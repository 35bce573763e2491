"""MIND raw tsv -> training artifacts: a copy of
``fedrec_tpu/data/preprocess.py``. On the same inputs it writes the same
``UserData/`` bytes, so either package's ``load_mind_artifacts`` reads the
other's.

Inputs, the public MIND tsv layout:

  * ``news.tsv``     — ``nid \t category \t subcategory \t title \t abstract
    \t url \t title_entities \t abstract_entities``
  * ``behaviors.tsv`` — ``impression_id \t user_id \t time \t history
    \t impressions`` where impressions are ``Nxxxx-1`` (clicked) /
    ``Nxxxx-0`` (shown, not clicked)

Artifact semantics (``data.mind.load_mind_artifacts``):

  * news index row 0 is ``<unk>`` (all-zero tokens), ``nid2index['<unk>']==0``
  * one sample per CLICK — for train AND valid — of the form
    ``[uidx, pos_nid, neg_pool, history, uid]`` with the impression's
    non-clicked candidates as the negative pool (``npratio`` negatives are
    drawn per epoch at batch time); a multi-click impression therefore
    yields one sample per click
  * clicks with an empty negative pool are kept (the sampler pads with
    ``<unk>``)

Usage:
  python -m fedrec_tpu_torch.data.preprocess --news news.tsv \
      --train-behaviors train/behaviors.tsv --valid-behaviors dev/behaviors.tsv \
      --out-dir UserData [--vocab vocab.txt] [--max-title-len 50]
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from fedrec_tpu_torch.data.mind import MindData
from fedrec_tpu_torch.data.tokenizer import get_tokenizer


def parse_news_tsv(path: str | Path) -> dict[str, str]:
    """-> ordered ``{nid: title}``; first field wins on duplicate nids."""
    titles: dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4:
                continue
            nid, title = parts[0], parts[3]
            if nid and nid not in titles:
                titles[nid] = title
    return titles


def build_news_index(
    titles: dict[str, str], tokenizer, max_title_len: int = 50
) -> tuple[np.ndarray, dict[str, int]]:
    """-> ((N+1, 2, L) int64 tokens+mask, nid2index with ``<unk> -> 0``)."""
    nid2index = {"<unk>": 0}
    rows = [np.zeros((2, max_title_len), np.int64)]  # row 0 = <unk>
    for nid, title in titles.items():
        ids, mask = tokenizer.encode(title, max_title_len)
        nid2index[nid] = len(rows)
        rows.append(np.stack([ids, mask]))
    return np.stack(rows), nid2index


def parse_behaviors_tsv(
    path: str | Path,
    known_nids: set[str],
    max_his_len: int | None = None,
    uid2idx: dict[str, int] | None = None,
) -> list:
    """behaviors.tsv -> ``[uidx, pos, neg_pool, history, uid]`` per click.

    Unknown nids (not in ``news.tsv``) are dropped from histories and pools;
    a click on an unknown nid is skipped entirely. ``max_his_len`` optionally
    pre-truncates histories to the most recent clicks (the batcher truncates
    again regardless). Pass one
    shared ``uid2idx`` across train/valid calls so a given uidx means the
    same user in both artifacts.
    """
    samples: list = []
    if uid2idx is None:
        uid2idx = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5:
                continue
            _, uid, _time, history_s, impressions_s = parts[:5]
            if uid not in uid2idx:
                uid2idx[uid] = len(uid2idx)
            uidx = uid2idx[uid]
            history = [n for n in history_s.split() if n in known_nids]
            if max_his_len is not None:
                history = history[-max_his_len:]
            clicked, pool = [], []
            for item in impressions_s.split():
                nid, _, label = item.rpartition("-")
                if not nid or nid not in known_nids:
                    continue
                (clicked if label == "1" else pool).append(nid)
            for pos in clicked:
                samples.append([uidx, pos, list(pool), list(history), uid])
    return samples


def preprocess_mind(
    news_path: str | Path,
    train_behaviors: str | Path,
    valid_behaviors: str | Path | None = None,
    out_dir: str | Path | None = None,
    vocab_path: str | Path | None = None,
    max_title_len: int = 50,
) -> MindData:
    """Full pipeline; writes the four reference-format artifacts if
    ``out_dir`` is given and always returns the in-memory ``MindData``."""
    tokenizer = get_tokenizer(vocab_path)
    titles = parse_news_tsv(news_path)
    news_tokens, nid2index = build_news_index(titles, tokenizer, max_title_len)
    known = set(titles)
    uid2idx: dict[str, int] = {}  # shared: uidx must mean one user across splits
    train_samples = parse_behaviors_tsv(train_behaviors, known, uid2idx=uid2idx)
    valid_samples = (
        parse_behaviors_tsv(valid_behaviors, known, uid2idx=uid2idx)
        if valid_behaviors
        else []
    )
    data = MindData(news_tokens, nid2index, train_samples, valid_samples)
    if out_dir is not None:
        write_artifacts(data, out_dir)
    return data


def write_artifacts(data: MindData, out_dir: str | Path) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "bert_news_index.npy", data.news_tokens)
    with open(out / "bert_nid2index.pkl", "wb") as f:
        pickle.dump(data.nid2index, f)
    with open(out / "train_sam_uid.pkl", "wb") as f:
        pickle.dump(data.train_samples, f)
    with open(out / "valid_sam_uid.pkl", "wb") as f:
        pickle.dump(data.valid_samples, f)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--news", required=True)
    p.add_argument("--train-behaviors", required=True)
    p.add_argument("--valid-behaviors", default=None)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--vocab", default=None, help="BERT vocab.txt (WordPiece); "
                   "omitted -> deterministic hashing tokenizer")
    p.add_argument("--max-title-len", type=int, default=50)
    args = p.parse_args(argv)
    data = preprocess_mind(
        args.news, args.train_behaviors, args.valid_behaviors,
        args.out_dir, args.vocab, args.max_title_len,
    )
    print(
        f"wrote {args.out_dir}: {data.num_news} news, "
        f"{len(data.train_samples)} train / {len(data.valid_samples)} valid samples"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
