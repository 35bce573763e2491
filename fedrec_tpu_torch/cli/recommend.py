"""Serving entry point of the port: trained snapshot -> top-k recommendations
per user (``fedrec-recommend``).

Restores the newest training snapshot (``fedrec_tpu_torch.train``'s
``round_<r>/state.pt``, client 0), encodes the news corpus once (kernel A
under ``model.use_pallas`` over the cached token states; in finetune mode
the snapshot's whole text encoder over the titles' tokens, which needs no
token states), and emits JSON lines
``{"uid": ..., "news": [nid, ...], "scores": [...]}`` for every known user
(or a ``--uids`` subset), batched through the exact full-catalog scorer
(kernel B under ``model.fuse_hot_path``) on one card. Each user's history
is their longest recorded click history across the train and valid
samples (samples carry cumulative histories, so longest = latest). The
training run's ``config.json`` next to the snapshots gives the model
settings; ``--set`` applies on top.

Usage:
  python -m fedrec_tpu_torch.cli.recommend --data-dir UserData \\
      --snapshot-dir snapshots [--token-states states.npy] [--top-k 10] \\
      [--out recs.jsonl] [--uids U123 U456] [--set section.key=value] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-dir", default="UserData", help="reference UserData/ artifact layout")
    p.add_argument("--token-states", default=None,
                   help="(N, L, bert_hidden) .npy of cached trunk states "
                        "(default <data-dir>/token_states.npy)")
    p.add_argument("--snapshot-dir", default=None,
                   help="training snapshots (default: train.snapshot_dir)")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--keep-history", action="store_true",
                   help="allow already-clicked news in the output")
    p.add_argument("--out", default="-", help="output JSONL path ('-' = stdout)")
    p.add_argument("--uids", nargs="*", default=None,
                   help="subset of user ids (default: every known user)")
    p.add_argument("--allow-random-states", action="store_true",
                   help="permit RANDOM trunk token states when token_states.npy is "
                        "missing (smoke tests only: the scores are meaningless)")
    p.add_argument("--batch-users", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without a GPU unless 'cpu')")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="SECTION.KEY=VALUE")
    return p


def collect_histories(data, max_his_len: int) -> dict[str, list[str]]:
    """uid -> longest recorded history (sample schema: [uidx, pos, negs,
    history, uid])."""
    best: dict[str, list[str]] = {}
    for sample in list(data.train_samples) + list(data.valid_samples):
        _, _, _, his, uid = sample
        if len(his) >= len(best.get(uid, ())):
            best[uid] = list(his)
    return {u: h[-max_his_len:] for u, h in best.items()}


def _log(msg: str) -> None:
    print(f"[recommend] {msg}", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.data import load_mind_artifacts
    from fedrec_tpu_torch.device import resolve_device, torch_dtype
    from fedrec_tpu_torch.serve import build_recommend_fn
    from fedrec_tpu_torch.serving import (
        SnapshotFormatError,
        load_checkpoint_params,
        restore_model,
    )
    from fedrec_tpu_torch.train.step import encode_all_news, encode_corpus_tokens

    dev = resolve_device(args.device)
    # full-f32 products on the card: TF32 would keep ~3 decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ExperimentConfig()
    cfg.apply_overrides(args.overrides)
    snap_dir = args.snapshot_dir or cfg.train.snapshot_dir

    # the training run's resolved config, persisted next to the snapshots,
    # wins over the defaults: a mismatch would give a shape error or, for
    # shape-compatible knobs like max_his_len, silently different scores
    cfg_path = Path(snap_dir) / "config.json"
    if cfg_path.exists():
        try:
            cfg = ExperimentConfig.from_dict(json.loads(cfg_path.read_text()))
            cfg.apply_overrides(args.overrides)
            _log(f"using training config {cfg_path}")
        except (OSError, ValueError, KeyError, TypeError) as e:
            _log(f"ignoring unreadable {cfg_path}: {e}")
    else:
        _log("no config.json next to the snapshot: model hyperparameters come from "
             "defaults + --set and are NOT verified against the training run")

    try:
        user_state, news_state, round_, kind = load_checkpoint_params(snap_dir, log=_log)
    except (FileNotFoundError, SnapshotFormatError) as e:
        _log(f"{e} — train first (python -m fedrec_tpu_torch.cli.run) or pass --snapshot-dir")
        return 2
    _log(f"serving {kind} snapshot (round {round_})")

    data = load_mind_artifacts(args.data_dir)
    if cfg.model.text_encoder_mode == "finetune":
        # the snapshot holds the trained trunk: encode the titles' tokens
        model = restore_model(cfg.model, user_state, news_state, dev)
        table = encode_corpus_tokens(model.text_encoder, data.news_tokens, device=dev)
    else:
        token_path = args.token_states or str(Path(args.data_dir) / "token_states.npy")
        if Path(token_path).exists():
            token_states = np.load(token_path)
        elif args.allow_random_states:
            _log(f"no token states at {token_path}; using RANDOM states "
                 "(--allow-random-states) — scores are meaningless")
            token_states = np.random.default_rng(0).standard_normal(
                (data.num_news, data.title_len, cfg.model.bert_hidden)).astype(np.float32)
        else:
            # a hard error: random trunk states would give normal-looking JSONL
            # an operator could ship
            _log(f"ERROR: no token states at {token_path}. Export them or pass "
                 "--token-states; use --allow-random-states only for smoke tests.")
            return 2
        model = restore_model(cfg.model, user_state, news_state, dev)
        tokens = torch.from_numpy(token_states).to(dtype=torch_dtype(cfg.model.dtype))
        table = encode_all_news(model, tokens, device=dev)
        del tokens, token_states

    histories = collect_histories(data, cfg.data.max_his_len)
    uids = sorted(histories) if args.uids is None else args.uids
    missing = [u for u in uids if u not in histories]
    if missing:
        _log(f"{len(missing)} unknown uid(s) skipped: {missing[:5]}...")
        uids = [u for u in uids if u in histories]
    if not uids:
        _log("no users to serve")
        return 2

    index2nid = {i: n for n, i in data.nid2index.items()}
    # artifacts can carry more token rows than mapped nids: never recommend
    # the unmapped
    valid = np.zeros(data.num_news, bool)
    valid[[i for i in index2nid if 0 <= i < data.num_news]] = True
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        _log(f"scoring on {dev} of {torch.cuda.device_count()} cards (the sharded scorer "
             "is ROADMAP Queue A item 9)")
    fn = build_recommend_fn(top_k=args.top_k, exclude_history=not args.keep_history,
                            valid_mask=valid, device=dev)

    out_fh = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        h_len, bu = cfg.data.max_his_len, args.batch_users
        for start in range(0, len(uids), bu):
            chunk = uids[start:start + bu]
            hist = np.zeros((bu, h_len), np.int32)  # one static shape for every batch
            for r, uid in enumerate(chunk):
                ids = [data.nid2index.get(n, 0) for n in histories[uid]]
                hist[r, :len(ids)] = ids
            ids_out, scores_out = fn(model.user_encoder, table, torch.from_numpy(hist))
            ids_out, scores_out = ids_out.cpu().numpy(), scores_out.cpu().numpy()
            for r, uid in enumerate(chunk):
                keep = ids_out[r] >= 0
                out_fh.write(json.dumps({
                    "uid": uid,
                    "news": [index2nid[int(i)] for i in ids_out[r][keep]],
                    "scores": [round(float(s), 5) for s in scores_out[r][keep]],
                }) + "\n")
    finally:
        if out_fh is not sys.stdout:
            out_fh.close()
    if args.out != "-":
        _log(f"wrote {len(uids)} users to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
