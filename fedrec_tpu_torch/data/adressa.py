"""Adressa event log -> training artifacts (the second dataset family): a
copy of ``fedrec_tpu/data/adressa.py``, writing the same ``UserData/``
layout and bytes on the same inputs.

Input: JSON-lines event logs (one JSON object per pageview) from
Adresseavisen; the fields read are ``userId``, ``id``/``documentId`` (news
id), ``title`` and ``time`` (unix seconds).

Pipeline (mapped onto the MIND artifact schema, so everything downstream —
``index_samples``, ``TrainBatcher``, ``Trainer`` — is shared with MIND):

  1. collect each user's clicks, time-sorted; dedupe news by id
  2. per click: history = that user's earlier clicks; negatives = a random
     corpus sample excluding the user's own clicks (Adressa logs have no
     shown-but-not-clicked impressions, so the negative pool is sampled)
  3. chronological split: the last ``valid_frac`` of each user's clicks form
     the validation samples
  4. artifacts written in the ``UserData/`` schema
     (``[uidx, pos, neg_pool, history, uid]``; news table ``(N, 2, L)``)

Usage:
  python -m fedrec_tpu_torch.data.adressa --events one_week/2017010* \
      --out-dir AdressaData [--vocab vocab.txt] [--max-title-len 30]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from fedrec_tpu_torch.data.mind import MindData
from fedrec_tpu_torch.data.preprocess import build_news_index, write_artifacts
from fedrec_tpu_torch.data.tokenizer import get_tokenizer


def parse_adressa_events(
    paths: list[str | Path],
) -> tuple[dict[str, str], dict[str, list[tuple[int, str]]]]:
    """JSON-lines event files -> (``{nid: title}``, ``{uid: [(time, nid)]}``).

    Events without a news id, title, or user are skipped (the raw logs mix
    pageviews of front pages and ads with article reads). Repeated clicks by
    the same user on the same article keep only the earliest timestamp, so
    the clicks mapping is independent of the order event files are passed
    (titles keep the first-seen text per nid, which does depend on order
    when a dump revises a title).
    """
    titles: dict[str, str] = {}
    seen: dict[tuple[str, str], int] = {}  # (uid, nid) -> earliest click time
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                nid = ev.get("id") or ev.get("documentId")
                title = ev.get("title")
                uid = ev.get("userId")
                t = ev.get("time")
                if isinstance(t, str):  # some dumps carry numeric strings
                    try:
                        t = float(t)
                    except ValueError:
                        t = None
                # timeless events are skipped: a fabricated time=0 would sort
                # the click to the front and corrupt the chronological
                # history/validation split
                if not nid or not title or not uid or not isinstance(t, (int, float)):
                    continue
                titles.setdefault(nid, title)
                # dedupe repeat clicks by keeping the EARLIEST timestamp so
                # chronological histories don't depend on file-read order
                key = (uid, nid)
                prev = seen.get(key)
                if prev is None or int(t) < prev:
                    seen[key] = int(t)
    clicks: dict[str, list[tuple[int, str]]] = {}
    for (uid, nid), t in seen.items():
        clicks.setdefault(uid, []).append((t, nid))
    for uid in clicks:
        clicks[uid].sort()
    return titles, clicks


def build_adressa_samples(
    titles: dict[str, str],
    clicks: dict[str, list[tuple[int, str]]],
    min_history: int = 1,
    neg_pool_size: int = 20,
    valid_frac: float = 0.1,
    seed: int = 0,
) -> tuple[list, list]:
    """-> (train_samples, valid_samples) in the reference schema.

    Per user, clicks after the first ``min_history`` become samples; the last
    ``ceil(valid_frac * n_samples)`` (chronologically) go to validation.
    """
    rng = np.random.default_rng(seed)
    all_nids = list(titles)
    train, valid = [], []
    for uidx, (uid, events) in enumerate(sorted(clicks.items())):
        nids = [nid for _, nid in events]
        if len(nids) <= min_history:
            continue
        clicked = set(nids)
        n_eligible = len(all_nids) - len(clicked)

        def draw_pool() -> list[str]:
            # rejection-sample indices against the (small) clicked set; exact
            # per-user eligible-list materialization would be O(users x corpus)
            k = min(neg_pool_size, n_eligible)
            pool: list[str] = []
            chosen: set[str] = set()
            # typical case: clicked << corpus, a couple of rounds suffice
            for _ in range(8):
                for j in rng.integers(0, len(all_nids), size=4 * k):
                    n = all_nids[j]
                    if n not in clicked and n not in chosen:
                        pool.append(n)
                        chosen.add(n)
                        if len(pool) == k:
                            return pool
            # heavy reader (clicked ~ corpus): fall back to the exact filter
            eligible = [n for n in all_nids if n not in clicked and n not in chosen]
            take = rng.choice(len(eligible), size=k - len(pool), replace=False)
            return pool + [eligible[int(i)] for i in take]

        n_samples = len(nids) - min_history
        # keep at least one train sample per user: a ceil-only split would
        # banish every 2-click user's single sample to validation
        n_valid = (
            min(n_samples - 1, int(np.ceil(valid_frac * n_samples)))
            if valid_frac > 0
            else 0
        )
        for i in range(min_history, len(nids)):
            pos, history = nids[i], nids[:i]
            sample = [uidx, pos, draw_pool(), history, uid]
            (valid if i >= len(nids) - n_valid else train).append(sample)
    return train, valid


def make_synthetic_adressa_events(
    num_users: int = 2_000,
    num_news: int = 1_500,
    num_topics: int = 12,
    topics_per_user: int = 2,
    p_pref: float = 0.9,
    clicks_range: tuple[int, int] = (4, 30),
    title_words: tuple[int, int] = (5, 9),
    words_per_topic: int = 12,
    p_topic_word: float = 0.85,
    seed: int = 0,
) -> list[dict]:
    """Synthetic Adressa-format event log with a recoverable topic signal.

    The lexical twin of ``make_synthetic_mind_topics``: every news item
    belongs to a latent topic whose TITLES share a topic vocabulary (each
    title word is topical w.p. ``p_topic_word``, else from a common pool),
    and every user clicks preferred-topic articles w.p. ``p_pref``. Because
    the signal lives in the *words*, it survives the real pipeline —
    tokenizer, ``build_news_index``, chronological splits — so an accuracy
    run through :func:`preprocess_adressa` trains on exactly what a real
    Adressa dump would exercise. Click timestamps increase per user; the
    adapter's chronological validation split therefore holds out each
    user's latest clicks.

    Returns a list of event dicts (``userId``/``id``/``title``/``time``)
    ready to be written as JSON-lines.
    """
    rng = np.random.default_rng(seed)
    # every topic must own >=1 news or the preferred-topic sampler crashes
    # (same guard as make_synthetic_mind_topics): clamp the topic count to
    # the corpus, then assign round-robin-then-shuffle so no topic is empty
    num_topics = min(num_topics, num_news)
    topics_per_user = min(topics_per_user, num_topics)
    topic_of = rng.permutation(np.arange(num_news) % num_topics)
    common = [f"felles{j}" for j in range(200)]

    def title_for(n: int) -> str:
        t = topic_of[n]
        k = int(rng.integers(*title_words, endpoint=True))
        words = [
            f"emne{t}ord{rng.integers(0, words_per_topic)}"
            if rng.random() < p_topic_word
            else common[rng.integers(0, len(common))]
            for _ in range(k)
        ]
        return " ".join(words)

    titles = [title_for(n) for n in range(num_news)]
    by_topic = [np.flatnonzero(topic_of == t) for t in range(num_topics)]

    events: list[dict] = []
    for u in range(num_users):
        pref = rng.choice(num_topics, size=topics_per_user, replace=False)
        n_clicks = int(rng.integers(*clicks_range, endpoint=True))
        t0 = int(rng.integers(1_500_000_000, 1_510_000_000))
        seen: set[int] = set()
        for c in range(n_clicks):
            if rng.random() < p_pref:
                t = int(pref[rng.integers(0, topics_per_user)])
                n = int(by_topic[t][rng.integers(0, len(by_topic[t]))])
            else:
                n = int(rng.integers(0, num_news))
            if n in seen:  # the adapter dedupes repeat clicks anyway
                continue
            seen.add(n)
            events.append(
                {
                    "userId": f"u{u:06d}",
                    "id": f"adr{n}",
                    "title": titles[n],
                    "time": t0 + 60 * c,
                }
            )
    return events


def preprocess_adressa(
    event_paths: list[str | Path],
    out_dir: str | Path | None = None,
    vocab_path: str | Path | None = None,
    max_title_len: int = 30,
    min_history: int = 1,
    neg_pool_size: int = 20,
    valid_frac: float = 0.1,
    seed: int = 0,
) -> MindData:
    tokenizer = get_tokenizer(vocab_path)
    titles, clicks = parse_adressa_events(event_paths)
    news_tokens, nid2index = build_news_index(titles, tokenizer, max_title_len)
    train, valid = build_adressa_samples(
        titles, clicks, min_history, neg_pool_size, valid_frac, seed
    )
    data = MindData(news_tokens, nid2index, train, valid)
    if out_dir is not None:
        write_artifacts(data, out_dir)
    return data


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--events", nargs="+", required=True, help="event JSON-lines files")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--vocab", default=None)
    p.add_argument("--max-title-len", type=int, default=30)
    p.add_argument("--min-history", type=int, default=1)
    p.add_argument("--neg-pool-size", type=int, default=20)
    p.add_argument("--valid-frac", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    data = preprocess_adressa(
        args.events, args.out_dir, args.vocab, args.max_title_len,
        args.min_history, args.neg_pool_size, args.valid_frac, args.seed,
    )
    print(
        f"wrote {args.out_dir}: {data.num_news} news, "
        f"{len(data.train_samples)} train / {len(data.valid_samples)} valid samples"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
