"""MIND data, a numpy copy of ``fedrec_tpu/data/mind.py``'s loader
(``load_mind_artifacts``), two generators (``make_synthetic_mind``,
``make_synthetic_mind_topics``) and the frozen-random-trunk surrogate
(``token_states_from_tokens``): the same seed gives the same arrays and
samples as the JAX package (``tests/test_torch_train.py``,
``tests/test_torch_data_pipeline.py``).

``MindData`` holds the reference artifacts' shapes: ``news_tokens``
``(N_news, 2, title_len)`` int64, ``nid2index`` with ``<unk> -> 0``, and
``[uidx, pos_nid, neg_nids, history_nids, uid]`` samples.
``load_mind_artifacts`` reads them from the reference's ``UserData``
layout: ``bert_news_index.npy`` and three pickles, which must come from a
trusted preprocessing run (unpickling runs code).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class MindData:
    news_tokens: np.ndarray          # (N_news, 2, title_len) int64
    nid2index: dict                  # nid -> row
    train_samples: list              # [uidx, pos, negs, history, uid]
    valid_samples: list

    @property
    def num_news(self) -> int:
        return self.news_tokens.shape[0]

    @property
    def title_len(self) -> int:
        return self.news_tokens.shape[2]


def load_mind_artifacts(data_dir: str | Path) -> MindData:
    """The reference's preprocessed artifacts under ``data_dir``:
    ``bert_news_index.npy``, ``bert_nid2index.pkl``, ``train_sam_uid.pkl``
    and ``valid_sam_uid.pkl``."""
    data_dir = Path(data_dir)
    news_tokens = np.load(data_dir / "bert_news_index.npy", allow_pickle=True)
    with open(data_dir / "bert_nid2index.pkl", "rb") as f:
        nid2index = pickle.load(f)
    with open(data_dir / "train_sam_uid.pkl", "rb") as f:
        train_samples = pickle.load(f)
    with open(data_dir / "valid_sam_uid.pkl", "rb") as f:
        valid_samples = pickle.load(f)
    return MindData(news_tokens, nid2index, train_samples, valid_samples)


def _synth_news_table(rng, num_news: int, title_len: int, vocab: int):
    """Shared synthetic news-token table: variable-length titles with
    attention masks, row 0 = ``<unk>`` all-zero (reference artifact layout,
    ``nid2index['<unk>'] == 0``)."""
    news_tokens = np.zeros((num_news, 2, title_len), dtype=np.int64)
    lengths = rng.integers(min(5, title_len), title_len + 1, size=num_news)
    for i in range(1, num_news):
        ln = lengths[i]
        news_tokens[i, 0, :ln] = rng.integers(1000, vocab, size=ln)
        news_tokens[i, 1, :ln] = 1
    nids = [f"N{i}" for i in range(num_news)]
    nid2index = {"<unk>": 0}
    for i in range(1, num_news):
        nid2index[nids[i]] = i
    return news_tokens, nids, nid2index


def make_synthetic_mind(
    num_news: int = 512,
    num_train: int = 256,
    num_valid: int = 64,
    title_len: int = 50,
    vocab: int = 30522,
    his_len_range: tuple[int, int] = (5, 50),
    neg_pool_range: tuple[int, int] = (4, 40),
    seed: int = 0,
    popular_frac: float = 0.0,
) -> MindData:
    """Synthetic MIND-shaped data for tests/benchmarks.

    Index 0 is reserved for ``<unk>`` (all-zero tokens), matching the
    reference artifact layout where ``nid2index['<unk>'] == 0``.

    ``popular_frac > 0`` draws positives from only the first
    ``popular_frac * num_news`` items while negatives come from the rest —
    a popularity signal a recommender can actually learn, for
    loss-decreases tests.
    """
    rng = np.random.default_rng(seed)
    news_tokens, nids, nid2index = _synth_news_table(rng, num_news, title_len, vocab)

    n_popular = max(1, int(popular_frac * num_news)) if popular_frac > 0 else 0
    if n_popular and 1 + n_popular >= num_news:
        raise ValueError(
            f"popular_frac={popular_frac} leaves no negatives: "
            f"{n_popular} popular items of {num_news} news (need >= 2 non-popular)"
        )

    def _make(n_samples: int) -> list:
        samples = []
        for s in range(n_samples):
            his_len = int(rng.integers(*his_len_range, endpoint=True))
            pool_len = int(rng.integers(*neg_pool_range, endpoint=True))
            his = [nids[int(j)] for j in rng.integers(1, num_news, size=his_len)]
            if n_popular:
                pos = nids[int(rng.integers(1, 1 + n_popular))]
                negs = [
                    nids[int(j)]
                    for j in rng.integers(1 + n_popular, num_news, size=pool_len)
                ]
            else:
                negs = [nids[int(j)] for j in rng.integers(1, num_news, size=pool_len)]
                pos = nids[int(rng.integers(1, num_news))]
            samples.append([s, pos, negs, his, f"U{s}"])
        return samples

    return MindData(news_tokens, nid2index, _make(num_train), _make(num_valid))


def make_synthetic_mind_topics(
    num_news: int = 4096,
    num_train: int = 50_000,
    num_valid: int = 5_000,
    title_len: int = 50,
    bert_hidden: int = 768,
    num_topics: int = 20,
    topics_per_user: int = 2,
    p_pref_hist: float = 0.9,
    p_pref_pos: float = 0.9,
    signal_scale: float = 1.0,
    noise_scale: float = 1.0,
    his_len_range: tuple[int, int] = (5, 50),
    neg_pool_range: tuple[int, int] = (4, 40),
    seed: int = 0,
    dtype=np.float32,
) -> tuple[MindData, np.ndarray]:
    """Topic-structured synthetic corpus with a *recoverable* ranking signal.

    Unlike :func:`make_synthetic_mind` (popularity-only), this generator has
    the structure the two-tower model is actually built for: each news item
    carries a latent topic expressed in its frozen-trunk token states, each
    user prefers ``topics_per_user`` topics, their click history is drawn
    mostly (``p_pref_hist``) from preferred topics, and the clicked positive
    is preferred with probability ``p_pref_pos`` while pool negatives are
    uniform. A perfect topic-matcher therefore attains full-pool
    AUC ~= ``p_pref_pos * (1 - r) + 0.5 * (p_pref_pos * r + (1 - p_pref_pos)
    * (1 - r))`` with ``r = topics_per_user / num_topics`` (~0.90 at the
    defaults) — a known ceiling the learning curve can be judged against.

    Returns ``(MindData, token_states)`` where ``token_states`` is the
    ``(num_news, title_len, bert_hidden)`` cached-trunk tensor: per-news
    topic centroid + i.i.d. position noise (row 0 = ``<unk>`` = zeros).
    """
    if num_news - 1 < num_topics:
        raise ValueError(
            f"num_news={num_news} leaves fewer than num_topics={num_topics} "
            "real news items; every topic needs at least one"
        )
    rng = np.random.default_rng(seed)

    centroids = rng.standard_normal((num_topics, bert_hidden))
    centroids *= signal_scale / np.linalg.norm(centroids, axis=1, keepdims=True)
    # round-robin-then-shuffle: uniform-ish AND every topic non-empty (a
    # uniform draw leaves topics empty at small num_news, crashing the
    # preferred-topic sampler)
    topic_of = np.empty(num_news, dtype=np.int64)
    topic_of[1:] = rng.permutation(np.arange(num_news - 1) % num_topics)
    topic_of[0] = -1  # <unk>

    # draw directly in float32 (a float64 intermediate would transiently
    # double the ~600 MB the central accuracy corpus already needs)
    token_states = rng.standard_normal(
        (num_news, title_len, bert_hidden), dtype=np.float32
    )
    if np.dtype(dtype) != np.float32:
        token_states = token_states.astype(dtype)
    token_states *= noise_scale
    token_states[1:] += centroids[topic_of[1:], None, :].astype(dtype)
    token_states[0] = 0.0

    # news grouped by topic for O(1) preferred-topic draws
    by_topic = [np.flatnonzero(topic_of == t) for t in range(num_topics)]

    news_tokens, nids, nid2index = _synth_news_table(
        rng, num_news, title_len, vocab=30_522
    )

    topic_sizes = np.array([len(b) for b in by_topic])

    def _draw(pref_topics: np.ndarray, n: int, p_pref: float) -> np.ndarray:
        """n news ids: preferred-topic w.p. p_pref, else uniform non-unk."""
        out = rng.integers(1, num_news, size=n)
        pref = rng.random(n) < p_pref
        k = int(pref.sum())
        if k:
            ts = pref_topics[rng.integers(0, len(pref_topics), size=k)]
            within = rng.integers(0, topic_sizes[ts])
            out[pref] = [by_topic[t][i] for t, i in zip(ts, within)]
        return out

    def _make(n_samples: int, offset: int) -> list:
        samples = []
        for s in range(n_samples):
            pref = rng.choice(num_topics, size=topics_per_user, replace=False)
            his_len = int(rng.integers(*his_len_range, endpoint=True))
            pool_len = int(rng.integers(*neg_pool_range, endpoint=True))
            his = [nids[j] for j in _draw(pref, his_len, p_pref_hist)]
            pos = nids[int(_draw(pref, 1, p_pref_pos)[0])]
            negs = [nids[int(j)] for j in rng.integers(1, num_news, size=pool_len)]
            samples.append([offset + s, pos, negs, his, f"U{offset + s}"])
        return samples

    data = MindData(
        news_tokens, nid2index, _make(num_train, 0), _make(num_valid, num_train)
    )
    return data, token_states


def token_states_from_tokens(
    news_tokens: np.ndarray,
    bert_hidden: int = 96,
    vocab: int = 30_522,
    seed: int = 0,
    dtype=np.float32,
) -> np.ndarray:
    """(N, 2, L) token table -> (N, L, bert_hidden) "frozen random trunk".

    A deterministic surrogate for cached DistilBERT states when no
    pretrained trunk is available offline: every token id maps to a fixed
    Gaussian embedding, masked positions are zeroed. Lexical structure in
    the titles (shared topic words) therefore survives into the states, so
    ``text_encoder_mode='head'`` can learn from corpora produced by the
    real tokenizer/pipeline. Not a language model — just the weakest trunk
    that preserves word identity.
    """
    ids = news_tokens[:, 0, :]
    # cover any tokenizer's id space (e.g. Norwegian BERT ~50k > the BERT
    # default); extending the table leaves ids < vocab with identical rows
    table = np.random.default_rng(seed).standard_normal(
        (max(vocab, int(ids.max()) + 1), bert_hidden), dtype=np.float32
    )
    mask = news_tokens[:, 1, :, None].astype(np.float32)
    states = table[ids] * mask
    return states.astype(dtype) if np.dtype(dtype) != np.float32 else states
