"""The serving store's pre-swap ``DriftProbe``: a copy of
``fedrec_tpu/obs/quality.py``'s probe (numpy), not an import of it. The rest
of that module (sliced evaluation, the quality monitor) is not ported
(``ROADMAP.md`` Queue A item 10b).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from fedrec_tpu_torch.obs.registry import MetricsRegistry, get_registry


class DriftProbe:
    """Pinned probe-user set scored against both sides of a store swap.

    ``compare(old_vecs, old_mask, new_vecs, new_mask)`` runs BEFORE the
    new generation becomes current: ``num_probes`` seeded unit-norm probe
    user vectors score every valid catalog row under each table;
    published metrics are the mean/max absolute score shift over rows
    valid in BOTH generations and the mean top-k Jaccard overlap (rank
    churn = 1 - Jaccard). Identical tables give shift 0, Jaccard 1, churn
    0. A catalog whose row count or embedding dim changed is reported
    ``comparable=False``, with churn metrics only when the id space still
    matches (same N); scores across different dims are skipped entirely.
    Tables arrive as numpy arrays (the store copies them to the host).
    """

    def __init__(
        self,
        num_probes: int = 32,
        topk: int = 10,
        seed: int = 0,
        registry: MetricsRegistry | None = None,
    ):
        self.num_probes = int(num_probes)
        self.topk = int(topk)
        self.seed = int(seed)
        self.registry = registry or get_registry()
        r = self.registry
        self._g_shift_mean = r.gauge(
            "serve.drift_score_shift_mean",
            "mean |delta score| over the probe set between the outgoing and "
            "incoming store generation (measured BEFORE the swap)",
        )
        self._g_shift_max = r.gauge(
            "serve.drift_score_shift_max",
            "max |delta score| over the probe set between generations",
        )
        self._g_jaccard = r.gauge(
            "serve.drift_topk_jaccard",
            "mean probe-user top-k Jaccard overlap between generations "
            "(1.0 = identical rankings)",
        )
        self._g_churn = r.gauge(
            "serve.drift_rank_churn",
            "1 - top-k Jaccard: fraction of each probe's top-k that changed across the swap",
        )
        self._c_checks = r.counter(
            "serve.drift_checks_total", "pre-swap drift probes executed by the embedding store"
        )
        self._probes: dict[int, np.ndarray] = {}
        self.last: dict | None = None

    def _probe_vectors(self, dim: int) -> np.ndarray:
        p = self._probes.get(dim)
        if p is None:
            rng = np.random.default_rng((self.seed, dim))
            p = rng.standard_normal((self.num_probes, dim))
            p /= np.linalg.norm(p, axis=1, keepdims=True)
            self._probes[dim] = p
        return p

    @staticmethod
    def _masked_scores(vecs: np.ndarray, mask, probes: np.ndarray) -> np.ndarray:
        s = probes @ vecs.T  # (P, N)
        if mask is not None:
            s = np.where(np.asarray(mask, bool)[None, :], s, -np.inf)
        return s

    def compare(self, old_vecs, old_mask, new_vecs, new_mask) -> dict:
        old = np.asarray(old_vecs, np.float64)
        new = np.asarray(new_vecs, np.float64)
        result: dict[str, Any] = {
            "probes": self.num_probes, "topk": self.topk, "comparable": True,
        }
        self._c_checks.inc()
        if old.ndim != 2 or new.ndim != 2 or old.shape[1] != new.shape[1]:
            result["comparable"] = False
            self.last = result
            return result
        probes = self._probe_vectors(old.shape[1])
        so = self._masked_scores(old, old_mask, probes)
        sn = self._masked_scores(new, new_mask, probes)

        k = min(self.topk, so.shape[1], sn.shape[1])
        jaccards = []
        for p in range(self.num_probes):
            top_o = set(np.argpartition(-so[p], k - 1)[:k].tolist())
            top_n = set(np.argpartition(-sn[p], k - 1)[:k].tolist())
            jaccards.append(len(top_o & top_n) / max(len(top_o | top_n), 1))
        jac = float(np.mean(jaccards))
        result["topk_jaccard"] = jac
        result["rank_churn"] = 1.0 - jac
        self._g_jaccard.set(jac)
        self._g_churn.set(1.0 - jac)

        if old.shape[0] == new.shape[0]:
            both = np.isfinite(so) & np.isfinite(sn)
            if both.any():
                # subtract on the jointly valid elements only: -inf - -inf
                # would warn and yield NaN
                delta = np.abs(so[both] - sn[both])
                result["score_shift_mean"] = float(delta.mean())
                result["score_shift_max"] = float(delta.max())
                self._g_shift_mean.set(result["score_shift_mean"])
                self._g_shift_max.set(result["score_shift_max"])
        else:
            # grown or shrunk catalog: ranks still compare (same id space by
            # convention), per-row score deltas do not
            result["comparable"] = False
        self.last = result
        return result
