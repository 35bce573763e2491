"""Model-quality observability: sliced evaluation, calibration, serving
drift. A numpy copy of ``fedrec_tpu/obs/quality.py`` (the host side of the
``obs.quality`` layer):

* slice definitions: fixed, seeded partitions of the validation set
  (news-category hash buckets, history-length buckets, user-activity
  quantile buckets); ``SlicedEvalAccumulator`` folds the full-pool eval
  pass's per-impression metric vectors into per-slice means without a
  second pass;
* score and calibration digests: the eval step's fixed-shape partial sums
  (``eval.metrics.quality_stats_batch``) reduce to score histograms,
  separation and reliability-bin ECE (``reduce_quality_sums``);
* the per-client quality digest (``QualityMonitor.digest_clients``): flags
  clients whose eval AUC sits ``outlier_auc_drop`` below the cohort median;
  informational, it never triggers quarantine;
* the serving store's pre-swap ``DriftProbe``: score shift and top-k rank
  churn of a seeded probe-user set between the outgoing and the incoming
  generation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np

from fedrec_tpu_torch.obs.registry import MetricsRegistry, get_registry

# the four ranking metrics every slice reports — the same quartet
# Trainer.evaluate_full returns corpus-wide
METRIC_KEYS = ("auc", "mrr", "ndcg5", "ndcg10")

# Knuth multiplicative hash constant: a seeded, stable id -> bucket map
# that needs no category metadata (a topic proxy on synthetic corpora;
# real categories can replace it upstream by pre-bucketing ids)
_HASH_MULT = np.uint64(2654435761)
_SEED_MIX = np.uint64(0x9E3779B97F4A7C15)


def parse_hist_edges(spec: str) -> list[int]:
    """``"10,30"`` -> ``[10, 30]`` (strictly increasing ints)."""
    edges = [int(x) for x in spec.split(",") if x.strip() != ""]
    if any(b <= a for a, b in zip(edges, edges[1:])):
        raise ValueError(
            f"obs.quality.hist_len_edges must be strictly increasing, got {spec!r}"
        )
    return edges


def category_buckets_of(ids: np.ndarray, buckets: int, seed: int) -> np.ndarray:
    """Seeded multiplicative-hash bucket per news id — THE fixed category
    slice map.  Deterministic across processes and runs for a given
    (seed, buckets), so banked quality-gate artifacts stay comparable."""
    ids = np.asarray(ids, np.uint64)
    mixed = ids * _HASH_MULT + np.uint64(seed) * _SEED_MIX
    return (mixed % np.uint64(1 << 32) % np.uint64(max(buckets, 1))).astype(np.int64)


@dataclass(frozen=True)
class SliceDef:
    """One named validation-set stratum: ``mask[i]`` selects impression i."""

    name: str                 # e.g. "category=b3", "hist_len=11-30"
    mask: np.ndarray          # (N,) bool over validation impressions


def build_slice_defs(valid_ix: Any, qcfg: Any) -> list[SliceDef]:
    """Fixed, seeded slice definitions over an ``IndexedSamples`` validation
    set — the same partitions every eval (and the banked quality gate)
    reports on:

    * ``category=b<k>``: seeded hash bucket of the POSITIVE news id
      (``category_buckets`` buckets);
    * ``hist_len=<range>``: user history length vs ``hist_len_edges``;
    * ``activity=q<k>``: the impression's user's validation-impression
      count, bucketed into ``activity_buckets`` quantile buckets (users
      missing a ``uidx`` column skip this family).

    Masks within one family partition the set; families overlap (an
    impression is in one category AND one hist-len AND one activity
    slice).  Empty masks are kept — the accumulator counts them as
    skipped slices, which is itself signal (a category bucket with zero
    validation impressions cannot be judged).
    """
    n = len(valid_ix)
    out: list[SliceDef] = []

    cats = category_buckets_of(
        np.asarray(valid_ix.pos), int(qcfg.category_buckets), int(qcfg.seed)
    )
    for b in range(int(qcfg.category_buckets)):
        out.append(SliceDef(f"category=b{b}", cats == b))

    edges = parse_hist_edges(qcfg.hist_len_edges)
    if edges:
        hl = np.asarray(valid_ix.his_len)
        # first bound -1 so zero-history (cold) users land in the first
        # bucket instead of matching no hist_len slice — the family must
        # partition the set, and the coldest users are exactly the
        # stratum the runbook reads this family for
        bounds = [-1, *edges, None]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if hi is None:
                out.append(SliceDef(f"hist_len={lo + 1}+", hl > lo))
            else:
                out.append(
                    SliceDef(
                        f"hist_len={max(lo + 1, 0)}-{hi}",
                        (hl > lo) & (hl <= hi),
                    )
                )

    uidx = getattr(valid_ix, "uidx", None)
    q = int(qcfg.activity_buckets)
    if uidx is not None and q > 0 and n > 0:
        uidx = np.asarray(uidx)
        _, inv, counts = np.unique(uidx, return_inverse=True, return_counts=True)
        activity = counts[inv].astype(np.float64)  # per-impression user activity
        # quantile edges over impressions; duplicate edges collapse (a
        # corpus where every user has one impression yields ONE slice)
        qs = np.quantile(activity, np.linspace(0, 1, q + 1)[1:-1])
        edges_a = np.unique(qs)
        bucket = np.searchsorted(edges_a, activity, side="left")
        for b in range(len(edges_a) + 1):
            out.append(SliceDef(f"activity=q{b}", bucket == b))

    return out


class SlicedEvalAccumulator:
    """Folds per-batch per-impression metric vectors into per-slice means.

    The Trainer's full-pool eval loop calls :meth:`add` once per batch
    with the batch's global start index, the jitted step's per-impression
    metric arrays and the keep-weights (0 for wrap-around padding and
    empty-pool impressions); :meth:`finalize` returns
    ``{slice_name: {auc, mrr, ndcg5, ndcg10, count}}`` plus the list of
    skipped (zero-impression) slices.  A second eval pass is never
    needed — slicing is a reweighting of the pass already being paid for.
    """

    def __init__(self, slice_defs: Sequence[SliceDef], n_valid: int):
        self.slice_defs = list(slice_defs)
        self.n_valid = int(n_valid)
        self._sums = {
            s.name: {k: 0.0 for k in METRIC_KEYS} for s in self.slice_defs
        }
        self._counts = {s.name: 0.0 for s in self.slice_defs}

    def add(
        self, start: int, out: Mapping[str, np.ndarray], weights: np.ndarray
    ) -> None:
        w = np.asarray(weights, np.float64)
        idx = np.arange(start, start + w.shape[0])
        valid = idx < self.n_valid
        idx = np.where(valid, idx, 0)
        w = w * valid  # wrap-around pad rows never count (already 0, belt+braces)
        metric = {k: np.asarray(out[k], np.float64).reshape(-1) for k in METRIC_KEYS}
        for s in self.slice_defs:
            sel = s.mask[idx] * w
            c = float(sel.sum())
            if c == 0.0:
                continue
            self._counts[s.name] += c
            for k in METRIC_KEYS:
                self._sums[s.name][k] += float(np.dot(sel, metric[k]))

    def finalize(self) -> tuple[dict[str, dict], list[str]]:
        slices: dict[str, dict] = {}
        skipped: list[str] = []
        for s in self.slice_defs:
            c = self._counts[s.name]
            if c <= 0:
                skipped.append(s.name)
                continue
            slices[s.name] = {
                **{k: self._sums[s.name][k] / c for k in METRIC_KEYS},
                "count": c,
            }
        return slices, skipped


def reduce_quality_sums(acc: Mapping[str, np.ndarray], ece_bins: int) -> dict:
    """Accumulated ``q.*`` partial sums -> the distribution digest:
    score-histogram counts, separation stats, the reliability table and
    ECE.  Pure closed forms."""
    pos_n = float(acc["q.pos_n"])
    neg_n = float(acc["q.neg_n"])
    out: dict[str, Any] = {
        "pos_hist": np.asarray(acc["q.pos_hist"], np.float64).tolist(),
        "neg_hist": np.asarray(acc["q.neg_hist"], np.float64).tolist(),
        "pos_n": pos_n,
        "neg_n": neg_n,
    }
    if pos_n > 0:
        mean_p = float(acc["q.pos_sum"]) / pos_n
        var_p = max(float(acc["q.pos_sq"]) / pos_n - mean_p**2, 0.0)
        out["pos_mean"], out["pos_std"] = mean_p, var_p**0.5
    if neg_n > 0:
        mean_n = float(acc["q.neg_sum"]) / neg_n
        var_n = max(float(acc["q.neg_sq"]) / neg_n - mean_n**2, 0.0)
        out["neg_mean"], out["neg_std"] = mean_n, var_n**0.5
    if pos_n > 0 and neg_n > 0:
        out["separation"] = out["pos_mean"] - out["neg_mean"]
        pooled = ((out["pos_std"] ** 2 + out["neg_std"] ** 2) / 2.0) ** 0.5
        out["dprime"] = out["separation"] / pooled if pooled > 0 else float("inf")

    cal_n = np.asarray(acc["q.cal_n"], np.float64)
    cal_conf = np.asarray(acc["q.cal_conf"], np.float64)
    cal_label = np.asarray(acc["q.cal_label"], np.float64)
    total = float(cal_n.sum())
    bins = []
    ece = 0.0
    for b in range(ece_bins):
        n_b = float(cal_n[b])
        row = {"bin": b, "count": n_b}
        if n_b > 0:
            row["confidence"] = float(cal_conf[b]) / n_b
            row["accuracy"] = float(cal_label[b]) / n_b
            ece += (n_b / total) * abs(row["accuracy"] - row["confidence"])
        bins.append(row)
    out["calibration"] = bins
    out["ece"] = ece if total > 0 else float("nan")
    return out


class QualityMonitor:
    """Publishes the quality digests into the process registry.

    One instance per Trainer (mirroring :class:`HealthMonitor`); the gate
    benchmark and the ``fedrec-obs quality`` CLI read what it publishes
    (``last_slices`` / ``last_distribution`` / ``last_outliers`` keep the
    raw dicts for in-process consumers)."""

    def __init__(self, qcfg: Any, registry: MetricsRegistry | None = None):
        self.cfg = qcfg
        self.registry = registry or get_registry()
        r = self.registry
        self._g_metric = {
            k: r.gauge(
                f"eval.{k}",
                f"sliced full-pool eval {k} (slice='all' = corpus mean)",
                labels=("slice",),
            )
            for k in METRIC_KEYS
        }
        self._g_slice_n = r.gauge(
            "eval.slice_impressions",
            "validation impressions contributing to the slice's last eval",
            labels=("slice",),
        )
        self._c_skipped = r.counter(
            "eval.slices_skipped_total",
            "slice evaluations skipped because the slice held no scoreable "
            "impression (empty stratum / single-class degenerate)",
        )
        self._g_ece = r.gauge(
            "eval.ece",
            "expected calibration error over the reliability bins of the "
            "last full-pool eval (sigmoid-score confidence vs click rate)",
        )
        self._g_cal_conf = r.gauge(
            "eval.calibration_confidence",
            "mean predicted click probability in the reliability bin",
            labels=("bin",),
        )
        self._g_cal_acc = r.gauge(
            "eval.calibration_accuracy",
            "observed positive rate in the reliability bin",
            labels=("bin",),
        )
        self._g_cal_n = r.gauge(
            "eval.calibration_count",
            "scored candidates in the reliability bin (last eval)",
            labels=("bin",),
        )
        self._h_pos = r.histogram(
            "eval.pos_score", "positive candidate scores (full-pool eval)",
            buckets=self._score_buckets(),
        )
        self._h_neg = r.histogram(
            "eval.neg_score", "negative candidate scores (full-pool eval)",
            buckets=self._score_buckets(),
        )
        self._g_sep = r.gauge(
            "eval.score_separation",
            "mean positive score minus mean negative score (last eval)",
        )
        self._g_dprime = r.gauge(
            "eval.score_dprime",
            "separation / pooled std — the scale-free margin between the "
            "positive and negative score distributions",
        )
        self._g_client_auc = r.gauge(
            "eval.client_auc",
            "per-device-client full-pool eval AUC (diverged clients only; "
            "in-sync cohorts publish the shared value under client 0)",
            labels=("client",),
        )
        self._c_outliers = r.counter(
            "eval.quality_outlier_clients_total",
            "client-evals whose AUC fell obs.quality.outlier_auc_drop below "
            "the cohort median (informational — never triggers quarantine)",
        )
        self._g_outliers = r.gauge(
            "eval.quality_outlier_clients",
            "quality-outlier clients in the last eval",
        )
        self.last_slices: dict[str, dict] = {}
        self.last_skipped: list[str] = []
        self.last_distribution: dict | None = None
        self.last_outliers: list[dict] = []
        # clients whose eval.client_auc cell has ever been written: when
        # the cohort resyncs, every one of them is overwritten with the
        # shared value — a gauge cell from a diverged era must not
        # outlive the divergence (the registry has no cell-delete)
        self._published_clients: set[str] = set()

    def _score_buckets(self) -> tuple:
        lo = -float(self.cfg.score_range)
        width = 2.0 * float(self.cfg.score_range) / int(self.cfg.score_bins)
        return tuple(lo + width * (i + 1) for i in range(int(self.cfg.score_bins) - 1))

    # ---------------------------------------------------------- publishing
    def publish_slices(
        self, slices: Mapping[str, dict], skipped: Sequence[str] = ()
    ) -> None:
        for name, m in slices.items():
            for k in METRIC_KEYS:
                self._g_metric[k].set(float(m[k]), slice=name)
            self._g_slice_n.set(float(m["count"]), slice=name)
        if skipped:
            self._c_skipped.inc(len(skipped))
        self.last_slices = dict(slices)
        self.last_skipped = list(skipped)

    def publish_corpus(self, metrics: Mapping[str, float], count: float) -> None:
        """The corpus-wide quartet under ``slice="all"`` — so one scrape
        shows the mean AND the strata it hides."""
        for k in METRIC_KEYS:
            if k in metrics:
                self._g_metric[k].set(float(metrics[k]), slice="all")
        self._g_slice_n.set(float(count), slice="all")

    def publish_distribution(self, acc: Mapping[str, np.ndarray]) -> dict:
        dist = reduce_quality_sums(acc, int(self.cfg.ece_bins))
        # histogram merge: quality_stats_batch clamps to the edge bins, so
        # bucket i of the in-graph histogram maps 1:1 onto the registry
        # histogram's i-th bucket (last in-graph bin -> +Inf bucket)
        for hist, key, total_key, sum_mean in (
            (self._h_pos, "pos_hist", "pos_n", "pos_mean"),
            (self._h_neg, "neg_hist", "neg_n", "neg_mean"),
        ):
            counts = [int(round(c)) for c in dist[key]]
            n = int(round(dist[total_key]))
            approx_sum = dist.get(sum_mean, 0.0) * n
            hist.merge_counts(counts, approx_sum, n)
        if "separation" in dist:
            self._g_sep.set(dist["separation"])
            self._g_dprime.set(dist["dprime"])
        if np.isfinite(dist["ece"]):
            self._g_ece.set(dist["ece"])
        for row in dist["calibration"]:
            b = str(row["bin"])
            self._g_cal_n.set(row["count"], bin=b)
            if "confidence" in row:
                self._g_cal_conf.set(row["confidence"], bin=b)
                self._g_cal_acc.set(row["accuracy"], bin=b)
        self.last_distribution = dist
        return dist

    # ---------------------------------------------------- per-client digest
    def digest_clients(
        self,
        round_idx: int,
        per_client: Sequence[Mapping[str, float]] | None,
        ignore_clients: set[int] | None = None,
        shared: Mapping[str, float] | None = None,
    ) -> list[dict]:
        """Per-client quality digest at eval cadence.

        ``per_client`` is the Trainer's per-client eval breakdown (None
        when clients are in sync — identical params cannot diverge in
        quality, so ``shared``'s corpus value is published under client 0
        AND over every previously-published client cell: a per-client
        gauge from a diverged era must not survive the resync as if it
        were this eval's number).  Quarantined clients
        (``ignore_clients``) keep their gauge published (their eval is
        real) but are excluded from the median AND from flagging — their
        weight is already 0 and their numbers are the quarantine's
        evidence, not new signal.  Returns the outlier records (also
        kept on ``last_outliers``); NEVER raises or quarantines.
        """
        ignore = ignore_clients or set()
        outliers: list[dict] = []
        if not per_client and shared is not None and "auc" in shared:
            for c in self._published_clients | {"0"}:
                self._g_client_auc.set(float(shared["auc"]), client=c)
            self._published_clients.add("0")
        if per_client:
            all_aucs = {
                c: float(m["auc"])
                for c, m in enumerate(per_client)
                if "auc" in m and np.isfinite(m["auc"])
            }
            for c, a in all_aucs.items():
                self._g_client_auc.set(a, client=str(c))
                self._published_clients.add(str(c))
            aucs = {c: a for c, a in all_aucs.items() if c not in ignore}
            drop = float(self.cfg.outlier_auc_drop or 0.0)
            if drop > 0 and len(aucs) >= 2:
                med = float(np.median(list(aucs.values())))
                for c, a in sorted(aucs.items()):
                    if a < med - drop:
                        outliers.append({
                            "round": int(round_idx),
                            "client": c,
                            "auc": a,
                            "cohort_median": med,
                        })
        if outliers:
            self._c_outliers.inc(len(outliers))
            worst = min(outliers, key=lambda o: o["auc"])
            print(
                f"[quality] quality-outlier client(s) "
                f"{sorted(o['client'] for o in outliers)} in round "
                f"{round_idx}: worst auc {worst['auc']:.4f} vs cohort median "
                f"{worst['cohort_median']:.4f} "
                f"(drop threshold {self.cfg.outlier_auc_drop})"
            )
        self._g_outliers.set(float(len(outliers)))
        self.last_outliers = outliers
        return outliers


# --------------------------------------------------------------------------
# serving drift probe
# --------------------------------------------------------------------------


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
