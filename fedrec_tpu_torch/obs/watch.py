"""The continuous watch layer, the port of ``fedrec_tpu/obs/watch.py``:
declarative SLOs, burn rates, anomaly detection and the fleet rules (host
only).

* Declarative SLOs (``obs.slo.objectives``, :func:`parse_slo_spec`):
  objectives over metrics the registry already publishes. Histograms are
  read as per-evaluation bucket deltas (this round's quantile, not the
  lifetime distribution), counters as deltas, gauges and ``MetricLogger``
  record keys at face value.
* Multi-window burn rates (:class:`BurnRateEvaluator`): an alert fires when
  the burn rate (bad fraction / error budget) passes ``fast_burn`` over the
  fast window and ``slow_burn`` over the slow one; windows count
  evaluations, so one spec scales from round cadence (``Trainer``) to
  heartbeat cadence (the serve CLI) to commit cadence (``agg.server``).
* Streaming anomaly detection (:class:`AnomalyDetector`): an EWMA baseline
  and a MAD-scaled robust z-score per round-cadence series.
* One trigger path: the health monitor's trigger and outliers, the quality
  digest's outliers, the serving drift probe and the perf efficiency drop
  pulse through the same engine; the perf capture arms off the drop
  alert's firing transition.
* Fleet rules (:class:`FleetRules`), evaluated by the collector a push:
  the persistent straggler, the world below target, quorum-wait growth, a
  stalled commit version, a partitioned edge.

Nothing here is built unless ``obs.slo.enabled`` is set: a run without it
registers no ``alert.*`` instrument and trains bitwise as before.
"""

from __future__ import annotations

import math
import re
import statistics
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from fedrec_tpu_torch.obs.alerts import AlertEngine
from fedrec_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    quantile_from_counts,
)

# the one perf-drop alert key: PerfMonitor's capture arms when THIS key
# transitions to firing (obs.perf)
PERF_DROP_KEY = "perf:efficiency_drop"

_OBJECTIVE_RE = re.compile(
    r"^(?P<name>[A-Za-z0-9_\-]+)"
    r":(?P<metric>[a-zA-Z0-9_.:@]+?)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"(?::p(?P<q>[0-9]+(?:\.[0-9]+)?))?"
    r"(?P<op><=|>=|<|>)"
    r"(?P<thr>-?[0-9.eE+\-]+)"
    r"(?:@(?P<target>0?\.[0-9]+|1(?:\.0*)?))?$"
)


@dataclass
class SloObjective:
    """One parsed ``obs.slo.objectives`` entry."""

    name: str
    metric: str
    op: str
    threshold: float
    labels: dict[str, str] = field(default_factory=dict)
    quantile: float | None = None      # pQQ -> 0.QQ; None = gauge/mean read
    target: float = 0.99               # per-objective error-budget target

    def good(self, value: float) -> bool:
        if self.op == "<":
            return value < self.threshold
        if self.op == "<=":
            return value <= self.threshold
        if self.op == ">":
            return value > self.threshold
        return value >= self.threshold

    def describe(self) -> str:
        lbl = (
            "{" + ",".join(f"{k}={v}" for k, v in sorted(self.labels.items()))
            + "}" if self.labels else ""
        )
        q = f":p{self.quantile * 100:g}" if self.quantile is not None else ""
        return f"{self.metric}{lbl}{q}{self.op}{self.threshold:g}"


def parse_slo_spec(spec: str, default_target: float = 0.99) -> list[SloObjective]:
    """``obs.slo.objectives`` -> objectives; raises ValueError naming the
    malformed entry (grammar: ``name:metric[{k=v,..}][:pQQ]OPthr[@target]``)."""
    out: list[SloObjective] = []
    seen: set[str] = set()
    for raw in str(spec or "").split(";"):
        part = "".join(raw.split())  # whitespace is never significant
        if not part:
            continue
        m = _OBJECTIVE_RE.match(part)
        if m is None:
            raise ValueError(
                f"bad obs.slo.objectives entry {raw.strip()!r} — expected "
                "name:metric[{label=value,...}][:pQQ]<op>threshold[@target] "
                "with <op> one of < <= > >= "
                "(e.g. round_time:train.round_seconds:p95<2.5)"
            )
        labels: dict[str, str] = {}
        for pair in (m.group("labels") or "").split(","):
            if not pair:
                continue
            if "=" not in pair:
                raise ValueError(
                    f"bad obs.slo.objectives label {pair!r} in {raw.strip()!r}"
                    " — labels are comma-separated key=value pairs"
                )
            k, v = pair.split("=", 1)
            labels[k] = v
        q = m.group("q")
        quantile = None
        if q is not None:
            quantile = float(q) / 100.0
            if not 0.0 < quantile <= 1.0:
                raise ValueError(
                    f"bad obs.slo.objectives quantile p{q} in {raw.strip()!r}"
                    " — must lie in (0, 100]"
                )
        name = m.group("name")
        if name in seen:
            raise ValueError(
                f"duplicate obs.slo.objectives name {name!r} — each "
                "objective keys its own alert and burn-rate gauges"
            )
        seen.add(name)
        target = float(m.group("target") or default_target)
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"bad obs.slo.objectives target {target} for {name!r} — "
                "must lie in (0, 1) (the error budget is 1 - target)"
            )
        out.append(SloObjective(
            name=name, metric=m.group("metric"), op=m.group("op"),
            threshold=float(m.group("thr")), labels=labels,
            quantile=quantile, target=target,
        ))
    return out


class BurnRateEvaluator:
    """Good/bad event window + the two burn rates for one objective.

    ``burn = bad_fraction / (1 - target)`` over each window; the alert
    condition is BOTH windows over their thresholds (the fast window
    catches the page-worthy spike, the slow window keeps a brief blip
    from paging — the Google-SRE multi-window idiom, with windows in
    evaluations instead of wall minutes so the thresholds scale with
    cadence)."""

    def __init__(
        self,
        objective: SloObjective,
        fast_window: int,
        slow_window: int,
        fast_burn: float,
        slow_burn: float,
    ):
        self.objective = objective
        self.fast_window = max(int(fast_window), 1)
        self.slow_window = max(int(slow_window), self.fast_window)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self._events: deque[bool] = deque(maxlen=self.slow_window)

    def observe(self, value: float) -> dict:
        """Score one evaluation's value; returns the burn verdict."""
        self._events.append(not self.objective.good(float(value)))
        return self.verdict()

    def verdict(self) -> dict:
        budget = max(1.0 - self.objective.target, 1e-9)
        ev = list(self._events)
        fast = ev[-self.fast_window:]
        fast_rate = sum(fast) / len(fast) if fast else 0.0
        slow_rate = sum(ev) / len(ev) if ev else 0.0
        fast_burn = fast_rate / budget
        slow_burn = slow_rate / budget
        return {
            "fast_burn": fast_burn,
            "slow_burn": slow_burn,
            "breached": bool(
                ev
                and fast_burn >= self.fast_burn
                and slow_burn >= self.slow_burn
            ),
        }


class AnomalyDetector:
    """EWMA baseline + MAD robust z-score over round-cadence series.

    Per series: the baseline is an exponentially weighted moving average,
    the scale a median-absolute-deviation over the trailing residual
    window (``1.4826 * MAD`` estimates sigma robustly — one outlier
    cannot inflate its own yardstick the way a stddev would).  A point
    fires when ``|x - ewma - median(residuals)| / scale`` exceeds ``z``
    after ``warmup`` observations; the baseline keeps adapting through
    an anomaly, so a true level shift resolves itself once the new
    regime becomes the baseline."""

    _MIN_RESIDUALS = 4

    def __init__(
        self,
        alpha: float = 0.3,
        window: int = 32,
        z: float = 6.0,
        warmup: int = 8,
    ):
        self.alpha = min(max(float(alpha), 0.0), 1.0)
        self.window = max(int(window), self._MIN_RESIDUALS)
        self.z = float(z)
        self.warmup = max(int(warmup), 1)
        self._state: dict[str, dict] = {}

    def observe(self, key: str, value: float) -> dict | None:
        """Feed one point; returns anomaly info when it fires, else None."""
        value = float(value)
        if not math.isfinite(value):
            return None
        st = self._state.get(key)
        if st is None:
            self._state[key] = {
                "ewma": value, "resid": deque(maxlen=self.window), "n": 1,
            }
            return None
        residual = value - st["ewma"]
        fired: dict | None = None
        resid = st["resid"]
        if st["n"] >= self.warmup and len(resid) >= self._MIN_RESIDUALS:
            med = statistics.median(resid)
            mad = statistics.median(abs(r - med) for r in resid)
            # absolute floor keeps a constant series (MAD 0) from firing
            # on float jitter while a real step still registers
            scale = max(1.4826 * mad, 1e-9 * max(1.0, abs(st["ewma"])))
            zscore = abs(residual - med) / scale
            if zscore > self.z:
                fired = {
                    "series": key, "value": value, "z": zscore,
                    "baseline": st["ewma"],
                }
        st["ewma"] += self.alpha * residual
        resid.append(residual)
        st["n"] += 1
        return fired


class Watch:
    """The in-process watch: SLO burn rates + anomaly detection + the
    unified trigger pulses, all draining into one
    :class:`~fedrec_tpu_torch.obs.alerts.AlertEngine`.

    ``evaluate()`` runs once per cadence tick (round / heartbeat /
    commit) with the tick's MetricLogger record (when one exists); the
    four legacy trigger paths pulse between ticks via the ``ingest_*``
    helpers and are scored at the next ``evaluate()``."""

    def __init__(
        self,
        slo_cfg: Any,
        watch_cfg: Any,
        *,
        registry: MetricsRegistry | None = None,
        tracer: Any = None,
        jsonl_path=None,
        jsonl_max_mb: float = 0.0,
    ):
        self.registry = registry or get_registry()
        self.objectives = parse_slo_spec(
            slo_cfg.objectives, float(slo_cfg.target)
        )
        self._evaluators = [
            BurnRateEvaluator(
                o,
                fast_window=slo_cfg.fast_window,
                slow_window=slo_cfg.slow_window,
                fast_burn=slo_cfg.fast_burn,
                slow_burn=slo_cfg.slow_burn,
            )
            for o in self.objectives
        ]
        self.engine = AlertEngine(
            registry=self.registry,
            tracer=tracer,
            pending_for=watch_cfg.pending_for,
            resolve_after=watch_cfg.resolve_after,
            flap_max=watch_cfg.flap_max,
            flap_window=watch_cfg.flap_window,
            history=watch_cfg.history,
            jsonl_path=jsonl_path,
            jsonl_max_mb=jsonl_max_mb,
        )
        self.anomaly: AnomalyDetector | None = None
        if watch_cfg.anomaly:
            self.anomaly = AnomalyDetector(
                alpha=watch_cfg.anomaly_alpha,
                window=watch_cfg.anomaly_window,
                z=watch_cfg.anomaly_z,
                warmup=watch_cfg.anomaly_warmup,
            )
        self.drift_churn_max = float(watch_cfg.drift_churn_max)
        # per-objective counter/histogram cursors for delta reads
        self._cursors: dict[str, Any] = {}
        self._pulses: dict[str, dict] = {}
        self._pulse_active: set[str] = set()
        self._c_evals = self.registry.counter(
            "alert.evaluations_total",
            "watch-layer evaluation ticks performed (round / heartbeat / "
            "commit cadence)",
        )
        self._g_burn = self.registry.gauge(
            "alert.slo_burn_rate",
            "last evaluated burn rate (bad fraction / error budget) per "
            "SLO objective and window",
            labels=("slo", "window"),
        )

    # ----------------------------------------------------------- plumbing
    def bind_perf(self, perf: Any) -> None:
        """Route the perf efficiency-drop trigger through the engine and
        arm the capture off the alert's FIRING transition (the unified
        replacement for PerfMonitor's private pending flag)."""
        perf.watch_hook = self.ingest_perf_drop

        def _arm(alert, event: str) -> None:
            if event == "firing" and alert.key == PERF_DROP_KEY:
                perf.arm_capture()

        self.engine.subscribe(_arm)

    def pulse(
        self,
        key: str,
        *,
        severity: str = "warning",
        summary: str = "",
        labels: dict[str, Any] | None = None,
        value: float | None = None,
        threshold: float | None = None,
    ) -> None:
        """Mark ``key`` breached for the CURRENT cadence tick; scored (and
        auto-cleared when the pulse stops repeating) at ``evaluate()``."""
        self._pulses[key] = {
            "severity": severity, "summary": summary,
            "labels": dict(labels or {}), "value": value,
            "threshold": threshold,
        }

    # ------------------------------------------------- unified trigger paths
    def ingest_health_trigger(self, trigger: dict | None) -> None:
        """HealthMonitor trigger dict (kind in nonfinite/loss_spike)."""
        if not trigger:
            return
        kind = str(trigger.get("kind", "trigger"))
        self.pulse(
            f"health:{kind}",
            severity="critical",
            summary=(
                f"health {kind} at round {trigger.get('round')}"
                + (f" client {trigger['client']}"
                   if trigger.get("client") is not None else "")
            ),
            labels={k: trigger[k] for k in ("round", "client")
                    if trigger.get(k) is not None},
            value=trigger.get("round_loss"),
        )

    def ingest_health_outliers(self, outliers: list[dict] | None) -> None:
        """HealthMonitor update-norm outlier list (poisoning triage)."""
        if not outliers:
            return
        worst = max(outliers, key=lambda o: o.get("update_norm", 0.0))
        clients = sorted(set(o["client"] for o in outliers))
        self.pulse(
            "health:outlier_clients",
            severity="warning",
            summary=(
                f"update-norm outlier client(s) {clients}: worst "
                f"{worst.get('update_norm', 0.0):.3g} vs cohort median "
                f"{worst.get('cohort_median', 0.0):.3g}"
            ),
            labels={"clients": ",".join(str(c) for c in clients)},
            value=worst.get("update_norm"),
            threshold=worst.get("cohort_median"),
        )

    def ingest_quality_outliers(self, outliers: list[dict] | None) -> None:
        """QualityMonitor per-client eval-AUC outlier digest."""
        if not outliers:
            return
        worst = min(outliers, key=lambda o: o.get("auc", 1.0))
        clients = sorted(set(o["client"] for o in outliers))
        self.pulse(
            "quality:outlier_clients",
            severity="warning",
            summary=(
                f"quality outlier client(s) {clients}: worst auc "
                f"{worst.get('auc', 0.0):.4f} vs cohort median "
                f"{worst.get('cohort_median', 0.0):.4f}"
            ),
            labels={"clients": ",".join(str(c) for c in clients)},
            value=worst.get("auc"),
            threshold=worst.get("cohort_median"),
        )

    def ingest_drift(self, stats: dict | None) -> None:
        """Serving drift-probe result (EmbeddingStore.metrics() keys or a
        DriftProbe.compare dict): breach on top-k rank churn past
        ``obs.watch.drift_churn_max``."""
        if not stats or self.drift_churn_max <= 0:
            return
        churn = stats.get("drift_rank_churn", stats.get("rank_churn"))
        if churn is None:
            return
        if float(churn) > self.drift_churn_max:
            self.pulse(
                "serve:drift",
                severity="critical",
                summary=(
                    f"pre-swap drift probe breach: rank churn "
                    f"{float(churn):.3f} > {self.drift_churn_max:g}"
                ),
                value=float(churn),
                threshold=self.drift_churn_max,
            )

    def ingest_perf_drop(
        self, round_idx: int, rate: float, trailing_mean: float
    ) -> None:
        """PerfMonitor efficiency-drop trigger (samples/s below the
        trailing-window mean); the capture arms when the alert FIRES."""
        self.pulse(
            PERF_DROP_KEY,
            severity="warning",
            summary=(
                f"round {round_idx} samples/s {rate:.1f} fell below the "
                f"trailing mean {trailing_mean:.1f}"
            ),
            labels={"round": round_idx},
            value=rate,
            threshold=trailing_mean,
        )

    # ----------------------------------------------------------- evaluation
    def _read_value(self, o: SloObjective, record: dict | None) -> float | None:
        if record is not None and not o.labels:
            v = record.get(o.metric)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return float(v)
        m = self.registry.get(o.metric)
        if m is None:
            return None
        try:
            if isinstance(m, Histogram):
                cell = m.cell(**o.labels)
                if cell is None:
                    return None
                prev = self._cursors.get(o.name) or {
                    "counts": [0] * len(cell["counts"]), "sum": 0.0,
                    "count": 0,
                }
                self._cursors[o.name] = cell
                dcounts = [c - p for c, p in zip(cell["counts"], prev["counts"])]
                dcount = cell["count"] - prev["count"]
                if dcount <= 0:
                    return None
                if o.quantile is not None:
                    return quantile_from_counts(o.quantile, m.buckets, dcounts)
                return (cell["sum"] - prev["sum"]) / dcount
            if isinstance(m, Counter):
                cur = m.value(**o.labels)
                prev = self._cursors.get(o.name, 0.0)
                self._cursors[o.name] = cur
                return cur - prev
            if isinstance(m, Gauge):
                return m.value(**o.labels)
        except ValueError:
            return None  # label set mismatch: the objective names labels
        return None       # the instrument doesn't carry

    def evaluate(self, record: dict | None = None) -> list[dict]:
        """One cadence tick: score every objective, run the anomaly
        detector over the record's series, drain trigger pulses.
        Returns the currently active alerts."""
        self._c_evals.inc()
        for ev in self._evaluators:
            o = ev.objective
            value = self._read_value(o, record)
            if value is None:
                continue
            verdict = ev.observe(value)
            self._g_burn.set(verdict["fast_burn"], slo=o.name, window="fast")
            self._g_burn.set(verdict["slow_burn"], slo=o.name, window="slow")
            self.engine.observe(
                f"slo:{o.name}",
                verdict["breached"],
                severity="critical",
                summary=(
                    f"SLO {o.name} burning: {o.describe()} "
                    f"(fast burn {verdict['fast_burn']:.1f}x, slow "
                    f"{verdict['slow_burn']:.1f}x budget)"
                ),
                labels={"slo": o.name, "metric": o.metric},
                value=value,
                threshold=o.threshold,
            )
        if self.anomaly is not None and record:
            for series, v in record.items():
                if series == "round" or isinstance(v, bool):
                    continue
                if not isinstance(v, (int, float)):
                    continue
                hit = self.anomaly.observe(series, float(v))
                self.engine.observe(
                    f"anomaly:{series}",
                    hit is not None,
                    severity="warning",
                    summary=(
                        f"anomalous {series}: {hit['value']:.6g} is "
                        f"{hit['z']:.1f} robust sigmas off the EWMA "
                        f"baseline {hit['baseline']:.6g}"
                    ) if hit else "",
                    labels={"series": series},
                    value=float(v),
                    pending_for=1,
                )
        pulses, self._pulses = self._pulses, {}
        for key in sorted(self._pulse_active | set(pulses)):
            info = pulses.get(key)
            alive = self.engine.observe(
                key,
                info is not None,
                pending_for=1,
                **(info or {}),
            )
            if alive is None:
                self._pulse_active.discard(key)
            else:
                self._pulse_active.add(key)
        return self.engine.active()


# --------------------------------------------------------------- fleet rules
class FleetRules:
    """Fleet-level watch rules, evaluated collector-side per telemetry
    push (the collector/membership service sees every worker, which no
    in-process watch does):

    * **persistent straggler** — two signatures, one alert, both vs
      ``fleet_straggler_factor`` x the fleet median for
      ``fleet_straggler_evals`` consecutive pushes, named in the alert:
      per-push mean round seconds (the sync/trainer signature — the
      live twin of the offline critical-path attribution) and push
      inter-arrival gap from the snapshot timestamps (the async
      signature: a worker that sleeps at the push boundary never
      inflates its own round_seconds, but cannot hide its arrival
      cadence);
    * **world below target** — formation world dropped under the target
      complement after having reached it (``observe_world``, fed by the
      membership service);
    * **quorum-wait growth** — the last ``agg.quorum_wait_ms`` exceeds
      ``fleet_quorum_factor`` x the trailing median (commits are waiting
      ever longer for quorum: workers dying or slowing);
    * **stalled commit version** — a worker's adopted global version
      (``agg.adopted_version``) stops advancing for
      ``fleet_stalled_pushes`` pushes while its rounds keep completing
      (commit authority dead or unreachable; only armed once a commit
      was ever adopted, so sync runs never match);
    * **partitioned edge** — a worker's per-peer ``wire.errors_total``
      keeps growing across ``fleet_stalled_pushes`` pushes while its
      ``wire.requests_total`` to the SAME peer does not: every exchange
      on that edge is failing, which separates a network partition (the
      worker is alive and pushing telemetry through a different edge)
      from a dead worker (no pushes at all — the straggler/world rules'
      territory).  The alert NAMES the edge: worker, peer, and the
      error count the window accumulated.

    Alert records land in ``<collector dir>/worker_fleet/metrics.jsonl``
    — the same worker-dir layout every fleet reader already consumes, so
    ``fedrec-obs alerts``/``fleet`` render them with no new plumbing.
    """

    _QUORUM_WINDOW = 16
    _QUORUM_MIN_PRIOR = 4

    def __init__(
        self,
        watch_cfg: Any = None,
        *,
        target_world: int = 0,
        registry: MetricsRegistry | None = None,
        tracer: Any = None,
        jsonl_path=None,
    ):
        if watch_cfg is None:
            from fedrec_tpu_torch.config import WatchConfig

            watch_cfg = WatchConfig()
        self.straggler_factor = float(watch_cfg.fleet_straggler_factor)
        self.straggler_evals = max(int(watch_cfg.fleet_straggler_evals), 1)
        self.quorum_factor = float(watch_cfg.fleet_quorum_factor)
        self.stalled_pushes = max(int(watch_cfg.fleet_stalled_pushes), 1)
        self.target_world = int(target_world)
        self.engine = AlertEngine(
            registry=registry,
            tracer=tracer,
            pending_for=1,
            resolve_after=watch_cfg.resolve_after,
            flap_max=watch_cfg.flap_max,
            flap_window=watch_cfg.flap_window,
            history=watch_cfg.history,
            jsonl_path=jsonl_path,
        )
        # per-worker cursors: round-seconds (sum, count), push arrival
        # ts/gap, rounds, version
        self._round_cursor: dict[str, tuple[float, float]] = {}
        self._round_mean: dict[str, float] = {}
        self._push_ts: dict[str, float] = {}
        self._push_gap: dict[str, float] = {}
        self._rounds: dict[str, float] = {}
        self._version: dict[str, float] = {}
        self._version_seen: set[str] = set()
        self._stalled: dict[str, int] = {}
        self._quorum: deque[float] = deque(maxlen=self._QUORUM_WINDOW)
        self._world_was_full = False
        # per-(worker, peer) wire cursors for the partitioned-edge rule
        self._edge_err: dict[tuple[str, str], float] = {}
        self._edge_req: dict[tuple[str, str], float] = {}
        self._edge_stall: dict[tuple[str, str], int] = {}

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _snap_value(snap: dict, name: str) -> float | None:
        from fedrec_tpu_torch.obs.report import snapshot_value

        return snapshot_value(snap, name)

    @staticmethod
    def _edge_totals(snap: dict, name: str) -> dict[str, float]:
        """Per-peer totals of a peer-labelled wire counter (ops summed
        away) out of one snapshot."""
        totals: dict[str, float] = {}
        rows = snap.get("metrics", {}).get(name, {}).get("values", [])
        for row in rows:
            peer = (row.get("labels") or {}).get("peer")
            if peer:
                totals[str(peer)] = (
                    totals.get(str(peer), 0.0) + float(row.get("value", 0.0))
                )
        return totals

    @staticmethod
    def _round_cell(snap: dict) -> tuple[float, float] | None:
        rows = (
            snap.get("metrics", {}).get("train.round_seconds", {})
            .get("values", [])
        )
        for row in rows:
            if not row.get("labels"):
                return float(row.get("sum", 0.0)), float(row.get("count", 0.0))
        return None

    # ------------------------------------------------------------ evaluate
    def observe_world(self, world: int) -> None:
        """Membership-side hook: fire once the formed world drops below
        the target complement it previously reached."""
        if self.target_world <= 0:
            return
        world = int(world)
        if world >= self.target_world:
            self._world_was_full = True
        self.engine.observe(
            "fleet:world_below_target",
            self._world_was_full and world < self.target_world,
            severity="critical",
            summary=(
                f"membership world {world} below target "
                f"{self.target_world}"
            ),
            labels={"world": world, "target": self.target_world},
            value=float(world),
            threshold=float(self.target_world),
        )

    def observe_push(self, worker: str, snapshot: dict | None) -> None:
        """Score one worker's telemetry push against every fleet rule."""
        if not isinstance(snapshot, dict):
            return
        wid = str(worker)
        # ---- persistent straggler: two signatures feed ONE alert key.
        # The round-seconds delta catches a worker whose rounds ARE slow;
        # the push inter-arrival gap catches one that is slow to the
        # wire (an async chaos straggler sleeps at the push boundary —
        # outside its own round timer — but its snapshot timestamps
        # cannot hide the cadence). Each signal compares against the
        # fleet median of the SAME signal.
        cell = self._round_cell(snapshot)
        if cell is not None:
            prev = self._round_cursor.get(wid, (0.0, 0.0))
            self._round_cursor[wid] = cell
            dsum, dcount = cell[0] - prev[0], cell[1] - prev[1]
            if dcount > 0:
                self._round_mean[wid] = dsum / dcount
        ts = snapshot.get("ts")
        if isinstance(ts, (int, float)):
            prev_ts = self._push_ts.get(wid)
            self._push_ts[wid] = float(ts)
            if prev_ts is not None and ts > prev_ts:
                self._push_gap[wid] = float(ts) - prev_ts
        verdicts = []
        for signal, table in (
            ("round", self._round_mean), ("push gap", self._push_gap),
        ):
            mine = table.get(wid)
            if mine is None or len(table) < 2:
                continue
            med = statistics.median(table.values())
            verdicts.append(
                (signal, mine, med,
                 med > 0 and mine > self.straggler_factor * med)
            )
        if verdicts:
            breached = [v for v in verdicts if v[3]]
            signal, mine, med, _ = breached[0] if breached else verdicts[0]
            self.engine.observe(
                f"fleet:straggler:{wid}",
                bool(breached),
                severity="warning",
                summary=(
                    f"persistent straggler: worker {wid} mean {signal} "
                    f"{mine:.2f}s vs fleet median {med:.2f}s "
                    f"(> {self.straggler_factor:g}x)"
                ),
                labels={"worker": wid, "signal": signal},
                value=mine,
                threshold=(
                    self.straggler_factor * med if med > 0 else None
                ),
                pending_for=self.straggler_evals,
            )
        # ---- quorum-wait growth (any worker's agg.quorum_wait_ms gauge)
        qw = self._snap_value(snapshot, "agg.quorum_wait_ms")
        if qw is not None and qw > 0:
            prior = list(self._quorum)
            self._quorum.append(float(qw))
            if len(prior) >= self._QUORUM_MIN_PRIOR:
                med = statistics.median(prior)
                self.engine.observe(
                    "fleet:quorum_wait_growth",
                    med > 0 and qw > self.quorum_factor * med,
                    severity="warning",
                    summary=(
                        f"quorum wait growing: {qw:.0f} ms vs trailing "
                        f"median {med:.0f} ms (> {self.quorum_factor:g}x)"
                    ),
                    value=float(qw),
                    threshold=self.quorum_factor * med if med > 0 else None,
                )
        # ---- stalled commit version: rounds advance, adopted version
        # doesn't (armed only after a first commit was ever adopted)
        rounds = self._snap_value(snapshot, "train.rounds_total")
        version = self._snap_value(snapshot, "agg.adopted_version")
        if rounds is not None and version is not None:
            prev_rounds = self._rounds.get(wid)
            prev_version = self._version.get(wid)
            self._rounds[wid], self._version[wid] = rounds, version
            if version > 0:
                self._version_seen.add(wid)
            if (
                wid in self._version_seen
                and prev_rounds is not None
                and rounds > prev_rounds
                and prev_version is not None
                and version <= prev_version
            ):
                self._stalled[wid] = self._stalled.get(wid, 0) + 1
            else:
                self._stalled[wid] = 0
            if wid in self._version_seen:
                self.engine.observe(
                    f"fleet:stalled_commit:{wid}",
                    self._stalled[wid] >= self.stalled_pushes,
                    severity="critical",
                    summary=(
                        f"stalled commit version: worker {wid} still at "
                        f"global version {version:g} after "
                        f"{self._stalled[wid]} pushes of completed rounds"
                    ),
                    labels={"worker": wid},
                    value=version,
                )
        # ---- partitioned edge: per-peer wire errors grow while requests
        # to the same peer do not — the edge is black-holed, and because
        # this telemetry push itself arrived, the WORKER is alive: a
        # partition, not a death. The alert names the edge.
        errs = self._edge_totals(snapshot, "wire.errors_total")
        if errs:
            reqs = self._edge_totals(snapshot, "wire.requests_total")
            for peer, err_total in errs.items():
                ek = (wid, peer)
                prev_err = self._edge_err.get(ek)
                prev_req = self._edge_req.get(ek, 0.0)
                req_total = reqs.get(peer, 0.0)
                self._edge_err[ek] = err_total
                self._edge_req[ek] = req_total
                if prev_err is None:
                    continue
                if err_total > prev_err and req_total <= prev_req:
                    self._edge_stall[ek] = self._edge_stall.get(ek, 0) + 1
                else:
                    self._edge_stall[ek] = 0
                stalled = self._edge_stall[ek]
                self.engine.observe(
                    f"fleet:partition:{wid}->{peer}",
                    stalled >= self.stalled_pushes,
                    severity="critical",
                    summary=(
                        f"partitioned edge: worker {wid} -> {peer} — wire "
                        f"errors at {err_total:g} and growing with no "
                        f"completed request for {stalled} pushes"
                    ),
                    labels={"worker": wid, "peer": peer},
                    value=err_total,
                )


# ------------------------------------------------------------ record readers
def alert_records(records: list[dict]) -> list[dict]:
    """The ``{"kind": "alert"}`` transition records out of a loaded event
    log, oldest first."""
    out = [r for r in records if r.get("kind") == "alert"]
    out.sort(key=lambda r: r.get("ts", 0.0))
    return out


def active_alerts(records: list[dict]) -> list[dict]:
    """Alerts whose LAST recorded transition is ``firing`` — the active
    set as of the end of the log (the offline twin of
    ``AlertEngine.active``)."""
    last: dict[str, dict] = {}
    for r in alert_records(records):
        key = r.get("key")
        if key:
            last[key] = r
    return [r for r in last.values() if r.get("event") == "firing"]
