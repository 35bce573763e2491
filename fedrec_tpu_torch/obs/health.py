"""Training-health monitor: the host side of the train step's numeric sentry.

A port of ``fedrec_tpu/obs/health.py`` (numpy; the port imports nothing of
the JAX package). With ``obs.health.sentry`` the train step returns a
per-client health vector every step (global grad, update and param norms,
a non-finite flag, and the per-example clip-rate under DP-SGD), kept on the
device; the trainer reads a round's worth once and hands it to
:meth:`HealthMonitor.check`, which publishes it as registry histograms and
gauges, flags outlier clients (round-mean update norm above ``outlier_k``
times the cohort median) and decides whether the round tripped a trigger
(a non-finite cell, or a loss spike against the trailing-window mean).

The flight recorder (``FlightRecorder``, under ``obs.dir`` with
``obs.health.flight_recorder``) keeps a ring of the last ``ring_size``
batches and the round-entry state of every client; on a trigger it dumps
them under ``obs.dir/flightrec/`` with the feature table (up to
``dump_table_max_mb``), the registry and a ``manifest.json`` with the JAX
package's keys. ``fedrec-obs replay`` re-runs the dumped steps. The state
file is the port's own: ``state.pt`` (``torch.save`` of the clients'
host tensors, as a snapshot's), where JAX writes ``state.msgpack``.
"""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from fedrec_tpu_torch.obs.registry import MetricsRegistry, get_registry

# log-spaced norm buckets: grad/update/param norms span decades; latency
# buckets would put every observation in one bin
NORM_BUCKETS = (
    1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 1e3, 1e4, 1e6
)
CLIP_RATE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)

class TrainingHealthError(RuntimeError):
    """Raised when the numeric sentry sees a non-finite step and
    ``obs.health.abort_on_nonfinite`` is set."""


def _observe_array(hist, arr: np.ndarray) -> None:
    """Publish every cell of ``arr`` into a registry histogram in ONE
    vectorized pass + one lock acquire (a per-cell ``observe()`` loop
    costs milliseconds per chunk on the round-critical host path).
    ``searchsorted(side='left')`` matches ``observe``'s inclusive-upper-
    bound ``bisect_left``; +inf (and nan, which compares unordered) land
    in the overflow bucket."""
    flat = np.asarray(arr, np.float64).reshape(-1)
    if flat.size == 0:
        return
    bounds = np.asarray(hist.buckets)
    idx = np.searchsorted(bounds, flat, side="left")
    counts = np.bincount(idx, minlength=len(bounds) + 1)
    hist.merge_counts(counts.tolist(), float(flat.sum()), int(flat.size))


class HealthMonitor:
    """Round-cadence digest of the sentry's health arrays.

    ``check()`` takes ``(rounds, steps, clients)``-shaped arrays (a
    host-driven round passes rounds=1) so the host-driven loop and the
    rounds-in-jit chunk share one code path — and one trigger policy.
    """

    def __init__(self, health_cfg: Any, registry: MetricsRegistry | None = None):
        self.cfg = health_cfg
        self.registry = registry or get_registry()
        r = self.registry
        self._h_grad = r.histogram(
            "health.grad_norm", "per-client per-step global grad norm "
            "(post-noise, pre-sync)", buckets=NORM_BUCKETS,
        )
        self._h_update = r.histogram(
            "health.update_norm", "per-client per-step optimizer-update norm",
            buckets=NORM_BUCKETS,
        )
        self._g_param = r.gauge(
            "health.param_norm", "last observed per-client param norm (max)"
        )
        self._c_nonfinite = r.counter(
            "health.nonfinite_steps_total",
            "step×client cells whose loss/grad/update/params went non-finite",
        )
        self._c_outliers = r.counter(
            "health.outlier_clients_total",
            "client-rounds whose mean update-norm exceeded k·cohort-median",
        )
        self._g_outliers = r.gauge(
            "health.outlier_clients", "outlier clients in the last round"
        )
        self._h_clip = r.histogram(
            "privacy.clip_rate",
            "per-step fraction of per-example grads clipped to C (dpsgd)",
            buckets=CLIP_RATE_BUCKETS,
        )
        self._g_clip = r.gauge(
            "privacy.clip_rate_last",
            "clip-rate of the last observed step (mean over clients)",
        )
        self._g_max_norm = r.gauge(
            "privacy.max_grad_norm",
            "largest pre-clip per-example grad norm in the last step (max "
            "over clients) — how far above/below C the raw grads sit",
        )
        self._loss_window: deque[float] = deque(
            maxlen=max(int(getattr(health_cfg, "spike_window", 8)), 1)
        )
        # outliers found by the most recent check() (post-ignore): the
        # Trainer's quarantine/rollback path reads this — an outlier alone
        # is not a dump trigger, but under fed.robust.recover it is a
        # quarantine trigger
        self.last_outliers: list[dict] = []
        # quality-outlier clients from the obs.quality per-client digest:
        # informational, a quality dip never quarantines
        self.last_quality_outliers: list[dict] = []

    # ------------------------------------------------------------ publish
    def publish_clip_rate(self, clip_rates: np.ndarray) -> None:
        """Publish dpsgd clip-rate observations: histogram per cell, gauge
        holds the last step's mean — the value the clip-rate correctness
        test pins exactly."""
        arr = np.asarray(clip_rates, np.float64)
        flat = arr.reshape(-1)
        if flat.size == 0:
            return
        _observe_array(self._h_clip, flat)
        last_step = arr.reshape(-1, arr.shape[-1])[-1] if arr.ndim >= 2 else flat
        self._g_clip.set(float(np.mean(last_step)))

    # -------------------------------------------------------------- check
    def check(
        self,
        start_round: int,
        rows: Mapping[str, np.ndarray],
        round_losses: list[float],
        ignore_clients: set[int] | None = None,
    ) -> dict | None:
        """Digest one round's (or chunk's) health arrays.

        ``rows`` values are shaped ``(rounds, steps, clients)``;
        ``round_losses`` has one mean loss per round.  Publishes registry
        instruments and returns a trigger dict (``kind`` ∈ {"nonfinite",
        "loss_spike"}) or None.  Non-finite wins over a spike — it is the
        root-cause signal.

        ``ignore_clients`` (the Trainer's quarantine set) suppresses
        triggers AND outlier flags from those clients: a quarantined
        client's weight is already 0, so its (expected) bad numbers must
        not re-trigger the rollback it caused — and must not pollute the
        cohort median other clients are judged against.  The outlier list
        of the last check (post-ignore) is kept on ``self.last_outliers``
        for the recovery path.
        """
        ignore = ignore_clients or set()
        arrays = {
            k: np.asarray(v, np.float64) for k, v in rows.items() if v is not None
        }
        trigger: dict | None = None

        grad = arrays.get("health.grad_norm")
        upd = arrays.get("health.update_norm")
        param = arrays.get("health.param_norm")
        if grad is not None:
            _observe_array(self._h_grad, grad)
        if upd is not None:
            _observe_array(self._h_update, upd)
        if param is not None and param.size:
            last = param.reshape(-1, param.shape[-1])[-1]
            self._g_param.set(float(np.max(last)))
        if "health.clip_rate" in arrays:
            self.publish_clip_rate(arrays["health.clip_rate"])
        if "health.clip_max_norm" in arrays:
            mx = arrays["health.clip_max_norm"]
            if mx.size:
                self._g_max_norm.set(
                    float(np.max(mx.reshape(-1, mx.shape[-1])[-1]))
                )

        # ---- outlier clients: round-mean update norm vs cohort median.
        # The median spans only eligible (non-ignored) clients with FINITE
        # norms: one NaN client would otherwise NaN the median and hide
        # every real outlier in the same round.
        k = float(getattr(self.cfg, "outlier_k", 0.0) or 0.0)
        outliers: list[dict] = []
        if upd is not None and k > 0 and upd.ndim == 3 and upd.shape[-1] >= 2:
            eligible = np.array(
                [c not in ignore for c in range(upd.shape[-1])], bool
            )
            for r in range(upd.shape[0]):
                per_client = upd[r].mean(axis=0)  # (clients,)
                base = per_client[eligible & np.isfinite(per_client)]
                if base.size < 2:
                    continue
                med = float(np.median(base))
                if med > 0 and np.isfinite(med):
                    for c in np.nonzero(per_client > k * med)[0]:
                        if not eligible[c]:
                            continue
                        outliers.append({
                            "round": start_round + r,
                            "client": int(c),
                            "update_norm": float(per_client[c]),
                            "cohort_median": med,
                        })
        self.last_outliers = outliers
        if outliers:
            self._c_outliers.inc(len(outliers))
        self._g_outliers.set(float(len(set(
            (o["round"], o["client"]) for o in outliers
        ))))

        # ---- non-finite sentinel (counter counts EVERY bad cell; the
        # trigger comes from the first cell of a non-ignored client)
        nf = arrays.get("health.nonfinite")
        if nf is not None and nf.sum() > 0:
            self._c_nonfinite.inc(float(nf.sum()))
            nf = nf.copy()
            for c in ignore:
                if 0 <= c < nf.shape[-1]:
                    nf[..., c] = 0
        if nf is not None and nf.sum() > 0:
            r, s, c = (int(i[0]) for i in np.nonzero(nf))
            detail = {
                key: float(arrays[key][r, s, c])
                for key in ("health.grad_norm", "health.update_norm",
                            "health.param_norm")
                if key in arrays
            }
            trigger = {
                "kind": "nonfinite",
                "round": start_round + r,
                "step": s,
                "client": c,
                "total_nonfinite_cells": float(nf.sum()),
                "detail": detail,
            }

        # ---- loss-spike divergence predicate (trailing-window mean)
        factor = float(getattr(self.cfg, "spike_factor", 0.0) or 0.0)
        for i, rl in enumerate(round_losses):
            if (
                trigger is None
                and factor > 0
                and len(self._loss_window) == self._loss_window.maxlen
                and np.isfinite(rl)
            ):
                trailing = float(np.mean(self._loss_window))
                if rl > factor * trailing:
                    trigger = {
                        "kind": "loss_spike",
                        "round": start_round + i,
                        "step": None,
                        "round_loss": float(rl),
                        "trailing_mean": trailing,
                        "factor": factor,
                    }
            if np.isfinite(rl):
                self._loss_window.append(float(rl))

        if outliers and trigger is None:
            # not a dump trigger, but worth a line: the operator's first
            # hint that one client is poisoning/diverging the cohort
            worst = max(outliers, key=lambda o: o["update_norm"])
            print(
                f"[health] outlier client(s) {sorted(set(o['client'] for o in outliers))}"
                f" in round {worst['round']}: update_norm "
                f"{worst['update_norm']:.3g} vs cohort median "
                f"{worst['cohort_median']:.3g} (k={k})"
            )
        if trigger is not None and outliers:
            trigger["outliers"] = outliers
        return trigger


class FlightRecorder:
    """Bounded ring of (batch, rng/step metadata) + chunk-entry state.

    ``start_chunk`` is called at every round entry with a HOST copy of the
    clients' state (``train.checkpoint.host_states``): replay must start
    from the state the offending step saw, and the live tensors move on.
    ``record`` appends one per-step batch record (numpy references, no
    copies).  ``dump`` writes the whole forensic bundle.
    """

    def __init__(self, ring_size: int = 16, dump_policy: str = "first",
                 dump_table_max_mb: int = 512):
        self.ring_size = max(int(ring_size), 1)
        self.dump_policy = dump_policy
        self.dump_table_max_mb = dump_table_max_mb
        self._ring: deque[dict] = deque(maxlen=self.ring_size)
        self._state_host: Any = None
        self._chunk_start_round: int | None = None
        self._weights: dict[int, list[float]] = {}
        self._records_seen = 0
        self._dumped_kinds: set[str] = set()
        self.dump_count = 0
        self.last_dump_dir: Path | None = None

    # ------------------------------------------------------------ record
    def start_chunk(
        self,
        round_idx: int,
        state_host: Any,
        weights_by_round: Mapping[int, np.ndarray] | None = None,
    ) -> None:
        self._ring.clear()
        self._records_seen = 0
        self._chunk_start_round = int(round_idx)
        self._state_host = state_host
        self._weights = {
            int(r): np.asarray(w, np.float64).tolist()
            for r, w in (weights_by_round or {}).items()
        }

    def record(self, batch: Mapping[str, Any], round_idx: int,
               epoch_idx: int, step_idx: int) -> None:
        self._records_seen += 1
        self._ring.append({
            "round": int(round_idx),
            "epoch": int(epoch_idx),
            "step": int(step_idx),
            "batch": {k: np.asarray(v) for k, v in batch.items()},
        })

    # -------------------------------------------------------------- dump
    def dump(
        self,
        out_dir: str | Path,
        trigger: Mapping[str, Any],
        cfg: Any = None,
        registry: MetricsRegistry | None = None,
        table: Any = None,
        meta: Mapping[str, Any] | None = None,
    ) -> Path | None:
        """Write the forensic bundle; returns the dump directory (None when
        the dump policy suppressed a repeat dump).

        ``dump_policy='first'`` suppresses repeats PER TRIGGER KIND: an
        early loss-spike dump must never swallow the later non-finite
        dump — the NaN's forensics are the ones the operator actually
        needs, and the spike-round state cannot replay the NaN round."""
        kind = str(trigger.get("kind", ""))
        if self.dump_policy == "first" and kind in self._dumped_kinds:
            return None
        self._dumped_kinds.add(kind)
        self.dump_count += 1
        base = Path(out_dir)
        dump_dir = base if self.dump_count == 1 else base.with_name(
            f"{base.name}_{self.dump_count}"
        )
        dump_dir.mkdir(parents=True, exist_ok=True)

        manifest: dict[str, Any] = {
            "kind": "flight_recorder_dump",
            "created_unix": time.time(),
            "trigger": dict(trigger),
            "chunk_start_round": self._chunk_start_round,
            "weights": self._weights,
            "ring_size": self.ring_size,
            # False when the ring dropped the round's early steps: replay
            # then starts mid-round from the round-entry state (approximate)
            "ring_complete": self._records_seen <= self.ring_size,
            "records": [],
        }
        if meta:
            manifest.update(dict(meta))
        if cfg is not None:
            manifest["config"] = cfg.to_dict()

        for i, rec in enumerate(self._ring):
            fname = f"batch_{i:03d}.npz"
            np.savez(dump_dir / fname, **rec["batch"])
            manifest["records"].append({
                "round": rec["round"], "epoch": rec["epoch"],
                "step": rec["step"], "file": fname,
            })

        manifest["state_file"] = None
        if self._state_host is not None:
            import torch

            torch.save(self._state_host, dump_dir / "state.pt")
            manifest["state_file"] = "state.pt"

        manifest["table_file"] = None
        if table is not None:
            # the size first: a table past the bound never leaves the device
            nbytes = int(table.nbytes)
            if nbytes <= self.dump_table_max_mb * 1e6:
                if hasattr(table, "detach"):  # a tensor, possibly on the card
                    t = table.detach()
                    # numpy has no bfloat16: such a table is saved as f32
                    table = (t.float() if str(t.dtype) == "torch.bfloat16" else t).cpu().numpy()
                np.save(dump_dir / "table.npy", np.asarray(table))
                manifest["table_file"] = "table.npy"
            else:
                manifest["table_skipped_mb"] = round(nbytes / 1e6, 1)

        manifest["registry_file"] = None
        if registry is not None:
            (dump_dir / "registry.json").write_text(
                json.dumps(registry.snapshot())
            )
            manifest["registry_file"] = "registry.json"

        # offending record, if the ring still holds it
        off = None
        tr_round, tr_step = trigger.get("round"), trigger.get("step")
        for rec in manifest["records"]:
            if rec["round"] == tr_round and (
                tr_step is None or rec["step"] == tr_step
            ):
                off = rec
                break
        manifest["offending"] = off

        # manifest last: its presence marks the dump complete
        (dump_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
        self.last_dump_dir = dump_dir
        return dump_dir
