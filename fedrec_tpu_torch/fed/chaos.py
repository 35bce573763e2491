"""Deterministic fault injection: the client faults of ``fedrec_tpu/fed/chaos.py``.

A :class:`FaultPlan` is a pure function of ``(chaos config, round index)``:
the same plan gives the same faults on every run and on every rollback
replay, so a chaos run repeats to the bit and the trainer's replay meets
the fault it rolled back from. The random drop and straggle draws come from
numpy ``default_rng([seed, round])``, as in the JAX package, so both
packages plan the same faults.

* participation faults (``drop``, ``straggle``): the client's round weight
  is 0; it trains, but its contribution is left out. A straggler also costs
  ``chaos.straggle_ms`` of host sleep a round.
* update faults (``nan``, ``scale``, ``flip``): applied at the optimizer
  update boundary of the train step (``apply_update_fault``), through the
  per-client ``chaos.code`` / ``chaos.scale`` vectors the batch carries.
* population faults (the ``pop_*`` keys, ``population_report``): each
  sampled LOGICAL client's dropout and simulated report latency for the
  cohort engine (``fed.population``), from numpy ``default_rng([seed,
  round, attempt, client, 0x90B])`` draws, bitwise the JAX package's.

* host faults (``kill_round``, ``kill_process``, ``torn_snapshot_round``,
  and under elastic membership ``rejoin_delay_s``, :func:`rejoin_holdoff`):
  read by the coordinator deployment (``cli.coordinator``), inert in the
  single-process trainer, as in the JAX package.

Not ported: the wire faults (``chaos.wire_faults``, ``wire_seed``,
``ChaosProxy``); ``refuse_unported_chaos`` names them.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING, Any, Sequence

import numpy as np

if TYPE_CHECKING:
    import torch

# update-fault codes carried in the batch's chaos.code vector; 0 = none
FAULT_CODES = {"nan": 1, "scale": 2, "flip": 3}


@dataclass(frozen=True)
class RoundFaults:
    """One round's resolved faults (pure function of plan + round)."""

    weight_mask: np.ndarray            # (C,) float32 0/1 — drop+straggle
    codes: np.ndarray                  # (C,) int32 update-fault codes
    scales: np.ndarray                 # (C,) float32 (code==scale multiplier)
    dropped: tuple = ()
    straggled: tuple = ()
    injected: tuple = ()               # ((kind, client), ...) update faults

    @property
    def any(self) -> bool:
        return bool(self.dropped or self.straggled or self.injected)


def parse_faults(spec: str, num_clients: int) -> list[tuple[str, int | None, int, float]]:
    """Parse the ``faults`` DSL: comma list of ``kind@round:client[xscale]``
    (``round`` may be ``*`` = every round). Raises on malformed entries so a
    typo'd plan fails at build time, not silently fault-free."""
    out: list[tuple[str, int | None, int, float]] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        try:
            kind, rest = item.split("@", 1)
            round_s, client_s = rest.split(":", 1)
            scale = 1.0
            if "x" in client_s:
                client_s, scale_s = client_s.split("x", 1)
                scale = float(scale_s)
            rnd = None if round_s == "*" else int(round_s)
            client = int(client_s)
        except ValueError:
            raise ValueError(
                f"chaos.faults entry {item!r} is not "
                "'kind@round:client[xscale]' (e.g. 'nan@2:3,scale@*:5x100')"
            ) from None
        if kind not in FAULT_CODES:
            raise ValueError(
                f"chaos.faults entry {item!r}: unknown kind {kind!r}; "
                f"expected one of {sorted(FAULT_CODES)}"
            )
        if not 0 <= client < num_clients:
            raise ValueError(
                f"chaos.faults entry {item!r}: client {client} out of range "
                f"[0, {num_clients})"
            )
        out.append((kind, rnd, client, scale))
    return out


class FaultPlan:
    """Seeded, deterministic per-round fault schedule.

    ``round_faults(r)`` is idempotent: the random drop/straggle draws are
    derived from ``default_rng([seed, r])``, never from mutable state, so
    rollback replays and re-runs see identical faults.
    """

    def __init__(self, chaos_cfg: Any, num_clients: int):
        self.cfg = chaos_cfg
        self.num_clients = int(num_clients)
        self.seed = int(chaos_cfg.seed)
        self.drop_rate = float(chaos_cfg.drop_rate)
        self.straggle_rate = float(chaos_cfg.straggle_rate)
        self.specs = parse_faults(chaos_cfg.faults, self.num_clients)

    def round_faults(self, round_idx: int) -> RoundFaults:
        c = self.num_clients
        mask = np.ones((c,), np.float32)
        dropped: list[int] = []
        straggled: list[int] = []
        if self.drop_rate > 0 or self.straggle_rate > 0:
            rng = np.random.default_rng([self.seed, int(round_idx)])
            u = rng.random(c)
            # one draw decides both: [0, drop) drops, [drop, drop+straggle)
            # straggles — so the rates compose without double-failing
            for i in range(c):
                if u[i] < self.drop_rate:
                    dropped.append(i)
                    mask[i] = 0.0
                elif u[i] < self.drop_rate + self.straggle_rate:
                    straggled.append(i)
                    mask[i] = 0.0
        codes = np.zeros((c,), np.int32)
        scales = np.ones((c,), np.float32)
        injected: list[tuple[str, int]] = []
        for kind, rnd, client, scale in self.specs:
            if rnd is not None and rnd != round_idx:
                continue
            codes[client] = FAULT_CODES[kind]
            scales[client] = np.float32(scale)
            injected.append((kind, client))
        return RoundFaults(
            weight_mask=mask,
            codes=codes,
            scales=scales,
            dropped=tuple(dropped),
            straggled=tuple(straggled),
            injected=tuple(injected),
        )

    def batch_keys(self, round_idx: int) -> dict[str, np.ndarray]:
        """The per-client fault vectors a chaos-enabled step expects in
        every batch dict (``train.step`` applies them at the update
        boundary)."""
        rf = self.round_faults(round_idx)
        return {"chaos.code": rf.codes, "chaos.scale": rf.scales}

    def is_flaky(self, client_id: int) -> bool:
        """Whether a logical client is in the seeded flaky cohort: a fixed
        ``pop_flaky_fraction`` of the population that drops at
        ``pop_flaky_drop_rate`` instead of ``pop_drop_rate``. Pure in
        ``(seed, client_id)``, so stable across rounds and replays."""
        frac = float(getattr(self.cfg, "pop_flaky_fraction", 0.0))
        if frac <= 0:
            return False
        u = np.random.default_rng([self.seed, int(client_id), 0xF1A]).random()
        return bool(u < frac)

    def population_report(self, round_idx: int, client_ids,
                          attempt: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """One round's report for sampled logical clients: ``(dropped,
        latency_ms)``, ``dropped[i]`` when ``client_ids[i]`` never starts,
        ``latency_ms[i]`` its simulated report latency (0 without
        ``pop_straggle_ms``). Deterministic in ``(seed, round_idx, attempt,
        client)``: the packing and the weights see the same fate, and a
        quorum re-draw (``attempt`` + 1) rolls fresh dice."""
        return population_report(self, round_idx, client_ids, attempt)


def population_report(plan: FaultPlan | None, round_idx: int, client_ids,
                      attempt: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``FaultPlan.population_report`` that tolerates ``plan=None`` (chaos
    off): nobody drops, everybody reports at once."""
    ids = np.asarray(client_ids, np.int64)
    dropped = np.zeros(ids.shape, bool)
    latency = np.zeros(ids.shape, np.float64)
    if plan is None:
        return dropped, latency
    cfg = plan.cfg
    drop_rate = float(getattr(cfg, "pop_drop_rate", 0.0))
    flaky_rate = float(getattr(cfg, "pop_flaky_drop_rate", 0.5))
    straggle_ms = float(getattr(cfg, "pop_straggle_ms", 0.0))
    straggle_sigma = float(getattr(cfg, "pop_straggle_sigma", 1.0))
    any_flaky = float(getattr(cfg, "pop_flaky_fraction", 0.0)) > 0
    if drop_rate <= 0 and not any_flaky and straggle_ms <= 0:
        return dropped, latency
    for i, cid in enumerate(ids):
        rng = np.random.default_rng([plan.seed, int(round_idx), int(attempt), int(cid), 0x90B])
        p = flaky_rate if (any_flaky and plan.is_flaky(int(cid))) else drop_rate
        dropped[i] = rng.random() < p
        if straggle_ms > 0:
            # lognormal with median pop_straggle_ms: the heavy tail is what
            # a deadline cuts
            latency[i] = straggle_ms * rng.lognormal(0.0, straggle_sigma)
    return dropped, latency


def apply_update_fault(updates: Sequence[torch.Tensor], code: int,
                       scale: float) -> list[torch.Tensor]:
    """One client's chaos update fault at the optimizer-update boundary:
    code 0 leaves the updates untouched (exact, not ``u * 1``), 1 makes them
    NaN, 2 multiplies them by ``scale`` (f32), 3 flips their sign. The codes
    are host values, so the branch costs no device read. (torch is imported
    here: the coordinator reads :func:`rejoin_holdoff` before it imports
    torch.)"""
    import torch

    code = int(code)
    if code == 0:
        return list(updates)
    if code == FAULT_CODES["nan"]:
        return [torch.full_like(u, float("nan")) for u in updates]
    factor = -1.0 if code == FAULT_CODES["flip"] else float(np.float32(scale))
    return [u * factor for u in updates]


def rejoin_holdoff(chaos_cfg: Any, worker_id: int, marker_dir) -> float:
    """The seconds a respawned, chaos-killed worker waits before it rejoins
    the membership service (``chaos.rejoin_delay_s``), or 0: only for the
    worker ``chaos.kill_process`` names, only once its kill marker exists,
    and only once (``chaos_rejoin_delayed_p<ID>`` marks it). The holdoff
    lets the survivors' shrunk epoch form and run before the rejoin; without
    it a fast respawn races back into their formation window."""
    if (not getattr(chaos_cfg, "enabled", False)
            or float(getattr(chaos_cfg, "rejoin_delay_s", 0.0)) <= 0
            or int(getattr(chaos_cfg, "kill_process", -1)) != int(worker_id)):
        return 0.0
    marker_dir = Path(marker_dir)
    killed = marker_dir / f"chaos_killed_p{int(worker_id)}"
    delayed = marker_dir / f"chaos_rejoin_delayed_p{int(worker_id)}"
    if not killed.exists() or delayed.exists():
        return 0.0
    marker_dir.mkdir(parents=True, exist_ok=True)
    delayed.write_text(str(chaos_cfg.rejoin_delay_s))
    return float(chaos_cfg.rejoin_delay_s)


# the ChaosConfig keys the port does not run, each with its default and the
# ROADMAP.md Queue A item that ports it
_UNPORTED = (
    ("wire_faults", "", "9 (the wire: ChaosProxy)"),
    ("wire_seed", 0, "9 (the wire: ChaosProxy)"),
)


def refuse_unported_chaos(chaos_cfg: Any) -> None:
    """Raise, naming the key and its Queue A item, for a chaos fault the
    port does not inject."""
    if not chaos_cfg.enabled:
        return
    for key, default, item in _UNPORTED:
        if getattr(chaos_cfg, key) != default:
            raise NotImplementedError(
                f"chaos.{key} is not ported to fedrec_tpu_torch yet (ROADMAP.md's "
                f"Queue A item {item}); the port injects chaos.faults, drop_rate, "
                "straggle_rate, the pop_* population faults and, in the coordinator "
                "deployment, kill_round/kill_process/torn_snapshot_round"
            )
