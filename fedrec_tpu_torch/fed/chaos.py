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

* wire faults (``chaos.wire_faults``, ``chaos.wire_seed``): a seeded
  :class:`WireFaultPlan` drives a :class:`ChaosProxy`, a TCP man in the
  middle in front of the async commit authority (``agg.server``) that
  refuses, delays, tears, duplicates or partitions the one-shot JSON-lines
  exchanges through it, by connection and by time window. The draws are
  pure in ``(wire_seed, connection index)``; with no plan, or outside every
  window, the proxy forwards every byte verbatim. The run CLI builds one in
  front of ``--agg-server`` when ``chaos.wire_faults`` is set (and only with
  ``chaos.enabled``); the trainer ignores the two keys, as in the JAX
  package.

The module imports no torch: the coordinator reads :func:`rejoin_holdoff`
before it imports torch, and the wire faults need none.
"""

from __future__ import annotations

import socket
import threading
import time
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


# ======================================================================
# wire faults (chaos.wire_faults): seeded network faults applied by a chaos
# TCP proxy in front of a JSON-lines service
# ======================================================================

# the transport fault kinds and their default argument (a probability for
# drop, milliseconds for delay, copies for dup; tear and partition take none)
WIRE_FAULT_KINDS = {
    "drop": 1.0,        # refuse the connection (arg = probability)
    "delay": 100.0,     # hold the request this many ms before forwarding it
    "tear": 0.0,        # forward half the request bytes, then hang up
    "dup": 2.0,         # deliver the request arg times upstream
    "partition": 0.0,   # nothing gets through the window
}


def parse_wire_faults(spec: str) -> list[tuple[str, float, float, float]]:
    """Parse the ``chaos.wire_faults`` DSL: a comma list of
    ``kind@start[-end][:arg]``, ``start``/``end`` seconds since the proxy
    started, ``*`` always, a single time ``t`` the window ``[t, t+1)``.
    Returns ``(kind, start_s, end_s, arg)`` tuples; a malformed entry raises
    ``ValueError``, so a typo fails when the plan is built."""
    out: list[tuple[str, float, float, float]] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        try:
            kind, rest = item.split("@", 1)
            arg_s = None
            if ":" in rest:
                rest, arg_s = rest.split(":", 1)
            if rest == "*":
                start, end = 0.0, float("inf")
            elif "-" in rest:
                start_s, end_s = rest.split("-", 1)
                start, end = float(start_s), float(end_s)
            else:
                start = float(rest)
                end = start + 1.0
            arg = float(arg_s) if arg_s is not None else WIRE_FAULT_KINDS.get(kind, 0.0)
        except ValueError:
            raise ValueError(
                f"chaos.wire_faults entry {item!r} is not 'kind@start[-end][:arg]' (e.g. "
                "'tear@2-4,dup@5-8,partition@20-30,drop@*:0.3')") from None
        if kind not in WIRE_FAULT_KINDS:
            raise ValueError(f"chaos.wire_faults entry {item!r}: unknown kind {kind!r}; "
                             f"expected one of {sorted(WIRE_FAULT_KINDS)}")
        if end <= start:
            raise ValueError(f"chaos.wire_faults entry {item!r}: empty window "
                             f"[{start:g}, {end:g})")
        out.append((kind, start, end, arg))
    return out


class WireFaultPlan:
    """The seeded wire-fault schedule of one proxy. ``actions(t_s,
    conn_idx)`` gives the faults of the ``conn_idx``-th accepted connection
    at ``t_s`` seconds after the proxy's start; a ``drop`` below probability
    1 draws from ``default_rng([seed, conn_idx])``, as the JAX package does,
    so both packages plan the same faults."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = str(spec)
        self.seed = int(seed)
        self.entries = parse_wire_faults(self.spec)

    def actions(self, t_s: float, conn_idx: int) -> list[tuple[str, float]]:
        out: list[tuple[str, float]] = []
        rng = None
        for kind, start, end, arg in self.entries:
            if not start <= t_s < end:
                continue
            if kind == "drop" and arg < 1.0:
                if rng is None:
                    rng = np.random.default_rng([self.seed, int(conn_idx)])
                if rng.random() >= arg:
                    continue
            out.append((kind, arg))
        return out


class ChaosProxy:
    """A chaos TCP man in the middle for one-shot JSON-lines exchanges.

    It listens on ``host:port`` and forwards each accepted connection's one
    request line to ``upstream``, then the reply line back, byte for byte
    when no fault applies. When the plan fires:

    * ``partition`` / ``drop``: the client's connection closes before a
      byte crosses;
    * ``delay``: the request is held ``arg`` ms, then forwarded;
    * ``tear``: half the request reaches the upstream, then both sides hang
      up (the peer sees no whole line, the client an ackless close);
    * ``dup``: the request goes upstream ``arg`` times, as separate
      exchanges, and the client gets the first reply (the idempotent
      ``push_id`` case).

    Each fault counts into ``chaos.wire_faults_total`` (by kind) and the
    ``injected`` dict."""

    _POLL_S = 0.2

    def __init__(self, upstream_host: str, upstream_port: int,
                 plan: WireFaultPlan | None = None, host: str = "127.0.0.1",
                 port: int = 0, timeout_s: float = 30.0):
        self.upstream = (str(upstream_host), int(upstream_port))
        self.plan = plan
        self.timeout_s = float(timeout_s)
        self.injected: dict[str, int] = {}
        self._sock = socket.create_server((host, int(port)))
        self._sock.settimeout(self._POLL_S)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._conn_idx = 0
        self._t0 = time.monotonic()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "ChaosProxy":
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._accept_loop, name="chaos-proxy",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self._sock.close()
        except OSError:
            pass

    def _count(self, kind: str) -> None:
        with self._lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1
        from fedrec_tpu_torch.obs.registry import get_registry

        get_registry().counter(
            "chaos.wire_faults_total",
            "transport faults the chaos proxy injected, by kind (chaos.wire_faults, "
            "chaos.wire_seed)",
            labels=("kind",),
        ).inc(kind=kind)

    @staticmethod
    def _read_line(conn: socket.socket) -> bytes:
        """The whole request, through its newline, as raw bytes."""
        buf = b""
        while b"\n" not in buf:
            chunk = conn.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
        return buf

    def _exchange_upstream(self, payload: bytes) -> bytes:
        with socket.create_connection(self.upstream, timeout=self.timeout_s) as up:
            up.settimeout(self.timeout_s)
            up.sendall(payload)
            return self._read_line(up)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            idx, self._conn_idx = self._conn_idx, self._conn_idx + 1
            t_s = time.monotonic() - self._t0
            threading.Thread(target=self._handle, args=(conn, idx, t_s), daemon=True).start()

    def _handle(self, conn: socket.socket, idx: int, t_s: float) -> None:
        actions = dict(self.plan.actions(t_s, idx)) if self.plan is not None else {}
        try:
            with conn:
                conn.settimeout(self.timeout_s)
                if "partition" in actions or "drop" in actions:
                    # a black hole: the client sees an empty reply, and its
                    # resilient RPC retries into its backoff budget
                    self._count("partition" if "partition" in actions else "drop")
                    return
                payload = self._read_line(conn)
                if not payload:
                    return
                if "delay" in actions:
                    self._count("delay")
                    time.sleep(actions["delay"] / 1e3)
                if "tear" in actions:
                    self._count("tear")
                    try:
                        with socket.create_connection(self.upstream,
                                                      timeout=self.timeout_s) as up:
                            up.sendall(payload[: max(len(payload) // 2, 1)])
                    except OSError:
                        pass
                    return
                copies = int(actions["dup"]) if "dup" in actions else 1
                if copies > 1:
                    self._count("dup")
                reply = b""
                for i in range(max(copies, 1)):
                    try:
                        got = self._exchange_upstream(payload)
                    except OSError:
                        got = b""
                    if i == 0:
                        reply = got
                if reply:
                    conn.sendall(reply)
        except OSError:
            pass
