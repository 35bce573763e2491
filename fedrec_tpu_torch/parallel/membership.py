"""Elastic membership: epoch-based world formation over heartbeat leases,
the port of ``fedrec_tpu/parallel/membership.py``.

The coordinator's fixed world (``--num-processes N``) cannot shrink: a dead
peer degrades every survivor to standalone training, or, under
``--supervise`` alone, the whole world respawns until the dead peer is back.
This module is the control plane that lets it shrink and grow:

* :class:`MembershipServer`, a threaded TCP JSON-lines service
  (``obs.fleet.serve_json_line``) that owns a monotonically increasing
  membership epoch. Each worker holds a heartbeat lease; an expired lease
  marks the epoch stale. Epoch ``e + 1`` forms from the workers that have
  (re-)joined: at once when the full target complement is back, or after
  ``formation_grace_ms`` with at least ``min_world`` joiners (shrink and
  continue). A join into a healthy epoch flags a reform, which the epoch's
  rank 0 broadcasts to its world at the next round boundary
  (``CoordinatorRuntime.start_round``).
* :class:`MembershipClient`: ``join`` / ``heartbeat`` / ``leave`` /
  ``status`` and a daemon lease-renewal thread. A join's assignment carries
  ``(epoch, rank, world, coordinator)``; the coordinator address is rank 0's
  own candidate, a fresh port each epoch, so a respawned worker never
  re-enters the previous, dying world's rendezvous.

Ranks are dense ``0 .. world - 1`` by sorted stable worker ids (numeric ids
numerically), so survivors keep the lowest ranks and rank 0 moves only when
the previous rank 0 died. The worker id is the supervisor-stable
``--process-id``, which keys the snapshots (``local_state_w<ID>.pt``). A
deployment without ``--membership`` never touches this module.

The wire and the state machine are the JAX package's, so either package's
client works against either package's service. With ``--telemetry-dir`` the
service is also the fleet telemetry collector (``obs.fleet``) on its own
port, and ``--watch`` evaluates the fleet rules (``obs.watch.FleetRules``)
over the pushes and its own world. Run the service alone::

    python -m fedrec_tpu_torch.parallel.membership 127.0.0.1:9123 \\
        --target-world 4 --lease-ms 6000 --formation-grace-ms 4000 \\
        --telemetry-dir fleet --watch
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass, field

from fedrec_tpu_torch.obs.fleet import request_json_line, serve_json_line


def _now() -> float:
    return time.monotonic()


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port on ``host``: the joiner's rendezvous
    candidate. Another process may take it before the store binds it; the
    supervised rendezvous then fails, and the retry joins with a fresh one."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


@dataclass(frozen=True)
class EpochAssignment:
    """One worker's seat in one membership epoch."""

    epoch: int
    rank: int
    world: int
    coordinator: str        # host:port of this epoch's rendezvous
    lease_ms: float
    heartbeat_ms: float

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "rank": self.rank, "world": self.world,
                "coordinator": self.coordinator, "lease_ms": self.lease_ms,
                "heartbeat_ms": self.heartbeat_ms}


def _rank_order(worker_ids) -> list[str]:
    """Dense rank order: numeric ids numerically (worker "0" keeps rank 0
    while it lives), other ids lexically after them."""
    def key(w: str):
        try:
            return (0, int(w), w)
        except ValueError:
            return (1, 0, w)

    return sorted(worker_ids, key=key)


@dataclass
class _Member:
    worker: str
    expires_at: float
    rank: int


@dataclass
class _Joiner:
    worker: str
    coord_candidate: str
    arrived_at: float
    event: threading.Event = field(default_factory=threading.Event)
    assignment: EpochAssignment | None = None


class MembershipServer:
    """The epoch and lease bookkeeper, one a federation.

    One listener thread accepts connections and answers each request on a
    thread of its own (a ``join`` parks there until formation); one reaper
    thread expires leases and closes formation windows. All state sits
    behind one lock; formation is the only compound transition.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        target_world: int = 0,
        min_world: int | None = None,
        lease_ms: float | None = None,
        heartbeat_ms: float | None = None,
        formation_grace_ms: float | None = None,
        collector=None,
        obs_dir: str | None = None,
    ):
        self.host = host
        self.port = port
        self.target_world = int(target_world)
        # the service's own metrics.jsonl / trace.json / prometheus.txt
        self.obs_dir = obs_dir
        # fleet telemetry on the membership port (one control-plane address
        # a federation): an obs.fleet.TelemetryCollector answers
        # telemetry_push / telemetry_status here
        self.collector = collector
        # None: adopt from the first join that carries a policy (the
        # workers' fed.elastic section); an explicit value wins over joiners
        self._min_world = min_world
        self._lease_ms = lease_ms
        self._heartbeat_ms = heartbeat_ms
        self._formation_grace_ms = formation_grace_ms
        self._lock = threading.Lock()
        self.epoch = -1                       # no world formed yet
        self._members: dict[str, _Member] = {}
        self._joiners: dict[str, _Joiner] = {}
        self._window_opened: float | None = None
        self._reform_needed = False
        self.shrinks = 0
        self.rejoins = 0
        self.lease_misses = 0
        self.epoch_history: list[dict] = []   # [{"epoch", "world", "workers"}]
        self._srv: socket.socket | None = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._instrument()

    # ------------------------------------------------- effective policy
    @property
    def min_world(self) -> int:
        return max(int(self._min_world or 1), 1)

    @property
    def lease_ms(self) -> float:
        return float(self._lease_ms or 15000.0)

    @property
    def heartbeat_ms(self) -> float:
        return float(self._heartbeat_ms or 5000.0)

    @property
    def formation_grace_ms(self) -> float:
        return float(self._formation_grace_ms or 10000.0)

    def _adopt_policy_locked(self, policy: dict) -> None:
        """Fill each knob still None from a joiner's ``fed.elastic``
        section: the first writer wins, explicit server values always."""
        if self._lease_ms is None and policy.get("lease_ms"):
            self._lease_ms = float(policy["lease_ms"])
        if self._heartbeat_ms is None and policy.get("heartbeat_ms"):
            self._heartbeat_ms = float(policy["heartbeat_ms"])
        if self._formation_grace_ms is None and policy.get("formation_grace_ms"):
            self._formation_grace_ms = float(policy["formation_grace_ms"])
        if self._min_world is None and policy.get("min_world"):
            self._min_world = int(policy["min_world"])

    # --------------------------------------------------------------- obs
    def _instrument(self) -> None:
        """The service's own counters: monotonic in its process, where the
        workers' registries restart with every respawn."""
        from fedrec_tpu_torch.obs import get_registry, get_tracer

        reg = get_registry()
        self._tracer = get_tracer()
        self._m_shrinks = reg.counter(
            "fed.membership_shrinks_total",
            "epochs that formed SMALLER than their predecessor "
            "(shrink-and-continue events; service-owned)")
        self._m_rejoins = reg.counter(
            "fed.membership_rejoins_total",
            "workers that re-entered a later epoch after missing one (service-owned)")
        self._m_lease_misses = reg.counter(
            "fed.membership_lease_misses_total",
            "heartbeat leases the service expired — the failure detector firing "
            "(service-owned)")
        self._g_epoch = reg.gauge("fed.membership_epoch",
                                  "membership epoch this worker's world formed at")
        self._g_world = reg.gauge("fed.membership_world",
                                  "world size of this worker's membership epoch")

    def dump_obs(self) -> None:
        """Write the service's artifacts under ``obs_dir`` (no-op without
        one), rotating the event log at 64 MB; a full disk is not fatal."""
        if not self.obs_dir:
            return
        from pathlib import Path

        from fedrec_tpu_torch.obs import dump_artifacts, rotate_jsonl

        try:
            rotate_jsonl(Path(self.obs_dir) / "metrics.jsonl", 64.0)
            dump_artifacts(self.obs_dir)
        except OSError:
            pass

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MembershipServer":
        srv = socket.create_server((self.host, self.port))
        srv.settimeout(0.5)
        self._srv = srv
        self.port = srv.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True)
        r = threading.Thread(target=self._reaper_loop, daemon=True)
        t.start()
        r.start()
        self._threads = [t, r]
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)
        # release the parked joiners so their threads exit
        with self._lock:
            for j in self._joiners.values():
                j.event.set()
        self.dump_obs()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # ------------------------------------------------------------- serving
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # a join parks its connection's thread until formation
        serve_json_line(conn, self._handle, timeout_s=300.0)

    def _handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd in ("telemetry_push", "telemetry_status"):
            if self.collector is None:
                return {"error": "no telemetry collector attached — start the service with "
                                 "--telemetry-dir (or run a standalone obs.fleet collector)"}
            return self.collector.handle(req)
        if cmd == "heartbeat":
            return self._heartbeat(str(req["worker"]), int(req.get("epoch", -1)))
        if cmd == "join":
            return self._join(str(req["worker"]), str(req.get("coord", "")),
                              req.get("policy") or {})
        if cmd == "leave":
            return self._leave(str(req["worker"]))
        if cmd == "status":
            return self.status()
        return {"error": f"unknown cmd {cmd!r}"}

    # ------------------------------------------------------------ protocol
    def _heartbeat(self, worker: str, epoch: int) -> dict:
        with self._lock:
            m = self._members.get(worker)
            if m is not None and epoch == self.epoch:
                m.expires_at = _now() + self.lease_ms / 1e3
            # a heartbeat from a stale epoch: that worker missed a formation
            reform = self._reform_needed or epoch != self.epoch
            return {"epoch": self.epoch, "reform": bool(reform)}

    def _join(self, worker: str, coord: str, policy: dict) -> dict:
        self._tracer.instant("membership_worker_join", worker=str(worker))
        with self._lock:
            self._adopt_policy_locked(policy)
            j = _Joiner(worker=worker, coord_candidate=coord, arrived_at=_now())
            self._joiners[worker] = j
            # joining supersedes a live lease (the worker left its world)
            self._members.pop(worker, None)
            if self._members and self.epoch >= 0:
                # a knock while members live: a new worker, or a member's
                # fast respawn: the live world reforms at its next boundary
                self._reform_needed = True
            if self._window_opened is None:
                self._window_opened = _now()
            self._maybe_form_locked()
        # park outside the lock until formation, a stop or a newer join
        deadline = _now() + 3600.0
        while not j.event.wait(timeout=0.2):
            if self._stop.is_set() or _now() > deadline:
                return {"error": "membership server stopping"}
            with self._lock:
                if j.assignment is not None:
                    # formed between the wait's timeout and the lock (the
                    # JAX service answers "superseded" here)
                    break
                if self._joiners.get(worker) is not j:
                    return {"error": "join superseded by a newer join from this worker"}
                self._maybe_form_locked()
        if j.assignment is None:
            return {"error": "membership server stopping"}
        return j.assignment.to_dict()

    def _leave(self, worker: str) -> dict:
        with self._lock:
            self._members.pop(worker, None)
            j = self._joiners.pop(worker, None)
            if j is not None:
                j.event.set()
            # a clean leave is a finished run: no reform, no shrink
            return {"ok": True, "epoch": self.epoch}

    # ----------------------------------------------------------- formation
    def _expected_world(self) -> int:
        """Joiners formation waits for before the grace window: the target
        complement, or (without one) everyone known alive."""
        if self.target_world > 0:
            return self.target_world
        return max(len(self._members) + len(self._joiners), self.min_world)

    def _maybe_form_locked(self) -> None:
        n = len(self._joiners)
        if n == 0 or self._window_opened is None:
            return
        window_s = self.formation_grace_ms / 1e3
        full = n >= self._expected_world()
        # live members that have not re-joined: forming now would orphan
        # them mid-round (a dead one's lease expires and the reaper prunes it)
        missing_live = [w for w in self._members if w not in self._joiners]
        if not full and (missing_live or _now() - self._window_opened < window_s):
            return
        if n < self.min_world:
            return
        self._form_locked()

    def _form_locked(self) -> None:
        joiners = dict(self._joiners)
        order = _rank_order(joiners)
        prev = self.epoch_history[-1] if self.epoch_history else None
        prev_world = prev["world"] if prev else 0
        prev_set = set(prev.get("workers", ())) if prev else set()
        self.epoch += 1
        world = len(order)
        coordinator = joiners[order[0]].coord_candidate or "127.0.0.1:0"
        expires = _now() + self.lease_ms / 1e3
        self._members = {w: _Member(worker=w, expires_at=expires, rank=r)
                         for r, w in enumerate(order)}
        if self.epoch > 0:
            if world < prev_world:
                self.shrinks += 1
                self._m_shrinks.inc()
            rejoined = set(order) - prev_set
            if prev_set and rejoined:
                self.rejoins += len(rejoined)
                self._m_rejoins.inc(len(rejoined))
        self.epoch_history.append({"epoch": self.epoch, "world": world, "workers": list(order)})
        self._g_epoch.set(float(self.epoch))
        self._g_world.set(float(world))
        self._tracer.instant("membership_epoch_formed", epoch=self.epoch, world=world,
                             workers=list(order))
        self._joiners.clear()
        self._window_opened = None
        self._reform_needed = False
        for r, w in enumerate(order):
            j = joiners[w]
            j.assignment = EpochAssignment(
                epoch=self.epoch, rank=r, world=world, coordinator=coordinator,
                lease_ms=self.lease_ms, heartbeat_ms=self.heartbeat_ms)
            j.event.set()

    def _reaper_loop(self) -> None:
        # the period is read each pass: the lease policy may come with the
        # first join
        while not self._stop.wait(timeout=max(self.lease_ms / 4e3, 0.05)):
            with self._lock:
                now = _now()
                dead = [w for w, m in self._members.items() if m.expires_at < now]
                for w in dead:
                    del self._members[w]
                    self.lease_misses += 1
                    self._m_lease_misses.inc()
                    self._tracer.instant("membership_lease_expired", worker=str(w))
                    self._reform_needed = True
                self._maybe_form_locked()

    # -------------------------------------------------------------- status
    def status(self) -> dict:
        with self._lock:
            return {
                "epoch": self.epoch,
                "world": len(self._members),
                "members": sorted(self._members),
                "pending": sorted(self._joiners),
                "reform_pending": bool(self._reform_needed),
                "shrinks": self.shrinks,
                "rejoins": self.rejoins,
                "lease_misses": self.lease_misses,
                "epoch_history": [{"epoch": h["epoch"], "world": h["world"]}
                                  for h in self.epoch_history],
            }


# ------------------------------------------------------------------ client
class MembershipError(RuntimeError):
    """The membership service refused or could not answer a request."""


class MembershipClient:
    """One worker's view of the membership service: one-shot requests over
    fresh connections, and a lease-renewal thread whose latched
    ``reform_pending`` the epoch's rank 0 reads at every round boundary."""

    def __init__(self, address: str, worker_id: str, join_timeout_s: float = 180.0,
                 rpc_timeout_s: float = 10.0):
        host, port = address.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.worker_id = str(worker_id)
        self.join_timeout_s = float(join_timeout_s)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.assignment: EpochAssignment | None = None
        self._reform = threading.Event()
        self._stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self.heartbeat_failures = 0

    def _call(self, req: dict, timeout_s: float | None = None) -> dict:
        """A transport failure raises ``OSError``; a refusal
        ``MembershipError``."""
        timeout = timeout_s if timeout_s is not None else self.rpc_timeout_s
        try:
            return request_json_line(self.host, self.port, req, timeout)
        except ValueError as e:
            raise MembershipError(str(e)) from e

    def _local_host_toward_service(self) -> str:
        """The local address that routes to the service: the host to
        advertise in this worker's rendezvous candidate."""
        try:
            with socket.create_connection((self.host, self.port),
                                          timeout=self.rpc_timeout_s) as s:
                return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"

    def join(self, coord_candidate: str | None = None,
             policy: dict | None = None) -> EpochAssignment:
        """Block until the next epoch forms; this worker's seat in it.
        ``coord_candidate`` (default: a fresh port on the interface toward
        the service) is where this worker could host the rendezvous, rank
        0's wins; ``policy`` is its ``fed.elastic`` section, which a service
        started without explicit flags adopts from the first joiner."""
        if coord_candidate is None:
            adv = self._local_host_toward_service()
            coord_candidate = f"{adv}:{free_port(adv)}"
        resp = self._call({"cmd": "join", "worker": self.worker_id,
                           "coord": coord_candidate, "policy": policy or {}},
                          timeout_s=self.join_timeout_s)
        self.assignment = EpochAssignment(
            epoch=int(resp["epoch"]), rank=int(resp["rank"]), world=int(resp["world"]),
            coordinator=str(resp["coordinator"]), lease_ms=float(resp["lease_ms"]),
            heartbeat_ms=float(resp["heartbeat_ms"]))
        self._reform.clear()
        return self.assignment

    def heartbeat(self) -> dict:
        epoch = self.assignment.epoch if self.assignment else -1
        resp = self._call({"cmd": "heartbeat", "worker": self.worker_id, "epoch": epoch})
        if resp.get("reform"):
            self._reform.set()
        return resp

    def leave(self) -> None:
        try:
            self._call({"cmd": "leave", "worker": self.worker_id})
        except (OSError, MembershipError):
            pass  # a dead service cannot block a clean exit

    def status(self) -> dict:
        return self._call({"cmd": "status"})

    def start_heartbeat(self) -> None:
        """Renew the lease every ``heartbeat_ms`` on a daemon thread,
        starting at once: the lease ticks from formation, and the rendezvous
        after the join can outlast it. A failed renewal counts
        ``heartbeat_failures`` and never raises: the service's lease expiry
        is the failure detector."""
        if self._hb_thread is not None:
            return
        interval = self.assignment.heartbeat_ms / 1e3 if self.assignment else 5.0

        def loop():
            while True:
                try:
                    self.heartbeat()
                except (OSError, MembershipError, ValueError):
                    self.heartbeat_failures += 1
                if self._stop.wait(timeout=interval):
                    return

        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    @property
    def reform_pending(self) -> bool:
        return self._reform.is_set()

    def close(self) -> None:
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None


def elastic_policy(elastic_cfg) -> dict:
    """The ``fed.elastic`` knobs a worker ships in its join request."""
    return {"lease_ms": float(elastic_cfg.lease_ms),
            "heartbeat_ms": float(elastic_cfg.heartbeat_ms),
            "formation_grace_ms": float(elastic_cfg.formation_grace_ms),
            "min_world": int(elastic_cfg.min_world)}


def publish_membership_metrics(assignment: EpochAssignment | None = None,
                               client: MembershipClient | None = None,
                               reforms: int = 0) -> None:
    """The worker-side membership metrics (``obs.report`` reads them): the
    epoch and world of this worker's seat, its failed lease renewals and its
    reform departures. The shrink, rejoin and lease-miss totals are the
    service's own counters, in the service's artifacts."""
    from fedrec_tpu_torch.obs import get_registry

    reg = get_registry()
    if assignment is not None:
        reg.gauge("fed.membership_epoch",
                  "membership epoch this worker's world formed at").set(float(assignment.epoch))
        reg.gauge("fed.membership_world",
                  "world size of this worker's membership epoch").set(float(assignment.world))
    if client is not None:
        reg.gauge("fed.lease_heartbeat_failures",
                  "lease renewals THIS worker failed to deliver").set(
            float(client.heartbeat_failures))
    if reforms:
        reg.counter("fed.membership_reforms_total",
                    "reformation departures this worker performed (save, leave, rejoin at the "
                    "next epoch)").inc(float(reforms))


def main(argv: list[str] | None = None) -> int:
    """The standalone service process."""
    import argparse
    import signal

    parser = argparse.ArgumentParser(description="fedrec elastic-membership service")
    parser.add_argument("address", metavar="HOST:PORT")
    parser.add_argument("--target-world", type=int, default=0,
                        help="full complement: formation waits for this many joiners before "
                             "the grace window applies")
    # None: adopt the first joiner's fed.elastic section
    parser.add_argument("--min-world", type=int, default=None)
    parser.add_argument("--lease-ms", type=float, default=None)
    parser.add_argument("--heartbeat-ms", type=float, default=None)
    parser.add_argument("--formation-grace-ms", type=float, default=None)
    parser.add_argument("--obs-dir", default=None,
                        help="write the service's own metrics.jsonl, trace.json and "
                             "prometheus.txt here (on every membership change and at exit)")
    parser.add_argument("--telemetry-dir", default=None,
                        help="also be the fleet telemetry collector (obs.fleet) on this port: "
                             "the workers' obs.fleet.collector pushes land as worker_* dirs "
                             "under this directory")
    parser.add_argument("--watch", action="store_true",
                        help="evaluate the fleet rules (obs.watch.FleetRules: persistent "
                             "straggler, world below target, quorum-wait growth, stalled "
                             "commit, partitioned edge) over the pushes and the world; alert "
                             "records land in the telemetry dir's worker_fleet/ (needs "
                             "--telemetry-dir)")
    args = parser.parse_args(argv)
    host, port = args.address.rsplit(":", 1)
    collector = rules = None
    if args.telemetry_dir:
        from fedrec_tpu_torch.obs.fleet import TelemetryCollector

        collector = TelemetryCollector(args.telemetry_dir)
        if args.watch:
            from pathlib import Path

            from fedrec_tpu_torch.obs.watch import FleetRules

            fleet_dir = Path(args.telemetry_dir) / "worker_fleet"
            fleet_dir.mkdir(parents=True, exist_ok=True)
            rules = collector.rules = FleetRules(target_world=args.target_world,
                                                 jsonl_path=fleet_dir / "metrics.jsonl")
    if args.obs_dir:
        from fedrec_tpu_torch.obs.fleet import set_fleet_identity

        set_fleet_identity(worker="membership")
    server = MembershipServer(
        host=host, port=int(port), target_world=args.target_world, min_world=args.min_world,
        lease_ms=args.lease_ms, heartbeat_ms=args.heartbeat_ms,
        formation_grace_ms=args.formation_grace_ms, collector=collector,
        obs_dir=args.obs_dir).start()
    print(f"[membership] serving on {server.address}", flush=True)

    def _term(signum, frame):  # noqa: ARG001 — a signal handler's signature
        raise SystemExit(0)

    # SIGTERM still runs the finally below: its dump is the timeline
    signal.signal(signal.SIGTERM, _term)
    try:
        last_status = None
        while True:
            time.sleep(5)
            status = server.status() if (args.obs_dir or rules is not None) else None
            if rules is not None:
                # world below target: only this service knows the world
                rules.observe_world(status["world"])
            if args.obs_dir and status != last_status:
                server.dump_obs()
                last_status = status
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
