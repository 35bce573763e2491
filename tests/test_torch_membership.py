"""The port's elastic membership (``fedrec_tpu_torch.parallel.membership``),
the reform signal of its coordinator runtime, the chaos rejoin holdoff and
the supervised coordinator (``--supervise``, ``--membership``), against the
JAX package's (``tests/test_membership.py``, ``tests/test_supervisor.py``,
``scripts/elastic_smoke.sh``).

* service parity: one scripted sequence (four joins, a lease expiry, the
  grace formation at world 3, a rejoin into the healthy epoch, the reform to
  world 4, a clean leave, ``min_world`` blocking formation, the policy
  adopted from the first joiner) into the JAX ``MembershipServer`` and the
  port's, each on a fake clock (the module's ``_now``): every assignment and
  every ``status()`` equal;
* wire: the JAX client against the port's service (its ``_wire`` envelope
  off and on) and the port's client against the JAX service, over sockets;
* the worker's join path loads no torch, so a restart joins within its
  lease;
* a supervised elastic world of 3 processes on the CPU at small widths:
  process 2 dies at round 1, the survivors shrink to world 2, process 2
  rejoins after its holdoff and the world re-forms at 3; and a supervised
  fixed world that relaunches after the same kill.

Each spawned world runs under its own ``communicate(timeout=...)``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from fedrec_tpu.fed import population as jpop
from fedrec_tpu.obs import wire as jwire
from fedrec_tpu.parallel import membership as jmem
from fedrec_tpu_torch.cli.coordinator import _argv_value, main
from fedrec_tpu_torch.config import ChaosConfig, ExperimentConfig
from fedrec_tpu_torch.fed import population as ppop
from fedrec_tpu_torch.fed.chaos import rejoin_holdoff
from fedrec_tpu_torch.parallel import membership as pmem
from fedrec_tpu_torch.parallel.multihost import REFORM_SIGNAL, CoordinatorRuntime, World

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_coordinator import _SMALL, _free_port, _reports, art  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
_WORLD_TIMEOUT_S = 150


# ------------------------------------------------------------ service parity
class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def _until(cond, what: str, timeout_s: float = 10.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.02)


def _script(mod, clock: _Clock) -> list:
    """The scripted sequence against ``mod``'s service, through its request
    handler (the reaper and the parked joins on their own threads); the
    log of every reply and status."""
    log = []
    # the joiners' fed.elastic section: the service adopts heartbeat_ms and
    # min_world from the first join; its own lease and grace flags win
    policy = {"lease_ms": 9999.0, "heartbeat_ms": 100.0, "formation_grace_ms": 5000.0,
              "min_world": 2}

    def join(srv, w):
        box: dict = {}
        t = threading.Thread(target=lambda: box.setdefault("a", srv._handle(
            {"cmd": "join", "worker": w, "coord": f"127.0.0.1:{9000 + int(w)}",
             "policy": policy})))
        t.start()
        return t, box

    def joined(pairs):
        for t, _ in pairs:
            t.join(10)
            assert not t.is_alive(), "a join never completed"
        return [box["a"] for _, box in pairs]

    def status(srv):
        return srv._handle({"cmd": "status"})

    srv = mod.MembershipServer(target_world=4, lease_ms=400.0,
                               formation_grace_ms=1000.0).start()
    try:
        log.append(("epoch 0 at the full complement", joined([join(srv, str(w))
                                                              for w in range(4)])))
        log.append(("policy", srv.lease_ms, srv.heartbeat_ms, srv.formation_grace_ms,
                    srv.min_world))
        log.append(("formed", status(srv)))
        clock.t += 0.3
        log.append(("renewals", [srv._handle({"cmd": "heartbeat", "worker": w, "epoch": 0})
                                 for w in "012"]))
        clock.t += 0.2  # worker 3's lease (0.4 s) has run out, the others' not
        _until(lambda: status(srv)["lease_misses"] == 1, "the lease expiry")
        log.append(("expired", status(srv),
                    srv._handle({"cmd": "heartbeat", "worker": "0", "epoch": 0})))
        pairs = [join(srv, w) for w in "012"]
        _until(lambda: status(srv)["pending"] == ["0", "1", "2"], "the survivors' joins")
        log.append(("waiting out the grace", status(srv)))
        clock.t += 1.1
        log.append(("epoch 1 after the grace", joined(pairs)))
        log.append(("shrunk", status(srv)))
        knock = join(srv, "3")
        _until(lambda: status(srv)["reform_pending"], "the rejoin's reform flag")
        log.append(("rejoin knocks", status(srv),
                    srv._handle({"cmd": "heartbeat", "worker": "0", "epoch": 1})))
        log.append(("epoch 2 reformed", joined([*[join(srv, w) for w in "012"], knock])))
        log.append(("regrown", status(srv)))
        log.append(("leave", srv._handle({"cmd": "leave", "worker": "3"}), status(srv)))
        log.append(("unknown", srv._handle({"cmd": "bogus"})))
    finally:
        srv.stop()
    srv = mod.MembershipServer(target_world=3, min_world=2, lease_ms=500.0, heartbeat_ms=100.0,
                               formation_grace_ms=200.0).start()
    try:
        lone = join(srv, "7")
        clock.t += 1.0
        # the reaper and the parked join poll past the grace; 0.5 s, not a
        # multiple of the join's 0.2 s poll, so the second join never lands
        # in the first one's poll (where the JAX service answers "superseded")
        time.sleep(0.5)
        log.append(("min_world blocks", status(srv), "a" in lone[1]))
        log.append(("formed at min_world", joined([lone, join(srv, "8")]), status(srv)))
    finally:
        srv.stop()
    return log


def test_membership_service_matches_jax_on_one_fake_clock(monkeypatch):
    logs = []
    for mod in (jmem, pmem):
        clock = _Clock()
        monkeypatch.setattr(mod, "_now", clock)
        logs.append(_script(mod, clock))
    want, got = logs
    assert [e[0] for e in got] == [e[0] for e in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    regrown = next(e[1] for e in got if e[0] == "regrown")
    assert [h["world"] for h in regrown["epoch_history"]] == [4, 3, 4]
    assert regrown["shrinks"] == 1 and regrown["rejoins"] == 1
    assert ("policy", 400.0, 100.0, 1000.0, 2) in got


# ---------------------------------------------------------------------- wire
@pytest.mark.parametrize("client,service,envelope", [
    ("jax", "torch", False), ("jax", "torch", True), ("torch", "jax", False),
    ("torch", "jax", True)])
def test_each_package_client_talks_to_the_other_service(client, service, envelope):
    """Two workers join a world of 2, heartbeat, read the status and leave.
    With wire observability on a client sends the ``_wire`` envelope: the
    other package's service strips it before dispatch and echoes one, which
    the client strips; off, the bytes are the pre-envelope protocol's."""
    from fedrec_tpu_torch.obs import wire as pwire

    cmod = jmem if client == "jax" else pmem
    smod = jmem if service == "jax" else pmem
    was = jwire.wire_enabled(), pwire.wire_enabled()
    jwire.configure_wire(enabled=envelope)
    pwire.configure_wire(enabled=envelope)
    srv = smod.MembershipServer(target_world=2, lease_ms=5000.0, heartbeat_ms=1000.0,
                                formation_grace_ms=5000.0).start()
    try:
        clients = [cmod.MembershipClient(srv.address, worker_id=str(i), join_timeout_s=15)
                   for i in range(2)]
        out: list = [None, None]
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, clients[i].join()))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(15)
            assert not t.is_alive()
        assert [(a.epoch, a.rank, a.world) for a in out] == [(0, 0, 2), (0, 1, 2)]
        assert out[0].coordinator == out[1].coordinator
        assert clients[1].heartbeat() == {"epoch": 0, "reform": False}
        st = clients[0].status()
        assert "_wire" not in st
        assert (st["epoch"], st["members"], st["epoch_history"]) == (
            0, ["0", "1"], [{"epoch": 0, "world": 2}])
        for c in clients:
            c.leave()
        assert clients[0].status()["members"] == []
        with pytest.raises(cmod.MembershipError, match="unknown cmd"):
            clients[0]._call({"cmd": "bogus"})
        if envelope:
            assert (jwire if client == "jax" else pwire).last_reply_envelope()["recv_ts"] > 0
    finally:
        srv.stop()
        jwire.configure_wire(enabled=was[0])
        pwire.configure_wire(enabled=was[1])


def test_heartbeat_thread_latches_reform_and_counts_failures():
    # no target: formation waits for everyone known alive
    srv = pmem.MembershipServer(lease_ms=5000.0, heartbeat_ms=50.0).start()
    try:
        c = pmem.MembershipClient(srv.address, worker_id="0", join_timeout_s=15)
        assert c.join().world == 1
        c.start_heartbeat()
        knock = pmem.MembershipClient(srv.address, worker_id="9", join_timeout_s=15)
        got: list = [None]
        t = threading.Thread(target=lambda: got.__setitem__(0, knock.join()))
        t.start()
        _until(lambda: c.reform_pending, "the latched reform")
        c.close()
        c.join()
        t.join(10)
        assert got[0].world == 2 and not c.reform_pending
    finally:
        srv.stop()
    gone = pmem.MembershipClient(f"127.0.0.1:{_free_port()}", worker_id="x", rpc_timeout_s=1.0)
    with pytest.raises(OSError):
        gone.heartbeat()
    gone.start_heartbeat()
    _until(lambda: gone.heartbeat_failures >= 1, "a counted failure")
    gone.close()


def test_rank_order_metrics_and_the_entry_refusals(tmp_path):
    assert pmem._rank_order(["10", "2", "0", "b", "a"]) == jmem._rank_order(
        ["10", "2", "0", "b", "a"]) == ["0", "2", "10", "a", "b"]
    el = ExperimentConfig().fed.elastic
    assert pmem.elastic_policy(el) == jmem.elastic_policy(el)
    from fedrec_tpu_torch.obs import get_registry

    pmem.publish_membership_metrics(
        assignment=pmem.EpochAssignment(3, 1, 2, "h:1", 1.0, 1.0), reforms=1)
    snap = get_registry().snapshot()["metrics"]
    assert snap["fed.membership_epoch"]["values"][0]["value"] == 3.0
    assert snap["fed.membership_world"]["values"][0]["value"] == 2.0
    assert snap["fed.membership_reforms_total"]["values"][0]["value"] >= 1.0
    # telemetry on the membership port: refused without a collector (the JAX
    # service's words), written into the collector's worker dir with one
    from fedrec_tpu_torch.obs.fleet import TelemetryCollector, request_json_line

    push = {"cmd": "telemetry_push", "worker": "3", "snapshot": {"kind": "registry_snapshot",
                                                                 "ts": 1.0, "metrics": {}}}
    bare = pmem.MembershipServer().start()
    served = pmem.MembershipServer(collector=TelemetryCollector(tmp_path)).start()
    try:
        with pytest.raises(ValueError, match="no telemetry collector attached"):
            request_json_line("127.0.0.1", bare.port, push, timeout_s=5.0)
        assert request_json_line("127.0.0.1", served.port, push, timeout_s=5.0) == {
            "ok": True, "worker": "3"}
        status = request_json_line("127.0.0.1", served.port, {"cmd": "telemetry_status"},
                                   timeout_s=5.0)
        assert status["pushes"] == 1 and set(status["workers"]) == {"3"}
    finally:
        bare.stop()
        served.stop()
    assert (tmp_path / "worker_3" / "metrics.jsonl").exists()


# ------------------------------------------------------ runtime and chaos
class _FakeMembership:
    def __init__(self, reform: bool):
        self.reform_pending = reform


def test_start_round_signals_reform_only_with_membership():
    rt = CoordinatorRuntime(World(rank=0, size=1), membership=_FakeMembership(True), epoch=4)
    assert rt.epoch == 4
    assert rt.start_round(2, 5) == REFORM_SIGNAL
    # a finished run stops, a reform pending or not
    assert rt.start_round(5, 5) == -1
    assert CoordinatorRuntime(World(rank=0, size=1),
                              membership=_FakeMembership(False)).start_round(2, 5) == 2
    plain = CoordinatorRuntime(World(rank=0, size=1))
    assert (plain.membership, plain.epoch) == (None, 0)
    assert plain.start_round(2, 5) == 2 and plain.start_round(5, 5) == -1


def test_rejoin_holdoff_fires_once_per_marker(tmp_path):
    from fedrec_tpu.config import ChaosConfig as JaxChaos
    from fedrec_tpu.fed.chaos import rejoin_holdoff as jax_holdoff

    seen = []
    for cfg_cls, holdoff, d in ((ChaosConfig, rejoin_holdoff, tmp_path / "p"),
                                (JaxChaos, jax_holdoff, tmp_path / "j")):
        d.mkdir()
        chaos = cfg_cls(enabled=True, kill_process=2, rejoin_delay_s=7.0)
        steps = [holdoff(chaos, 2, d)]          # not killed yet
        (d / "chaos_killed_p2").write_text("3")
        steps += [holdoff(chaos, 1, d), holdoff(chaos, 2, d), holdoff(chaos, 2, d),
                  holdoff(cfg_cls(enabled=False, kill_process=2, rejoin_delay_s=7.0), 2, d)]
        seen.append((steps, (d / "chaos_rejoin_delayed_p2").read_text()))
    assert seen[0] == seen[1] and seen[0][0] == [0.0, 0.0, 7.0, 0.0, 0.0]


_JOIN_WITHOUT_TORCH = """
import os, sys
from fedrec_tpu_torch.cli import coordinator as coord
from fedrec_tpu_torch.parallel.membership import MembershipServer
srv = MembershipServer(target_world=1).start()
os.environ["FEDREC_SUPERVISED"] = "1"
parser = coord._build_parser()
args = parser.parse_args(["1", "8", "1", "--synthetic", "--device", "cpu",
                          "--membership", srv.address, "--process-id", "0"])
client, asg = coord._join_membership(parser, args)
client.leave()
srv.stop()
print("torch" in sys.modules, asg.world)
"""


def test_worker_joins_before_it_imports_torch():
    """A restarted worker's join must land within its old lease, so the
    coordinator joins before torch's import (seconds with CUDA), as the JAX
    worker joins before jax's: the join path loads no torch."""
    out = subprocess.run([sys.executable, "-c", _JOIN_WITHOUT_TORCH], capture_output=True,
                         text=True, timeout=60, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["False", "1"], out.stdout


def test_argv_value():
    assert _argv_value(["--membership", "h:1", "x"], "--membership") == "h:1"
    assert _argv_value(["--membership=h:2"], "--membership") == "h:2"
    assert _argv_value(["--other", "v"], "--membership") is None
    assert _argv_value(["--membership"], "--membership") is None


def test_ledger_resize_matches_jax():
    """The population ledger's ``load_state_dict(resize=True)`` (the
    re-formed world's participation continuity): the port and the JAX
    ledger load the same state alike, to a smaller and a larger
    population."""
    src = jpop.ParticipationLedger(6)
    src.selected[:] = [5, 4, 3, 2, 1, 9]
    src.reported[:] = [4, 4, 2, 2, 1, 8]
    src.quarantine(1, 10)
    src.quarantine(5, 12)
    state = src.state_dict()
    for n in (4, 6, 8):
        mine, theirs = ppop.ParticipationLedger(n), jpop.ParticipationLedger(n)
        mine.load_state_dict(state, resize=True)
        theirs.load_state_dict(state, resize=True)
        for key in ("selected", "reported", "dropped", "deadline_cut"):
            np.testing.assert_array_equal(getattr(mine, key), getattr(theirs, key))
        assert mine.quarantined == theirs.quarantined
    with pytest.raises(ValueError):
        ppop.ParticipationLedger(4).load_state_dict(state)


# ------------------------------------------------------- supervised worlds
_ELASTIC_ROUNDS = 240
# the lease, 6 s as in the JAX package's elastic smoke, outlasts a worker's
# restart at the reformation: the worker joins before it imports torch,
# about 1 s after its supervisor respawns it. The dead worker's lease
# expires 6-7 s after the kill, and the 25 s holdoff lets the survivors'
# shrunk epoch form and run before the rejoin (rounds of ~0.1 s: 240
# outlast it)
_ELASTIC = ["fed.elastic.lease_ms=6000", "fed.elastic.heartbeat_ms=1000",
            "fed.elastic.formation_grace_ms=2000", "chaos.enabled=1", "chaos.kill_process=2",
            "chaos.kill_round=1", "chaos.rejoin_delay_s=25"]


def _supervised(argv: list[str], n: int, cwd: Path, world_flags) -> tuple[list, list]:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), FEDREC_SUPERVISE_MAX="12")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fedrec_tpu_torch.cli.coordinator", *argv, "--supervise",
         *world_flags(i)], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=_WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def _argv(art: Path, snaps: Path, rounds: int, *sets: str) -> list[str]:
    flags = [x for kv in (*_SMALL, *sets) for x in ("--set", kv)]
    return [str(rounds), "8", "1", "--data-dir", str(art), "--device", "cpu", "--clients", "2",
            "--mode", "joint", *flags, "--set", f"train.snapshot_dir={snaps}",
            "--collective-timeout", "2"]


def _saved_globals(outs: list[str]) -> list[int]:
    return sorted(int(ln.rsplit("global_round_", 1)[1].split(".")[0])
                  for o in outs for ln in o.splitlines() if "saved global_round_" in ln)


def test_supervised_elastic_world_shrinks_and_regrows(art, tmp_path):
    snaps, obs = tmp_path / "snaps", tmp_path / "obs"
    srv = pmem.MembershipServer(target_world=3).start()
    try:
        rcs, outs = _supervised(
            _argv(art, snaps, _ELASTIC_ROUNDS, *_ELASTIC, f"obs.dir={obs}"), 3, tmp_path,
            lambda i: ["--membership", srv.address, "--process-id", str(i)])
        st = srv.status()
    finally:
        srv.stop()
    assert rcs == [0, 0, 0], [o[-3000:] for o in outs]
    assert [h["world"] for h in st["epoch_history"]] == [3, 2, 3], st
    assert st["shrinks"] == 1 and st["rejoins"] == 1 and st["lease_misses"] >= 1, st
    assert outs[2].count("dying at round 1") == 1
    assert "holding off its rejoin 25s" in outs[2]
    # every round's global written once, across every server incarnation
    assert _saved_globals(outs) == list(range(_ELASTIC_ROUNDS))
    reports = [_reports(o) for o in outs]
    assert any(r["world"] == 2 and r["rounds"] for reps in reports for r in reps)
    last = [reps[-1] for reps in reports]
    assert all(r["world"] == 3 and r["rounds"][-1] == _ELASTIC_ROUNDS - 1 for r in last)
    assert np.isfinite(last[1]["losses"][-1])
    # the rejoined worker's first fan-out is, bitwise, the last global the
    # server saved before the reform: the hand-off loses nothing
    first = last[2]["rounds"][0]
    server = [r for r in reports[0] if r["world"] == 2][-1]
    assert server["reformed"] and server["rounds"][-1] == first - 1
    assert last[2]["fanout_sha256"][0] == server["global_sha256"][-1]
    assert last[2]["fanout_sha256"][0] == last[0]["fanout_sha256"][0]
    # fleet identity and counter continuity: each worker's obs dir holds a
    # tagged trace an epoch and its counter baseline; the server's last
    # snapshot counts every round of the run across its incarnations
    from fedrec_tpu_torch.obs.fleet import load_fleet_dir
    from fedrec_tpu_torch.obs.report import snapshot_value

    fleet = load_fleet_dir(obs)
    assert set(fleet) == {"0", "1", "2"}
    assert len(fleet["0"].traces) >= 3 and all(t.tag.startswith("e") for t in fleet["0"].traces)
    assert all((obs / f"worker_{w}" / "counters.json").exists() for w in "012")
    last_snap = fleet["0"].last_snapshot()
    assert last_snap["fleet"]["worker"] == "0" and last_snap["fleet"]["membership_epoch"] == 2
    assert snapshot_value(last_snap, "train.rounds_total") >= _ELASTIC_ROUNDS


def test_supervised_fixed_world_relaunches_after_a_kill(art, tmp_path):
    """``--supervise`` alone: the killed process's supervisor relaunches it,
    the survivors' degraded processes exit 75 and relaunch, and the same
    world of 3 re-rendezvouses, resumes from the local states and finishes."""
    port = _free_port()
    rounds = 3
    rcs, outs = _supervised(
        _argv(art, tmp_path / "snaps", rounds, "chaos.enabled=1", "chaos.kill_process=2",
              "chaos.kill_round=1"), 3, tmp_path,
        lambda i: ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "3",
                   "--process-id", str(i)])
    assert rcs == [0, 0, 0], [o[-3000:] for o in outs]
    assert outs[2].count("dying at round 1") == 1
    assert all("respawn 1/12" in o for o in outs)
    assert all("exiting for re-rendezvous (rc 75)" in o for o in outs[:2])
    assert _saved_globals(outs) == list(range(rounds))
    finals = [_reports(o)[-1] for o in outs]
    assert all(r["rounds"] == [1, 2] and not r["degraded"] for r in finals)
    assert np.isfinite(finals[1]["losses"][-1])


def test_membership_needs_an_identity_the_supervisor_and_a_service(art, tmp_path, capsys,
                                                                  monkeypatch):
    base = _argv(art, tmp_path / "s", 1)
    monkeypatch.delenv("FEDREC_SUPERVISED", raising=False)
    for extra, msg in ((["--membership", "h:1"], "requires --process-id"),
                       (["--membership", "h:1", "--process-id", "0"], "requires --supervise")):
        with pytest.raises(SystemExit):
            main([*base, *extra])
        assert msg in capsys.readouterr().err
    with pytest.raises(ValueError, match="no membership service"):
        main([*base, "--set", "fed.elastic.enabled=1"])
    with pytest.raises(NotImplementedError, match="shard.table"):
        main([*base, "--set", "shard.table=1"])
