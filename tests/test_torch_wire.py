"""The port's wire envelope (``obs.wire``) against the JAX package's (CPU):
the offset estimator on the same exchanges, the one-shot JSON-lines exchange
both ways (either package's client against either's server), the bytes with
the envelope off, the commit authority, the membership service's collector
and the asyncio serving server answering a JAX client with a reply
envelope, and the flow arrows of a push -> commit -> adoption through the
port's authority, merged into one fleet trace.

Tolerances: none; the estimator is the same float64 arithmetic.
"""

import asyncio
import json
import socket
import threading
import time

import numpy as np
import pytest

from fedrec_tpu.obs import fleet as jfleet
from fedrec_tpu.obs import wire as jwire
from fedrec_tpu.obs.registry import MetricsRegistry as JaxRegistry
from fedrec_tpu.obs.registry import get_registry as jax_get_registry
from fedrec_tpu.obs.registry import set_registry as jax_set_registry
from fedrec_tpu.obs.tracing import Tracer as JaxTracer
from fedrec_tpu.obs.tracing import set_tracer as jax_set_tracer
from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, fleet, get_registry, get_tracer
from fedrec_tpu_torch.obs import set_registry, set_tracer, wire
from fedrec_tpu_torch.obs.report import _metric_values


@pytest.fixture
def fresh_obs():
    """Fresh registries, tracers, identities and wire state in both
    packages, the envelope on; restored afterwards."""
    prev = (set_registry(MetricsRegistry()), set_tracer(Tracer()),
            jax_set_registry(JaxRegistry()), jax_set_tracer(JaxTracer()))
    for mod_fleet, mod_wire in ((fleet, wire), (jfleet, jwire)):
        mod_fleet.reset_fleet_identity()
        mod_wire.reset_wire_state()
        mod_wire.configure_wire(enabled=True, window=32)
    yield
    for mod_fleet, mod_wire in ((fleet, wire), (jfleet, jwire)):
        mod_fleet.reset_fleet_identity()
        mod_wire.reset_wire_state()
        mod_wire.configure_wire(enabled=True, window=32)
    set_registry(prev[0])
    set_tracer(prev[1])
    jax_set_registry(prev[2])
    jax_set_tracer(prev[3])


def _wait_until_it_answers(port: int, cmd: str, timeout_s: float = 60.0) -> None:
    """Poll a service just started in a process of its own until it answers
    ``cmd``: a loaded machine can take seconds to start an interpreter."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            fleet.request_json_line("127.0.0.1", port, {"cmd": cmd}, 2.0)
            return
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _serve(serve_json_line, handler, n: int = 1):
    """A server answering ``n`` connections through ``serve_json_line``;
    returns (port, done). The server books its wire telemetry after the
    reply, so a test reading it waits on ``done``."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    done = threading.Event()

    def run():
        try:
            for _ in range(n):
                conn, _ = srv.accept()
                serve_json_line(conn, handler)
            srv.close()
        finally:
            done.set()

    threading.Thread(target=run, daemon=True).start()
    return port, done


def _raw(port: int, line: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), 5.0) as c:
        c.sendall(line)
        buf = b""
        while b"\n" not in buf:
            chunk = c.recv(65536)
            if not chunk:
                break
            buf += chunk
    return buf


def _capture_one(reply: bytes = b'{"ok": true}\n'):
    """A plain server that records the one request line it gets."""
    srv = socket.create_server(("127.0.0.1", 0))
    lines: list = []

    def run():
        conn, _ = srv.accept()
        with conn:
            buf = b""
            while b"\n" not in buf:
                buf += conn.recv(65536)
            lines.append(buf)
            conn.sendall(reply)
        srv.close()

    threading.Thread(target=run, daemon=True).start()
    return srv.getsockname()[1], lines


# ------------------------------------------------------- offset estimation
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_offset_estimator_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = wire.OffsetEstimator(window=16), jwire.OffsetEstimator(window=16)
    skew = float(rng.uniform(-5, 5))
    asym = []
    for i in range(60):
        send = 100.0 + i
        fwd, ret, proc = (float(x) for x in rng.exponential(0.002, 3))
        asym.append(abs(fwd - ret))
        recv = send + fwd + skew
        reply = recv + proc
        ack = send + fwd + proc + ret
        assert ours.add(send, recv, reply, ack) == theirs.add(send, recv, reply, ack)
        assert ours.offset() == theirs.offset()
    assert list(ours.rtts) == list(theirs.rtts)
    # the NTP bound: within half the largest path asymmetry of the true skew
    assert abs(ours.offset() - skew) <= 0.5 * max(asym) + 1e-9
    assert wire.OffsetEstimator().offset() is None


# ------------------------------------------------- the one-shot exchange
@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_exchange_interoperates_with_envelopes(fresh_obs, client, server):
    """Either package's ``request_json_line`` against either's
    ``serve_json_line``: the handler never sees ``_wire``, the reply echoes
    an envelope (the server's identity, ``serve_extra`` keys, ``recv_ts <=
    reply_ts``), and the client books the edge under the server's name."""
    srv_fleet, srv_wire = (fleet, wire) if server == "port" else (jfleet, jwire)
    cli_fleet, cli_wire = (fleet, wire) if client == "port" else (jfleet, jwire)
    srv_fleet.set_fleet_identity(worker="srv")
    cli_fleet.set_fleet_identity(worker="cli")
    seen = []

    def handler(req):
        seen.append(req)
        srv_wire.serve_extra(commit_flow=99)
        return {"ok": True, "x": req["x"]}

    port, served = _serve(srv_fleet.serve_json_line, handler)
    resp = cli_fleet.request_json_line("127.0.0.1", port, {"cmd": "ping", "x": 3}, 5.0)
    assert served.wait(5.0)
    assert resp == {"ok": True, "x": 3} and seen == [{"cmd": "ping", "x": 3}]
    env = cli_wire.last_reply_envelope()
    assert env["src"] == "srv" and env["commit_flow"] == 99
    assert env["recv_ts"] <= env["reply_ts"]
    reg = (get_registry if client == "port" else jax_get_registry)()
    snap = reg.snapshot()
    assert {r["labels"]["peer"] for r in _metric_values(snap, "wire.rtt_ms")} == {"srv"}
    assert {r["labels"]["peer"] for r in _metric_values(snap, "wire.clock_offset_ms")} == {"srv"}
    srv_snap = (get_registry if server == "port" else jax_get_registry)().snapshot()
    assert [r["labels"] for r in _metric_values(srv_snap, "wire.requests_total")
            if r["labels"]["peer"] == "cli"] == [{"peer": "cli", "op": "ping"}]


@pytest.mark.parametrize("server", ["jax", "port"])
def test_a_bare_request_gets_the_pre_envelope_reply_bytes(fresh_obs, server):
    serve_json_line = fleet.serve_json_line if server == "port" else jfleet.serve_json_line
    port, _ = _serve(serve_json_line, lambda req: {"echo": req["x"]}, n=2)
    assert _raw(port, b'{"cmd": "ping", "x": 7}\n') == b'{"echo": 7}\n'
    assert _raw(port, b'{"cmd": "ping", "x": 7\n') == b'{"error": "bad request"}\n'


@pytest.mark.parametrize("client", ["jax", "port"])
def test_wire_disabled_sends_pre_envelope_bytes(fresh_obs, client):
    cli_fleet, cli_wire = (fleet, wire) if client == "port" else (jfleet, jwire)
    cli_wire.configure_wire(enabled=False)
    port, lines = _capture_one()
    assert cli_fleet.request_json_line("127.0.0.1", port, {"cmd": "ping", "a": [1]}, 5.0) == {
        "ok": True}
    assert lines == [(json.dumps({"cmd": "ping", "a": [1]}) + "\n").encode()]
    assert "wire.requests_total" not in (
        get_registry if client == "port" else jax_get_registry)().snapshot()["metrics"]


def test_disabled_bytes_equal_jax_both_ways(fresh_obs):
    """With the envelope off the two clients send the same bytes, and the
    two servers answer a bare request with the same bytes."""
    wire.configure_wire(enabled=False)
    jwire.configure_wire(enabled=False)
    req = {"cmd": "push", "worker": "1", "payload": "QUJD", "weight": 0.5}
    sent = []
    for mod in (fleet, jfleet):
        port, lines = _capture_one()
        mod.request_json_line("127.0.0.1", port, req, 5.0)
        sent.append(lines[0])
    assert sent[0] == sent[1]
    replies = []
    for mod in (fleet, jfleet):
        port, _ = _serve(mod.serve_json_line, lambda r: {"version": 3, "got": r})
        replies.append(_raw(port, sent[0]))
    assert replies[0] == replies[1] == (json.dumps({"version": 3, "got": req}) + "\n").encode()


def test_envelope_overhead_is_bounded(fresh_obs):
    fleet.set_fleet_identity(worker="12")
    over = wire.envelope_overhead_bytes({"cmd": "push", "payload": "x" * 1000})
    assert 60 < over < 200


# ----------------------------------------------------------- the services
def test_jax_client_against_the_ports_authority(fresh_obs, tmp_path):
    """A JAX ``FleetRpc`` says hello, seeds and reads the global of the
    port's commit authority: each reply envelope carries the authority's
    identity and incarnation, and the ``global`` reply the commit's flow."""
    from fedrec_tpu.parallel.rpc import FleetRpc as JaxFleetRpc
    from fedrec_tpu_torch.agg import server as pserver
    from fedrec_tpu_torch.agg.commit import CommitPolicy

    fleet.set_fleet_identity(worker="aggserver")
    jfleet.set_fleet_identity(worker="0")
    auth = pserver.AggServer(policy=CommitPolicy(quorum=1), world=1).start()
    try:
        rpc = JaxFleetRpc(auth.host, auth.port)
        rpc.call({"cmd": "hello", "worker": "0", "epoch": 0}, op="hello")
        assert jwire.last_reply_envelope()["incarnation"] == 1
        leaves = [np.zeros((2, 3), np.float32)]
        rpc.call({"cmd": "init", "worker": "0", "payload": pserver.encode_leaves(leaves)},
                 op="init")
        push = {"cmd": "push", "worker": "0", "round": 0, "epoch": 0, "based_on": 0,
                "weight": 1.0, "payload": pserver.encode_leaves([np.ones((2, 3), np.float32)]),
                "push_id": "p0"}
        assert rpc.call(push, op="push")["committed"]
        resp = rpc.call({"cmd": "global", "since": 0}, op="global")
        env = jwire.last_reply_envelope()
        assert resp["version"] == 1 and "payload" in resp and "_wire" not in resp
        assert env["src"] == "aggserver" and isinstance(env["commit_flow"], int)
    finally:
        auth.stop()


def test_ports_client_against_the_jax_authority(fresh_obs):
    from fedrec_tpu.agg import server as jserver
    from fedrec_tpu.agg.commit import CommitPolicy as JaxCommitPolicy
    from fedrec_tpu_torch.parallel.rpc import FleetRpc

    jfleet.set_fleet_identity(worker="aggserver")
    auth = jserver.AggServer(policy=JaxCommitPolicy(quorum=1), world=1).start()
    try:
        rpc = FleetRpc(auth.host, auth.port)
        assert rpc.call({"cmd": "hello", "worker": "0", "epoch": 0}, op="hello")["version"] == 0
        env = wire.last_reply_envelope()
        assert env["src"] == "aggserver" and env["incarnation"] == 1
        snap = get_registry().snapshot()
        assert [r["labels"] for r in _metric_values(snap, "wire.rtt_ms")] == [
            {"peer": "aggserver", "op": "hello"}]
    finally:
        auth.stop()


@pytest.mark.parametrize("client", ["jax", "port"])
def test_membership_collector_answers_with_an_envelope(fresh_obs, tmp_path, client):
    from fedrec_tpu_torch.parallel.membership import MembershipServer

    fleet.set_fleet_identity(worker="membership")
    svc = MembershipServer(collector=fleet.TelemetryCollector(tmp_path)).start()
    cli_fleet, cli_wire = (fleet, wire) if client == "port" else (jfleet, jwire)
    try:
        resp = cli_fleet.request_json_line(
            "127.0.0.1", svc.port, {"cmd": "telemetry_push", "worker": "5",
                                    "snapshot": {"kind": "registry_snapshot", "ts": 1.0,
                                                 "metrics": {}}}, 5.0)
        assert resp == {"ok": True, "worker": "5"}
        assert cli_wire.last_reply_envelope()["src"] == "membership"
    finally:
        svc.stop()


class _StubService:
    """What the serving TCP layer reads of a service: ``handle`` and the
    live connections."""

    def __init__(self):
        self._conns = set()
        self.seen = []

    async def handle(self, req):
        self.seen.append(req)
        return {"id": req.get("id"), "ids": [1, 2], "echo": req.get("x")}


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_serving_envelope_both_ways(fresh_obs, client, server):
    """Either package's ``ServingClient`` against either's asyncio TCP layer
    (``serving.server._handle_conn``): the service never sees ``_wire``,
    the reply envelope is stripped client-side, and the client books the
    edge's RTT; the server books its ``wire.serve`` span."""
    from fedrec_tpu.serving import client as jclient_mod
    from fedrec_tpu.serving import server as jserver_mod
    from fedrec_tpu_torch.serving import client as client_mod
    from fedrec_tpu_torch.serving import server as server_mod

    srv_fleet = fleet if server == "port" else jfleet
    srv_fleet.set_fleet_identity(worker="serve")
    handle_conn = (server_mod if server == "port" else jserver_mod)._handle_conn
    Client = (client_mod if client == "port" else jclient_mod).ServingClient
    svc = _StubService()

    async def go():
        srv = await asyncio.start_server(lambda r, w: handle_conn(svc, r, w), "127.0.0.1", 0)
        c = Client("127.0.0.1", srv.sockets[0].getsockname()[1], seed=1)
        try:
            return [await c.request({"id": i, "x": i * 2}, deadline_ms=5000) for i in range(3)]
        finally:
            await c.close()
            srv.close()
            await srv.wait_closed()

    replies = asyncio.run(asyncio.wait_for(go(), 30))
    assert replies == [{"id": i, "ids": [1, 2], "echo": i * 2} for i in range(3)]
    assert all("_wire" not in r for r in svc.seen)
    cli_reg = (get_registry if client == "port" else jax_get_registry)()
    rtt = _metric_values(cli_reg.snapshot(), "wire.rtt_ms")
    assert [(r["labels"], r["count"]) for r in rtt] == [({"peer": "serve", "op": "score"}, 3)]
    if server == "port":
        assert sum(e["name"] == "wire.serve" for e in get_tracer().events()) == 3


# -------------------------------------------------------------- flow arrows
def test_push_commit_adoption_arrows_merge_across_processes(fresh_obs, tmp_path):
    """Two workers (this process, a tracer each) push through the port's
    authority (``python -m fedrec_tpu_torch.agg.server``, quorum 2, its
    ``--obs-dir`` under the fleet root) and adopt the commit. Merged by
    either package: each push's ``wire.request`` arrow ends in the
    authority's track, the authority's push -> commit arrows stay in its
    track, and the commit's arrow ends in both workers' adoption spans."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from fedrec_tpu_torch.agg import server as pserver
    from fedrec_tpu_torch.parallel.membership import free_port
    from fedrec_tpu_torch.parallel.rpc import FleetRpc

    root = Path(__file__).resolve().parents[1]
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "fedrec_tpu_torch.agg.server", f"127.0.0.1:{port}",
         "--quorum", "2", "--world", "2", "--obs-dir", str(tmp_path / "worker_aggserver")],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    workers = {w: Tracer() for w in ("0", "1")}
    try:
        _wait_until_it_answers(port, "status")
        for w, tr in workers.items():
            set_tracer(tr)
            fleet.set_fleet_identity(worker=w, tracer=tr)
            rpc = FleetRpc("127.0.0.1", port)
            rpc.call({"cmd": "init", "worker": w,
                      "payload": pserver.encode_leaves([np.zeros(4, np.float32)])})
            rpc.call({"cmd": "push", "worker": w, "round": 0, "epoch": 0, "based_on": 0,
                      "weight": 1.0, "payload": pserver.encode_leaves([np.ones(4, np.float32)]),
                      "push_id": f"p{w}"}, op="push")
        for w, tr in workers.items():
            set_tracer(tr)
            fleet.set_fleet_identity(worker=w, tracer=tr)
            FleetRpc("127.0.0.1", port).call({"cmd": "global", "since": 0}, op="global")
            flow = wire.last_reply_envelope()["commit_flow"]
            with tr.span("agg.adopt", version=1):
                tr.flow("in", int(flow))
    finally:
        proc.terminate()
        proc.communicate(timeout=20)
    for w, tr in workers.items():
        (tmp_path / f"worker_{w}").mkdir()
        tr.save(tmp_path / f"worker_{w}" / "trace.json")
    for mod in (fleet, jfleet):
        doc = mod.build_fleet_trace(mod.load_fleet_dir(tmp_path))
        pid = doc["otherData"]["workers"]
        auth, ws = pid["aggserver"], {pid["0"], pid["1"]}
        ends: dict = {}
        for e in doc["traceEvents"]:
            if e.get("cat") == "wire":
                ends.setdefault(e["id"], {})[e["ph"]] = e["pid"]
        cross_in = [v for v in ends.values() if v.get("s") in ws and v.get("f") == auth]
        intra = [v for v in ends.values() if v.get("s") == auth and v.get("f") == auth]
        cross_out = [v for v in ends.values() if v.get("s") == auth and v.get("f") in ws]
        assert len(cross_in) >= 6  # init, push and global of each worker
        assert len(intra) == 2  # each folded push into the commit
        assert len(cross_out) == 1  # the commit's arrow (its last end wins here)
        adoptions = [e for e in doc["traceEvents"] if e.get("ph") == "f" and e["pid"] in ws
                     and e["id"] in {k for k, v in ends.items() if v.get("s") == auth}]
        assert {e["pid"] for e in adoptions} == ws
