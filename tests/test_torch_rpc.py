"""The port's wire failure handling (``fedrec_tpu_torch.parallel.rpc``) and
wire faults (``fed.chaos``'s ``parse_wire_faults``, ``WireFaultPlan``,
``ChaosProxy``), held to ``tests/test_rpc.py``'s behaviour: backoff and
breaker, retries through faults on a real socket of 127.0.0.1, an error
reply never retried, the proxy's byte-verbatim passthrough, tear, dup and
partition; and the fault plans, drawn per connection, equal to the JAX
package's for the same spec and seed."""

from __future__ import annotations

import json
import random
import socket
import threading
import time

import pytest

from fedrec_tpu.fed import chaos as jchaos
from fedrec_tpu.parallel import rpc as jrpc
from fedrec_tpu_torch.fed.chaos import ChaosProxy, WireFaultPlan, parse_wire_faults
from fedrec_tpu_torch.obs import MetricsRegistry, get_registry, set_registry
from fedrec_tpu_torch.obs.fleet import request_json_line
from fedrec_tpu_torch.parallel.rpc import (
    RC_DEGRADED,
    AuthorityUnreachable,
    CircuitBreaker,
    CircuitOpen,
    FleetRpc,
    RpcPolicy,
    backoff_delay_s,
    new_push_id,
)


@pytest.fixture(autouse=True)
def _fresh_registry():
    set_registry(MetricsRegistry())
    yield
    set_registry(MetricsRegistry())


def test_backoff_bounds_and_stream_equal_jax():
    rng, jrng = random.Random(0), random.Random(0)
    for attempt in range(8):
        cap_s = min(2000.0, 50.0 * 2 ** attempt) / 1e3
        for _ in range(20):
            d = backoff_delay_s(attempt, 50.0, 2000.0, rng)
            assert 0.0 <= d <= cap_s
            assert d == jrpc.backoff_delay_s(attempt, 50.0, 2000.0, jrng)


def test_new_push_id_shape_and_uniqueness():
    ids = {new_push_id("w3", 5) for _ in range(64)}
    assert len(ids) == 64 and all(i.startswith("w3:5:") for i in ids)


def test_policy_budgets_and_degraded_code():
    pol = RpcPolicy(attempts=4, op_attempts={"global": 1, "none": 0})
    assert (pol.attempts_for("push"), pol.attempts_for("global"), pol.attempts_for("none")) == (
        4, 1, 1)
    assert RC_DEGRADED == 75 and AuthorityUnreachable("x").returncode == 75
    assert issubclass(CircuitOpen, OSError)


def test_circuit_breaker_transitions():
    br = CircuitBreaker(threshold=2, reset_s=0.05)
    assert br.state == "closed" and br.allow()
    br.failure()
    assert br.state == "closed"
    br.failure()
    assert br.state == "open" and br.opens == 1
    assert not br.allow()                       # fail fast while open
    time.sleep(0.06)
    assert br.state == "half-open"
    assert br.allow()                           # the first caller is the probe
    assert not br.allow()                       # the others are still refused
    br.failure()                                # a failed probe re-opens
    assert br.state == "open" and br.opens == 1
    time.sleep(0.06)
    assert br.allow()
    br.success()
    assert br.state == "closed" and br.consec_failures == 0


def _serve(reply: bytes | None):
    """A one-shot JSON-lines server on 127.0.0.1: echoes ``{"echo": x}`` or
    sends ``reply``; returns (port, requests seen, stop)."""
    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(0.2)
    hits: list[dict] = []
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                conn.settimeout(5.0)
                buf = b""
                try:
                    while b"\n" not in buf:
                        chunk = conn.recv(65536)
                        if not chunk:
                            break
                        buf += chunk
                    if b"\n" not in buf:
                        continue
                    req = json.loads(buf.split(b"\n", 1)[0])
                    hits.append(req)
                    conn.sendall(reply if reply is not None
                                 else (json.dumps({"echo": req.get("x")}) + "\n").encode())
                except OSError:
                    pass

    threading.Thread(target=loop, daemon=True).start()

    def close():
        stop.set()
        srv.close()

    return srv.getsockname()[1], hits, close


@pytest.fixture()
def echo():
    port, hits, close = _serve(None)
    yield port, hits
    close()


def _dead_port() -> int:
    with socket.create_server(("127.0.0.1", 0)) as s:
        return s.getsockname()[1]


def _policy(**kw):
    base = dict(connect_timeout_s=2.0, read_timeout_s=5.0, attempts=4, backoff_base_ms=5.0,
                backoff_max_ms=20.0, seed=0)
    return RpcPolicy(**{**base, **kw})


def test_fleet_rpc_roundtrip_and_accounting(echo):
    port, _ = echo
    rpc = FleetRpc("127.0.0.1", port, _policy())
    assert rpc.call({"cmd": "t", "x": 3})["echo"] == 3
    assert (rpc.ok, rpc.errors, rpc.op_ok) == (1, 0, {"t": 1})
    assert rpc.unreachable_for() < 5.0
    assert get_registry().gauge("wire.circuit_state", labels=("peer",)).value(
        peer=rpc.peer) == 0.0


def test_fleet_rpc_retries_through_transient_deadness(echo):
    """Seed 5 drops a mix of connections at p = 0.5; a budget of 6 rides it
    out, the retries counted per edge."""
    port, _ = echo
    proxy = ChaosProxy("127.0.0.1", port, plan=WireFaultPlan("drop@*:0.5", seed=5)).start()
    try:
        rpc = FleetRpc(proxy.host, proxy.port, _policy(attempts=6))
        for i in range(4):
            assert rpc.call({"cmd": "t", "x": i})["echo"] == i
        assert rpc.retries >= 1 and proxy.injected["drop"] == rpc.retries
        assert rpc.op_ok == {"t": 4} and rpc.op_errors == {"t": rpc.retries}
        assert get_registry().counter("wire.retries_total", labels=("peer", "op")).value(
            peer=rpc.peer, op="t") == rpc.retries
    finally:
        proxy.stop()


def test_fleet_rpc_budget_exhaustion_raises_oserror():
    rpc = FleetRpc("127.0.0.1", _dead_port(), _policy(attempts=2))
    with pytest.raises(OSError):
        rpc.call({"cmd": "t"})
    assert (rpc.errors, rpc.retries, rpc.last_ok) == (2, 1, None)


def test_fleet_rpc_breaker_opens_and_fails_fast():
    rpc = FleetRpc("127.0.0.1", _dead_port(),
                   _policy(attempts=3, breaker_threshold=3, breaker_reset_s=60.0))
    with pytest.raises(OSError):
        rpc.call({"cmd": "t"})
    assert rpc.breaker.state == "open"
    assert get_registry().counter("wire.circuit_open_total", labels=("peer",)).value(
        peer=rpc.peer) == 1.0
    t0 = time.monotonic()
    with pytest.raises(CircuitOpen):
        rpc.call({"cmd": "t"})
    assert time.monotonic() - t0 < 0.5          # no dial deadline spent


def test_fleet_rpc_application_error_not_retried():
    port, hits, close = _serve(b'{"error": "rebase: nope"}\n')
    try:
        rpc = FleetRpc("127.0.0.1", port, _policy(attempts=4))
        with pytest.raises(ValueError, match="rebase"):
            rpc.call({"cmd": "push"})
        assert len(hits) == 1                   # never asked again
        assert rpc.last_ok is not None          # the peer is alive
    finally:
        close()


def test_fleet_rpc_retries_a_reply_torn_mid_line():
    """A peer that hangs up inside its reply line (an authority killed while
    it streams a large ``global``) is a transport failure: ``OSError``,
    retried into the budget, the peer not counted alive. The JAX client
    reads the torn line as a malformed answer and gives up."""
    port, hits, close = _serve(b'{"version": 3, "leaves": [0.1, 0.2')
    try:
        with pytest.raises(OSError, match="mid-reply"):
            request_json_line("127.0.0.1", port, {"cmd": "global"}, timeout_s=5.0)
        rpc = FleetRpc("127.0.0.1", port, _policy(attempts=3))
        with pytest.raises(OSError, match="mid-reply"):
            rpc.call({"cmd": "global"})
        assert (rpc.retries, rpc.errors, rpc.last_ok) == (2, 3, None)
        assert len(hits) == 4
    finally:
        close()


def test_dial_deadline_is_split_from_the_read_deadline():
    """A peer that accepts and never answers costs the read deadline, not
    the dial's; a request that hangs up without a reply is an ``OSError``."""
    silent = socket.create_server(("127.0.0.1", 0))
    try:
        t0 = time.monotonic()
        with pytest.raises(OSError):
            request_json_line("127.0.0.1", silent.getsockname()[1], {"cmd": "t"},
                              timeout_s=0.3, connect_timeout_s=5.0)
        assert 0.25 < time.monotonic() - t0 < 3.0
    finally:
        silent.close()


# ------------------------------------------------------------ wire faults
def test_parse_wire_faults_windows_and_args():
    spec = "tear@2-4,dup@5-8:3,partition@20-30,drop@*:0.3,delay@1:250"
    entries = parse_wire_faults(spec)
    assert entries == jchaos.parse_wire_faults(spec)
    assert ("tear", 2.0, 4.0, 0.0) in entries
    assert ("dup", 5.0, 8.0, 3.0) in entries
    assert ("partition", 20.0, 30.0, 0.0) in entries
    assert ("drop", 0.0, float("inf"), 0.3) in entries
    assert ("delay", 1.0, 2.0, 250.0) in entries  # a single t is [t, t+1)


@pytest.mark.parametrize("bad", ["tear", "tear@4-2", "warp@1-2", "drop@x-y"])
def test_parse_wire_faults_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_wire_faults(bad)
    with pytest.raises(ValueError):
        jchaos.parse_wire_faults(bad)


@pytest.mark.parametrize("spec,seed", [("drop@*:0.4", 9), ("drop@*:0.5,tear@1-3", 5),
                                       ("dup@0-2:3,partition@2-4,delay@*:50", 0),
                                       ("drop@0-10:0.25,drop@5-20:0.75", 123)])
def test_wire_fault_plan_actions_equal_jax(spec, seed):
    mine, theirs = WireFaultPlan(spec, seed=seed), jchaos.WireFaultPlan(spec, seed=seed)
    for t in (0.0, 1.5, 2.5, 4.0, 7.0, 12.0):
        for conn in range(24):
            assert mine.actions(t, conn) == theirs.actions(t, conn), (t, conn)
    fates = [bool(mine.actions(1.0, i)) for i in range(32)]
    assert fates == [bool(WireFaultPlan(spec, seed=seed).actions(1.0, i)) for i in range(32)]


def test_chaos_proxy_passthrough_is_byte_verbatim(echo):
    """With no plan the proxy forwards request and reply bytes verbatim."""
    port, hits = echo
    proxy = ChaosProxy("127.0.0.1", port).start()
    try:
        line = b'{"cmd": "t", "x": 42, "pad": "\\u00e9"}\n'
        got = []
        for target in (("127.0.0.1", port), (proxy.host, proxy.port)):
            with socket.create_connection(target, timeout=5) as c:
                c.sendall(line)
                got.append(c.recv(65536))
        assert got[0] == got[1]
        assert hits[0] == hits[1]
        assert proxy.injected == {}
    finally:
        proxy.stop()


@pytest.mark.parametrize("kind", ["tear", "partition"])
def test_chaos_proxy_tear_and_partition_are_ackless(echo, kind):
    """A tear hands the peer half a line and the client an ackless close; a
    partition lets no byte through. Neither reaches the handler."""
    port, hits = echo
    proxy = ChaosProxy("127.0.0.1", port, plan=WireFaultPlan(f"{kind}@0-600")).start()
    try:
        with pytest.raises(OSError):
            request_json_line(proxy.host, proxy.port, {"cmd": "t", "x": 1}, timeout_s=5)
        assert proxy.injected == {kind: 1}
        assert hits == []
        assert get_registry().counter("chaos.wire_faults_total", labels=("kind",)).value(
            kind=kind) == 1.0
    finally:
        proxy.stop()


def test_chaos_proxy_dup_delivers_twice(echo):
    port, hits = echo
    proxy = ChaosProxy("127.0.0.1", port, plan=WireFaultPlan("dup@0-600")).start()
    try:
        resp = request_json_line(proxy.host, proxy.port, {"cmd": "t", "x": 7}, timeout_s=5)
        assert resp["echo"] == 7                # the client still gets its reply
        assert len(hits) == 2 and hits[0] == hits[1]
        assert proxy.injected == {"dup": 1}
    finally:
        proxy.stop()


def test_chaos_module_imports_without_torch():
    """The coordinator reads ``fed.chaos`` before it imports torch, and the
    wire faults keep it so."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys; import fedrec_tpu_torch.fed.chaos as c; "
            "import fedrec_tpu_torch.parallel.rpc; c.WireFaultPlan('tear@1-2'); "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
