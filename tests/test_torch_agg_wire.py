"""The port's async wire deployment (``fedrec_tpu_torch.agg.server``,
``agg.worker``, the run CLI's ``--agg-server``) against the JAX package's
(``fedrec_tpu/agg/server.py``, ``agg/worker.py``):

* authority parity: one scripted request sequence (hello, init, pushes
  across the quorum, a late fold, a stale drop, duplicate ``push_id``s, a
  ``rebase``, int8 / topk / countsketch payloads, a bad codec) through
  ``handle`` of a JAX ``AggServer`` and of the port's: the replies equal
  apart from timing fields, every global bitwise; then each authority
  restores the other's ``--state-dir`` and resumes at the same version as
  incarnation + 1, and the two go on equal;
* the wire blobs (``encode_leaves``, ``encode_payloads``) decode in the
  other package to equal arrays;
* a mixed world, one JAX worker and one torch worker at quorum 2 of 2 on the
  port's authority, against two JAX workers on the JAX authority: every
  committed global at the train path's bars (rtol 2e-4 / atol 1e-4, the
  zero-gradient leaves within 1e-3), the round losses at rtol 1e-5 / atol
  1e-6; its exchanges carry the wire envelope both ways, and ``fedrec-obs
  fleet`` merges the JAX worker's and the authority's artifacts;
* the port's own: a dense push that does not fit the global is refused; a
  torch worker against a dead address exits 75 within its budget; a worker
  rides an authority restart (resync, no acked push lost); the authority
  runs without a CUDA context.

Everything runs in threads on 127.0.0.1 at the population file's small
widths, ``device="cpu"``.
"""

from __future__ import annotations

import copy
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fedrec_tpu.agg import commit as jcommit
from fedrec_tpu.agg import server as jserver
from fedrec_tpu.comms import encode_leaf as jencode_leaf
from fedrec_tpu_torch.agg import commit as pcommit
from fedrec_tpu_torch.agg import server as pserver
from fedrec_tpu_torch.cli import run
from fedrec_tpu_torch.comms import encode_leaf
from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, get_registry, set_registry, set_tracer
from fedrec_tpu_torch.parallel.rpc import AuthorityUnreachable
from fedrec_tpu_torch.train import Trainer

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_population as tp  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_registries():
    from fedrec_tpu.obs import MetricsRegistry as JaxRegistry
    from fedrec_tpu.obs import Tracer as JaxTracer
    from fedrec_tpu.obs import set_registry as jax_set_registry
    from fedrec_tpu.obs import set_tracer as jax_set_tracer
    from fedrec_tpu.obs.fleet import reset_fleet_identity as jax_reset_fleet_identity
    from fedrec_tpu_torch.obs.fleet import reset_fleet_identity

    jax_set_registry(JaxRegistry())
    jax_set_tracer(JaxTracer())
    set_registry(MetricsRegistry())
    set_tracer(Tracer())
    yield
    jax_set_registry(JaxRegistry())
    set_registry(MetricsRegistry())
    jax_reset_fleet_identity()
    reset_fleet_identity()


# ------------------------------------------------------- authority parity
_SHAPES = [(6, 4), (5,), (3, 2, 2)]
_TIMING = ("quorum_wait_ms", "gate_ms", "fold_ms")
_SEED = 7


def _leaves(rng, scale=1.0):
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in _SHAPES]


def _payload(codec: str, leaves) -> str:
    if codec == "none":
        return pserver.encode_leaves(leaves)
    return pserver.encode_payloads([
        encode_leaf(x, codec, 0.25, sketch_width=0.5, sketch_seed=_SEED, leaf_id=j)
        for j, x in enumerate(leaves)])


def _push(worker, rnd, based_on, payload, codec="none", push_id=None):
    return {"cmd": "push", "worker": worker, "round": rnd, "epoch": 0, "based_on": based_on,
            "weight": 1.0, "payload": payload, "codec": codec,
            "push_id": push_id or f"{worker}:{rnd}:fixed"}


def _script():
    """The request sequence, each payload encoded once and sent to both."""
    rng = np.random.default_rng(0)
    d = [_leaves(rng, 0.1) for _ in range(8)]
    return [
        {"cmd": "global", "since": -1},                         # before init
        _push("a", 0, 0, _payload("none", d[0])),               # push before init
        {"cmd": "hello", "worker": "a", "epoch": 0},
        {"cmd": "hello", "worker": "b", "epoch": 0},
        {"cmd": "hello", "worker": "c", "epoch": 0},
        {"cmd": "init", "worker": "a", "payload": pserver.encode_leaves(_leaves(rng))},
        {"cmd": "init", "worker": "b", "payload": pserver.encode_leaves(_leaves(rng))},
        {"cmd": "global", "since": -1},
        _push("a", 0, 0, _payload("none", d[0])),               # pending {a}
        _push("b", 0, 0, _payload("int8", d[1]), "int8"),       # quorum: v1
        _push("a", 0, 0, _payload("none", d[0])),               # folded id again: duplicate
        _push("c", 0, 0, _payload("topk", d[2]), "topk"),       # late, pending {c}
        _push("a", 1, 1, _payload("countsketch", d[3]), "countsketch"),  # v2, c folds late
        _push("b", 1, 0, _payload("none", d[4])),               # staleness 2 > cap 1
        _push("c", 1, 2, _payload("countsketch", d[5]), "countsketch"),  # v3, b dropped
        _push("a", 2, 3, _payload("none", d[6])),               # pending {a}
        _push("a", 2, 3, _payload("none", d[6])),               # pending id again: duplicate
        _push("a", 2, 3, _payload("none", d[7]), push_id="a:2:retrained"),  # supersedes
        _push("b", 2, 9, _payload("none", d[7])),               # ahead of the global: rebase
        _push("b", 2, 3, _payload("sign1bit", d[7]), "nope"),   # bad codec
        {"cmd": "global", "since": 1},
        {"cmd": "global", "since": 3},
        {"cmd": "frobnicate"},
        {"cmd": "status"},
    ]


def _norm(reply: dict) -> dict:
    """A reply with its timing fields dropped and its payload decoded."""
    out = copy.deepcopy(reply)
    if "payload" in out:
        out["payload"] = pserver.decode_leaves(out["payload"])
    if "commits" in out:
        for c in out["commits"]:
            for k in _TIMING:
                c.pop(k, None)
        out["gate_ms"] = sorted(out["gate_ms"])
    return out


def _assert_equal(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a, b)
        for k in a:
            _assert_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, (where, a, b)


def _authorities(jdir, pdir):
    kw = dict(world=3, sketch_seed=_SEED)
    return (jserver.AggServer(policy=jcommit.CommitPolicy(quorum=2, staleness_cap=1),
                              state_dir=str(jdir), **kw),
            pserver.AggServer(policy=pcommit.CommitPolicy(quorum=2, staleness_cap=1),
                              state_dir=str(pdir), **kw))


def test_authority_replies_and_globals_equal_jax_then_cross_restore(tmp_path):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jsrv, psrv = _authorities(jdir, pdir)
    for i, req in enumerate(_script()):
        want, got = jsrv.handle(req), psrv.handle(req)
        _assert_equal(_norm(got), _norm(want), f"request {i} ({req['cmd']})")
    st = psrv.status()
    assert st["version"] == 3 and st["push_dups"] == 2
    folds = [(c["late_folds"], c["stale_drops"]) for c in st["commits"]]
    assert folds == [(0, 0), (1, 0), (0, 1)]
    assert sorted(v["disposition"] for v in st["ledger"].values()) == [
        "folded"] * 5 + ["stale_dropped", "superseded"]
    assert st["pending_push_ids"] == ["a:2:retrained"]
    _assert_equal(psrv.global_leaves, [np.asarray(x) for x in jsrv.global_leaves])
    assert not torch.cuda.is_initialized()      # a host-only fold
    jsrv.stop()
    psrv.stop()

    # each package restores the other's state directory
    jsrv2, psrv2 = _authorities(pdir, jdir)
    for srv in (jsrv2, psrv2):
        assert (srv.version, srv.incarnation) == (3, 2)
    _assert_equal(_norm(psrv2.status()), _norm(jsrv2.status()), "restored status")
    _assert_equal(psrv2.global_leaves, [np.asarray(x) for x in jsrv2.global_leaves])
    rng = np.random.default_rng(1)
    again = [_push("a", 2, 3, _payload("none", _leaves(rng)), push_id="a:0:fixed"),
             _push("b", 3, 4, _payload("none", _leaves(rng))),
             {"cmd": "hello", "worker": "b", "epoch": 0},
             _push("b", 3, 3, _payload("int8", _leaves(rng, 0.1)), "int8"),
             {"cmd": "global", "since": 3}, {"cmd": "status"}]
    for i, req in enumerate(again):
        want, got = jsrv2.handle(req), psrv2.handle(req)
        _assert_equal(_norm(got), _norm(want), f"after restore, request {i} ({req['cmd']})")
    assert psrv2.version == 4 and psrv2.status()["push_dups"] == 1
    jsrv2.stop()
    psrv2.stop()


@pytest.mark.parametrize("codec", ["none", "int8", "sign1bit", "topk", "countsketch",
                                   "randproj"])
def test_wire_blobs_decode_in_the_other_package(codec):
    rng = np.random.default_rng(3)
    leaves = _leaves(rng)
    if codec == "none":
        blobs = [(pserver.encode_leaves(leaves), jserver.decode_leaves),
                 (jserver.encode_leaves(leaves), pserver.decode_leaves)]
        for blob, decode in blobs:
            _assert_equal(decode(blob), leaves)
        return
    payloads = [encode_leaf(x, codec, 0.25, sketch_width=0.5, sketch_seed=_SEED, leaf_id=j)
                for j, x in enumerate(leaves)]
    jpayloads = [jencode_leaf(x, codec, 0.25, sketch_width=0.5, sketch_seed=_SEED, leaf_id=j)
                 for j, x in enumerate(leaves)]
    _assert_equal([{k: np.asarray(v) for k, v in p.items()} for p in jpayloads],
                  [{k: np.asarray(v) for k, v in p.items()} for p in payloads])
    for blob, decode in ((pserver.encode_payloads(payloads), jserver.decode_payloads),
                         (jserver.encode_payloads(jpayloads), pserver.decode_payloads)):
        got = decode(blob)
        _assert_equal([{k: np.asarray(v) for k, v in p.items()} for p in got],
                      [{k: np.asarray(v) for k, v in p.items()} for p in payloads])


def test_the_authority_imports_no_torch():
    """The commit authority is host only: it restarts in an interpreter's
    time and can never create a CUDA context."""
    import subprocess

    code = ("import sys, numpy as np; from fedrec_tpu_torch.agg import server as s; "
            "a = s.AggServer(); a.handle({'cmd': 'init', 'worker': 'w', "
            "'payload': s.encode_leaves([np.zeros(3, np.float32)])}); "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"


def test_a_dense_push_that_does_not_fit_is_refused():
    srv = pserver.AggServer(policy=pcommit.CommitPolicy(quorum=1), world=1)
    srv.handle({"cmd": "init", "worker": "a",
                "payload": pserver.encode_leaves(_leaves(np.random.default_rng(0)))})
    short = _leaves(np.random.default_rng(1))[:2]
    assert "2 leaves, global has 3" in srv.handle(
        _push("a", 0, 0, pserver.encode_leaves(short)))["error"]
    wrong = [np.zeros((4, 6), np.float32), *short[1:], np.zeros((3, 2, 2), np.float32)]
    assert "leaf 0 has shape (4, 6)" in srv.handle(
        _push("a", 0, 0, pserver.encode_leaves(wrong)))["error"]
    assert srv.version == 0 and len(srv.buffer) == 0


# ---------------------------------------------------------- a mixed world
_WIRE = {"agg.worker_global_wait_s": 60.0, "agg.worker_poll_s": 0.02,
         "agg.worker_connect_timeout_s": 2.0, "agg.worker_timeout_s": 30.0}
# the JAX async smoke's learning rate (scripts/async_smoke.sh). Adam turns
# the zero-gradient leaves' rounding noise into steps of up to lr each, which
# the two packages take in their own directions: 4 steps a round at 1e-3
# keep them inside the train path's 1e-3 noise bar with room
_WORLD_LR = {"optim.user_lr": 1e-3, "optim.news_lr": 1e-3}


def _world_cfgs(rounds: int, **over):
    jcfg, pcfg = tp._cfgs(0, 1, rounds, **_WIRE, **over)
    tp._copy_into(pcfg.agg, jcfg.agg)
    return jcfg, pcfg


def _recording(srv) -> list:
    """Every committed global of ``srv``, copied as the commit lands."""
    commits: list = []
    fire = srv._maybe_commit

    def record():
        done = fire()
        if done:
            commits.append([np.array(x) for x in srv.global_leaves])
        return done

    srv._maybe_commit = record
    return commits


def _run_world(srv, workers, rounds):
    """The workers (``(run_async_worker, trainer, id)``) in threads against
    ``srv``, seeded with the first trainer's parameters; returns each
    worker's round losses and the committed globals."""
    import jax

    commits = _recording(srv)
    srv.start()
    first = workers[0][1]
    init = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, first._client0_params()))
    srv.handle({"cmd": "init", "worker": "seed", "payload": jserver.encode_leaves(init)})
    out: dict = {}

    def drive(fn, trainer, wid):
        try:
            out[wid] = fn(trainer, srv.address, wid)
        except BaseException as e:  # noqa: BLE001 — reported below
            out[wid] = e

    threads = [threading.Thread(target=drive, args=w, daemon=True) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    srv.stop()
    assert not any(t.is_alive() for t in threads)
    for wid, hist in out.items():
        assert not isinstance(hist, BaseException), (wid, hist)
    assert len(commits) == rounds
    return {w: [r.train_loss for r in h] for w, h in out.items()}, commits


def _leaf_names(jt) -> list[str]:
    import jax

    paths = jax.tree_util.tree_flatten_with_path(jt._client0_params())[0]
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p) for p, _ in paths]


def test_mixed_jax_and_torch_world_matches_the_jax_world(tmp_path, capsys):
    import json

    from fedrec_tpu.agg.worker import run_async_worker as jax_worker
    from fedrec_tpu.obs import MetricsRegistry as JaxRegistry
    from fedrec_tpu.obs import Tracer as JaxTracer
    from fedrec_tpu.obs import set_registry as jax_set_registry
    from fedrec_tpu.obs import set_tracer as jax_set_tracer
    from fedrec_tpu.obs.fleet import set_fleet_identity as jax_set_fleet_identity
    from fedrec_tpu.obs.report import dump_artifacts as jax_dump_artifacts
    from fedrec_tpu.train.trainer import Trainer as JaxTrainer
    from fedrec_tpu_torch.agg.worker import run_async_worker as torch_worker
    from fedrec_tpu_torch.cli import obs as obs_cli
    from fedrec_tpu_torch.obs.fleet import set_fleet_identity
    from fedrec_tpu_torch.obs.report import dump_artifacts

    rounds = 2
    data, toks = tp._data(num_train=32)
    jcfg, pcfg = _world_cfgs(rounds, **_WORLD_LR)

    def authority(pkg):
        return pkg.AggServer(policy=(jcommit if pkg is jserver else pcommit).CommitPolicy(
            quorum=2, staleness_cap=2), world=2)

    ref_trainers = [JaxTrainer(jcfg, data, toks) for _ in range(2)]
    names = _leaf_names(ref_trainers[0])
    ref_losses, ref_commits = _run_world(
        authority(jserver), [(jax_worker, t, f"j{i}") for i, t in enumerate(ref_trainers)],
        rounds)
    assert ref_losses["j0"] == ref_losses["j1"]

    # the mixed world's telemetry on fresh instruments: the JAX worker's in
    # the JAX package's, the authority's (and the torch worker's, one
    # process here) in the port's
    jax_set_registry(JaxRegistry())
    jax_set_tracer(JaxTracer())
    set_registry(MetricsRegistry())
    set_tracer(Tracer())
    jax_set_fleet_identity(worker="j0")
    set_fleet_identity(worker="aggserver")
    mixed = [(jax_worker, JaxTrainer(jcfg, data, toks), "j0"),
             (torch_worker, Trainer(pcfg, data, toks, device="cpu"), "t1")]
    losses, commits = _run_world(authority(pserver), mixed, rounds)
    for wid in losses:
        np.testing.assert_allclose(losses[wid], ref_losses["j0"], rtol=1e-5, atol=1e-6,
                                   err_msg=wid)
    for v, (got, want) in enumerate(zip(commits, ref_commits)):
        for name, g, w in zip(names, got, want):
            if name.endswith(tp.NOISE_LEAVES):
                assert float(np.abs(g - w).max()) < 1e-3, (v, name)
            else:
                np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-4,
                                           err_msg=f"v{v + 1} {name}")
    jax_dump_artifacts(tmp_path / "worker_j0")
    dump_artifacts(tmp_path / "worker_aggserver")
    capsys.readouterr()
    assert obs_cli.main(["fleet", str(tmp_path), "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert set(report["workers"]) == {"aggserver", "j0"}
    assert report["agg"]["aggserver"]["role"] == "agg_server"
    assert report["agg"]["aggserver"]["commits"] == rounds
    edges = {(e["peer"], e["op"]): e for e in report["wire"]["edges"]["j0"]}
    assert {("aggserver", "push"), ("aggserver", "global")} <= set(edges)
    # one host, one clock: the measured offset lies within the edge's RTT / 2
    push = edges[("aggserver", "push")]
    assert abs(report["wire"]["offsets_ms"]["j0"]["aggserver"]) <= push["rtt_ms"] / 2
    served = {(e["peer"], e["op"]) for e in report["wire"]["edges"]["aggserver"]}
    assert {("j0", "push"), ("j0", "global")} <= served


# -------------------------------------------------------- the port's own
_SMALL_ARGS = [f"{k}={v}" for k, v in tp._SMALL.items()]


def _small_argv(rounds: int, *sets: str) -> list[str]:
    flags = [x for kv in (*_SMALL_ARGS, *sets) for x in ("--set", kv)]
    return [str(rounds), "8", "1", "--synthetic", "--synthetic-news", "64",
            "--synthetic-train", "64", "--clients", "1", "--device", "cpu", "--mode", "joint",
            *flags, "--set", "train.snapshot_dir="]


def test_worker_and_authority_entry_points_refuse(monkeypatch, capsys):
    """A worker needs a GPU unless given ``--device cpu`` and a
    ``--worker-id``; the authority refuses a malformed ``--slo`` spec with
    the grammar before it binds its port."""
    from fedrec_tpu_torch.device import NoGPUError

    argv = [a for a in _small_argv(1) if a not in ("--device", "cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoGPUError):
        run.main([*argv, "--agg-server", "127.0.0.1:1", "--worker-id", "w"])
    assert run.main([*argv, "--agg-server", "127.0.0.1:1"]) == 2
    assert "requires --worker-id" in capsys.readouterr().err
    with pytest.raises(ValueError, match="bad obs.slo.objectives entry"):
        pserver.main(["127.0.0.1:0", "--slo", "agg.staleness<2"])


def test_worker_against_a_dead_address_exits_75_within_its_budget():
    import socket

    with socket.create_server(("127.0.0.1", 0)) as s:
        dead = s.getsockname()[1]
    budget = ["agg.worker_connect_timeout_s=0.5", "agg.worker_rpc_attempts=2",
              "agg.worker_backoff_ms=10", "agg.worker_unreachable_budget_s=1"]
    rc = run.main([*_small_argv(2, *budget), "--agg-server", f"127.0.0.1:{dead}",
                   "--worker-id", "w"])
    assert rc == 75
    # the worker loop alone: it gives up within the budget plus one dial
    _, pcfg = _world_cfgs(2)
    pcfg.apply_overrides(budget)
    data, toks = tp._data(num_train=32)
    trainer = Trainer(pcfg, data, toks, device="cpu")
    from fedrec_tpu_torch.agg.worker import run_async_worker

    t0 = time.monotonic()
    with pytest.raises(AuthorityUnreachable):
        run_async_worker(trainer, f"127.0.0.1:{dead}", "w")
    assert time.monotonic() - t0 < 1.0 + 0.5


def _push_retries() -> float:
    """The worker's retried pushes so far (``wire.retries_total``, op push)."""
    rows = get_registry().snapshot()["metrics"].get("wire.retries_total", {"values": []})
    return sum(r["value"] for r in rows["values"] if r["labels"].get("op") == "push")


def test_cli_worker_rides_an_authority_restart(tmp_path, capsys):
    """The run CLI's worker through a ChaosProxy (a dup window) keeps
    training while its authority is down (a push fails and parks), re-hellos
    on the new incarnation and resyncs; every push it saw acked has a
    disposition or is pending at the restored authority."""
    import json

    state = tmp_path / "state"
    policy = pcommit.CommitPolicy(quorum=1, staleness_cap=8)
    srv = pserver.AggServer(policy=policy, world=1, state_dir=str(state)).start()
    port = srv.port
    argv = [*_small_argv(5, "agg.worker_global_wait_s=1", "agg.worker_poll_s=0.02",
                         "agg.worker_connect_timeout_s=0.5", "agg.worker_rpc_attempts=2",
                         "agg.worker_backoff_ms=10", "agg.worker_unreachable_budget_s=30",
                         "chaos.enabled=1", "chaos.wire_faults=dup@0-600",
                         "chaos.wire_seed=3"),
            "--agg-server", f"127.0.0.1:{port}", "--worker-id", "w0",
            "--obs-dir", str(tmp_path / "obs")]
    out: dict = {}
    t = threading.Thread(target=lambda: out.setdefault("rc", run.main(argv)), daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    while srv.version < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    v_kill = srv.version
    srv.stop()
    # down until a push has failed over to the unacked list
    while _push_retries() < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    srv2 = pserver.AggServer(port=port, policy=policy, world=1, state_dir=str(state)).start()
    t.join(timeout=60)
    srv2.stop()
    assert not t.is_alive() and out["rc"] == 0
    assert 2 <= v_kill < 5
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[agg-worker w0] report ")]
    rep = json.loads(lines[-1].split(" report ", 1)[1])
    assert rep["rounds"] == list(range(5)) and rep["resyncs"] >= 1
    assert rep["wire_faults_injected"]["dup"] >= 1 and rep["undelivered"] == 0
    st = srv2.status()
    assert st["incarnation"] == 2 and st["version"] >= v_kill and st["push_dups"] >= 1
    accounted = set(st["ledger"]) | set(st["pending_push_ids"])
    assert set(rep["acked"]) <= accounted
    assert not set(st["ledger"]) & set(st["pending_push_ids"])
    assert (tmp_path / "obs" / "worker_w0" / "metrics.jsonl").exists()
