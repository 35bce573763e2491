"""The port's coordinator deployment (``python -m
fedrec_tpu_torch.cli.coordinator``) in spawned gloo worlds on the CPU, at
small widths, each worker on one thread.

(a) 3 processes (the server does not train), 2 rounds, shards of unequal
    size under ``fed.weight_by_samples``: the server's ``global_round_1``
    equals the in-process emulation (``cli.coordinator.emulate_world``: the
    two shards' ``Trainer``s here, reduced by the same
    ``aggregate_from_hosts`` over the same stacks), and it restores through
    ``load_checkpoint_params`` and the recommend CLI;
(b) ``int8`` + ``trimmed_mean`` with ``--server-trains``, and the mean
    under ``int8``, ``topk`` and ``countsketch``, against the emulation;
(c) ``chaos.kill_process`` / ``kill_round`` with ``--collective-timeout
    10``: the killed process exits 137, the server finishes alone and
    exits 0, the degraded client re-executes itself standalone and exits 0;
(d) ``chaos.torn_snapshot_round``, then a resume: every shard restarts
    fresh and the world finishes.

Bar: the trajectory bars (parameters rtol 2e-4 / atol 1e-4), though both
sides run the same code on one thread and agree to the bit here. Each world
takes a free port and runs under its own ``communicate(timeout=...)``.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fedrec_tpu_torch.cli import recommend
from fedrec_tpu_torch.cli.coordinator import (
    _build_parser,
    config_from_args,
    emulate_world,
    load_inputs,
    main,
)
from fedrec_tpu_torch.data import make_synthetic_mind
from fedrec_tpu_torch.device import NoGPUError
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.params import from_flax
from fedrec_tpu_torch.serving import load_checkpoint_params
from fedrec_tpu_torch.train import Trainer
from fedrec_tpu_torch.train.checkpoint import coordinator_globals, load_state_bytes

REPO = Path(__file__).resolve().parents[1]
_SMALL = ["model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
          "model.bert_hidden=48", "data.max_his_len=8", "data.max_title_len=6",
          "train.eval_every=1000", "model.fuse_hot_path=true", "model.use_pallas=true"]
_WORLD_TIMEOUT_S = 60
# a worker: one thread, then the CLI's main
_WORKER = ("import sys, torch; torch.set_num_threads(1); "
           "from fedrec_tpu_torch.cli.coordinator import main; sys.exit(main(sys.argv[1:]))")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def art(tmp_path_factory) -> Path:
    """A reference-layout artifact directory: 161 training rows (shards of 81
    and 80 over two clients), its token states beside them."""
    root = tmp_path_factory.mktemp("coordinator") / "UserData"
    root.mkdir()
    data = make_synthetic_mind(num_news=64, num_train=161, num_valid=16, title_len=6,
                               his_len_range=(2, 8), seed=3)
    np.save(root / "bert_news_index.npy", data.news_tokens)
    np.save(root / "token_states.npy",
            np.random.default_rng(4).standard_normal((64, 6, 48)).astype(np.float32))
    for name, obj in (("bert_nid2index.pkl", data.nid2index),
                      ("train_sam_uid.pkl", data.train_samples),
                      ("valid_sam_uid.pkl", data.valid_samples)):
        with open(root / name, "wb") as f:
            pickle.dump(obj, f)
    return root


def _argv(art: Path, snaps: Path, rounds: int, *extra: str) -> list[str]:
    sets = [x for kv in _SMALL for x in ("--set", kv)]
    return [str(rounds), "8", "1", "--data-dir", str(art), "--device", "cpu", "--clients", "2",
            "--mode", "joint", *sets, "--set", f"train.snapshot_dir={snaps}", *extra]


def _world(argv: list[str], n: int, cwd: Path, timeout_s: float = _WORLD_TIMEOUT_S):
    """``n`` worker processes of one world; ``(returncodes, outputs)``."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, *argv, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n), "--process-id", str(i)],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def _reports(out: str) -> list[dict]:
    return [json.loads(ln.split("[coordinator] report ", 1)[1]) for ln in out.splitlines()
            if ln.startswith("[coordinator] report ")]


def _emulate(argv: list[str], procs: int, server_trains: bool, rounds: int):
    """The world's rounds in this process, on one thread: one Trainer a
    training process on its shard."""
    args = _build_parser().parse_args(argv)
    dev = torch.device("cpu")
    cfg = config_from_args(args, dev)
    cfg.train.snapshot_dir = ""
    shards = procs if server_trains else procs - 1
    cfg.data.num_shards = shards
    data, toks = load_inputs(args, cfg)
    trainers = [] if server_trains else [None]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for i in range(shards):
            c = config_from_args(args, dev)
            c.train.snapshot_dir = ""
            c.data.num_shards, c.data.shard_index = shards, i
            trainers.append(Trainer(c, data, toks, device=dev))
        return emulate_world(trainers, cfg, range(rounds))[0]
    finally:
        torch.set_num_threads(threads)


def _assert_global_matches(path: Path, emulated, bitwise: bool = True) -> None:
    """The server's global file against an emulated Flax-layout global."""
    snap = load_state_bytes(path.read_bytes())
    cfg = config_from_args(_build_parser().parse_args(_argv(Path("."), Path("."), 1)),
                           torch.device("cpu"))
    model = NewsRecommender(cfg.model)
    from_flax(model.user_encoder, emulated[0])
    from_flax(model.news_tower, emulated[1])
    for part, module in (("user_params", model.user_encoder),
                         ("news_params", model.news_tower)):
        for name, p in module.named_parameters():
            got = snap[part][name].numpy()
            np.testing.assert_allclose(got, p.detach().numpy(), rtol=2e-4, atol=1e-4,
                                       err_msg=f"{part}.{name}")
            if bitwise:
                np.testing.assert_array_equal(got, p.detach().numpy(), err_msg=f"{part}.{name}")


def test_reference_world_matches_emulation_and_serves(art, tmp_path):
    snaps = tmp_path / "snaps"
    argv = _argv(art, snaps, 2, "--set", "fed.weight_by_samples=1")
    rcs, outs = _world(argv, 3, tmp_path)
    assert rcs == [0, 0, 0], outs
    reports = [_reports(o)[-1] for o in outs]
    assert [r["trains"] for r in reports] == [False, True, True]
    assert sorted(r["num_local_samples"] for r in reports[1:]) == [80, 81]
    assert not any(r["degraded"] for r in reports)
    # dense wire: every process ships the dense tree up and receives it down
    # each round (2 rounds), all the same size
    assert len({r["bytes_up"] for r in reports}) == 1 and reports[0]["bytes_up"] > 0
    assert reports[0]["bytes_up"] == reports[0]["bytes_down"]
    assert [p.name for p in coordinator_globals(snaps)] == ["global_round_0.pt",
                                                           "global_round_1.pt"]
    emulated = _emulate(argv, 3, server_trains=False, rounds=2)
    _assert_global_matches(snaps / "global_round_1.pt", emulated[-1])
    # served: the newest global, then the recommend CLI with config.json's settings
    user, news, round_, kind = load_checkpoint_params(snaps)
    assert (round_, kind) == (1, "coordinator")
    assert set(user) == {k for k, _ in NewsRecommender(
        config_from_args(_build_parser().parse_args(argv), torch.device("cpu")).model
    ).user_encoder.named_parameters()}
    out = tmp_path / "recs.jsonl"
    assert recommend.main(["--data-dir", str(art), "--snapshot-dir", str(snaps), "--device",
                           "cpu", "--top-k", "5", "--out", str(out)]) == 0
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert lines and all(len(ln["news"]) == 5 and np.isfinite(ln["scores"]).all()
                         for ln in lines)


@pytest.mark.parametrize("codec,sets,server_trains", [
    ("int8", ["fed.robust.method=trimmed_mean", "fed.robust.trim_k=1"], True),
    ("int8", [], False),
    ("topk", ["fed.dcn_topk_ratio=0.05"], False),
    ("countsketch", [], False),
], ids=["int8_trimmed_mean_server_trains", "int8_mean", "topk_mean", "countsketch_mean"])
def test_codec_world_matches_emulation(art, tmp_path, codec, sets, server_trains):
    """The codecs over the real wire (payloads packed into byte tensors and
    gathered): ``int8`` + ``trimmed_mean`` with a training server, then the
    mean of each kind of payload (a scale, an index list, a summed sketch)."""
    snaps = tmp_path / "snaps"
    argv = _argv(art, snaps, 2, "--set", f"fed.dcn_compress={codec}",
                 *[x for kv in sets for x in ("--set", kv)])
    rcs, outs = _world([*argv, *(["--server-trains"] if server_trains else [])], 3, tmp_path)
    assert rcs == [0, 0, 0], outs
    reports = [_reports(o)[-1] for o in outs]
    assert not any(r["degraded"] for r in reports)
    assert [r["trains"] for r in reports] == [server_trains, True, True]
    # every process ships the same encoded bytes, fewer than the dense tree's
    assert len({r["bytes_up"] for r in reports}) == 1
    assert reports[0]["bytes_up"] < reports[0]["bytes_down"]
    if codec == "topk":
        assert sorted(p.name for p in snaps.glob("codec_state_p*.npz")) == [
            f"codec_state_p{i}.npz" for i in range(3)]
    emulated = _emulate(argv, 3, server_trains=server_trains, rounds=2)
    _assert_global_matches(snaps / "global_round_1.pt", emulated[-1])


def test_killed_process_degrades_the_survivors_bounded(art, tmp_path):
    snaps = tmp_path / "snaps"
    argv = _argv(art, snaps, 3, "--collective-timeout", "10", "--set", "chaos.enabled=1",
                 "--set", "chaos.kill_process=2", "--set", "chaos.kill_round=1")
    rcs, outs = _world(argv, 3, tmp_path)
    assert rcs == [0, 0, 137], outs
    assert "dying at round 1" in outs[2]
    # the server finished its rounds alone and says so
    assert "degrading to standalone" in outs[0] and "degraded after 3 rounds" in outs[0]
    server = _reports(outs[0])[-1]
    assert server["degraded"] and server["deadline_misses"] >= 1
    # the client left the world and its standalone continuation finished
    assert "respawning standalone, resuming from local_state_p1.pt" in outs[1]
    first, cont = _reports(outs[1])
    assert first["degraded"] and not first["standalone"]
    assert cont["standalone"] and cont["rounds"] == [1, 2] and cont["process"] == 1
    assert (snaps / "chaos_killed_p2").read_text() == "1"


def test_torn_local_snapshot_restarts_the_shard_fresh(art, tmp_path):
    snaps = tmp_path / "snaps"
    argv = _argv(art, snaps, 1, "--set", "chaos.enabled=1", "--set",
                 "chaos.torn_snapshot_round=0")
    rcs, outs = _world(argv, 3, tmp_path)
    assert rcs == [0, 0, 0], outs
    assert all("tore its local snapshot at round 0" in o for o in outs)
    rcs, outs = _world(_argv(art, snaps, 2), 3, tmp_path)
    assert rcs == [0, 0, 0], outs
    assert all("is corrupt/torn" in o and "starting this shard fresh" in o for o in outs)
    assert [r["rounds"] for r in (_reports(o)[-1] for o in outs)] == [[0, 1]] * 3
    assert global_round_exists(snaps, 1)


def global_round_exists(snaps: Path, r: int) -> bool:
    return (snaps / f"global_round_{r}.pt").exists()


def test_refusals_and_the_device(art, tmp_path, monkeypatch, capsys):
    base = _argv(art, tmp_path / "s", 1)
    monkeypatch.delenv("FEDREC_SUPERVISED", raising=False)
    # the membership refusals the JAX coordinator keeps: no identity, no supervisor
    for extra, match in ((["--membership", "h:1"], "requires --process-id"),
                         (["--membership", "h:1", "--process-id", "1"], "requires --supervise")):
        with pytest.raises(SystemExit):
            main([*base, *extra])
        assert match in capsys.readouterr().err
    for extra, err, match in ((["--set", "fed.dcn_compress=auto"], ValueError, "warmup"),
                              (["--set", "fed.dcn_compress=countsketch", "--set",
                                "fed.robust.method=median"], ValueError,
                               "per-contribution decode"),
                              (["--agg-server", "h:1"], ValueError,
                               "start a worker of the async deployment")):
        with pytest.raises(err, match=match):
            main([*base, *extra])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoGPUError):
        main([a for a in base if a not in ("--device", "cpu")])
