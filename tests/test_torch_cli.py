"""The port's run CLI (``python -m fedrec_tpu_torch.cli.run``) against the JAX
package's (``fedrec_tpu.cli.run``): for the same argv, both CLIs hand their
``Trainer`` the same configuration, data and token states (each ``Trainer``
stubbed; nothing trains), and the port's runs a tiny decoupled run on the
CPU to its ``final:`` line. Data: tiny reference-layout artifacts the test
writes, or ``--synthetic``."""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

import fedrec_tpu.train.trainer as jax_trainer_module
import fedrec_tpu_torch.train.trainer as trainer_module
from fedrec_tpu.cli import run as jax_run
from fedrec_tpu_torch.cli import run
from fedrec_tpu_torch.data import make_synthetic_mind
from fedrec_tpu_torch.device import NoGPUError

_SMALL = ["--set", "model.news_dim=32", "--set", "model.num_heads=4", "--set",
          "model.head_dim=8", "--set", "model.query_dim=16", "--set", "model.bert_hidden=48",
          "--set", "data.max_his_len=10", "--set", "data.max_title_len=12"]
# every field the port's config shares with the JAX config holds the same value
_DIFFER_BY_DESIGN: set[str] = set()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("UserData")
    data = make_synthetic_mind(num_news=40, num_train=48, num_valid=8, title_len=6,
                               his_len_range=(1, 10), seed=1)
    np.save(d / "bert_news_index.npy", data.news_tokens)
    for name, obj in (("bert_nid2index.pkl", data.nid2index),
                      ("train_sam_uid.pkl", data.train_samples),
                      ("valid_sam_uid.pkl", data.valid_samples)):
        with open(d / name, "wb") as f:
            pickle.dump(obj, f)
    return d


def _stub(sink: dict, key: str):
    class Stub:
        def __init__(self, cfg, data, token_states, **kw):
            sink[key] = (cfg, data, token_states)

        def run(self):
            return []

    return Stub


def _assert_same_config(port, ref, path: str = "") -> None:
    """Every field of the port's config equals the JAX config's field of
    the same name."""
    for f in dataclasses.fields(port):
        where = f"{path}.{f.name}" if path else f.name
        mine, theirs = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(mine):
            _assert_same_config(mine, theirs, where)
        elif where not in _DIFFER_BY_DESIGN:
            assert mine == theirs, f"{where}: port {mine!r}, JAX {theirs!r}"


@pytest.mark.parametrize("extra", [
    [],
    ["--mode", "joint", "--clients", "4"],
    ["--dp-epsilon", "8", "--clients", "4"],
    ["--local-epochs", "2", "--participation", "0.5", "--clients", "2"],
    ["--strategy", "coordinator", "--clients", "4"],
    ["--synthetic", "--synthetic-news", "64", "--synthetic-train", "96", "--clients", "3",
     "--set", "fed.rounds=5", "--set", "data.npratio=3", *_SMALL],
    ["--mode", "joint", "--dp-epsilon", "10", "--clients", "4"],
], ids=["default", "joint", "dp_epsilon", "epochs_participation", "coordinator", "set",
        "joint_dpsgd"])
def test_cli_hands_its_trainer_what_the_jax_cli_hands_its_own(monkeypatch, capsys, artifacts,
                                                             extra):
    got: dict = {}
    monkeypatch.setattr(jax_trainer_module, "Trainer", _stub(got, "jax"))
    monkeypatch.setattr(trainer_module, "Trainer", _stub(got, "port"))
    argv = ["2", "8", "1", "--data-dir", str(artifacts), *extra]
    assert jax_run.main(argv) == 0
    assert run.main([*argv, "--device", "cpu"]) == 0
    (pcfg, pdata, ptoks), (jcfg, jdata, jtoks) = got["port"], got["jax"]
    if "--clients" not in extra:  # the device count: JAX's fake CPU mesh, one CPU here
        assert (pcfg.fed.num_clients, jcfg.fed.num_clients) == (1, len(jax.local_devices()))
        pcfg.fed.num_clients = jcfg.fed.num_clients
    _assert_same_config(pcfg, jcfg)
    np.testing.assert_array_equal(pdata.news_tokens, jdata.news_tokens)
    assert pdata.nid2index == jdata.nid2index
    assert pdata.train_samples == jdata.train_samples
    assert pdata.valid_samples == jdata.valid_samples
    assert ptoks.dtype == jtoks.dtype and np.array_equal(ptoks, jtoks)
    if "--dp-epsilon" in extra:
        mechanism = "dpsgd" if "joint" in extra else "ldp_news"
        assert pcfg.privacy.enabled and pcfg.privacy.mechanism == mechanism
        assert pcfg.privacy.sigma > 0
    assert "final:" not in capsys.readouterr().out  # the stubs ran no round


def test_cli_runs_a_decoupled_run_on_the_cpu(tmp_path, capsys):
    argv = ["2", "8", "1", "--synthetic", "--synthetic-news", "64", "--synthetic-train", "64",
            "--clients", "2", "--device", "cpu", "--dp-epsilon", "8", *_SMALL,
            "--set", f"train.snapshot_dir={tmp_path}"]
    assert run.main(argv) == 0
    out = capsys.readouterr().out
    final = [ln for ln in out.splitlines() if ln.startswith("final: ")]
    assert len(final) == 1, out
    fields = dict(kv.split("=") for kv in final[0].removeprefix("final: ").split())
    assert np.isfinite(float(fields["loss"])) and 0.0 <= float(fields["auc"]) <= 1.0
    assert sorted(p.name for p in tmp_path.glob("round_*")) == ["round_0", "round_1"]


def test_cli_pushes_fleet_telemetry_to_a_collector(tmp_path, capsys):
    """``obs.fleet.collector``: a run pushes a registry snapshot and its new
    spans every round and once more at its end, as worker "0" (the
    trainer's identity), into the collector's ``worker_*`` layout."""
    from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, set_registry, set_tracer
    from fedrec_tpu_torch.obs.fleet import (
        CollectorServer,
        TelemetryCollector,
        load_fleet_dir,
        reset_fleet_identity,
    )

    srv = CollectorServer(TelemetryCollector(tmp_path / "fleet")).start()
    prev = set_registry(MetricsRegistry()), set_tracer(Tracer())
    reset_fleet_identity()
    try:
        argv = ["2", "8", "1", "--synthetic", "--synthetic-news", "64", "--synthetic-train",
                "64", "--clients", "2", "--device", "cpu", "--mode", "joint", *_SMALL, "--set",
                "train.snapshot_dir=", "--set", f"obs.fleet.collector={srv.address}"]
        assert run.main(argv) == 0
        status = srv.collector.status()
    finally:
        srv.stop()
        set_registry(prev[0])
        set_tracer(prev[1])
        reset_fleet_identity()
    assert status["pushes"] == 3 and set(status["workers"]) == {"0"}
    w = load_fleet_dir(tmp_path / "fleet")["0"]
    rounds = [e["args"]["step_num"] for t in w.traces for e in t.events
              if e["name"] == "fed_round"]
    assert rounds == [0, 1] and w.snapshots[-1]["fleet"] == {"worker": "0", "rank": 0}


@pytest.mark.parametrize("argv,exc,match", [
    (["--mode", "joint", "--dp-epsilon", "8", "--set", "model.fuse_hot_path=1", "--device",
      "cpu"], NotImplementedError, "model.fuse_hot_path with privacy.mechanism='dpsgd'"),
    (["--agg-server", "localhost:1", "--worker-id", "w", "--device", "cpu", "--set",
      "chaos.wire_faults=tear@1-2"], ValueError, "wire fault injection requires chaos.enabled"),
    ([], NoGPUError, "no CUDA device"),
])
def test_cli_refuses_what_the_port_cannot_run(monkeypatch, artifacts, argv, exc, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(exc, match=match):
        run.main(["2", "8", "1", "--data-dir", str(artifacts), *argv])
