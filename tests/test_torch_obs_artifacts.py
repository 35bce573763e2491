"""The port's observability artifacts (CPU): a ``Trainer`` with ``obs.dir``
writes ``metrics.jsonl``, ``trace.json`` and ``prometheus.txt``; the JAX
package's host-only ``build_report`` reads them and agrees with the port's
own; the quality monitor, the slice definitions, the registry's exposition,
the FLOPs model and the roofline verdicts equal the JAX package's on the
same inputs; a ``nan`` chaos run dumps the flight recorder and ``fedrec-obs
replay --device cpu`` reproduces the trigger; the ``prom``, ``quality`` and
``perf`` subcommands; the serve CLI's ``prometheus`` and ``alerts`` admin
commands and its ``--obs-dir`` artifacts.

Tolerances: none. The monitors, the report and the exposition are the same
float64 host arithmetic on the same numbers in the same order, compared
exactly (``==``).
"""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fedrec_tpu.config import ExperimentConfig as JaxExperimentConfig
from fedrec_tpu.data import index_samples as jax_index_samples
from fedrec_tpu.obs import perf as jax_perf
from fedrec_tpu.obs import quality as jax_quality
from fedrec_tpu.obs.registry import MetricsRegistry as JaxRegistry
from fedrec_tpu.obs.registry import snapshot_to_prometheus as jax_snapshot_to_prometheus
from fedrec_tpu.obs.report import build_report as jax_build_report
from fedrec_tpu.obs.report import load_jsonl as jax_load_jsonl
from fedrec_tpu.obs.report import load_trace as jax_load_trace
from fedrec_tpu_torch.cli import obs as obs_cli
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.data import index_samples, make_synthetic_mind
from fedrec_tpu_torch.eval.metrics import quality_stats_batch
from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, TrainingHealthError, set_registry
from fedrec_tpu_torch.obs import perf, quality, set_tracer
from fedrec_tpu_torch.obs.device import BuildWatch, sample_device_memory
from fedrec_tpu_torch.obs.registry import snapshot_to_prometheus
from fedrec_tpu_torch.obs.report import build_report, load_jsonl, load_trace, render_text
from fedrec_tpu_torch.serving import serve_forever
from fedrec_tpu_torch.train import Trainer

_SMALL = ["model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
          "model.bert_hidden=48", "data.max_his_len=8", "data.max_title_len=6",
          "data.batch_size=8", "model.text_encoder_mode=head", "train.snapshot_dir="]
_PORT_ONLY_KEYS = ("kernels",)


@pytest.fixture
def fresh_obs():
    """A fresh registry and tracer, so one test's instruments do not leak
    into another's artifacts."""
    prev_r, prev_t = set_registry(MetricsRegistry()), set_tracer(Tracer())
    yield
    set_registry(prev_r)
    set_tracer(prev_t)


def _data():
    data = make_synthetic_mind(num_news=100, num_train=64, num_valid=40, title_len=6,
                               his_len_range=(1, 8), seed=1)
    toks = np.random.default_rng(0).standard_normal((100, 6, 48)).astype(np.float32)
    return data, toks


def _run(obs_dir: Path, *over: str):
    cfg = ExperimentConfig().apply_overrides([
        *_SMALL, "fed.num_clients=2", "fed.rounds=2", "model.user_tower=gru",
        "model.text_head_arch=cnn", "model.use_pallas=1", f"obs.dir={obs_dir}",
        "obs.quality.enabled=1", "obs.perf.enabled=1", "obs.perf.capture_rounds=1", *over])
    data, toks = _data()
    trainer = Trainer(cfg, data, toks, device="cpu")
    return trainer, trainer.run()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    prev_r, prev_t = set_registry(MetricsRegistry()), set_tracer(Tracer())
    try:
        _run(d)
    finally:
        set_registry(prev_r)
        set_tracer(prev_t)
    return d


def test_trainer_with_obs_dir_writes_the_artifacts(run_dir):
    assert {"metrics.jsonl", "trace.json", "prometheus.txt"} <= {p.name for p in run_dir.iterdir()}
    records, snaps = load_jsonl(run_dir / "metrics.jsonl")
    rounds = [r for r in records if "training_loss" in r]
    assert [r["round"] for r in rounds] == [0.0, 1.0]
    assert all("val_auc" in r and "perf.samples_per_sec" in r for r in rounds)
    # one snapshot a round (obs.snapshot_every=1) and the final one
    assert len(snaps) == 3 and all(s["kind"] == "registry_snapshot" for s in snaps)
    capture = [r for r in records if r.get("kind") == "perf_capture"]
    assert len(capture) == 1 and capture[0]["round"] == 1
    assert (Path(capture[0]["logdir"]) / "trace.json").exists()
    events = load_trace(run_dir / "trace.json")
    names = {e["name"] for e in events}
    assert {"fed_round", "batch_build", "h2d", "dispatch", "aggregate", "eval"} <= names
    assert [e["args"]["step_num"] for e in events if e["name"] == "fed_round"] == [0, 1]
    prom = (run_dir / "prometheus.txt").read_text()
    assert "# TYPE train_rounds_total counter" in prom
    assert "\nperf_mfu " not in prom  # the CPU is not in the peak table: no value
    assert 'eval_auc{slice="all"}' in prom


def test_jax_build_report_reads_the_ports_artifacts(run_dir):
    records, snaps = jax_load_jsonl(run_dir / "metrics.jsonl")
    events = jax_load_trace(run_dir / "trace.json")
    theirs = jax_build_report(records, snaps, events)
    p_records, p_snaps = load_jsonl(run_dir / "metrics.jsonl")
    ours = build_report(p_records, p_snaps, load_trace(run_dir / "trace.json"))
    assert {k: v for k, v in ours.items() if k not in _PORT_ONLY_KEYS} == theirs
    for section in ("training", "quality", "perf", "spans"):
        assert section in theirs, section
    text = render_text(ours)
    # a run without obs.slo records no alert, so neither report has the panel
    assert "## Training" in text and "## Alerts" not in text and "alerts" not in theirs


def test_quality_monitor_equals_jax_on_the_same_sums():
    """Slice definitions from both packages' indexing of one validation
    set, the same per-impression metrics and the same score sums through
    both monitors: equal registry snapshots."""
    data = make_synthetic_mind(num_news=90, num_train=8, num_valid=60, title_len=6,
                               his_len_range=(0, 40), seed=4)
    jcfg, cfg = JaxExperimentConfig(), ExperimentConfig()
    jix = jax_index_samples(data.valid_samples, data.nid2index, 50)
    pix = index_samples(data.valid_samples, data.nid2index, 50)
    jdefs = jax_quality.build_slice_defs(jix, jcfg.obs.quality)
    pdefs = quality.build_slice_defs(pix, cfg.obs.quality)
    assert [(d.name, d.mask.tolist()) for d in jdefs] == [(d.name, d.mask.tolist())
                                                          for d in pdefs]
    rng = np.random.default_rng(0)
    n = len(pix)
    out = {k: rng.random(n) for k in ("auc", "mrr", "ndcg5", "ndcg10")}
    keep = (rng.random(n) > 0.1).astype(np.float32)
    pos = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    neg = torch.from_numpy(rng.standard_normal((n, 7)).astype(np.float32) * 3)
    neg_mask = torch.from_numpy((rng.random((n, 7)) > 0.2).astype(np.float32))
    q = cfg.obs.quality
    sums = {k: v.double().numpy() for k, v in quality_stats_batch(
        pos, neg, neg_mask, torch.from_numpy(keep), q.score_bins, q.score_range,
        q.ece_bins).items()}
    per_client = [{"auc": 0.61, "mrr": 0.3, "ndcg5": 0.3, "ndcg10": 0.35},
                  {"auc": 0.52, "mrr": 0.2, "ndcg5": 0.2, "ndcg10": 0.25},
                  {"auc": 0.60, "mrr": 0.3, "ndcg5": 0.3, "ndcg10": 0.33}]
    snaps = []
    for mod, defs, reg in ((jax_quality, jdefs, JaxRegistry()),
                           (quality, pdefs, MetricsRegistry())):
        acc = mod.SlicedEvalAccumulator(defs, n)
        for start in range(0, n, 16):
            acc.add(start, {k: v[start:start + 16] for k, v in out.items()}, keep[start:start + 16])
        slices, skipped = acc.finalize()
        mon = mod.QualityMonitor(cfg.obs.quality, registry=reg)
        mon.publish_slices(slices, skipped)
        mon.publish_corpus({k: float(v.mean()) for k, v in out.items()}, count=float(keep.sum()))
        mon.publish_distribution(sums)
        outliers = mon.digest_clients(3, per_client)
        snaps.append((reg.snapshot()["metrics"], outliers))
    assert snaps[0] == snaps[1]
    assert snaps[1][1] and snaps[1][1][0]["client"] == 1
    assert quality.reduce_quality_sums(sums, q.ece_bins) == jax_quality.reduce_quality_sums(
        sums, q.ece_bins)


def test_prometheus_exposition_equals_jax():
    reg = MetricsRegistry()
    reg.counter("a.b_total", "x", labels=("k",)).inc(3, k='q"1')
    reg.gauge("g", "y").set(0.25)
    h = reg.histogram("h.ms", "z", buckets=(1.0, 5.0))
    for v in (0.5, 2.0, 9.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snapshot_to_prometheus(snap) == jax_snapshot_to_prometheus(snap)
    assert reg.to_prometheus() == snapshot_to_prometheus(reg.snapshot())


def test_flops_model_peaks_and_verdicts():
    """The FLOPs model is the JAX package's; the peak table holds the H100
    rows only; the verdict strings are the JAX package's."""
    jcfg, cfg = JaxExperimentConfig(), ExperimentConfig()
    for b, cap in ((64, 0), (16, 700)):
        jcfg.data.unique_news_cap = cfg.data.unique_news_cap = cap
        assert perf.flops_per_train_step(cfg, b, 65536) == jax_perf.flops_per_train_step(
            jcfg, b, 65536)
    assert set(perf.CARD_PEAKS) == {"H100", "H100 PCIe"}
    assert perf.card_peaks("NVIDIA H100 80GB HBM3")[0] == "H100"
    assert perf.card_peaks("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    assert perf.card_peaks("cpu") is None and perf.peak_flops("cpu", "float32") is None
    assert perf.peak_flops("NVIDIA H100 80GB HBM3", "float32") == 67e12
    assert perf.ROOFLINE_VERDICTS == jax_perf.ROOFLINE_VERDICTS
    for args in ((True, None), (False, None), (False, 0.7), (False, 0.1), (True, 0.7)):
        assert perf.roofline_verdict(*args) == jax_perf.roofline_verdict(*args)
    assert perf.ROUND_PHASES == ("batch_build", "h2d", "dispatch", "aggregate", "eval")


def test_device_memory_and_build_watch_on_the_cpu(fresh_obs):
    reg = MetricsRegistry()
    assert sample_device_memory(reg, None, torch.device("cpu")) == 0
    assert reg.get("device.memory.bytes_in_use") is None
    watch = BuildWatch(reg)
    builds = watch.publish()
    assert watch.publish() == builds
    assert reg.get("kernel.builds_total") is not None


def _nan_run(obs_dir: Path):
    cfg = ExperimentConfig().apply_overrides([
        *_SMALL, "fed.num_clients=2", "fed.rounds=3", "model.user_tower=gru",
        "model.text_head_arch=cnn", f"obs.dir={obs_dir}", "chaos.enabled=1",
        "chaos.faults=nan@1:1"])
    data, toks = _data()
    with pytest.raises(TrainingHealthError, match="Forensics dumped to"):
        Trainer(cfg, data, toks, device="cpu").run()


def test_nan_chaos_run_dumps_and_replay_reproduces_the_trigger(tmp_path, fresh_obs, capsys):
    _nan_run(tmp_path)
    manifest = json.loads((tmp_path / "flightrec" / "manifest.json").read_text())
    assert manifest["kind"] == "flight_recorder_dump"
    assert manifest["trigger"]["kind"] == "nonfinite" and manifest["trigger"]["round"] == 1
    assert manifest["state_file"] == "state.pt" and manifest["table_file"] == "table.npy"
    assert manifest["chunk_start_round"] == 1 and manifest["ring_complete"]
    assert manifest["mode"] == "joint" and manifest["config"]["model"]["user_tower"] == "gru"
    # the artifacts are written on the failing exit too, the non-finite
    # values in the text format's spelling
    for name in ("trace.json", "metrics.jsonl", "prometheus.txt"):
        assert (tmp_path / name).exists(), name
    assert " NaN\n" in (tmp_path / "prometheus.txt").read_text()
    capsys.readouterr()
    assert obs_cli.main(["replay", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "REPRODUCED: non-finite step at round 1 step 0" in out
    assert obs_cli.main(["replay", str(tmp_path), "--device", "cpu", "--json"]) == 0
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["reproduced_nonfinite"] and verdict["device"] == "cpu"
    assert obs_cli.main(["replay", str(tmp_path / "nowhere")]) == 2


def test_prom_quality_and_perf_subcommands(run_dir, tmp_path, capsys, fresh_obs):
    capsys.readouterr()
    assert obs_cli.main(["prom", str(run_dir)]) == 0
    _, snaps = load_jsonl(run_dir / "metrics.jsonl")
    assert capsys.readouterr().out == snapshot_to_prometheus(snaps[-1])
    assert obs_cli.main(["quality", str(run_dir), "--json"]) == 0
    detail = json.loads(capsys.readouterr().out)
    assert "all" in detail["slices"] and "ece" in detail
    assert obs_cli.main(["perf", str(run_dir), "--json"]) == 0
    detail = json.loads(capsys.readouterr().out)
    assert detail["verdict_rounds"] == {"device": 2.0}
    assert set(detail["phases"]) >= {"batch_build", "dispatch", "eval"}
    assert len(detail["trend"]) == 2 and detail["capture_records"][0]["kind"] == "perf_capture"
    assert {"params", "optimizer", "news_table", "batch", "other"} <= set(detail["hbm_components"])
    assert obs_cli.main(["report", str(run_dir)]) == 0
    assert "# fedrec_tpu_torch run report" in capsys.readouterr().out
    # a run without the telemetry: exit 2, as the JAX verbs do
    _run(tmp_path, "obs.quality.enabled=0", "obs.perf.enabled=0", "obs.perf.capture_rounds=",
         "fed.rounds=1")
    assert obs_cli.main(["quality", str(tmp_path)]) == 2
    assert obs_cli.main(["perf", str(tmp_path)]) == 2
    assert obs_cli.main(["report", str(tmp_path / "missing")]) == 2


def test_serving_prometheus_alerts_and_obs_dir(tmp_path, fresh_obs):
    from fedrec_tpu_torch.cli import serve

    args = serve.build_parser().parse_args(
        ["--synthetic", "64", "--device", "cpu", "--set", "model.news_dim=32",
         "--set", "model.num_heads=4", "--set", "model.head_dim=8", "--set",
         "model.query_dim=16"])
    cfg = ExperimentConfig().apply_overrides(args.overrides)
    svc = serve.build_service(args, cfg)

    async def drive():
        task = asyncio.ensure_future(serve_forever(svc, port=0, metrics_every_s=0.05,
                                                   obs_dir=str(tmp_path)))
        for _ in range(200):
            await asyncio.sleep(0.05)
            log = tmp_path / "metrics.jsonl"
            if log.exists() and "registry_snapshot" in log.read_text():
                break
        replies = [await svc.handle({"cmd": "prometheus"}), await svc.handle({"cmd": "alerts"}),
                   await svc.handle({"id": 3, "history": [1, 2], "_wire": {"v": 1}})]
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return replies

    prom, alerts, wired = asyncio.run(asyncio.wait_for(drive(), 60))
    assert "# TYPE serve_p99_ms gauge" in prom["prometheus"]
    assert alerts == {"alerts": {"active": [], "recent": []}}
    # the service's handle() sees what the TCP layer hands it: the layer
    # strips the envelope first, so a request that still carries one scores
    assert wired["id"] == 3 and wired["ids"] and "error" not in wired
    assert {"metrics.jsonl", "trace.json", "prometheus.txt"} <= {p.name for p in tmp_path.iterdir()}
    records, snaps = load_jsonl(tmp_path / "metrics.jsonl")
    assert snaps and any("serve.p50_ms" in r for r in records)
