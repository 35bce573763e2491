"""The port stands alone: ``fedrec_tpu_torch``, ``chip_smoke.py`` and
``kernel_ab.py`` import nothing of JAX, Flax or the JAX package; entry
points run on the GPU unless the caller asks for the CPU; CPU tensors never
count a launch."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fedrec_tpu_torch
from fedrec_tpu_torch.config import ExperimentConfig, ModelConfig
from fedrec_tpu_torch.data import make_synthetic_mind
from fedrec_tpu_torch.device import NoGPUError
from fedrec_tpu_torch.models import (
    DistilBert,
    DistilBertConfig,
    NewsRecommender,
    TextEncoder,
    precompute_token_states,
)
from fedrec_tpu_torch.ops import (
    UserTowerWeights,
    additive_pool,
    fused_history_score,
    launch_counts,
    reset_launch_counts,
)
from fedrec_tpu_torch.params import init_params
from fedrec_tpu_torch.serve import build_recommend_fn
from fedrec_tpu_torch.serving import (
    EmbeddingStore,
    ServingService,
    build_index,
    build_two_stage_fn,
    kmeans,
    restore_model,
)
from fedrec_tpu_torch.train import Trainer, build_eval_step, build_full_eval_step
from fedrec_tpu_torch.train.step import encode_all_news, encode_corpus_tokens

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(fedrec_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fedrec_tpu")


def _modules():
    return sorted(
        ".".join(("fedrec_tpu_torch", *p.relative_to(PKG).with_suffix("").parts)).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_importing_every_module_leaves_jax_out():
    # the cohort engine's, the data path's, the real-data path's, the native
    # batcher's, the observability artifacts', the coordinator deployment's,
    # elastic membership's, the async commit's, the async wire's, fleet
    # observability's and sequence parallelism's modules are among them
    assert {"fedrec_tpu_torch.comms", "fedrec_tpu_torch.comms.codecs",
            "fedrec_tpu_torch.agg", "fedrec_tpu_torch.agg.hierarchy",
            "fedrec_tpu_torch.agg.buffer", "fedrec_tpu_torch.agg.commit",
            "fedrec_tpu_torch.agg.server", "fedrec_tpu_torch.agg.worker",
            "fedrec_tpu_torch.parallel.rpc", "fedrec_tpu_torch.fed.chaos",
            "fedrec_tpu_torch.cli.run",
            "fedrec_tpu_torch.parallel.membership", "fedrec_tpu_torch.obs.fleet",
            "fedrec_tpu_torch.parallel.multihost", "fedrec_tpu_torch.cli.coordinator",
            "fedrec_tpu_torch.utils.pytree",
            "fedrec_tpu_torch.fed.sampling", "fedrec_tpu_torch.fed.population",
            "fedrec_tpu_torch.data.prefetch", "fedrec_tpu_torch.data.tokenizer",
            "fedrec_tpu_torch.data.preprocess", "fedrec_tpu_torch.data.adressa",
            "fedrec_tpu_torch.models.bert", "fedrec_tpu_torch.data.native_batcher",
            "fedrec_tpu_torch.obs.report", "fedrec_tpu_torch.obs.perf",
            "fedrec_tpu_torch.obs.device", "fedrec_tpu_torch.cli.obs",
            "fedrec_tpu_torch.obs.wire", "fedrec_tpu_torch.obs.alerts",
            "fedrec_tpu_torch.obs.watch", "fedrec_tpu_torch.utils.logging",
            "fedrec_tpu_torch.parallel.ring", "fedrec_tpu_torch.parallel.mesh"} <= set(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", ["package", "chip_smoke.py", "kernel_ab.py"])
def test_no_jax_import_anywhere_in_the_source(path):
    files = sorted(PKG.rglob("*.py")) if path == "package" else [ROOT / path]
    found = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            found += [f"{f.name}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert not found


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_model():
    cfg = ModelConfig(news_dim=8, num_heads=2, head_dim=4, query_dim=4, bert_hidden=8,
                      fuse_hot_path=True, use_pallas=True)
    return init_params(NewsRecommender(cfg), seed=1).eval()


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(no_gpu):
    model = _tiny_model()
    toks = torch.randn((3, 5, 8))
    store = EmbeddingStore()
    store.publish(torch.randn((6, 8)), model.user_encoder)
    cfg = ExperimentConfig().apply_overrides([
        "model.text_encoder_mode=head", "model.news_dim=8", "model.num_heads=2",
        "model.head_dim=4", "model.query_dim=4", "model.bert_hidden=8", "data.max_his_len=4",
        "data.max_title_len=5", "data.batch_size=2", "fed.num_clients=2", "train.snapshot_dir=",
    ])
    data = make_synthetic_mind(num_news=6, num_train=4, num_valid=2, title_len=5,
                               his_len_range=(1, 4))
    tiny_trunk = DistilBertConfig(vocab_size=11, dim=8, n_layers=1, n_heads=2, hidden_dim=16)
    trunk = DistilBert(tiny_trunk)
    encoder = TextEncoder(tiny_trunk, news_dim=4)
    calls = [
        lambda **kw: encode_all_news(model, toks, **kw),
        lambda **kw: build_recommend_fn(**kw),
        lambda **kw: ServingService(store, history_len=4, **kw),
        lambda **kw: Trainer(cfg, data, np.zeros((6, 5, 8), np.float32), **kw),
        lambda **kw: build_eval_step(cfg, **kw),
        lambda **kw: build_full_eval_step(**kw),
        lambda **kw: kmeans(torch.randn((9, 8)), 3, **kw),
        lambda **kw: build_index(torch.randn((9, 8)), num_clusters=3, exact_threshold=4, **kw),
        lambda **kw: build_two_stage_fn(build_index(torch.randn((9, 8))), **kw),
        lambda **kw: restore_model(
            model.cfg, dict(model.user_encoder.named_parameters()),
            dict(model.text_head.named_parameters()), **kw),
        lambda **kw: precompute_token_states(trunk, np.zeros((2, 2, 5), np.int64), trunk.cfg,
                                             **kw),
        lambda **kw: encode_corpus_tokens(encoder, np.zeros((2, 2, 5), np.int64), **kw),
    ]
    for call in calls:
        with pytest.raises(NoGPUError):
            call()
        with pytest.raises(NoGPUError):
            call(device="cuda")
        call(device="cpu")


def test_cli_serve_refuses_without_a_gpu(no_gpu):
    from fedrec_tpu_torch.cli import serve

    args = serve.build_parser().parse_args(["--synthetic", "16"])
    with pytest.raises(NoGPUError):
        serve.synthetic_service(args, ExperimentConfig())


def test_cpu_tensors_count_no_launch(rng):
    reset_launch_counts()
    x = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    additive_pool(x, torch.randn(8, 4), torch.zeros(4), torch.randn(4))
    w = UserTowerWeights(*(torch.randn(s) for s in [(8, 8), (8,)] * 3 + [(8, 4), (4,), (4,)]))
    fused_history_score(x, x[:, :2], None, w, 2)
    model = _tiny_model()
    table = encode_all_news(model, torch.randn((5, 5, 8)), device="cpu")
    build_recommend_fn(device="cpu")(model.user_encoder, table, torch.tensor([[1, 2, 0]]))
    assert set(launch_counts().values()) == {0} and len(launch_counts()) == 9


def test_overrides_set_the_slice_and_reject_unknown_keys():
    cfg = ExperimentConfig().apply_overrides(["model.fuse_hot_path=true", "model.use_pallas=1"])
    assert cfg.model.fuse_hot_path and cfg.model.use_pallas
    assert (cfg.model.news_dim, cfg.model.num_heads, cfg.data.max_his_len) == (400, 20, 50)
    with pytest.raises(KeyError):
        ExperimentConfig().apply_overrides(["model.nope=1"])
    # the round loop's fields, with the JAX package's defaults
    train, fed = ExperimentConfig().train, ExperimentConfig().fed
    assert (train.save_every, train.snapshot_dir, train.resume, train.eval_every,
            train.eval_protocol, train.keep_best, train.seed) == (
        1, "snapshots", True, 1, "full", False, 42)
    assert (fed.rounds, fed.local_epochs, fed.participation) == (10, 1, 1.0)
    cfg = ExperimentConfig().apply_overrides([
        "train.save_every=2", "train.snapshot_dir=/tmp/x", "train.resume=0",
        "train.eval_every=3", "train.eval_protocol=last4", "train.keep_best=1", "train.seed=7",
        "fed.rounds=4", "fed.local_epochs=2", "fed.participation=0.5",
    ])
    assert (cfg.train.save_every, cfg.train.snapshot_dir, cfg.train.resume,
            cfg.train.eval_every, cfg.train.eval_protocol, cfg.train.keep_best,
            cfg.train.seed) == (2, "/tmp/x", False, 3, "last4", True, 7)
    assert (cfg.fed.rounds, cfg.fed.local_epochs, cfg.fed.participation) == (4, 2, 0.5)
    for unported in ("train.scan_steps=2", "train.rounds_per_scan=2", "train.profile=1",
                     "fed.mesh_axis=hosts", "fed.seq_axis=sp"):
        with pytest.raises(KeyError):
            ExperimentConfig().apply_overrides([unported])
    # the auto codec's warm-up and the seq world's fields, the JAX defaults
    fed = ExperimentConfig().apply_overrides(["fed.dcn_auto_warmup=2", "fed.seq_impl=ulysses",
                                              "fed.seq_shards=4"]).fed
    assert (fed.dcn_auto_warmup, fed.seq_impl, fed.seq_shards) == (2, "ulysses", 4)
    assert (ExperimentConfig().fed.dcn_auto_warmup, ExperimentConfig().fed.seq_impl) == (1, "ring")
    # the coordinator deployment's and the codecs' fields, the JAX defaults
    fed, agg = ExperimentConfig().fed, ExperimentConfig().agg
    assert (fed.weight_by_samples, fed.dcn_compress, fed.dcn_topk_ratio, fed.dcn_sketch_width,
            fed.dcn_sketch_seed, fed.dcn_error_feedback) == (False, "none", 0.01, 0.1, 0, True)
    assert (agg.mode, agg.quorum, agg.staleness_cap, agg.tree_fanout) == ("flat", 0, 2, 2)
    # the async worker's wire policy, the JAX defaults
    assert (agg.worker_timeout_s, agg.worker_connect_timeout_s, agg.worker_poll_s,
            agg.worker_global_wait_s, agg.worker_rpc_attempts, agg.worker_backoff_ms,
            agg.worker_backoff_cap_ms, agg.worker_unreachable_budget_s) == (
        60.0, 5.0, 0.2, 20.0, 4, 50.0, 2000.0, 120.0)
    cfg = ExperimentConfig().apply_overrides(["agg.worker_rpc_attempts=2",
                                              "agg.worker_global_wait_s=1.5"])
    assert (cfg.agg.worker_rpc_attempts, cfg.agg.worker_global_wait_s) == (2, 1.5)
    cfg = ExperimentConfig().apply_overrides(["fed.weight_by_samples=1", "fed.dcn_compress=int8",
                                              "agg.mode=hierarchical", "agg.tree_fanout=3"])
    assert (cfg.fed.weight_by_samples, cfg.fed.dcn_compress, cfg.agg.mode,
            cfg.agg.tree_fanout) == (True, "int8", "hierarchical", 3)
    with pytest.raises(ValueError):
        ExperimentConfig().apply_overrides(["model.fuse_hot_path=maybe"])


def test_train_step_needs_a_gpu_unless_asked_and_refuses_unported_levers(no_gpu):
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.train import build_fed_train_step

    cfg = ExperimentConfig().apply_overrides(["model.text_encoder_mode=head"])
    model = _tiny_model()
    with pytest.raises(NoGPUError):
        build_fed_train_step(model, cfg, get_strategy("param_avg"))
    build_fed_train_step(model, cfg, get_strategy("param_avg"), device="cpu")
    for lever in ("shard.table=1", "shard.fsdp=2"):
        bad = ExperimentConfig().apply_overrides(["model.text_encoder_mode=head",
                                                  *lever.split(",")])
        name = lever.split(",")[-1].split("=")[0]
        with pytest.raises(NotImplementedError, match=name.split(".")[-1]):
            build_fed_train_step(model, bad, get_strategy("param_avg"), device="cpu")
    # sequence parallelism is ported: a seq step wants its world (the run CLI
    # starts one), and "auto" builds (the trainer pins its map)
    seq = ExperimentConfig().apply_overrides(["model.text_encoder_mode=head",
                                              "fed.seq_shards=2", "model.fuse_hot_path=0"])
    with pytest.raises(ValueError, match="fed.seq_shards=2 but the step has none"):
        build_fed_train_step(init_params(NewsRecommender(seq.model), seed=1), seq,
                             get_strategy("param_avg"), device="cpu")
    auto = ExperimentConfig().apply_overrides(["model.text_encoder_mode=head",
                                               "fed.dcn_compress=auto"])
    build_fed_train_step(model, auto, get_strategy("param_avg"), device="cpu")
    # fleet observability is ported (the trainer's pusher, watch and wire
    # envelope): the step ignores its keys
    obs = ExperimentConfig().apply_overrides([
        "model.text_encoder_mode=head", "obs.fleet.collector=localhost:1",
        "obs.watch.flap_max=9", "obs.slo.enabled=1", "obs.wire.window=64"])
    build_fed_train_step(model, obs, get_strategy("param_avg"), device="cpu")
    # the wire faults are ported (the run CLI's ChaosProxy): the step ignores them
    wire = ExperimentConfig().apply_overrides(["model.text_encoder_mode=head", "chaos.enabled=1",
                                               "chaos.wire_seed=2",
                                               "chaos.wire_faults=tear@1-2"])
    build_fed_train_step(model, wire, get_strategy("param_avg"), device="cpu")


def test_elastic_membership_is_refused_by_name(no_gpu):
    """``fed.elastic`` has the JAX package's fields and builds a train step;
    the coordinator refuses ``fed.elastic.enabled`` without a membership
    service, with the JAX coordinator's words."""
    from fedrec_tpu_torch.cli.coordinator import main
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.train import build_fed_train_step

    cfg = ExperimentConfig().apply_overrides(["model.text_encoder_mode=head",
                                              "fed.elastic.enabled=1"])
    build_fed_train_step(_tiny_model(), cfg, get_strategy("param_avg"), device="cpu")
    with pytest.raises(ValueError, match="no membership service was given"):
        main(["1", "8", "1", "--synthetic", "--device", "cpu", "--set", "train.snapshot_dir=",
              "--set", "fed.elastic.enabled=1"])
