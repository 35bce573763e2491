"""Checkpoint serving in the port (CPU): ``load_checkpoint_params`` and
``publish_from_checkpoint`` on a port ``Trainer``'s snapshots, the JAX
package's snapshot formats refused by name, the ``{"cmd": "refresh"}``
hot-swap over TCP (a mid-stream swap, a failed refresh that keeps
serving), the pre-swap drift probe against JAX ``DriftProbe`` on the same
tables, and ``cli/serve.py``'s checkpoint service.

Bars: restored parameters and the published table bitwise equal to the
trainer's client 0 and to ``encode_all_news`` of it (the same code on the
same inputs); served ids equal to the exact scorer's on the refreshed
table; the probe's numbers equal JAX's to 1e-12 (both float64 numpy).
Every asyncio test runs under its own ``asyncio.wait_for``.
"""

import asyncio
import contextlib
import io
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrec_tpu.obs import MetricsRegistry as JaxMetricsRegistry
from fedrec_tpu.obs.quality import DriftProbe as JaxDriftProbe
from fedrec_tpu.serving import EmbeddingStore as JaxEmbeddingStore
from fedrec_tpu_torch.cli import serve as serve_cli
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.data import make_synthetic_mind
from fedrec_tpu_torch.device import NoGPUError
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.obs import DriftProbe, MetricsRegistry
from fedrec_tpu_torch.params import init_params
from fedrec_tpu_torch.serve import build_recommend_fn
from fedrec_tpu_torch.serving import (
    EmbeddingStore,
    ServingService,
    SnapshotFormatError,
    load_checkpoint_params,
    publish_from_checkpoint,
    start_server,
)
from fedrec_tpu_torch.train import Trainer, encode_all_news

_SMALL = ["model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
          "model.bert_hidden=48", "data.max_his_len=10", "data.max_title_len=6",
          "model.fuse_hot_path=true", "model.use_pallas=true"]
N = 60
_TIMEOUT_S = 60


def _cfg(*extra: str) -> ExperimentConfig:
    return ExperimentConfig().apply_overrides([*_SMALL, *extra])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-round decoupled run of 2 clients (the config's default mode),
    snapshotted every round, and the reference artifact layout of its data
    with its token states."""
    root = tmp_path_factory.mktemp("refresh")
    cfg = _cfg("fed.num_clients=2", "data.batch_size=8", "fed.rounds=2", "train.eval_every=100",
               f"train.snapshot_dir={root / 'snaps'}")
    data = make_synthetic_mind(num_news=N, num_train=32, num_valid=8, title_len=6,
                               his_len_range=(2, 10), seed=3)
    toks = np.random.default_rng(3).standard_normal((N, 6, 48)).astype(np.float32)
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(cfg, data, toks, device="cpu")
        trainer.run()
    art = root / "UserData"
    art.mkdir()
    np.save(art / "bert_news_index.npy", data.news_tokens)
    np.save(art / "token_states.npy", toks)
    for name, obj in (("bert_nid2index.pkl", data.nid2index),
                      ("train_sam_uid.pkl", data.train_samples),
                      ("valid_sam_uid.pkl", data.valid_samples)):
        with open(art / name, "wb") as f:
            pickle.dump(obj, f)
    return cfg, trainer, toks, root / "snaps", art


def test_load_checkpoint_params_restores_client0_of_the_newest_round(trained):
    _, trainer, _, snaps, _ = trained
    user, news, round_, kind = load_checkpoint_params(snaps)
    assert (round_, kind) == (1, "torch")
    m = trainer.states[0].model
    for state, module in ((user, m.user_encoder), (news, m.text_head)):
        assert set(state) == {k for k, _ in module.named_parameters()}
        for k, p in module.named_parameters():
            assert torch.equal(state[k], p.detach())


def test_publish_from_checkpoint_encodes_the_restored_text_head(trained):
    cfg, trainer, toks, snaps, _ = trained
    store = EmbeddingStore(registry=MetricsRegistry())
    gen = publish_from_checkpoint(store, cfg.model, snaps, toks, device="cpu")
    assert (gen.generation, gen.round, gen.source) == (0, 1, "checkpoint:torch")
    m = trainer.states[0].model
    assert torch.equal(gen.news_vecs, encode_all_news(m, torch.from_numpy(toks), device="cpu"))
    for (k, p), (k2, q) in zip(m.user_encoder.named_parameters(),
                               gen.user_params.named_parameters()):
        assert k == k2 and torch.equal(p.detach(), q)
    assert not gen.user_params.training and not any(p.requires_grad
                                                    for p in gen.user_params.parameters())


def test_jax_snapshot_formats_are_refused_by_name(tmp_path, trained):
    from fedrec_tpu.train.checkpoint import SnapshotManager as JaxSnapshotManager

    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="round_<r>/state.pt"):
        load_checkpoint_params(empty)
    with pytest.raises(FileNotFoundError):
        load_checkpoint_params(tmp_path / "missing")
    msgpack = tmp_path / "msgpack"
    msgpack.mkdir()
    (msgpack / "global_round_3.msgpack").write_bytes(b"\x80")
    with pytest.raises(SnapshotFormatError, match="coordinator msgpack globals"):
        load_checkpoint_params(msgpack)
    orbax = tmp_path / "orbax"
    mgr = JaxSnapshotManager(orbax)
    mgr.save(0, {"user_params": {"w": jnp.ones((2, 3))}}, wait=True)
    mgr.close()
    with pytest.raises(SnapshotFormatError, match="only orbax snapshot trees"):
        load_checkpoint_params(orbax)
    # beside the port's own snapshots, the JAX formats are passed over
    _, _, _, snaps, _ = trained
    (snaps / "global_round_9.msgpack").write_bytes(b"\x80")
    said = []
    try:
        assert load_checkpoint_params(snaps, log=said.append)[2:] == (1, "torch")
    finally:
        (snaps / "global_round_9.msgpack").unlink()
    assert len(said) == 1 and "coordinator globals 1" in said[0]


def _service(cfg, valid=None) -> ServingService:
    """Generation 0: a random table and a fresh user tower over N news."""
    model = init_params(NewsRecommender(cfg.model), seed=5).eval()
    table = torch.randn((N, cfg.model.news_dim), generator=torch.Generator().manual_seed(5))
    store = EmbeddingStore()
    store.publish(table, model.user_encoder, valid_mask=valid, source="synthetic")
    svc = ServingService(store, history_len=cfg.data.max_his_len, top_k=5, batch_sizes=(1, 4, 8),
                         flush_ms=1.0, model_cfg=cfg.model, device="cpu")
    svc.warmup()
    return svc


async def _serve(svc, body):
    server = await start_server(svc, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        return await body(reader, writer)
    finally:
        writer.close()
        server.close()
        await server.wait_closed()
        await svc.stop()


def _send(writer, req: dict) -> None:
    writer.write((json.dumps(req) + "\n").encode())


def test_refresh_over_tcp_swaps_mid_stream(trained):
    cfg, trainer, toks, snaps, art = trained
    valid = np.ones(N, bool)
    valid[40:] = False
    svc = _service(cfg, valid)
    rng = np.random.default_rng(9)
    hists = {i: rng.integers(1, N, 6).tolist() for i in range(24)}
    refresh = {"cmd": "refresh", "snapshot_dir": str(snaps),
               "token_states": str(art / "token_states.npy")}

    async def body(reader, writer):
        for i in range(12):            # pipelined: the refresh lands mid-stream
            _send(writer, {"id": i, "history": hists[i]})
        _send(writer, refresh)
        await writer.drain()
        before, reply = {}, None
        while reply is None:
            r = json.loads(await reader.readline())
            if "refreshed" in r or "error" in r and "id" not in r:
                reply = r
            else:
                before[r["id"]] = r
        for i in range(12, 24):        # sent after the refresh reply arrived
            _send(writer, {"id": i, "history": hists[i]})
        await writer.drain()
        after = {}
        while len(before) + len(after) < 24:
            r = json.loads(await reader.readline())
            (after if r["id"] >= 12 else before)[r["id"]] = r
        _send(writer, {"cmd": "metrics"})
        await writer.drain()
        return before, reply, after, json.loads(await reader.readline())["metrics"]

    before, reply, after, metrics = asyncio.run(asyncio.wait_for(_serve(svc, body), _TIMEOUT_S))
    assert reply == {"refreshed": True, "generation": 1, "round": 1, "source": "checkpoint:torch"}
    assert all(r["generation"] in (0, 1) and "error" not in r for r in before.values())
    assert all(r["generation"] == 1 for r in after.values())
    assert metrics["swap_count"] == 1 and metrics["round"] == 1
    assert set(svc.last_refresh_ms) >= {"restore_ms", "token_load_ms", "host_to_device_ms",
                                        "encode_ms", "index_build_ms", "warmup_ms"}
    # ground truth: the refreshed table encoded from the trainer's client 0,
    # the exact scorer with its user tower; the serving mask (same N) reused
    m = trainer.states[0].model
    table = encode_all_news(m, torch.from_numpy(toks), device="cpu")
    exact = build_recommend_fn(top_k=5, valid_mask=valid, device="cpu")
    for i, r in after.items():
        hist = torch.tensor([hists[i] + [0] * 4])
        assert r["ids"] == exact(m.user_encoder, table, hist)[0][0].tolist()
        assert all(0 < j < 40 for j in r["ids"])


def test_failed_refresh_keeps_serving_the_old_generation(trained, tmp_path):
    cfg, _, _, snaps, art = trained
    np.save(tmp_path / "short_mask.npy", np.ones(N - 1, bool))
    svc = _service(cfg)

    async def body(reader, writer):
        out = []
        for req in ({"cmd": "refresh", "snapshot_dir": str(tmp_path / "nowhere"),
                     "token_states": str(art / "token_states.npy")},
                    {"cmd": "refresh", "snapshot_dir": str(snaps),
                     "token_states": str(art / "token_states.npy"),
                     "valid_mask": str(tmp_path / "short_mask.npy")},
                    {"id": 1, "history": [3, 4]}):
            _send(writer, req)
            await writer.drain()
            out.append(json.loads(await reader.readline()))
        return out

    missing, short, served = asyncio.run(asyncio.wait_for(_serve(svc, body), _TIMEOUT_S))
    assert missing["error"].startswith("refresh_failed: FileNotFoundError")
    assert short["error"].startswith("refresh_failed: ValueError: valid_mask length 59")
    assert served["generation"] == 0 and len(served["ids"]) == 5
    assert svc.store.metrics()["swap_count"] == 0


def _tables():
    rng = np.random.default_rng(11)
    old = rng.standard_normal((80, 16)).astype(np.float32)
    new = old + 0.3 * rng.standard_normal((80, 16)).astype(np.float32)
    m_old, m_new = rng.random(80) > 0.2, rng.random(80) > 0.2
    return old, m_old, new, m_new


@pytest.mark.parametrize("case", ["same_catalog", "grown_catalog", "other_dim"])
def test_drift_probe_matches_jax(case):
    old, m_old, new, m_new = _tables()
    if case == "grown_catalog":
        new, m_new = np.concatenate([new, new[:7]]), np.concatenate([m_new, m_new[:7]])
    if case == "other_dim":
        new = new[:, :8]
    want = JaxDriftProbe(num_probes=12, topk=5, seed=2, registry=JaxMetricsRegistry()).compare(
        old, m_old, new, m_new)
    got = DriftProbe(num_probes=12, topk=5, seed=2, registry=MetricsRegistry()).compare(
        old, m_old, new, m_new)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_store_drift_probe_runs_before_the_swap_as_jax():
    old, m_old, new, m_new = _tables()
    tower = init_params(NewsRecommender(_cfg().model), seed=1).user_encoder
    port = EmbeddingStore(registry=MetricsRegistry())
    ref = JaxEmbeddingStore(registry=JaxMetricsRegistry())
    port.enable_drift_probe(num_probes=8, topk=4, seed=3)
    ref.enable_drift_probe(num_probes=8, topk=4, seed=3)
    for store, wrap in ((port, torch.from_numpy), (ref, np.asarray)):
        store.publish(wrap(old), tower, valid_mask=m_old)
        store.publish(wrap(new), tower, valid_mask=m_new)
    got, want = port.metrics(), ref.metrics()
    drift = {k for k in want if k.startswith("drift_")}
    assert drift and drift == {k for k in got if k.startswith("drift_")}
    for k in drift:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert got["generation"] == 1


def _cli_args(trained, *extra: str):
    _, _, _, snaps, art = trained
    argv = ["--data-dir", str(art), "--snapshot-dir", str(snaps), "--batch-sizes", "1,4",
            "--top-k", "3", *extra]
    for s in _SMALL:
        argv += ["--set", s]
    args = serve_cli.build_parser().parse_args(argv)
    return args, ExperimentConfig().apply_overrides(args.overrides)


def test_serve_cli_checkpoint_service(trained):
    args, cfg = _cli_args(trained, "--device", "cpu", "--set", "obs.quality.enabled=true",
                          "--set", "obs.quality.probe_users=4")
    svc = serve_cli.build_service(args, cfg)
    gen = svc.store.current()
    assert (gen.source, gen.round, gen.num_news) == ("checkpoint:torch", 1, N)
    assert svc.store._drift is not None and svc.store._drift.num_probes == 4
    svc.warmup()

    async def ask():
        await svc.start()
        try:
            return await svc.handle({"id": 1, "history": [3, 4, 5]})
        finally:
            await svc.stop()

    r = asyncio.run(asyncio.wait_for(ask(), _TIMEOUT_S))
    assert len(r["ids"]) == 3 and r["generation"] == 0
    assert r["news"] == [svc.id_map[i] for i in r["ids"]]
    assert all(n.startswith("N") for n in r["news"])


@pytest.mark.parametrize("flag", ["--shard-store", "obs.slo.enabled", "obs.wire.window"])
def test_serve_cli_refuses_unported_flags_by_name(trained, flag, capsys):
    """``--shard-store`` is refused by name (ROADMAP.md's Queue A item 9);
    the ``obs.slo`` and ``obs.wire`` keys are ported (the CLI's watch and
    wire envelope) and build the service."""
    args, cfg = _cli_args(trained, "--device", "cpu",
                          *([flag] if flag.startswith("--") else ["--set", f"{flag}=1"]))
    svc = serve_cli.build_service(args, cfg)
    if flag.startswith("--"):
        assert svc is None
        assert f"{flag} is not ported" in capsys.readouterr().err
    else:
        assert svc is not None and "is not ported" not in capsys.readouterr().err


def test_serve_cli_runs_on_the_card_unless_asked_for_the_cpu(trained):
    args, cfg = _cli_args(trained)
    with pytest.raises(NoGPUError):
        serve_cli.build_service(args, cfg)
