"""Port parity for the other model families (CPU): the GRU user tower
(``model.user_tower='gru'``) and the CNN text head
(``model.text_head_arch='cnn'``, ``model.cnn_kernel``) against the Flax
modules, the ``from_flax`` bridge over their trees, Flax's initialisers,
the joint and decoupled steps and a 2-round ``Trainer`` against the JAX
package's, per-example DP-SGD with the GRU tower, the refusals with the JAX
package's wording, a GRU+CNN snapshot through ``restore_model`` and the
recommend CLI, and the run CLI's cuDNN TF32 switch.

Tolerances. Module outputs in f32: atol 1e-5 (the same f32 products summed
in another order; values O(1)). bf16: kernel A's band, atol 0.15 / rtol
0.05, since one bf16 ulp is 2**-8 relative. Steps and trainers:
``tests/test_torch_train.py``'s trajectory bars, losses rtol 1e-5 / atol
1e-6, parameters rtol 2e-4 / atol 1e-4 (the leaves with a true gradient of
zero, and elements in Adam's epsilon regime, at a 1e-3 noise bound:
``tests/test_torch_decoupled.py``'s ``_assert_params_close``).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrec_tpu.config import ModelConfig as JaxModelConfig
from fedrec_tpu.fed import get_strategy as jax_get_strategy
from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
from fedrec_tpu.parallel import shard_batch
from fedrec_tpu.train import build_fed_train_step as jax_build_fed_train_step
from fedrec_tpu.train import build_news_update_step as jax_build_news_update_step
from fedrec_tpu.train import build_param_sync as jax_build_param_sync
from fedrec_tpu.train import encode_all_news as jax_encode_all_news
from fedrec_tpu.train.trainer import Trainer as JaxTrainer
from fedrec_tpu_torch.config import ExperimentConfig, ModelConfig
from fedrec_tpu_torch.fed import get_strategy
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.models.encoders import CnnTextHead, GRUUserEncoder
from fedrec_tpu_torch.params import from_flax, init_params
from fedrec_tpu_torch.serving import load_checkpoint_params, restore_model
from fedrec_tpu_torch.train import (
    Trainer,
    build_fed_train_step,
    build_news_update_step,
    build_param_sync,
    encode_all_news,
    init_client_state,
    replicate_state,
)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_decoupled import _assert_params_close, _EpsRegime  # noqa: E402
from test_torch_train import _client_tree  # noqa: E402
from test_torch_trainer import _assert_round, _jax_round, _port_cfg  # noqa: E402
from test_train import _batch_dict, make_setup, small_cfg  # noqa: E402
from test_trainer import tiny_cfg, tiny_data  # noqa: E402

_KW = dict(news_dim=32, num_heads=4, head_dim=8, query_dim=16, bert_hidden=48)
_FAMILIES = dict(user_tower="gru", text_head_arch="cnn")
_F32_ATOL = 1e-5
_BF16_ATOL, _BF16_RTOL = 0.15, 0.05


def _flax_tree(cnn_kernel: int, seed: int = 3) -> dict:
    """A Flax ``NewsRecommender`` tree of both families, its biases drawn
    (zero at init) so that the bridge is tested on them."""
    rng = np.random.default_rng(seed)
    model = JaxNewsRecommender(JaxModelConfig(**_KW, **_FAMILIES, cnn_kernel=cnn_kernel))
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, 6, 48)), jnp.zeros((2, 3, 32)),
                   jnp.zeros((2, 8, 32)), method=JaxNewsRecommender.init_both_towers)
    tree = jax.tree_util.tree_map(np.asarray, v["params"])

    def draw(node):
        for key, sub in node.items():
            if isinstance(sub, dict):
                draw(sub)
            elif key == "bias":
                node[key] = (rng.standard_normal(sub.shape) * 0.05).astype(np.float32)
    draw(tree)
    return tree


def _to_flax(module) -> dict:
    """A port module's parameters as a Flax-shaped numpy tree: Dense
    kernels (in, out), the CNN head's conv kernel (k, in, out)."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        value = p.detach().numpy()
        if leaf == "weight":
            value = value.T
            if path[-1] == "conv":
                k = module.get_submodule(".".join(path[:-1])).kernel
                value = value.reshape(k, -1, value.shape[-1])
        node["kernel" if leaf == "weight" else "bias"] = value
    return tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _assert_out(got: torch.Tensor, want, dtype: str, what: str) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().detach().numpy(), want, atol=_BF16_ATOL,
                                   rtol=_BF16_RTOL, err_msg=what)
    else:
        np.testing.assert_allclose(got.detach().numpy(), want, atol=_F32_ATOL, err_msg=what)


# ------------------------------------------------------------- the modules
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_gru_user_encoder_matches_flax(use_pallas, dtype, masked):
    """The GRU tower over (B, H, D) histories: the recurrence in Flax's
    gate layout, then the pool (kernel A's plain version under
    ``use_pallas``; the JAX side's Pallas kernel in interpret mode). With a
    tail-padded mask the recurrence still runs every step, as JAX's
    ``nn.RNN(seq_lengths=...)`` does, and only the pool masks."""
    rng = np.random.default_rng(1)
    tree = _flax_tree(3)
    his = rng.standard_normal((3, 8, 32)).astype(np.float32)
    mask = None
    if masked:
        lens = np.array([8, 5, 1])
        mask = (np.arange(8)[None] < lens[:, None]).astype(np.float32)
    cfg = dict(**_KW, **_FAMILIES, dtype=dtype, use_pallas=use_pallas)
    jm = JaxNewsRecommender(JaxModelConfig(**cfg))
    want = jm.apply({"params": tree}, jnp.asarray(his), None if mask is None else jnp.asarray(mask),
                    method=JaxNewsRecommender.encode_user)
    tm = NewsRecommender(ModelConfig(**cfg)).eval()
    from_flax(tm, tree)
    assert isinstance(tm.user_encoder, GRUUserEncoder)
    got = tm.encode_user(_t(his), None if mask is None else _t(mask))
    assert got.shape == (3, 32) and got.dtype == torch.float32
    _assert_out(got, want, dtype, "user vector")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kernel", [3, 4])
def test_cnn_text_head_matches_flax(use_pallas, dtype, masked, kernel):
    """The CNN head over (N, L, bert_hidden) token states: SAME padding
    (asymmetric for the even kernel), ReLU, the pool with ``news_dim // 2``
    hidden units; with and without a token mask."""
    rng = np.random.default_rng(2)
    tree = _flax_tree(kernel)
    toks = rng.standard_normal((5, 6, 48)).astype(np.float32)
    mask = (rng.random((5, 6)) > 0.3).astype(np.float32) if masked else None
    cfg = dict(**_KW, **_FAMILIES, cnn_kernel=kernel, dtype=dtype, use_pallas=use_pallas)
    jm = JaxNewsRecommender(JaxModelConfig(**cfg))
    want = jm.apply({"params": tree}, jnp.asarray(toks), None if mask is None else jnp.asarray(mask),
                    method=JaxNewsRecommender.encode_news)
    tm = NewsRecommender(ModelConfig(**cfg)).eval()
    from_flax(tm, tree)
    assert isinstance(tm.text_head, CnnTextHead)
    got = tm.encode_news(_t(toks).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32),
                         None if mask is None else _t(mask))
    assert got.shape == (5, 32) and got.dtype == getattr(torch, dtype)
    _assert_out(got, want, dtype, "news vector")


def test_from_flax_maps_both_family_trees():
    tree = _flax_tree(4)
    tm = NewsRecommender(ModelConfig(**_KW, **_FAMILIES, cnn_kernel=4))
    loaded = set(from_flax(tm, tree))
    assert loaded == {
        *(f"user_encoder.GRUCell_0.{g}" for g in ("ir", "iz", "in", "hr", "hz", "hn")),
        "user_encoder.pool.att_fc1", "user_encoder.pool.att_fc2",
        "text_head.conv", "text_head.pool.att_fc1", "text_head.pool.att_fc2",
    }
    cell = tm.user_encoder.GRUCell_0
    assert cell.hr.bias is None and cell.hz.bias is None and cell.hn.bias is not None
    # the conv: (k, in, out) -> (out, k * in), tap-major
    kern = tree["text_head"]["conv"]["kernel"]
    assert kern.shape == (4, 48, 32)
    w = tm.text_head.conv.weight.detach().numpy()
    np.testing.assert_array_equal(w[:, 2 * 48 + 5], kern[2, 5])
    # the round trip
    back = _to_flax(tm)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    with pytest.raises(ValueError, match="bias"):
        from_flax(tm, {"user_encoder": {"GRUCell_0": {"hr": {
            "kernel": np.zeros((32, 32), np.float32), "bias": np.zeros(32, np.float32)}}}})
    with pytest.raises(ValueError):
        from_flax(tm, {"text_head": {"conv": {"kernel": np.zeros((3, 48, 32), np.float32),
                                              "bias": np.zeros(32, np.float32)}}})


def test_init_params_gives_flax_initialisers_to_both_families():
    """Orthogonal recurrent kernels, LeCun-normal input and conv kernels
    (the conv's fan-in k * in), zero biases; seeded."""
    cfg = ModelConfig(news_dim=64, query_dim=16, bert_hidden=96, **_FAMILIES, cnn_kernel=3)
    tm = init_params(NewsRecommender(cfg), seed=5)
    cell = tm.user_encoder.GRUCell_0
    for name in ("hr", "hz", "hn"):
        w = getattr(cell, name).weight.detach()
        torch.testing.assert_close(w @ w.T, torch.eye(64), atol=1e-5, rtol=0)
    # a truncated normal of std sqrt(1 / fan_in) over [-2, 2] std
    for layer, fan_in in ((cell.ir, 64), (tm.text_head.conv, 3 * 96)):
        w = layer.weight.detach()
        assert abs(float(w.std()) - (1 / fan_in) ** 0.5) < 0.1 * (1 / fan_in) ** 0.5
        assert float(w.abs().max()) <= 2 * (1 / fan_in) ** 0.5 / 0.8796256610342398 + 1e-6
    for name, p in tm.named_parameters():
        if name.endswith("bias"):
            assert float(p.detach().abs().max()) == 0.0, name
    again = init_params(NewsRecommender(cfg), seed=5)
    assert all(torch.equal(p, q) for p, q in zip(tm.parameters(), again.parameters()))


# ------------------------------------------------------ the steps against JAX
_K, _STEPS = 2, 3


def _step_cfg(mode: str, **over) -> ExperimentConfig:
    return ExperimentConfig().apply_overrides([
        "model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
        "model.bert_hidden=48", "data.max_his_len=10", "data.max_title_len=12",
        "data.batch_size=8", f"fed.num_clients={_K}", f"model.text_encoder_mode={mode}",
        "model.dropout_rate=0.0", "optim.user_lr=3e-3", "optim.news_lr=3e-3",
        "model.user_tower=gru", "model.text_head_arch=cnn", "model.use_pallas=true",
        "train.snapshot_dir=", *(f"{k}={v}" for k, v in over.items()),
    ])


def _jax_setup(mode: str, **over):
    jcfg = small_cfg(**{"optim__user_lr": 3e-3, "optim__news_lr": 3e-3,
                        "model__text_encoder_mode": mode, "model__dropout_rate": 0.0,
                        "model__use_pallas": True, "model__user_tower": "gru",
                        "model__text_head_arch": "cnn", "fed__num_clients": _K, **over})
    return jcfg, *make_setup(jcfg, seed=0)


def _joint_steps_match_jax(jax_over: dict, port_over: dict) -> None:
    """Three ``param_avg`` joint steps of K=2 clients from the same
    parameters, losses per step and parameters after the round-end mean."""
    jcfg, _, jbatcher, toks, jmodel, jstate, mesh = _jax_setup("head", **jax_over)
    jstep = jax_build_fed_train_step(jmodel, jcfg, jax_get_strategy("param_avg"), mesh,
                                     mode="joint")
    cfg = _step_cfg("head", **port_over)
    model = NewsRecommender(cfg.model)
    from_flax(model, _client_tree(jstate, 0))
    states = replicate_state(init_client_state(model, cfg, seed=0), _K)
    step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device="cpu")
    table = _t(np.array(toks))
    regimes = [_EpsRegime(st) for st in states]
    for i, b in enumerate(jbatcher.epoch_batches_sharded(_K, 0)):
        if i == _STEPS:
            break
        jstate, jm = jstep(jstate, shard_batch(mesh, _batch_dict(b)), toks)
        states, m = step(states, _batch_dict(b), table)
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]).reshape(-1),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
        assert m["unique_overflow"] == 0
        for r in regimes:
            r.update()
    jstate = jax_build_param_sync(jcfg, mesh)(jstate, jnp.ones((_K,), jnp.float32))
    states = build_param_sync(cfg)(states, np.ones(_K))
    for c in range(_K):
        _assert_params_close(states[c].model, _client_tree(jstate, c), _EpsRegime.union(regimes))


@pytest.mark.parametrize("gather_chunk", [0, 16])
def test_joint_steps_match_jax(gather_chunk):
    """Three ``param_avg`` joint steps of K=2 clients (the CNN head's dense
    gather + encode, tiled by ``data.gather_chunk`` on the port's side),
    then the round-end mean."""
    _joint_steps_match_jax({}, {"data.gather_chunk": gather_chunk})


def test_fused_cnn_joint_steps_match_jax():
    """The CNN head under the MHA tower with ``fuse_hot_path``: the user
    tower through B and E (their plain versions here; the JAX side's Pallas
    kernels in interpret mode), the CNN head's dense gather + encode on
    both sides, three joint steps and the round-end mean."""
    _joint_steps_match_jax({"model__user_tower": "mha", "model__fuse_hot_path": True},
                           {"model.user_tower": "mha", "model.fuse_hot_path": True})


def test_decoupled_steps_and_news_update_match_jax():
    """One epoch of 3 decoupled steps (the GRU tower on the CNN head's
    table), the news update's corpus replay and re-encode through the CNN
    head (chunked: 64 news in chunks of 24), then the losses, tables and
    parameters."""
    jcfg, _, jbatcher, toks, jmodel, jstate, mesh = _jax_setup("table")
    jstrat = jax_get_strategy("param_avg")
    jstep = jax_build_fed_train_step(jmodel, jcfg, jstrat, mesh, mode="decoupled")
    jupdate = jax_build_news_update_step(jmodel, jcfg, mesh, jstrat)
    jtable = jax_encode_all_news(jmodel, jax.tree_util.tree_map(lambda x: x[0], jstate.news_params),
                                 toks)
    cfg = _step_cfg("table")
    model = NewsRecommender(cfg.model)
    from_flax(model, _client_tree(jstate, 0))
    states = replicate_state(init_client_state(model, cfg), _K)
    strat = get_strategy("param_avg")
    step = build_fed_train_step(model, cfg, strat, device="cpu")
    update = build_news_update_step(model, cfg, strat, chunk=24, device="cpu")
    token_states = _t(np.array(toks))
    table = encode_all_news(model, token_states, chunk=24, device="cpu")
    np.testing.assert_allclose(table.numpy(), np.asarray(jtable), rtol=2e-4, atol=1e-4)
    regimes = [_EpsRegime(st) for st in states]
    for i, b in enumerate(jbatcher.epoch_batches_sharded(_K, 0)):
        if i == _STEPS:
            break
        jstate, jm = jstep(jstate, shard_batch(mesh, _batch_dict(b)), jtable)
        states, m = step(states, _batch_dict(b), table)
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]).reshape(-1),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
        for r in regimes:
            r.update()
    jstate, jtables = jupdate(jstate, toks)
    states, tables = update(states, token_states)
    for c, st in enumerate(states):
        regimes[c].update()
        np.testing.assert_allclose(tables[c].numpy(), np.asarray(jtables[c]), rtol=2e-4, atol=1e-4)
        _assert_params_close(st.model, _client_tree(jstate, c), regimes[c])


def test_trainer_matches_jax_over_two_rounds():
    """The port's ``Trainer`` against the JAX ``Trainer`` with GRU+CNN in
    joint mode, K=4: two rounds, each evaluated on the full pool (round
    losses, validation means), then every client's parameters."""
    jcfg = tiny_cfg(None, model__text_encoder_mode="head", model__dropout_rate=0.0,
                    model__use_pallas=True, model__user_tower="gru", model__text_head_arch="cnn",
                    optim__user_lr=3e-3, optim__news_lr=3e-3, fed__num_clients=4,
                    fed__rounds=2, train__eval_every=1)
    data, toks = tiny_data(jcfg)
    pt = Trainer(_port_cfg(jcfg), data, toks, device="cpu")
    jcfg.train.eval_every = 10**6
    jt = JaxTrainer(jcfg, data, toks)
    up, np_ = jax.tree_util.tree_map(np.asarray, jt._client0_params())
    pt.set_global_params(up, np_)
    regimes = [_EpsRegime(st) for st in pt.states]
    for r in range(2):
        _assert_round(_jax_round(jt, r, "full"), pt.train_round(r), f"round {r}")
    for c in range(4):
        _assert_params_close(pt.states[c].model, _client_tree(jt.state, c),
                             _EpsRegime.union(regimes))


def test_dpsgd_with_the_gru_tower_matches_jax():
    """Per-example DP-SGD (``torch.func`` over the GRU recurrence and the
    CNN head) at sigma 1e-9: three ``param_avg`` SGD steps of K=2 against
    the JAX step, losses, clip rates and parameters (SGD, as in
    ``tests/test_torch_dpsgd.py``)."""
    jcfg, _, jbatcher, toks, jmodel, jstate, mesh = _jax_setup(
        "head", optim__optimizer="sgd", optim__user_lr=3e-2, optim__news_lr=3e-2)
    jcfg.privacy.enabled, jcfg.privacy.sigma = True, 1e-9
    jstep = jax_build_fed_train_step(jmodel, jcfg, jax_get_strategy("param_avg"), mesh,
                                     mode="joint")
    cfg = _step_cfg("head", **{"privacy.enabled": 1, "privacy.sigma": 1e-9,
                               "optim.optimizer": "sgd", "optim.user_lr": 3e-2,
                               "optim.news_lr": 3e-2})
    model = NewsRecommender(cfg.model)
    from_flax(model, _client_tree(jstate, 0))
    states = replicate_state(init_client_state(model, cfg, seed=0), _K)
    step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device="cpu")
    table = _t(np.array(toks))
    for i, b in enumerate(jbatcher.epoch_batches_sharded(_K, 0)):
        if i == _STEPS:
            break
        jstate, jm = jstep(jstate, shard_batch(mesh, _batch_dict(b)), toks)
        states, m = step(states, _batch_dict(b), table)
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]).reshape(-1),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
        np.testing.assert_allclose(m["health.clip_rate"].numpy(),
                                   np.asarray(jm["health.clip_rate"]).reshape(-1))
    jstate = jax_build_param_sync(jcfg, mesh)(jstate, jnp.ones((_K,), jnp.float32))
    states = build_param_sync(cfg)(states, np.ones(_K))
    for c in range(_K):
        # SGD has no epsilon regime: only the zero-gradient leaves are noise
        _assert_params_close(states[c].model, _client_tree(jstate, c), _EpsRegime.union([]))


# ------------------------------------------------------- refusals and resume
def test_fuse_hot_path_with_gru_is_refused_in_jax_wording():
    cfg = dict(**_KW, user_tower="gru", fuse_hot_path=True)
    with pytest.raises(ValueError) as theirs:
        jm = JaxNewsRecommender(JaxModelConfig(**cfg))
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 48)), jnp.zeros((1, 3, 32)),
                jnp.zeros((1, 4, 32)), method=JaxNewsRecommender.init_both_towers)
    with pytest.raises(ValueError) as ours:
        NewsRecommender(ModelConfig(**cfg))
    assert str(ours.value) == str(theirs.value)
    # the CNN head keeps fuse_hot_path: B/E on the user tower, no C/D
    tm = NewsRecommender(ModelConfig(**_KW, text_head_arch="cnn", fuse_hot_path=True))
    assert tm.user_encoder.fused and isinstance(tm.text_head, CnnTextHead)
    with pytest.raises(ValueError, match="unknown model.user_tower 'lstm'"):
        NewsRecommender(ModelConfig(**_KW, user_tower="lstm"))
    with pytest.raises(ValueError, match="unknown model.text_head_arch 'rnn'"):
        NewsRecommender(ModelConfig(**_KW, text_head_arch="rnn"))


def _tiny_families(tmp_path, **over) -> ExperimentConfig:
    return _port_cfg(tiny_cfg(tmp_path, model__text_encoder_mode="head",
                              model__user_tower="gru", model__text_head_arch="cnn",
                              model__use_pallas=True, **over))


def test_resume_under_another_cnn_kernel_is_refused_by_name(tmp_path):
    cfg = _tiny_families(tmp_path, fed__rounds=1)
    data, toks = tiny_data(cfg)
    Trainer(cfg, data, toks, device="cpu").run()
    other = _tiny_families(tmp_path, fed__rounds=2, model__cnn_kernel=4)
    with pytest.raises(ValueError, match="model.cnn_kernel: snapshot=3 vs this run=4"):
        Trainer(other, data, toks, device="cpu")


def test_snapshot_restores_and_serves_through_the_serve_and_recommend_clis(tmp_path):
    """A GRU+CNN run's snapshot through ``load_checkpoint_params`` and
    ``restore_model`` (the same parameters), then the recommend CLI over a
    reference-layout artifact directory, and the serve CLI's checkpoint
    service answering a request."""
    import asyncio

    from fedrec_tpu_torch.cli import recommend
    from fedrec_tpu_torch.cli import serve as serve_cli
    from fedrec_tpu_torch.data.preprocess import write_artifacts

    cfg = _tiny_families(tmp_path / "snaps", fed__rounds=1)
    data, toks = tiny_data(cfg)
    trainer = Trainer(cfg, data, toks, device="cpu")
    trainer.run()
    user_state, news_state, round_, kind = load_checkpoint_params(tmp_path / "snaps")
    assert (round_, kind) == (0, "torch")
    model = restore_model(cfg.model, user_state, news_state, device="cpu")
    for p, q in zip(model.parameters(), trainer.states[0].model.parameters()):
        assert torch.equal(p, q)
    art = tmp_path / "UserData"
    write_artifacts(data, art)
    np.save(art / "token_states.npy", toks)
    out = tmp_path / "recs.jsonl"
    argv = ["--data-dir", str(art), "--snapshot-dir", str(tmp_path / "snaps"), "--device", "cpu",
            "--top-k", "3", "--out", str(out)]
    assert recommend.main(argv) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert rows and all(len(r["news"]) == 3 for r in rows)
    argv = ["--data-dir", str(art), "--snapshot-dir", str(tmp_path / "snaps"), "--device",
            "cpu", "--top-k", "3"]
    for key in ("news_dim", "num_heads", "head_dim", "query_dim", "bert_hidden", "user_tower",
                "text_head_arch", "use_pallas"):
        argv += ["--set", f"model.{key}={getattr(cfg.model, key)}"]
    args = serve_cli.build_parser().parse_args(argv + ["--set", "data.max_his_len=10"])
    svc = serve_cli.build_service(args, ExperimentConfig().apply_overrides(args.overrides))

    async def ask():
        await svc.start()
        try:
            return await svc.handle({"id": 1, "history": [3, 4, 5]})
        finally:
            await svc.stop()

    r = asyncio.run(asyncio.wait_for(ask(), 60))
    assert len(r["ids"]) == 3 and r["generation"] == 0


def test_run_cli_turns_cudnn_tf32_off(tmp_path, monkeypatch):
    """The run CLI sets ``torch.backends.cudnn.allow_tf32 = False`` (and
    matmul TF32 off), as the serve and recommend CLIs do."""
    from fedrec_tpu_torch.cli import run

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    argv = ["1", "8", "1", "--synthetic", "--synthetic-news", "64", "--synthetic-train", "64",
            "--clients", "2", "--device", "cpu", "--mode", "joint",
            "--set", "model.news_dim=32", "--set", "model.num_heads=4", "--set",
            "model.head_dim=8", "--set", "model.query_dim=16", "--set", "model.bert_hidden=48",
            "--set", "model.user_tower=gru", "--set", "model.text_head_arch=cnn",
            "--set", f"train.snapshot_dir={tmp_path}"]
    assert run.main(argv) == 0
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
