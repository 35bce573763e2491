"""Port parity for the joint-mode federated train step (CPU): the repaired
fused route's gradients, the loss, the unique-id dedup and its cap, the
optimizer chains against optax, the weighted parameter mean, the numpy data
port-copies, and K=8 federated trajectories against the JAX package's
``build_fed_train_step`` on the 8 fake CPU devices of ``tests/conftest.py``.

Tolerances. Gradients and single steps in f32 differ only by summation order
between XLA and PyTorch: 1e-5 absolute (values O(0.1-1)). Trajectories use
the bars of ``tests/test_fused_hot_path.py``'s fused-vs-dense trajectory:
losses rtol 1e-5 / atol 1e-6 per step, parameters rtol 2e-4 / atol 1e-4
(Adam divides by sqrt(v), which amplifies the last bits of tiny gradients).
Two leaves have a gradient of exactly zero in theory — the key-projection
bias (a softmax-row shift) and the pool fc2 bias (a constant logit shift) —
so each path's value there is float noise that Adam amplifies; they compare
at a 1e-3 noise bound.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrec_tpu.data import TrainBatcher as JaxTrainBatcher
from fedrec_tpu.data import index_samples as jax_index_samples
from fedrec_tpu.data import make_synthetic_mind as jax_make_synthetic_mind
from fedrec_tpu.data import make_synthetic_mind_topics as jax_make_synthetic_mind_topics
from fedrec_tpu.fed import get_strategy as jax_get_strategy
from fedrec_tpu.models import score_loss as jax_score_loss
from fedrec_tpu.parallel import shard_batch
from fedrec_tpu.train import build_fed_train_step as jax_build_fed_train_step
from fedrec_tpu.train import build_param_sync as jax_build_param_sync
from fedrec_tpu.train.state import make_optimizers as jax_make_optimizers
from fedrec_tpu.train.step import unique_overflow as jax_unique_overflow
from fedrec_tpu_torch.config import ExperimentConfig, ModelConfig
from fedrec_tpu_torch.data import TrainBatcher, index_samples, make_synthetic_mind, make_synthetic_mind_topics
from fedrec_tpu_torch.fed import get_strategy, weighted_param_avg
from fedrec_tpu_torch.models import NewsRecommender, score_loss
from fedrec_tpu_torch.ops import UserTowerWeights, additive_pool_plain, fused_history_score_plain
from fedrec_tpu_torch.ops import attention_kernels, fused_hot_path
from fedrec_tpu_torch.params import from_flax, init_params
from fedrec_tpu_torch.train import (
    build_fed_train_step,
    build_param_sync,
    init_client_state,
    make_optimizers,
    replicate_state,
    resolve_unique_cap,
    unique_overflow,
)
from fedrec_tpu_torch.train import step as step_module
from fedrec_tpu_torch.train.step import take_rows_backward, unique_padded

sys.path.insert(0, str(Path(__file__).parent))
from test_train import _batch_dict, make_setup, small_cfg  # noqa: E402

_KW = dict(news_dim=32, num_heads=4, head_dim=8, query_dim=16, bert_hidden=48)
_ZERO_GRAD = ("self_attn.w_k.bias", "pool.att_fc2.bias")


# ------------------------------------------------------------ the repairs
def test_fused_route_trains_every_user_tower_weight():
    """The fused route's user-tower gradients equal the dense route's: its
    kernel operands are differentiable views of the live parameters when
    autograd is on (the cached pack used to cut the weights off)."""
    rng = np.random.default_rng(0)
    dense = init_params(NewsRecommender(ModelConfig(**_KW)), seed=3).user_encoder
    fused = init_params(NewsRecommender(ModelConfig(**_KW, fuse_hot_path=True)), seed=3).user_encoder
    his = torch.from_numpy(rng.standard_normal((3, 6, 32)).astype(np.float32))
    cand = torch.from_numpy(rng.standard_normal((3, 5, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    # same dropout masks: each route draws from an equally seeded stream
    user, scores = fused(his, None, True, cand, torch.Generator().manual_seed(7))
    ((scores * w).sum() + user.sum()).backward()
    user_d = dense(his, None, True, generator=torch.Generator().manual_seed(7))
    ((torch.einsum("bcd,bd->bc", cand, user_d) * w).sum() + user_d.sum()).backward()
    grads_d = dict(dense.named_parameters())
    for name, p in fused.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        want = grads_d[name].grad
        if name in _ZERO_GRAD:
            assert float(got.abs().max()) < 1e-5 and float(want.abs().max()) < 1e-5, name
            continue
        assert p.grad is not None, f"{name}: no gradient through the fused route"
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, err_msg=name)


def test_serving_pack_is_cached_and_detached():
    enc = init_params(NewsRecommender(ModelConfig(**_KW, fuse_hot_path=True)), seed=1).user_encoder
    with torch.no_grad():
        a = enc.fused_weights(torch.float32)
        assert enc.fused_weights(torch.float32) is a
    assert a.wq.grad_fn is None
    trained = enc.fused_weights(torch.float32)
    assert trained is not a and all(t.requires_grad for t in trained)
    assert trained.wq.grad_fn is not None  # a view of w_q.weight, not a copy


def _plain_launch(monkeypatch, module, name, plain):
    """Let a CUDA launcher run its plain version, so that the autograd
    function around it runs on CPU tensors."""
    monkeypatch.setattr(module, name, plain)


def test_kernel_autograd_functions_route_gradients(monkeypatch, rng):
    """The autograd functions that wrap kernels A, B+E and C+D, driven on
    CPU tensors with each launcher swapped for its plain version: their
    gradients equal autograd of the plain versions."""
    t = torch.from_numpy
    # kernel A: backward = autograd of the plain pool
    _plain_launch(monkeypatch, attention_kernels, "_launch", additive_pool_plain)
    x = t(rng.standard_normal((4, 7, 16)).astype(np.float32))
    w1 = t(rng.standard_normal((16, 8)).astype(np.float32) * 0.3)
    b1 = t(rng.standard_normal(8).astype(np.float32) * 0.1)
    w2 = t(rng.standard_normal(8).astype(np.float32) * 0.3)
    leaves = [v.clone().requires_grad_() for v in (x, w1, b1, w2)]
    got = torch.autograd.grad(attention_kernels._Pool.apply(*leaves, None).square().sum(), leaves)
    leaves = [v.clone().requires_grad_() for v in (x, w1, b1, w2)]
    want = torch.autograd.grad(additive_pool_plain(*leaves).square().sum(), leaves)
    for g, h in zip(got, want):
        np.testing.assert_allclose(g.numpy(), h.numpy(), atol=1e-6)

    # kernels B + E
    _plain_launch(monkeypatch, fused_hot_path, "_launch_hist", fused_history_score_plain)
    d, q, nh = 16, 8, 2
    xs = t(rng.standard_normal((3, 5, d)).astype(np.float32))
    cs = t(rng.standard_normal((3, 4, d)).astype(np.float32))
    ws = [t((rng.standard_normal(s) * 0.3).astype(np.float32))
          for s in [(d, d), (d,)] * 3 + [(d, q), (q,), (q,)]]

    def run(fn):
        leaves = [v.clone().requires_grad_() for v in (xs, cs, *ws)]
        s, u = fn(leaves)
        return torch.autograd.grad((s * s).sum() + u.sum(), leaves)

    got = run(lambda lv: fused_hot_path._HistScore.apply(nh, lv[0], lv[1], None, *lv[2:]))
    want = run(lambda lv: fused_history_score_plain(lv[0], lv[1], None, UserTowerWeights(*lv[2:]), nh))
    for g, h in zip(got, want):
        np.testing.assert_allclose(g.numpy(), h.numpy(), atol=1e-6)

    # kernels C + D: no cotangent for the table
    _plain_launch(monkeypatch, fused_hot_path, "_launch_gather",
                  lambda tb, ids, w: fused_hot_path.fused_gather_encode_plain(tb, ids, w))
    table = t(rng.standard_normal((9, 5, 16)).astype(np.float32))
    ids = torch.tensor([0, 3, 3, 8], dtype=torch.int64)
    hw = [t((rng.standard_normal(s) * 0.3).astype(np.float32)) for s in [(16, 8), (8,), (8,), (16, 6), (6,)]]
    leaves = [v.clone().requires_grad_() for v in hw]
    out = fused_hot_path._GatherEncode.apply(table, ids, *leaves)
    got = torch.autograd.grad(out.square().sum(), leaves)
    leaves = [v.clone().requires_grad_() for v in hw]
    out = fused_hot_path.fused_gather_encode_plain(table, ids, fused_hot_path.TextHeadWeights(*leaves))
    want = torch.autograd.grad(out.square().sum(), leaves)
    for g, h in zip(got, want):
        np.testing.assert_allclose(g.numpy(), h.numpy(), atol=1e-6)


def test_take_rows_backward_is_a_deterministic_segment_sum():
    """The slot gather's backward (``_TakeRows``) sums each slot's cotangents
    in a fixed order, in memory linear in the ids (it used to build a
    (slots x ids) one-hot): equal to index_add_ within 1e-6, bitwise
    repeatable. The ids hold duplicates, overflow ids clamped onto the last
    slot, and padding slots no id maps to."""
    rng = np.random.default_rng(4)
    ids = np.concatenate([rng.integers(1, 40, 300), np.zeros(60, np.int64),
                          rng.integers(40, 90, 25)])      # 0 = history padding
    uniq, inv = unique_padded(torch.from_numpy(ids), 45)  # cap 45 < distinct: clamped
    assert int(inv.max()) == 44 and int((inv == 44).sum()) > 1
    rows = 50                                             # 5 padding slots past the cap
    g = torch.from_numpy(rng.standard_normal((inv.numel(), 16)).astype(np.float32))
    got = take_rows_backward(g, inv, rows)
    want = torch.zeros((rows, 16)).index_add_(0, inv, g)
    assert got.shape == (rows, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert torch.equal(got, take_rows_backward(g, inv, rows))
    assert float(got[45:].abs().max()) == 0.0
    # through autograd, as the train step gathers the candidate/history slots
    vecs = torch.from_numpy(rng.standard_normal((rows, 16)).astype(np.float32)).requires_grad_()
    (grad,) = torch.autograd.grad(step_module._TakeRows.apply(vecs, inv), vecs, g)
    assert torch.equal(grad, got)


# -------------------------------------------------------- loss and dedup
@pytest.mark.parametrize("sigmoid", [True, False])
def test_score_loss_matches_jax(rng, sigmoid):
    scores = (rng.standard_normal((6, 5)) * 3).astype(np.float32)
    labels = np.zeros(6, np.int32)
    labels[2] = 3
    want = jax_score_loss(jnp.asarray(scores), jnp.asarray(labels), sigmoid)
    got = score_loss(torch.from_numpy(scores), torch.from_numpy(labels), sigmoid)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    per_row = score_loss(torch.from_numpy(scores).to(torch.bfloat16), torch.from_numpy(labels),
                         sigmoid, reduce=False)
    assert per_row.dtype == torch.float32 and per_row.shape == (6,)


@pytest.mark.parametrize("size", [3, 5, 9])
def test_unique_padded_matches_jnp_unique(size):
    ids = np.array([5, 3, 3, 9, 0, 7, 5], np.int64)
    uj, ij = jnp.unique(jnp.asarray(ids), size=size, fill_value=0, return_inverse=True)
    ut, it = unique_padded(torch.from_numpy(ids), size)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    # past the cap JAX's gather clamps the slot to the last one; so does the port
    np.testing.assert_array_equal(it.numpy(), np.minimum(np.asarray(ij).reshape(-1), size - 1))


def test_unique_cap_and_overflow_flag_match_jax(rng):
    cfg = ExperimentConfig()
    cfg.data.unique_news_cap = 40
    assert resolve_unique_cap(cfg, 64) == 40
    cfg.data.unique_news_cap_buckets = "8:20,32:60"
    assert [resolve_unique_cap(cfg, b) for b in (4, 8, 9, 32, 33)] == [20, 20, 60, 60, 0]
    cfg.data.unique_news_cap_buckets = "8:20,8:30"
    with pytest.raises(ValueError):
        resolve_unique_cap(cfg, 4)
    cand = rng.integers(1, 200, (4, 5))
    his = rng.integers(0, 200, (4, 10))
    distinct = len(np.unique(np.concatenate([cand.ravel(), his.ravel()])))
    for cap in (distinct - 1, distinct, distinct + 5):
        want = int(jax_unique_overflow(jnp.asarray(cand), jnp.asarray(his), cap, 200))
        got = unique_overflow(torch.from_numpy(cand), torch.from_numpy(his), cap, 200)
        assert got == want == int(distinct > cap)


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("clip,schedule", [(0.0, "constant"), (0.05, "cosine"), (50.0, "cosine")])
def test_make_optimizers_match_optax(rng, clip, schedule):
    over = dict(optim__user_lr=3e-3, optim__news_lr=1e-3, optim__grad_clip_norm=clip,
                optim__lr_schedule=schedule, optim__decay_steps=4, optim__lr_min_frac=0.2)
    jcfg = small_cfg(**over)
    cfg = ExperimentConfig()
    for k, v in over.items():
        section, key = k.split("__")
        setattr(getattr(cfg, section), key, v)
    params = [rng.standard_normal(s).astype(np.float32) for s in [(4, 3), (3,)]]
    jtx = jax_make_optimizers(jcfg)[0]
    ttx = make_optimizers(cfg)[0]
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(6):
        grads = [(rng.standard_normal(p.shape) * 0.1).astype(np.float32) for p in params]
        ju, js = jtx.update([jnp.asarray(g) for g in grads], js, jp)
        tu, ts = ttx.update([torch.from_numpy(g) for g in grads], ts, tp)
        for a, b in zip(ju, tu):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-9,
                                       err_msg=f"step {step}")
        jp = [p + u for p, u in zip(jp, ju)]
        tp = [p + u for p, u in zip(tp, tu)]


def test_weighted_param_avg_masks_zero_weight_clients():
    good = [[torch.tensor([1.0, 2.0])], [torch.tensor([3.0, 6.0])]]
    poisoned = [torch.tensor([float("nan"), float("inf")])]
    out = weighted_param_avg(good + [poisoned], [1.0, 3.0, 0.0])
    for client in out:
        np.testing.assert_allclose(client[0].numpy(), [2.5, 5.0])
    kept = weighted_param_avg(good, [0.0, 0.0])
    for client, local in zip(kept, good):
        assert client[0] is local[0]
    mean = get_strategy("grad_avg").sync_grads([[torch.tensor([1.0])], [torch.tensor([2.0])], [None]])
    assert len(mean) == 3 and float(mean[2][0]) == 1.0


@pytest.mark.parametrize("name", ["local", "grad_avg", "param_avg", "coordinator"])
def test_get_strategy_names_match_jax(name):
    jax_s, torch_s = jax_get_strategy(name), get_strategy(name)
    assert type(torch_s).__name__ == type(jax_s).__name__
    assert torch_s.name == jax_s.name
    assert torch_s.sync_grads_every_step == jax_s.sync_grads_every_step
    assert torch_s.sync_params_every_round == jax_s.sync_params_every_round


def test_get_strategy_rejects_unknown_names_as_jax_does():
    for get in (jax_get_strategy, get_strategy):
        with pytest.raises(ValueError, match="unknown federation strategy"):
            get("fedprox")


# --------------------------------------------------- data port-copies
def test_synthetic_data_and_batches_equal_jax():
    kw = dict(num_news=64, num_train=48, num_valid=8, title_len=12, his_len_range=(2, 10),
              seed=3, popular_frac=0.2)
    dj, dt = jax_make_synthetic_mind(**kw), make_synthetic_mind(**kw)
    np.testing.assert_array_equal(dt.news_tokens, dj.news_tokens)
    assert dt.nid2index == dj.nid2index
    assert dt.train_samples == dj.train_samples and dt.valid_samples == dj.valid_samples
    tk = dict(num_news=40, num_train=24, num_valid=4, title_len=6, bert_hidden=8, num_topics=5, seed=2)
    (tj, sj), (tt, st) = jax_make_synthetic_mind_topics(**tk), make_synthetic_mind_topics(**tk)
    np.testing.assert_array_equal(st, sj)
    assert tt.train_samples == tj.train_samples
    ij = jax_index_samples(dj.train_samples, dj.nid2index, 10)
    it = index_samples(dt.train_samples, dt.nid2index, 10)
    for f in ("pos", "neg_pools", "neg_lens", "history", "his_len", "uidx"):
        np.testing.assert_array_equal(getattr(it, f), getattr(ij, f))
    bj = JaxTrainBatcher(ij, 8, 4, seed=1)
    bt = TrainBatcher(it, 8, 4, seed=1)
    for epoch in (0, 1):
        pairs = list(zip(bj.epoch_batches_sharded(2, epoch), bt.epoch_batches_sharded(2, epoch)))
        pairs += list(zip(bj.epoch_batches(epoch), bt.epoch_batches(epoch)))
        assert pairs
        for a, b in pairs:
            for f in ("candidates", "history", "his_len", "labels"):
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


# ------------------------------------------ federated trajectories vs JAX
# "grad_avg" / "param_avg": the fused route, K=8 clients, history 10;
# "long_history": the unfused use_pallas route (flash attention and the
# pool kernel in the user tower), param_avg, K=2 clients, history 40
_TRAJ = {
    "grad_avg": ("grad_avg", dict(fuse_hot_path=True), 8, 10),
    "param_avg": ("param_avg", dict(fuse_hot_path=True), 8, 10),
    "long_history": ("param_avg", dict(fuse_hot_path=False, use_pallas=True), 2, 40),
}


def _port_cfg(route: dict, clients: int, his_len: int) -> ExperimentConfig:
    return ExperimentConfig().apply_overrides([
        "model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
        "model.bert_hidden=48", f"data.max_his_len={his_len}", "data.max_title_len=12",
        "data.batch_size=8", f"fed.num_clients={clients}", "model.text_encoder_mode=head",
        "model.dropout_rate=0.0", "optim.user_lr=3e-3", "optim.news_lr=3e-3",
        *(f"model.{k}={v}" for k, v in route.items()),
    ])


def _to_flax(module) -> dict:
    """The module's Linear layers as a Flax-shaped numpy tree (kernels (in, out))."""
    tree: dict = {}
    for name, layer in module.named_modules():
        if isinstance(layer, torch.nn.Linear):
            node = tree
            for key in name.split("."):
                node = node.setdefault(key, {})
            node["kernel"] = layer.weight.detach().numpy().T
            node["bias"] = layer.bias.detach().numpy()
    return tree


def _client_tree(stacked, c):
    take = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x[c]), tree)  # noqa: E731
    return {"user_encoder": take(stacked.user_params), "text_head": take(stacked.news_params)}


def _assert_tree_close(got, want, path=""):
    for key, sub in want.items():
        where = f"{path}.{key}" if path else key
        if isinstance(sub, dict):
            _assert_tree_close(got[key], sub, where)
        elif where.endswith(("w_k.bias", "att_fc2.bias")):
            assert float(np.abs(got[key] - sub).max()) < 1e-3, where
        else:
            np.testing.assert_allclose(got[key], sub, rtol=2e-4, atol=1e-4, err_msg=where)


@pytest.mark.parametrize("case", list(_TRAJ))
def test_fed_train_step_trajectory_matches_jax(case):
    strategy, route, k, his_len = _TRAJ[case]
    jcfg = small_cfg(optim__user_lr=3e-3, optim__news_lr=3e-3, model__text_encoder_mode="head",
                     model__dropout_rate=0.0, fed__num_clients=k, data__max_his_len=his_len,
                     **{f"model__{key}": v for key, v in route.items()})
    _, jbatcher, toks, jmodel, jstate, mesh = make_setup(jcfg, seed=0)
    jstep = jax_build_fed_train_step(jmodel, jcfg, jax_get_strategy(strategy), mesh, mode="joint")

    cfg = _port_cfg(route, k, his_len)
    model = NewsRecommender(cfg.model)
    from_flax(model, _client_tree(jstate, 0))
    states = replicate_state(init_client_state(model, cfg, seed=0), k)
    step = build_fed_train_step(model, cfg, get_strategy(strategy), device="cpu")
    table = torch.from_numpy(np.array(toks))

    for i, b in enumerate(jbatcher.epoch_batches_sharded(k, 0)):
        if i == 3:
            break
        jstate, jm = jstep(jstate, shard_batch(mesh, _batch_dict(b)), toks)
        states, m = step(states, _batch_dict(b), table)
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]).reshape(-1),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
        assert m["unique_overflow"] == 0
    if strategy == "param_avg":
        jstate = jax_build_param_sync(jcfg, mesh)(jstate, jnp.ones((k,), jnp.float32))
        states = build_param_sync(cfg)(states, np.ones(k))
    for c in sorted({0, min(5, k - 1)}):
        _assert_tree_close(_to_flax(states[c].model), _client_tree(jstate, c))
