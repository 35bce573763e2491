"""Port parity for per-example DP-SGD (CPU): ``per_example_dp_grads``
against the JAX step's per-example loss under ``per_example_clipped_grads``,
the kernels' ``vmap`` rules (kernels A and F1-F3 folded into their rows,
launched a constant number of times whatever B, a mapped weight refused),
the clip bound, the noise's statistics, a 3-step federated trajectory
against the JAX step at sigma = 1e-9, ``dp_scope='user'`` freezing the text
head and its Adam state to the bit, the bitwise repeat, the refusals with
the JAX package's wording, and the run CLI's ``--mode joint --dp-epsilon``.

Tolerances: per-example clipped gradients rtol 1e-5 / atol 1e-6 (f32 sums in
another order); trajectories ``tests/test_torch_train.py``'s bars (losses
rtol 1e-5 / atol 1e-6, parameters rtol 2e-4 / atol 1e-4, the two leaves
with a true gradient of zero at 1e-3), stepped with SGD (the test says
why). The noise at sigma = 1e-9 has std sigma C / B = 2.5e-10, far under
those bars.
"""

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrec_tpu.fed import get_strategy as jax_get_strategy
from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
from fedrec_tpu.models import score_loss as jax_score_loss
from fedrec_tpu.parallel import shard_batch
from fedrec_tpu.parallel.mesh import fed_mesh
from fedrec_tpu.privacy.dpsgd import clip_by_global_norm_per_example as jax_clip
from fedrec_tpu.privacy.dpsgd import per_example_clipped_grads as jax_per_example_clipped_grads
from fedrec_tpu.train import build_fed_train_step as jax_build_fed_train_step
from fedrec_tpu.train import build_param_sync as jax_build_param_sync
from fedrec_tpu_torch.config import ExperimentConfig, PrivacyConfig
from fedrec_tpu_torch.fed import get_strategy
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.ops import attention_kernels as ak
from fedrec_tpu_torch.params import from_flax, init_params
from fedrec_tpu_torch.privacy import clip_by_global_norm_per_example, make_noise_fn
from fedrec_tpu_torch.privacy import per_example_clipped_grads
from fedrec_tpu_torch.train import build_fed_train_step, build_param_sync, init_client_state
from fedrec_tpu_torch.train import replicate_state
from fedrec_tpu_torch.train.step import per_example_dp_grads

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train import _assert_tree_close, _client_tree, _to_flax  # noqa: E402
from test_train import _batch_dict, make_setup, small_cfg  # noqa: E402

_WIDTHS = ["model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
           "model.bert_hidden=48", "data.max_his_len=10", "data.max_title_len=12",
           "data.batch_size=8", "model.text_encoder_mode=head"]


def _cfg(*over) -> ExperimentConfig:
    return ExperimentConfig().apply_overrides([*_WIDTHS, "model.dropout_rate=0.0",
                                               "privacy.enabled=1", "privacy.sigma=1e-9", *over])


def _grads_tree(module, grads) -> dict:
    """A port gradient list (``parameters()`` order) as a Flax-shaped tree."""
    tree: dict = {}
    for (name, _), g in zip(module.named_parameters(), grads):
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node["kernel" if leaf == "weight" else "bias"] = g.detach().numpy().T
    return tree


def _close(got: dict, want, path=""):
    for key, sub in want.items():
        where = f"{path}.{key}" if path else key
        if isinstance(sub, dict):
            _close(got[key], sub, where)
        else:
            np.testing.assert_allclose(got[key], np.asarray(sub), rtol=1e-5, atol=1e-6,
                                       err_msg=where)


@pytest.fixture(scope="module")
def setup():
    jcfg = small_cfg(model__dropout_rate=0.0)
    _, batcher, toks, jmodel, jstate, _ = make_setup(jcfg, seed=0)
    batch = _batch_dict(next(iter(batcher.epoch_batches_sharded(8, 0))))
    return jcfg, jmodel, jstate, toks, batch


@pytest.mark.parametrize("clip_norm", [0.05, 2.0, 1e3])
def test_per_example_clipped_grads_match_jax(setup, clip_norm):
    """Client 0's batch through both estimators (dp_scope='all'): the mean
    loss, both towers' clipped mean gradients, the clip-rate and the
    largest pre-clip norm."""
    jcfg, jmodel, jstate, toks, batch = setup
    cand, hist, lab = (batch[k][0] for k in ("candidates", "history", "labels"))
    c = cand.shape[1]
    table = jnp.asarray(toks)

    def per_example_loss(packed, cand_row, his_row, label):
        user_params, news_params = packed
        vecs = jmodel.apply({"params": {"text_head": news_params}},
                            table[jnp.concatenate([cand_row, his_row])],
                            method=JaxNewsRecommender.encode_news)
        scores = jmodel.apply({"params": {"user_encoder": user_params}}, vecs[:c][None],
                              vecs[c:][None], train=False)
        return jax_score_loss(scores, label[None], True)

    params = jax.tree_util.tree_map(lambda x: x[0], (jstate.user_params, jstate.news_params))
    jloss, (jug, jng), jstats = jax_per_example_clipped_grads(
        per_example_loss, params, (jnp.asarray(cand), jnp.asarray(hist), jnp.asarray(lab)),
        clip_norm, with_stats=True)

    model = NewsRecommender(_cfg().model)
    from_flax(model, _client_tree(jstate, 0))
    loss, ug, ng, stats = per_example_dp_grads(
        model, torch.from_numpy(np.array(toks)), torch.from_numpy(cand), torch.from_numpy(hist),
        torch.from_numpy(lab), clip_norm)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
    _close(_grads_tree(model.user_encoder, ug), jug)
    _close(_grads_tree(model.text_head, ng), jng)
    assert float(stats["clip_rate"]) == float(jstats["clip_rate"])
    np.testing.assert_allclose(float(stats["max_norm"]), float(jstats["max_norm"]), rtol=1e-5)


def test_clip_bounds_every_example_and_matches_jax():
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((8, 4, 3)).astype(np.float32) * 10,
             "b": rng.standard_normal((8, 5)).astype(np.float32) * 10,
             "c": np.full((8, 2), 0.01, np.float32)}
    grads["a"][3] *= 1e-4
    grads["b"][3] *= 1e-4
    got = clip_by_global_norm_per_example({k: torch.from_numpy(v) for k, v in grads.items()}, 1.0)
    want = jax_clip({k: jnp.asarray(v) for k, v in grads.items()}, 1.0)
    norms = np.sqrt(sum(np.square(v.numpy()).reshape(8, -1).sum(1) for v in got.values()))
    assert (norms <= 1.0 + 1e-6).all()
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    # an example under the bound passes through unscaled
    np.testing.assert_array_equal(got["c"][3].numpy(), grads["c"][3])


def test_clip_rate_and_max_norm_are_exact():
    """``tests/test_obs_health.py``'s pin: norms (1, 1, 3, 5) against C=2
    clip 2 of 4; the clipped mean is (1 - 1 + 2 + 2) / 4."""
    loss, g, stats = per_example_clipped_grads(
        lambda w, x: w * x, torch.tensor(1.0), (torch.tensor([1.0, -1.0, 3.0, 5.0]),),
        clip_norm=2.0, with_stats=True)
    assert float(stats["clip_rate"]) == 0.5 and float(stats["max_norm"]) == 5.0
    assert float(g) == pytest.approx(1.0) and float(loss) == 2.0


def test_dpsgd_noise_statistics():
    """N(0, (sigma C / B)^2) on every element of every part."""
    noise_fn = make_noise_fn(PrivacyConfig(enabled=True, sigma=2.0, clip_norm=3.0), 4)
    std = 2.0 * 3.0 / 4
    parts = noise_fn(([torch.zeros(4000)], [torch.zeros(2000), torch.zeros(50, 40)]),
                     torch.Generator().manual_seed(0))
    for part in parts:
        for arr in part:
            arr = arr.numpy().ravel()
            assert abs(arr.std() - std) < 0.1 * std
            assert abs(arr.mean()) < 4 * std / math.sqrt(arr.size)


# --------------------------------------------------- the kernels' vmap rules
@pytest.fixture
def kernel_route(monkeypatch):
    """Kernels A and F1-F3 through their autograd functions on CPU tensors,
    each launcher swapped for its plain version and counted: the route a
    CUDA tensor takes, with the vmap rules in it."""
    calls: dict[str, list] = {"A": [], "F1": [], "F2": [], "F3": []}

    def counted(name, fn):
        def launch(*args):
            assert not any(torch._C._functorch.is_functorch_wrapped_tensor(t)
                           for t in args if torch.is_tensor(t)), f"{name}: a mapped tensor"
            calls[name].append(tuple(args[0].shape))
            return fn(*args)
        return launch

    monkeypatch.setattr(ak, "_launch", counted("A", ak.additive_pool_plain))
    monkeypatch.setattr(ak, "_launch_flash_fwd", counted("F1", ak.flash_forward_plain))
    monkeypatch.setattr(ak, "_launch_flash_dq", counted("F2", ak.flash_backward_dq_plain))
    monkeypatch.setattr(ak, "_launch_flash_dkv", counted("F3", ak.flash_backward_dkv_plain))
    monkeypatch.setattr(ak, "_pool", lambda x, w1, b1, w2, mask, long: ak._Pool.apply(
        x, w1, b1, w2, mask, long))
    monkeypatch.setattr(ak, "_flash", lambda q, k, v, bias: ak._Flash.apply(q, k, v, bias)[0])
    return calls


def _route_grads(use_pallas: bool, b: int, clip_norm: float = 2.0):
    cfg = _cfg(f"model.use_pallas={int(use_pallas)}", "model.attn_impl=" +
               ("auto" if use_pallas else "dense"))
    model = init_params(NewsRecommender(cfg.model), seed=0)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.standard_normal((64, 12, 48)).astype(np.float32))
    cand = torch.from_numpy(rng.integers(1, 64, (b, 5)))
    hist = torch.from_numpy(rng.integers(0, 64, (b, 10)))
    lab = torch.zeros(b, dtype=torch.int64)
    return model, per_example_dp_grads(model, toks, cand, hist, lab, clip_norm)


def test_kernel_route_per_example_grads_equal_the_dense_route(kernel_route):
    """vmap(grad) through kernels A (both pools) and F1-F3 (the user
    tower's attention): the clipped mean gradients equal the dense route's,
    and every kernel launched on whole batches only."""
    model, (loss_k, ug_k, ng_k, st_k) = _route_grads(True, 8)
    _, (loss_d, ug_d, ng_d, st_d) = _route_grads(False, 8)
    np.testing.assert_allclose(float(loss_k), float(loss_d), rtol=1e-5, atol=1e-6)
    for (name, _), a, b in zip(model.named_parameters(), ug_k + ng_k, ug_d + ng_d):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(st_k["clip_rate"]) == float(st_d["clip_rate"])
    # one A launch on the 8 x 15 candidate-and-history rows (the examples
    # one more leading axis), one on the 8 user-tower rows; F1 on the 8 x 4
    # head rows; F2, F3 once each
    assert kernel_route["A"] == [(8, 15, 12, 48), (8, 1, 10, 32)]
    assert kernel_route["F1"] == [(32, 10, 8)]
    assert kernel_route["F2"] == [(32, 10, 8)] and kernel_route["F3"] == [(32, 10, 8)]


def test_kernel_launches_are_constant_in_the_batch(kernel_route):
    counts = {}
    for b in (2, 4, 16):
        for v in kernel_route.values():
            v.clear()
        _route_grads(True, b)
        counts[b] = {k: len(v) for k, v in kernel_route.items()}
        assert kernel_route["F1"] == [(b * 4, 10, 8)]
    assert counts[2] == counts[4] == counts[16] == {"A": 2, "F1": 1, "F2": 1, "F3": 1}


def test_a_mapped_weight_raises_rather_than_run_a_plain_version(kernel_route):
    x = torch.randn(3, 5, 7, 8)
    w1, b1, w2 = torch.randn(3, 8, 6), torch.randn(6), torch.randn(6)
    with pytest.raises(ValueError, match=r"operand 1 of shape \(3, 8, 6\) is mapped"):
        torch.func.vmap(lambda x, w: ak._Pool.apply(x, w, b1, w2, None))(x, w1)
    assert not kernel_route["A"]


def test_flash_folds_every_mapped_operand(kernel_route):
    """F1-F3 have no weights: a per-example key bias folds with q, k, v."""
    q = torch.randn(3, 4, 9, 8)
    bias = torch.where(torch.rand(3, 4, 9) > 0.3, 0.0, -1e9)
    got = torch.func.vmap(lambda q, b: ak._Flash.apply(q, q, q, b)[0])(q, bias)
    want = ak.flash_forward_plain(q.reshape(12, 9, 8), q.reshape(12, 9, 8),
                                  q.reshape(12, 9, 8), bias.reshape(12, 9))[0]
    torch.testing.assert_close(got, want.reshape(3, 4, 9, 8))
    assert kernel_route["F1"] == [(12, 9, 8)]


def test_a_mapped_mask_folds_with_the_rows(kernel_route):
    x = torch.randn(3, 5, 7, 8)
    mask = (torch.rand(3, 5, 7) > 0.3).float()
    w1, b1, w2 = torch.randn(8, 6) * 0.3, torch.randn(6) * 0.1, torch.randn(6) * 0.3
    got = torch.func.vmap(lambda x, m: ak._Pool.apply(x, w1, b1, w2, m))(x, mask)
    want = ak.additive_pool_plain(x, w1, b1, w2, mask)
    torch.testing.assert_close(got, want)
    assert kernel_route["A"] == [(3, 5, 7, 8)]


# ------------------------------------------------------------ the DP step
def test_dpsgd_trajectory_matches_jax():
    """Three param_avg steps of K=2 clients under dpsgd at sigma 1e-9,
    then the round-end mean: losses per step and every client's
    parameters at the trajectory bars. SGD, as the JAX package's own
    sigma -> 0 pin (``tests/test_privacy.py``) takes it: the two leaves with
    a true gradient of zero get per-example float noise of ~1e-8, which
    Adam (eps 1e-8) turns into steps of up to lr in either direction; the
    optimizer chains are pinned against optax elsewhere."""
    k = 2
    jcfg = small_cfg(optim__user_lr=3e-2, optim__news_lr=3e-2, model__dropout_rate=0.0,
                     fed__num_clients=k, optim__optimizer="sgd")
    jcfg.privacy.enabled, jcfg.privacy.sigma = True, 1e-9
    _, batcher, toks, jmodel, jstate, _ = make_setup(jcfg, seed=0)
    from fedrec_tpu.parallel import client_mesh

    mesh = client_mesh(k)
    jstep = jax_build_fed_train_step(jmodel, jcfg, jax_get_strategy("param_avg"), mesh,
                                     mode="joint")
    cfg = _cfg(f"fed.num_clients={k}", "optim.user_lr=3e-2", "optim.news_lr=3e-2",
               "optim.optimizer=sgd")
    model = NewsRecommender(cfg.model)
    from_flax(model, _client_tree(jstate, 0))
    states = replicate_state(init_client_state(model, cfg, seed=0), k)
    step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device="cpu")
    table = torch.from_numpy(np.array(toks))
    for i, b in enumerate(batcher.epoch_batches_sharded(k, 0)):
        if i == 3:
            break
        jstate, jm = jstep(jstate, shard_batch(mesh, _batch_dict(b)), toks)
        states, m = step(states, _batch_dict(b), table)
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]).reshape(-1),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
        np.testing.assert_allclose(m["health.clip_rate"].numpy(),
                                   np.asarray(jm["health.clip_rate"]).reshape(-1))
        assert m["unique_overflow"] == 0
    jstate = jax_build_param_sync(jcfg, mesh)(jstate, jnp.ones((k,), jnp.float32))
    states = build_param_sync(cfg)(states, np.ones(k))
    for c in range(k):
        _assert_tree_close(_to_flax(states[c].model), _client_tree(jstate, c))


def _dp_run(*over, steps: int = 2):
    cfg = _cfg("fed.num_clients=2", "privacy.sigma=0.5", *over)
    model = init_params(NewsRecommender(cfg.model), seed=0)
    states = replicate_state(init_client_state(model, cfg, seed=0), 2)
    step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.standard_normal((64, 12, 48)).astype(np.float32))
    before = [[p.detach().clone() for p in st.news_params()] for st in states]
    ms = []
    for _ in range(steps):
        batch = {"candidates": rng.integers(1, 64, (2, 8, 5)),
                 "history": rng.integers(0, 64, (2, 8, 10)), "labels": np.zeros((2, 8))}
        states, m = step(states, batch, toks)
        ms.append(m)
    return states, before, ms


def test_dp_scope_user_freezes_the_head_and_its_adam_state():
    states, before, ms = _dp_run("privacy.dp_scope=user")
    for st, head in zip(states, before):
        assert all(torch.equal(p, q) for p, q in zip(st.news_params(), head))
        assert st.opt_news.count == 0
        assert all(not m.any() for m in st.opt_news.mu + st.opt_news.nu)
        assert st.opt_user.count == 2
    assert all(torch.isfinite(m["health.grad_norm"]).all() for m in ms)
    # dp_scope='all' moves the head
    states, before, _ = _dp_run()
    assert not all(torch.equal(p, q) for p, q in zip(states[0].news_params(), before[0]))


def test_dp_step_repeats_bitwise_with_dropout_on():
    runs = [_dp_run("model.dropout_rate=0.2")[0] for _ in range(2)]
    for a, b in zip(*runs):
        assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
        assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_dp_step_reports_the_clip_rate():
    _, _, ms = _dp_run("privacy.clip_norm=1e-6", steps=1)
    assert torch.equal(ms[0]["health.clip_rate"], torch.ones(2))
    assert (ms[0]["health.clip_max_norm"] > 0).all()


@pytest.mark.parametrize("case", ["fuse", "decoupled", "scope_unknown", "scope_user_ldp",
                                  "seq_shards", "shard_table"])
def test_dp_refusals_match_jax_word_for_word(case):
    over = {"fuse": dict(model__fuse_hot_path=True),
            "decoupled": dict(model__text_encoder_mode="table"),
            "scope_unknown": dict(privacy__dp_scope="everything"),
            "scope_user_ldp": dict(privacy__dp_scope="user", privacy__mechanism="ldp_news"),
            "seq_shards": dict(fed__seq_shards=2, fed__num_clients=2),
            "shard_table": dict()}[case]
    jcfg = small_cfg(**{"model__text_encoder_mode": "head", "privacy__enabled": True,
                        "privacy__sigma": 1.0, **over})
    mode = "decoupled" if case == "decoupled" else "joint"
    mesh = fed_mesh(jcfg)
    kw = {"sharded_table": object()} if case == "shard_table" else {}
    with pytest.raises((NotImplementedError, ValueError)) as want:
        jax_build_fed_train_step(JaxNewsRecommender(jcfg.model), jcfg,
                                 jax_get_strategy("param_avg"), mesh, mode=mode, **kw)
    cfg = _cfg(*(f"{k.replace('__', '.')}={v}" for k, v in over.items()),
               *(["shard.table=1"] if case == "shard_table" else []))
    with pytest.raises(type(want.value)) as got:
        build_fed_train_step(NewsRecommender(cfg.model), cfg, get_strategy("param_avg"),
                             mode=mode, device="cpu")
    assert str(got.value) == str(want.value)


def test_run_cli_joint_dp_epsilon_runs_dpsgd(tmp_path, capsys):
    from fedrec_tpu_torch.cli import run

    argv = ["1", "8", "1", "--synthetic", "--synthetic-news", "64", "--synthetic-train", "64",
            "--clients", "2", "--device", "cpu", "--mode", "joint", "--dp-epsilon", "10",
            *(a for w in _WIDTHS[:7] for a in ("--set", w)), "--set", "train.snapshot_dir="]
    assert run.main(argv) == 0
    captured = capsys.readouterr()
    assert "ldp_news" not in captured.err and "sigma=" in captured.err
    final = [ln for ln in captured.out.splitlines() if ln.startswith("final: ")]
    fields = dict(kv.split("=") for kv in final[0].removeprefix("final: ").split())
    assert np.isfinite(float(fields["loss"])) and 0.0 <= float(fields["auc"]) <= 1.0
