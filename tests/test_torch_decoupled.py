"""Port parity for decoupled ("table") mode and the ldp_news noise path (CPU):
the decoupled train step and the epoch-end news update against the JAX
package's ``build_fed_train_step(mode="decoupled")`` and
``build_news_update_step`` on the fake CPU devices of ``tests/conftest.py``;
the per-id scatter; the trainer's table (client 0's feeds every client's
next epoch); the port's ``Trainer`` against the JAX ``Trainer``; bitwise
resume with dropout and noise on; the ldp_news hook; the accountant copy and
the artifact loader.

Tolerances, as in ``tests/test_torch_train.py``: losses and the
accumulators rtol 1e-5 / atol 1e-6 (the same f32 products summed in
another order; the port sums a batch's rows per id before adding them to
the accumulator, JAX adds them one by one), parameters and tables rtol
2e-4 / atol 1e-4 (the two leaves with a true gradient of zero at a 1e-3
noise bound). The accountant is the same float64 arithmetic: rtol 1e-12.
"""

import copy
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from fedrec_tpu.config import PrivacyConfig as JaxPrivacyConfig
from fedrec_tpu.data import load_mind_artifacts as jax_load_mind_artifacts
from fedrec_tpu.fed import get_strategy as jax_get_strategy
from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
from fedrec_tpu.parallel import client_mesh, shard_batch
from fedrec_tpu.privacy import accountant as jax_accountant
from fedrec_tpu.train import build_fed_train_step as jax_build_fed_train_step
from fedrec_tpu.train import build_news_update_step as jax_build_news_update_step
from fedrec_tpu.train import build_param_sync as jax_build_param_sync
from fedrec_tpu.train import encode_all_news as jax_encode_all_news
from fedrec_tpu.train.trainer import Trainer as JaxTrainer
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.data import load_mind_artifacts, make_synthetic_mind
from fedrec_tpu_torch.fed import get_strategy
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.params import from_flax
from fedrec_tpu_torch.privacy import accountant, make_ldp_news_noise_fn, make_noise_fn
from fedrec_tpu_torch.train import (
    Trainer,
    build_fed_train_step,
    build_news_update_step,
    build_param_sync,
    encode_all_news,
    init_client_state,
    replicate_state,
    scatter_add_rows,
)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train import _assert_tree_close, _client_tree, _to_flax  # noqa: E402
from test_torch_trainer import (  # noqa: E402
    _assert_round,
    _check_eval_margins,
    _client_bits,
    _data_and_tokens,
    _jax_round,
    _port_cfg,
)
from test_train import _batch_dict, make_setup, small_cfg  # noqa: E402
from test_trainer import tiny_cfg, tiny_data  # noqa: E402

_K = 2
_STEPS = 3
_B1, _ADAM_EPS = 0.9, 1e-8
_ZERO_GRAD = ("self_attn.w_k.bias", "att_fc2.bias")


class _EpsRegime:
    """Which parameter elements one of Adam's steps saw a gradient under
    10x Adam's epsilon, read back from the client's first moments
    (``g = (mu_t - b1 mu_t-1) / (1 - b1)``). There Adam's update is
    ``lr g / (|g| + eps)``: the gradient's last-bit noise, relative to a
    value that cancelled to ~1e-9, becomes a parameter difference of a
    fraction of the learning rate. (Seen here: in interpret mode JAX's fused
    kernel gives client 0's user-pool ``att_fc1.bias[0]`` 8.5e-10 on the
    first batch, where float64 gives 1.40e-9 and the port 1.42e-9; one Adam
    step later the parameters are 1.35e-4 apart.) Such elements compare at
    the noise bound of the leaves whose gradient is zero in theory."""

    def __init__(self, st):
        self.st, self.mask = st, {}
        self.prev = self._moments()

    def _moments(self) -> dict:
        out = {}
        for part, opt, module in (("user_encoder", self.st.opt_user, self.st.model.user_encoder),
                                  ("text_head", self.st.opt_news, self.st.model.text_head)):
            for (name, _), mu in zip(module.named_parameters(), opt.mu):
                out[f"{part}.{name}"] = (opt.count, mu.clone())
        return out

    def update(self) -> None:
        now = self._moments()
        for name, (count, mu) in now.items():
            prev_count, prev = self.prev[name]
            if count == prev_count:
                continue  # this tower did not step
            g = (mu - _B1 * prev) / (1 - _B1)
            small = g.abs() < 10 * _ADAM_EPS
            self.mask[name] = self.mask.get(name, torch.zeros_like(small)) | small
        self.prev = now

    @staticmethod
    def union(regimes):
        out = _EpsRegime.__new__(_EpsRegime)
        out.mask = {}
        for r in regimes:
            for name, m in r.mask.items():
                out.mask[name] = out.mask.get(name, torch.zeros_like(m)) | m
        return out


def _assert_params_close(model, jax_tree: dict, regime: _EpsRegime) -> None:
    """Parameters at rtol 2e-4 / atol 1e-4; the zero-gradient leaves and
    the elements in Adam's epsilon regime within the 1e-3 noise bound."""
    ref = copy.deepcopy(model)
    from_flax(ref, jax_tree)
    for (name, p), q in zip(model.named_parameters(), ref.parameters(), strict=True):
        diff = (p - q).abs().detach()
        noise = regime.mask.get(name, torch.zeros_like(diff, dtype=torch.bool))
        if name.endswith(_ZERO_GRAD):
            noise = torch.ones_like(noise)
        assert float(diff[noise].max()) < 1e-3 if noise.any() else True, name
        bar = 1e-4 + 2e-4 * q.abs().detach()
        assert bool((diff[~noise] <= bar[~noise]).all()), (
            f"{name}: {float((diff - bar)[~noise].max())} over the bar")


def _cfg(strategy: str, **over) -> ExperimentConfig:
    return ExperimentConfig().apply_overrides([
        "model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
        "model.bert_hidden=48", "data.max_his_len=10", "data.max_title_len=12",
        "data.batch_size=8", f"fed.num_clients={_K}", "model.text_encoder_mode=table",
        "model.dropout_rate=0.0", "optim.user_lr=3e-3", "optim.news_lr=3e-3",
        "model.fuse_hot_path=true", "model.use_pallas=true", f"fed.strategy={strategy}",
        "train.snapshot_dir=", *(f"{k}={v}" for k, v in over.items()),
    ])


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


# ----------------------------------------------- the step against JAX
@pytest.mark.parametrize("strategy", ["grad_avg", "param_avg"])
def test_decoupled_steps_and_news_updates_match_jax(strategy):
    """Two epochs of 3 steps on the fused route, each ended by the news
    update, every client's next epoch on client 0's table (the trainer's
    rule); then the round-end mean. Losses each step, the accumulators
    before the first update, parameters and tables after each update
    (``_assert_params_close``: Adam's epsilon regime).

    ``local`` and ``param_avg`` run the same steps and news updates (neither
    syncs gradients) and part only at the round-end mean, so the
    ``param_avg`` case is ``local``'s too: its clients are compared before
    the mean (where ``local``'s run ends: its sync leaves them as they are),
    and again after it."""
    jcfg = small_cfg(optim__user_lr=3e-3, optim__news_lr=3e-3, model__text_encoder_mode="table",
                     model__dropout_rate=0.0, model__fuse_hot_path=True,
                     model__use_pallas=True, fed__num_clients=_K)
    _, jbatcher, toks, jmodel, jstate, mesh = make_setup(jcfg, seed=0)
    # the step's output layout, so that its second call does not recompile
    jstate = jax.device_put(jstate, NamedSharding(mesh, PartitionSpec(jcfg.fed.mesh_axis)))
    jstrat = jax_get_strategy(strategy)
    jstep = jax_build_fed_train_step(jmodel, jcfg, jstrat, mesh, mode="decoupled")
    jupdate = jax_build_news_update_step(jmodel, jcfg, mesh, jstrat)
    jtable = jax_encode_all_news(jmodel, jax.tree_util.tree_map(lambda x: x[0], jstate.news_params),
                                 toks)

    cfg = _cfg(strategy)
    model = NewsRecommender(cfg.model)
    from_flax(model, _client_tree(jstate, 0))
    states = replicate_state(init_client_state(model, cfg), _K)
    strat = get_strategy(strategy)
    step = build_fed_train_step(model, cfg, strat, device="cpu")
    update = build_news_update_step(model, cfg, strat, device="cpu")
    token_states = torch.from_numpy(np.array(toks))
    table = encode_all_news(model, token_states, device="cpu")
    _close(table, jtable, 2e-4, 1e-4, "first table")
    tiny = [_EpsRegime(st) for st in states]

    for epoch in range(2):
        for i, b in enumerate(jbatcher.epoch_batches_sharded(_K, epoch)):
            if i == _STEPS:
                break
            jstate, jm = jstep(jstate, shard_batch(mesh, _batch_dict(b)), jtable)
            states, m = step(states, _batch_dict(b), table)
            _close(m["loss"], np.asarray(jm["loss"]).reshape(-1), 1e-5, 1e-6,
                   f"epoch {epoch} step {i}")
            assert m["unique_overflow"] == 0
            for t in tiny:
                t.update()
        if epoch == 0:
            for c, st in enumerate(states):
                _close(st.news_grad_accum, jstate.news_grad_accum[c], 1e-5, 1e-6,
                       f"client {c} accumulator")
                assert float(st.news_grad_accum.abs().max()) > 0
        jstate, jtables = jupdate(jstate, toks)
        states, tables = update(states, token_states)
        for c, st in enumerate(states):
            tiny[c].update()
            assert float(st.news_grad_accum.abs().max()) == 0.0
            _close(tables[c], jtables[c], 2e-4, 1e-4, f"epoch {epoch} client {c} table")
            _assert_params_close(st.model, _client_tree(jstate, c), tiny[c])
        jtable, table = jtables[0], tables[0]
    if strategy == "grad_avg":  # the head gradient is averaged: the heads stay in lockstep
        for p, q in zip(states[0].news_params(), states[1].news_params()):
            assert torch.equal(p, q)
        return
    # local: the heads diverged, yet every client trained on client 0's table
    assert not torch.equal(tables[0], tables[1])
    before = [[p.clone() for p in st.model.parameters()] for st in states]
    build_param_sync(cfg, get_strategy("local"))(states, np.ones(_K))
    assert all(torch.equal(p, q) for st, ps in zip(states, before)
               for p, q in zip(st.model.parameters(), ps))
    jstate = jax_build_param_sync(jcfg, mesh, jstrat)(jstate, jnp.ones((_K,), jnp.float32))
    states = build_param_sync(cfg, strat)(states, np.ones(_K))
    for c in range(_K):
        # the mean mixes the clients: an element is in the regime where any
        # client's was
        _assert_params_close(states[c].model, _client_tree(jstate, c), _EpsRegime.union(tiny))


def test_decoupled_step_reaches_the_gathered_vectors_through_the_kernel_route():
    """The fused route's gradients of the candidate and history vectors
    (kernel E's dcand and dx, through dropout) equal the dense route's."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((40, 32)).astype(np.float32))
    batch = {"candidates": rng.integers(0, 40, (1, 8, 5)),
             "history": rng.integers(0, 40, (1, 8, 10)), "labels": np.zeros((1, 8), np.int64)}
    out = {}
    for fused in (True, False):
        cfg = _cfg("param_avg", **{"model.dropout_rate": 0.2,
                                   "model.fuse_hot_path": str(fused).lower()})
        model = NewsRecommender(cfg.model)
        torch.manual_seed(0)
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.2)
        states = replicate_state(init_client_state(model, cfg), 1)
        step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device="cpu")
        step(states, batch, table)
        out[fused] = states[0].news_grad_accum
    assert float(out[True].abs().max()) > 0
    _close(out[True], out[False], 1e-5, 1e-6, "accumulator, fused vs dense route")


# ------------------------------------------------------------ the scatter
def test_scatter_add_rows_equals_np_add_at_and_repeats_to_the_bit():
    rng = np.random.default_rng(5)
    ids = np.concatenate([rng.integers(1, 30, 200), np.zeros(50, np.int64),
                          rng.integers(0, 30, 40)])  # duplicates; 0 = history padding
    rng.shuffle(ids)
    # integer-valued rows: every order of the sum is exact, so equal to the bit
    ints = rng.integers(-50, 50, (ids.size, 6)).astype(np.float32)
    base = rng.integers(-50, 50, (40, 6)).astype(np.float32)
    want = base.copy()
    np.add.at(want, ids, ints)
    got = torch.from_numpy(base.copy())
    scatter_add_rows(got, torch.from_numpy(ids), torch.from_numpy(ints))
    np.testing.assert_array_equal(got.numpy(), want)
    # real-valued rows: np.add.at in float64, then the f32 sums within 1e-6
    rows = rng.standard_normal((ids.size, 6)).astype(np.float32)
    want = base.astype(np.float64)
    np.add.at(want, ids, rows.astype(np.float64))
    got = torch.from_numpy(base.copy())
    scatter_add_rows(got, torch.from_numpy(ids), torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    again = torch.from_numpy(base.copy())
    scatter_add_rows(again, torch.from_numpy(ids), torch.from_numpy(rows))
    assert torch.equal(got, again)
    untouched = np.setdiff1d(np.arange(40), ids)
    assert untouched.size and np.array_equal(got.numpy()[untouched], base[untouched])


# ------------------------------------------------------- the trainer's table
def test_every_client_trains_its_next_epoch_on_client_0s_table(monkeypatch):
    """Under ``local`` the heads diverge at each news update, yet every
    client's next epoch reads client 0's new table (JAX trainer.py:2674-2678);
    evaluation and the export reuse the cached table, and a client other
    than 0 evaluated alone gets its own fresh encode."""
    cfg = _port_cfg(tiny_cfg(None, fed__strategy="local", fed__rounds=1, fed__local_epochs=2,
                             model__text_encoder_mode="table"))
    data, toks = _data_and_tokens(cfg)
    t = Trainer(cfg, data, toks, device="cpu")
    seen, made = [], []
    step, update = t.train_step, t.news_update

    def spy_step(states, batch, table):
        seen.append(table)
        return step(states, batch, table)

    def spy_update(states, token_states):
        states, tables = update(states, token_states)
        made.append(tables)
        return states, tables

    monkeypatch.setattr(t, "train_step", spy_step)
    monkeypatch.setattr(t, "news_update", spy_update)
    t.run()
    epochs = len(seen) // 2
    assert len(made) == 2 and not torch.equal(made[0][0], made[0][1])
    assert all(tab is made[0][0] for tab in seen[epochs:])
    assert t._table is made[1][0]              # local: no round-end refresh
    encode = []
    monkeypatch.setattr(t, "_encode_states", lambda c: encode.append(c) or made[1][c])
    assert t._corpus_for(0) is made[1][0] and t.export_for_serving()[1] is made[1][0]
    assert t._corpus_for(1) is made[1][1] and encode == [1]


# ------------------------------------------------------- Trainer against JAX
def test_trainer_matches_jax_in_decoupled_mode():
    """K=8, three rounds of two local epochs, each evaluated on the full
    pool: round losses, metrics where the margins hold, final parameters
    and the export's table."""
    jcfg = tiny_cfg(None, model__text_encoder_mode="table", model__dropout_rate=0.0,
                    model__fuse_hot_path=True, model__use_pallas=True, optim__user_lr=3e-3,
                    optim__news_lr=3e-3, fed__num_clients=8, fed__rounds=3,
                    fed__local_epochs=2, train__eval_every=1)
    data, toks = tiny_data(jcfg)
    pt = Trainer(_port_cfg(jcfg), data, toks, device="cpu")
    jcfg.train.eval_every = 10**6
    jt = JaxTrainer(jcfg, data, toks)
    up, np_ = jax.tree_util.tree_map(np.asarray, jt._client0_params())
    pt.set_global_params(up, np_)
    for r in range(3):
        _assert_round(_jax_round(jt, r, "full"), pt.train_round(r), f"round {r}")
        _check_eval_margins(jt, pt)
    for c in (0, 5):
        _assert_tree_close(_to_flax(pt.states[c].model), _client_tree(jt.state, c))
    # JAX's export is its cached table (its eager in-sync check is skipped:
    # see _jax_round)
    _close(pt.export_for_serving()[1], jt._table, 2e-4, 1e-4, "export table")


# ------------------------------------------------------------------ resume
def test_resume_is_bitwise_in_decoupled_mode_with_dropout_and_noise(tmp_path):
    """2 rounds of 2 local epochs, then a fresh Trainer resumes round 2:
    loss, metrics, parameters, optimizer states, both generators and the
    table equal a straight 3-round run's to the bit; the accumulators are
    zero at every round end, which is why a snapshot leaves them out."""
    over = dict(fed__local_epochs=2, model__dropout_rate=0.2, privacy__enabled=True,
                privacy__mechanism="ldp_news", privacy__sigma=0.5,
                model__text_encoder_mode="table")

    def cfg(where, rounds):
        c = _port_cfg(tiny_cfg(where, fed__rounds=rounds, **over))
        c.privacy.enabled, c.privacy.mechanism, c.privacy.sigma = True, "ldp_news", 0.5
        return c

    data, toks = _data_and_tokens(cfg(None, 3))
    straight = Trainer(cfg(tmp_path / "a", 3), data, toks, device="cpu")
    hist_a = straight.run()
    for st in straight.states:
        assert st.news_grad_accum is not None and float(st.news_grad_accum.abs().max()) == 0.0
    Trainer(cfg(tmp_path / "b", 2), data, toks, device="cpu").run()
    resumed = Trainer(cfg(tmp_path / "b", 3), data, toks, device="cpu")
    assert resumed.start_round == 2
    (last,) = resumed.run()
    assert last.train_loss == hist_a[2].train_loss and last.val_metrics == hist_a[2].val_metrics
    for a, b in zip(_client_bits(straight), _client_bits(resumed), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(straight.states, resumed.states):
        assert torch.equal(a.noise_generator.get_state(), b.noise_generator.get_state())
    assert torch.equal(straight._table, resumed._table)


# --------------------------------------------------------------- ldp_news
def _one_epoch(noise: bool, sigma: float = 0.5):
    cfg = _cfg("param_avg", **{"model.dropout_rate": 0.2})
    if noise:
        cfg.privacy.enabled, cfg.privacy.mechanism, cfg.privacy.sigma = True, "ldp_news", sigma
    data, toks = _data_and_tokens(cfg)
    t = Trainer(cfg, data, toks, device="cpu")
    table = t._feature_table()
    batches = list(t.batcher.epoch_batches_sharded(_K, 0))
    for b in batches:
        t.train_step(t.states, _batch_dict(b), table)
    return t, batches


def test_ldp_news_noises_the_news_gradients_only():
    """Same seeds with noise off and on: every user-tower parameter is equal
    to the bit (noise has its own generator, dropout draws the same masks);
    the accumulators differ by the noise alone, which is N(0, sigma^2) per
    touch: on each touched row, (noised - clean) / sqrt(times touched) has
    mean 0 and std sigma within 5 standard errors (SE sigma/sqrt(n) and
    sigma/sqrt(2n) over n values); an untouched row stays 0."""
    sigma = 0.5
    clean, batches = _one_epoch(False)
    noised, _ = _one_epoch(True, sigma)
    for a, b in zip(clean.states, noised.states):
        for p, q in zip(a.user_params(), b.user_params()):
            assert torch.equal(p, q)
    for c in range(_K):
        ids = np.concatenate([np.concatenate([b.candidates[c].ravel(), b.history[c].ravel()])
                              for b in batches])
        touched = np.bincount(ids, minlength=clean.token_states.shape[0])
        diff = (noised.states[c].news_grad_accum - clean.states[c].news_grad_accum).numpy()
        assert np.abs(diff[touched == 0]).max(initial=0.0) == 0.0
        z = (diff[touched > 0] / np.sqrt(touched[touched > 0])[:, None]).ravel()
        n = z.size
        assert abs(z.mean()) < 5 * sigma / np.sqrt(n), z.mean()
        assert abs(z.std() - sigma) < 5 * sigma / np.sqrt(2 * n), z.std()


def test_ldp_news_noises_the_text_head_in_joint_mode():
    g = torch.Generator().manual_seed(0)
    user = [torch.ones(3)]
    news = [torch.zeros(4, 2), torch.zeros(5)]
    out_user, out_news = make_ldp_news_noise_fn(2.0)((user, news), g)
    assert out_user is user
    assert all(float(n.abs().max()) > 0 for n in out_news)
    g2 = torch.Generator().manual_seed(0)
    again = make_ldp_news_noise_fn(2.0)((user, news), g2)[1]
    assert all(torch.equal(a, b) for a, b in zip(out_news, again))


@pytest.mark.parametrize("case,exc,match", [
    ("sigma0", ValueError, "privacy.sigma not set"),
    ("dpsgd", ValueError, "mechanism='dpsgd' requires mode='joint'"),
    ("scope_user", ValueError, "dp_scope='user' requires mechanism='dpsgd'"),
])
def test_privacy_checks_raise_as_in_jax(case, exc, match):
    over = {"sigma0": dict(mechanism="ldp_news", sigma=0.0),
            "dpsgd": dict(mechanism="dpsgd", sigma=1.0),
            "scope_user": dict(mechanism="ldp_news", sigma=1.0, dp_scope="user")}[case]
    jcfg = small_cfg(model__text_encoder_mode="table", fed__num_clients=_K)
    cfg = _cfg("param_avg")
    for c in (jcfg, cfg):
        c.privacy.enabled = True
        for k, v in over.items():
            setattr(c.privacy, k, v)
    with pytest.raises(exc, match=match):
        jax_build_fed_train_step(JaxNewsRecommender(jcfg.model), jcfg,
                                 jax_get_strategy("param_avg"), client_mesh(_K),
                                 mode="decoupled")
    with pytest.raises(exc, match=match):
        build_fed_train_step(NewsRecommender(cfg.model), cfg, get_strategy("param_avg"),
                             device="cpu")


def test_dpsgd_is_refused_by_name_in_joint_mode():
    """Joint-mode DP-SGD runs; what stays refused is the JAX package's own
    refusal, with its wording: dpsgd on the fused route."""
    cfg = _cfg("param_avg", **{"model.text_encoder_mode": "head", "privacy.enabled": 1,
                               "privacy.sigma": 1.0, "model.fuse_hot_path": 0})
    build_fed_train_step(NewsRecommender(cfg.model), cfg, get_strategy("param_avg"),
                         device="cpu")
    assert make_noise_fn(cfg.privacy, 8) is not None
    cfg.model.fuse_hot_path = True
    with pytest.raises(NotImplementedError,
                       match="model.fuse_hot_path with privacy.mechanism='dpsgd'"):
        build_fed_train_step(NewsRecommender(cfg.model), cfg, get_strategy("param_avg"),
                             device="cpu")


# -------------------------------------------------- accountant and loader
@pytest.mark.parametrize("over,clients,batch,n_train", [
    (dict(epsilon=10.0), 8, 64, 20000),
    (dict(epsilon=1.0, delta=1e-6, accountant_epochs=5), 2, 16, 512),
    (dict(epsilon=8.0, clip_norm=1.0, accountant_epochs=20), 4, 64, 96),
])
def test_calibrate_from_config_equals_jax(over, clients, batch, n_train):
    jcfg = small_cfg(fed__num_clients=clients, data__batch_size=batch)
    cfg = _cfg("param_avg", **{"fed.num_clients": clients, "data.batch_size": batch})
    for k, v in over.items():
        setattr(jcfg.privacy, k, v)
        setattr(cfg.privacy, k, v)
    want = jax_accountant.calibrate_from_config(jcfg, n_train)
    got = accountant.calibrate_from_config(cfg, n_train)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert accountant.sampling_profile(cfg, n_train) == jax_accountant.sampling_profile(jcfg, n_train)
    cfg.privacy.sigma = jcfg.privacy.sigma = got
    np.testing.assert_allclose(accountant.round_epsilon_schedule(cfg, n_train)(3),
                               jax_accountant.round_epsilon_schedule(jcfg, n_train)(3),
                               rtol=1e-12)


def test_privacy_config_fields_and_defaults_equal_jax():
    from dataclasses import asdict

    from fedrec_tpu_torch.config import PrivacyConfig

    assert asdict(PrivacyConfig()) == asdict(JaxPrivacyConfig())


def test_load_mind_artifacts_equals_jax(tmp_path):
    d = make_synthetic_mind(num_news=20, num_train=12, num_valid=4, title_len=6,
                            his_len_range=(1, 5), seed=2)
    np.save(tmp_path / "bert_news_index.npy", d.news_tokens)
    for name, obj in (("bert_nid2index.pkl", d.nid2index), ("train_sam_uid.pkl", d.train_samples),
                      ("valid_sam_uid.pkl", d.valid_samples)):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(obj, f)
    got, want = load_mind_artifacts(tmp_path), jax_load_mind_artifacts(tmp_path)
    np.testing.assert_array_equal(got.news_tokens, want.news_tokens)
    assert got.news_tokens.dtype == want.news_tokens.dtype
    assert got.nid2index == want.nid2index
    assert got.train_samples == want.train_samples and got.valid_samples == want.valid_samples
    assert (got.num_news, got.title_len) == (20, 6)


def test_trainer_runs_from_a_default_config_on_the_cpu():
    """``ExperimentConfig()`` names decoupled mode, which the port's Trainer
    used to refuse: one round at the default widths (400-d news vectors,
    768-d token states, 8 clients of 64) runs and evaluates."""
    cfg = ExperimentConfig().apply_overrides(["fed.rounds=1", "train.snapshot_dir="])
    assert cfg.model.text_encoder_mode == "table"
    data = make_synthetic_mind(num_news=32, num_train=512, num_valid=16,
                               title_len=cfg.data.max_title_len, seed=0)
    toks = np.random.default_rng(0).standard_normal(
        (32, cfg.data.max_title_len, cfg.model.bert_hidden)).astype(np.float32)
    (result,) = Trainer(cfg, data, toks, device="cpu").run()
    assert np.isfinite(result.train_loss) and set(result.val_metrics) == {
        "auc", "mrr", "ndcg5", "ndcg10"}
