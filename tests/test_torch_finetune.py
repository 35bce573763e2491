"""Port parity for finetune mode (CPU): the DistilBERT trunk trained in the
loop (``model.text_encoder_mode='finetune'``), against the JAX package's
``build_fed_train_step(mode='finetune')`` and ``Trainer``; then the port's
own finetune snapshots (bitwise resume), the recommend CLI on a finetune
snapshot, ``data.gather_chunk`` against the untiled route, a sampled
cohort run in finetune mode, and the refusals.

Both packages start from one Flax tree (``params.from_flax``), at dropout 0
in the user tower and the trunk: the dropout streams differ by design
(torch generators against JAX keys). Tolerances are the trajectory bars of
``tests/test_torch_train.py``: losses rtol 1e-5 / atol 1e-6, parameters
rtol 2e-4 / atol 1e-4 (Adam divides by sqrt(v), which amplifies the last
bits of tiny gradients). Three kinds of leaf have a gradient of exactly
zero in theory — the user tower's key bias, both pools' fc2 bias (as
there) and every trunk block's ``k_lin`` bias (a per-query shift of the
logits) — so each package's value there is rounding noise that Adam turns
into steps of up to the learning rate, of either sign: they compare at
2 x lr x steps, the farthest two such walks can part.
"""

import io
import json
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedrec_tpu.data import TrainBatcher as JaxTrainBatcher
from fedrec_tpu.data import index_samples as jax_index_samples
from fedrec_tpu.fed import get_strategy as jax_get_strategy
from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
from fedrec_tpu.models.bert import make_text_encoder as jax_make_text_encoder
from fedrec_tpu.parallel import client_mesh, shard_batch
from fedrec_tpu.train import build_fed_train_step as jax_build_fed_train_step
from fedrec_tpu.train.state import init_client_state as jax_init_client_state
from fedrec_tpu.train.state import replicate_state as jax_replicate_state
from fedrec_tpu.train.step import encode_corpus_tokens as jax_encode_corpus_tokens
from fedrec_tpu.train.trainer import Trainer as JaxTrainer
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.data import make_synthetic_mind, write_artifacts
from fedrec_tpu_torch.fed import get_strategy
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.params import from_flax
from fedrec_tpu_torch.serve import build_recommend_fn
from fedrec_tpu_torch.train import (
    Trainer,
    build_fed_train_step,
    encode_corpus_tokens,
    init_client_state,
    replicate_state,
)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_trainer import _full_scores, _port_cfg  # noqa: E402
from test_trainer import finetune_cfg, finetune_data  # noqa: E402

_NOISE_LEAVES = ("w_k.bias", "att_fc2.bias", "k_lin.bias")
_PARITY = dict(model__dropout_rate=0.0, model__trunk_dropout=0.0, optim__user_lr=3e-3,
               optim__news_lr=3e-3)


def _named(tree, prefix: str) -> dict:
    """A Flax tree as the port's ``{parameter name: array}``: Dense kernels
    transposed to (out, in), Embed tables and LayerNorm scales as weights."""
    out = {}
    for key, sub in tree.items():
        path = f"{prefix}.{key}"
        if isinstance(sub, dict):
            out.update(_named(sub, path))
        else:
            name = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(key, key)
            arr = np.asarray(sub)
            out[f"{prefix}.{name}"] = arr.T if key == "kernel" else arr
    return out


def _assert_params_close(model, want: dict, steps: int) -> None:
    got = {k: v.detach().numpy() for k, v in model.named_parameters()}
    assert set(got) == set(want)
    noise = 2 * _PARITY["optim__user_lr"] * steps
    for name, w in want.items():
        if name.endswith(_NOISE_LEAVES):
            assert float(np.abs(got[name] - w).max()) <= noise, name
        else:
            np.testing.assert_allclose(got[name], w, rtol=2e-4, atol=1e-4, err_msg=name)


def _jax_client(stacked, c: int) -> dict:
    take = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x[c]), tree)  # noqa: E731
    return {**_named(take(stacked.user_params), "user_encoder"),
            **_named(take(stacked.news_params), "text_encoder")}


def _load_jax_client(model, user_tree, news_tree) -> None:
    from_flax(model.user_encoder, user_tree)
    from_flax(model.news_tower, news_tree)


# ------------------------------------------------------------ the train step
@pytest.mark.parametrize("fuse", [False, True], ids=["dense", "kernel_route"])
def test_finetune_train_step_matches_jax(fuse):
    """K=2 ``param_avg`` clients, 3 finetune steps from one Flax tree; the
    kernel route runs kernels B/E's plain versions on the CPU."""
    jcfg = finetune_cfg(None, model__fuse_hot_path=fuse, **_PARITY)
    jcfg.model.trunk_layers = 2
    jcfg.data.unique_news_cap = 45  # below the 48 news: the cap path, no overflow
    data = make_synthetic_mind(num_news=48, num_train=64, num_valid=8, title_len=12,
                               vocab=2000, his_len_range=(2, 10), seed=0)
    k = jcfg.fed.num_clients
    ix = jax_index_samples(data.train_samples, data.nid2index, jcfg.data.max_his_len)
    batcher = JaxTrainBatcher(ix, jcfg.data.batch_size, jcfg.data.npratio, seed=0)
    jmodel = JaxNewsRecommender(jcfg.model)
    jstate = jax_replicate_state(
        jax_init_client_state(jmodel, jcfg, jax.random.PRNGKey(0), data.num_news,
                              jcfg.data.max_title_len), k, jax.random.PRNGKey(1))
    mesh = client_mesh(k)
    jstep = jax_build_fed_train_step(jmodel, jcfg, jax_get_strategy("param_avg"), mesh,
                                     mode="finetune")
    jtable = jnp.asarray(data.news_tokens, jnp.int32)

    cfg = _port_cfg(jcfg)
    model = NewsRecommender(cfg.model)
    take = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x[0]), tree)  # noqa: E731
    _load_jax_client(model, take(jstate.user_params), take(jstate.news_params))
    states = replicate_state(init_client_state(model, cfg, seed=0), k)
    step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device="cpu")
    table = torch.from_numpy(data.news_tokens)

    for i, b in enumerate(batcher.epoch_batches_sharded(k, 0)):
        if i == 3:
            break
        batch = {"candidates": b.candidates, "history": b.history, "labels": b.labels}
        jstate, jm = jstep(jstate, shard_batch(mesh, batch), jtable)
        states, m = step(states, batch, table)
        np.testing.assert_allclose(m["loss"].detach().numpy(), np.asarray(jm["loss"]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
        assert m["unique_overflow"] == 0 and not np.asarray(jm["unique_overflow"]).any()
    for c in range(k):
        _assert_params_close(states[c].model, _jax_client(jstate, c), steps=3)


def test_finetune_unique_overflow_matches_jax():
    """A cap below a batch's distinct ids: both packages flag the step."""
    jcfg = finetune_cfg(None, **_PARITY)
    jcfg.data.unique_news_cap = 4
    data = finetune_data(jcfg)
    k = jcfg.fed.num_clients
    ix = jax_index_samples(data.train_samples, data.nid2index, jcfg.data.max_his_len)
    b = next(iter(JaxTrainBatcher(ix, jcfg.data.batch_size, jcfg.data.npratio,
                                  seed=0).epoch_batches_sharded(k, 0)))
    batch = {"candidates": b.candidates, "history": b.history, "labels": b.labels}
    jmodel = JaxNewsRecommender(jcfg.model)
    jstate = jax_replicate_state(
        jax_init_client_state(jmodel, jcfg, jax.random.PRNGKey(0), data.num_news,
                              jcfg.data.max_title_len), k, jax.random.PRNGKey(1))
    mesh = client_mesh(k)
    _, jm = jax_build_fed_train_step(jmodel, jcfg, jax_get_strategy("param_avg"), mesh,
                                     mode="finetune")(
        jstate, shard_batch(mesh, batch), jnp.asarray(data.news_tokens, jnp.int32))
    cfg = _port_cfg(jcfg)
    model = NewsRecommender(cfg.model)
    states = replicate_state(init_client_state(model, cfg, seed=0), k)
    _, m = build_fed_train_step(model, cfg, get_strategy("param_avg"), device="cpu")(
        states, batch, torch.from_numpy(data.news_tokens))
    # JAX's flag is the cohort's sum, replicated on every client
    assert m["unique_overflow"] == k and set(np.asarray(jm["unique_overflow"])) == {k}


# ------------------------------------------------------------ the trainer
def test_finetune_trainer_matches_jax_over_three_rounds():
    """K=2 clients, 3 ``param_avg`` rounds of finetune training from one
    Flax tree: round losses, every client's parameters, and the full-pool
    validation of the last round (the corpus encode through both packages'
    whole text encoders)."""
    jcfg = finetune_cfg(None, fed__rounds=3, train__eval_every=10**6, **_PARITY)
    data = finetune_data(jcfg)
    jt = JaxTrainer(jcfg, data, token_states=None)
    cfg = _port_cfg(jcfg)
    cfg.train.eval_every = 3
    pt = Trainer(cfg, data, None, device="cpu")
    up, np_ = jax.tree_util.tree_map(np.asarray, jt._client0_params())
    pt.set_global_params(up, np_)
    for r in range(3):
        jr, pr = jt.train_round(r), pt.train_round(r)
        np.testing.assert_allclose(pr.train_loss, jr.train_loss, rtol=1e-5, atol=1e-6,
                                   err_msg=f"round {r}")
    for c in range(cfg.fed.num_clients):
        _assert_params_close(pt.states[c].model, _jax_client(jt.state, c),
                             steps=int(pt.states[c].step))
    # the full-pool scores of client 0: the corpus encode through both
    # packages' whole text encoders, then the user tower
    ix = pt.valid_ix
    with torch.no_grad():
        table = pt._encode_corpus(0)
        user = pt.states[0].model.user_encoder(table[torch.from_numpy(ix.history).long()])
    up, np_ = jt._client_params(0)
    jtable = jt._encode_corpus(np_)
    juser = jt.model.apply({"params": {"user_encoder": up}}, jtable[ix.history],
                           method=type(jt.model).encode_user)
    np.testing.assert_allclose(table.numpy(), np.asarray(jtable), rtol=1e-5, atol=1e-5)
    got = _full_scores(ix.pos, ix.neg_pools, ix.neg_lens, user.numpy(), table.numpy())
    want = _full_scores(ix.pos, ix.neg_pools, ix.neg_lens, np.asarray(juser), np.asarray(jtable))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    assert set(pr.val_metrics) == set(jt.evaluate_full(client=0))


def _tiny_ft(tmp_path, **over) -> ExperimentConfig:
    return _port_cfg(finetune_cfg(tmp_path, **over))


def _bits(t: Trainer) -> list:
    return [p.detach().clone() for st in t.states for p in st.model.parameters()]


def test_finetune_resume_is_bitwise(tmp_path):
    """Trunk dropout and user-tower dropout on: 2 rounds, against 1 round
    and a resume to 2 — losses, metrics, every parameter and the trunk's
    Adam moments bitwise (snapshots hold the trunk and the generators)."""
    data = finetune_data(finetune_cfg(None))
    full = Trainer(_tiny_ft(tmp_path / "a", fed__rounds=2), data, None, device="cpu")
    hist = full.run()
    Trainer(_tiny_ft(tmp_path / "b", fed__rounds=1), data, None, device="cpu").run()
    resumed = Trainer(_tiny_ft(tmp_path / "b", fed__rounds=2), data, None, device="cpu")
    assert resumed.start_round == 1
    last = resumed.run()
    assert last[0].train_loss == hist[1].train_loss and last[0].val_metrics == hist[1].val_metrics
    assert all(torch.equal(a, b) for a, b in zip(_bits(full), _bits(resumed)))
    for sa, sb in zip(full.states, resumed.states):
        assert all(torch.equal(a, b) for a, b in zip(sa.opt_news.mu, sb.opt_news.mu))
    assert any(n.startswith("trunk.") for n, _ in full.states[0].model.news_tower.named_parameters())


def test_finetune_resume_checks_the_trunk_knobs(tmp_path):
    data = finetune_data(finetune_cfg(None))
    Trainer(_tiny_ft(tmp_path, fed__rounds=1), data, None, device="cpu").run()
    other = _tiny_ft(tmp_path, fed__rounds=2)
    other.model.trunk_layers = 2
    with pytest.raises(ValueError, match="model.trunk_layers: snapshot=1 vs this run=2"):
        Trainer(other, data, None, device="cpu")


def test_finetune_refuses_out_of_vocab_tokens():
    cfg = _tiny_ft(None)
    data = make_synthetic_mind(num_news=16, num_train=8, num_valid=4, title_len=12,
                               vocab=30522, his_len_range=(2, 10))
    with pytest.raises(ValueError, match="trunk_vocab"):
        Trainer(cfg, data, None, device="cpu")


# ------------------------------------------------------------ the recommend CLI
def test_recommend_cli_serves_a_finetune_snapshot(tmp_path):
    """A finetune run's snapshot through ``cli.recommend``: the corpus is
    encoded by the restored ``TextEncoder`` (JAX's ``encode_corpus_tokens``
    on the same weights agrees at 1e-5), and the output is the exact
    scorer's top-k over it."""
    from fedrec_tpu_torch.cli import recommend

    snaps, art = tmp_path / "snaps", tmp_path / "UserData"
    data = finetune_data(finetune_cfg(None))
    cfg = _tiny_ft(snaps, fed__rounds=1)
    with redirect_stdout(io.StringIO()):
        trainer = Trainer(cfg, data, None, device="cpu")
        trainer.run()
    write_artifacts(data, art)
    out = tmp_path / "recs.jsonl"
    err = io.StringIO()
    with redirect_stderr(err):
        rc = recommend.main(["--data-dir", str(art), "--snapshot-dir", str(snaps), "--out",
                             str(out), "--device", "cpu", "--top-k", "5"])
    assert rc == 0, err.getvalue()
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    users = recommend.collect_histories(data, cfg.data.max_his_len)
    assert [ln["uid"] for ln in lines] == sorted(users)

    m0 = trainer.states[0].model.eval()
    table = encode_corpus_tokens(m0.text_encoder, data.news_tokens, device="cpu")
    news_tree = _flax_tree(m0.text_encoder)
    jtable = jax_encode_corpus_tokens(jax_make_text_encoder(finetune_cfg(None).model), news_tree,
                                      jnp.asarray(data.news_tokens, jnp.int32))
    np.testing.assert_allclose(table.numpy(), np.asarray(jtable), atol=1e-5, rtol=1e-5)
    hist = np.zeros((len(lines), cfg.data.max_his_len), np.int64)
    for r, ln in enumerate(lines):
        ids = [data.nid2index[n] for n in users[ln["uid"]]]
        hist[r, :len(ids)] = ids
    ids, scores = build_recommend_fn(top_k=5, device="cpu")(m0.user_encoder, table,
                                                            torch.from_numpy(hist))
    index2nid = {i: n for n, i in data.nid2index.items()}
    for r, ln in enumerate(lines):
        keep = ids[r] >= 0
        assert ln["news"] == [index2nid[int(i)] for i in ids[r][keep]]
        np.testing.assert_allclose(ln["scores"], scores[r][keep].numpy(), atol=1e-5)


def _flax_tree(module) -> dict:
    """The module's parameters as a Flax-shaped numpy tree."""
    kinds = {torch.nn.Linear: "kernel", torch.nn.Embedding: "embedding",
             torch.nn.LayerNorm: "scale"}
    tree: dict = {}
    for name, layer in module.named_modules():
        kind = kinds.get(type(layer))
        if kind is None:
            continue
        node = tree
        for key in name.split("."):
            node = node.setdefault(key, {})
        w = layer.weight.detach().numpy()
        node[kind] = w.T if kind == "kernel" else w
        if kind != "embedding":
            node["bias"] = layer.bias.detach().numpy()
    return tree


# ------------------------------------------------------------ data.gather_chunk
def _joint_cfg(*extra: str) -> ExperimentConfig:
    return ExperimentConfig().apply_overrides([
        "model.text_encoder_mode=head", "model.news_dim=32", "model.num_heads=4",
        "model.head_dim=8", "model.query_dim=16", "model.bert_hidden=48",
        "data.max_his_len=10", "data.max_title_len=12", "data.batch_size=8",
        "fed.num_clients=2", "optim.user_lr=3e-3", "optim.news_lr=3e-3", *extra])


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("chunk", [7, 64])
def test_gather_chunk_equals_the_untiled_route(fuse, chunk):
    """The tiled gather + encode (each tile recomputed in backward) against
    the untiled one on one batch's unique ids: the news vectors and the
    text head's gradients agree to the last bits (1e-6 of the largest: the
    encode is row-wise, only the weight gradients' sum order changes); then 3
    steps of K=2 clients at the trajectory bars. On the fused route the
    tiles run kernels C/D's plain versions."""
    from test_torch_trainer import _data_and_tokens

    from fedrec_tpu_torch.data import TrainBatcher, index_samples
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.train.step import _batch_news_vecs

    cfg = _joint_cfg(f"model.fuse_hot_path={fuse}")
    data, toks = _data_and_tokens(cfg)
    toks = torch.from_numpy(toks)
    ix = index_samples(data.train_samples, data.nid2index, cfg.data.max_his_len)
    batches = list(TrainBatcher(ix, 8, 4, seed=0).epoch_batches_sharded(2, 0))[:3]
    model = init_params(NewsRecommender(cfg.model), seed=0)
    cand = torch.from_numpy(batches[0].candidates[0])
    hist = torch.from_numpy(batches[0].history[0])
    outs = []
    for c in (0, chunk):
        model.zero_grad()
        cv, hv = _batch_news_vecs(model, toks, cand, hist, fused=fuse, chunk=c)
        ((cv ** 2).sum() + (hv * 0.5).sum()).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()  # fused: no fc2 bias
                 for p in model.text_head.parameters()]
        outs.append((cv.detach(), hv.detach(), grads))
    (c0, h0, g0), (c1, h1, g1) = outs
    np.testing.assert_allclose(c1.numpy(), c0.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(h1.numpy(), h0.numpy(), rtol=1e-6, atol=1e-7)
    scale = max(float(g.abs().max()) for g in g0)  # fc2's bias gradient is 0 up to noise
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max()) <= 1e-6 * scale

    runs = []
    for extra in ([], [f"data.gather_chunk={chunk}"]):
        cfg = _joint_cfg(f"model.fuse_hot_path={fuse}", *extra)
        model = init_params(NewsRecommender(cfg.model), seed=0)
        states = replicate_state(init_client_state(model, cfg, seed=0), 2)
        step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device="cpu")
        losses = []
        for b in batches:
            states, m = step(states, {"candidates": b.candidates, "history": b.history,
                                      "labels": b.labels}, toks)
            losses.append(m["loss"].detach().numpy())
        runs.append((losses, states))
    (l0, s0), (l1, s1) = runs
    np.testing.assert_allclose(np.array(l1), np.array(l0), rtol=1e-5, atol=1e-6)
    for a, b in zip(s1, s0):
        _assert_params_close(a.model, {k: v.detach().numpy()
                                       for k, v in b.model.named_parameters()}, steps=3)


# ------------------------------------------------------------ cohorts
def test_cohort_run_in_finetune_mode():
    """A sampled population of 4 logical clients on 2 slots: the sidecars
    carry the trunk's Adam moments, the run is finite, and a repeat is
    bitwise."""
    data = finetune_data(finetune_cfg(None))

    def run():
        cfg = _tiny_ft(None, fed__rounds=3)
        cfg.apply_overrides(["fed.population.num_clients=4", "data.batch_size=4"])
        with redirect_stdout(io.StringIO()):
            t = Trainer(cfg, data, None, device="cpu")
            hist = t.run()
        return t, hist

    t, hist = run()
    assert all(np.isfinite(h.train_loss) for h in hist)
    n_news = sum(1 for _ in t.states[0].model.news_tower.parameters())
    sidecar = t._read_sidecar(0)
    assert len(sidecar["opt_news"]) == 1 + 2 * n_news  # count, the trunk's and head's moments
    t2, hist2 = run()
    assert [h.train_loss for h in hist2] == [h.train_loss for h in hist]
    assert all(torch.equal(a, b) for a, b in zip(_bits(t), _bits(t2)))


# ------------------------------------------------------------ refusals
def test_dpsgd_over_the_trunk_is_refused_with_jax_wording():
    jcfg = finetune_cfg(None)
    jcfg.privacy.enabled, jcfg.privacy.sigma = True, 1.0
    with pytest.raises(NotImplementedError) as want:
        jax_build_fed_train_step(JaxNewsRecommender(jcfg.model), jcfg,
                                 jax_get_strategy("param_avg"), client_mesh(2),
                                 mode="finetune")
    cfg = _port_cfg(jcfg)
    cfg.privacy.enabled, cfg.privacy.sigma = True, 1.0
    with pytest.raises(NotImplementedError) as got:
        build_fed_train_step(NewsRecommender(cfg.model), cfg, get_strategy("param_avg"),
                             device="cpu")
    assert str(got.value) == str(want.value)


def test_finetune_text_head_arch_refusal_matches_jax():
    from fedrec_tpu.models.bert import make_text_encoder
    from fedrec_tpu_torch.models.bert import make_text_encoder as port_make

    jcfg = finetune_cfg(None)
    jcfg.model.text_head_arch = "cnn"
    with pytest.raises(NotImplementedError) as want:
        make_text_encoder(jcfg.model)
    cfg = _port_cfg(jcfg)
    with pytest.raises(NotImplementedError) as got:
        port_make(cfg.model)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ the run CLI
_FT_SMALL = ["--set", "model.text_encoder_mode=finetune", "--set", "model.news_dim=32",
             "--set", "model.num_heads=4", "--set", "model.head_dim=8", "--set",
             "model.query_dim=16", "--set", "model.bert_hidden=32", "--set",
             "model.trunk_layers=1", "--set", "model.trunk_heads=2", "--set",
             "model.trunk_ffn=64", "--set", "data.max_his_len=10", "--set",
             "data.max_title_len=12"]


def test_run_cli_hands_finetune_mode_what_the_jax_cli_does(monkeypatch, tmp_path):
    """``--set model.text_encoder_mode=finetune``: the same configuration
    and data as the JAX CLI's, and no token states (JAX builds random ones
    that its finetune trainer never reads)."""
    import fedrec_tpu.train.trainer as jax_trainer_module
    from test_torch_cli import _assert_same_config, _stub

    import fedrec_tpu_torch.train.trainer as trainer_module
    from fedrec_tpu.cli import run as jax_run
    from fedrec_tpu_torch.cli import run

    got: dict = {}
    monkeypatch.setattr(jax_trainer_module, "Trainer", _stub(got, "jax"))
    monkeypatch.setattr(trainer_module, "Trainer", _stub(got, "port"))
    argv = ["2", "8", "1", "--synthetic", "--synthetic-news", "64", "--synthetic-train", "64",
            "--clients", "2", "--data-dir", str(tmp_path), *_FT_SMALL]
    assert jax_run.main(argv) == 0
    assert run.main([*argv, "--device", "cpu"]) == 0
    (pcfg, pdata, ptoks), (jcfg, jdata, jtoks) = got["port"], got["jax"]
    _assert_same_config(pcfg, jcfg)
    np.testing.assert_array_equal(pdata.news_tokens, jdata.news_tokens)
    assert pdata.train_samples == jdata.train_samples and ptoks is None and jtoks is not None


def test_run_cli_trains_finetune_mode_on_the_cpu(tmp_path, capsys):
    from fedrec_tpu_torch.cli import run

    argv = ["2", "8", "1", "--synthetic", "--synthetic-news", "64", "--synthetic-train", "64",
            "--clients", "2", "--device", "cpu", *_FT_SMALL,
            "--set", f"train.snapshot_dir={tmp_path}"]
    assert run.main(argv) == 0
    final = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("final: ")]
    assert len(final) == 1
    fields = dict(kv.split("=") for kv in final[0].removeprefix("final: ").split())
    assert np.isfinite(float(fields["loss"])) and 0.0 <= float(fields["auc"]) <= 1.0
    state = torch.load(tmp_path / "round_1" / "state.pt", weights_only=False)
    assert "trunk.layer_0.lin1.weight" in state["clients"][0]["news_params"]


def test_cached_state_entry_points_refuse_a_finetune_model():
    """``encode_all_news`` (and with it ``publish_from_checkpoint``, the
    serving refresh) reads cached token states, which a finetune model does
    not take: a named error, not an attribute error."""
    from fedrec_tpu_torch.train import encode_all_news

    model = NewsRecommender(_tiny_ft(None).model)
    with pytest.raises(ValueError, match="encode_corpus_tokens"):
        encode_all_news(model, torch.zeros((3, 12, 32)), device="cpu")
