"""Port parity for the update codecs, the host reductions and the
coordinator's gather (CPU): ``fedrec_tpu_torch.comms``,
``fed.robust.robust_reduce_np`` / ``robust_reduce_tree_np``,
``agg.hierarchy.tree_reduce_np``, ``parallel.multihost.aggregate_from_hosts``
and the codec and hierarchical round-end syncs of the ``Trainer`` against
the JAX package's, on the same seeded inputs.

The codecs' inputs are a seeded ``(user, news)`` tree in Flax layout
(``params.to_flax`` of a small ``NewsRecommender``, plus seeded noise): the
port's payloads must be byte-equal to the JAX package's (same keys, dtypes,
shapes and bytes, leaf for leaf, which also pins the leaf order), and the
decodes equal. The torch twin is held to ``jax_encode_decode`` at
``tests/test_comms.py``'s bar (rtol 0, atol 1e-6). The numpy reductions run
the same numpy expressions as the JAX package, so they are held equal to the
bit; ``aggregate_from_hosts`` is given the same gathered stacks on both
sides (only the collective is replaced) and held equal to the bit, its byte
counters and residual too. The trainer runs use ``tests/test_torch_trainer.py``'s
configuration (K = 8, 3 rounds) and bars: round losses rtol 1e-5 / atol
1e-6, parameters rtol 2e-4 / atol 1e-4.

Top-k under a trajectory: Adam's first step moves every coordinate with a
gradient by exactly the learning rate, so a round's deltas hold exact
magnitude ties, and a 1-ulp difference between the two packages' training
decides which tied coordinate is kept. The topk trainer case therefore
holds the losses at the bars; after the first round (equal entries, zero
residuals) every coordinate where the two kept sets differ must be a tie
(both packages' banked residuals show the swapped coordinates at one
magnitude); at the end every parameter is at the bars except at most 1% of
a leaf's coordinates, each within one step of the learning rate.
"""

import copy
import dataclasses
import io
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import fedrec_tpu.comms as jcomms
import fedrec_tpu.parallel.multihost as jmh
from fedrec_tpu.agg.hierarchy import build_tree as jax_build_tree
from fedrec_tpu.agg.hierarchy import tree_reduce_np as jax_tree_reduce_np
from fedrec_tpu.cli.coordinator import apply_process_sharding as jax_apply_process_sharding
from fedrec_tpu.config import ExperimentConfig as JaxConfig
from fedrec_tpu.fed.robust import robust_reduce_np as jax_robust_reduce_np
from fedrec_tpu.fed.robust import robust_reduce_tree_np as jax_robust_reduce_tree_np
from fedrec_tpu.obs import get_registry as jax_registry
from fedrec_tpu.train.trainer import Trainer as JaxTrainer
from fedrec_tpu_torch import comms
from fedrec_tpu_torch.agg.hierarchy import build_tree, tree_reduce_np
from fedrec_tpu_torch.cli.coordinator import apply_process_sharding
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.fed.robust import robust_reduce_np, robust_reduce_tree_np
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.obs import get_registry
from fedrec_tpu_torch.params import init_params, to_flax
from fedrec_tpu_torch.parallel import multihost
from fedrec_tpu_torch.train import Trainer

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train import _assert_tree_close, _client_tree, _to_flax  # noqa: E402
from test_torch_trainer import _PARITY, _assert_round, _port_cfg  # noqa: E402
from test_trainer import tiny_cfg, tiny_data  # noqa: E402

CODECS = ("none", "int8", "sign1bit", "topk", "countsketch", "randproj")
DECODABLE = ("none", "int8", "sign1bit", "topk")
_SMALL = ["model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
          "model.bert_hidden=48"]
# a small width and a non-default seed, so that the sketches' geometry and
# hashes are exercised off their defaults
_GEOM = dict(sketch_width=0.25, sketch_seed=3)


def _tree(seed: int = 0, scale: float = 1e-2):
    """A seeded ``(user, news)`` contribution in Flax layout: a small model's
    ``to_flax`` trees plus seeded noise (a round delta's scale)."""
    cfg = ExperimentConfig().apply_overrides(_SMALL)
    model = init_params(NewsRecommender(cfg.model), seed=0)
    rng = np.random.default_rng(seed)
    noisy = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: (x * scale + rng.standard_normal(x.shape) * scale).astype(np.float32), t)
    return noisy(to_flax(model.user_encoder)), noisy(to_flax(model.news_tower))


def _assert_payload_equal(got: dict, want: dict, where: str) -> None:
    assert sorted(got) == sorted(want), where
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{where}.{k}"
        assert g.tobytes() == w.tobytes(), f"{where}.{k}: payload bytes differ"


# --------------------------------------------------------------- codecs
@pytest.mark.parametrize("codec", CODECS)
def test_payloads_are_byte_equal_to_jax(codec):
    tree = _tree()
    mine = comms.encode_tree(tree, codec, 0.05, **_GEOM)
    theirs = jcomms.encode_tree(tree, codec, 0.05, **_GEOM)
    assert len(mine.payloads) == len(theirs.payloads) == len(jax.tree_util.tree_leaves(tree))
    for i, (g, w) in enumerate(zip(mine.payloads, theirs.payloads)):
        _assert_payload_equal(g, w, f"leaf {i}")
    assert mine.nbytes() == theirs.nbytes()
    for g, w in zip(jax.tree_util.tree_leaves(comms.decode_tree(mine)),
                    jax.tree_util.tree_leaves(jcomms.decode_tree(theirs))):
        np.testing.assert_array_equal(g, w)
    assert comms.leaf_names(tree) == jcomms.leaf_names(tree)
    assert comms.tree_dense_nbytes(tree) == jcomms.tree_dense_nbytes(tree)


@pytest.mark.parametrize("codec", CODECS)
def test_torch_twin_matches_jax_twin(codec):
    for i, x in enumerate(jax.tree_util.tree_leaves(_tree(seed=1))):
        got = comms.torch_encode_decode(torch.from_numpy(x), codec, 0.05, leaf_id=i, **_GEOM)
        want = np.asarray(jcomms.jax_encode_decode(x, codec, 0.05, leaf_id=i, **_GEOM))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6, err_msg=f"leaf {i}")
        wire = comms.decode_leaf(comms.encode_leaf(x, codec, 0.05, leaf_id=i, **_GEOM), codec,
                                 x.shape, sketch_seed=_GEOM["sketch_seed"], leaf_id=i)
        np.testing.assert_allclose(got.numpy(), wire, rtol=0, atol=1e-6, err_msg=f"leaf {i}")


def test_codec_state_reads_a_jax_blob_and_back():
    """The per-process residual sidecar: a JAX-written blob restores into
    the port's tree, and the port's blob into JAX's; a zero-leaf blob is
    ``residual=None``; a structure mismatch raises."""
    res = _tree(seed=2)
    template = jax.tree_util.tree_map(np.zeros_like, res)
    state, r = comms.load_codec_state(jcomms.codec_state_bytes(jcomms.CodecState(res), 7),
                                      template)
    assert r == 7
    for g, w in zip(jax.tree_util.tree_leaves(state.residual), jax.tree_util.tree_leaves(res)):
        np.testing.assert_array_equal(g, w)
    back, r = jcomms.load_codec_state(comms.codec_state_bytes(state, 8), template)
    assert r == 8
    for g, w in zip(jax.tree_util.tree_leaves(back.residual), jax.tree_util.tree_leaves(res)):
        np.testing.assert_array_equal(np.asarray(g), w)
    empty, _ = comms.load_codec_state(jcomms.codec_state_bytes(jcomms.CodecState(), 1), template)
    assert empty.residual is None
    with pytest.raises(ValueError, match="leaves"):
        comms.load_codec_state(comms.codec_state_bytes(state, 1), template[0])


def test_codec_capabilities_and_validation():
    assert {k: dataclasses.astuple(v) for k, v in comms.CODEC_CAPS.items()} == \
        {k: dataclasses.astuple(v) for k, v in jcomms.CODEC_CAPS.items()}
    assert comms.EF_CODECS == jcomms.EF_CODECS == ("sign1bit", "topk")
    with pytest.raises(ValueError, match="unknown fed.dcn_compress"):
        comms.validate_codec("gzip")
    for n, r in ((100, 0.01), (3, 1e-9), (1152, 0.01)):
        assert comms.topk_count(n, r) == jcomms.topk_count(n, r)
        assert comms.sketch_dims(n, 0.1) == jcomms.sketch_dims(n, 0.1)


# ----------------------------------------------------------- reductions
def _stack(seed: int, shape=(6, 5, 4)):
    """(P, ...) contributions with NaN cells, an infinite cell, a weight-0
    row and a column where every participant is NaN (m == 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(shape[0], -1)  # a view
    flat[1, 0] = np.nan
    flat[3, 2] = np.inf
    flat[:, -1] = np.nan
    x[2] *= 100.0  # an outlier
    w = np.asarray([1.0, 2.0, 1.0, 0.0, 3.0, 1.0], np.float32)[: shape[0]]
    fb = rng.standard_normal(shape[1:]).astype(np.float32)
    return x, w, fb


@pytest.mark.parametrize("method", ["mean", "trimmed_mean", "median", "clip"])
def test_robust_reduce_np_matches_jax(method):
    x, w, fb = _stack(0)
    if method == "mean":
        x = np.nan_to_num(x, nan=0.5, posinf=2.0)  # mean has no NaN guard
    kw = dict(trim_k=1, clip_norm=3.0, fallback=fb) if method != "clip" else dict(clip_norm=3.0)
    np.testing.assert_array_equal(robust_reduce_np(x, w, method, **kw),
                                  jax_robust_reduce_np(x, w, method, **kw))


@pytest.mark.parametrize("method", ["trimmed_mean", "median", "clip"])
def test_robust_reduce_tree_np_matches_jax(method):
    (a, w, fa), (b, _, fb) = _stack(1), _stack(2, (6, 3))
    tree, fallback = {"a": a, "b": (b,)}, {"a": fa, "b": (fb,)}
    got = robust_reduce_tree_np(tree, w, method, trim_k=1, clip_norm=2.0, fallback_tree=fallback)
    want = jax_robust_reduce_tree_np(tree, w, method, trim_k=1, clip_norm=2.0,
                                     fallback_tree=fallback)
    for g, v in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, v)


@pytest.mark.parametrize("method,fanout", [("trimmed_mean", 2), ("median", 3), ("clip", 2),
                                           ("mean", 2)])
def test_tree_reduce_np_matches_jax(method, fanout):
    (a, w, fa), (b, _, fb) = _stack(3), _stack(4, (6, 3))
    if method == "mean":
        a, b = np.nan_to_num(a, nan=0.25, posinf=1.0), np.nan_to_num(b, nan=0.25, posinf=1.0)
    w = w.copy()
    w[[0, 1]] = 0.0  # a whole tier without a participant carries the fallback
    tree, fallback = {"a": a, "b": b}, {"a": fa, "b": fb}
    s_got, s_want = {}, {}
    got = tree_reduce_np(tree, w, fanout, method, trim_k=1, clip_norm=2.0,
                         fallback_tree=fallback, stats=s_got)
    want = jax_tree_reduce_np(tree, w, fanout, method, trim_k=1, clip_norm=2.0,
                              fallback_tree=fallback, stats=s_want)
    for g, v in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, v)
    assert [lv["groups"] for lv in s_got["levels"]] == [lv["groups"] for lv in s_want["levels"]]
    assert build_tree(6, fanout) == jax_build_tree(6, fanout)


# ------------------------------------------------------ aggregate_from_hosts
_AGG_CASES = [(c, m, mode) for c in CODECS for m in ("mean", "trimmed_mean", "median", "clip")
              for mode in ("flat", "hierarchical")
              if c in DECODABLE or m == "mean"]


def _counter(reg, name: str) -> float:
    m = reg.get(name)
    return 0.0 if m is None else m.value(path="dcn")


@pytest.mark.parametrize("codec,method,mode", _AGG_CASES)
def test_aggregate_from_hosts_matches_jax_on_the_same_stacks(codec, method, mode, monkeypatch):
    """Process 1 of a 4-process world; the others' contributions are seeded
    trees, process 2 sits the round out (weight 0) with a NaN leaf. Both
    packages' own reductions run over the same gathered stacks."""
    base = _tree(seed=10, scale=1.0)
    contribs = [jax.tree_util.tree_map(lambda b, d: b + d, base, _tree(seed=20 + p))
                for p in range(4)]
    contribs[2] = jax.tree_util.tree_map(lambda x: x.copy(), contribs[2])
    jax.tree_util.tree_leaves(contribs[2])[0][...] = np.nan
    weights = np.asarray([1.0, 3.0, 0.0, 2.0], np.float32)
    residual = _tree(seed=30, scale=1e-3)
    robust = SimpleNamespace(method=method, trim_k=1, clip_norm=0.5)
    agg = SimpleNamespace(mode=mode, tree_fanout=2)
    kw = dict(compress=codec, robust=robust, topk_ratio=0.05, agg=agg, **_GEOM)
    ef = jcomms.codec_uses_feedback(codec)
    # every process's payload as it travels (built with the JAX codec; the
    # port's payloads are byte-equal, pinned above)
    if codec == "none":
        tw = (lambda p: (jax.tree_util.tree_map(np.asarray, contribs[p]), weights[p])
              if method != "mean" else
              (jax.tree_util.tree_map(lambda x: np.asarray(x) * weights[p], contribs[p]),
               weights[p]))
    else:
        def tw(p):
            acc = jax.tree_util.tree_map(lambda c, b: c - b, contribs[p], base)
            if ef:
                acc = jax.tree_util.tree_map(lambda a, r: a + r, acc, residual)
            return jcomms.encode_tree(acc, codec, 0.05, **_GEOM).payloads, weights[p]
    sent = [tw(p) for p in range(4)]
    stacked = (jax.tree_util.tree_map(lambda *xs: np.stack(xs), *[t for t, _ in sent]),
               np.asarray([w for _, w in sent], np.float32))
    monkeypatch.setattr(jmh, "_allgather_stacked", lambda tree_and_weight: stacked)
    monkeypatch.setattr(multihost, "_allgather_stacked",
                        lambda tree_and_weight, world=None: stacked)
    jreg, preg = jax_registry(), get_registry()
    before = [(_counter(r, "fed.dcn_bytes_up_total"), _counter(r, "fed.dcn_bytes_down_total"))
              for r in (jreg, preg)]
    jstate = jcomms.CodecState(copy.deepcopy(residual)) if ef else None
    pstate = comms.CodecState(copy.deepcopy(residual)) if ef else None
    want = jmh.aggregate_from_hosts(contribs[1], float(weights[1]),
                                    base=base if codec != "none" else None,
                                    codec_state=jstate, **kw)
    got = multihost.aggregate_from_hosts(contribs[1], float(weights[1]),
                                         base=base if codec != "none" else None,
                                         codec_state=pstate, **kw)
    for g, v in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(v))
    after = [(_counter(r, "fed.dcn_bytes_up_total"), _counter(r, "fed.dcn_bytes_down_total"))
             for r in (jreg, preg)]
    assert [a[0] - b[0] for a, b in zip(after, before)][0] == \
        [a[0] - b[0] for a, b in zip(after, before)][1] > 0
    if ef:
        for g, v in zip(jax.tree_util.tree_leaves(pstate.residual),
                        jax.tree_util.tree_leaves(jstate.residual)):
            np.testing.assert_array_equal(g, v)


def test_aggregate_one_process_world_and_sketch_robust_refusal():
    """A one-process world gathers itself (the P = 1 identity); a sketch
    under a robust method raises before any collective."""
    tree = _tree(seed=4)
    out = multihost.aggregate_from_hosts(tree, 2.0)
    for g, v in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_allclose(g, v, rtol=1e-7)
    with pytest.raises(ValueError, match="per-contribution decode"):
        multihost.aggregate_from_hosts(tree, 1.0, compress="countsketch",
                                       robust=SimpleNamespace(method="median", trim_k=1,
                                                              clip_norm=1.0))


# ------------------------------------------------------------- sharding
@pytest.mark.parametrize("procs", [1, 2, 3, 5])
def test_apply_process_sharding_matches_jax(procs):
    for pid in range(procs):
        for server_trains in (False, True):
            for num_shards in (0, 1, 3):
                rt = SimpleNamespace(num_processes=procs, process_id=pid)
                mine, theirs = ExperimentConfig(), JaxConfig()
                mine.data.num_shards = theirs.data.num_shards = num_shards
                apply_process_sharding(mine, rt, server_trains)
                jax_apply_process_sharding(theirs, rt, server_trains)
                assert (mine.data.num_shards, mine.data.shard_index) == \
                    (theirs.data.num_shards, theirs.data.shard_index)


# ---------------------------------------------------------------- trainer
# the leaves whose true gradient is 0 (tests/test_torch_train.py's noise-bound
# pair): their round deltas are rounding noise, which each package ranks its own way
_NOISE_LEAVES = ("w_k/bias", "att_fc2/bias")


def _topk_ties(pt: Trainer, jt: JaxTrainer) -> None:
    """Where the two packages kept different coordinates of a leaf in a
    round that started from equal residuals, both banked residuals show the
    swapped coordinates at one magnitude: a tie. The two noise-only leaves
    are left out, as the trajectory bars leave them out."""
    jres = jax.tree_util.tree_leaves(jt.state.ef_residual)
    names = comms.leaf_names(pt._client0_params())
    for c in range(len(pt.states)):
        for i, (jr, pr) in enumerate(zip(jres, pt.states[c].ef_residual)):
            if names[i].endswith(_NOISE_LEAVES):
                continue  # a true gradient of 0: its deltas are rounding noise
            jx, px = np.asarray(jr)[c].reshape(-1), pr.numpy().reshape(-1)
            j_kept, p_kept = jx == 0, px == 0
            swapped = np.flatnonzero(j_kept != p_kept)
            if swapped.size:
                mags = np.concatenate([np.abs(px[j_kept & ~p_kept]),
                                       np.abs(jx[p_kept & ~j_kept])])
                np.testing.assert_allclose(mags, mags[0], rtol=1e-5,
                                           err_msg=f"client {c} leaf {i}: not a tie")


def _assert_params_close_but_ties(got: dict, want: dict, lr: float, path: str = "") -> None:
    for key, sub in want.items():
        where = f"{path}.{key}" if path else key
        if isinstance(sub, dict):
            _assert_params_close_but_ties(got[key], sub, lr, where)
            continue
        d = np.abs(got[key] - sub)
        off = d > 1e-4 + 2e-4 * np.abs(sub)
        assert off.mean() <= 0.01, f"{where}: {int(off.sum())} coordinates off the bars"
        assert float(d.max()) <= lr, f"{where}: {float(d.max())} beyond one lr step"


@pytest.mark.parametrize("case", ["int8", "sign1bit", "topk", "countsketch", "randproj",
                                  "hierarchical_trimmed_mean"])
def test_trainer_codec_and_hierarchical_sync_match_jax(case):
    over = dict(_PARITY, train__eval_every=10**6)
    if not case.startswith("hierarchical"):
        over.update(fed__dcn_compress=case)
    jcfg = tiny_cfg(None, **over)
    if case.startswith("hierarchical"):
        jcfg.agg.mode = "hierarchical"
        jcfg.fed.robust.method, jcfg.fed.robust.trim_k = "trimmed_mean", 1
    data, toks = tiny_data(jcfg)
    pcfg = _port_cfg(jcfg)
    pcfg.agg.mode = jcfg.agg.mode
    pt = Trainer(pcfg, data, toks, device="cpu")
    jt = JaxTrainer(jcfg, data, toks)
    pt.set_global_params(*jax.tree_util.tree_map(np.asarray, jt._client0_params()))
    for r in range(3):
        _assert_round(jt.train_round(r), pt.train_round(r), f"{case} round {r}")
        if case == "topk" and r == 0:
            # from equal entries and zero residuals: any other kept set is a tie
            _topk_ties(pt, jt)
    if case.startswith("hierarchical"):
        assert pt.registry.gauge("agg.tier_reduce_ms").value() > 0
    for c in (0, 5):
        if case == "topk":
            _assert_params_close_but_ties(_to_flax(pt.states[c].model),
                                          _client_tree(jt.state, c), jcfg.optim.user_lr)
        else:
            _assert_tree_close(_to_flax(pt.states[c].model), _client_tree(jt.state, c))
    # the modeled uplink: one real encode's bytes a reporting client
    if not case.startswith("hierarchical"):
        assert pt._codec_bytes_per_client == jt._codec_bytes_per_client
        assert pt._dense_bytes_per_client == jt._dense_bytes_per_client


def test_residual_rides_the_population_sidecar_spill(tmp_path):
    """``ef_residual`` is a ``SIDECAR_FIELDS`` member: it spills to disk with
    the optimizer moments above the resident cap and reloads exactly; a
    reset (a quarantined client's heal) forgets it (the JAX package's
    ``tests/test_comms.py`` pin)."""
    from fedrec_tpu_torch.fed.population import SIDECAR_FIELDS, ClientPopulation

    assert "ef_residual" in SIDECAR_FIELDS
    pop = ClientPopulation(8, num_rows=64, resident_cap=2, spill_dir=tmp_path / "spill")
    mk = lambda c: {"step": np.int64(c),  # noqa: E731
                    "ef_residual": [np.full((4,), float(c), np.float32),
                                    np.full((2, 2), -float(c), np.float32)]}
    for c in range(5):
        pop.put_sidecar(c, mk(c))
    assert pop.spill_count == 3
    for c in range(5):
        for got, want in zip(pop.get_sidecar(c)["ef_residual"], mk(c)["ef_residual"]):
            np.testing.assert_array_equal(got, want)
    pop.reset_sidecar(1)
    assert pop.get_sidecar(1) is None


def test_residual_rides_snapshots_sidecars_and_heal(tmp_path):
    """sign1bit keeps a residual per client: it is saved and restored with a
    snapshot, it is a population sidecar field, and a healed client's is
    zero."""
    from fedrec_tpu_torch.fed.population import SIDECAR_FIELDS
    from fedrec_tpu_torch.train.checkpoint import host_states, load_host_states

    cfg = _port_cfg(tiny_cfg(None, **dict(_PARITY, fed__num_clients=2, fed__rounds=1,
                                          fed__dcn_compress="sign1bit",
                                          train__eval_every=10**6)))
    data, toks = tiny_data(tiny_cfg(None, **_PARITY))
    t = Trainer(cfg, data, toks, device="cpu")
    t.train_round(0)
    assert "ef_residual" in SIDECAR_FIELDS
    res = [r.clone() for r in t.states[1].ef_residual]
    assert any(bool(r.abs().sum() > 0) for r in res)
    snap = copy.deepcopy(host_states(t.states, 0))
    sidecar = t._read_sidecar(1)
    for r in t.states[1].ef_residual:
        r.zero_()
    t._write_sidecar(1, sidecar)
    assert all(torch.equal(a, b) for a, b in zip(t.states[1].ef_residual, res))
    # a first-time (or healed) logical client starts from a zero residual
    tpl = t._template_sidecar(3)["ef_residual"]
    assert [x.shape for x in tpl] == [tuple(r.shape) for r in res]
    assert not any(x.any() for x in tpl)
    t._heal_client(1)
    assert all(not r.any() for r in t.states[1].ef_residual)
    load_host_states(t.states, snap)
    assert all(torch.equal(a, b) for a, b in zip(t.states[1].ef_residual, res))
    buf = io.BytesIO()
    torch.save(snap, buf)
    assert buf.tell() > 0
