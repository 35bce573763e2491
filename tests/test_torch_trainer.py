"""Port parity for the federated round loop (CPU): the port's ``Trainer``
against the JAX package's on ``tests/test_trainer.py``'s tiny configuration
and data (K=8 clients on the 8 fake CPU devices of ``tests/conftest.py``,
joint mode, dropout 0, lr 3e-3 so that the trajectory moves, an evaluation
every round), then the port's snapshots: bitwise resume with dropout on,
``keep_best`` across a resume, the fallback from a corrupted newest
snapshot, the guided error on a model mismatch, and the refused levers.

Tolerances: ``tests/test_torch_train.py``'s trajectory bars — round losses
rtol 1e-5 / atol 1e-6, parameters rtol 2e-4 / atol 1e-4 (the two leaves
with a true gradient of zero at a 1e-3 noise bound). Validation means as in
``tests/test_torch_eval.py``: after every round the full-pool scores of
both packages agree at 1e-4, and every positive stands more than 1e-4 and
more than twice the largest score difference from each of its negatives
(asserted), so each impression's metrics are equal and the means differ
only by summation order (1e-6).
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fedrec_tpu.train.trainer import Trainer as JaxTrainer
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.data import make_synthetic_mind
from fedrec_tpu_torch.fed import participation_mask
from fedrec_tpu_torch.serve import build_recommend_fn
from fedrec_tpu_torch.serving import EmbeddingStore
from fedrec_tpu_torch.train import SnapshotIntegrityError, SnapshotManager, Trainer
from fedrec_tpu_torch.train.checkpoint import verify_state_tree

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train import _assert_tree_close, _client_tree, _to_flax  # noqa: E402
from test_trainer import tiny_cfg, tiny_data  # noqa: E402

_PARITY = dict(model__text_encoder_mode="head", model__dropout_rate=0.0,
               model__fuse_hot_path=True, model__use_pallas=True,
               optim__user_lr=3e-3, optim__news_lr=3e-3, fed__num_clients=8, fed__rounds=3,
               train__eval_every=1)
_SCORE_TOL = 1e-4
_MARGIN = 1e-4


def _port_cfg(jcfg) -> ExperimentConfig:
    """The port's config with the JAX config's values for every field the
    port has."""
    cfg = ExperimentConfig()
    for section in ("data", "model", "optim", "fed", "train"):
        mine = getattr(cfg, section)
        for key in vars(mine):
            setattr(mine, key, getattr(getattr(jcfg, section), key))
    return cfg


def _tiny(tmp_path=None, **over) -> ExperimentConfig:
    """``tiny_cfg`` for the port alone: joint mode on the kernel route."""
    over = {"model__text_encoder_mode": "head", "model__fuse_hot_path": True,
            "model__use_pallas": True, **over}
    return _port_cfg(tiny_cfg(tmp_path, **over))


def _full_scores(pos, pools, lens, user, table):
    pos_s = np.asarray((table[pos] * user).sum(-1))
    neg_s = np.asarray((table[pools] * user[:, None]).sum(-1))
    mask = np.arange(pools.shape[1])[None, :] < lens[:, None]
    return pos_s, np.where(mask, neg_s, np.nan)


def _check_eval_margins(jt: JaxTrainer, pt: Trainer) -> None:
    """The full-pool scores of client 0 in both packages agree, and every
    positive stands apart from its negatives."""
    ix = pt.valid_ix
    with torch.no_grad():
        table = pt._encode_corpus(0)
        user = pt.states[0].model.user_encoder(table[torch.from_numpy(ix.history).long()])
        got = _full_scores(ix.pos, ix.neg_pools, ix.neg_lens, user.numpy(), table.numpy())
    up, np_ = jt._client_params(0)
    jtab = jt._encode_corpus(np_)
    juser = jt.model.apply({"params": {"user_encoder": up}}, jtab[ix.history],
                           method=type(jt.model).encode_user)
    want = _full_scores(ix.pos, ix.neg_pools, ix.neg_lens, np.asarray(juser), np.asarray(jtab))
    diff = max(float(np.nanmax(np.abs(g - w))) for g, w in zip(got, want))
    margin = float(np.nanmin(np.abs(got[1] - got[0][:, None])))
    assert diff <= _SCORE_TOL, f"full-pool scores differ by {diff}"
    assert margin > max(_MARGIN, 2 * diff), f"margin {margin}: a closer pair may swap"


def _assert_round(jr, pr, name):
    assert pr.round_idx == jr.round_idx
    np.testing.assert_allclose(pr.train_loss, jr.train_loss, rtol=1e-5, atol=1e-6,
                               err_msg=f"{name}: round loss")
    assert set(pr.val_metrics) == set(jr.val_metrics), name
    for k, v in jr.val_metrics.items():
        np.testing.assert_allclose(pr.val_metrics[k], v, atol=1e-6, err_msg=f"{name}: {k}")


def _jax_round(jt: JaxTrainer, r: int, protocol: str):
    """One JAX round, evaluated on client 0 under ``protocol``. The clients
    are in sync after the round-end mean, so client 0's metrics are the
    aggregate; asking for client 0 skips the JAX trainer's eager
    clients-in-sync check, whose cross-device programs can outwait XLA's CPU
    collective deadline when the test machine is loaded (the process
    aborts)."""
    res = jt.train_round(r)
    res.val_metrics = {
        "full": lambda: jt.evaluate_full(client=0),
        "last4": lambda: jt.evaluate_full(last_k=4, client=0),
        "sampled": lambda: jt.evaluate(client=0),
    }[protocol]()
    return res


def test_trainer_matches_jax_over_evaluated_rounds():
    """Three rounds with full-pool eval, then one round each of the last4
    and sampled protocols and one at participation 0.5, where each package
    draws its own mask (equal: ``fed.strategies.jax_uniform``). The port
    evaluates through its own round loop (``train.eval_every=1``); the JAX
    side explicitly after each round."""
    jcfg = tiny_cfg(None, **_PARITY)
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

    for r, protocol in ((3, "last4"), (4, "sampled")):
        pt.cfg.train.eval_protocol = protocol
        jr, pr = _jax_round(jt, r, protocol), pt.train_round(r)
        assert set(pr.val_metrics) == ({"auc", "mrr", "ndcg5", "ndcg10"}
                                       | ({"loss"} if protocol == "sampled" else set()))
        _assert_round(jr, pr, protocol)
        _check_eval_margins(jt, pt)

    pt.cfg.train.eval_protocol = "full"
    jt.cfg.fed.participation = 0.5
    weights = jt._round_weights(5)
    assert weights.sum() == 4 and weights.shape == (8,)
    pt.cfg.fed.participation = 0.5
    np.testing.assert_array_equal(pt._round_weights(5), weights)
    _assert_round(_jax_round(jt, 5, "full"), pt.train_round(5), "participation 0.5")
    for c in (0, 5):
        _assert_tree_close(_to_flax(pt.states[c].model), _client_tree(jt.state, c))


def test_participation_mask_keeps_the_k_lowest_scores():
    np.testing.assert_array_equal(participation_mask(0, 5, 1.0), np.ones(5, np.float32))
    for k_clients, fraction, want in ((8, 0.5, 4), (8, 0.3, 2), (8, 0.01, 1), (3, 0.5, 2)):
        scores = np.asarray(jax.random.uniform(jax.random.PRNGKey(k_clients), (k_clients,)))
        mask = participation_mask(k_clients, k_clients, fraction)
        assert mask.dtype == np.float32 and mask.sum() == want
        np.testing.assert_array_equal(mask, (scores <= np.sort(scores)[want - 1]).astype(np.float32))


# ------------------------------------------------------------- snapshots
def _data_and_tokens(cfg):
    data = make_synthetic_mind(num_news=64, num_train=128, num_valid=32,
                               title_len=cfg.data.max_title_len,
                               his_len_range=(2, cfg.data.max_his_len), seed=0,
                               popular_frac=0.2)
    toks = np.random.default_rng(0).standard_normal(
        (64, cfg.data.max_title_len, cfg.model.bert_hidden)).astype(np.float32)
    return data, toks


def _client_bits(t: Trainer) -> list:
    out = []
    for st in t.states:
        out += [p.detach().clone() for p in st.model.parameters()]
        for opt in (st.opt_user, st.opt_news):
            out += [torch.tensor(opt.count), *opt.mu, *opt.nu]
        out += [torch.tensor(st.step), st.generator.get_state()]
    return out


def test_resume_is_bitwise_with_dropout_on(tmp_path):
    """2 rounds, then a fresh Trainer on the same directory resumes round 2:
    its loss, metrics, parameters, optimizer states and dropout streams
    equal a straight 3-round run's to the bit."""
    cfg = _tiny(tmp_path / "a", fed__rounds=3, model__dropout_rate=0.2)
    data, toks = _data_and_tokens(cfg)
    straight = Trainer(cfg, data, toks, device="cpu")
    hist_a = straight.run()

    cfg_b = _tiny(tmp_path / "b", fed__rounds=2, model__dropout_rate=0.2)
    Trainer(cfg_b, data, toks, device="cpu").run()
    cfg_b.fed.rounds = 3
    resumed = Trainer(cfg_b, data, toks, device="cpu")
    assert resumed.start_round == 2
    hist_b = resumed.run()
    assert [r.round_idx for r in hist_b] == [2]
    assert hist_b[0].train_loss == hist_a[2].train_loss
    assert hist_b[0].val_metrics == hist_a[2].val_metrics
    for a, b in zip(_client_bits(straight), _client_bits(resumed), strict=True):
        assert torch.equal(a, b)


def test_keep_best_survives_resume_and_a_corrupt_newest_snapshot_falls_back(tmp_path):
    cfg = _tiny(tmp_path, fed__rounds=3, train__keep_best=True, optim__user_lr=3e-3,
                optim__news_lr=3e-3)
    data, toks = _data_and_tokens(cfg)
    history = Trainer(cfg, data, toks, device="cpu").run()
    aucs = [r.val_metrics["auc"] for r in history]
    best_dir = tmp_path / "best"
    marker = json.loads((best_dir / "best.json").read_text())
    assert marker["auc"] == max(aucs) and aucs[marker["round"]] == max(aucs)
    assert (best_dir / "config.json").exists()
    assert SnapshotManager(best_dir).latest_round() == marker["round"]
    assert SnapshotManager(tmp_path).all_rounds() == [0, 1, 2]

    # truncate the newest snapshot: the resume falls back to round 1
    newest = tmp_path / "round_2" / "state.pt"
    newest.write_bytes(newest.read_bytes()[:1000])
    cfg.fed.rounds = 4
    t2 = Trainer(cfg, data, toks, device="cpu")
    assert t2.snapshots.last_restored_round == 1 and t2.start_round == 2
    assert t2._best_auc == marker["auc"]  # the incumbent best is kept
    t2.run()
    marker2 = json.loads((best_dir / "best.json").read_text())
    assert marker2["auc"] >= marker["auc"]
    # an explicit round gets no fallback
    newest = tmp_path / "round_3" / "state.pt"
    newest.write_bytes(newest.read_bytes()[:1000])
    mgr = SnapshotManager(tmp_path)
    with pytest.raises(RuntimeError, match="every retained snapshot"):
        mgr.restore(t2.states, round_idx=3)
    mgr.restore(t2.states)
    assert mgr.last_restored_round == 2


def test_snapshot_manager_retains_verifies_and_waits(tmp_path):
    cfg = _tiny(None, fed__num_clients=2)
    data, toks = _data_and_tokens(cfg)
    t = Trainer(cfg, data, toks, device="cpu")
    mgr = SnapshotManager(tmp_path, max_to_keep=2)
    for r in range(4):
        mgr.save(r, t.states)          # in the background
    assert mgr.latest_round() == 3     # waits for the writes
    assert mgr.all_rounds() == [2, 3]
    raw = mgr.restore_raw()
    assert raw["round"] == 3 and len(raw["clients"]) == 2
    verify_state_tree(raw)
    raw["clients"][1]["news_params"]["fc.weight"][0, 0] = float("nan")
    with pytest.raises(SnapshotIntegrityError, match=r"clients\[1\].news_params.fc.weight"):
        verify_state_tree(raw)
    mgr.close()


def test_resume_under_another_model_config_fails_with_a_guided_error(tmp_path):
    cfg = _tiny(tmp_path, fed__rounds=1)
    data, toks = _data_and_tokens(cfg)
    Trainer(cfg, data, toks, device="cpu").run()
    other = _tiny(tmp_path, fed__rounds=2, model__query_dim=8)
    with pytest.raises(ValueError, match="model.query_dim: snapshot=16 vs this run=8"):
        Trainer(other, data, toks, device="cpu")
    # the incumbent config.json survives: the record of the snapshot's run
    assert json.loads((tmp_path / "config.json").read_text())["model"]["query_dim"] == 16


@pytest.mark.parametrize("lever", [
    "privacy.enabled=1", "fed.seq_shards=2", "shard.table=1", "chaos.enabled=1",
    "obs.slo.enabled=1", "fed.dcn_compress=auto", "obs.fleet.collector=localhost:1",
    "obs.watch.anomaly_z=3", "obs.slo.objectives=x,obs.slo.enabled=1", "obs.wire.enabled=0",
])
def test_trainer_refuses_unported_levers_by_name(lever):
    """Each lever the port does not run raises, naming it and its Queue A
    item. Per-example DP-SGD runs now: on ``_tiny``'s fused route it meets
    the JAX package's own refusal. The wire faults run too (the run CLI's
    ``ChaosProxy`` in front of ``--agg-server``), and the trainer ignores
    them, as the JAX trainer does. Fleet observability runs too: the
    ``obs.fleet``, ``obs.slo``, ``obs.watch`` and ``obs.wire`` keys build
    the pusher, the watch and the envelope's settings, and a malformed
    objective meets the JAX watch's own refusal. ``fed.dcn_compress=auto``
    runs (the map pins after the warm-up), and ``fed.seq_shards=2`` runs
    inside the seq world the run CLI starts: a trainer without one is
    refused."""
    from fedrec_tpu_torch.obs import wire

    over = {"privacy.enabled=1": [lever, "privacy.sigma=1"],
            "chaos.enabled=1": [lever, "chaos.wire_faults=drop@*"]}.get(lever, lever.split(","))
    cfg = _tiny().apply_overrides(over)
    data, toks = _data_and_tokens(cfg)
    if lever == "chaos.enabled=1":
        assert Trainer(cfg, data, toks, device="cpu").cfg.chaos.wire_faults == "drop@*"
        return
    if lever == "fed.dcn_compress=auto":
        assert Trainer(cfg, data, toks, device="cpu")._sync_takes_entry
        return
    if lever == "fed.seq_shards=2":
        with pytest.raises(ValueError, match="fed.seq_shards=2 but the step has none"):
            Trainer(cfg.apply_overrides(["model.fuse_hot_path=0"]), data, toks, device="cpu")
        return
    if lever.startswith("obs.slo.objectives=x"):
        with pytest.raises(ValueError, match="bad obs.slo.objectives entry 'x'"):
            Trainer(cfg, data, toks, device="cpu")
        return
    if lever.startswith("obs."):
        try:
            trainer = Trainer(cfg, data, toks, device="cpu")
            assert wire.wire_enabled() == cfg.obs.wire.enabled
        finally:
            wire.configure_wire(enabled=True, window=32)
        assert (trainer.watch is not None) == cfg.obs.slo.enabled
        assert (trainer.fleet_pusher is not None) == bool(cfg.obs.fleet.collector)
        return
    name = over[-1].split("=")[0].split(".")[-1]
    if lever == "privacy.enabled=1":
        name = "model.fuse_hot_path with privacy.mechanism='dpsgd' is not supported"
    with pytest.raises(NotImplementedError, match=name) as e:
        Trainer(cfg, data, toks, device="cpu")
    if lever != "privacy.enabled=1":  # the JAX package's refusal names no item
        assert "Queue A item" in str(e.value)


def test_trainer_rejects_an_unknown_eval_protocol():
    cfg = _tiny().apply_overrides(["train.eval_protocol=topk"])
    data, toks = _data_and_tokens(cfg)
    with pytest.raises(ValueError, match="train.eval_protocol"):
        Trainer(cfg, data, toks, device="cpu")


def test_export_for_serving_feeds_the_store_and_the_scorer(capsys):
    cfg = _tiny(None, fed__strategy="local", fed__rounds=1)
    data, toks = _data_and_tokens(cfg)
    t = Trainer(cfg, data, toks, device="cpu")
    t.run()
    user, table = t.export_for_serving()
    assert "DIVERGED" in capsys.readouterr().out  # local: the clients differ
    assert table.shape == (64, cfg.model.news_dim)
    store = EmbeddingStore()
    store.publish(table, user)
    gen = store.current()
    ids, scores = build_recommend_fn(top_k=5, device="cpu")(
        gen.user_params, gen.news_vecs, torch.tensor([[3, 7, 0, 0], [1, 2, 5, 9]]))
    assert ids.shape == (2, 5) and bool(torch.isfinite(scores).all())
    assert not set(ids[1].tolist()) & {0, 1, 2, 5, 9}


def test_exported_tower_is_frozen_against_later_rounds():
    cfg = _tiny(None, fed__rounds=1)
    data, toks = _data_and_tokens(cfg)
    t = Trainer(cfg, data, toks, device="cpu")
    t.run()
    user, table = t.export_for_serving()
    his = table[torch.tensor([[3, 7, 0, 0], [1, 2, 5, 9]])]
    with torch.no_grad():
        before = user(his)
    t.train_round(1)
    live = t.states[0].model.user_encoder
    assert not all(torch.equal(p, q) for p, q in zip(user.parameters(), live.parameters()))
    assert not any(p.requires_grad for p in user.parameters())
    with torch.no_grad():
        assert torch.equal(user(his), before)
