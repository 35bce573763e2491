"""Port parity for ``fed.dcn_compress="auto"`` (CPU): the per-leaf codec
map of ``comms.codecs`` (payloads byte-identical to the JAX package's under
the same map), the trainer's pin after the warm-up window (the same map and
reconstruction errors as the JAX rule on the same round delta), its
artifacts (``codec_map.json``, the logger's row, the report's
``auto_codec_map``), the warm-up rounds against ``dcn_compress="none"`` and
the refusals, each with the JAX package's words.

The JAX ``Trainer``'s own auto test is marked slow; the JAX side here is its
selection rule (``encode_leaf`` / ``decode_leaf``, the dense floor) applied
to the port's recorded delta.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import fedrec_tpu.comms as jcomms
from fedrec_tpu.train.trainer import Trainer as JaxTrainer
from fedrec_tpu_torch import comms
from fedrec_tpu_torch.obs.report import build_report, load_jsonl
from fedrec_tpu_torch.train import Trainer

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_comms import _GEOM, _assert_payload_equal, _tree  # noqa: E402
from test_torch_trainer import _port_cfg  # noqa: E402
from test_trainer import tiny_cfg, tiny_data  # noqa: E402

_AUTO = dict(fed__dcn_compress="auto", fed__dcn_auto_warmup=1, fed__dcn_topk_ratio=0.05,
             fed__dcn_sketch_width=0.25, fed__dcn_sketch_seed=3,
             model__text_encoder_mode="head", model__dropout_rate=0.0)


def _map_for(tree) -> list[str]:
    """A per-leaf map that uses every codec, by leaf index."""
    codecs = ("topk", "countsketch", "none", "int8", "sign1bit", "randproj")
    return [codecs[i % len(codecs)] for i in range(len(jax.tree_util.tree_leaves(tree)))]


def test_per_leaf_payloads_are_byte_equal_to_jax():
    tree = _tree()
    leaf_codecs = _map_for(tree)
    mine = comms.encode_tree(tree, "auto", 0.05, leaf_codecs=leaf_codecs, **_GEOM)
    theirs = jcomms.encode_tree(tree, "auto", 0.05, leaf_codecs=leaf_codecs, **_GEOM)
    assert mine.leaf_codecs == theirs.leaf_codecs == leaf_codecs
    for i, (g, w) in enumerate(zip(mine.payloads, theirs.payloads)):
        assert mine.leaf_codec(i) == theirs.leaf_codec(i)
        _assert_payload_equal(g, w, f"leaf {i} ({leaf_codecs[i]})")
    assert mine.nbytes() == theirs.nbytes()
    for g, w in zip(jax.tree_util.tree_leaves(comms.decode_tree(mine)),
                    jax.tree_util.tree_leaves(jcomms.decode_tree(theirs))):
        np.testing.assert_array_equal(g, w)
    # the gathered decode, per leaf by its own codec (the decodable ones)
    dec_map = [c if c in ("none", "int8", "sign1bit", "topk") else "none" for c in leaf_codecs]
    mine = comms.encode_tree(tree, "auto", 0.05, leaf_codecs=dec_map, **_GEOM)
    theirs = jcomms.encode_tree(tree, "auto", 0.05, leaf_codecs=dec_map, **_GEOM)
    gathered = [{k: np.stack([np.asarray(v)] * 2) for k, v in p.items()} for p in mine.payloads]
    for g, w in zip(jax.tree_util.tree_leaves(comms.decode_gathered(gathered, mine)),
                    jax.tree_util.tree_leaves(jcomms.decode_gathered(gathered, theirs))):
        np.testing.assert_array_equal(g, w)


def test_per_leaf_map_refuses_a_stale_length_and_feedback_follows_jax():
    tree = _tree()
    n = len(jax.tree_util.tree_leaves(tree))
    with pytest.raises(ValueError) as got:
        comms.encode_tree(tree, "auto", leaf_codecs=["none"] * (n - 1))
    with pytest.raises(ValueError) as want:
        jcomms.encode_tree(tree, "auto", leaf_codecs=["none"] * (n - 1))
    assert str(got.value) == str(want.value)
    for codec in ("auto", "none", "topk", "countsketch"):
        for ef in (True, False):
            assert comms.codec_uses_feedback(codec, ef) == jcomms.codec_uses_feedback(codec, ef)


def _auto_cfg(tmp_path, **over):
    return _port_cfg(tiny_cfg(tmp_path, **{**_AUTO, **over}))


def _run(cfg, obs_dir: Path | None = None):
    if obs_dir is not None:
        cfg.obs.dir = str(obs_dir)
    data, toks = tiny_data(cfg)
    trainer = Trainer(cfg, data, toks, device="cpu")
    return trainer, trainer.run()


def _jax_pick(delta: list[np.ndarray], names: list[str], cfg) -> tuple[list[str], list[dict]]:
    """The JAX trainer's selection rule (``_pin_auto_codec_map``) through the
    JAX package's wire codecs."""
    chosen, detail = [], []
    for i, (name, d) in enumerate(zip(names, delta)):
        if d.size <= JaxTrainer._AUTO_DENSE_FLOOR:
            chosen.append("none")
            detail.append({"leaf": name, "codec": "none", "n": int(d.size)})
            continue
        errs = {}
        for cand in ("topk", "countsketch"):
            rec = jcomms.decode_leaf(
                jcomms.encode_leaf(d, cand, cfg.fed.dcn_topk_ratio,
                                   sketch_width=cfg.fed.dcn_sketch_width,
                                   sketch_seed=cfg.fed.dcn_sketch_seed, leaf_id=i),
                cand, d.shape, sketch_seed=cfg.fed.dcn_sketch_seed, leaf_id=i)
            errs[cand] = float(np.sqrt(np.mean((rec - d) ** 2)))
        pick = "topk" if errs["topk"] <= errs["countsketch"] else "countsketch"
        chosen.append(pick)
        detail.append({"leaf": name, "codec": pick, "n": int(d.size),
                       "rmse_topk": errs["topk"], "rmse_countsketch": errs["countsketch"]})
    return chosen, detail


def test_pin_gives_jax_map_and_errors_on_the_same_delta(tmp_path):
    """One warm-up round, then the pin: the map and the per-leaf RMSEs equal
    the JAX rule's on the same global round delta (client 0's round-entry
    leaves against its post-sync ones), and the leaf names are JAX's."""
    cfg = _auto_cfg(None, fed__rounds=1)
    data, toks = tiny_data(cfg)
    trainer = Trainer(cfg, data, toks, device="cpu")
    entry = trainer._contribution_host(0)
    trainer.run()
    pin = trainer.auto_codec_pin
    assert pin["pinned_at_round"] == 0 and pin["warmup_rounds"] == 1
    post = trainer._contribution_host(0)
    names = jcomms.leaf_names(trainer._client0_params())
    want_map, want_detail = _jax_pick([p - e for p, e in zip(post, entry)], names, cfg)
    assert list(pin["map"]) == names and list(pin["map"].values()) == want_map
    assert trainer._auto_leaf_codecs == want_map
    assert {"topk", "none"} <= set(want_map)
    for got, want in zip(pin["detail"], want_detail):
        assert got.keys() == want.keys() and got["codec"] == want["codec"]
        for key in ("rmse_topk", "rmse_countsketch"):
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=got["leaf"])
    # every leaf of at most 64 elements stays dense
    assert all(d["codec"] == "none" for d in pin["detail"] if d["n"] <= 64)


def test_auto_run_writes_the_map_and_the_report_row(tmp_path, capsys):
    """Three rounds under "auto": the map pins after round 0, lands in
    ``codec_map.json`` beside the artifacts and in the report's
    ``auto_codec_map``, the uplink is priced again (fewer bytes than the
    dense tree) and the round losses stay finite."""
    obs = tmp_path / "obs"
    trainer, history = _run(_auto_cfg(None, fed__rounds=3), obs)
    assert "fed.dcn_compress=auto pinned per-leaf codec map after round 0" in capsys.readouterr().out
    saved = json.loads((obs / "codec_map.json").read_text())
    assert saved["map"] == trainer.auto_codec_pin["map"] and saved["pinned_at_round"] == 0
    assert saved.keys() == {"pinned_at_round", "warmup_rounds", "sketch_width", "sketch_seed",
                            "topk_ratio", "map", "detail"}
    records, snaps = load_jsonl(obs / "metrics.jsonl")
    report = build_report(records, snaps)
    assert report["communication"]["auto_codec_map"] == saved["map"]
    assert trainer._codec_bytes_per_client < trainer._dense_bytes_per_client
    assert all(np.isfinite(r.train_loss) for r in history)
    assert all(0.0 <= r.val_metrics["auc"] <= 1.0 for r in history)
    # the EF residual banks only on the biased (topk) leaves
    for st in trainer.states:
        for r, codec in zip(st.ef_residual, trainer._auto_leaf_codecs):
            if codec != "topk":
                assert not bool(r.any())


def test_auto_run_repeats_bitwise(tmp_path):
    runs = [_run(_auto_cfg(None, fed__rounds=2)) for _ in range(2)]
    (a, ha), (b, hb) = runs
    assert a.auto_codec_pin["map"] == b.auto_codec_pin["map"]
    assert [r.train_loss for r in ha] == [r.train_loss for r in hb]
    for sa, sb in zip(a.states, b.states):
        assert all(torch.equal(p, q) for p, q in zip(sa.model.parameters(), sb.model.parameters()))


def test_warmup_rounds_track_dcn_compress_none(tmp_path):
    """Before the pin the sync runs an all-"none" map through the codec
    body (entry + the mean of the deltas): two warm-up rounds stay within
    the trajectory bars (losses 1e-5, parameters rtol 2e-4 / atol 1e-4) of
    the same rounds under ``dcn_compress="none"``."""
    (auto, ha), (dense, hd) = (_run(_auto_cfg(None, fed__rounds=2, fed__dcn_auto_warmup=3)),
                               _run(_auto_cfg(None, fed__rounds=2, fed__dcn_compress="none")))
    assert auto.auto_codec_pin is None
    np.testing.assert_allclose([r.train_loss for r in ha], [r.train_loss for r in hd],
                               rtol=1e-5, atol=1e-6)
    for p, q in zip(auto.states[0].model.parameters(), dense.states[0].model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["robust", "warmup", "fsdp"])
def test_trainer_refusals_match_jax_word_for_word(case):
    over = {"robust": dict(), "warmup": dict(fed__dcn_auto_warmup=0), "fsdp": dict()}[case]
    jcfg = tiny_cfg(None, **{**_AUTO, **over})
    cfg = _port_cfg(jcfg)
    if case == "robust":
        jcfg.fed.robust.method = cfg.fed.robust.method = "trimmed_mean"
    if case == "fsdp":
        jcfg.shard.fsdp = cfg.shard.fsdp = 2
    data, toks = tiny_data(jcfg)
    with pytest.raises(ValueError) as want:
        JaxTrainer(jcfg, data, toks)
    with pytest.raises(ValueError) as got:
        Trainer(cfg, data, toks, device="cpu")
    assert str(got.value) == str(want.value)


def test_async_and_coordinator_refuse_auto():
    from fedrec_tpu_torch.cli import coordinator

    cfg = _auto_cfg(None, agg__mode="async")
    cfg.agg.mode = "async"
    data, toks = tiny_data(cfg)
    with pytest.raises(ValueError, match="agg.mode='async' is incompatible with "
                                         "fed.dcn_compress='auto'"):
        Trainer(cfg, data, toks, device="cpu")
    argv = ["1", "8", "1", "--synthetic", "--device", "cpu", "--set", "fed.dcn_compress=auto",
            "--coordinator", "127.0.0.1:1", "--num-processes", "1", "--process-id", "0"]
    with pytest.raises(ValueError) as got:
        coordinator.main(argv)
    assert str(got.value) == (
        "fed.dcn_compress='auto' needs the trainer's warmup telemetry and is not available "
        "on the coordinator path; pin a concrete codec "
        "(int8/sign1bit/topk/countsketch/randproj) per deployment")
