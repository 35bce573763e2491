"""The port's recommend CLI (``python -m fedrec_tpu_torch.cli.recommend``)
against the JAX package's (``fedrec_tpu.cli.recommend``) on a tiny
reference-layout artifact directory (CPU). Both ``load_checkpoint_params``
are stubbed to return one parameter tree (the port's bridged from it by
``params.from_flax``), and both CLIs read the same training ``config.json``
next to the snapshots, with ``--set`` on top.

Bars: the same users in the same order; scores (printed to 5 places) within
1e-4; news ids equal wherever neighbouring scores are more than 1e-4 apart.
"""

import contextlib
import io
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fedrec_tpu.serving.store as jax_store
import fedrec_tpu_torch.serving as port_serving
from fedrec_tpu.cli import recommend as jax_recommend
from fedrec_tpu.config import ModelConfig as JaxModelConfig
from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
from fedrec_tpu_torch.cli import recommend
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.data import make_synthetic_mind
from fedrec_tpu_torch.device import NoGPUError
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.params import from_flax

_SMALL = ["model.news_dim=32", "model.num_heads=4", "model.head_dim=8", "model.query_dim=16",
          "model.bert_hidden=48", "data.max_his_len=10", "data.max_title_len=6",
          "model.fuse_hot_path=true", "model.use_pallas=true"]
_TOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("recommend")
    art = root / "UserData"
    art.mkdir()
    data = make_synthetic_mind(num_news=40, num_train=48, num_valid=8, title_len=6,
                               his_len_range=(1, 10), seed=1)
    np.save(art / "bert_news_index.npy", data.news_tokens)
    np.save(art / "token_states.npy",
            np.random.default_rng(2).standard_normal((40, 6, 48)).astype(np.float32))
    for name, obj in (("bert_nid2index.pkl", data.nid2index),
                      ("train_sam_uid.pkl", data.train_samples),
                      ("valid_sam_uid.pkl", data.valid_samples)):
        with open(art / name, "wb") as f:
            pickle.dump(obj, f)
    # the training run's config.json: the small widths; --set max_his_len on top
    snaps = root / "snaps"
    snaps.mkdir()
    (snaps / "config.json").write_text(ExperimentConfig().apply_overrides(_SMALL).to_json())

    cfg = ExperimentConfig().apply_overrides(_SMALL).model
    jm = JaxNewsRecommender(JaxModelConfig(**{k: getattr(cfg, k) for k in (
        "news_dim", "num_heads", "head_dim", "query_dim", "bert_hidden")}))
    toks = jnp.zeros((2, 6, 48), jnp.float32)
    his = jnp.zeros((2, 8, 32), jnp.float32)
    tree = jm.init(jax.random.PRNGKey(7), toks, his[:, :3], his,
                   method=JaxNewsRecommender.init_both_towers)
    tree = jax.tree_util.tree_map(np.asarray, tree["params"])
    tm = NewsRecommender(cfg)
    from_flax(tm, tree)
    port_params = tuple({k: p.detach().clone() for k, p in m.named_parameters()}
                        for m in (tm.user_encoder, tm.text_head))
    return art, snaps, tree, port_params


def _run(main, argv) -> tuple[int, str]:
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


def _both(setup, monkeypatch, tmp_path, *extra: str):
    art, snaps, tree, (user, news) = setup
    monkeypatch.setattr(jax_store, "load_checkpoint_params",
                        lambda d, log=None: (tree["user_encoder"], tree["text_head"], 3, "orbax"))
    monkeypatch.setattr(port_serving, "load_checkpoint_params",
                        lambda d, log=None: (user, news, 3, "torch"))
    argv = ["--data-dir", str(art), "--snapshot-dir", str(snaps), "--top-k", "5",
            "--batch-users", "16", "--set", "data.max_his_len=8", *extra]
    out = {}
    for name, main, more in (("jax", jax_recommend.main, []),
                             ("port", recommend.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        rc, err = _run(main, [*argv, *more, "--out", str(path)])
        assert rc == 0, err
        assert "using training config" in err
        out[name] = [json.loads(ln) for ln in path.read_text().splitlines()]
    return out["port"], out["jax"]


def _assert_lines_agree(got, want):
    assert [g["uid"] for g in got] == [w["uid"] for w in want]
    for g, w in zip(got, want):
        assert len(g["news"]) == len(w["news"]) == len(g["scores"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=_TOL)
        s = np.asarray(w["scores"])
        gaps = np.abs(np.diff(s))
        apart = np.concatenate([[np.inf], gaps]) > _TOL
        apart &= np.concatenate([gaps, [np.inf]]) > _TOL
        assert [n for n, a in zip(g["news"], apart) if a] == [n for n, a in zip(w["news"], apart)
                                                            if a]


@pytest.mark.parametrize("extra", [[], ["--keep-history"], ["--uids", "U3", "U0", "nobody"]],
                         ids=["all_users", "keep_history", "uid_subset"])
def test_recommend_cli_lines_match_jax(setup, monkeypatch, tmp_path, extra):
    got, want = _both(setup, monkeypatch, tmp_path, *extra)
    assert len(got) == (2 if extra[:1] == ["--uids"] else 48)
    _assert_lines_agree(got, want)
    if not extra:
        assert all(0 < len(g["news"]) <= 5 for g in got)


def test_recommend_cli_refusals(setup, monkeypatch, tmp_path):
    art, snaps, _, (user, news) = setup
    monkeypatch.setattr(port_serving, "load_checkpoint_params",
                        lambda d, log=None: (user, news, 3, "torch"))
    base = ["--data-dir", str(art), "--snapshot-dir", str(snaps), "--out", str(tmp_path / "o")]
    rc, err = _run(recommend.main, [*base, "--device", "cpu", "--token-states",
                                    str(tmp_path / "absent.npy")])
    assert rc == 2 and "no token states" in err
    # a finetune config over a head-mode snapshot: the trunk is missing
    with pytest.raises(ValueError, match="news_params .* do not fit"):
        _run(recommend.main, [*base, "--device", "cpu", "--set",
                              "model.text_encoder_mode=finetune"])
    with pytest.raises(NoGPUError):
        _run(recommend.main, base)
    monkeypatch.undo()
    rc, err = _run(recommend.main, [*base, "--device", "cpu"])  # no snapshot there
    assert rc == 2 and "round_<r>/state.pt" in err


def test_recommend_cli_random_states_match_jax(setup, monkeypatch, tmp_path):
    """``--allow-random-states`` draws the same seeded states in both."""
    got, want = _both(setup, monkeypatch, tmp_path, "--allow-random-states",
                      "--token-states", str(tmp_path / "absent.npy"))
    _assert_lines_agree(got, want)
