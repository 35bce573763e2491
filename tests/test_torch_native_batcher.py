"""The port's native C++ batcher (CPU): built with ``g++`` from the port's
own copy of the engine, it gives batches bitwise equal to the JAX package's
``NativeTrainBatcher`` for the same seed (the engine's own RNG, so the
negatives are not numpy's); its shapes, positives, histories and padding
match the Python ``TrainBatcher``; a failed build raises (no fallback), and
the trainer selects it under ``data.native_loader``. Exact equality
throughout: the same integer arithmetic on the same inputs.
"""

from pathlib import Path

import numpy as np
import pytest

from fedrec_tpu.data import native_batcher as jax_native
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.data import IndexedSamples, TrainBatcher, make_synthetic_mind
from fedrec_tpu_torch.data import native_batcher
from fedrec_tpu_torch.data.native_batcher import NativeBuildError, NativeTrainBatcher
from fedrec_tpu_torch.train import Trainer

_FIELDS = ("candidates", "history", "his_len", "labels")


def _indexed(n=37, max_pool=12, max_his=10, seed=0, short_pools=False) -> IndexedSamples:
    rng = np.random.default_rng(seed)
    pos = rng.integers(1, 200, n).astype(np.int32)
    neg_lens = (rng.integers(1, 4, n) if short_pools
                else rng.integers(6, max_pool + 1, n)).astype(np.int32)
    neg_pools = np.zeros((n, max_pool), np.int32)
    for i in range(n):
        neg_pools[i, : neg_lens[i]] = rng.integers(1, 200, neg_lens[i])
    his_len = rng.integers(0, max_his + 1, n).astype(np.int32)
    history = np.zeros((n, max_his), np.int32)
    for i in range(n):
        history[i, : his_len[i]] = rng.integers(1, 200, his_len[i])
    return IndexedSamples(pos, neg_pools, neg_lens, history, his_len)


def _equal(a, b, what: str) -> None:
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{what}: {f}")


@pytest.mark.parametrize("shuffle,drop_remainder,clients", [
    (True, True, 3), (True, False, 1), (False, False, 4), (False, True, 2)])
def test_batches_equal_the_jax_engines_bitwise(shuffle, drop_remainder, clients):
    ix = _indexed(n=61)
    kw = dict(batch_size=8, npratio=4, shuffle=shuffle, drop_remainder=drop_remainder, seed=5)
    ours = NativeTrainBatcher(ix, num_threads=4, **kw)
    theirs = jax_native.NativeTrainBatcher(ix, num_threads=4, **kw)
    for epoch in (0, 3):
        got = list(ours.epoch_batches_sharded(clients, epoch))
        want = list(theirs.epoch_batches_sharded(clients, epoch))
        assert len(got) == len(want) > 0
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"epoch {epoch} batch {i}")
        for i, (a, b) in enumerate(zip(ours.epoch_batches(epoch), theirs.epoch_batches(epoch))):
            _equal(a, b, f"unsharded epoch {epoch} batch {i}")
        _equal(ours.epoch_arrays_sharded(clients, epoch),
               theirs.epoch_arrays_sharded(clients, epoch), f"epoch {epoch} arrays")
    assert ours.num_batches() == theirs.num_batches()


def test_shapes_and_padding_match_the_python_batcher():
    """Everything the RNG does not touch equals the Python batcher's:
    shapes, positives, histories, lengths, labels, the wrap-around pad."""
    for n, clients in ((53, 4), (5, 1)):
        ix = _indexed(n=n)
        kw = dict(batch_size=8, npratio=4, shuffle=False, drop_remainder=False, seed=3)
        py, nat = TrainBatcher(ix, **kw), NativeTrainBatcher(ix, **kw)
        pb, nb = (list(b.epoch_batches_sharded(clients, 0)) for b in (py, nat))
        assert len(pb) == len(nb) > 0
        for p, q in zip(pb, nb):
            assert q.candidates.shape == p.candidates.shape == (clients, 8, 5)
            assert q.candidates.dtype == p.candidates.dtype == np.int32
            np.testing.assert_array_equal(q.candidates[..., 0], p.candidates[..., 0])
            np.testing.assert_array_equal(q.history, p.history)
            np.testing.assert_array_equal(q.his_len, p.his_len)
            np.testing.assert_array_equal(q.labels, p.labels)


def test_short_pools_keep_the_whole_pool_and_pad_with_zero():
    ix = _indexed(n=16, short_pools=True)
    nat = NativeTrainBatcher(ix, batch_size=16, npratio=4, shuffle=False, drop_remainder=False)
    (batch,) = list(nat.epoch_batches(0))
    for j in range(16):
        k = int(ix.neg_lens[j])
        negs = batch.candidates[j, 1:]
        assert set(negs[:k].tolist()) == set(ix.neg_pools[j, :k].tolist())
        assert (negs[k:] == 0).all()


def test_the_library_is_the_ports_own_build():
    lib = native_batcher.library_path()
    assert lib.parent == Path(native_batcher.__file__).resolve().parents[2] / "build" / \
        "fedrec_tpu_torch_native"
    assert native_batcher.SOURCE.parent.name == "csrc"
    native_batcher.load()
    assert lib.exists()


def test_a_failed_build_raises_naming_the_compiler(tmp_path, monkeypatch):
    bad = tmp_path / "fedrec_data.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native_batcher, "build_dir", lambda: tmp_path / "build")
    with pytest.raises(NativeBuildError, match="native engine build failed"):
        native_batcher.build(bad)
    # the batcher raises too: no fallback to the Python batcher
    monkeypatch.setattr(native_batcher, "SOURCE", bad)
    monkeypatch.setattr(native_batcher, "_lib", None)
    with pytest.raises(NativeBuildError):
        NativeTrainBatcher(_indexed(), batch_size=8)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(NativeBuildError):
        native_batcher.build(bad)
    cfg = ExperimentConfig().apply_overrides([
        "model.text_encoder_mode=head", "model.news_dim=8", "model.num_heads=2",
        "model.head_dim=4", "model.query_dim=4", "model.bert_hidden=8", "data.max_his_len=4",
        "data.max_title_len=5", "data.batch_size=2", "fed.num_clients=2",
        "train.snapshot_dir=", "data.native_loader=1"])
    data = make_synthetic_mind(num_news=12, num_train=8, num_valid=2, title_len=5,
                               his_len_range=(1, 4))
    with pytest.raises(NativeBuildError):
        Trainer(cfg, data, np.zeros((12, 5, 8), np.float32), device="cpu")


def test_the_trainer_selects_the_native_batcher():
    cfg = ExperimentConfig().apply_overrides([
        "model.text_encoder_mode=head", "model.news_dim=8", "model.num_heads=2",
        "model.head_dim=4", "model.query_dim=4", "model.bert_hidden=8", "data.max_his_len=4",
        "data.max_title_len=5", "data.batch_size=2", "fed.num_clients=2", "fed.rounds=1",
        "train.snapshot_dir=", "data.native_loader=1"])
    data = make_synthetic_mind(num_news=12, num_train=16, num_valid=4, title_len=5,
                               his_len_range=(1, 4))
    t = Trainer(cfg, data, np.random.default_rng(0).standard_normal((12, 5, 8)).astype(
        np.float32), device="cpu")
    assert isinstance(t.batcher, NativeTrainBatcher)
    (result,) = t.run()
    assert np.isfinite(result.train_loss)
