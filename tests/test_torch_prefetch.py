"""The port's prefetched data path (``data/prefetch.py``,
``data.prefetch_batches``) and its process shard
(``data.batcher.process_shard_indices``, ``data.num_shards``), each beside
the JAX test it follows (``tests/test_prefetch.py``).

Prefetch changes the schedule, never the data: the same batches in the same
order as the bare iterator, a producer exception at its position, no thread
left behind, and a ``Trainer`` run bitwise the same with it on or off. The
process shard equals the JAX package's bitwise.
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fedrec_tpu.data.batcher import process_shard_indices as jax_process_shard_indices
from fedrec_tpu_torch.data import (
    Prefetcher,
    TrainBatcher,
    index_samples,
    make_synthetic_mind,
    maybe_prefetch,
    process_shard_indices,
)
from fedrec_tpu_torch.obs import MetricsRegistry

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_population import _SAMPLED, _bits, _port_trainer, _same_bits  # noqa: E402


def _batcher(seed=0, batch_size=8):
    data = make_synthetic_mind(num_news=64, num_train=128, num_valid=8, title_len=12,
                               his_len_range=(2, 10), seed=seed)
    ix = index_samples(data.train_samples, data.nid2index, 10)
    return TrainBatcher(ix, batch_size, npratio=4, seed=seed)


def _arrays(b):
    return (b.candidates, b.history, b.labels)


def test_prefetch_yields_identical_batches_in_order():
    batcher = _batcher()
    bare = [_arrays(b) for b in batcher.epoch_batches_sharded(4, epoch=1)]
    pre = [_arrays(b) for b in Prefetcher(batcher.epoch_batches_sharded(4, epoch=1), depth=2)]
    assert len(bare) == len(pre) > 0
    for x, y in zip(bare, pre):
        for a, b in zip(x, y):
            np.testing.assert_array_equal(a, b)


def test_prefetch_transform_runs_and_order_holds():
    assert list(Prefetcher(range(100), depth=3, transform=lambda x: x * 2)) == [
        x * 2 for x in range(100)]
    assert list(maybe_prefetch(range(10), 0, lambda x: x + 1)) == list(range(1, 11))
    assert list(maybe_prefetch(range(4), 0)) == [0, 1, 2, 3]


def test_prefetch_depth_is_bounded_under_slow_consumer():
    produced = []

    def source():
        for i in range(50):
            produced.append(i)
            yield i

    pf = Prefetcher(source(), depth=2)
    it = iter(pf)
    for consumed in range(1, 6):
        next(it)
        time.sleep(0.03)
        assert len(produced) <= consumed + 2 + 1, (len(produced), consumed)
    pf.close()


def test_prefetch_relays_midepoch_exception_at_position():
    def source():
        yield from range(3)
        raise RuntimeError("batch build failed mid-epoch")

    pf = Prefetcher(source(), depth=2)
    got = []
    with pytest.raises(RuntimeError, match="mid-epoch"):
        for x in pf:
            got.append(x)
    assert got == [0, 1, 2]
    assert not pf._thread.is_alive()


def test_prefetch_close_unblocks_producer_and_joins():
    pf = Prefetcher(iter(range(10_000)), depth=1)
    it = iter(pf)
    assert next(it) == 0
    it.close()
    deadline = time.time() + 5
    while pf._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not pf._thread.is_alive(), "producer thread leaked after close()"
    pf.close()  # idempotent


def test_prefetch_context_manager_closes():
    with Prefetcher(iter(range(1000)), depth=1) as pf:
        assert next(iter(pf)) == 0
    assert not pf._thread.is_alive()


def test_prefetch_rejects_bad_depth():
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(range(3), depth=0)


def test_prefetch_threads_do_not_accumulate():
    before = threading.active_count()
    for _ in range(5):
        assert list(Prefetcher(range(20), depth=2)) == list(range(20))
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_prefetch_queue_health_telemetry():
    reg = MetricsRegistry()
    out = []
    for x in Prefetcher(range(20), depth=2, registry=reg):
        time.sleep(0.01)
        out.append(x)
    assert out == list(range(20))
    assert reg.counter("data.prefetch.producer_stall_total").value() > 0
    assert reg.counter("data.prefetch.items_total").value() == 20
    assert reg.gauge("data.prefetch.queue_depth").value() is not None

    def slow_source():
        for i in range(5):
            time.sleep(0.02)
            yield i

    reg2 = MetricsRegistry()
    assert list(Prefetcher(slow_source(), depth=2, registry=reg2)) == list(range(5))
    assert reg2.counter("data.prefetch.consumer_stall_total").value() > 0


@pytest.mark.parametrize("pop,over", [(0, {}), (16, _SAMPLED)])
def test_trainer_prefetch_on_and_off_is_bitwise(pop, over):
    """The fixed world and a sampled population: the same losses and
    parameters with ``data.prefetch_batches`` 2 as with 0, and no producer
    thread left when the run ends."""
    before = threading.active_count()
    runs = []
    for depth in (0, 2):
        t = _port_trainer(pop=pop, rounds=2, **{**over, "data.prefetch_batches": depth,
                                                "model.dropout_rate": 0.2})
        runs.append((t, [r.train_loss for r in t.run()]))
    (t0, l0), (t1, l1) = runs
    assert l0 == l1 and _same_bits(_bits(t0), _bits(t1))
    assert t1.registry.counter("data.prefetch.items_total").value() > 0
    assert t0.registry.counter("data.prefetch.items_total").value() == 0
    assert threading.active_count() <= before


def test_a_step_that_raises_joins_the_producer(monkeypatch):
    t = _port_trainer(pop=0, rounds=1, **{"data.prefetch_batches": 1})
    before = threading.active_count()

    def boom(*a, **kw):
        raise RuntimeError("step failed")

    monkeypatch.setattr(t, "train_step", boom)
    with pytest.raises(RuntimeError, match="step failed"):
        t.run()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


@pytest.mark.parametrize("n,shards,seed", [(259, 4, 0), (100, 3, 7), (17, 5, 2)])
def test_process_shard_indices_equal_jax(n, shards, seed):
    parts = [process_shard_indices(n, shards, i, seed) for i in range(shards)]
    for i, part in enumerate(parts):
        np.testing.assert_array_equal(part, jax_process_shard_indices(n, shards, i, seed))
    np.testing.assert_array_equal(np.sort(np.concatenate(parts)), np.arange(n))
    with pytest.raises(ValueError, match="shard_index"):
        process_shard_indices(n, shards, shards)


def test_trainer_trains_its_process_shard():
    t = _port_trainer(pop=0, rounds=1, **{"data.num_shards": 2, "data.shard_index": 1,
                                          "data.seed": 3})
    want = process_shard_indices(256, 2, 1, 3)
    assert len(t.train_ix) == len(want) == 128
    full = _port_trainer(pop=0, rounds=1)
    np.testing.assert_array_equal(t.train_ix.pos, full.train_ix.pos[want])
    assert torch.isfinite(torch.tensor(t.run()[0].train_loss))
