#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``fedrec_tpu_torch``).

Builds the port's CUDA kernels from ``fedrec_tpu_torch/ops/csrc``, holds
each against its plain PyTorch version on the card (forward and gradients),
then drives sixteen paths at full width through the entry points a user calls:

* ``main_path`` (serving): corpus encode of a 65,536-news catalog of seeded
  frozen-trunk token states (50 x 768, kernel A), publish,
  ``ServingService.warmup`` and a JSON-lines TCP server answering a few
  hundred requests (kernel B on every batch); then the port's
  ``ServingClient`` with the wire envelope (an echoed reply envelope, the
  edge's RTT in the client's registry) and an unmeetable ``obs.slo``
  objective over ``serve.p99_ms`` (a firing alert from ``{"cmd":
  "alerts"}``);
* ``train_path`` (training): one federated ``param_avg`` round of the
  joint-mode train step over the same token states — 4 clients x 8 local
  steps at B=64, then the round-end mean (kernels B, C, D and E on every
  step) — then the kernel route against the pure-PyTorch dense route over
  5 steps, and the same 3 steps twice for bitwise-equal parameters;
* ``long_path`` (the long-history user tower, ``use_pallas`` without
  ``fuse_hot_path``, 2048-click histories): the server answering waves of
  1,024-2,048-click requests (kernels A, F1 and A2), against the dense
  route; then one ``param_avg`` round of 2 clients x 4 steps at B=16
  (kernels A, F1, F2, F3 and A2), the kernel route against the dense route
  over 3 steps, and the same 3 steps twice for bitwise-equal parameters;
* ``trainer_path`` (a whole federated run through ``train.trainer.Trainer``):
  3 ``param_avg`` rounds of 4 clients x 4 steps at B=64 (kernels B, C, D
  and E), each followed by a full-pool evaluation of 8,192 impressions (the
  corpus encode on kernel A, the user vectors on kernel B at n = 256), a
  snapshot and the best-AUC snapshot; then the export served through the
  store and the scorer, the same run on the dense route, and a 2-round run
  resumed to 3 rounds, bitwise equal to the uninterrupted one;
* ``decoupled_path`` (the JAX CLI's default run: decoupled mode, the
  config's default): ``Trainer.run`` for 3 ``param_avg`` rounds of 4 clients
  x 2 local epochs of 4 steps at B=64, each epoch ended by the news update
  (the corpus-wide replay of the accumulated news gradients through the
  text head: kernel A and its plain-autograd backward), each round by the
  table's refresh and a full-pool evaluation of 8,192 impressions on the
  cached table (kernels B and E on every step, B at n = 256 on every eval
  batch), snapshots and ``keep_best``; then the same run on the dense
  route, a 2-round run resumed to 3, a repeat (both bitwise), the export
  served; one ldp_news round against the same round without noise (the
  user tower bitwise equal); and ``fedrec_tpu_torch.cli.run`` in this
  process, decoupled, ``--mode joint`` and ``--dp-epsilon 8``;
* ``safety_path`` (training safety at full width): the health sentry on
  and off through the fused joint step and the decoupled step (bitwise
  equal trajectories, the sentry's cost); a chaos NaN update on client 2
  in round 1 through ``Trainer``, aborted with ``recover=false``, then
  quarantined, rolled back and replayed with ``recover=true``, twice,
  bitwise; joint-mode per-example DP-SGD on the dense route and on the
  ``use_pallas`` route (kernels A and F1-F3 under ``torch.func.vmap``, a
  constant launch count a step whatever B), dp_scope all and user, the
  kernel route's clipped gradients against the plain route's, and the run
  CLI's ``--mode joint --dp-epsilon 10``; robust aggregation: the round-end
  sync by method at K = 4 and 16, and three rounds under a x1000 poison;
* ``cohort_path`` (a sampled cross-device run through ``Trainer``): 256
  logical clients of 128 training rows each, drawn onto 4 slots a round
  (skew sampler, over-selection 1.25) under population dropout 0.2 and
  lognormal stragglers (median 40 ms) cut at an 80 ms deadline with a
  quorum of 2, their optimizer sidecars persisted (8 resident, the rest
  spilled to disk), FedAvgM at round end and the batches prefetched: 10
  rounds of 2 steps at B=64 (kernels B, C, D and E on every step), then a
  full-pool evaluation of 8,192 impressions (A, B); a bitwise repeat, 4
  rounds resumed to 10 bitwise (sidecars included), prefetch off bitwise,
  the dense route over 4 rounds, population == slots bitwise the fixed
  world, a quorum replay, the logical-client quarantine, FedAdam, and a
  decoupled leg (16 clients, 2 rounds); install, spill, FedOpt and sampler
  costs;
* ``async_path`` (the buffered quorum commit, ``agg.mode=async``, in
  ``Trainer``): the cohort path's population without its deadline, 6 rounds
  synchronous then 6 async at quorum 3 of 4 slots (the later reporters fold
  into the next commit, weighted by staleness): round times, each commit's
  ``agg.quorum_wait_ms`` and ``agg.gate_saved_ms``, a bitwise repeat, the
  dense route at the train path's bars (B, C, D, E, and A in the evaluation);
* ``data_path`` (raw tsv -> trunk -> train -> recommend): a MIND-format
  ``news.tsv`` / ``behaviors.tsv`` written from the seed at MIND-small scale
  (65,535 news, 50,000 users, 157,000 training impressions) and run through
  the port's preprocessing (hashing tokenizer, the full 30,522-id space);
  the DistilBERT trunk at full width (6 x 768, 12 heads, FFN 3072, random
  weights from seed 0) over every title on the card
  (``precompute_token_states``), 64 titles held against it in float64 on
  the CPU; one joint round on those 10.07 GB of states (2 clients x 4 steps
  at B=64: kernels C, D, B and E) and its full-pool evaluation (A, B); then
  finetune mode, the trunk trained in the loop: 2 rounds of 2 clients x 2
  steps (B and E on every client step), the kernel route against the dense
  route, and the snapshot through ``fedrec_tpu_torch.cli.recommend`` for
  8,192 users against the plain route;
* ``family_path`` (the other model families and the run's observability
  artifacts): the native C++ batcher's ``g++`` build and its epoch fill
  against the Python batcher's; a joint ``Trainer`` with the GRU user
  tower and the CNN text head (kernel A on both pools) fed by the native
  batcher, 2 rounds of 4 clients x 4 steps, each evaluated on 8,192
  impressions, with ``obs.dir``, the quality and perf monitors and a
  ``torch.profiler`` capture of round 1, against the same run without
  ``obs.dir`` (bitwise equal), and the same run with ``obs.slo`` and an
  unmeetable ``train.round_seconds`` objective (bitwise equal; the alert
  fires, ``fedrec-obs alerts`` and ``tail --once`` exit 1, the report has
  its Alerts panel); ``fedrec-obs report``, ``perf`` and ``quality`` on its
  artifacts; its snapshot through the recommend CLI;
  the CNN head under the MHA tower with ``fuse_hot_path`` (B and E, no C
  or D); one decoupled round (the CNN head's chunked corpus re-encode);
  and a ``nan`` chaos run on a 2,048-news catalog whose flight-recorder
  dump ``fedrec-obs replay`` re-runs on the card;
* ``coordinator_path`` (the reference's client/server deployment): real
  processes of ``fedrec_tpu_torch.cli.coordinator`` on 127.0.0.1, all on
  the one card, gloo over host buffers: 3 processes (a non-training server,
  two clients of 4 x 4 steps at B=64 on unequal shards,
  ``fed.weight_by_samples``) for 3 rounds, every round's global held to the
  in-process emulation and served through the recommend CLI over 2,048
  users; the topk and countsketch wires for 2 rounds each; trimmed mean
  over int8 up a fanout-2 hierarchy with a training server; a process killed at
  round 1 (the survivors degrade, the client finishes standalone); each
  worker's launches of C, D, B, E (and A in the evaluation) summed into the
  kernels line as ``launches_by_path["coordinator"]``;
* ``elastic_path`` (elastic membership and the supervisor): the standalone
  membership service and ``--supervise --membership`` workers with a
  training server, every one on the one card: a fault-free world of 3 for
  3 rounds, every global bitwise the fixed world's and the emulation's;
  then a world of 4 whose worker 2 dies at round 2: the survivors shrink to
  an epoch of 3 and train, worker 2 rejoins after its holdoff and the world
  re-forms at 4 and finishes with a full-pool evaluation (epoch history
  [4, 3, 4]); formation times, each incarnation's start to first round,
  hand-off save and restore, rounds by world, peak memory; C, D, B, E in
  every training incarnation (``launches_by_path["elastic"]``);
* ``wire_path`` (the async wire deployment): the commit authority
  (``python -m fedrec_tpu_torch.agg.server``, host only) and
  ``fedrec_tpu_torch.cli.run --agg-server`` workers, each a single-client
  ``Trainer`` on the one card (16 steps a round at B=64): quorum 3 of 4 for 4
  rounds with worker 3 straggling 4 s before every push (commits, a late
  fold, the straggler's gate near 0, the sidecars on disk); quorum 2 of 2
  through a seeded ``ChaosProxy`` (dup, tear, partition) with the authority
  SIGKILLed after its second commit and restarted from its state directory
  (one incarnation bump, a resync per worker, no acked push lost); and
  countsketch pushes at quorum 2 (bytes a push against the dense leg's);
  C, D, B, E on every worker step, A and B in each worker's evaluation
  (``launches_by_path["wire"]``); fleet observability over the quorum leg:
  a standalone collector (``python -m fedrec_tpu_torch.obs.fleet --watch``)
  the workers push to, the authority's ``--slo``, and ``fedrec-obs fleet``
  / ``fleet-trace`` over the workers' and the authority's obs dirs (five
  workers merged, the straggler's gate, per-edge RTT and clock offsets
  near 0, flow arrows push -> commit -> adoption, the collector's
  ``fleet:straggler:3`` alert); the envelope's bytes, a push's ms and the
  merge's s;
* ``seq_path`` (sequence parallelism, ``fed.seq_shards=4``): a world of 4
  ranks (``chip_smoke.py --seq-rank R`` processes over gloo, pinned host
  buffers), all on the one card, each holding 512 of every 2,048-click
  history over the first 16,384 news of the token states: the joint step
  of 2 clients at B=16 by ring attention for 4 steps (then again, bitwise),
  by Ulysses for 2, and the finetune step (the full trunk, 64 clicks) for 2,
  each against the same configuration at ``seq_shards=1`` with the dense
  user tower in this process (losses 1e-5, the first step's gradients
  2e-4, parameters 2e-3; kernel A on every rank, F1 on none); then
  ``fedrec_tpu_torch.cli.run --set fed.seq_shards=4``, which starts its own
  world, for one evaluated round; hop and all-to-all ms and bytes, step ms
  and peak memory per rank against the reference's, start-up to the first
  step;
* ``auto_codec_path`` (``fed.dcn_compress=auto``): ``Trainer.run`` for 3
  evaluated ``param_avg`` rounds of 4 clients x 4 steps at B=64 with
  ``obs.dir``, the per-leaf codec map pinned after round 0 (every leaf of
  <= 64 elements dense), ``codec_map.json`` and the report's map, bytes up
  a client below the dense tree's, a bitwise repeat; the pin's ms, round
  ms before and after it, compression by leaf (C, D, B, E on every step);
* ``serving_path`` (train -> snapshot -> serve -> refresh): a decoupled
  ``Trainer`` round of 4 clients x 4 steps snapshotted under ``build/``,
  the token states written once as a 10.07 GB ``.npy``, the snapshot
  published through ``publish_from_checkpoint`` (kernel A), the TCP server
  driven by a ``ServingClientPool`` in waves of 1-128 requests (kernel B)
  while ``{"cmd": "refresh"}`` swaps in the next round's snapshot; k-means
  two-stage retrieval over the 65,536 news (256 clusters, 16 probed)
  against a plain per-row rerank, recall by ``n_probe``; the serve CLI's
  million-item mode (``--synthetic 1000000 --clusters 1024 --n-probe 64``)
  in process; ``fedrec_tpu_torch.cli.recommend`` over a synthetic artifact
  directory of 8,192 users; and the client against a server restart and
  a server that never answers.

Every phase prints one JSON line; any failure exits non-zero without the
final result line. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Needs one CUDA device; imports nothing of JAX or of ``fedrec_tpu``.

Usage:
  python3 chip_smoke.py                           # every phase
  python3 chip_smoke.py --phases build,kernels    # kernels only
  python3 chip_smoke.py --phases build,kernels,train_path
  python3 chip_smoke.py --phases build,kernels,long_path
  python3 chip_smoke.py --phases build,kernels,trainer_path
  python3 chip_smoke.py --phases build,kernels,decoupled_path
  python3 chip_smoke.py --phases build,kernels,safety_path
  python3 chip_smoke.py --phases build,kernels,cohort_path
  python3 chip_smoke.py --phases build,kernels,data_path
  python3 chip_smoke.py --phases build,kernels,family_path
  python3 chip_smoke.py --phases build,kernels,coordinator_path
  python3 chip_smoke.py --phases build,kernels,elastic_path
  python3 chip_smoke.py --phases build,kernels,async_path
  python3 chip_smoke.py --phases build,kernels,wire_path
  python3 chip_smoke.py --phases build,kernels,seq_path,auto_codec_path
  python3 chip_smoke.py --phases build,kernels,serving_path
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

PHASES = ("device", "build", "kernels", "main_path", "train_path", "long_path", "trainer_path",
          "decoupled_path", "safety_path", "cohort_path", "async_path", "data_path",
          "family_path", "coordinator_path", "elastic_path", "wire_path", "seq_path",
          "auto_codec_path", "serving_path")
PATHS = ("main_path", "train_path", "long_path", "trainer_path", "decoupled_path", "safety_path",
         "cohort_path", "async_path", "data_path", "family_path", "coordinator_path",
         "elastic_path", "wire_path", "seq_path", "auto_codec_path", "serving_path")
DEV = "cuda"


# f32 tolerance: kernel and plain version sum the same f32 products in
# different orders (reductions of length <= 768 over O(1) values), which
# moves results by ~1e-6; 1e-4 leaves room without hiding a wrong term.
F32_ATOL = 1e-4
# bf16: both round at the same points, but a different summation order can
# flip one bf16 rounding (2**-8 relative) and carry it on: the JAX band.
BF16_ATOL, BF16_RTOL = 0.15, 0.05
# Gradients, per output, relative to that output's largest magnitude. f32:
# the kernels sum the weight gradients over up to 176,000 rows (U x T) in
# another order than autograd's products, so the error grows with the sum's
# length (about sqrt(rows) x 2**-24 of the summed magnitudes) while a wrong
# term moves a result by its own size: 1e-4 of the largest value separates
# the two. bf16: the plain version's autograd rounds every gradient through
# bf16 at each rounding point where the kernels, like the JAX ones, keep f32,
# so they agree to a few bf16 ulps (2**-8 each): 5%.
GRAD_REL = {"float32": 1e-4, "bfloat16": 0.05}
# kernel E's outputs on the family path, each against float64: within this
# many times the plain f32 route's own error there, or GRAD_REL of the
# output's own scale, whichever is larger. The CNN head's news vectors share
# a large common part, so the user pool's weight gradients cancel to ~1e-7
# of their terms: a bar relative to each output's scale fails a kernel that
# loses them (or returns zeros), where an absolute one would not
E_PLAIN_FACTOR = 10
# the trajectory bars of the JAX package's fused-vs-dense pin
# (tests/test_fused_hot_path.py): losses per step, then parameters; the two
# leaves with a true gradient of zero compare at a noise bound
TRAJ_LOSS_RTOL, TRAJ_LOSS_ATOL = 1e-5, 1e-6
TRAJ_RTOL, TRAJ_ATOL, TRAJ_NOISE = 2e-4, 1e-4, 1e-3
TRAJ_STEPS = 5
# trainer_path, decoupled_path: rounds of the uninterrupted run; the resume
# check runs one fewer, then resumes to this many
TRAINER_ROUNDS = 3
# decoupled_path: local epochs a round (a news update ends each)
DECOUPLED_EPOCHS = 2
# per-round validation means, kernel route against dense route: a score pair
# closer than the routes' difference may swap, which moves one impression's
# metric; 1e-4 of a mean over thousands of impressions allows a few
VAL_ATOL = 1e-4
# leaves whose true gradient is 0 (a softmax-invariant shift): the user
# tower's key bias, both pools' fc2 bias, and in finetune mode every trunk
# block's key bias
ZERO_GRAD_LEAVES = ("w_k.bias", "att_fc2.bias", "k_lin.bias")

KERNEL_META = {
    "additive_pool": {
        "source": "fedrec_tpu_torch/ops/csrc/additive_pool.cu",
        "replaces": "fedrec_tpu/ops/attention_kernels.py:537",
        "path": "main_path",
    },
    "fused_history_score": {
        "source": "fedrec_tpu_torch/ops/csrc/fused_history_score.cu",
        "replaces": "fedrec_tpu/ops/fused_hot_path.py:457",
        "path": "main_path",
    },
    "fused_gather_encode": {
        "source": "fedrec_tpu_torch/ops/csrc/fused_gather_encode.cu",
        "replaces": "fedrec_tpu/ops/fused_hot_path.py:132",
        "path": "train_path",
    },
    "fused_gather_encode_bwd": {
        "source": "fedrec_tpu_torch/ops/csrc/fused_gather_encode.cu",
        "replaces": "fedrec_tpu/ops/fused_hot_path.py:169",
        "path": "train_path",
    },
    "fused_history_score_bwd": {
        "source": "fedrec_tpu_torch/ops/csrc/fused_history_score_bwd.cu",
        "replaces": "fedrec_tpu/ops/fused_hot_path.py:476",
        "path": "train_path",
    },
    "additive_pool_long": {
        "source": "fedrec_tpu_torch/ops/csrc/additive_pool.cu",
        "replaces": "fedrec_tpu/ops/attention_kernels.py:537",
        "path": "long_path",
    },
    "flash_forward": {
        "source": "fedrec_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "fedrec_tpu/ops/attention_kernels.py:63",
        "path": "long_path",
    },
    "flash_backward_dq": {
        "source": "fedrec_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "fedrec_tpu/ops/attention_kernels.py:177",
        "path": "long_path",
    },
    "flash_backward_dkv": {
        "source": "fedrec_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "fedrec_tpu/ops/attention_kernels.py:215",
        "path": "long_path",
    },
}


# the kernels' letters (PERF.md's table)
KERNEL_LETTER = {"additive_pool": "A", "fused_history_score": "B", "fused_gather_encode": "C",
                 "fused_gather_encode_bwd": "D", "fused_history_score_bwd": "E",
                 "additive_pool_long": "A2", "flash_forward": "F1", "flash_backward_dq": "F2",
                 "flash_backward_dkv": "F3"}


class SmokeFailure(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def peaks_for(name: str) -> dict:
    """The card's published peaks (data sheets: FP32 outside the tensor
    cores, dense TF32 and bf16 tensor-core rates, HBM bandwidth), from the
    one table the port keeps (``fedrec_tpu_torch.obs.perf.CARD_PEAKS``,
    which the live ``perf.mfu`` gauge reads too)."""
    from fedrec_tpu_torch.obs.perf import CARD_PEAKS, card_peaks

    found = card_peaks(name)
    if found is not None:
        return dict(found[1], table_row=found[0])
    return dict(CARD_PEAKS["H100"], table_row="H100 (card not in table)")


def bound(cost: tuple[float, float, float], dtype: str, peaks: dict) -> tuple[float, str]:
    """The least time (ms) the card needs for a kernel's work: the larger of
    its operations and its bytes. ``cost`` is (matrix-product FLOPs, other
    FLOPs, bytes). Products run at the tensor cores' rate that keeps the
    operand precision (f32: three TF32 passes, so TF32 peak / 3; bf16: the
    bf16 peak), the rest at the CUDA-core f32 peak."""
    mm, rest, nbytes = cost
    mm_rate = peaks["tf32"] / 3 if dtype == "float32" else peaks["bf16"]
    t_ops = (mm / mm_rate + rest / peaks["f32"]) * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_core_bound(cost: tuple[float, float, float], peaks: dict) -> float:
    """The bound with every FLOP on CUDA cores at the f32 peak (the bound the
    kernel table used before the tensor-core rates), ms."""
    mm, rest, nbytes = cost
    return max((mm + rest) / peaks["f32"], nbytes / peaks["bytes"]) * 1e3


def pool_cost(n: int, L: int, D: int, hd: int, itemsize: int):
    """(product FLOPs, other FLOPs, bytes) of additive_pool on (n, L, D)
    with hidden hd: the x W1 product; logits, bias and weighted sum."""
    mm = n * L * 2 * D * hd
    rest = n * L * (2 * hd + 2 * D) + n * L * hd
    nbytes = n * L * D * itemsize + (D * hd + 2 * hd) * 4 + n * D * itemsize
    return mm, rest, nbytes


def hist_cost(n: int, H: int, D: int, Q: int, nh: int, C: int, itemsize: int):
    """(product FLOPs, other FLOPs, bytes) of fused_history_score on n rows
    of (H, D)."""
    dh = D // nh
    mm = n * (3 * 2 * H * D * D          # q, k, v projections
              + nh * 2 * 2 * H * H * dh  # scores and a . v per head
              + 2 * H * D * Q)           # pool hidden
    rest = n * (2 * H * Q + 2 * H * D + 2 * C * D)  # logits, user vector, scores
    weights = (3 * D * D + 3 * D + D * Q + 2 * Q) * itemsize
    nbytes = n * (H * D + C * D + D + C) * itemsize + n * H * 4 + weights
    return mm, rest, nbytes


def gather_cost(U: int, T: int, Dh: int, Ah: int, D: int, itemsize: int):
    """(product FLOPs, other FLOPs, bytes) of fused_gather_encode (kernel C)
    on U ids: the x W1 rows and the fc projection; logits and pool."""
    mm = U * (2 * T * Dh * Ah + 2 * Dh * D)
    rest = U * (2 * T * Ah + 2 * T * Dh)
    weights = (Dh * Ah + 2 * Ah + Dh * D + D) * itemsize
    return mm, rest, U * (T * Dh + D) * itemsize + U * 8 + weights


def gather_bwd_cost(U: int, T: int, Dh: int, Ah: int, D: int, itemsize: int):
    """(product FLOPs, other FLOPs, bytes) of fused_gather_encode_bwd (kernel
    D): the recompute of x W1, dpooled = g fcW^T, dW1 and dfcW are products;
    the walk back per id and the column sums are the rest."""
    mm = U * (2 * T * Dh * Ah + 2 * Dh * D) + 2 * U * T * Dh * Ah + 2 * U * Dh * D
    rest = (U * (2 * T * Ah + 2 * T * Dh + 2 * T * Dh + 4 * T * Ah)
            + U * T * Ah + U * Ah + U * D)
    weights = (Dh * Ah + 2 * Ah + Dh * D) * itemsize
    grads = (Dh * Ah + 2 * Ah + Dh * D + D) * itemsize
    return mm, rest, U * T * Dh * itemsize + U * 8 + U * D * 4 + weights + grads


def hist_bwd_cost(n: int, H: int, D: int, Q: int, nh: int, C: int, itemsize: int):
    """(product FLOPs, other FLOPs, bytes) of fused_history_score_bwd
    (kernel E): kernel B's forward recomputed, the walk back per row, then
    the weight sums."""
    dh = D // nh
    fwd_mm, fwd_rest, _ = hist_cost(n, H, D, Q, nh, C, itemsize)
    mm = fwd_mm + n * (2 * H * Q * D                 # pool hidden, back
                       + nh * 5 * 2 * H * H * dh     # attention
                       + 3 * 2 * H * D * D)          # dx
    mm += 3 * 2 * n * H * D * D + 2 * n * H * D * Q  # weight sums
    rest = fwd_rest + n * (4 * C * D + 2 * H * D + 4 * H * Q + 2 * H * D)
    rest += 3 * n * H * D + n * H * Q + n * Q
    weights = (3 * D * D + 3 * D + D * Q + 2 * Q) * itemsize
    io = n * (2 * H * D + 2 * C * D) * itemsize + n * (C + D) * 4 + n * H * 4
    return mm, rest, io + 2 * weights


def flash_cost(bh: int, lq: int, lk: int, dk: int, dv: int, which: str, itemsize: int):
    """(product FLOPs, other FLOPs, bytes) of kernel F1 ("fwd"), F2 ("dq")
    or F3 ("dkv") on (bh, L, d) operands: the products (2 per multiply-add)
    only."""
    pairs = bh * lq * lk
    per_pair = {"fwd": 2 * (dk + dv), "dq": 2 * (2 * dk + dv), "dkv": 2 * (2 * dk + 2 * dv)}[which]
    rows_q, rows_k = bh * lq, bh * lk
    if which == "fwd":   # q, k, v, bias in; out, lse out
        nbytes = (rows_q * dk + rows_k * (dk + dv) + rows_q * dv) * itemsize + (rows_k + rows_q) * 4
    elif which == "dq":  # q, k, v, g, bias, lse, delta in; dq out
        nbytes = (2 * rows_q * dk + rows_k * (dk + dv) + rows_q * dv) * itemsize + (rows_k + 2 * rows_q) * 4
    else:                # q, k, v, g, bias, lse, delta in; dk, dv, dbias out
        nbytes = (rows_q * (dk + dv) + 2 * rows_k * (dk + dv)) * itemsize + (2 * rows_k + 2 * rows_q) * 4
    return pairs * per_pair, 0, nbytes


def within_grad(got, want, dtype) -> tuple[bool, float, str]:
    """An output's error against GRAD_REL of its largest magnitude."""
    err = max_err(got, want)
    scale = float(want.detach().float().abs().max()) if want.numel() else 0.0
    rel = GRAD_REL[str(dtype).split(".")[-1]]
    return err <= rel * scale + 1e-6, err, f"{rel} x max|plain| = {rel * scale:.3g}"


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max()) if a.numel() else 0.0


def within(got, want, dtype) -> tuple[bool, float, str]:
    import torch

    err = max_err(got, want)
    if dtype == torch.float32:
        return err <= F32_ATOL, err, f"atol {F32_ATOL}"
    ok = bool(((got.float() - want.float()).abs()
               <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
    return ok, err, f"atol {BF16_ATOL} rtol {BF16_RTOL}"


# ------------------------------------------------------------------ phases
def phase_device(state: dict) -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    check(smi.returncode == 0 and bool(smi.stdout.strip()), f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    state["nvidia_smi"] = smi_line
    # full-f32 products and convolutions: TF32 keeps about 3 decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state["peaks"] = peaks_for(name)
    return {
        "kind": name,
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi_line,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn": torch.backends.cudnn.allow_tf32},
        "peaks": state["peaks"],
    }


def phase_build(state: dict) -> dict:
    from fedrec_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    return {
        "wall_s": time.perf_counter() - t0,
        "nvcc_s": secs,
        "libraries": {n: _build.library_path(n) for n in secs},
        "flags": " ".join(_build.NVCC_FLAGS),
    }


def _pool_weights(gen, D: int, hd: int):
    import torch

    dev = DEV
    w1 = torch.randn((D, hd), generator=gen, device=dev) / math.sqrt(D)
    b1 = torch.randn((hd,), generator=gen, device=dev) * 0.02
    w2 = torch.randn((hd,), generator=gen, device=dev) / math.sqrt(hd)
    return w1, b1, w2


def _tower_weights(gen, D: int, Q: int):
    import torch
    from fedrec_tpu_torch.ops import UserTowerWeights

    dev = DEV
    lim = math.sqrt(6.0 / (2 * D))  # xavier-uniform bound of a (D, D) kernel

    def uni(shape):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * lim

    def small(shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.02

    return UserTowerWeights(
        uni((D, D)), small((D,)), uni((D, D)), small((D,)), uni((D, D)), small((D,)),
        torch.randn((D, Q), generator=gen, device=dev) / math.sqrt(D), small((Q,)),
        torch.randn((Q,), generator=gen, device=dev) / math.sqrt(Q),
    )


def _mask(gen, n: int, L: int, kind: str):
    import torch

    if kind == "none":
        return None
    m = (torch.rand((n, L), generator=gen, device=DEV) > 0.3).float()
    m[:, 0] = 1.0
    if kind == "fully_masked_row" and n > 1:
        m[1] = 0.0
    return m.contiguous()


def phase_kernels(state: dict, args) -> dict:
    import torch
    from fedrec_tpu_torch.ops import (
        additive_pool,
        additive_pool_plain,
        fused_history_score,
        fused_history_score_plain,
    )

    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    peaks = state["peaks"]
    checks, failures = [], []

    def record(kernel, shape, dtype, mask_kind, ok, err, tol, extra=""):
        row = {"kernel": kernel, "shape": shape, "dtype": str(dtype).split(".")[-1],
               "mask": mask_kind, "max_abs_err": err, "tol": tol, "ok": ok}
        checks.append(row)
        if not ok:
            failures.append(row)

    # ---- kernel A at (4096, 50, 768), hidden 384
    n, L, D, hd = args.pool_rows, 50, 768, 384
    x32 = torch.randn((n, L, D), generator=gen, device=DEV)
    w1, b1, w2 = _pool_weights(gen, D, hd)
    for kind in ("none", "partial", "fully_masked_row"):
        mask = _mask(gen, n, L, kind)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            got = additive_pool(x, w1, b1, w2, mask)
            want = additive_pool_plain(x, w1, b1, w2, mask)
            torch.cuda.synchronize()
            ok, err, tol = within(got, want, dt)
            if kind == "fully_masked_row":
                ok = ok and bool((got[1] == 0).all())
            record("additive_pool", [n, L, D], dt, kind, ok, err, tol)
    del x32

    # timing at the main path's launch shape: one 2048-row chunk, f32
    n_t = args.chunk
    xt = torch.randn((n_t, L, D), generator=gen, device=DEV)
    a_ms = time_ms(lambda: additive_pool(xt, w1, b1, w2), reps=10)
    a_plain = time_ms(lambda: additive_pool_plain(xt, w1, b1, w2), reps=5)
    a_bf = xt.to(torch.bfloat16)
    a_ms_bf16 = time_ms(lambda: additive_pool(a_bf, w1, b1, w2), reps=10)
    a_cost = pool_cost(n_t, L, D, hd, 4)
    a_bound, a_by = bound(a_cost, "float32", peaks)
    a_bound_bf16, _ = bound(pool_cost(n_t, L, D, hd, 2), "bfloat16", peaks)
    del xt, a_bf
    # and at the long path's text head: one launch a client step over
    # U = B x (1 + npratio 4 + history) rows of (50, 768) token states
    n_l = min(args.long_batch_size * (5 + args.long_history), args.num_news)
    xl = torch.randn((n_l, L, D), generator=gen, device=DEV)
    long_ms = time_ms(lambda: additive_pool(xl, w1, b1, w2), reps=3)
    long_plain = time_ms(lambda: additive_pool_plain(xl, w1, b1, w2), reps=2, warmup=1)
    long_err = max_err(additive_pool(xl, w1, b1, w2), additive_pool_plain(xl, w1, b1, w2))
    check(long_err <= F32_ATOL, f"additive_pool at {[n_l, L, D]}: error {long_err} against {F32_ATOL}")
    long_bound, long_by = bound(pool_cost(n_l, L, D, hd, 4), "float32", peaks)
    del xl
    torch.cuda.empty_cache()
    state["timing"] = {"additive_pool": {
        "shape": [n_t, L, D], "dtype": "float32", "ms": a_ms, "plain_ms": a_plain,
        "bound_ms": a_bound, "bound_by": a_by, "cuda_core_bound_ms": cuda_core_bound(a_cost, peaks),
        "library_ms": None, "bf16_ms": a_ms_bf16, "bf16_bound_ms": a_bound_bf16,
        "long_text_head": {"shape": [n_l, L, D], "ms": long_ms, "plain_ms": long_plain,
                           "bound_ms": long_bound, "bound_by": long_by, "max_abs_err": long_err},
    }}

    # ---- kernel B at every serving bucket, H=50, D=400, 20 heads, Q=200
    H, D, Q, nh = 50, 400, 200, 20
    w32 = _tower_weights(gen, D, Q)
    for b in (1, 8, 32, 64, 128, 256):
        x32 = torch.randn((b, H, D), generator=gen, device=DEV)
        c32 = torch.randn((b, 5, D), generator=gen, device=DEV)
        for c in (0, 5):
            for kind in ("none", "fully_masked_row"):
                mask = _mask(gen, b, H, kind if b > 1 else "partial")
                for dt in (torch.float32, torch.bfloat16):
                    x, w = x32.to(dt), w32.to(dt)
                    cand = c32.to(dt) if c else None
                    sk, uk = fused_history_score(x, cand, mask, w, nh)
                    sp, up = fused_history_score_plain(x, cand, mask, w, nh)
                    torch.cuda.synchronize()
                    ok, err, tol = within(uk, up, dt)
                    if c:
                        ok_s, err_s, _ = within(sk, sp, dt)
                        ok, err = ok and ok_s, max(err, err_s)
                    record("fused_history_score", [b, H, D, c], dt, kind, ok, err, tol)
    def b_timing(b: int, c: int) -> dict:
        x = torch.randn((b, H, D), generator=gen, device=DEV)
        cand = torch.randn((b, c, D), generator=gen, device=DEV) if c else None
        k_ms = time_ms(lambda: fused_history_score(x, cand, None, w32, nh), reps=50)
        p_ms = time_ms(lambda: fused_history_score_plain(x, cand, None, w32, nh), reps=20)
        cost = hist_cost(b, H, D, Q, nh, c, 4)
        bms, by = bound(cost, "float32", peaks)
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
                "cuda_core_bound_ms": cuda_core_bound(cost, peaks)}

    # the serving buckets (C = 0), the train path's shape (n = 64, C = 5)
    # and the evaluation's (n = 256, C = 0)
    b_times = {b: b_timing(b, 0) for b in (1, 8, 32, 128)}
    state["timing"]["fused_history_score"] = dict(
        b_times[128], shape=[128, H, D, 0], dtype="float32", library_ms=None,
        by_bucket=b_times, train_shape=dict(b_timing(64, 5), shape=[64, H, D, 5]),
        eval_shape=dict(b_timing(256, 0), shape=[256, H, D, 0]),
    )
    _check_backward_kernels(state, args, gen, record)
    _check_long_kernels(state, args, gen, record)
    cancelling = _check_flash_cancelling(args, gen, record)
    check(not failures, f"kernel checks failed: {failures}")
    return {"checks": checks, "timing": state["timing"], "flash_cancelling": cancelling}


def _check_flash_cancelling(args, gen, record) -> list:
    """F1's forward, then F2 (dq) and F3 (dk, dv, dbias), on keys that share
    a large common part (a common vector plus 0.05 per-key noise, as kernel
    E's and D's cancelling checks build them): the softmax flattens, each dS
    row sums to ~0 and dq's common term cancels. Every output against a
    float64 autograd reference on the card, within ``E_PLAIN_FACTOR`` x the
    plain route's own error or ``GRAD_REL`` of the output's scale. At the
    long path's width (20) and length, 2 x 20 heads, f32 and bf16."""
    import torch
    from fedrec_tpu_torch.ops import (
        flash_backward_dkv,
        flash_backward_dq,
        flash_backward_plain,
        flash_forward,
        flash_forward_plain,
    )

    bh, L, d = 40, args.long_history, 20
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        base = torch.randn((d,), generator=gen, device=DEV).abs()
        q, v, g = (torch.randn((bh, L, d), generator=gen, device=DEV).to(dt) for _ in range(3))
        k = (base + 0.05 * torch.randn((bh, L, d), generator=gen, device=DEV)).to(dt)
        keep = torch.rand((bh, L), generator=gen, device=DEV) > 0.3
        keep[:, 0] = True
        bias = torch.where(keep, 0.0, -1e9).contiguous()
        out, lse = flash_forward(q, k, v, bias)
        delta = (g.float() * out.float()).sum(-1)
        got = (flash_backward_dq(q, k, v, bias, g, lse, delta),
               *flash_backward_dkv(q, k, v, bias, g, lse, delta))
        p_out, p_lse = flash_forward_plain(q, k, v, bias)
        plain = flash_backward_plain(q, k, v, bias, p_out, p_lse, g)
        with torch.enable_grad():
            leaves = [t.detach().double().requires_grad_() for t in (q, k, v, bias)]
            ql, kl, vl, bl = leaves
            s = ql @ kl.transpose(-1, -2) / math.sqrt(d) + bl[:, None, :]
            ref = torch.autograd.grad(torch.softmax(s, -1) @ vl, leaves, g.double())
        torch.cuda.synchronize()
        for name, a, b, r in zip(("dq", "dk", "dv", "dbias"), got, plain, ref):
            err_k = float((a.double() - r).abs().max())
            err_p = float((b.double() - r).abs().max())
            scale = float(r.abs().max())
            bar = max(E_PLAIN_FACTOR * err_p, GRAD_REL["float32"] * scale)
            record("flash_backward_cancelling:" + name, [bh, L, d], dt, "partial",
                   err_k <= bar, err_k, f"max({E_PLAIN_FACTOR} x plain {err_p:.3g}, "
                   f"{GRAD_REL['float32']} x {scale:.3g})")
            rows.append({"output": name, "dtype": str(dt).split(".")[-1], "kernel_err": err_k,
                         "plain_err": err_p, "scale": scale, "bar": bar})
        del q, k, v, g, out, lse, got, plain, ref, leaves, s
        torch.cuda.empty_cache()
    return rows


def _check_backward_kernels(state: dict, args, gen, record) -> None:
    """Kernel A's backward, kernels C and D (gather + encode) and kernel E
    (user tower backward) against their plain versions at the train path's
    shapes, f32 and bf16; then C, D and E timed in f32."""
    import torch
    from fedrec_tpu_torch.ops import (
        TextHeadWeights,
        UserTowerWeights,
        additive_pool,
        additive_pool_plain,
        fused_gather_encode,
        fused_gather_encode_bwd,
        fused_gather_encode_bwd_plain,
        fused_gather_encode_plain,
        fused_history_score_bwd,
        fused_history_score_bwd_plain,
    )

    peaks = state["peaks"]
    # ---- kernel A's backward (autograd of the plain pool around the launch)
    n, L, Dh, Ah = 256, 50, 768, 384
    w1, b1, w2 = _pool_weights(gen, Dh, Ah)
    x32 = torch.randn((n, L, Dh), generator=gen, device=DEV)
    mask = _mask(gen, n, L, "partial")
    for dt in (torch.float32, torch.bfloat16):
        g = torch.randn((n, Dh), generator=gen, device=DEV).to(dt)

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (x32.to(dt), w1, b1, w2)]
            return torch.autograd.grad(fn(*leaves, mask), leaves, g)

        for name, a, b in zip(("dx", "dw1", "db1", "dw2"), grads(additive_pool), grads(additive_pool_plain)):
            ok, err, tol = within_grad(a, b, dt)
            record("additive_pool_bwd:" + name, [n, L, Dh], dt, "partial", ok, err, tol)
    del x32

    # ---- kernels C and D: the U = B x 55 unique slots of a train step's
    # dedup (3,520 at B=64), sorted and padded with id 0 as the dedup does,
    # over a table of up to 16,384 rows
    N, D = min(args.num_news, 16384), 400
    U = min(args.batch_size * (1 + 4 + L), N)
    table32 = torch.randn((N, L, Dh), generator=gen, device=DEV)
    real = U - U // 64
    ids = torch.sort(torch.randperm(N - 1, generator=gen, device=DEV)[:real] + 1).values
    ids = torch.cat([ids, torch.zeros(U - real, dtype=torch.int64, device=DEV)])
    head32 = TextHeadWeights(
        *_pool_weights(gen, Dh, Ah),
        torch.randn((Dh, D), generator=gen, device=DEV) / math.sqrt(Dh),
        torch.randn((D,), generator=gen, device=DEV) * 0.02,
    )
    g32 = torch.randn((U, D), generator=gen, device=DEV)
    g32[real:] = 0.0  # padded slots get no cotangent
    for dt in (torch.float32, torch.bfloat16):
        table, head = table32.to(dt), head32.to(dt)
        got = fused_gather_encode(table, ids, head)
        want = fused_gather_encode_plain(table, ids, head)
        torch.cuda.synchronize()
        ok, err, tol = within(got, want, dt)
        record("fused_gather_encode", [U, L, Dh, D], dt, "none", ok, err, tol)
        got = fused_gather_encode_bwd(table, ids, head, g32)
        want = fused_gather_encode_bwd_plain(table, ids, head, g32)
        torch.cuda.synchronize()
        for name, a, b in zip(TextHeadWeights._fields, got, want):
            ok, err, tol = within_grad(a, b, dt)
            record("fused_gather_encode_bwd:d" + name, [U, L, Dh, D], dt, "none", ok, err, tol)
        del table, head
    c_ms = time_ms(lambda: fused_gather_encode(table32, ids, head32), reps=10)
    c_plain = time_ms(lambda: fused_gather_encode_plain(table32, ids, head32), reps=5)
    c_cost = gather_cost(U, L, Dh, Ah, D, 4)
    c_bound, c_by = bound(c_cost, "float32", peaks)
    d_ms = time_ms(lambda: fused_gather_encode_bwd(table32, ids, head32, g32), reps=5)
    d_plain = time_ms(lambda: fused_gather_encode_bwd_plain(table32, ids, head32, g32), reps=3)
    d_cost = gather_bwd_cost(U, L, Dh, Ah, D, 4)
    d_bound, d_by = bound(d_cost, "float32", peaks)
    for name, ms, plain_ms, bms, by, cost in (
        ("fused_gather_encode", c_ms, c_plain, c_bound, c_by, c_cost),
        ("fused_gather_encode_bwd", d_ms, d_plain, d_bound, d_by, d_cost),
    ):
        state["timing"][name] = {"shape": [U, L, Dh, D], "dtype": "float32", "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                                 "cuda_core_bound_ms": cuda_core_bound(cost, peaks),
                                 "library_ms": None}
    del table32, g32

    # ---- kernel E at the train path's shape: 64 rows, C = 5, no mask (the
    # step passes none); a partial mask too
    n, H, D, Q, nh, C = args.batch_size, 50, 400, 200, 20, 5
    w32 = _tower_weights(gen, D, Q)
    x32 = torch.randn((n, H, D), generator=gen, device=DEV)
    c32 = torch.randn((n, C, D), generator=gen, device=DEV)
    gs = torch.randn((n, C), generator=gen, device=DEV)
    gu = torch.randn((n, D), generator=gen, device=DEV)
    for kind in ("none", "partial"):
        mask = _mask(gen, n, H, kind)
        for dt in (torch.float32, torch.bfloat16):
            x, cand, w = x32.to(dt), c32.to(dt), w32.to(dt)
            got = fused_history_score_bwd(x, cand, mask, w, gs, gu, nh)
            want = fused_history_score_bwd_plain(x, cand, mask, w, gs, gu, nh)
            torch.cuda.synchronize()
            outs = [("dx", got[0], want[0]), ("dcand", got[1], want[1])]
            outs += list(zip(("d" + f for f in UserTowerWeights._fields), got[2], want[2]))
            for name, a, b in outs:
                ok, err, tol = within_grad(a, b, dt)
                if name == "dbk":
                    # true gradient zero: both sides are float noise, on the
                    # scale of the sibling query-bias gradient
                    rel = GRAD_REL[str(dt).split(".")[-1]]
                    scale = float(want[2].bq.float().abs().max())
                    ok, tol = err <= rel * scale + 1e-6, f"noise: {rel} x max|plain dbq| = {rel * scale:.3g}"
                record("fused_history_score_bwd:" + name, [n, H, D, C], dt, kind, ok, err, tol)
    e_ms = time_ms(lambda: fused_history_score_bwd(x32, c32, None, w32, gs, gu, nh), reps=10)
    e_plain = time_ms(lambda: fused_history_score_bwd_plain(x32, c32, None, w32, gs, gu, nh), reps=5)
    e_cost = hist_bwd_cost(n, H, D, Q, nh, C, 4)
    e_bound, e_by = bound(e_cost, "float32", peaks)
    state["timing"]["fused_history_score_bwd"] = {
        "shape": [n, H, D, C], "dtype": "float32", "ms": e_ms, "plain_ms": e_plain,
        "bound_ms": e_bound, "bound_by": e_by, "cuda_core_bound_ms": cuda_core_bound(e_cost, peaks),
        "library_ms": None,
    }


def _flash_operands(gen, bh: int, L: int, d: int, kind: str):
    """q, k, v (bh, L, d) f32, the (bh, L) key bias of a mask of ``kind``
    and a cotangent that is 0 on rows with no valid key (the wrapper
    multiplies such rows by 0)."""
    import torch

    q, k, v, g = (torch.randn((bh, L, d), generator=gen, device=DEV) for _ in range(4))
    if kind == "none":
        bias = torch.zeros((bh, L), device=DEV)
    else:
        keep = torch.rand((bh, L), generator=gen, device=DEV) > 0.3
        keep[:, 0] = True
        if kind == "fully_masked_row":
            keep[1] = False
        bias = torch.where(keep, 0.0, -1e9)
        g[~keep.any(1)] = 0.0
    return q, k, v, bias.contiguous(), g


def _check_long_kernels(state: dict, args, gen, record) -> None:
    """Kernels F1, F2, F3 at the long path's attention shape (B=16 x 20
    heads, L=2048, width 20) and A2 at its pool shape (16, 2048, 400),
    f32 and bf16, three masks, against their plain versions; then each
    timed in f32 beside its plain version and, for the flash kernels,
    ``F.scaled_dot_product_attention`` with the same additive mask (a
    yardstick only: the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from fedrec_tpu_torch.ops import (
        additive_pool,
        additive_pool_long,
        additive_pool_plain,
        flash_backward_dkv,
        flash_backward_dkv_plain,
        flash_backward_dq,
        flash_backward_dq_plain,
        flash_forward,
        flash_forward_plain,
    )

    peaks = state["peaks"]
    bh, L, d, nh = args.flash_bh, args.long_history, 20, 20
    for kind in ("none", "partial", "fully_masked_row"):
        q32, k32, v32, bias, g32 = _flash_operands(gen, bh, L, d, kind)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, g = (t.to(dt) for t in (q32, k32, v32, g32))
            out, lse = flash_forward(q, k, v, bias)
            want_out, want_lse = flash_forward_plain(q, k, v, bias)
            torch.cuda.synchronize()
            ok, err, tol = within(out, want_out, dt)
            record("flash_forward", [bh, L, d], dt, kind, ok, err, tol)
            # the log-sum-exp, f32 in both dtypes; a row with no valid key
            # holds about -1e9, where one f32 ulp is 64: relative 1e-5
            rel = float(((lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)).max())
            record("flash_forward:lse", [bh, L, d], dt, kind, rel <= 1e-5, max_err(lse, want_lse),
                   f"relative 1e-5 (max {rel:.3g})")
            delta = (g.float() * want_out.float()).sum(-1)
            dq = flash_backward_dq(q, k, v, bias, g, want_lse, delta)
            ok, err, tol = within_grad(dq, flash_backward_dq_plain(q, k, v, bias, g, want_lse, delta), dt)
            record("flash_backward_dq", [bh, L, d], dt, kind, ok, err, tol)
            got = flash_backward_dkv(q, k, v, bias, g, want_lse, delta)
            want = flash_backward_dkv_plain(q, k, v, bias, g, want_lse, delta)
            torch.cuda.synchronize()
            for name, a, b, adt in zip(("dk", "dv", "dbias"), got, want, (dt, dt, torch.float32)):
                ok, err, tol = within_grad(a, b, adt)
                record("flash_backward_dkv:" + name, [bh, L, d], dt, kind, ok, err, tol)
            del out, lse, want_out, want_lse, dq, got, want
        del q32, k32, v32, g32

    # timing, f32, no mask (the path passes none)
    q, k, v, bias, g = _flash_operands(gen, bh, L, d, "none")
    out, lse = flash_forward(q, k, v, bias)
    delta = (g * out).sum(-1)
    f_ms = time_ms(lambda: flash_forward(q, k, v, bias), reps=5)
    f_plain = time_ms(lambda: flash_forward_plain(q, k, v, bias), reps=2, warmup=1)
    dq_ms = time_ms(lambda: flash_backward_dq(q, k, v, bias, g, lse, delta), reps=5)
    dq_plain = time_ms(lambda: flash_backward_dq_plain(q, k, v, bias, g, lse, delta), reps=2, warmup=1)
    dkv_ms = time_ms(lambda: flash_backward_dkv(q, k, v, bias, g, lse, delta), reps=5)
    dkv_plain = time_ms(lambda: flash_backward_dkv_plain(q, k, v, bias, g, lse, delta), reps=2, warmup=1)
    # the yardstick: one SDPA call, forward and backward, same additive mask
    b = bh // nh
    qs, ks, vs = (t.reshape(b, nh, L, d).detach().requires_grad_() for t in (q, k, v))
    am = bias.reshape(b, nh, 1, L)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am), reps=5)
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am)
    g_lib = g.reshape(b, nh, L, d)
    lib_bwd = time_ms(lambda: torch.autograd.grad(o_lib, (qs, ks, vs), g_lib, retain_graph=True), reps=5)
    lib_err = max_err(o_lib.reshape(bh, L, d), out)
    del o_lib, qs, ks, vs
    timing = state["timing"]
    for name, which, ms, plain_ms, lib in (
        ("flash_forward", "fwd", f_ms, f_plain, lib_fwd),
        ("flash_backward_dq", "dq", dq_ms, dq_plain, lib_bwd),
        ("flash_backward_dkv", "dkv", dkv_ms, dkv_plain, lib_bwd),
    ):
        cost = flash_cost(bh, L, L, d, d, which, 4)
        bms, by = bound(cost, "float32", peaks)
        timing[name] = {"shape": [bh, L, d], "dtype": "float32", "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bms, "bound_by": by, "gflop": cost[0] / 1e9,
                        "cuda_core_bound_ms": cuda_core_bound(cost, peaks),
                        "library_ms": lib, "library": "F.scaled_dot_product_attention "
                        + ("forward" if which == "fwd" else "backward (dq, dk, dv together)")}
    timing["flash_forward"]["library_max_abs_err"] = lib_err
    del q, k, v, bias, g, out, lse, delta

    # ---- kernel A2 at the long path's pool shape (hidden 200)
    n, D, hd = args.long_batch_size, 400, 200
    w1, b1, w2 = _pool_weights(gen, D, hd)
    x32 = torch.randn((n, L, D), generator=gen, device=DEV)
    for kind in ("none", "partial", "fully_masked_row"):
        mask = _mask(gen, n, L, kind)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            got = additive_pool(x, w1, b1, w2, mask)
            want = additive_pool_plain(x, w1, b1, w2, mask)
            torch.cuda.synchronize()
            ok, err, tol = within(got, want, dt)
            if kind == "fully_masked_row":
                ok = ok and bool((got[1] == 0).all())
            record("additive_pool_long", [n, L, D], dt, kind, ok, err, tol)
    a2_ms = time_ms(lambda: additive_pool_long(x32, w1, b1, w2), reps=10)
    a2_plain = time_ms(lambda: additive_pool_plain(x32, w1, b1, w2), reps=5)
    a2_cost = pool_cost(n, L, D, hd, 4)
    a2_bound, a2_by = bound(a2_cost, "float32", peaks)
    timing["additive_pool_long"] = {"shape": [n, L, D], "dtype": "float32", "ms": a2_ms,
                                    "plain_ms": a2_plain, "bound_ms": a2_bound, "bound_by": a2_by,
                                    "cuda_core_bound_ms": cuda_core_bound(a2_cost, peaks),
                                    "library_ms": None}
    del x32


async def _drive_server(service, waves, num_news: int, rng, his_len: int = 50,
                        clicks: tuple[int, int] = (1, 50), wire_checks: bool = False) -> dict:
    """Send ``waves`` of requests (each with ``clicks`` real clicks, 0-padded
    to ``his_len``) over TCP; collect responses, round trips, metrics. With
    ``wire_checks`` the same server then answers the envelope and alerts
    checks (``_serving_wire_checks``)."""
    from fedrec_tpu_torch.serving import start_server

    server = await start_server(service, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port, limit=1 << 20)
    sent, responses, rtt_ms = {}, {}, []
    rid = 0
    try:
        for wave in waves:
            t0 = {}
            for _ in range(wave):
                k = int(rng.integers(clicks[0], clicks[1] + 1))
                hist = rng.integers(1, num_news, size=k).tolist() + [0] * (his_len - k)
                sent[rid] = hist
                t0[rid] = time.perf_counter()
                writer.write((json.dumps({"id": rid, "history": hist}) + "\n").encode())
                rid += 1
            await writer.drain()
            for _ in range(wave):
                line = await asyncio.wait_for(reader.readline(), timeout=120)
                resp = json.loads(line)
                responses[resp.get("id")] = resp
                if resp.get("id") in t0:
                    rtt_ms.append((time.perf_counter() - t0[resp["id"]]) * 1e3)
        writer.write(b'{"cmd": "metrics"}\n')
        await writer.drain()
        metrics = json.loads(await asyncio.wait_for(reader.readline(), timeout=60))["metrics"]
        wire = (await _serving_wire_checks(service, port, reader, writer, num_news, rng,
                                           his_len) if wire_checks else None)
    finally:
        writer.close()
        await writer.wait_closed()
        server.close()
        await server.wait_closed()
        await service.stop()
    return {"sent": sent, "responses": responses, "rtt_ms": rtt_ms, "metrics": metrics,
            "wire": wire}


SERVE_WIRE_REQUESTS = 32


async def _serving_wire_checks(service, port: int, reader, writer, num_news: int, rng,
                               his_len: int) -> dict:
    """The serving wire with fleet observability: a request carrying the
    ``_wire`` envelope gets one back (its parent the request's span,
    ``recv_ts <= reply_ts``); the port's ``ServingClient`` sends
    ``SERVE_WIRE_REQUESTS`` with the envelope and books the edge's RTT in
    its registry; then an unmeetable ``obs.slo`` objective over
    ``serve.p99_ms``, evaluated at two heartbeats as ``serve_forever``'s
    beat does, makes ``{"cmd": "alerts"}`` answer a firing alert."""
    from fedrec_tpu_torch.config import SloConfig, WatchConfig
    from fedrec_tpu_torch.obs import MetricsRegistry, set_registry, wire
    from fedrec_tpu_torch.obs.registry import quantile_from_counts
    from fedrec_tpu_torch.obs.watch import Watch
    from fedrec_tpu_torch.serving import ServingClient

    hist = rng.integers(1, num_news, size=his_len).tolist()
    env = wire.request_envelope("score")
    bare = (json.dumps({"id": -1, "history": hist}) + "\n").encode()
    line = (json.dumps({"id": -1, "history": hist, "_wire": env}) + "\n").encode()
    writer.write(line)
    await writer.drain()
    resp = json.loads(await asyncio.wait_for(reader.readline(), timeout=60))
    renv = resp.get("_wire") or {}
    check(resp.get("id") == -1 and len(resp.get("ids", ())) > 0 and renv.get("parent")
          == env["span_id"] and renv["recv_ts"] <= renv["reply_ts"],
          f"the enveloped request's reply {str(resp)[:400]}")
    reg = MetricsRegistry()
    prev = set_registry(reg)
    client = ServingClient("127.0.0.1", port, request_timeout_ms=60_000)
    try:
        for i in range(SERVE_WIRE_REQUESTS):
            r = await client.request({"id": 10_000 + i, "history": hist})
            check("_wire" not in r and len(r.get("ids", ())) > 0, f"client reply {str(r)[:300]}")
    finally:
        await client.close()
        set_registry(prev)
    rows = [row for row in reg.snapshot()["metrics"].get("wire.rtt_ms", {}).get("values", [])
            if row["labels"]["op"] == "score"]
    check(len(rows) == 1 and rows[0]["count"] == SERVE_WIRE_REQUESTS,
          f"the client's wire.rtt_ms rows {rows}")
    h = reg.get("wire.rtt_ms")
    rtt_p50 = quantile_from_counts(0.5, h.buckets, list(rows[0]["buckets"].values()))
    # the heartbeat's watch, fed the serve.* snapshot twice (pending_for 2)
    service.watch = Watch(SloConfig(enabled=True, objectives="p99:serve.p99_ms<0.001"),
                          WatchConfig(), registry=service.registry)
    for _ in range(2):
        service.watch.evaluate(record={f"serve.{k}": v for k, v in service.metrics().items()
                                       if isinstance(v, (int, float)) and not isinstance(v, bool)})
    writer.write(b'{"cmd": "alerts"}\n')
    await writer.drain()
    alerts = json.loads(await asyncio.wait_for(reader.readline(), timeout=60))["alerts"]
    firing = [a for a in alerts["active"] if a["state"] == "firing"]
    check([a["key"] for a in firing] == ["slo:p99"], f"the alerts command answered {alerts}")
    return {"envelope_bytes": len(line) - len(bare), "request_bytes_bare": len(bare),
            "reply_recv_to_reply_ms": (renv["reply_ts"] - renv["recv_ts"]) * 1e3,
            "client_rtt_ms": {"mean": rows[0]["sum"] / rows[0]["count"], "p50": rtt_p50},
            "peer": rows[0]["labels"]["peer"], "alert": firing[0]["summary"]}


def _plain_recommend(model, table, hist, top_k: int):
    """The served batch again through plain versions only: plain user tower,
    f32 catalog product, pad/history masking, top k+1 (for the score gaps)."""
    import torch
    from fedrec_tpu_torch.ops import fused_history_score_plain

    enc = model.user_encoder
    n = table.shape[0]
    his = table[hist.clamp(0, n - 1)]
    _, user = fused_history_score_plain(his, None, None, enc.fused_weights(his.dtype), enc.num_heads)
    scores = user.float() @ table.float().T
    invalid = torch.zeros_like(scores, dtype=torch.bool)
    invalid[:, 0] = True
    rows = torch.arange(hist.shape[0], device=hist.device)[:, None]
    invalid[rows, hist.clamp(0, n - 1)] = True
    scores = scores.masked_fill(invalid, torch.finfo(torch.float32).min)
    return torch.topk(scores, top_k + 1, dim=1)


def _device_breakdown(call, reps: int, top: int = 8, sum_of: dict | None = None) -> dict:
    """Device time by kernel and the device's busy share over ``reps``
    calls of ``call`` (torch.profiler; each call ends in a host read-back).
    ``sum_of`` maps a label to kernel names: ``sums_us`` holds, per label,
    the device time per call of every kernel whose name contains one of
    them (None where none ran)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        dev_us = float(getattr(ev, "self_device_time_total", 0.0))
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us / reps, ev.count / reps))
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    out = {
        "wall_ms_per_call_profiled": wall_us / reps / 1e3,
        "device_ms_per_call": busy_us / 1e3,
        "device_busy_share": busy_us * reps / wall_us if wall_us else None,
        "top": [{"kernel": k[:90], "us_per_call": us, "launches_per_call": c}
                for k, us, c in rows[:top]],
    }
    if sum_of:
        out["sums_us"] = {}
        for label, names in sum_of.items():
            hits = [us for k, us, _ in rows if any(n in k for n in names)]
            out["sums_us"][label] = sum(hits) if hits else None
    return out


def _tokens(state: dict, args, title_len: int, bert_hidden: int):
    """The seeded frozen-trunk token states (num_news, title_len,
    bert_hidden) f32, made on the card chunk by chunk once and shared by
    every path (10.1 GB at full size)."""
    import torch

    if "tokens" not in state:
        gen = torch.Generator(device=DEV).manual_seed(args.seed)
        tokens = torch.empty((args.num_news, title_len, bert_hidden), device=DEV)
        for s in range(0, args.num_news, args.chunk):
            tokens[s:s + args.chunk].normal_(generator=gen)
        if DEV == "cuda":
            torch.cuda.synchronize()
        state["tokens"] = tokens
    return state["tokens"]


def _check_responses(sent: dict, responses: dict, top_k: int, least: int) -> None:
    """Every request answered: top_k ids, no pad id, no clicked id, scores
    descending, generation 0."""
    check(len(responses) == len(sent) >= least, f"{len(responses)} responses to {len(sent)} requests")
    bad = []
    for rid, hist in sent.items():
        r = responses.get(rid, {})
        ids, sc = r.get("ids", []), r.get("scores", [])
        if ("error" in r or len(ids) != top_k or 0 in ids or set(hist) & set(ids)
                or any(a < b for a, b in zip(sc, sc[1:])) or r.get("generation") != 0):
            bad.append({"id": rid, "resp": r})
    check(not bad, f"{len(bad)} bad responses, first: {bad[:2]}")


def _topk_disagreements(ids, ref_scores, ref_ids, top_k: int) -> int:
    """Top-k ids that differ from the reference's where the reference's
    scores are more than F32_ATOL from both neighbours (a closer pair may
    swap under another summation order). ``ref_*`` hold k + 1 columns."""
    import torch

    gaps = (ref_scores[:, :-1] - ref_scores[:, 1:]).abs()                  # (B, k)
    left = torch.cat([torch.full_like(gaps[:, :1], float("inf")), gaps[:, :-1]], 1)
    decided = (gaps > F32_ATOL) & (left > F32_ATOL)
    return int((decided & (ids.long() != ref_ids[:, :top_k].long())).sum())


def phase_main_path(state: dict, args) -> dict:
    import torch
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.models.attention import dense
    from fedrec_tpu_torch.ops import additive_pool_plain, launch_counts, reset_launch_counts
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.serve import build_recommend_fn
    from fedrec_tpu_torch.serving import EmbeddingStore, ServingService
    from fedrec_tpu_torch.train.step import encode_all_news

    cfg = ExperimentConfig().apply_overrides(
        ["model.fuse_hot_path=true", "model.use_pallas=true"]
    )
    mc = cfg.model
    N, L, top_k = args.num_news, cfg.data.max_title_len, 10
    dev = torch.device(DEV)
    model = init_params(NewsRecommender(mc), seed=args.seed).to(dev).eval()
    tokens = _tokens(state, args, L, mc.bert_hidden)

    # ---------------- the main path, with every launch count from 0
    reset_launch_counts()
    t0 = time.perf_counter()
    table = encode_all_news(model, tokens, chunk=args.chunk, device=dev)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    store = EmbeddingStore()
    store.publish(table, model.user_encoder, source="synthetic")
    service = ServingService(store, history_len=cfg.data.max_his_len, top_k=top_k, device=dev)
    t0 = time.perf_counter()
    service.warmup()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(args.seed)
    run = asyncio.run(_drive_server(service, args.waves, N, rng, wire_checks=True))
    torch.cuda.synchronize()
    launches = launch_counts()
    # ---------------- end of the main path

    check(table.shape == (N, mc.news_dim) and bool(torch.isfinite(table).all()),
          f"news table {tuple(table.shape)} not finite/(N, {mc.news_dim})")
    sent, responses = run["sent"], run["responses"]
    _check_responses(sent, responses, top_k, least=256)
    for name, meta in KERNEL_META.items():
        if meta["path"] == "main_path":
            check(launches[name] > 0, f"kernel {name} never launched on the main path")

    # ---- the kernel path against the plain versions on the same inputs
    # kernel A: the first chunk of the table again through the plain pool
    th = model.text_head
    with torch.no_grad():
        x0 = tokens[: args.chunk]
        pooled = additive_pool_plain(
            x0, th.pool.att_fc1.weight.t().contiguous(), th.pool.att_fc1.bias,
            th.pool.att_fc2.weight[0].contiguous(),
        )
        plain_vecs = dense(th.fc, pooled, torch.float32)
    err_a = max_err(table[: args.chunk], plain_vecs)
    check(err_a <= F32_ATOL, f"corpus encode vs plain: max err {err_a} > {F32_ATOL}")
    # kernel B: the last full wave's histories, scorer vs plain recompute
    last = sorted(sent)[-128:]
    hist = torch.tensor([sent[i] for i in last], device=dev)
    fn = build_recommend_fn(top_k=top_k, device=dev)
    ids_k, sc_k = fn(model.user_encoder, table, hist)
    sc_p, ids_p = _plain_recommend(model, table, hist, top_k)
    with torch.no_grad():
        his = table[hist]
        w = model.user_encoder.fused_weights(his.dtype)
        from fedrec_tpu_torch.ops import fused_history_score, fused_history_score_plain
        u_k = fused_history_score(his, None, None, w, mc.num_heads)[1]
        u_p = fused_history_score_plain(his, None, None, w, mc.num_heads)[1]
    err_b = max_err(u_k, u_p)
    err_scores = max_err(sc_k, sc_p[:, :top_k])
    check(err_b <= F32_ATOL, f"user vectors vs plain: max err {err_b} > {F32_ATOL}")
    check(err_scores <= F32_ATOL, f"top-k scores vs plain: max err {err_scores} > {F32_ATOL}")
    served = torch.tensor([responses[i]["ids"] for i in last], device=dev)
    mismatch = _topk_disagreements(ids_k, sc_p, ids_p, top_k)
    mismatch_served = _topk_disagreements(served, sc_p, ids_p, top_k)
    check(mismatch == 0 and mismatch_served == 0,
          f"top-k ids differ from plain where scores are apart: {mismatch} (scorer), "
          f"{mismatch_served} (served)")
    state.setdefault("path_errs", {}).update({"additive_pool": err_a, "fused_history_score": err_b})
    state.setdefault("launches", {})["main_path"] = launches

    # ---- per-bucket scorer time (host clock to results on the host)
    scorer = service._fn_for(store.current())
    bucket_ms = {}
    for b in service.batcher.batch_sizes:
        hb = torch.from_numpy(rng.integers(1, N, size=(b, cfg.data.max_his_len)).astype(np.int32))
        times = []
        for _ in range(args.scorer_reps):
            t0 = time.perf_counter()
            scorer(model.user_encoder, hb)[0].cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        bucket_ms[b] = float(np.median(times))
    sizes = service.batcher.batch_sizes
    breakdown = {
        b: _device_breakdown(
            lambda hb=torch.from_numpy(rng.integers(1, N, size=(b, cfg.data.max_his_len))
                                       .astype(np.int32)): scorer(model.user_encoder, hb)[0].cpu(),
            reps=args.scorer_reps,
        )
        for b in (sizes[0], sizes[-1])
    }
    lat = np.asarray([r["latency_ms"] for r in responses.values()], np.float64)
    rtt = np.asarray(run["rtt_ms"], np.float64)
    return {
        "config": {"num_news": N, "title_len": L, "bert_hidden": mc.bert_hidden,
                   "news_dim": mc.news_dim, "num_heads": mc.num_heads,
                   "head_dim": mc.head_dim, "query_dim": mc.query_dim,
                   "history": cfg.data.max_his_len, "dtype": mc.dtype,
                   "fuse_hot_path": mc.fuse_hot_path, "use_pallas": mc.use_pallas,
                   "top_k": top_k, "chunk": args.chunk},
        "corpus_encode_ms": encode_ms,
        "warmup_ms": warmup_ms,
        "requests": len(sent),
        "batches_by_size": run["metrics"].get("batches_by_size"),
        "mean_occupancy": run["metrics"].get("mean_occupancy"),
        "scorer_ms_by_bucket": bucket_ms,
        "scorer_device_breakdown": breakdown,
        "server_latency_ms": {"p50": float(np.percentile(lat, 50)),
                              "p99": float(np.percentile(lat, 99))},
        "client_rtt_ms": {"p50": float(np.percentile(rtt, 50)),
                          "p99": float(np.percentile(rtt, 99))},
        "launches": launches,
        "max_abs_err": {"table_vs_plain": err_a, "user_vs_plain": err_b,
                        "topk_scores_vs_plain": err_scores},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "wire": run["wire"],
    }


def _train_cfg(args, *overrides: str):
    from fedrec_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().apply_overrides([
        "model.fuse_hot_path=true", "model.use_pallas=true", "model.text_encoder_mode=head",
        f"data.batch_size={args.batch_size}", f"fed.num_clients={args.clients}", *overrides,
    ])


def _param_diffs(model_a, model_b) -> tuple[list[str], float, float]:
    """Leaves outside the trajectory bars, the largest difference of the
    others and of the zero-gradient leaves."""
    import torch

    bad, worst, worst_noise = [], 0.0, 0.0
    pb = {k: v.detach() for k, v in model_b.named_parameters()}
    for name, a in model_a.named_parameters():
        a = a.detach()
        b = pb[name]
        diff = float((a - b).abs().max())
        if name.endswith(ZERO_GRAD_LEAVES):
            worst_noise = max(worst_noise, diff)
            if diff >= TRAJ_NOISE:
                bad.append(name)
            continue
        worst = max(worst, diff)
        if not torch.allclose(a, b, rtol=TRAJ_RTOL, atol=TRAJ_ATOL):
            bad.append(name)
    return bad, worst, worst_noise


def phase_train_path(state: dict, args) -> dict:
    import torch
    from fedrec_tpu_torch.data import TrainBatcher, index_samples, make_synthetic_mind
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.ops import (
        fused_gather_encode,
        fused_gather_encode_bwd,
        fused_gather_encode_bwd_plain,
        fused_gather_encode_plain,
        fused_history_score,
        fused_history_score_bwd,
        fused_history_score_bwd_plain,
        fused_history_score_plain,
        launch_counts,
        reset_launch_counts,
        text_head_weights,
    )
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.train import (
        build_fed_train_step,
        build_param_sync,
        init_client_state,
        replicate_state,
    )
    from fedrec_tpu_torch.train.step import unique_padded

    cfg = _train_cfg(args)
    mc, dc = cfg.model, cfg.data
    N, K, S, B = args.num_news, args.clients, args.local_steps, dc.batch_size
    T, C, H = dc.max_title_len, 1 + dc.npratio, dc.max_his_len
    dev = torch.device(DEV)
    tokens = _tokens(state, args, T, mc.bert_hidden)
    data = make_synthetic_mind(num_news=N, num_train=K * B * S, num_valid=0, title_len=T,
                               seed=args.seed)
    batcher = TrainBatcher(index_samples(data.train_samples, data.nid2index, H), B,
                           dc.npratio, seed=args.seed)
    batches = [{"candidates": b.candidates, "history": b.history, "labels": b.labels}
               for b in batcher.epoch_batches_sharded(K, 0)][:S]
    check(len(batches) == S, f"{len(batches)} batches for {S} local steps")
    model = init_params(NewsRecommender(mc), seed=args.seed).to(dev)
    states = replicate_state(init_client_state(model, cfg, args.seed), K, args.seed)
    step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device=dev)
    sync = build_param_sync(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---------------- the train path, with every launch count from 0
    reset_launch_counts()
    step_ms, losses, overflow = [], [], 0
    t_round = time.perf_counter()
    for b in batches:
        t0 = time.perf_counter()
        states, met = step(states, b, tokens)
        losses.append(met["loss"].tolist())  # a host read: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        overflow += met["unique_overflow"]
    states = sync(states, np.ones(K, np.float32))
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t_round) * 1e3
    launches = launch_counts()
    # ---------------- end of the train path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(all(math.isfinite(v) for row in losses for v in row), f"non-finite loss: {losses}")
    check(overflow == 0, f"unique_overflow {overflow}")
    for name, meta in KERNEL_META.items():
        if meta["path"] == "train_path" or name == "fused_history_score":
            check(launches[name] > 0, f"kernel {name} never launched on the train path")
    ref = list(states[0].model.parameters())
    for st in states[1:]:
        check(all(torch.equal(a, b) for a, b in zip(ref, st.model.parameters())),
              "clients differ after the round-end mean")
    check(all(bool(torch.isfinite(p).all()) for p in ref), "non-finite parameters after the round")

    # ---- the kernels against their plain versions on this path's inputs:
    # client 0's first batch, the synced weights
    m = states[0].model
    cand = torch.as_tensor(batches[0]["candidates"][0], device=dev)
    hist = torch.as_tensor(batches[0]["history"][0], device=dev)
    ids = torch.cat([cand.reshape(-1), hist.reshape(-1)])
    uniq, inv = unique_padded(ids.long(), min(ids.numel(), N))
    real = int(torch.unique(ids).numel())
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    with torch.no_grad():
        head = text_head_weights(m.text_head, torch.float32)
        tower = m.user_encoder.fused_weights(torch.float32)
        vecs = fused_gather_encode(tokens, uniq, head)
        err_c = max_err(vecs, fused_gather_encode_plain(tokens, uniq, head))
        cand_v = vecs[inv[: B * C]].reshape(B, C, -1)
        his_v = vecs[inv[B * C:]].reshape(B, H, -1)
        sk, uk = fused_history_score(his_v, cand_v, None, tower, mc.num_heads)
        sp, up = fused_history_score_plain(his_v, cand_v, None, tower, mc.num_heads)
        err_b = max(max_err(sk, sp), max_err(uk, up))
    g = torch.randn((uniq.numel(), mc.news_dim), generator=gen, device=dev)
    g[real:] = 0.0
    got_d = fused_gather_encode_bwd(tokens, uniq, head, g)
    want_d = fused_gather_encode_bwd_plain(tokens, uniq, head, g)
    gs = torch.randn((B, C), generator=gen, device=dev)
    gu = torch.randn((B, mc.news_dim), generator=gen, device=dev)
    got_e = fused_history_score_bwd(his_v, cand_v, None, tower, gs, gu, mc.num_heads)
    want_e = fused_history_score_bwd_plain(his_v, cand_v, None, tower, gs, gu, mc.num_heads)
    torch.cuda.synchronize()
    errs = {"fused_history_score": err_b, "fused_gather_encode": err_c}
    oks = {"fused_history_score": err_b <= F32_ATOL, "fused_gather_encode": err_c <= F32_ATOL}
    for name, pairs in (
        ("fused_gather_encode_bwd", list(zip(got_d, want_d))),
        ("fused_history_score_bwd", [(got_e[0], want_e[0]), (got_e[1], want_e[1]),
                                     *[(a, b) for f, a, b in zip(tower._fields, got_e[2], want_e[2])
                                       if f != "bk"]]),
    ):
        res = [within_grad(a, b, torch.float32) for a, b in pairs]
        errs[name] = max(r[1] for r in res)
        oks[name] = all(r[0] for r in res)
    check(all(oks.values()), f"train-path kernels vs plain: {errs}")
    state.setdefault("path_errs", {}).update(
        {k: v for k, v in errs.items() if KERNEL_META[k]["path"] == "train_path"})
    state.setdefault("launches", {})["train_path"] = launches

    # ---- device ms per launch at this path's shapes (CUDA events)
    per_launch = {
        "fused_history_score": time_ms(
            lambda: fused_history_score(his_v, cand_v, None, tower, mc.num_heads), reps=20),
        "fused_gather_encode": time_ms(lambda: fused_gather_encode(tokens, uniq, head), reps=10),
        "fused_gather_encode_bwd": time_ms(
            lambda: fused_gather_encode_bwd(tokens, uniq, head, g), reps=5),
        "fused_history_score_bwd": time_ms(
            lambda: fused_history_score_bwd(his_v, cand_v, None, tower, gs, gu, mc.num_heads), reps=10),
    }
    one = {k: v[:1] for k, v in batches[0].items()}
    step1 = build_fed_train_step(model, cfg, get_strategy("local"), device=dev)
    breakdown = _device_breakdown(lambda: step1(states[:1], one, tokens)[1]["loss"].tolist(),
                                  reps=3, top=12)

    # ---- kernel route against the pure-PyTorch dense route: one client,
    # the same init and batches, dropout 0
    cfg_k = _train_cfg(args, "model.dropout_rate=0.0", "fed.num_clients=1")
    cfg_d = _train_cfg(args, "model.dropout_rate=0.0", "fed.num_clients=1",
                       "model.fuse_hot_path=false", "model.use_pallas=false")
    mk = init_params(NewsRecommender(cfg_k.model), seed=args.seed + 2).to(dev)
    md = NewsRecommender(cfg_d.model).to(dev)
    md.load_state_dict(mk.state_dict())
    st_k, st_d = [init_client_state(mk, cfg_k)], [init_client_state(md, cfg_d)]
    step_k = build_fed_train_step(mk, cfg_k, get_strategy("local"), device=dev)
    step_d = build_fed_train_step(md, cfg_d, get_strategy("local"), device=dev)
    traj = []
    for i in range(TRAJ_STEPS):
        b1 = {k: v[:1] for k, v in batches[i % S].items()}
        lk = step_k(st_k, b1, tokens)[1]["loss"]
        ld = step_d(st_d, b1, tokens)[1]["loss"]
        traj.append((float(lk[0]), float(ld[0])))
        check(bool(torch.allclose(lk, ld, rtol=TRAJ_LOSS_RTOL, atol=TRAJ_LOSS_ATOL)),
              f"step {i}: kernel-route loss {float(lk[0])!r} vs dense {float(ld[0])!r}")
    bad, worst, worst_noise = _param_diffs(mk, md)
    check(not bad, f"kernel route vs dense after {TRAJ_STEPS} steps: {bad} outside the bars")

    # ---- the same 3 steps twice give the same bits
    def three_steps():
        mm = init_params(NewsRecommender(cfg.model), seed=args.seed + 3).to(dev)
        st = [init_client_state(mm, cfg, args.seed)]
        stp = build_fed_train_step(mm, cfg, get_strategy("local"), device=dev)
        for i in range(3):
            stp(st, {k: v[:1] for k, v in batches[i % S].items()}, tokens)
        return [p.detach().clone() for p in mm.parameters()]

    first, second = three_steps(), three_steps()
    bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
    check(bitwise, "the same 3 steps twice gave different parameters")

    return {
        "config": {"num_news": N, "clients": K, "local_steps": S, "batch_size": B,
                   "title_len": T, "history": H, "candidates": C, "unique_slots": int(uniq.numel()),
                   "bert_hidden": mc.bert_hidden, "news_dim": mc.news_dim,
                   "num_heads": mc.num_heads, "query_dim": mc.query_dim, "dtype": mc.dtype,
                   "dropout_rate": mc.dropout_rate, "optimizer": cfg.optim.optimizer,
                   "user_lr": cfg.optim.user_lr, "news_lr": cfg.optim.news_lr,
                   "strategy": "param_avg", "fuse_hot_path": mc.fuse_hot_path,
                   "use_pallas": mc.use_pallas},
        "step_ms": step_ms,
        "median_step_ms": float(np.median(step_ms)),
        "round_ms": round_ms,
        "losses": losses,
        "unique_overflow": overflow,
        "distinct_ids_first_batch": real,
        "launches": launches,
        "device_ms_per_launch": per_launch,
        "step_device_breakdown": breakdown,
        "max_abs_err_vs_plain": errs,
        "trajectory_losses_kernel_vs_dense": traj,
        "trajectory_max_param_diff": worst,
        "trajectory_max_zero_grad_leaf_diff": worst_noise,
        "bitwise_repeatable": bitwise,
        "peak_mem_gb": peak_gb,
    }


DENSE_ROUTE = ("model.attn_impl=dense", "model.use_pallas=false")


def _long_cfg(args, *overrides: str):
    """The long-history configuration: ExperimentConfig's widths with the
    unfused kernel route (use_pallas, no fuse_hot_path) at 2048 clicks."""
    from fedrec_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().apply_overrides([
        "model.use_pallas=true", "model.fuse_hot_path=false",
        f"data.max_his_len={args.long_history}", *overrides,
    ])


def _flat_heads(x, num_heads: int):
    """(B, L, heads * d) -> (B * heads, L, d), as flash_attention flattens."""
    b, L, hd = x.shape
    d = hd // num_heads
    return x.reshape(b, L, num_heads, d).transpose(1, 2).reshape(b * num_heads, L, d).contiguous()


def _attention_operands(encoder, his):
    """The user tower's flash operands for (B, H, D) history vectors: its
    q/k/v projections, head-flattened, and the no-mask key bias."""
    import torch
    from fedrec_tpu_torch.models.attention import dense

    a = encoder.self_attn
    q, k, v = (_flat_heads(dense(w, his, torch.float32), a.num_heads) for w in (a.w_q, a.w_k, a.w_v))
    return q, k, v, torch.zeros(q.shape[:2], device=q.device)


def _pool_operands(encoder):
    p = encoder.pool
    return p.att_fc1.weight.t().contiguous(), p.att_fc1.bias, p.att_fc2.weight[0].contiguous()


def phase_long_path(state: dict, args) -> dict:
    """Serving, then training, of the long-history user tower."""
    import torch
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.ops import (
        additive_pool,
        additive_pool_plain,
        flash_forward,
        flash_forward_plain,
        launch_counts,
        reset_launch_counts,
    )
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.serve import build_recommend_fn
    from fedrec_tpu_torch.serving import EmbeddingStore, ServingService
    from fedrec_tpu_torch.train.step import encode_all_news

    cfg = _long_cfg(args)
    mc = cfg.model
    N, T, H, top_k = args.num_news, cfg.data.max_title_len, cfg.data.max_his_len, 10
    dev = torch.device(DEV)
    tokens = _tokens(state, args, T, mc.bert_hidden)
    model = init_params(NewsRecommender(mc), seed=args.seed).to(dev).eval()

    # ---------------- serving, with every launch count from 0
    reset_launch_counts()
    t0 = time.perf_counter()
    table = encode_all_news(model, tokens, chunk=args.chunk, device=dev)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    store = EmbeddingStore()
    store.publish(table, model.user_encoder, source="synthetic")
    service = ServingService(store, history_len=H, top_k=top_k, device=dev)
    t0 = time.perf_counter()
    service.warmup()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(args.seed + 7)
    run = asyncio.run(_drive_server(service, args.long_waves, N, rng, H, (H // 2, H)))
    torch.cuda.synchronize()
    serve_launches = launch_counts()
    # ---------------- end of serving

    check(table.shape == (N, mc.news_dim) and bool(torch.isfinite(table).all()),
          f"news table {tuple(table.shape)} not finite/(N, {mc.news_dim})")
    sent, responses = run["sent"], run["responses"]
    _check_responses(sent, responses, top_k, least=sum(args.long_waves))
    for name in ("additive_pool", "additive_pool_long", "flash_forward"):
        check(serve_launches[name] > 0, f"kernel {name} never launched serving the long path")

    # ---- the kernel route against the dense route (no kernel at all, the
    # same weights) on the last wave, 8 rows at a time (dense scores are
    # (8, 20, H, H) f32, 2.7 GB at H=2048)
    dense_model = NewsRecommender(_long_cfg(args, *DENSE_ROUTE).model).to(dev).eval()
    dense_model.load_state_dict(model.state_dict())
    last = sorted(sent)[-args.long_waves[-1]:]
    hist = torch.tensor([sent[i] for i in last], device=dev)
    ids_k, sc_k = build_recommend_fn(top_k=top_k, device=dev)(model.user_encoder, table, hist)
    dense_fn = build_recommend_fn(top_k=top_k + 1, device=dev)
    parts = [dense_fn(dense_model.user_encoder, table, hist[i:i + 8]) for i in range(0, len(last), 8)]
    ids_d = torch.cat([p[0] for p in parts])
    sc_d = torch.cat([p[1] for p in parts])
    del parts, dense_model
    err_scores = max_err(sc_k, sc_d[:, :top_k])
    served = torch.tensor([responses[i]["ids"] for i in last], device=dev)
    mismatch = _topk_disagreements(ids_k, sc_d, ids_d, top_k)
    mismatch_served = _topk_disagreements(served, sc_d, ids_d, top_k)
    check(err_scores <= F32_ATOL, f"top-k scores vs the dense route: max err {err_scores} > {F32_ATOL}")
    check(mismatch == 0 and mismatch_served == 0,
          f"top-k ids differ from the dense route where scores are apart: {mismatch} (scorer), "
          f"{mismatch_served} (served)")
    # ---- F1 and A2 against their plain versions on served inputs
    with torch.no_grad():
        his = table[hist[:8]]
        q, k, v, bias = _attention_operands(model.user_encoder, his)
        err_f1 = max_err(flash_forward(q, k, v, bias)[0], flash_forward_plain(q, k, v, bias)[0])
        ctx = model.user_encoder.self_attn(his, his, his)
        w = _pool_operands(model.user_encoder)
        err_a2 = max_err(additive_pool(ctx, *w), additive_pool_plain(ctx, *w))
        del q, k, v, ctx
    check(err_f1 <= F32_ATOL and err_a2 <= F32_ATOL,
          f"long path kernels vs plain: F1 {err_f1}, A2 {err_a2} (atol {F32_ATOL})")

    # ---- per-bucket scorer time at H clicks (host clock to results on the host)
    scorer = service._fn_for(store.current())
    bucket_ms = {}
    for b in service.batcher.batch_sizes:
        hb = torch.from_numpy(rng.integers(1, N, size=(b, H)).astype(np.int32))
        times = []
        for _ in range(args.long_scorer_reps):
            t0 = time.perf_counter()
            scorer(model.user_encoder, hb)[0].cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        bucket_ms[b] = float(np.median(times))
    big = service.batcher.batch_sizes[-1]
    hb = torch.from_numpy(rng.integers(1, N, size=(big, H)).astype(np.int32))
    serve_breakdown = _device_breakdown(lambda: scorer(model.user_encoder, hb)[0].cpu(), reps=2)
    lat = np.asarray([r["latency_ms"] for r in responses.values()], np.float64)
    serving = {
        "corpus_encode_ms": encode_ms,
        "warmup_ms": warmup_ms,
        "requests": len(sent),
        "clicks_per_request": [H // 2, H],
        "batches_by_size": run["metrics"].get("batches_by_size"),
        "scorer_ms_by_bucket": bucket_ms,
        "scorer_device_breakdown": {big: serve_breakdown},
        "server_latency_ms": {"p50": float(np.percentile(lat, 50)),
                              "p99": float(np.percentile(lat, 99))},
        "launches": serve_launches,
        "max_abs_err": {"topk_scores_vs_dense": err_scores, "flash_forward_vs_plain": err_f1,
                        "additive_pool_long_vs_plain": err_a2},
    }
    del store, service, table, model, hist
    torch.cuda.empty_cache()

    training, train_launches, train_errs = _long_train(state, args, tokens)
    launches = {k: serve_launches[k] + train_launches[k] for k in serve_launches}
    state.setdefault("path_errs", {}).update(
        {"flash_forward": err_f1, "additive_pool_long": err_a2, **train_errs})
    state.setdefault("launches", {})["long_path"] = launches
    return {
        "config": {"num_news": N, "history": H, "title_len": T, "bert_hidden": mc.bert_hidden,
                   "news_dim": mc.news_dim, "num_heads": mc.num_heads, "head_dim": mc.head_dim,
                   "query_dim": mc.query_dim, "dtype": mc.dtype, "use_pallas": mc.use_pallas,
                   "fuse_hot_path": mc.fuse_hot_path, "attn_impl": mc.attn_impl,
                   "resolved_attn": "pallas", "top_k": top_k},
        "serving": serving,
        "training": training,
        "launches": launches,
    }


def _long_train(state: dict, args, tokens) -> tuple[dict, dict, dict]:
    """One param_avg round of the long-history joint step, the kernel route
    against the dense route, and a bitwise repeat. Returns the phase's
    training section, its launch counts and the F2/F3 errors."""
    import torch
    from fedrec_tpu_torch.data import TrainBatcher, index_samples, make_synthetic_mind
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.ops import (
        flash_backward_dkv,
        flash_backward_dkv_plain,
        flash_backward_dq,
        flash_backward_dq_plain,
        flash_forward_plain,
        launch_counts,
        reset_launch_counts,
    )
    from fedrec_tpu_torch.ops.attention_kernels import additive_pool_kernel_names
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.train import (
        build_fed_train_step,
        build_param_sync,
        init_client_state,
        replicate_state,
    )

    K, S, B = args.long_clients, args.long_local_steps, args.long_batch_size
    base = ("model.text_encoder_mode=head", f"data.batch_size={B}")
    cfg = _long_cfg(args, *base, f"fed.num_clients={K}")
    mc, dc = cfg.model, cfg.data
    N, T, H = args.num_news, dc.max_title_len, dc.max_his_len
    dev = torch.device(DEV)
    data = make_synthetic_mind(num_news=N, num_train=K * B * S, num_valid=0, title_len=T,
                               his_len_range=(H // 2, H), seed=args.seed)
    batcher = TrainBatcher(index_samples(data.train_samples, data.nid2index, H), B,
                           dc.npratio, seed=args.seed)
    batches = [{"candidates": b.candidates, "history": b.history, "labels": b.labels}
               for b in batcher.epoch_batches_sharded(K, 0)][:S]
    check(len(batches) == S, f"{len(batches)} batches for {S} local steps")
    model = init_params(NewsRecommender(mc), seed=args.seed).to(dev)
    states = replicate_state(init_client_state(model, cfg, args.seed), K, args.seed)
    step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device=dev)
    sync = build_param_sync(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---------------- training, with every launch count from 0
    reset_launch_counts()
    step_ms, losses, overflow = [], [], 0
    t_round = time.perf_counter()
    for b in batches:
        t0 = time.perf_counter()
        states, met = step(states, b, tokens)
        losses.append(met["loss"].tolist())  # a host read: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        overflow += met["unique_overflow"]
    states = sync(states, np.ones(K, np.float32))
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t_round) * 1e3
    launches = launch_counts()
    # ---------------- end of training
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(all(math.isfinite(v) for row in losses for v in row), f"non-finite loss: {losses}")
    check(overflow == 0, f"unique_overflow {overflow}")
    for name in ("additive_pool", "additive_pool_long", "flash_forward", "flash_backward_dq",
                 "flash_backward_dkv"):
        check(launches[name] > 0, f"kernel {name} never launched training the long path")
    ref = list(states[0].model.parameters())
    for st in states[1:]:
        check(all(torch.equal(a, b) for a, b in zip(ref, st.model.parameters())),
              "clients differ after the round-end mean")
    check(all(bool(torch.isfinite(p).all()) for p in ref), "non-finite parameters after the round")

    # ---- F2 and F3 against their plain versions on this path's inputs:
    # two histories of client 0's first batch through the synced weights
    m = states[0].model
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    with torch.no_grad():
        hist = torch.as_tensor(batches[0]["history"][0][:2], device=dev).long()
        his = m.encode_news(tokens[hist])                       # (2, H, D)
        q, k, v, bias = _attention_operands(m.user_encoder, his)
        out, lse = flash_forward_plain(q, k, v, bias)
    g = torch.randn(out.shape, generator=gen, device=dev)
    delta = (g * out).sum(-1)
    res = [within_grad(flash_backward_dq(q, k, v, bias, g, lse, delta),
                       flash_backward_dq_plain(q, k, v, bias, g, lse, delta), torch.float32)]
    got = flash_backward_dkv(q, k, v, bias, g, lse, delta)
    want = flash_backward_dkv_plain(q, k, v, bias, g, lse, delta)
    res_kv = [within_grad(a, b, torch.float32) for a, b in zip(got, want)]
    errs = {"flash_backward_dq": res[0][1], "flash_backward_dkv": max(r[1] for r in res_kv)}
    check(res[0][0] and all(r[0] for r in res_kv), f"long train path kernels vs plain: {errs}")
    del his, q, k, v, out, lse, g, delta, got, want

    one = {k: v[:1] for k, v in batches[0].items()}
    step1 = build_fed_train_step(model, cfg, get_strategy("local"), device=dev)
    # kernel A on the unfused text head: one launch a client step over the
    # step's U deduplicated slots, its device time from the breakdown: the
    # sum of the kernels it launches (its logits pass at hidden Dh / 2 and
    # its pool pass; the user tower's A2 runs its own instances)
    U, Dh = min(B * (1 + dc.npratio + H), N), mc.bert_hidden
    a_names = additive_pool_kernel_names(Dh // 2)
    breakdown = _device_breakdown(lambda: step1(states[:1], one, tokens)[1]["loss"].tolist(),
                                  reps=2, top=12, sum_of={"text_head_pool": a_names})
    a_cost = pool_cost(U, T, Dh, Dh // 2, 4)
    a_us = breakdown["sums_us"]["text_head_pool"]
    check(a_us is not None, f"kernel A's kernels {a_names} not found in the step's profile")
    text_head_pool = {"shape": [U, T, Dh], "hidden": Dh // 2, "launches_per_client_step": 1,
                      "kernels": list(a_names),
                      "device_ms": a_us / 1e3 if a_us is not None else None,
                      "bound_ms": bound(a_cost, "float32", state["peaks"])[0],
                      "cuda_core_bound_ms": cuda_core_bound(a_cost, state["peaks"])}
    del states, step, step1
    torch.cuda.empty_cache()

    # ---- kernel route against the dense route: one client, the same init
    # and batches, dropout 0
    one_client = (*base, "fed.num_clients=1", "model.dropout_rate=0.0")
    cfg_k = _long_cfg(args, *one_client)
    cfg_d = _long_cfg(args, *one_client, *DENSE_ROUTE)
    mk = init_params(NewsRecommender(cfg_k.model), seed=args.seed + 2).to(dev)
    md = NewsRecommender(cfg_d.model).to(dev)
    md.load_state_dict(mk.state_dict())
    st_k, st_d = [init_client_state(mk, cfg_k)], [init_client_state(md, cfg_d)]
    step_k = build_fed_train_step(mk, cfg_k, get_strategy("local"), device=dev)
    step_d = build_fed_train_step(md, cfg_d, get_strategy("local"), device=dev)
    torch.cuda.reset_peak_memory_stats()
    traj = []
    for i in range(args.long_traj_steps):
        b1 = {k: v[:1] for k, v in batches[i % S].items()}
        lk = step_k(st_k, b1, tokens)[1]["loss"]
        ld = step_d(st_d, b1, tokens)[1]["loss"]
        traj.append((float(lk[0]), float(ld[0])))
        check(bool(torch.allclose(lk, ld, rtol=TRAJ_LOSS_RTOL, atol=TRAJ_LOSS_ATOL)),
              f"step {i}: kernel-route loss {float(lk[0])!r} vs dense {float(ld[0])!r}")
    dense_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad, worst, worst_noise = _param_diffs(mk, md)
    check(not bad, f"kernel route vs dense after {args.long_traj_steps} steps: {bad} outside the bars")
    del mk, md, st_k, st_d, step_k, step_d
    torch.cuda.empty_cache()

    # ---- the same 3 steps twice give the same bits
    def three_steps():
        mm = init_params(NewsRecommender(cfg.model), seed=args.seed + 3).to(dev)
        st = [init_client_state(mm, cfg, args.seed)]
        stp = build_fed_train_step(mm, cfg, get_strategy("local"), device=dev)
        for i in range(3):
            stp(st, {k: v[:1] for k, v in batches[i % S].items()}, tokens)
        return [p.detach().clone() for p in mm.parameters()]

    first, second = three_steps(), three_steps()
    bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
    check(bitwise, "the same 3 steps twice gave different parameters")

    return {
        "config": {"clients": K, "local_steps": S, "batch_size": B, "history": H,
                   "clicks_per_history": [H // 2, H], "candidates": 1 + dc.npratio,
                   "strategy": "param_avg", "text_encoder_mode": mc.text_encoder_mode,
                   "dropout_rate": mc.dropout_rate, "optimizer": cfg.optim.optimizer},
        "step_ms": step_ms,
        "median_step_ms": float(np.median(step_ms)),
        "round_ms": round_ms,
        "losses": losses,
        "unique_overflow": overflow,
        "launches": launches,
        "step_device_breakdown": breakdown,
        "text_head_pool": text_head_pool,
        "max_abs_err_vs_plain": errs,
        "trajectory_losses_kernel_vs_dense": traj,
        "trajectory_max_param_diff": worst,
        "trajectory_max_zero_grad_leaf_diff": worst_noise,
        "bitwise_repeatable": bitwise,
        "peak_mem_gb": peak_gb,
        "dense_route_peak_mem_gb": dense_peak_gb,
    }, launches, errs


def _trainer_cfg(args, snapshot_dir: str, *overrides: str):
    """The trainer path's configuration: ExperimentConfig's widths, joint
    mode on the kernel route, param_avg, a full-pool evaluation and a
    snapshot every round, keep_best."""
    from fedrec_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().apply_overrides([
        "model.fuse_hot_path=true", "model.use_pallas=true", "model.text_encoder_mode=head",
        f"data.batch_size={args.batch_size}", f"fed.num_clients={args.clients}",
        "fed.strategy=param_avg", f"fed.rounds={TRAINER_ROUNDS}", "train.eval_every=1",
        "train.eval_protocol=full", "train.save_every=1", "train.keep_best=true",
        f"train.seed={args.seed}", f"train.snapshot_dir={snapshot_dir}", *overrides,
    ])


def _time_calls(obj, name: str, sink: list) -> None:
    """Replace ``obj.name`` by a wrapper that appends each call's wall time
    (ms, synchronised on both ends) to ``sink``."""
    import torch

    fn = getattr(obj, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, timed)


def _trainer_params(trainer) -> list:
    return [p.detach().clone() for st in trainer.states for p in st.model.parameters()]


def phase_trainer_path(state: dict, args) -> dict:
    """A whole evaluated, resumable federated run through ``Trainer``."""
    import contextlib
    import tempfile

    import torch
    from fedrec_tpu_torch.ops import (
        additive_pool_plain,
        fused_history_score,
        fused_history_score_plain,
        launch_counts,
        reset_launch_counts,
    )
    from fedrec_tpu_torch.ops.attention_kernels import additive_pool_kernel_names
    from fedrec_tpu_torch.models.attention import dense
    from fedrec_tpu_torch.serve import build_recommend_fn
    from fedrec_tpu_torch.serving import EmbeddingStore
    from fedrec_tpu_torch.train import SnapshotManager, Trainer

    K, B, S, R = args.clients, args.batch_size, args.trainer_steps, TRAINER_ROUNDS
    dev = torch.device(DEV)
    # snapshots under the checkout's git-ignored build directory
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(prefix="trainer_path_", dir=build)
    root = work.name
    cfg = _trainer_cfg(args, f"{root}/kernel")
    mc, dc = cfg.model, cfg.data
    N, T, H = args.num_news, dc.max_title_len, dc.max_his_len
    tokens = _tokens(state, args, T, mc.bert_hidden)
    data = _mind_data(state, args, T)
    # the trainer's per-round lines go to stderr: stdout holds the phases' JSON
    quiet = contextlib.redirect_stdout(sys.stderr)
    with quiet:
        trainer = Trainer(cfg, data, tokens, device=dev)
    check(trainer.token_states.data_ptr() == tokens.data_ptr(), "the trainer copied the table")
    check(trainer.batcher.num_batches(len(trainer.batcher.indexed) // K) == S,
          f"{S} steps a local epoch expected")
    times: dict[str, list] = {"round": [], "eval": [], "encode": []}
    _time_calls(trainer, "train_round", times["round"])
    _time_calls(trainer, "_eval_if_due", times["eval"])
    _time_calls(trainer, "_encode_corpus", times["encode"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---------------- the trainer path, with every launch count from 0
    reset_launch_counts()
    t0 = time.perf_counter()
    with quiet:
        history = trainer.run()
        user, table = trainer.export_for_serving()
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    # ---------------- end of the trainer path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [h.train_loss for h in history]
    metrics = [h.val_metrics for h in history]
    check([h.round_idx for h in history] == list(range(R)), f"rounds {[h.round_idx for h in history]}")
    check(all(math.isfinite(v) for v in losses), f"non-finite round loss: {losses}")
    check(all(set(m) == {"auc", "mrr", "ndcg5", "ndcg10"} for m in metrics), f"metrics {metrics}")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for m in metrics for v in m.values()),
          f"metrics outside [0, 1]: {metrics}")
    for name in ("additive_pool", "fused_history_score", "fused_gather_encode",
                 "fused_gather_encode_bwd", "fused_history_score_bwd"):
        check(launches[name] > 0, f"kernel {name} never launched on the trainer path")
    eval_batches = -(-args.valid // 256)
    check(launches["fused_history_score"] >= R * (K * S + eval_batches),
          f"kernel B launched {launches['fused_history_score']} times: fewer than the "
          f"train steps' and the {eval_batches} eval batches a pass")
    best = json.loads((trainer.best_snapshots.directory / "best.json").read_text())
    aucs = [m["auc"] for m in metrics]
    check(best["round"] == int(np.argmax(aucs)) and best["auc"] == max(aucs),
          f"best.json {best} against the rounds' AUC {aucs}")
    state.setdefault("launches", {})["trainer_path"] = launches

    # ---- the path's kernels against their plain versions on its inputs:
    # the corpus encode's first chunk (A), the first eval batch's user
    # vectors (B at n = 256, C = 0)
    m0 = trainer.states[0].model
    with torch.no_grad():
        th = m0.text_head
        pooled = additive_pool_plain(tokens[: args.chunk], th.pool.att_fc1.weight.t().contiguous(),
                                     th.pool.att_fc1.bias, th.pool.att_fc2.weight[0].contiguous())
        err_a = max_err(table[: args.chunk], dense(th.fc, pooled, torch.float32))
        his = table[torch.as_tensor(trainer.valid_ix.history[:256], device=dev).long()]
        w = m0.user_encoder.fused_weights(his.dtype)
        err_b = max_err(fused_history_score(his, None, None, w, mc.num_heads)[1],
                        fused_history_score_plain(his, None, None, w, mc.num_heads)[1])
    check(err_a <= F32_ATOL and err_b <= F32_ATOL,
          f"trainer path kernels vs plain: A {err_a}, B {err_b} (atol {F32_ATOL})")

    # ---- serving the export: the store and the scorer take it unchanged
    store = EmbeddingStore()
    store.publish(table, user, round=R - 1, source="trainer")
    gen = store.current()
    rng = np.random.default_rng(args.seed + 11)
    hist = torch.as_tensor(rng.integers(1, N, size=(8, H)), device=dev)
    ids, _ = build_recommend_fn(top_k=10, device=dev)(gen.user_params, gen.news_vecs, hist)
    ref_scores, ref_ids = _plain_recommend(m0, table, hist, 10)
    mismatch = _topk_disagreements(ids, ref_scores, ref_ids, 10)
    check(mismatch == 0, f"served top-k differ from the plain route where apart: {mismatch}")

    # ---- one evaluation pass: device time by kernel, busy share
    corpus_names = additive_pool_kernel_names(mc.bert_hidden // 2)
    breakdown = _device_breakdown(lambda: trainer.evaluate_full(), reps=2, top=10,
                                  sum_of={"corpus_encode_A": corpus_names})

    # ---- snapshot cost: a blocking save of the K clients, then a restore
    mgr = SnapshotManager(f"{root}/timing")
    t0 = time.perf_counter()
    mgr.save(0, trainer.states, wait=True)
    save_ms = (time.perf_counter() - t0) * 1e3
    snap_mb = sum(f.stat().st_size for f in mgr.directory.rglob("state.pt")) / 2**20
    t0 = time.perf_counter()
    with quiet:
        mgr.restore(trainer.states)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    mgr.close()

    # ---- the kernel route against the dense route, from the same seeds
    dense_cfg = _trainer_cfg(args, f"{root}/dense", "model.fuse_hot_path=false",
                             "model.use_pallas=false")
    reset_launch_counts()
    with quiet:
        dense_trainer = Trainer(dense_cfg, data, tokens, device=dev)
        dense_hist = dense_trainer.run()
    dense_launches = launch_counts()
    check(not any(dense_launches.values()), f"the dense route launched {dense_launches}")
    traj = [(a, h.train_loss) for a, h in zip(losses, dense_hist)]
    for r, (lk, ld) in enumerate(traj):
        check(math.isclose(lk, ld, rel_tol=TRAJ_LOSS_RTOL, abs_tol=TRAJ_LOSS_ATOL),
              f"round {r}: kernel-route loss {lk!r} vs dense {ld!r}")
    val_diff = max(abs(m[k] - h.val_metrics[k]) for m, h in zip(metrics, dense_hist) for k in m)
    check(val_diff <= VAL_ATOL, f"validation means: kernel vs dense route differ by {val_diff}")
    # the final parameters at the train path's bars: the run's loss and AUC
    # sit near chance on random data, so they alone would not show a wrong
    # gradient
    param_worst, param_worst_noise = 0.0, 0.0
    for c, (sk, sd) in enumerate(zip(trainer.states, dense_trainer.states)):
        bad, worst, worst_noise = _param_diffs(sk.model, sd.model)
        check(not bad, f"client {c}: kernel route vs dense after {R} rounds: {bad} "
                       "outside the bars")
        param_worst = max(param_worst, worst)
        param_worst_noise = max(param_worst_noise, worst_noise)
    del dense_trainer

    # ---- resume: 2 rounds, then a fresh Trainer on the same directory
    # finishes the run; bitwise equal to the uninterrupted run
    with quiet:
        Trainer(_trainer_cfg(args, f"{root}/resume", f"fed.rounds={R - 1}"), data, tokens,
                device=dev).run()
        resumed = Trainer(_trainer_cfg(args, f"{root}/resume"), data, tokens, device=dev)
        check(resumed.start_round == R - 1, f"resumed at round {resumed.start_round}")
        last = resumed.run()
    check(len(last) == 1 and last[0].train_loss == losses[-1]
          and last[0].val_metrics == metrics[-1],
          f"resumed round {last[0].round_idx}: {last[0].train_loss!r} {last[0].val_metrics} vs "
          f"{losses[-1]!r} {metrics[-1]}")
    bitwise = all(torch.equal(a, b) for a, b in zip(_trainer_params(trainer),
                                                    _trainer_params(resumed)))
    check(bitwise, "the resumed run's parameters differ from the uninterrupted run's")
    work.cleanup()

    round_ms = times["round"]
    return {
        "config": {"num_news": N, "clients": K, "local_steps": S, "batch_size": B,
                   "rounds": R, "num_train": K * B * S, "num_valid": args.valid,
                   "eval_batch": 256, "eval_protocol": cfg.train.eval_protocol,
                   "title_len": T, "history": H, "bert_hidden": mc.bert_hidden,
                   "news_dim": mc.news_dim, "num_heads": mc.num_heads,
                   "query_dim": mc.query_dim, "dtype": mc.dtype,
                   "dropout_rate": mc.dropout_rate, "strategy": cfg.fed.strategy,
                   "fuse_hot_path": mc.fuse_hot_path, "use_pallas": mc.use_pallas,
                   "keep_best": cfg.train.keep_best, "save_every": cfg.train.save_every},
        "run_ms": run_ms,
        "round_ms": round_ms,
        "round_ms_without_eval": [r - e for r, e in zip(round_ms, times["eval"])],
        "eval_ms": times["eval"],
        "eval_corpus_encode_ms": times["encode"][:R],
        "export_corpus_encode_ms": times["encode"][R],
        "eval_device_breakdown": breakdown,
        "snapshot_save_ms": save_ms,
        "snapshot_mb": snap_mb,
        "restore_ms": restore_ms,
        "losses": losses,
        "val_metrics": metrics,
        "best": best,
        "launches": launches,
        "max_abs_err_vs_plain": {"additive_pool": err_a, "fused_history_score": err_b},
        "kernel_vs_dense": {"losses": traj, "max_val_metric_diff": val_diff,
                            "max_param_diff": param_worst,
                            "max_zero_grad_leaf_diff": param_worst_noise,
                            "dense_val_metrics": [h.val_metrics for h in dense_hist],
                            "dense_route_launches": sum(dense_launches.values())},
        "resume": {"start_round": resumed.start_round, "bitwise": bitwise},
        "peak_mem_gb": peak_gb,
    }


def _decoupled_cfg(args, snapshot_dir: str, *overrides: str):
    """The decoupled path's configuration: ExperimentConfig's widths and its
    default text_encoder_mode ("table"), the kernel route, param_avg, two
    local epochs, a full-pool evaluation and a snapshot every round,
    keep_best."""
    from fedrec_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig().apply_overrides([
        "model.fuse_hot_path=true", "model.use_pallas=true",
        f"data.batch_size={args.batch_size}", f"fed.num_clients={args.clients}",
        "fed.strategy=param_avg", f"fed.rounds={TRAINER_ROUNDS}",
        f"fed.local_epochs={DECOUPLED_EPOCHS}", "train.eval_every=1",
        "train.eval_protocol=full", "train.save_every=1", "train.keep_best=true",
        f"train.seed={args.seed}", f"train.snapshot_dir={snapshot_dir}", *overrides,
    ])
    check(cfg.model.text_encoder_mode == "table", "decoupled mode is the config's default")
    return cfg


def _mind_data(state: dict, args, title_len: int):
    """The trainer paths' synthetic MIND split (K x B x steps training
    samples, ``--valid`` validation impressions), made once."""
    from fedrec_tpu_torch.data import make_synthetic_mind

    if "mind" not in state:
        state["mind"] = make_synthetic_mind(
            num_news=args.num_news, num_train=args.clients * args.batch_size * args.trainer_steps,
            num_valid=args.valid, title_len=title_len, seed=args.seed)
    return state["mind"]


def _news_update_parts(model, tokens, chunk: int, gen) -> dict:
    """Device time (CUDA events, ms) of one client's news update, part by
    part over the whole corpus: A's forward over every chunk, A's backward
    (autograd of the plain pool, as the update runs it), the fc layer's
    backward, the re-encode (``encode_all_news``), and the train step's
    scatter into the accumulator at the step's size."""
    import torch
    from fedrec_tpu_torch.models.attention import dense
    from fedrec_tpu_torch.ops import additive_pool, additive_pool_plain
    from fedrec_tpu_torch.train import encode_all_news, scatter_add_rows

    th = model.text_head
    n, d = tokens.shape[0], th.fc.out_features
    w = [th.pool.att_fc1.weight.t().contiguous(), th.pool.att_fc1.bias.detach(),
         th.pool.att_fc2.weight[0].detach().contiguous()]
    spans = [(s, min(s + chunk, n)) for s in range(0, n, chunk)]
    cot = torch.randn((n, d), generator=gen, device=DEV)
    with torch.no_grad():
        pooled = [additive_pool(tokens[a:b], *w) for a, b in spans]
    g_pooled = [c @ th.fc.weight.detach() for c in cot.split(chunk)]

    def a_forward():
        with torch.no_grad():
            for a, b in spans:
                additive_pool(tokens[a:b], *w)

    def a_backward():
        leaves = [t.detach().requires_grad_() for t in w]
        with torch.enable_grad():
            for (a, b), g in zip(spans, g_pooled):
                torch.autograd.grad(additive_pool_plain(tokens[a:b], *leaves), leaves, g)

    def fc_backward():
        params = list(th.fc.parameters())
        with torch.enable_grad():
            for p_, c in zip(pooled, cot.split(chunk)):
                leaf = p_.requires_grad_()
                torch.autograd.grad(dense(th.fc, leaf, torch.float32), [leaf, *params], c)

    accum = torch.zeros((n, d), device=DEV)
    ids = torch.randint(0, n, (64 * 55,), generator=gen, device=DEV)
    rows = torch.randn((ids.numel(), d), generator=gen, device=DEV)
    with torch.no_grad():
        return {
            "a_forward_ms": time_ms(a_forward, 2, warmup=1),
            "a_plain_backward_ms": time_ms(a_backward, 2, warmup=1),
            "fc_backward_ms": time_ms(fc_backward, 2, warmup=1),
            "re_encode_ms": time_ms(lambda: encode_all_news(model, tokens, chunk, device=DEV),
                                    2, warmup=1),
            "scatter_ms_per_step": time_ms(lambda: scatter_add_rows(accum, ids, rows), 20),
            "rows": n, "chunk": chunk,
        }


def _cli_leg(argv: list[str]) -> dict:
    """``fedrec_tpu_torch.cli.run.main(argv)`` in this process: its exit code,
    its ``final:`` line parsed, its wall time and its kernel launches."""
    import contextlib
    import io

    import torch
    from fedrec_tpu_torch.cli import run
    from fedrec_tpu_torch.ops import launch_counts, reset_launch_counts

    out = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = run.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    finals = [ln for ln in out.getvalue().splitlines() if ln.startswith("final: ")]
    check(rc == 0 and len(finals) == 1, f"cli {argv}: rc {rc}, final lines {finals}")
    fields = {k: float(v) for k, v in (kv.split("=") for kv in finals[0][7:].split())}
    check(math.isfinite(fields["loss"]) and 0.0 <= fields["auc"] <= 1.0,
          f"cli {argv}: {finals[0]}")
    return {"argv": argv, "rc": rc, "final": fields, "wall_s": wall_s, "launches": launches}


def phase_decoupled_path(state: dict, args) -> dict:
    """The JAX CLI's default run: decoupled mode through ``Trainer``, its
    ldp_news leg, and the run CLI itself."""
    import contextlib
    import copy
    import tempfile

    import torch
    from fedrec_tpu_torch.models.attention import dense
    from fedrec_tpu_torch.ops import (
        additive_pool_plain,
        fused_history_score_bwd,
        fused_history_score_bwd_plain,
        launch_counts,
        reset_launch_counts,
    )
    from fedrec_tpu_torch.ops.attention_kernels import additive_pool_kernel_names
    from fedrec_tpu_torch.serve import build_recommend_fn
    from fedrec_tpu_torch.serving import EmbeddingStore
    from fedrec_tpu_torch.train import SnapshotManager, Trainer

    K, B, S, R, E = args.clients, args.batch_size, args.trainer_steps, TRAINER_ROUNDS, DECOUPLED_EPOCHS
    dev = torch.device(DEV)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(prefix="decoupled_path_", dir=build)
    root = work.name
    cfg = _decoupled_cfg(args, f"{root}/kernel")
    mc, dc = cfg.model, cfg.data
    N, T, H = args.num_news, dc.max_title_len, dc.max_his_len
    tokens = _tokens(state, args, T, mc.bert_hidden)
    data = _mind_data(state, args, T)
    quiet = contextlib.redirect_stdout(sys.stderr)
    with quiet:
        trainer = Trainer(cfg, data, tokens, device=dev)
    check(trainer.mode == "decoupled" and trainer.token_states.data_ptr() == tokens.data_ptr(),
          "a decoupled trainer over the shared table")
    check(trainer.batcher.num_batches(len(trainer.batcher.indexed) // K) == S,
          f"{S} steps a local epoch expected")
    step_fn, update_fn = trainer.train_step, trainer.news_update  # untimed, for the profiles
    times: dict[str, list] = {k: [] for k in ("round", "eval", "step", "news_update", "refresh")}
    _time_calls(trainer, "train_round", times["round"])
    _time_calls(trainer, "_eval_if_due", times["eval"])
    _time_calls(trainer, "train_step", times["step"])
    _time_calls(trainer, "news_update", times["news_update"])
    _time_calls(trainer, "_refresh_table", times["refresh"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---------------- the decoupled path, with every launch count from 0
    reset_launch_counts()
    t0 = time.perf_counter()
    with quiet:
        history = trainer.run()
        user, table = trainer.export_for_serving()
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    # ---------------- end of the decoupled path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [h.train_loss for h in history]
    metrics = [h.val_metrics for h in history]
    check([h.round_idx for h in history] == list(range(R)), f"rounds {[h.round_idx for h in history]}")
    check(all(math.isfinite(v) for v in losses), f"non-finite round loss: {losses}")
    check(all(set(m) == {"auc", "mrr", "ndcg5", "ndcg10"} for m in metrics), f"metrics {metrics}")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for m in metrics for v in m.values()),
          f"metrics outside [0, 1]: {metrics}")
    for name in ("additive_pool", "fused_history_score", "fused_history_score_bwd"):
        check(launches[name] > 0, f"kernel {name} never launched on the decoupled path")
    for name in ("fused_gather_encode", "fused_gather_encode_bwd"):
        check(launches[name] == 0, f"joint-mode kernel {name} launched on the decoupled path")
    chunks = -(-N // 2048)  # encode_all_news's and the news update's chunk
    # the first table, each news update's forward and re-encode per client,
    # each round-end refresh (evaluation and the export reuse the table)
    want_a = chunks * (1 + R * (E * 2 * K + 1))
    check(launches["additive_pool"] == want_a,
          f"kernel A launched {launches['additive_pool']} times, {want_a} expected")
    check(len(times["refresh"]) == R + 1, f"table refreshes {len(times['refresh'])}")
    check(all(float(st.news_grad_accum.abs().max()) == 0.0 for st in trainer.states),
          "an accumulator is not zero at the round end")
    best = json.loads((trainer.best_snapshots.directory / "best.json").read_text())
    aucs = [m["auc"] for m in metrics]
    check(best["round"] == int(np.argmax(aucs)) and best["auc"] == max(aucs),
          f"best.json {best} against the rounds' AUC {aucs}")
    state.setdefault("launches", {})["decoupled_path"] = launches

    # ---- the path's kernels against their plain versions on its inputs:
    # A on the table's first chunk, E on the first step's gathered vectors
    m0 = trainer.states[0].model
    gen = torch.Generator(device=DEV).manual_seed(args.seed + 21)
    batch0 = next(iter(trainer.batcher.epoch_batches_sharded(K, 0)))
    batch0 = {"candidates": batch0.candidates, "history": batch0.history, "labels": batch0.labels}
    with torch.no_grad():
        th = m0.text_head
        pooled = additive_pool_plain(tokens[: args.chunk], th.pool.att_fc1.weight.t().contiguous(),
                                     th.pool.att_fc1.bias, th.pool.att_fc2.weight[0].contiguous())
        err_a = max_err(table[: args.chunk], dense(th.fc, pooled, torch.float32))
        cand = table[torch.as_tensor(batch0["candidates"][0], device=dev).long()]
        his = table[torch.as_tensor(batch0["history"][0], device=dev).long()]
        w = m0.user_encoder.fused_weights(his.dtype)
        g_s = torch.randn(cand.shape[:2], generator=gen, device=DEV)
        g_u = torch.zeros((B, mc.news_dim), device=DEV)
        got = fused_history_score_bwd(his, cand, None, w, g_s, g_u, mc.num_heads)
        want = fused_history_score_bwd_plain(his, cand, None, w, g_s, g_u, mc.num_heads)
        errs_e = [within_grad(a, b, torch.float32) for a, b in zip(got[:2], want[:2])]
    check(err_a <= F32_ATOL, f"decoupled path: A vs plain {err_a} (atol {F32_ATOL})")
    check(all(ok for ok, _, _ in errs_e), f"decoupled path: E's dx, dcand vs plain {errs_e}")
    err_e = max(e for _, e, _ in errs_e)

    # ---- serving the export: the store and the scorer take it unchanged
    store = EmbeddingStore()
    store.publish(table, user, round=R - 1, source="decoupled")
    gen_s = store.current()
    rng = np.random.default_rng(args.seed + 13)
    hist = torch.as_tensor(rng.integers(1, N, size=(8, H)), device=dev)
    ids, _ = build_recommend_fn(top_k=10, device=dev)(gen_s.user_params, gen_s.news_vecs, hist)
    ref_scores, ref_ids = _plain_recommend(m0, table, hist, 10)
    mismatch = _topk_disagreements(ids, ref_scores, ref_ids, 10)
    check(mismatch == 0, f"served top-k differ from the plain route where apart: {mismatch}")

    # ---- one client's news update and one 4-client step, by kernel, on
    # copies of the final states (the copies step; the run is untouched)
    corpus_names = additive_pool_kernel_names(mc.bert_hidden // 2)
    spare = copy.deepcopy(trainer.states)
    # each call ends in a synchronise: neither reads a result back
    update_breakdown = _device_breakdown(
        lambda: (update_fn(spare[:1], tokens), torch.cuda.synchronize()), reps=1, top=10,
        sum_of={"A": corpus_names})
    step_breakdown = _device_breakdown(
        lambda: (step_fn(spare, batch0, table), torch.cuda.synchronize()), reps=2, top=10)
    parts = _news_update_parts(m0, tokens, args.chunk, gen)
    del spare

    # ---- snapshot cost: a blocking save of the K clients, then a restore
    mgr = SnapshotManager(f"{root}/timing")
    t0 = time.perf_counter()
    mgr.save(0, trainer.states, wait=True)
    save_ms = (time.perf_counter() - t0) * 1e3
    snap_mb = sum(f.stat().st_size for f in mgr.directory.rglob("state.pt")) / 2**20
    restored = copy.deepcopy(trainer.states)
    t0 = time.perf_counter()
    with quiet:
        mgr.restore(restored)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    mgr.close()
    del restored

    # ---- the kernel route against the dense route, from the same seeds
    reset_launch_counts()
    with quiet:
        dense_trainer = Trainer(_decoupled_cfg(args, f"{root}/dense", "model.fuse_hot_path=false",
                                               "model.use_pallas=false"), data, tokens, device=dev)
        dense_hist = dense_trainer.run()
        _, dense_table = dense_trainer.export_for_serving()
    dense_launches = launch_counts()
    check(not any(dense_launches.values()), f"the dense route launched {dense_launches}")
    traj = [(a, h.train_loss) for a, h in zip(losses, dense_hist)]
    for r, (lk, ld) in enumerate(traj):
        check(math.isclose(lk, ld, rel_tol=TRAJ_LOSS_RTOL, abs_tol=TRAJ_LOSS_ATOL),
              f"round {r}: kernel-route loss {lk!r} vs dense {ld!r}")
    val_diff = max(abs(m[k] - h.val_metrics[k]) for m, h in zip(metrics, dense_hist) for k in m)
    check(val_diff <= VAL_ATOL, f"validation means: kernel vs dense route differ by {val_diff}")
    param_worst, param_worst_noise = 0.0, 0.0
    for c, (sk, sd) in enumerate(zip(trainer.states, dense_trainer.states)):
        bad, worst, worst_noise = _param_diffs(sk.model, sd.model)
        check(not bad, f"client {c}: kernel route vs dense after {R} rounds: {bad} outside the bars")
        param_worst = max(param_worst, worst)
        param_worst_noise = max(param_worst_noise, worst_noise)
    table_diff = max_err(table, dense_table)
    check(bool(torch.allclose(table, dense_table, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)),
          f"final table: kernel route vs dense route differ by {table_diff}")
    dense_val = [h.val_metrics for h in dense_hist]
    del dense_trainer, dense_table

    # ---- resume: 2 rounds, then a fresh Trainer on the same directory
    # finishes the run; bitwise equal to the uninterrupted run
    with quiet:
        Trainer(_decoupled_cfg(args, f"{root}/resume", f"fed.rounds={R - 1}"), data, tokens,
                device=dev).run()
        resumed = Trainer(_decoupled_cfg(args, f"{root}/resume"), data, tokens, device=dev)
        check(resumed.start_round == R - 1, f"resumed at round {resumed.start_round}")
        last = resumed.run()
    check(len(last) == 1 and last[0].train_loss == losses[-1]
          and last[0].val_metrics == metrics[-1],
          f"resumed round {last[0].round_idx}: {last[0].train_loss!r} {last[0].val_metrics} vs "
          f"{losses[-1]!r} {metrics[-1]}")
    resume_bitwise = (all(torch.equal(a, b) for a, b in zip(_trainer_params(trainer),
                                                            _trainer_params(resumed)))
                      and torch.equal(trainer._table, resumed._table))
    check(resume_bitwise, "the resumed run's parameters or table differ from the uninterrupted run's")
    del resumed

    # ---- a repeat of the kernel route: bitwise equal
    with quiet:
        again = Trainer(_decoupled_cfg(args, f"{root}/again"), data, tokens, device=dev)
        again_hist = again.run()
    repeat_bitwise = ([h.train_loss for h in again_hist] == losses
                      and [h.val_metrics for h in again_hist] == metrics
                      and all(torch.equal(a, b) for a, b in zip(_trainer_params(trainer),
                                                                _trainer_params(again)))
                      and torch.equal(trainer._table, again._table))
    check(repeat_bitwise, "a repeat of the kernel route differs from the first run")
    del again

    # ---- ldp_news: one round of one epoch, noise on and off, same seeds
    legs = {}
    for name, extra in (("clean", ()), ("noised", ("privacy.enabled=true",
                                                    "privacy.mechanism=ldp_news",
                                                    "privacy.sigma=1.0"))):
        with quiet:
            t = Trainer(_decoupled_cfg(args, "", "fed.rounds=1", "fed.local_epochs=1",
                                       "train.eval_every=1000", *extra), data, tokens, device=dev)
            legs[name] = (t, t.run())
    (clean, clean_hist), (noised, noised_hist) = legs["clean"], legs["noised"]
    check(all(math.isfinite(h.train_loss) for h in noised_hist), f"ldp_news loss {noised_hist}")
    user_equal = all(torch.equal(p, q) for a, b in zip(clean.states, noised.states)
                     for p, q in zip(a.user_params(), b.user_params()))
    head_diff = max(max_err(p, q) for a, b in zip(clean.states, noised.states)
                    for p, q in zip(a.news_params(), b.news_params()))
    check(user_equal, "ldp_news moved the user tower")
    check(head_diff > 0, "ldp_news left the text head as it was")
    ldp = {"sigma": 1.0, "loss": noised_hist[0].train_loss, "clean_loss": clean_hist[0].train_loss,
           "user_params_bitwise_equal": user_equal, "max_text_head_diff": head_diff}
    del legs, clean, noised

    # ---- the run CLI, in this process, at its own synthetic defaults, on
    # the kernel route (model.fuse_hot_path and use_pallas default off)
    base = ["2", str(B), "1", "--synthetic", "--clients", str(K),
            "--set", "model.fuse_hot_path=true", "--set", "model.use_pallas=true"]
    cli = {}
    for name, extra in (("decoupled", []), ("joint", ["--mode", "joint"]),
                        ("dp_epsilon", ["--dp-epsilon", "8"])):
        cli[name] = _cli_leg([*base, *extra, "--set", f"train.snapshot_dir={root}/cli_{name}"])
    for name in ("decoupled", "dp_epsilon"):
        n = cli[name]["launches"]
        check(n["additive_pool"] > 0 and n["fused_history_score"] > 0
              and n["fused_history_score_bwd"] > 0, f"cli {name}: kernels A, B, E {n}")
        check(n["fused_gather_encode"] == n["fused_gather_encode_bwd"] == 0,
              f"cli {name}: kernels C, D launched {n}")
    n = cli["joint"]["launches"]
    check(n["fused_gather_encode"] > 0 and n["fused_gather_encode_bwd"] > 0,
          f"cli joint: kernels C, D never launched {n}")
    work.cleanup()

    round_ms = times["round"]
    return {
        "config": {"num_news": N, "clients": K, "local_steps": S, "local_epochs": E,
                   "batch_size": B, "rounds": R, "num_train": K * B * S, "num_valid": args.valid,
                   "eval_protocol": cfg.train.eval_protocol, "mode": mc.text_encoder_mode,
                   "title_len": T, "history": H, "bert_hidden": mc.bert_hidden,
                   "news_dim": mc.news_dim, "num_heads": mc.num_heads, "query_dim": mc.query_dim,
                   "dtype": mc.dtype, "dropout_rate": mc.dropout_rate,
                   "strategy": cfg.fed.strategy, "fuse_hot_path": mc.fuse_hot_path,
                   "use_pallas": mc.use_pallas, "keep_best": cfg.train.keep_best,
                   "save_every": cfg.train.save_every},
        "run_ms": run_ms,
        "round_ms": round_ms,
        "round_ms_without_eval": [r - e for r, e in zip(round_ms, times["eval"])],
        "eval_ms": times["eval"],
        "step_ms": times["step"],
        "news_update_ms": times["news_update"],
        "news_update_ms_per_client": [t / K for t in times["news_update"]],
        "news_update_parts_one_client": parts,
        "news_update_device_breakdown": update_breakdown,
        "step_device_breakdown": step_breakdown,
        "refresh_ms": times["refresh"],
        "snapshot_save_ms": save_ms,
        "snapshot_mb": snap_mb,
        "restore_ms": restore_ms,
        "losses": losses,
        "val_metrics": metrics,
        "best": best,
        "launches": launches,
        "max_abs_err_vs_plain": {"additive_pool": err_a, "fused_history_score_bwd": err_e},
        "kernel_vs_dense": {"losses": traj, "max_val_metric_diff": val_diff,
                            "max_param_diff": param_worst,
                            "max_zero_grad_leaf_diff": param_worst_noise,
                            "max_table_diff": table_diff, "dense_val_metrics": dense_val,
                            "dense_route_launches": sum(dense_launches.values())},
        "resume_bitwise": resume_bitwise,
        "repeat_bitwise": repeat_bitwise,
        "ldp_news": ldp,
        "cli": cli,
        "peak_mem_gb": peak_gb,
    }


# ------------------------------------------------------------ serving_path
class _PathLaunches:
    """Kernel launches summed over the segments of a path: each segment
    starts from counts of 0 and adds what it launched. The checks between
    segments (a kernel against its plain version, the plain routes) are
    outside every segment, so they count nothing."""

    def __init__(self):
        self.total: dict[str, int] = {}

    @contextlib.contextmanager
    def segment(self):
        import torch
        from fedrec_tpu_torch.ops import launch_counts, reset_launch_counts

        reset_launch_counts()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            for name, n in launch_counts().items():
                self.total[name] = self.total.get(name, 0) + n


# ------------------------------------------------------------- safety_path
def _safety_cfg(args, *overrides: str):
    """The safety path's configuration: ExperimentConfig's widths, joint
    mode on the fused kernel route, param_avg, no evaluation, no snapshots."""
    from fedrec_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().apply_overrides([
        "model.fuse_hot_path=true", "model.use_pallas=true", "model.text_encoder_mode=head",
        f"data.batch_size={args.batch_size}", f"fed.num_clients={args.clients}",
        "fed.strategy=param_avg", f"train.seed={args.seed}", "train.snapshot_dir=",
        "train.eval_every=1000", *overrides,
    ])


def _safety_clients(cfg, seed: int, dev):
    """A fresh model and its K clients (one seeded init, replicated)."""
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.train import init_client_state, replicate_state

    model = init_params(NewsRecommender(cfg.model), seed=seed).to(dev)
    return model, replicate_state(init_client_state(model, cfg, seed), cfg.fed.num_clients, seed)


def _timed_steps(step, states, batches, table, launches=None) -> tuple[list, list, dict]:
    """The batches through ``step``, each timed (wall ms, synchronised on
    both ends); the metrics kept on the device; with ``launches`` (a list),
    each step's kernel launches from counts of 0."""
    import torch
    from fedrec_tpu_torch.ops import launch_counts, reset_launch_counts

    ms, metrics = [], []
    for b in batches:
        if launches is not None:
            reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, m = step(states, b, table)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
        if launches is not None:
            launches.append({k: v for k, v in launch_counts().items() if v})
    return states, ms, metrics


def _read_health(metrics: list) -> tuple[dict, float]:
    """The steps' health vectors as (steps, clients) arrays, from one
    device-to-host copy, and that read's wall ms."""
    import torch

    keys = sorted(k for k in metrics[0] if k.startswith("health."))
    t0 = time.perf_counter()
    flat = torch.stack([torch.stack([m[k].float() for m in metrics]) for k in keys]).cpu().numpy()
    read_ms = (time.perf_counter() - t0) * 1e3
    return {k: flat[i] for i, k in enumerate(keys)}, read_ms


def _client_params(states) -> list:
    return [p.detach().clone() for st in states for p in st.model.parameters()]


def phase_safety_path(state: dict, args) -> dict:
    """The training-safety slice at full width: the health sentry (fused
    joint and decoupled steps, on and off), a chaos NaN aborted and then
    quarantined, rolled back and replayed, per-example DP-SGD (dense and
    kernel routes, dp_scope all and user, the run CLI's DP leg) and robust
    aggregation (sync times at K = 4 and 16, a x1000 poison)."""
    import contextlib

    import torch
    from fedrec_tpu_torch.data import TrainBatcher, index_samples
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.fed.robust import robust_aggregate
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, TrainingHealthError, set_registry
    from fedrec_tpu_torch.obs import set_tracer
    from fedrec_tpu_torch.train import Trainer, build_fed_train_step, build_param_sync
    from fedrec_tpu_torch.train import encode_all_news
    from fedrec_tpu_torch.train.step import _group_norms, per_example_dp_grads

    K, B, S = args.clients, args.batch_size, args.trainer_steps
    dev = torch.device(DEV)
    cfg0 = _safety_cfg(args)
    mc, dc = cfg0.model, cfg0.data
    T, H = dc.max_title_len, dc.max_his_len
    tokens = _tokens(state, args, T, mc.bert_hidden)
    data = _mind_data(state, args, T)
    batcher = TrainBatcher(index_samples(data.train_samples, data.nid2index, H), B, dc.npratio,
                           seed=args.seed)
    batches = [{"candidates": b.candidates, "history": b.history, "labels": b.labels}
               for b in batcher.epoch_batches_sharded(K, 0)][:S]
    check(len(batches) == S, f"{len(batches)} batches for {S} steps")
    quiet = contextlib.redirect_stdout(sys.stderr)
    paths = _PathLaunches()
    out: dict = {"config": {"num_news": args.num_news, "clients": K, "steps": S, "batch_size": B,
                            "title_len": T, "history": H, "candidates": 1 + dc.npratio,
                            "bert_hidden": mc.bert_hidden, "news_dim": mc.news_dim,
                            "num_heads": mc.num_heads, "head_dim": mc.head_dim,
                            "query_dim": mc.query_dim, "dtype": mc.dtype}}

    # ---- (a) the sentry: the fused joint step and the decoupled step, off
    # then on, from the same init; trajectories bitwise, norms finite
    sentry: dict = {}
    for mode in ("joint", "decoupled"):
        runs = {}
        for on in (False, True):
            cfg = _safety_cfg(args, f"obs.health.sentry={int(on)}", "model.text_encoder_mode="
                              + ("head" if mode == "joint" else "table"))
            model, states = _safety_clients(cfg, args.seed, dev)
            table = tokens if mode == "joint" else encode_all_news(model, tokens, device=dev)
            step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device=dev)
            with paths.segment():
                states, ms, metrics = _timed_steps(step, states, batches, table)
            health, read_ms = _read_health(metrics) if on else ({}, None)
            runs[on] = {"ms": ms, "params": _client_params(states), "health": health,
                        "read_ms": read_ms, "losses": [m["loss"].tolist() for m in metrics]}
            del model, states, table, step, metrics
        off, on = runs[False], runs[True]
        bitwise = (all(torch.equal(a, b) for a, b in zip(off["params"], on["params"]))
                   and off["losses"] == on["losses"])
        check(bitwise, f"sentry {mode}: the trajectory moved with the sentry on")
        h = on["health"]
        check(all(np.isfinite(v).all() for k, v in h.items() if k != "health.nonfinite")
              and int(h["health.nonfinite"].sum()) == 0, f"sentry {mode}: {h}")
        sentry[mode] = {
            "step_ms_off": off["ms"], "step_ms_on": on["ms"],
            "median_step_ms_off": float(np.median(off["ms"][1:])),
            "median_step_ms_on": float(np.median(on["ms"][1:])),
            "health_read_ms": on["read_ms"], "bitwise_on_off": bitwise,
            "norm_ranges": {k.split(".")[1]: [float(v.min()), float(v.max())]
                            for k, v in h.items() if k != "health.nonfinite"},
        }
        del runs
    # the sentry's own time a 4-client step (CUDA events over back-to-back
    # calls): the step's one batched pass, three norms a client over
    # parameter-sized lists (the grads, the updates, the params)
    cfg = _safety_cfg(args)
    model, states = _safety_clients(cfg, args.seed, dev)
    trees = [st.user_params() + st.news_params() for st in states]
    sentry["device_ms_per_step"] = time_ms(lambda: _group_norms(trees * 3), reps=20)
    # the same twelve norms as twelve calls (the first design)
    sentry["twelve_calls_ms_per_step"] = time_ms(
        lambda: [_group_norms([t]) for t in trees for _ in range(3)], reps=20)
    sentry["params_per_client"] = sum(p.numel() for p in trees[0])
    out["sentry"] = sentry
    del model, states, trees

    # ---- (b) a chaos NaN update on client 2 in round 1
    def chaos_run(recover: bool, rounds: int = 3):
        set_registry(MetricsRegistry())
        set_tracer(Tracer())
        cfg = _safety_cfg(args, "chaos.enabled=true", "chaos.faults=nan@1:2",
                          f"fed.robust.recover={str(recover).lower()}", f"fed.rounds={rounds}")
        with quiet:
            trainer = Trainer(cfg, data, tokens, device=dev)
        times = {"capture": [], "rollback": [], "round": []}
        _time_calls(trainer, "_capture_recovery_state", times["capture"])
        _time_calls(trainer, "_rollback_and_quarantine", times["rollback"])
        _time_calls(trainer, "train_round", times["round"])
        return trainer, times

    trainer, _ = chaos_run(False)
    try:
        with paths.segment(), quiet:
            trainer.run()
        raise SmokeFailure("recover=false: no TrainingHealthError")
    except TrainingHealthError as e:
        abort_msg = str(e)
    check("[nonfinite] at round 1 step" in abort_msg and "client 2" in abort_msg
          and "Set obs.dir" in abort_msg, f"recover=false: {abort_msg}")
    recovered = []
    for _ in range(2):
        trainer, times = chaos_run(True)
        t0 = time.perf_counter()
        with paths.segment(), quiet:
            history = trainer.run()
        wall = (time.perf_counter() - t0) * 1e3
        rb = [e["args"] for e in trainer.tracer._events if e["name"] == "rollback"]
        recovered.append({"losses": [r.train_loss for r in history], "params":
                          _client_params(trainer.states), "times": times, "wall_ms": wall,
                          "rollbacks": rb,
                          "quarantines": trainer.registry.get("fed.quarantines_total").value()})
        del trainer
    r1, r2 = recovered
    check(all(math.isfinite(v) for v in r1["losses"]) and len(r1["losses"]) == 3,
          f"recovered run losses {r1['losses']}")
    check(len(r1["rollbacks"]) == 1 and r1["rollbacks"][0]["client"] == 2
          and r1["rollbacks"][0]["round"] == 1, f"rollbacks {r1['rollbacks']}")
    chaos_bitwise = r1["losses"] == r2["losses"] and all(
        torch.equal(a, b) for a, b in zip(r1["params"], r2["params"]))
    check(chaos_bitwise, "the recovered run did not repeat to the bit")
    out["chaos"] = {
        "abort_message": abort_msg[:300], "losses": r1["losses"], "rollbacks": r1["rollbacks"],
        "quarantines": r1["quarantines"], "bitwise_repeat": chaos_bitwise,
        "capture_ms_per_round": r1["times"]["capture"], "rollback_ms": r1["times"]["rollback"],
        "round_ms": r1["times"]["round"], "replay_ms": r1["times"]["round"][1],
        "run_wall_ms": [r1["wall_ms"], r2["wall_ms"]],
    }
    del recovered, r1, r2

    # ---- (c) per-example DP-SGD, dense and kernel routes, dp_scope all
    # and user; the dense non-DP joint step beside them
    dp: dict = {}
    routes = {"kernel": ("model.fuse_hot_path=false", "model.use_pallas=true"),
              "dense": ("model.fuse_hot_path=false", "model.use_pallas=false",
                        "model.attn_impl=dense")}
    for name, over in (("dense_joint_no_dp", routes["dense"]),
                       *((f"{r}_{scope}", (*routes[r], "privacy.enabled=true",
                                            "privacy.sigma=1.0", f"privacy.dp_scope={scope}"))
                         for r in ("dense", "kernel") for scope in ("all", "user"))):
        cfg = _safety_cfg(args, *over)
        model, states = _safety_clients(cfg, args.seed, dev)
        step = build_fed_train_step(model, cfg, get_strategy("param_avg"), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step = []
        with paths.segment():
            states, ms, metrics = _timed_steps(step, states, batches, tokens, per_step)
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = [m["loss"].tolist() for m in metrics]
        check(all(math.isfinite(v) for row in losses for v in row), f"dp {name}: {losses}")
        row = {"step_ms": ms, "median_step_ms": float(np.median(ms[1:])), "peak_mem_gb": peak,
               "losses": losses, "launches_per_step": per_step}
        if "privacy.enabled=true" in over:
            health, _ = _read_health(metrics)
            row["clip_rate_range"] = [float(health["health.clip_rate"].min()),
                                      float(health["health.clip_rate"].max())]
            row["clip_max_norm_range"] = [float(health["health.clip_max_norm"].min()),
                                          float(health["health.clip_max_norm"].max())]
        if name.startswith("kernel"):
            # a constant launch count a step, whatever B: B/4 against B
            small = [{k: v[:, : B // 4] for k, v in b.items()} for b in batches[:1]]
            counts_small = []
            _timed_steps(step, states, small, tokens, counts_small)
            want = {"additive_pool": 2 * K, "flash_forward": K, "flash_backward_dq": K,
                    "flash_backward_dkv": K}
            for counts in (*per_step, *counts_small):
                got = {k: counts.get(k, 0) for k in want}
                check(got == want, f"dp {name}: launches a step {counts}, want {want}")
            row["launches_per_step_at_quarter_batch"] = counts_small
        dp[name] = row
        del model, states, step, metrics
        torch.cuda.empty_cache()
    # the per-example clipped mean gradients of client 0's first batch:
    # the kernel route against the plain route, the same weights
    cfg_k = _safety_cfg(args, *routes["kernel"])
    cfg_d = _safety_cfg(args, *routes["dense"])
    mk = _safety_clients(cfg_k, args.seed + 1, dev)[0]
    md = NewsRecommender(cfg_d.model).to(dev)
    md.load_state_dict(mk.state_dict())
    b0 = [torch.as_tensor(batches[0][k][0], device=dev) for k in ("candidates", "history",
                                                                   "labels")]
    errs = {}
    for scope in ("all", "user"):
        # the same dropout masks: generators seeded alike
        gk, gd = (per_example_dp_grads(m, tokens, *b0, cfg_k.privacy.clip_norm,
                                       torch.Generator(device=dev).manual_seed(args.seed),
                                       user_only=scope == "user") for m in (mk, md))
        names = [n for n, _ in mk.user_encoder.named_parameters()] + (
            [f"text_head.{n}" for n, _ in mk.text_head.named_parameters()] if scope == "all"
            else [])
        res = {n: within_grad(a, b, torch.float32)
               for n, a, b in zip(names, gk[1] + (gk[2] or []), gd[1] + (gd[2] or []))}
        bad = {n: r for n, r in res.items() if not r[0]}
        check(not bad and abs(float(gk[0]) - float(gd[0])) <= TRAJ_LOSS_ATOL + TRAJ_LOSS_RTOL
              * abs(float(gd[0])), f"dp grads kernel vs plain ({scope}): {bad}")
        errs[scope] = {"loss": [float(gk[0]), float(gd[0])],
                       "max_abs_err": max(r[1] for r in res.values()),
                       "clip_rate": [float(gk[3]["clip_rate"]), float(gd[3]["clip_rate"])]}
    dp["kernel_vs_plain_grads"] = errs
    del mk, md
    # the run CLI's DP-SGD leg (joint, --dp-epsilon), on the kernel route
    with paths.segment():
        leg = _cli_leg(["1", str(B), "1", "--synthetic", "--clients", str(K), "--mode", "joint",
                        "--dp-epsilon", "10", "--set", "model.use_pallas=true",
                        "--set", "train.snapshot_dir="])
    n = leg["launches"]
    check(all(n[k] > 0 for k in ("additive_pool", "flash_forward", "flash_backward_dq",
                                 "flash_backward_dkv")), f"cli dp leg: {n}")
    dp["cli"] = leg
    out["dpsgd"] = dp

    # ---- (d) robust aggregation: the round-end sync by method, K = 4 and
    # 16, then a x1000 scale poison on client 1 every round
    def sync_ms(k: int) -> dict:
        cfg = _safety_cfg(args, f"fed.num_clients={k}")
        _, states = _safety_clients(cfg, args.seed, dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        with torch.no_grad():
            for st in states:
                for p in st.model.parameters():
                    p.add_(torch.randn(p.shape, generator=gen, device=dev) * 0.01)
        w = np.ones(k, np.float32)
        res = {}
        for method in ("mean", "clip", "trimmed_mean", "median"):
            sync = build_param_sync(_safety_cfg(args, f"fed.robust.method={method}"))
            res[method] = time_ms(lambda: sync(states, w), reps=5)
        params = [st.user_params() + st.news_params() for st in states]
        first = robust_aggregate(params, w, "median")
        again = robust_aggregate(params, w, "median")
        check(all(torch.equal(a, b) for a, b in zip(first[0], again[0])),
              f"median at K={k} did not repeat to the bit")
        return res

    robust: dict = {"sync_ms_k4": sync_ms(K), f"sync_ms_k{args.robust_clients}":
                    sync_ms(args.robust_clients)}
    poison = {}
    for name, over in (("clean_mean", ()),
                       *((f"poison_{m}", ("chaos.enabled=true", "chaos.faults=scale@*:1x1000",
                                          "obs.health.abort_on_nonfinite=false",
                                          f"fed.robust.method={m}"))
                         for m in ("mean", "trimmed_mean", "median"))):
        set_registry(MetricsRegistry())
        cfg = _safety_cfg(args, "fed.rounds=3", *over)
        with quiet:
            trainer = Trainer(cfg, data, tokens, device=dev)
        with paths.segment(), quiet:
            history = trainer.run()
        poison[name] = {"losses": [r.train_loss for r in history],
                        "params": _client_params(trainer.states[:1])}
        del trainer
    clean = poison["clean_mean"]
    ref = torch.cat([p.flatten() for p in clean["params"]])
    for name, row in poison.items():
        got = torch.cat([p.flatten() for p in row.pop("params")])
        row["param_dist_from_clean"] = float((got - ref).norm() / ref.norm())
        last, base = row["losses"][-1], clean["losses"][-1]
        row["last_loss_rel_to_clean"] = (last - base) / base if math.isfinite(last) else None
    for m in ("trimmed_mean", "median"):
        row = poison[f"poison_{m}"]
        check(all(math.isfinite(v) for v in row["losses"])
              and abs(row["last_loss_rel_to_clean"]) <= 0.10,
              f"{m} under a x1000 poison: {row}")
    # the aggregate itself: the mean follows the poisoned client, the
    # coordinate-wise methods leave it out (the loss, bounded by the
    # sigmoid-then-CE to [0.91, 2.49], is reported, not held)
    mean = poison["poison_mean"]
    mean["left_the_10pct_band"] = (mean["last_loss_rel_to_clean"] is None
                                   or abs(mean["last_loss_rel_to_clean"]) > 0.10)
    robust_dist = max(poison[f"poison_{m}"]["param_dist_from_clean"]
                      for m in ("trimmed_mean", "median"))
    check(mean["param_dist_from_clean"] >= 10 * robust_dist,
          f"the poisoned mean stayed as close to the clean run as the robust methods: {poison}")
    robust["poison"] = poison
    out["robust"] = robust

    state.setdefault("launches", {})["safety_path"] = paths.total
    for name in ("additive_pool", "flash_forward", "flash_backward_dq", "flash_backward_dkv",
                 "fused_history_score", "fused_history_score_bwd", "fused_gather_encode",
                 "fused_gather_encode_bwd"):
        check(paths.total.get(name, 0) > 0, f"kernel {name} never launched on the safety path")
    out["launches"] = paths.total
    return out


# cohort_path: rounds of the main run; the resume point, which is also the
# length of the dense-route and prefetch-off legs
COHORT_ROUNDS = 10
COHORT_CHECK_ROUNDS = 4


def _cohort_cfg(args, *overrides: str):
    """The cohort path's configuration: ExperimentConfig's widths, joint mode
    on the kernel route, K slots at B, a sampled population of
    ``--cohort-population`` logical clients (skew sampler, over-selection
    1.25), population dropout and stragglers against a deadline with a
    quorum of 2, persisted sidecars with ``--cohort-resident`` resident,
    FedAvgM, prefetch 2, and a full-pool evaluation after the last round
    only."""
    from fedrec_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().apply_overrides([
        "model.fuse_hot_path=true", "model.use_pallas=true", "model.text_encoder_mode=head",
        f"data.batch_size={args.batch_size}", f"fed.num_clients={args.clients}",
        "fed.strategy=param_avg", f"fed.rounds={COHORT_ROUNDS}", f"train.seed={args.seed}",
        f"train.eval_every={COHORT_ROUNDS}", "train.eval_protocol=full", "train.snapshot_dir=",
        "train.save_every=1000",
        f"fed.population.num_clients={args.cohort_population}", "fed.population.sampler=skew",
        "fed.population.over_select=1.25", "fed.population.round_deadline_ms=80",
        "fed.population.min_reports=2", "fed.population.client_state=persist",
        f"fed.population.resident_cap={args.cohort_resident}",
        "chaos.enabled=true", "chaos.pop_drop_rate=0.2", "chaos.pop_straggle_ms=40",
        "fed.server_opt=sgd", "fed.server_momentum=0.9", "data.prefetch_batches=2",
        *overrides,
    ])


class _Clock:
    """Wall times (ms, synchronised on both ends) of wrapped calls, by name."""

    def __init__(self):
        self.ms: dict[str, list] = {}

    def wrap(self, obj, name: str, key: str | None = None, on_call=None) -> None:
        import torch

        fn = getattr(obj, name)
        sink = self.ms.setdefault(key or name, [])

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0) * 1e3)
            if on_call is not None:
                on_call(a, out)
            return out

        setattr(obj, name, timed)


def _median(values) -> float | None:
    return float(np.median(values)) if len(values) else None


def _rss_mb() -> dict:
    """The process's resident set now and at its peak, MiB (host)."""
    import resource

    now = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1]) / 1024
    return {"now_mb": now, "peak_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024}


def _store_equal(a, b) -> bool:
    """Two populations hold the same sidecars, bitwise."""
    if a.stored_ids() != b.stored_ids():
        return False
    for cid in a.stored_ids():
        sa, sb = a.get_sidecar(cid), b.get_sidecar(cid)
        for key in sa:
            xs = sa[key] if isinstance(sa[key], list) else [sa[key]]
            ys = sb[key] if isinstance(sb[key], list) else [sb[key]]
            if len(xs) != len(ys) or not all(np.array_equal(x, y) for x, y in zip(xs, ys)):
                return False
    return True


def _engine_state(trainer) -> dict:
    """What a bitwise repeat must reproduce besides the parameters."""
    led = trainer.population.ledger.state_dict()
    smp = trainer.cohort_sampler.state_dict()
    return {"history": trainer.cohort_history,
            "ledger": {k: np.asarray(v).tolist() for k, v in led.items()},
            "sampler": {k: (v if isinstance(v, str) else np.asarray(v).tolist())
                        for k, v in smp.items()}}


def _server_state_equal(a, b) -> bool:
    sa, sb = a.server_opt._state, b.server_opt._state
    return sa["t"] == sb["t"] and all(
        np.array_equal(x, y) for name in ("buf", "m", "v") for x, y in
        zip(sa.get(name, ()), sb.get(name, ())))


def _server_opt_ms(trainer, reps: int = 5) -> dict:
    """The FedOpt step's parts on the trainer's parameters, by kind: the
    copy of client 0's parameters down, the numpy step, the broadcast into
    every slot (ms, medians)."""
    import torch
    from fedrec_tpu_torch.fed import ServerOptimizer

    out = {}
    base = trainer._params_host(0)
    for label, kind, momentum in (("sgd", "sgd", 0.0), ("fedavgm", "sgd", 0.9),
                                  ("adam", "adam", 0.9)):
        opt = ServerOptimizer(kind, 1.0 if kind == "sgd" else 1e-3, momentum)
        parts: dict[str, list] = {"down": [], "step": [], "broadcast": []}
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean = trainer._params_host(0)
            t1 = time.perf_counter()
            new = opt.step(base, mean)
            t2 = time.perf_counter()
            trainer._adopt_global(new)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for key, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[key].append(v * 1e3)
        out[label] = {k: _median(v) for k, v in parts.items()}
    out["param_mb"] = sum(x.nbytes for x in base) / 2**20
    return out


def phase_cohort_path(state: dict, args) -> dict:
    """A sampled cross-device federated run through ``Trainer``: the cohort
    engine, FedAvgM and the prefetched data path (module docstring)."""
    import tempfile

    import torch
    from fedrec_tpu_torch.data import make_synthetic_mind
    from fedrec_tpu_torch.fed import CohortSampler
    from fedrec_tpu_torch.fed.population import ClientPopulation, QuorumFailure
    from fedrec_tpu_torch.models.attention import dense
    from fedrec_tpu_torch.obs import (
        MetricsRegistry,
        Tracer,
        TrainingHealthError,
        set_registry,
        set_tracer,
    )
    from fedrec_tpu_torch.ops import (
        additive_pool_plain,
        fused_history_score,
        fused_history_score_plain,
        launch_counts,
        reset_launch_counts,
    )
    from fedrec_tpu_torch.train import Trainer

    K, B, R, P = args.clients, args.batch_size, COHORT_ROUNDS, args.cohort_population
    dev = torch.device(DEV)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(prefix="cohort_path_", dir=build)
    root = Path(work.name)
    cfg = _cohort_cfg(args)
    mc, dc = cfg.model, cfg.data
    T = dc.max_title_len
    tokens = _tokens(state, args, T, mc.bert_hidden)
    steps = args.cohort_shard // B
    t0 = time.perf_counter()
    data = make_synthetic_mind(num_news=args.num_news, num_train=P * args.cohort_shard,
                               num_valid=args.valid, title_len=T, seed=args.seed)
    # the fixed world at the same K and steps: K x B x steps rows
    fixed_data = make_synthetic_mind(num_news=args.num_news, num_train=K * B * steps,
                                     num_valid=args.valid, title_len=T, seed=args.seed)
    data_s = time.perf_counter() - t0
    quiet = contextlib.redirect_stdout(sys.stderr)
    spill_n = [0]

    def trainer(overrides=(), name="run", d=None, snapshot=None):
        # a fresh registry and tracer a run: the counters are the run's own
        set_registry(MetricsRegistry())
        set_tracer(Tracer())
        c = _cohort_cfg(args, *overrides)
        spill_n[0] += 1
        if c.fed.population.num_clients and not c.fed.population.spill_dir:
            c.fed.population.spill_dir = str(root / f"spill_{name}_{spill_n[0]}")
        with quiet:
            return Trainer(c, d or data, tokens, snapshot_dir=snapshot, device=dev)

    # ---------------- the cohort path, with every launch count from 0
    main = trainer(name="main")
    check(main.population.shard_size == args.cohort_shard
          and main.population.steps_per_epoch(B) == steps,
          f"shards of {args.cohort_shard} rows, {steps} steps a local epoch expected")
    clock = _Clock()
    for obj, name, key in ((main, "train_round", "round"), (main, "_install_cohort", "install"),
                           (main, "_read_sidecar", "writeback"),
                           (main.population, "put_sidecar", "store"),
                           (main.population, "get_sidecar", "load_get"),
                           (main, "_write_sidecar", "load_write")):
        clock.wrap(obj, name, key)
    # each step's and each evaluation's launches (the timing wrapper below
    # goes around these, so the counts bracket just the call)
    step_launches: list[dict] = []
    eval_launches: list[dict] = []
    overflow = [0]

    def counted(fn, sink, on_out=None):
        def call(*a, **kw):
            before = launch_counts()
            out = fn(*a, **kw)
            sink.append({k: v - before[k] for k, v in launch_counts().items()})
            if on_out is not None:
                on_out(out)
            return out
        return call

    def add_overflow(out):
        overflow[0] += int(out[1]["unique_overflow"])

    main.train_step = counted(main.train_step, step_launches, add_overflow)
    main._eval_if_due = counted(main._eval_if_due, eval_launches)
    clock.wrap(main, "train_step", "step_prefetch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with quiet:
        history = main.run()
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    # ---------------- end of the cohort path
    run_parts = {k: list(v) for k, v in clock.ms.items()}  # the later checks call them too
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rss = _rss_mb()
    state.setdefault("launches", {})["cohort_path"] = launches
    reg = main.registry
    losses = [h.train_loss for h in history]
    metrics = history[-1].val_metrics
    check([h.round_idx for h in history] == list(range(R)), f"rounds {[h.round_idx for h in history]}")
    check(all(math.isfinite(v) for v in losses), f"non-finite round loss: {losses}")
    check(set(metrics) == {"auc", "mrr", "ndcg5", "ndcg10"}
          and all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()),
          f"final evaluation {metrics}")
    check(overflow[0] == 0, f"unique_overflow on {overflow[0]} client steps")
    check(len(step_launches) == R * steps, f"{len(step_launches)} steps, {R * steps} expected")
    for i, d in enumerate(step_launches):
        for name in ("fused_gather_encode", "fused_gather_encode_bwd", "fused_history_score",
                     "fused_history_score_bwd"):
            check(d[name] >= K, f"step {i}: kernel {name} launched {d[name]} times, K={K}")
    check(len(eval_launches) == R, f"{len(eval_launches)} evaluation checks")
    ev = eval_launches[-1]
    check(ev["additive_pool"] > 0 and ev["fused_history_score"] >= -(-args.valid // 256),
          f"the evaluation launched A {ev['additive_pool']} and B {ev['fused_history_score']}")
    check(reg.counter("fed.cohort_slot_swaps_total").value() > 0, "no cohort swap")
    check(main.population.spill_count > 0, "no sidecar spilled at resident_cap "
          f"{args.cohort_resident}")
    coverage = reg.gauge("fed.population_coverage").value()
    counters = {name: reg.counter(name).value() for name in (
        "fed.cohort_slot_swaps_total", "fed.pop_dropouts_total", "fed.deadline_cuts_total",
        "fed.quorum_replays_total", "data.prefetch.items_total",
        "data.prefetch.producer_stall_total", "data.prefetch.consumer_stall_total")}

    # ---- the path's kernels against their plain versions on its inputs
    m0 = main.states[0].model
    with torch.no_grad():
        table = main._encode_corpus(0)
        th = m0.text_head
        pooled = additive_pool_plain(tokens[: args.chunk], th.pool.att_fc1.weight.t().contiguous(),
                                     th.pool.att_fc1.bias, th.pool.att_fc2.weight[0].contiguous())
        err_a = max_err(table[: args.chunk], dense(th.fc, pooled, torch.float32))
        his = table[torch.as_tensor(main.valid_ix.history[:256], device=dev).long()]
        w = m0.user_encoder.fused_weights(his.dtype)
        err_b = max_err(fused_history_score(his, None, None, w, mc.num_heads)[1],
                        fused_history_score_plain(his, None, None, w, mc.num_heads)[1])
    check(err_a <= F32_ATOL and err_b <= F32_ATOL,
          f"cohort path kernels vs plain: A {err_a}, B {err_b} (atol {F32_ATOL})")
    del table

    # ---- a bitwise repeat
    again = trainer(name="repeat")
    with quiet:
        again.run()
    check(_engine_state(again) == _engine_state(main), "the repeat's cohorts, ledger or sampler differ")
    check(all(torch.equal(a, b) for a, b in zip(_trainer_params(main), _trainer_params(again))),
          "the repeat's parameters differ")
    check(_server_state_equal(main, again), "the repeat's FedOpt buffers differ")
    del again

    # ---- 4 rounds, then a resume to R: the straight run bitwise
    snaps = str(root / "snapshots")
    first = trainer([f"fed.rounds={COHORT_CHECK_ROUNDS}"], name="first", snapshot=snaps)
    clock.wrap(first, "train_step", "step_prefetch_4")
    with quiet:
        first_hist = first.run()
    resumed = trainer(name="resumed", snapshot=snaps)
    check(resumed.start_round == COHORT_CHECK_ROUNDS, f"resumed at {resumed.start_round}")
    with quiet:
        resumed.run()
    resume_ok = {
        "params": all(torch.equal(a, b) for a, b in zip(_trainer_params(main),
                                                        _trainer_params(resumed))),
        "server_opt": _server_state_equal(main, resumed),
        "engine": _engine_state(resumed)["ledger"] == _engine_state(main)["ledger"]
        and _engine_state(resumed)["sampler"] == _engine_state(main)["sampler"]
        and first.cohort_history + resumed.cohort_history == main.cohort_history,
        "sidecars": _store_equal(main.population, resumed.population),
        "stored": len(main.population.stored_ids()),
        "spilled_in_first": first.population.spill_count,
    }
    check(all(v for k, v in resume_ok.items() if k not in ("stored", "spilled_in_first")),
          f"4 rounds + resume vs the straight run: {resume_ok}")
    del resumed

    # ---- prefetch off: the same 4 rounds bitwise; the step medians
    off = trainer([f"fed.rounds={COHORT_CHECK_ROUNDS}", "data.prefetch_batches=0"], name="off")
    clock.wrap(off, "train_step", "step_no_prefetch")
    with quiet:
        off_hist = off.run()
    check([h.train_loss for h in off_hist] == [h.train_loss for h in first_hist]
          and all(torch.equal(a, b) for a, b in zip(_trainer_params(first), _trainer_params(off))),
          "prefetch on and off differ")
    del off

    # ---- the kernel route against the dense route over 4 rounds
    reset_launch_counts()
    dense_t = trainer([f"fed.rounds={COHORT_CHECK_ROUNDS}", "model.fuse_hot_path=false",
                       "model.use_pallas=false"], name="dense")
    with quiet:
        dense_hist = dense_t.run()
    check(not any(launch_counts().values()), "the dense route launched a kernel")
    check(dense_t.cohort_history == first.cohort_history, "the dense route drew other cohorts")
    traj = [(a.train_loss, b.train_loss) for a, b in zip(first_hist, dense_hist)]
    for r, (lk, ld) in enumerate(traj):
        check(math.isclose(lk, ld, rel_tol=TRAJ_LOSS_RTOL, abs_tol=TRAJ_LOSS_ATOL),
              f"round {r}: kernel-route loss {lk!r} vs dense {ld!r}")
    param_worst, param_worst_noise = 0.0, 0.0
    for c, (sk, sd) in enumerate(zip(first.states, dense_t.states)):
        bad, worst, worst_noise = _param_diffs(sk.model, sd.model)
        check(not bad, f"slot {c}: kernel vs dense route after {COHORT_CHECK_ROUNDS} rounds: {bad}")
        param_worst, param_worst_noise = max(param_worst, worst), max(param_worst_noise,
                                                                      worst_noise)
    del dense_t, first

    # ---- the degenerate world (population == slots) against no population,
    # and the fixed world's round time at the same K and steps
    fixed_over = ["fed.rounds=3", "chaos.enabled=false", "fed.population.min_reports=0"]
    fixed = trainer([*fixed_over, "fed.population.num_clients=0"], name="fixed", d=fixed_data)
    clock.wrap(fixed, "train_round", "round_fixed")
    degenerate = trainer([*fixed_over, f"fed.population.num_clients={K}"], name="degenerate",
                         d=fixed_data)
    with quiet:
        fixed_hist, degen_hist = fixed.run(), degenerate.run()
    check(fixed.batcher.num_batches(len(fixed.train_ix) // K) == steps,
          f"the fixed world runs {steps} steps a round")
    check([h.train_loss for h in fixed_hist] == [h.train_loss for h in degen_hist]
          and all(torch.equal(a, b) for a, b in zip(_trainer_params(fixed),
                                                    _trainer_params(degenerate)))
          and degenerate.cohort_history == [(r, tuple(range(K))) for r in range(3)],
          "the degenerate population differs from no population")
    server_ms = _server_opt_ms(fixed)
    del degenerate, fixed

    # ---- the quorum policy: min_reports 4 at pop_drop_rate 0.5
    quorum = trainer(["fed.rounds=3", "fed.population.min_reports=4", "chaos.pop_drop_rate=0.5"],
                     name="quorum")
    attempts: list = []
    round_fn = quorum.train_round

    def timed_round(r):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = round_fn(r)
        except QuorumFailure:
            attempts.append(("replayed", (time.perf_counter() - t0) * 1e3))
            raise
        torch.cuda.synchronize()
        attempts.append(("trained", (time.perf_counter() - t0) * 1e3))
        return out

    quorum.train_round = timed_round
    quorum_end = "finished"
    try:
        with quiet:
            quorum.run()
    except RuntimeError as e:
        check("failed quorum" in str(e) and "sizing a cohort" in str(e), f"quorum abort: {e}")
        quorum_end = "aborted"
    replays = quorum.registry.counter("fed.quorum_replays_total").value()
    check(replays > 0, "no quorum replay at min_reports 4, pop_drop_rate 0.5")
    replay_ms = [ms for kind, ms in attempts if kind == "replayed"]
    del quorum

    # ---- recovery: a NaN in slot 1 at round 2 quarantines the slot's
    # logical client and resets its sidecar; the fault is keyed on the slot,
    # as in the JAX package, so each replay's new occupant meets it too,
    # until the retries are spent and the run aborts
    rec = trainer(["fed.rounds=4", "fed.robust.recover=true", "chaos.faults=nan@2:1",
                   "fed.population.min_reports=0"], name="recover")
    drawn: list = []
    install = rec._install_cohort
    rec._install_cohort = lambda plan: (drawn.append(plan.slot_clients.copy()), install(plan))[1]
    rec_end = "finished"
    try:
        with quiet:
            rec.run()
    except TrainingHealthError:
        rec_end = "aborted"
    victims = [e["args"]["client"] for e in rec.tracer._events if e["name"] == "rollback"]
    retries = rec.cfg.fed.robust.max_retries
    check(len(victims) == retries and [int(d[1]) for d in drawn[2:2 + retries]] == victims,
          f"quarantined {victims}, slot 1 of the round-2 draws {[int(d[1]) for d in drawn[2:]]}")
    check(all(v not in d for i, v in enumerate(victims) for d in drawn[3 + i:]),
          "a quarantined client was drawn again before its expiry")
    check(all(rec.population.get_sidecar(v) is None for v in victims)
          and set(rec.population.ledger.quarantined) == set(victims),
          "a quarantined client kept its sidecar or left the ledger's quarantine")
    check(rec_end == "aborted", "the slot-keyed fault was not met again on a replay")
    del rec

    # ---- FedAdam, 3 rounds
    adam = trainer(["fed.rounds=3", "fed.server_opt=adam", "fed.server_lr=0.001"], name="adam")
    with quiet:
        adam_hist = adam.run()
    check(all(math.isfinite(h.train_loss) for h in adam_hist) and adam.server_opt._state["t"] == 3,
          f"FedAdam: {[h.train_loss for h in adam_hist]}")
    del adam

    # ---- decoupled mode: population 16 over K slots, 2 rounds
    dec_data = make_synthetic_mind(num_news=args.num_news, num_train=16 * args.cohort_shard,
                                   num_valid=args.valid, title_len=T, seed=args.seed)
    dec = trainer(["model.text_encoder_mode=table", "fed.rounds=2", "fed.population.num_clients=16",
                   "train.eval_every=1000"], name="decoupled", d=dec_data)
    dclock = _Clock()
    markers: list = []
    dclock.wrap(dec, "_install_cohort", "install")
    dclock.wrap(dec, "_read_sidecar", "writeback",
                on_call=lambda a, out: markers.append(out["news_grad_accum"].size))
    dclock.wrap(dec, "_write_sidecar", "load_write")
    with quiet:
        dec_hist = dec.run()
    check(all(math.isfinite(h.train_loss) for h in dec_hist), f"decoupled: {dec_hist}")
    check(markers and not any(markers), f"a round-boundary accumulator was not zero: {markers}")
    check(all(st.news_grad_accum is None or not bool(st.news_grad_accum.any())
              for st in dec.states), "a slot's accumulator is not zero after its install")
    dec_accum_mb = args.num_news * mc.news_dim * 4 / 2**20
    del dec

    # ---- the sidecar store: spill and reload of one client's sidecar
    sidecar = main._read_sidecar(0)
    store = ClientPopulation(4, 64, resident_cap=1, spill_dir=root / "spill_probe")
    spill_ms, reload_ms = [], []
    for i in range(4):
        store.put_sidecar(0, sidecar)
        t0 = time.perf_counter()
        store.put_sidecar(1, sidecar)  # spills client 0
        spill_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        store.get_sidecar(0)
        reload_ms.append((time.perf_counter() - t0) * 1e3)
    spill_mb = store._spill_path(0).stat().st_size / 2**20

    # ---- the sampler's draw at a real cross-device population (host only)
    draw_ms = {}
    for n in (P, 1 << 20):
        s = CohortSampler(n, "skew", seed=args.seed)
        s.record(s.draw(0, math.ceil(K * 1.25)))
        times = []
        for r in range(5):
            t0 = time.perf_counter()
            s.draw(r + 1, math.ceil(K * 1.25), exclude={1, 2})
            times.append((time.perf_counter() - t0) * 1e3)
        draw_ms[str(n)] = _median(times)
    work.cleanup()

    ms = clock.ms
    installs = len(run_parts["install"])
    per_install = lambda key: sum(run_parts.get(key, [])) / max(installs, 1)  # noqa: E731
    return {
        "config": {"num_news": args.num_news, "slots": K, "batch_size": B, "rounds": R,
                   "population": P, "shard_rows": args.cohort_shard, "steps_per_epoch": steps,
                   "num_train": P * args.cohort_shard, "num_valid": args.valid,
                   "sampler": cfg.fed.population.sampler,
                   "over_select": cfg.fed.population.over_select,
                   "pop_drop_rate": cfg.chaos.pop_drop_rate,
                   "pop_straggle_ms": cfg.chaos.pop_straggle_ms,
                   "round_deadline_ms": cfg.fed.population.round_deadline_ms,
                   "min_reports": cfg.fed.population.min_reports,
                   "resident_cap": cfg.fed.population.resident_cap,
                   "server_opt": "fedavgm", "server_momentum": cfg.fed.server_momentum,
                   "prefetch_batches": dc.prefetch_batches, "title_len": T,
                   "history": dc.max_his_len, "bert_hidden": mc.bert_hidden,
                   "news_dim": mc.news_dim, "num_heads": mc.num_heads, "dtype": mc.dtype,
                   "fuse_hot_path": mc.fuse_hot_path, "use_pallas": mc.use_pallas},
        "data_s": data_s,
        "run_ms": run_ms,
        "round_ms": ms["round"],
        "round_ms_fixed_world": ms["round_fixed"],
        "round_ms_median_sampled_without_eval": _median(ms["round"][:-1]),
        "round_ms_median_fixed_world": _median(ms["round_fixed"]),
        "install_ms_per_round": {"total": per_install("install"),
                                 "writeback": per_install("writeback"),
                                 "store": per_install("store"),
                                 "load": per_install("load_get") + per_install("load_write")},
        "installs": installs,
        "install_ms": run_parts["install"],
        "sidecar_mb": spill_mb,
        "spill_ms": _median(spill_ms), "reload_ms": _median(reload_ms),
        "server_opt_ms": server_ms,
        "quorum": {"end": quorum_end, "replays": replays, "replay_ms": replay_ms,
                   "trained_round_ms": [m for k, m in attempts if k == "trained"]},
        "recovery": {"end": rec_end, "quarantined": victims},
        "sampler_draw_ms": draw_ms,
        "step_ms_median": {"prefetch_2": _median(ms["step_prefetch"]),
                           "prefetch_2_first_4_rounds": _median(ms["step_prefetch_4"]),
                           "prefetch_0_first_4_rounds": _median(ms["step_no_prefetch"])},
        "coverage": coverage,
        "counters": counters,
        "losses": losses,
        "val_metrics": metrics,
        "launches": launches,
        "max_abs_err_vs_plain": {"additive_pool": err_a, "fused_history_score": err_b},
        "kernel_vs_dense": {"losses": traj, "max_param_diff": param_worst,
                            "max_zero_grad_leaf_diff": param_worst_noise},
        "resume": resume_ok,
        "fedadam_losses": [h.train_loss for h in adam_hist],
        "decoupled": {"losses": [h.train_loss for h in dec_hist],
                      "install_ms": dclock.ms["install"],
                      "writeback_ms": dclock.ms.get("writeback", []),
                      "load_ms": dclock.ms.get("load_write", []),
                      "accum_marker_writebacks": len(markers),
                      "accum_full_mb_avoided_per_writeback": dec_accum_mb},
        "peak_mem_gb": peak_gb,
        "host_rss": rss,
    }


def _write_token_states(tokens, path: Path, chunk: int) -> float:
    """The token states as one ``.npy`` on disk (10.07 GB at full size),
    written chunk by chunk from the card; fails loudly when the disk cannot
    hold it. Returns the seconds it took."""
    import shutil

    need = tokens.numel() * tokens.element_size()
    free = shutil.disk_usage(path.parent).free
    check(free > need + (1 << 30), f"{path.parent} has {free / 1e9:.2f} GB free; the token "
                                   f"states need {need / 1e9:.2f} GB")
    t0 = time.perf_counter()
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32, shape=tuple(tokens.shape))
    for s in range(0, tokens.shape[0], chunk):
        out[s:s + chunk] = tokens[s:s + chunk].cpu().numpy()
    out.flush()
    del out
    return time.perf_counter() - t0


def _write_artifacts(data, directory: Path) -> None:
    """The reference UserData layout of ``data`` (``data/mind.py``'s loader)."""
    import pickle

    directory.mkdir()
    np.save(directory / "bert_news_index.npy", data.news_tokens)
    for name, obj in (("bert_nid2index.pkl", data.nid2index),
                      ("train_sam_uid.pkl", data.train_samples),
                      ("valid_sam_uid.pkl", data.valid_samples)):
        with open(directory / name, "wb") as f:
            pickle.dump(obj, f)


def _plain_scores(tower, table, hist, top_k: int):
    """``_plain_recommend`` for a bare user tower: plain versions only."""
    import torch
    from fedrec_tpu_torch.ops import fused_history_score_plain

    n = table.shape[0]
    his = table[hist.clamp(0, n - 1)]
    _, user = fused_history_score_plain(his, None, None, tower.fused_weights(his.dtype),
                                        tower.num_heads)
    scores = user.float() @ table.float().T
    invalid = torch.zeros_like(scores, dtype=torch.bool)
    invalid[:, 0] = True
    rows = torch.arange(hist.shape[0], device=hist.device)[:, None]
    invalid[rows, hist.clamp(0, n - 1)] = True
    scores = scores.masked_fill(invalid, torch.finfo(torch.float32).min)
    return torch.topk(scores, top_k + 1, dim=1)


def _plain_rerank(index, user_vec, hist, top_k: int):
    """The two-stage route again, one row at a time: the probe, the
    member gather, a product and sum per candidate, the history and padding
    masks from Python sets, the top k."""
    import torch

    neg = torch.finfo(torch.float32).min
    n = index.news_vecs.shape[0]
    ids_out, scores_out = [], []
    for b in range(user_vec.shape[0]):
        u = user_vec[b]
        probe = torch.topk(index.centroids @ u, index.n_probe).indices
        cand = index.members[probe].reshape(-1)
        scores = (index.news_vecs[cand.clamp(0, n - 1)].float() * u).sum(-1)
        clicked = set(hist[b].tolist())
        bad = torch.tensor([c < 0 or c in clicked for c in cand.tolist()], device=u.device)
        top = torch.topk(scores.masked_fill(bad, neg), top_k)
        ids = torch.where(top.values <= neg, -1, cand[top.indices])
        ids_out.append(ids)
        scores_out.append(top.values)
    return torch.stack(ids_out).to(torch.int32), torch.stack(scores_out)


def _bucket_ms(call, make_hist, buckets, reps: int) -> dict:
    """Median host milliseconds of ``call(hist)`` to results on the host,
    per bucket size."""
    out = {}
    for b in buckets:
        hist = make_hist(b)
        call(hist)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call(hist)
            times.append((time.perf_counter() - t0) * 1e3)
        out[b] = float(np.median(times))
    return out


def _timeline(pairs, t_start: float, t_end: float, step_s: float) -> list:
    """``[seconds from t_start, largest value]`` of the ``(time, value)``
    pairs in each ``step_s`` window of ``[t_start, t_end)``."""
    worst: dict[int, float] = {}
    for t, v in pairs:
        if t_start <= t < t_end:
            k = int((t - t_start) // step_s)
            worst[k] = max(worst.get(k, 0.0), v)
    return [[k * step_s, worst[k]] for k in sorted(worst)]


class _StallProbe:
    """Where serving waits while a refresh runs: the host time of each
    scorer call (the batcher makes it on the event loop) and the oversleep
    of a bare Python thread that sleeps 5 ms at a time. A stall the thread
    shares is the interpreter lock or the whole process standing still; one
    it does not share is the loop's thread blocked in native code."""

    def __init__(self, service):
        import threading

        self.calls: list[tuple[float, float]] = []
        self.ticks: list[tuple[float, float]] = []
        score = service.batcher._score

        def timed(hist):
            t0 = time.monotonic()
            out = score(hist)
            self.calls.append((t0, (time.monotonic() - t0) * 1e3))
            return out

        service.batcher._score = timed
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._tick, daemon=True)
        self._thread.start()

    def _tick(self):
        while not self._stop.is_set():
            t0 = time.monotonic()
            time.sleep(0.005)
            self.ticks.append((t0, (time.monotonic() - t0 - 0.005) * 1e3))

    def close(self):
        self._stop.set()
        self._thread.join(5)


def _percentiles(values) -> dict:
    v = np.asarray(values, np.float64)
    if not v.size:
        return {"n": 0, "p50": None, "p99": None}
    return {"n": int(v.size), "p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99))}


async def _serve_and_refresh(service, refresh: dict, waves, num_news: int, rng,
                             his_len: int) -> dict:
    """Waves of concurrent requests through a ``ServingClientPool``; a
    refresh sent on a connection of its own after two rounds of waves, waves
    going on until it answers, then a request on the refresh's connection
    and two more rounds of waves. Every request's send time (before the
    pool's checkout), receive time, history and response."""
    from fedrec_tpu_torch.serving import ServingClient, ServingClientPool, start_server

    server = await start_server(service, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    pool = ServingClientPool("127.0.0.1", port, size=max(waves), request_timeout_ms=60_000)
    admin = ServingClient("127.0.0.1", port, request_timeout_ms=60_000, seed=99)
    records = []

    def history():
        k = int(rng.integers(1, his_len + 1))
        return rng.integers(1, num_news, size=k).tolist()

    async def one(hist):
        t_send = time.monotonic()
        resp = await pool.handle({"id": len(records), "history": hist})
        records.append({"t_send": t_send, "t_recv": time.monotonic(), "hist": hist,
                        "resp": resp})

    async def wave(size):
        await asyncio.gather(*(one(history()) for _ in range(size)))

    try:
        for _ in range(2):
            for size in waves:
                await wave(size)
        t_refresh = time.monotonic()
        task = asyncio.ensure_future(admin.admin("refresh", deadline_ms=900_000, **refresh))
        during_waves = 0
        while not task.done():
            await wave(waves[during_waves % len(waves)])
            during_waves += 1
        reply = task.result()
        t_reply = time.monotonic()
        same_conn = await admin.request({"id": -1, "history": history()}, deadline_ms=60_000)
        for _ in range(2):
            for size in waves:
                await wave(size)
        metrics = (await admin.admin("metrics", deadline_ms=60_000))["metrics"]
    finally:
        await pool.close()
        await admin.close()
        server.close()
        await service.stop()
        await server.wait_closed()
    return {"records": records, "reply": reply, "t_refresh": t_refresh, "t_reply": t_reply,
            "same_conn": same_conn, "during_waves": during_waves, "metrics": metrics}


async def _client_behaviour(store, cfg) -> dict:
    """A server restart under a ``ServingClientPool`` (unavailable or
    retried successes, never an exception), then a black-hole server
    against the client's deadline; the black hole's handlers are cancelled
    and its writers closed before ``wait_closed``."""
    from fedrec_tpu_torch.serving import (
        ServingClient,
        ServingClientPool,
        ServingService,
        start_server,
    )

    def service():
        svc = ServingService(store, history_len=cfg.data.max_his_len, top_k=10, device=DEV)
        svc.warmup()
        return svc

    async def fire(pool, n):
        return [await pool.handle({"id": i, "history": [1 + i, 2, 3]}) for i in range(n)]

    svc = service()
    server = await start_server(svc, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    pool = ServingClientPool("127.0.0.1", port, size=4, request_timeout_ms=5000,
                             backoff_base_ms=20, backoff_max_ms=200)
    try:
        before = await fire(pool, 16)
        server.close()
        await svc.stop()
        await server.wait_closed()
        probe = ServingClient("127.0.0.1", port, request_timeout_ms=300, backoff_base_ms=10,
                              backoff_max_ms=50, seed=5)
        down = await probe.request({"history": [1]})
        await probe.close()
        svc = service()
        server = await start_server(svc, "127.0.0.1", port)
        after = await fire(pool, 16)
        retries = pool.retry_metrics()
    finally:
        await pool.close()
        server.close()
        await svc.stop()
        await server.wait_closed()

    handlers, writers = set(), []

    async def black_hole(reader, writer):
        handlers.add(asyncio.current_task())
        writers.append(writer)
        await asyncio.sleep(3600)

    hole = await asyncio.start_server(black_hole, "127.0.0.1", 0)
    client = ServingClient("127.0.0.1", hole.sockets[0].getsockname()[1],
                           request_timeout_ms=200, seed=6)
    t0 = time.monotonic()
    silent = await client.request({"history": [1]})
    silent_s = time.monotonic() - t0
    await client.close()
    hole.close()
    for t in handlers:
        t.cancel()
    for w in writers:
        w.close()
    await asyncio.gather(*handlers, return_exceptions=True)
    await asyncio.wait_for(hole.wait_closed(), 10)
    return {"before": before, "down": down, "after": after, "retries": retries,
            "black_hole": silent, "black_hole_s": silent_s}


def phase_serving_path(state: dict, args) -> dict:
    """Train, snapshot, serve the snapshot, refresh it under load; two-stage
    retrieval at the catalog's size and at the CLI's million-item mode; the
    recommend CLI; the client's failure modes."""
    import dataclasses
    import tempfile

    import torch
    from fedrec_tpu_torch.cli import recommend
    from fedrec_tpu_torch.cli import serve as serve_cli
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.serve import build_recommend_fn
    from fedrec_tpu_torch.serving import (
        EmbeddingStore,
        ServingService,
        build_index,
        build_two_stage_fn,
        load_checkpoint_params,
        publish_from_checkpoint,
        recall_at_k,
    )
    from fedrec_tpu_torch.train import Trainer, encode_all_news

    dev = torch.device(DEV)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(prefix="serving_path_", dir=build)
    root = Path(work.name)
    snaps = root / "snapshots"
    # decoupled mode (the config's default), snapshots every round, no eval
    cfg = _decoupled_cfg(args, str(snaps), "fed.rounds=1", "fed.local_epochs=1",
                         "train.eval_every=1000", "train.keep_best=false")
    mc, dc = cfg.model, cfg.data
    N, T, H, top_k = args.num_news, dc.max_title_len, dc.max_his_len, 10
    tokens = _tokens(state, args, T, mc.bert_hidden)
    data = _mind_data(state, args, T)
    quiet = contextlib.redirect_stdout(sys.stderr)
    launches = _PathLaunches()
    rng = np.random.default_rng(args.seed + 31)
    out: dict = {"config": {"num_news": N, "clients": args.clients, "batch_size": args.batch_size,
                            "rounds": 2, "mode": mc.text_encoder_mode, "top_k": top_k,
                            "waves": args.serving_waves, "clusters": args.serving_clusters,
                            "n_probe": args.serving_probe, "million_news": args.million_news,
                            "million_clusters": 1024, "million_n_probe": 64}}

    # ---- 1. train round 0, write the token states, publish the snapshot
    npy = root / "token_states.npy"
    out["token_states_gb"] = tokens.numel() * 4 / 1e9
    npy.hardlink_to(_token_file(state, args, tokens, out))
    with launches.segment(), quiet:
        trainer = Trainer(cfg, data, tokens, device=dev)
        trainer.run()
    m0 = trainer.states[0].model
    store = EmbeddingStore()
    t0 = time.perf_counter()
    with launches.segment():
        gen0 = publish_from_checkpoint(store, mc, snaps, np.load(npy, mmap_mode="c"), device=dev)
    out["publish_ms"] = (time.perf_counter() - t0) * 1e3
    user_state, news_state, _, _ = load_checkpoint_params(snaps)
    restored_equal = all(
        torch.equal(state_[k], p.detach().cpu())
        for state_, module in ((user_state, m0.user_encoder), (news_state, m0.text_head))
        for k, p in module.named_parameters())
    check(restored_equal, "the restored client-0 parameters differ from the trainer's")
    table_equal = torch.equal(gen0.news_vecs, encode_all_news(m0, tokens, device=dev))
    check(table_equal, "the published table differs from encode_all_news of the trainer's head")
    check((gen0.round, gen0.source) == (0, "checkpoint:torch"), f"generation 0: {gen0}")
    del trainer
    # round 1 into the same directory (the run resumes from round 0)
    with launches.segment(), quiet:
        Trainer(_decoupled_cfg(args, str(snaps), "fed.rounds=2", "fed.local_epochs=1",
                               "train.eval_every=1000", "train.keep_best=false"),
                data, tokens, device=dev).run()

    # ---- 2. serve generation 0 and refresh to round 1 under load
    service = ServingService(store, history_len=H, top_k=top_k, model_cfg=mc, device=dev)
    stalls = _StallProbe(service)
    try:
        with launches.segment():
            service.warmup()
            run = asyncio.run(asyncio.wait_for(_serve_and_refresh(
                service, {"snapshot_dir": str(snaps), "token_states": str(npy)},
                args.serving_waves, N, rng, H), 1800))
    finally:
        stalls.close()
    records, reply = run["records"], run["reply"]
    errors = [r["resp"] for r in records if "error" in r["resp"]]
    check(not errors, f"{len(errors)} requests failed, first: {errors[:2]}")
    check(reply == {"refreshed": True, "generation": 1, "round": 1,
                    "source": "checkpoint:torch"}, f"refresh reply {reply}")
    gens = [r["resp"]["generation"] for r in records]
    check(set(gens) <= {0, 1}, f"generations {sorted(set(gens))}")
    late0 = [r for r in records if r["t_send"] > run["t_reply"] and r["resp"]["generation"] != 1]
    check(not late0, f"{len(late0)} requests sent after the refresh reply scored on generation 0")
    check(run["same_conn"].get("generation") == 1,
          f"the refresh's connection after the reply: {run['same_conn']}")
    check(run["metrics"]["source"] == "checkpoint:torch" and run["metrics"]["swap_count"] == 1,
          f"metrics after the refresh {run['metrics']}")
    gen1 = store.current()
    g1 = [r for r in records if r["resp"]["generation"] == 1][-128:]
    hist = torch.tensor([r["hist"] + [0] * (H - len(r["hist"])) for r in g1], device=dev)
    ref_scores, ref_ids = _plain_scores(gen1.user_params, gen1.news_vecs, hist, top_k)
    served_ids = torch.tensor([r["resp"]["ids"] for r in g1], device=dev)
    served_scores = torch.tensor([r["resp"]["scores"] for r in g1], device=dev)
    # the wire carries scores to 5 places
    err_served = max_err(served_scores, ref_scores[:, :top_k])
    check(err_served <= F32_ATOL + 5e-6, f"served scores vs plain: {err_served}")
    mismatch = _topk_disagreements(served_ids, ref_scores, ref_ids, top_k)
    check(mismatch == 0, f"{mismatch} served ids differ from the plain scorer's where apart")
    windows = {"before": lambda r: r["t_send"] < run["t_refresh"],
               "during": lambda r: run["t_refresh"] <= r["t_send"] < run["t_reply"],
               "after": lambda r: r["t_send"] >= run["t_reply"]}
    out["serve_refresh"] = {
        "requests": len(records), "generation_1_requests": gens.count(1),
        "waves_during_refresh": run["during_waves"],
        "refresh_wall_ms": (run["t_reply"] - run["t_refresh"]) * 1e3,
        "refresh_ms": service.last_refresh_ms,
        "client_rtt_ms": {k: _percentiles([r["resp"]["latency_ms"] for r in records if f(r)])
                          for k, f in windows.items()},
        # from the refresh to the last answer, in 250 ms windows: the slowest
        # round trip of the requests sent, scorer call and thread oversleep,
        # beside the refresh's parts (restore, load, host-to-device, ...)
        "during_timeline_ms": {
            name: _timeline(pairs, run["t_refresh"], max(r["t_recv"] for r in records), 0.25)
            for name, pairs in (
                ("max_rtt", [(r["t_send"], r["resp"]["latency_ms"]) for r in records]),
                ("max_scorer_call", stalls.calls), ("max_thread_oversleep", stalls.ticks))},
        "scorer_call_ms": {k: _percentiles([ms for t, ms in stalls.calls if f({"t_send": t})])
                           for k, f in windows.items()},
        "served_vs_plain": {"max_abs_score_err": err_served, "id_mismatches": mismatch,
                            "rows": len(g1)},
        "restored_bitwise": restored_equal, "table_bitwise": table_equal,
    }

    # ---- 3. two-stage retrieval over the refreshed 65,536-news table
    table, tower = gen1.news_vecs, gen1.user_params
    kw = dict(num_clusters=args.serving_clusters, n_probe=args.serving_probe, device=dev)
    t0 = time.perf_counter()
    with launches.segment():
        index = build_index(table, **kw)
    index_ms = (time.perf_counter() - t0) * 1e3
    check(not index.exact, "the 65,536-news index fell back to exact scoring")
    t0 = time.perf_counter()
    again = build_index(table, **kw)
    index_again_ms = (time.perf_counter() - t0) * 1e3
    kmeans_bitwise = (torch.equal(index.centroids, again.centroids)
                      and torch.equal(index.members, again.members))
    check(kmeans_bitwise, "a repeated k-means build differs")
    del again
    hist = torch.from_numpy(rng.integers(1, N, size=(128, H))).to(dev)
    with launches.segment():
        ids2, sc2 = build_two_stage_fn(index, top_k=top_k, device=dev)(tower, hist)
    with torch.no_grad():
        user_vec = tower(table[hist]).float()
    ids_p, sc_p = _plain_rerank(index, user_vec, hist, top_k)
    rerank_err = max_err(sc2, sc_p)
    rerank_bitwise = torch.equal(ids2, ids_p) and torch.equal(sc2, sc_p)
    gaps = (sc_p[:, :-1] - sc_p[:, 1:]).abs()
    inf = torch.full_like(gaps[:, :1], float("inf"))
    decided = (torch.cat([inf, gaps], 1) > 1e-5) & (torch.cat([gaps, inf], 1) > 1e-5)
    rerank_mismatch = int((decided & (ids2 != ids_p)).sum())
    check(rerank_err <= 1e-5 and rerank_mismatch == 0,
          f"two-stage vs the plain per-row rerank: scores {rerank_err}, ids {rerank_mismatch}")
    recalls = {}
    with launches.segment():
        for p in (4, 16, args.serving_clusters):
            recalls[p] = recall_at_k(dataclasses.replace(index, n_probe=p), tower, hist,
                                     k=top_k, device=dev)
    rs = [recalls[p] for p in sorted(recalls)]
    check(all(a <= b for a, b in zip(rs, rs[1:])), f"recall falls as n_probe grows: {recalls}")
    check(recalls[args.serving_clusters] == 1.0, f"recall with every cluster probed {recalls}")
    two_stage = build_two_stage_fn(index, top_k=top_k, device=dev)
    exact = build_recommend_fn(top_k=top_k, device=dev)
    make_hist = lambda b: torch.from_numpy(rng.integers(1, N, size=(b, H)))  # noqa: E731
    out["two_stage"] = {
        "index_build_ms": index_ms, "index_build_again_ms": index_again_ms,
        "stats": index.stats(), "kmeans_bitwise": kmeans_bitwise,
        "vs_plain_rerank": {"max_abs_score_err": rerank_err, "id_mismatches": rerank_mismatch,
                            "bitwise": rerank_bitwise},
        "recall_at_10": recalls,
        "scorer_ms_by_bucket": {
            "two_stage": _bucket_ms(lambda h: two_stage(tower, h)[0].cpu(), make_hist,
                                    (1, 8, 32, 128), args.scorer_reps),
            "exact": _bucket_ms(lambda h: exact(tower, table, h)[0].cpu(), make_hist,
                                (1, 8, 32, 128), args.scorer_reps)},
    }
    del index, two_stage

    # ---- 4. the CLI's million-item mode, through its service, in process
    argv = ["--synthetic", str(args.million_news), "--clusters", "1024", "--n-probe", "64",
            "--seed", str(args.seed), "--device", DEV, "--set", "model.fuse_hot_path=true",
            "--set", "model.use_pallas=true"]
    margs = serve_cli.build_parser().parse_args(argv)
    mcfg = ExperimentConfig().apply_overrides(margs.overrides)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    with launches.segment():
        msvc = serve_cli.build_service(margs, mcfg)
        msvc.warmup()
    million_ms = (time.perf_counter() - t0) * 1e3
    check(not msvc.last_build_ms["exact"], f"million-item index {msvc.last_build_ms}")
    mgen = msvc.store.current()
    mfn = msvc._fn_for(mgen)
    mexact = build_recommend_fn(top_k=top_k, device=dev)
    mhist = lambda b: torch.from_numpy(rng.integers(1, args.million_news, size=(b, H)))  # noqa: E731
    m_ms = {"two_stage": _bucket_ms(lambda h: mfn(mgen.user_params, h)[0].cpu(), mhist,
                                    (1, 8, 32, 128), max(3, args.scorer_reps // 4)),
            "exact": _bucket_ms(lambda h: mexact(mgen.user_params, mgen.news_vecs, h)[0].cpu(),
                                mhist, (1, 8, 32, 128), max(3, args.scorer_reps // 4))}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # recall against brute force, no bar: the synthetic table is unclustered
    mh = mhist(128)
    approx = mfn(mgen.user_params, mh)[0].cpu().numpy()
    truth = mexact(mgen.user_params, mgen.news_vecs, mh)[0].cpu().numpy()
    hits = sum(len(set(a[a >= 0].tolist()) & set(e[e >= 0].tolist()))
               for a, e in zip(approx, truth))
    out["million"] = {
        "argv": argv, "recall_at_10": hits / max(int((truth >= 0).sum()), 1),
        "service_build_ms": million_ms, "build": msvc.last_build_ms,
        "peak_mem_gb": peak_gb, "mem_before_gb": base_gb, "scorer_ms_by_bucket": m_ms,
    }
    del msvc, mgen, mfn

    # ---- 5. the recommend CLI over the snapshots and the token states
    art = root / "UserData"
    _write_artifacts(data, art)
    recs = root / "recs.jsonl"
    err = io.StringIO()
    t0 = time.perf_counter()
    with launches.segment(), contextlib.redirect_stderr(err):
        rc = recommend.main(["--data-dir", str(art), "--snapshot-dir", str(snaps),
                             "--token-states", str(npy), "--out", str(recs), "--device", DEV])
    rec_s = time.perf_counter() - t0
    check(rc == 0, f"recommend CLI rc {rc}: {err.getvalue()[-2000:]}")
    lines = [json.loads(ln) for ln in recs.read_text().splitlines()]
    users = recommend.collect_histories(data, H)
    check([ln["uid"] for ln in lines] == sorted(users),
          f"{len(lines)} lines for {len(users)} known users")
    sample = lines[:256]
    hist = torch.tensor([[data.nid2index[n] for n in users[ln["uid"]]]
                         + [0] * (H - len(users[ln["uid"]])) for ln in sample], device=dev)
    ref_scores, ref_ids = _plain_scores(tower, table, hist, top_k)
    got = torch.tensor([[data.nid2index[n] for n in ln["news"]] for ln in sample], device=dev)
    rec_mismatch = _topk_disagreements(got, ref_scores, ref_ids, top_k)
    check(rec_mismatch == 0, f"{rec_mismatch} recommended ids differ from the plain route's")
    out["recommend_cli"] = {"rc": rc, "users": len(lines), "wall_s": rec_s,
                            "users_per_s": len(lines) / rec_s, "id_mismatches": rec_mismatch,
                            "checked_users": len(sample)}

    # ---- 6. the client against a restart and a black hole
    with launches.segment():
        client = asyncio.run(asyncio.wait_for(_client_behaviour(store, cfg), 120))
    check(all("error" not in r for r in client["before"]), f"before the restart {client['before'][:2]}")
    check(client["down"].get("error") in ("unavailable", "deadline"),
          f"during the restart {client['down']}")
    check(all("error" not in r or r["error"] in ("unavailable", "deadline")
              for r in client["after"]), f"after the restart {client['after'][:2]}")
    check(client["black_hole"] == {"error": "deadline"} and client["black_hole_s"] < 2.0,
          f"black hole: {client['black_hole']} after {client['black_hole_s']} s")
    out["client"] = {"after_restart_ok": sum("error" not in r for r in client["after"]),
                     "retries": client["retries"], "down": client["down"],
                     "black_hole_s": client["black_hole_s"]}

    counts = launches.total
    for name in ("additive_pool", "fused_history_score"):
        check(counts.get(name, 0) > 0, f"kernel {name} never launched on the serving path")
    state.setdefault("launches", {})["serving_path"] = counts
    out["launches"] = counts
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    work.cleanup()
    return out


# ---------------------------------------------------------------- data_path
# the trunk's work a token (6 layers at 768 wide, FFN 3072, L = 50): Q, K, V
# and out projections, QK^T and AV, the FFN's two products
def _trunk_flops_per_token(cfg, L: int) -> float:
    d, f = cfg.dim, cfg.hidden_dim
    return cfg.n_layers * (4 * 2 * d * d + 2 * 2 * L * d + 2 * 2 * d * f)


def _write_mind_tsv(root: Path, args) -> dict:
    """A MIND-format ``news.tsv``, ``behaviors.tsv`` (training) and
    ``behaviors_valid.tsv`` from ``--seed`` at MIND-small scale: ``--num-news``
    rows with the ``<unk>`` row (so 65,535 news), ``--data-users`` users and
    ``--data-impressions`` training impressions (MIND-small: 50,000 users,
    156,965 impressions), plus ``--valid`` validation impressions of one
    click each. Titles are 6-20 words of a seeded 30,000-word list, 60% of
    them from the news' category's share (18 categories, as MIND's); a user
    holds a fixed history of 0-50 clicks and two preferred categories, each
    impression shows 5-49 news and clicks 1-2 of the preferred ones."""
    rng = np.random.default_rng(args.seed + 41)
    n, users = args.num_news - 1, args.data_users
    topics, n_words = 18, 30_000
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    chars = letters[rng.integers(0, 26, size=(n_words, 9))]
    words = np.array(["".join(c[:k]) for c, k in zip(chars, rng.integers(3, 10, n_words))],
                     dtype=object)
    topic_of = rng.integers(0, topics, size=n)
    share = n_words // topics
    tlen = rng.integers(6, 21, size=n)
    total = int(tlen.sum())
    owner = np.repeat(np.arange(n), tlen)
    idx = np.where(rng.random(total) < 0.6,
                   topic_of[owner] * share + rng.integers(0, share, total),
                   rng.integers(0, n_words, total))
    nid = np.array([f"N{i}" for i in range(1, n + 1)], dtype=object)
    with open(root / "news.tsv", "w", encoding="utf-8") as f:
        f.writelines(f"{nid[i]}\tcat{t}\tcat{t}-sub\t{' '.join(ws)}\t\t\t[]\t[]\n" for i, (t, ws)
                     in enumerate(zip(topic_of, np.split(words[idx], np.cumsum(tlen)[:-1]))))
    order = np.argsort(topic_of, kind="stable")
    sizes = np.bincount(topic_of, minlength=topics)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pref = rng.integers(0, topics, size=(users, 2))

    def draws(who, p_own: float):  # one news each, a preferred category's w.p. p_own
        t = pref[who, rng.integers(0, 2, len(who))]
        own = order[starts[t] + (rng.random(len(who)) * sizes[t]).astype(np.int64)]
        return np.where(rng.random(len(who)) < p_own, own, rng.integers(0, n, len(who)))

    hlen = rng.integers(0, 51, size=users)
    hist = [" ".join(h) for h in np.split(nid[draws(np.repeat(np.arange(users), hlen), 0.8)],
                                          np.cumsum(hlen)[:-1])]
    clicked = np.array([s + "-1" for s in nid], dtype=object)
    shown = np.array([s + "-0" for s in nid], dtype=object)

    def behaviors(path: Path, imps: int, one_click: bool) -> int:
        us = rng.integers(0, users, size=imps)
        clicks = np.ones(imps, np.int64) if one_click else 1 + (rng.random(imps) < 0.3)
        negs = rng.integers(5, 50, size=imps) - clicks
        pos = np.split(clicked[draws(np.repeat(us, clicks), 1.0)], np.cumsum(clicks)[:-1])
        neg = np.split(shown[rng.integers(0, n, int(negs.sum()))], np.cumsum(negs)[:-1])
        with open(path, "w", encoding="utf-8") as f:
            f.writelines(f"{j + 1}\tU{u}\t11/11/2019 9:00:00 AM\t{hist[u]}\t"
                         f"{' '.join(p)} {' '.join(q)}\n"
                         for j, (u, p, q) in enumerate(zip(us, pos, neg)))
        return int(clicks.sum())

    clicks = behaviors(root / "behaviors.tsv", args.data_impressions, False)
    behaviors(root / "behaviors_valid.tsv", args.valid, True)
    return {"news": n, "users": users, "train_impressions": args.data_impressions,
            "train_clicks": clicks, "valid_impressions": args.valid,
            "tsv_mb": sum(p.stat().st_size for p in root.glob("*.tsv")) / 2**20}


def _data_cfg(args, snapshot_dir: str, *overrides: str):
    """The data path's runs: ExperimentConfig's widths and trunk, K = 2
    clients at B = ``--batch-size``, param_avg, the full-pool evaluation."""
    from fedrec_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().apply_overrides([
        "model.fuse_hot_path=true", "model.use_pallas=true", "fed.num_clients=2",
        f"data.batch_size={args.batch_size}", "fed.strategy=param_avg",
        "train.eval_protocol=full", f"train.seed={args.seed}",
        f"train.snapshot_dir={snapshot_dir}", "train.keep_best=false", *overrides,
    ])


def phase_data_path(state: dict, args) -> dict:
    """Raw MIND tsv -> preprocessing -> the DistilBERT trunk's token states
    -> a joint round on them -> finetune rounds that train the trunk ->
    snapshot -> the recommend CLI, at MIND-small scale and full width."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from fedrec_tpu_torch.cli import recommend
    from fedrec_tpu_torch.data import MindData, load_mind_artifacts, preprocess_mind
    from fedrec_tpu_torch.models.attention import dense
    from fedrec_tpu_torch.models.bert import (
        DistilBert,
        DistilBertConfig,
        init_trunk_params,
        precompute_token_states,
    )
    from fedrec_tpu_torch.ops import (
        additive_pool_plain,
        fused_history_score,
        fused_history_score_plain,
        launch_counts,
        reset_launch_counts,
    )
    from fedrec_tpu_torch.train import Trainer

    dev = torch.device(DEV)
    K, B = 2, args.batch_size
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(prefix="data_path_", dir=build)
    root = Path(work.name)
    free = shutil.disk_usage(root).free
    check(free > 8 << 30, f"{root} has {free / 1e9:.2f} GB free; the data path needs 8 GB")
    quiet = contextlib.redirect_stdout(sys.stderr)
    launches = _PathLaunches()
    out: dict = {}

    # ---- 1. raw MIND tsv, then the port's preprocessing (hashing tokenizer
    # over the full 30,522-id space)
    t0 = time.perf_counter()
    out["tsv"] = _write_mind_tsv(root, args)
    out["tsv"]["write_s"] = time.perf_counter() - t0
    art = root / "UserData"
    t0 = time.perf_counter()
    data = preprocess_mind(root / "news.tsv", root / "behaviors.tsv",
                           root / "behaviors_valid.tsv", art, vocab_path=None, max_title_len=50)
    out["preprocess_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reread = load_mind_artifacts(art)
    out["artifacts_load_s"] = time.perf_counter() - t0
    N, T = data.news_tokens.shape[0], data.news_tokens.shape[2]
    check(N == args.num_news and T == 50, f"news table {data.news_tokens.shape}")
    check(np.array_equal(reread.news_tokens, data.news_tokens)
          and len(reread.train_samples) == out["tsv"]["train_clicks"]
          and len(reread.valid_samples) == args.valid,
          f"artifacts: {len(reread.train_samples)} train / {len(reread.valid_samples)} valid")
    ids = data.news_tokens[:, 0]
    out["tokens"] = {"ids_max": int(ids.max()), "distinct_ids": int(np.unique(ids).size),
                     "real_tokens": int(data.news_tokens[:, 1].sum()),
                     "mean_title_tokens": float(data.news_tokens[1:, 1].sum(1).mean())}
    del reread

    # ---- 2. the trunk over every title, on the card
    tcfg = DistilBertConfig()
    sd = init_trunk_params(0, tcfg)
    trunk = DistilBert(tcfg)
    trunk.load_state_dict(sd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    states = precompute_token_states(trunk, data.news_tokens, tcfg, chunk=256, device=dev)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    flops = _trunk_flops_per_token(tcfg, T) * N * T
    check(states.shape == (N, T, tcfg.dim) and np.isfinite(states[:: max(1, N // 512)]).all(),
          f"token states {states.shape}")
    # 64 real titles against the same trunk in float64 on the CPU; the
    # <unk> row (every key padded: uniform attention from f32's absorption
    # of -1e9, as in JAX) against it in float32
    ref64 = DistilBert(tcfg, dtype=torch.float64)
    ref64.load_state_dict({k: v.double() for k, v in sd.items()})
    rows = torch.from_numpy(data.news_tokens[1:65])
    with torch.no_grad():
        want = ref64(rows[:, 0], rows[:, 1])
        unk = torch.from_numpy(data.news_tokens[:1])
        want0 = trunk.cpu()(unk[:, 0], unk[:, 1])
    err64 = float((torch.from_numpy(states[1:65]).double() - want).abs().max())
    err0 = float((torch.from_numpy(states[:1]) - want0).abs().max())
    check(err64 <= 1e-4 and err0 <= 1e-4,
          f"trunk on the card vs the CPU: float64 rows {err64}, <unk> row {err0} (atol 1e-4)")
    out["precompute"] = {
        "ms": pre_s * 1e3, "tokens": N * T, "tokens_per_s": N * T / pre_s,
        "flops": flops, "share_of_f32_peak": flops / pre_s / state["peaks"]["f32"],
        "chunk": 256, "gb": states.nbytes / 1e9,
        "max_abs_err_vs_f64": err64, "unk_row_err_vs_f32_cpu": err0,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del trunk, ref64, want

    # ---- 3. one joint round on those states, then the full-pool evaluation
    steps = args.data_joint_steps
    joint_data = MindData(data.news_tokens, data.nid2index,
                          data.train_samples[: K * B * steps], data.valid_samples)
    cfg = _data_cfg(args, "", "model.text_encoder_mode=head", "fed.rounds=1",
                    "train.eval_every=1")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with launches.segment(), quiet:
        trainer = Trainer(cfg, joint_data, states, device=dev)
        up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        hist = trainer.run()
    joint_counts = dict(launches.total)
    round_s = time.perf_counter() - t1
    m = hist[0].val_metrics
    check(math.isfinite(hist[0].train_loss) and all(0.0 <= v <= 1.0 for v in m.values()),
          f"joint round: loss {hist[0].train_loss}, metrics {m}")
    for name in ("fused_gather_encode", "fused_gather_encode_bwd", "fused_history_score",
                 "fused_history_score_bwd", "additive_pool"):
        check(joint_counts.get(name, 0) > 0, f"kernel {name} never launched on the joint round")
    check(joint_counts["fused_gather_encode"] >= K * steps
          and joint_counts["fused_history_score_bwd"] >= K * steps,
          f"C, E launched {joint_counts} times: fewer than the {K * steps} client steps")
    m0 = trainer.states[0].model
    with torch.no_grad():
        th, tok = m0.text_head, trainer.token_states
        table = trainer._encode_corpus(0)
        pooled = additive_pool_plain(tok[: args.chunk], th.pool.att_fc1.weight.t().contiguous(),
                                     th.pool.att_fc1.bias, th.pool.att_fc2.weight[0].contiguous())
        err_a = max_err(table[: args.chunk], dense(th.fc, pooled, torch.float32))
        his = table[torch.as_tensor(trainer.valid_ix.history[:256], device=dev).long()]
        w = m0.user_encoder.fused_weights(his.dtype)
        err_b = max_err(fused_history_score(his, None, None, w, cfg.model.num_heads)[1],
                        fused_history_score_plain(his, None, None, w, cfg.model.num_heads)[1])
    check(err_a <= F32_ATOL and err_b <= F32_ATOL,
          f"joint round kernels vs plain: A {err_a}, B {err_b} (atol {F32_ATOL})")
    out["joint"] = {"clients": K, "batch_size": B, "steps": steps,
                    "states_to_card_s": up_s, "round_s": round_s, "loss": hist[0].train_loss,
                    "val_metrics": m, "launches": joint_counts,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "max_abs_err_vs_plain": {"additive_pool": err_a,
                                             "fused_history_score": err_b}}
    del trainer, states, tok, table, his, m0
    torch.cuda.empty_cache()

    # ---- 4. finetune: the trunk trains in the loop, kernel route then dense
    ft_steps, ft_rounds = args.finetune_steps, 2
    ft_data = MindData(data.news_tokens, data.nid2index,
                       data.train_samples[: K * B * ft_steps], data.valid_samples)
    snaps = root / "snapshots"
    ft = ["model.text_encoder_mode=finetune", "model.trunk_dropout=0", "model.trunk_remat=true",
          f"fed.rounds={ft_rounds}", f"train.eval_every={ft_rounds}",
          f"train.save_every={ft_rounds}"]

    def instrumented(trainer, log: list) -> None:
        inner = trainer.train_step

        def step(states_, batch, table_):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            before = launch_counts()
            t0_ = time.perf_counter()
            res = inner(states_, batch, table_)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0_) * 1e3
            after = launch_counts()
            log.append({
                "ms": ms, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "resident_gb": resident / 1e9,
                # the trainer hands the step device tensors
                "unique_news": [int(torch.unique(torch.cat([c.reshape(-1), h.reshape(-1)])).numel())
                                for c, h in zip(torch.as_tensor(batch["candidates"]),
                                                torch.as_tensor(batch["history"]))],
                "losses": res[1]["loss"].tolist(),
                "unique_overflow": int(res[1]["unique_overflow"]),
                "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]}})
            return res

        trainer.train_step = step

    runs = {}
    for route, extra in (("kernel", ()), ("dense", ("model.fuse_hot_path=false",
                                                     "model.use_pallas=false"))):
        log: list = []
        cfg_ft = _data_cfg(args, str(snaps) if route == "kernel" else "", *ft, *extra)
        # the kernel route counts toward the path; the dense route must count 0
        seg = launches.segment() if route == "kernel" else contextlib.nullcontext()
        reset_launch_counts()
        t0 = time.perf_counter()
        with seg, quiet:
            trainer = Trainer(cfg_ft, ft_data, None, device=dev)
            instrumented(trainer, log)
            hist = trainer.run()
        runs[route] = (trainer, hist, log, time.perf_counter() - t0)
        if route == "dense":
            check(not any(launch_counts().values()), "the dense finetune route launched a kernel")
    trainer, hist, log, run_s = runs["kernel"]
    dense_trainer, dense_hist, dense_log, dense_s = runs["dense"]
    check(len(log) == ft_rounds * ft_steps, f"{len(log)} finetune steps logged")
    for i, s in enumerate(log):
        check(all(math.isfinite(v) for v in s["losses"]) and s["unique_overflow"] == 0,
              f"finetune step {i}: losses {s['losses']}, overflow {s['unique_overflow']}")
        for name in ("fused_history_score", "fused_history_score_bwd"):
            check(s["launches"].get(name, 0) >= K,
                  f"finetune step {i}: kernel {name} launched {s['launches'].get(name, 0)} "
                  f"times for {K} client steps")
        check("fused_gather_encode" not in s["launches"], "C launched in finetune mode")
    traj = [(h.train_loss, d.train_loss) for h, d in zip(hist, dense_hist)]
    for r, (lk, ld) in enumerate(traj):
        check(math.isclose(lk, ld, rel_tol=TRAJ_LOSS_RTOL, abs_tol=TRAJ_LOSS_ATOL),
              f"finetune round {r}: kernel-route loss {lk!r} vs dense {ld!r}")
    for i, (s, d) in enumerate(zip(log, dense_log)):
        for lk, ld in zip(s["losses"], d["losses"]):
            check(math.isclose(lk, ld, rel_tol=TRAJ_LOSS_RTOL, abs_tol=TRAJ_LOSS_ATOL),
                  f"finetune step {i}: kernel-route loss {lk!r} vs dense {ld!r}")
    val_diff = max(abs(hist[-1].val_metrics[k] - dense_hist[-1].val_metrics[k])
                   for k in hist[-1].val_metrics)
    check(val_diff <= VAL_ATOL, f"finetune validation: kernel vs dense route differ by {val_diff}")
    worst = worst_noise = 0.0
    for c, (sk, sd_) in enumerate(zip(trainer.states, dense_trainer.states)):
        bad, w_, wn = _param_diffs(sk.model, sd_.model)
        check(not bad, f"finetune client {c}: kernel route vs dense: {bad} outside the bars")
        worst, worst_noise = max(worst, w_), max(worst_noise, wn)
    del dense_trainer
    torch.cuda.empty_cache()
    n_trunk = sum(p.numel() for p in trainer.states[0].model.text_encoder.trunk.parameters())
    # the trunk's work a step: forward, the remat recompute, backward (2x)
    step_flops = [4 * sum(s["unique_news"]) * T * _trunk_flops_per_token(tcfg, T) for s in log]
    out["finetune"] = {
        "clients": K, "batch_size": B, "steps_per_round": ft_steps, "rounds": ft_rounds,
        "trunk_params": n_trunk, "run_s": run_s, "dense_run_s": dense_s,
        "step_ms": [s["ms"] for s in log], "dense_step_ms": [s["ms"] for s in dense_log],
        "client_step_ms_median": float(np.median([s["ms"] for s in log])) / K,
        "trunk_flops_per_step": step_flops,
        "trunk_share_of_f32_peak": [f / (s["ms"] / 1e3) / state["peaks"]["f32"]
                                    for f, s in zip(step_flops, log)],
        "peak_mem_gb": [s["peak_mem_gb"] for s in log],
        "resident_gb_before_step": [s["resident_gb"] for s in log],
        "dense_peak_mem_gb": [s["peak_mem_gb"] for s in dense_log],
        "unique_news": [s["unique_news"] for s in log],
        "step_launches": [s["launches"] for s in log],
        "round_losses": [h.train_loss for h in hist], "val_metrics": hist[-1].val_metrics,
        "kernel_vs_dense": {"round_losses": traj, "max_val_metric_diff": val_diff,
                            "max_param_diff": worst, "max_zero_grad_leaf_diff": worst_noise,
                            "dense_val_metrics": dense_hist[-1].val_metrics}}

    # ---- 5. the snapshot through the recommend CLI, against the plain route
    tower, table = trainer.export_for_serving()
    m0 = trainer.states[0].model
    with torch.no_grad():
        his = table[torch.as_tensor(trainer.valid_ix.history[:256], device=dev).long()]
        w = m0.user_encoder.fused_weights(his.dtype)
        err_b_ft = max_err(fused_history_score(his, None, None, w, m0.cfg.num_heads)[1],
                           fused_history_score_plain(his, None, None, w, m0.cfg.num_heads)[1])
    check(err_b_ft <= F32_ATOL, f"finetune eval B vs plain: {err_b_ft}")
    out["finetune"]["max_abs_err_vs_plain"] = {"fused_history_score": err_b_ft}
    users = recommend.collect_histories(data, 50)
    uids = sorted(users)[: args.data_rec_users]
    recs = root / "recs.jsonl"
    err = io.StringIO()
    t0 = time.perf_counter()
    with launches.segment(), contextlib.redirect_stderr(err):
        rc = recommend.main(["--data-dir", str(art), "--snapshot-dir", str(snaps), "--out",
                             str(recs), "--device", DEV, "--uids", *uids])
    rec_s = time.perf_counter() - t0
    check(rc == 0, f"recommend CLI rc {rc}: {err.getvalue()[-2000:]}")
    lines = [json.loads(ln) for ln in recs.read_text().splitlines()]
    check([ln["uid"] for ln in lines] == uids, f"{len(lines)} lines for {len(uids)} users")
    sample = lines[:: max(1, len(lines) // 256)][:256]
    H = 50
    hist_ids = torch.tensor([[data.nid2index[n] for n in users[ln["uid"]]]
                             + [0] * (H - len(users[ln["uid"]])) for ln in sample], device=dev)
    ref_scores, ref_ids = _plain_scores(tower, table, hist_ids, 10)
    got = torch.tensor([[data.nid2index[n] for n in ln["news"]] for ln in sample], device=dev)
    mismatch = _topk_disagreements(got, ref_scores, ref_ids, 10)
    check(mismatch == 0, f"{mismatch} recommended ids differ from the plain route's")
    snap_mb = sum(f.stat().st_size for f in snaps.rglob("state.pt")) / 2**20
    out["recommend_cli"] = {"rc": rc, "users": len(lines), "wall_s": rec_s,
                            "users_per_s": len(lines) / rec_s, "id_mismatches": mismatch,
                            "checked_users": len(sample), "snapshot_mb": snap_mb}

    # ---- 6. where a finetune step's device time goes (one more step of
    # the first batch, after every check that reads the trained state)
    batch = next(iter(trainer.batcher.epoch_batches_sharded(K, 0)))
    batch = {"candidates": batch.candidates, "history": batch.history, "labels": batch.labels}
    step_fn = trainer.train_step
    out["finetune"]["step_device_breakdown"] = _device_breakdown(
        lambda: step_fn(trainer.states, batch, trainer.news_tokens)[1]["loss"].tolist(),
        reps=2, top=10, sum_of={"cublas_gemm": ["gemm", "Gemm", "sm90_", "cutlass"],
                                "kernels_B_E": ["rows_gemm_kernel", "attn_head_kernel",
                                                "pool_fwd_kernel", "pool_bwd_kernel",
                                                "wgrad_"]})

    counts = launches.total
    for name in ("fused_history_score", "fused_history_score_bwd", "fused_gather_encode",
                 "fused_gather_encode_bwd", "additive_pool"):
        check(counts.get(name, 0) > 0, f"kernel {name} never launched on the data path")
    state.setdefault("launches", {})["data_path"] = counts
    out["launches"] = counts
    out["config"] = {"num_news": N, "title_len": T, "trunk": dataclasses.asdict(tcfg),
                     "tokenizer": "HashingTokenizer(30522)", "valid": args.valid,
                     "rec_users": len(uids), "dtype": "float32", "tf32": False}
    del trainer, tower, table
    torch.cuda.empty_cache()
    work.cleanup()
    return out


# ------------------------------------------------------------- family_path
# family_path's watch leg: an objective no round meets, so the alert fires at
# the second round's evaluation (pending_for 2)
FAMILY_SLO = "round_time:train.round_seconds:p50<0.001"


def _family_slo_checks(obs_dir: Path, slo_dir: Path, round_ms_slo: list,
                       round_ms_obs: list) -> dict:
    """The watch leg's artifacts: a firing ``slo:round_time`` record in its
    ``metrics.jsonl`` and none in the watch-less ``obs`` leg's; ``fedrec-obs
    alerts`` and ``tail --once`` exit 1 on it (0 on the other); its report
    has the Alerts panel."""
    from fedrec_tpu_torch.cli import obs as obs_cli
    from fedrec_tpu_torch.obs.report import load_jsonl

    fired = [r for r in load_jsonl(slo_dir / "metrics.jsonl")[0]
             if r.get("kind") == "alert" and r.get("event") == "firing"]
    check([r["key"] for r in fired] == ["slo:round_time"], f"the watch leg's alerts {fired}")
    quiet = [r for r in load_jsonl(obs_dir / "metrics.jsonl")[0] if r.get("kind") == "alert"]
    check(not quiet, f"the run without obs.slo wrote alert records {quiet}")
    rcs = {}
    for name, argv in (("alerts", ["alerts", str(slo_dir)]),
                       ("tail_once", ["tail", str(slo_dir), "--once"]),
                       ("alerts_without_slo", ["alerts", str(obs_dir)]),
                       ("report", ["report", str(slo_dir)])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rcs[name] = obs_cli.main(argv)
        if name == "report":
            check("## Alerts" in buf.getvalue() and "STILL FIRING" in buf.getvalue(),
                  "the watch leg's report has no Alerts panel")
    check(rcs == {"alerts": 1, "tail_once": 1, "alerts_without_slo": 0, "report": 0},
          f"fedrec-obs exit codes {rcs}")
    return {"objective": FAMILY_SLO, "fired": fired[0]["summary"], "rcs": rcs,
            "round_ms_slo": round_ms_slo, "round_ms_obs": round_ms_obs}


def _family_cfg(args, snapshot_dir: str, *overrides: str):
    """The family path's runs: ExperimentConfig's widths with the GRU user
    tower and the CNN text head (``cnn_kernel`` 3), kernel A on both pools
    (``use_pallas``), the native batcher, joint mode, param_avg over
    ``--clients`` slots at B = ``--batch-size``, the full-pool evaluation."""
    from fedrec_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().apply_overrides([
        "model.user_tower=gru", "model.text_head_arch=cnn", "model.cnn_kernel=3",
        "model.use_pallas=true", "model.fuse_hot_path=false", "model.text_encoder_mode=head",
        "data.native_loader=true", f"data.batch_size={args.batch_size}",
        f"fed.num_clients={args.clients}", "fed.strategy=param_avg", "train.eval_protocol=full",
        f"train.seed={args.seed}", f"train.snapshot_dir={snapshot_dir}", "train.keep_best=false",
        *overrides,
    ])


def _indexed_samples(n: int, pool: int, his: int, num_news: int, seed: int):
    """``n`` click samples over ``num_news`` news with pools of 5-``pool``
    negatives and histories of 0-``his`` clicks, made in bulk (numpy)."""
    from fedrec_tpu_torch.data import IndexedSamples

    rng = np.random.default_rng(seed)
    lens = rng.integers(5, pool + 1, n).astype(np.int32)
    pools = rng.integers(1, num_news, (n, pool)).astype(np.int32)
    pools[np.arange(pool)[None, :] >= lens[:, None]] = 0
    his_len = rng.integers(0, his + 1, n).astype(np.int32)
    history = rng.integers(1, num_news, (n, his)).astype(np.int32)
    history[np.arange(his)[None, :] >= his_len[:, None]] = 0
    return IndexedSamples(rng.integers(1, num_news, n).astype(np.int32), pools, lens, history,
                          his_len)


def _tower_bwd_f64(x, cand, w, g_scores, g_user, num_heads: int):
    """Kernel E's outputs in float64: autograd of the fused user tower's
    arithmetic (``fused_history_score_plain``'s, no mask) run in float64,
    the exact answer the f32 kernel and the f32 plain version are held to
    where an output cancels."""
    import torch
    from fedrec_tpu_torch.ops.fused_hot_path import UserTowerWeights, masked_softmax

    with torch.enable_grad():
        xl = x.detach().double().requires_grad_()
        cl = cand.detach().double().requires_grad_()
        wl = UserTowerWeights(*(t.detach().double().requires_grad_() for t in w))
        n, h, d = xl.shape
        dh = d // num_heads
        q, k, v = (xl @ wm + b for wm, b in ((wl.wq, wl.bq), (wl.wk, wl.bk), (wl.wv, wl.bv)))
        ones = torch.ones((n, h), dtype=torch.float64, device=x.device)

        def heads(t):
            return t.reshape(n, h, num_heads, dh).transpose(1, 2)

        a = masked_softmax(heads(q) @ heads(k).transpose(-1, -2) / math.sqrt(dh),
                           ones[:, None, None, :])
        ctx = (a @ heads(v)).transpose(1, 2).reshape(n, h, d)
        lg = torch.tanh(ctx @ wl.pw1 + wl.pb1) @ wl.pw2
        user = torch.einsum("nh,nhd->nd", masked_softmax(lg, ones), ctx)
        scores = torch.einsum("ncd,nd->nc", cl, user)
        got = torch.autograd.grad([user, scores], [xl, cl, *wl],
                                  [g_user.double(), g_scores.double()])
    return got[0], got[1], UserTowerWeights(*got[2:])


def phase_family_path(state: dict, args) -> dict:
    """The other model families and the run's observability artifacts at
    full width: the native engine's build and its epoch fill against the
    Python batcher's; a GRU + CNN joint ``Trainer`` (kernel A on both
    pools, the native batcher, ``obs.dir`` with the quality and perf
    monitors and a capture window) against the same run without ``obs.dir``
    (bitwise equal); a CNN-head + MHA-tower leg under ``fuse_hot_path`` (B
    and E launch, C and D do not; E held against float64, the leg against
    the dense route); one decoupled round (the CNN head's
    chunked corpus re-encode); the snapshot through the recommend CLI;
    ``fedrec-obs report`` and ``perf`` on the run's artifacts; a ``nan``
    chaos run on a 2,048-news catalog whose flight-recorder dump is
    replayed on the card."""
    import copy
    import tempfile

    import torch
    from fedrec_tpu_torch.cli import obs as obs_cli
    from fedrec_tpu_torch.cli import recommend
    from fedrec_tpu_torch.data import MindData, TrainBatcher, make_synthetic_mind
    from fedrec_tpu_torch.data import native_batcher
    from fedrec_tpu_torch.models.encoders import gru_scan
    from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, TrainingHealthError
    from fedrec_tpu_torch.obs import set_registry, set_tracer
    from fedrec_tpu_torch.obs.report import load_trace
    from fedrec_tpu_torch.ops import (
        additive_pool,
        additive_pool_plain,
        fused_history_score,
        fused_history_score_bwd,
        fused_history_score_bwd_plain,
        fused_history_score_plain,
    )
    from fedrec_tpu_torch.train import Trainer
    from fedrec_tpu_torch.train import trainer as trainer_module

    dev = torch.device(DEV)
    K, B, S = args.clients, args.batch_size, args.trainer_steps
    base = _family_cfg(args, "")
    T, H = base.data.max_title_len, base.data.max_his_len
    D, Dh = base.model.news_dim, base.model.bert_hidden
    tokens = _tokens(state, args, T, Dh)
    data = _mind_data(state, args, T)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(prefix="family_path_", dir=build)
    root = Path(work.name)
    quiet = contextlib.redirect_stdout(sys.stderr)
    launches = _PathLaunches()
    out: dict = {}
    errs: dict[str, float] = {}

    # ---- 1. the native engine: its build, then one epoch's batches at
    # MIND-small's ~204k click samples against the Python batcher's, each
    # read through epoch_batches_sharded as the trainer reads them (the
    # native one fills the epoch in one threaded call)
    t0 = time.perf_counter()
    lib = native_batcher.build()
    out["native_build"] = {"wall_s": time.perf_counter() - t0,
                           "g++_s": native_batcher.build_seconds, "library": str(lib)}
    ix = _indexed_samples(args.family_fill_samples, 49, H, args.num_news, args.seed)
    fill = {}
    for name, cls in (("native", native_batcher.NativeTrainBatcher), ("python", TrainBatcher)):
        batcher = cls(ix, B, 4, seed=args.seed)
        t0 = time.perf_counter()
        steps = sum(1 for _ in batcher.epoch_batches_sharded(K, 0))
        fill[name] = {"s": time.perf_counter() - t0, "steps": steps}
    check(fill["native"]["steps"] == fill["python"]["steps"] > 0, f"epoch fill: {fill}")
    py_first = next(iter(TrainBatcher(ix, B, 4, shuffle=False, seed=0).epoch_batches_sharded(K, 0)))
    nat_first = next(iter(native_batcher.NativeTrainBatcher(ix, B, 4, shuffle=False, seed=0)
                          .epoch_batches_sharded(K, 0)))
    check(np.array_equal(py_first.history, nat_first.history)
          and np.array_equal(py_first.candidates[..., 0], nat_first.candidates[..., 0]),
          "native batcher: positives or histories differ from the Python batcher's")
    fill["samples"] = len(ix)
    fill["speedup"] = fill["python"]["s"] / fill["native"]["s"]
    out["epoch_fill"] = fill
    del ix

    # ---- 2. the GRU + CNN joint run with obs.dir, the same run without, and
    # the same run with the watch layer over an unmeetable round-time SLO
    rounds = 2
    obs_dir, slo_dir = root / "obs", root / "obs_slo"
    snaps = root / "snapshots"
    runs = {}
    for leg, extra in (("obs", (f"obs.dir={obs_dir}", "obs.quality.enabled=true",
                                "obs.perf.enabled=true", "obs.perf.capture_rounds=1")),
                       ("plain", ()),
                       ("slo", (f"obs.dir={slo_dir}", "obs.slo.enabled=true",
                                f"obs.slo.objectives={FAMILY_SLO}"))):
        # every leg snapshots every round: obs.dir is their one difference
        cfg = _family_cfg(args, str(snaps if leg == "obs" else root / f"snapshots_{leg}"),
                          f"fed.rounds={rounds}", "train.eval_every=1", *extra)
        step_ms: list = []
        round_ms: list = []
        # where obs.dir's cost goes: the evaluation (the quality sums), the
        # round's bookkeeping (records, registry snapshots; both legs save
        # the same snapshots), the flight recorder's round-entry host copy
        parts = {"eval": [], "after_round": [], "flightrec_copy": []}
        prev = set_registry(MetricsRegistry()), set_tracer(Tracer())
        copy_fn = trainer_module.host_states
        seg = launches.segment() if leg == "obs" else contextlib.nullcontext()
        try:
            with seg, quiet:
                trainer = Trainer(cfg, data, tokens, device=dev)
                check(isinstance(trainer.batcher, native_batcher.NativeTrainBatcher),
                      "data.native_loader did not select the native batcher")
                _time_calls(trainer, "train_step", step_ms)
                _time_calls(trainer, "train_round", round_ms)
                _time_calls(trainer, "_eval_if_due", parts["eval"])
                _time_calls(trainer, "_after_round", parts["after_round"])
                _time_calls(trainer_module, "host_states", parts["flightrec_copy"])
                hist = trainer.run()
        finally:
            trainer_module.host_states = copy_fn
            set_registry(prev[0])
            set_tracer(prev[1])
        runs[leg] = (trainer, hist, step_ms, round_ms, parts)
    trainer, hist, step_ms, round_ms, _ = runs["obs"]
    counts = dict(launches.total)
    for r in hist:
        check(math.isfinite(r.train_loss) and all(0.0 <= v <= 1.0 for v in r.val_metrics.values()),
              f"GRU+CNN round {r.round_idx}: loss {r.train_loss}, metrics {r.val_metrics}")
    check(counts.get("additive_pool", 0) >= 2 * K * S * rounds,
          f"kernel A launched {counts.get('additive_pool', 0)} times: fewer than both pools "
          f"of {K * S * rounds} client steps")
    for name in ("fused_history_score", "fused_gather_encode"):
        check(counts.get(name, 0) == 0, f"{name} launched on the GRU + CNN run")
    plain_trainer, plain_hist = runs["plain"][:2]

    def bitwise(t, h) -> bool:
        return ([r.train_loss for r in h] == [r.train_loss for r in plain_hist]
                and all(r.val_metrics == q.val_metrics for r, q in zip(h, plain_hist))
                and all(torch.equal(p, q) for a, b in zip(t.states, plain_trainer.states)
                        for p, q in zip(a.model.parameters(), b.model.parameters())))

    same = bitwise(trainer, hist)
    check(same, "obs.dir changed the trajectory: losses, metrics or parameters differ")
    same_slo = bitwise(*runs["slo"][:2])
    check(same_slo, "obs.slo changed the trajectory: losses, metrics or parameters differ")
    out["slo"] = _family_slo_checks(obs_dir, slo_dir, runs["slo"][3], runs["obs"][3])

    # kernel A against its plain version on this path's inputs: the CNN
    # pool over a chunk of the corpus, the GRU pool over a batch's histories
    m0 = trainer.states[0].model
    th, ue = m0.text_head, m0.user_encoder
    with torch.no_grad():
        conv = torch.relu(torch.nn.functional.linear(
            th.windows(tokens[: args.chunk]), th.conv.weight, th.conv.bias))
        w_t = (th.pool.att_fc1.weight.t().contiguous(), th.pool.att_fc1.bias,
               th.pool.att_fc2.weight[0].contiguous())
        err_cnn = max_err(additive_pool(conv, *w_t), additive_pool_plain(conv, *w_t))
        table = trainer._encode_corpus(0)
        his = table[torch.as_tensor(trainer.valid_ix.history[:256], device=dev).long()]
        outs = gru_scan(ue.GRUCell_0, his, torch.float32)
        w_u = (ue.pool.att_fc1.weight.t().contiguous(), ue.pool.att_fc1.bias,
               ue.pool.att_fc2.weight[0].contiguous())
        err_gru = max_err(additive_pool(outs, *w_u), additive_pool_plain(outs, *w_u))
        # the CNN product against float64 (TF32 off)
        x64 = th.windows(tokens[:64]).double()
        ref = torch.relu(x64 @ th.conv.weight.double().t() + th.conv.bias.double())
        err_conv64 = max_err(conv[:64].double(), ref)
    check(err_cnn <= F32_ATOL and err_gru <= F32_ATOL and err_conv64 <= 1e-4,
          f"family kernels vs plain: A on the CNN pool {err_cnn}, on the GRU pool {err_gru}; "
          f"the CNN product vs float64 {err_conv64}")
    errs["additive_pool"] = max(err_cnn, err_gru)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        trainer._encode_states(0)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    plain_steps, plain_rounds = runs["plain"][2], runs["plain"][3]
    out["joint"] = {
        "clients": K, "batch_size": B, "steps": S, "rounds": rounds,
        "round_losses": [r.train_loss for r in hist], "val_metrics": hist[-1].val_metrics,
        # K-client steps; round 1's run inside the obs leg's profiler capture
        "step_ms_obs": step_ms, "step_ms_plain": plain_steps,
        "client_step_ms_plain_median": float(np.median(plain_steps[1:])) / K,
        "round_ms_obs": round_ms, "round_ms_plain": plain_rounds,
        "obs_cost_ms_by_round": [a - b for a, b in zip(round_ms, plain_rounds)],
        "obs_parts_ms": {"obs": runs["obs"][4], "plain": runs["plain"][4]},
        "corpus_encode_ms": encode_ms,
        "launches": counts, "obs_equals_plain_bitwise": same,
        "slo_equals_plain_bitwise": same_slo,
        "max_abs_err_vs_plain": {"additive_pool_cnn": err_cnn, "additive_pool_gru": err_gru},
        "conv_err_vs_f64": err_conv64,
        "a_device_ms": {
            "cnn_pool": time_ms(lambda: additive_pool(conv, *w_t), reps=10),
            "gru_pool": time_ms(lambda: additive_pool(outs, *w_u), reps=20)}}
    del plain_trainer, runs, conv, outs
    torch.cuda.empty_cache()

    # ---- 3. fedrec-obs report and perf on the run's artifacts
    events = load_trace(obs_dir / "trace.json")
    n_rounds = sum(1 for e in events if e.get("name") == "fed_round")
    check(n_rounds == rounds, f"trace.json holds {n_rounds} fed_round spans")
    cli_out = {}
    for verb in ("report", "perf", "quality"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = obs_cli.main([verb, str(obs_dir), "--json"])
        check(rc == 0, f"fedrec-obs {verb} rc {rc}")
        cli_out[verb] = json.loads(buf.getvalue())
    mfu = cli_out["perf"].get("mfu")
    check(mfu is not None and 0.0 < mfu <= 1.0, f"perf.mfu {mfu} outside (0, 1]")
    captures = cli_out["perf"].get("capture_records", [])
    check(len(captures) == 1 and (Path(captures[0]["logdir"]) / "trace.json").exists(),
          f"capture records {captures}")
    out["obs"] = {"mfu": mfu, "samples_per_sec": cli_out["perf"].get("samples_per_sec"),
                  "verdicts": cli_out["perf"].get("verdict_rounds"),
                  "phases": cli_out["perf"].get("phases"),
                  "hbm_components_mb": {k: v / 2**20 for k, v in
                                        cli_out["perf"].get("hbm_components", {}).items()},
                  "quality_slices": len(cli_out["quality"].get("slices", {})),
                  "ece": cli_out["quality"].get("ece"),
                  "report_sections": sorted(cli_out["report"]),
                  "capture_trace_mb": (Path(captures[0]["logdir"]) / "trace.json").stat().st_size
                  / 2**20,
                  "artifact_mb": {p.name: p.stat().st_size / 2**20 for p in obs_dir.iterdir()
                                  if p.is_file()}}

    # ---- 4. the snapshot through the recommend CLI, against the plain route
    art = root / "UserData"
    _write_artifacts(data, art)
    (art / "token_states.npy").hardlink_to(_token_file(state, args, tokens, out))
    tower, table = trainer.export_for_serving()
    users = recommend.collect_histories(data, H)
    uids = sorted(users)[: args.family_rec_users]
    recs = root / "recs.jsonl"
    err = io.StringIO()
    t0 = time.perf_counter()
    with launches.segment(), contextlib.redirect_stderr(err):
        rc = recommend.main(["--data-dir", str(art), "--snapshot-dir", str(snaps), "--out",
                             str(recs), "--device", DEV, "--uids", *uids])
    rec_s = time.perf_counter() - t0
    check(rc == 0, f"recommend CLI rc {rc}: {err.getvalue()[-2000:]}")
    lines = [json.loads(ln) for ln in recs.read_text().splitlines()]
    check([ln["uid"] for ln in lines] == uids, f"{len(lines)} lines for {len(uids)} users")
    sample = lines[:: max(1, len(lines) // 256)][:256]
    hist_ids = torch.tensor([[data.nid2index[n] for n in users[ln["uid"]]]
                             + [0] * (H - len(users[ln["uid"]])) for ln in sample], device=dev)
    plain_tower = copy.deepcopy(tower)
    plain_tower.pool.use_pallas = False
    with torch.no_grad():
        n = table.shape[0]
        user = plain_tower(table[hist_ids.clamp(0, n - 1)])
        scores = user.float() @ table.float().T
        invalid = torch.zeros_like(scores, dtype=torch.bool)
        invalid[:, 0] = True
        invalid[torch.arange(len(sample), device=dev)[:, None], hist_ids] = True
        ref_scores, ref_ids = torch.topk(scores.masked_fill(invalid, torch.finfo(torch.float32).min),
                                         11, dim=1)
    got = torch.tensor([[data.nid2index[n] for n in ln["news"]] for ln in sample], device=dev)
    mismatch = _topk_disagreements(got, ref_scores, ref_ids, 10)
    check(mismatch == 0, f"{mismatch} recommended ids differ from the plain route's")
    out["recommend_cli"] = {"rc": rc, "users": len(lines), "wall_s": rec_s,
                            "users_per_s": len(lines) / rec_s, "id_mismatches": mismatch,
                            "checked_users": len(sample)}
    (art / "token_states.npy").unlink()
    # where a GRU + CNN 4-client step's device time goes (profiler; one more
    # step of the first batch, after the checks that read the trained state)
    b0 = next(iter(trainer.batcher.epoch_batches_sharded(K, 0)))
    b0 = {k: torch.as_tensor(getattr(b0, k)).to(dev) for k in ("candidates", "history", "labels")}
    step_fn = trainer.train_step
    out["joint"]["step_device_breakdown"] = _device_breakdown(
        lambda: step_fn(trainer.states, b0, tokens)[1]["loss"].tolist(), reps=2, top=10,
        sum_of={"gemm": ["gemm", "Gemm", "sm90_", "cutlass"],
                "kernel_A": ["pool_logits_kernel", "pool_rows_kernel"]})
    del trainer, tower, table, m0, th, ue
    torch.cuda.empty_cache()

    # ---- 5. the CNN head under an MHA tower with fuse_hot_path: B and E
    # on the user tower, the CNN head's dense gather + encode (no C, D)
    cfg = _family_cfg(args, "", "model.user_tower=mha", "model.fuse_hot_path=true",
                      "fed.rounds=1", "train.eval_every=1")
    seg_counts = _PathLaunches()
    with launches.segment(), seg_counts.segment(), quiet:
        fused = Trainer(cfg, data, tokens, device=dev)
        fhist = fused.run()
    fc = seg_counts.total
    check(math.isfinite(fhist[0].train_loss), f"fused CNN leg loss {fhist[0].train_loss}")
    check(fc.get("fused_history_score_bwd", 0) >= K * S and fc.get("fused_history_score", 0) > 0
          and fc.get("additive_pool", 0) > 0, f"fused CNN leg launches {fc}")
    check(fc.get("fused_gather_encode", 0) == 0 and fc.get("fused_gather_encode_bwd", 0) == 0,
          f"C or D launched under the CNN head: {fc}")
    mf = fused.states[0].model
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    with torch.no_grad():
        ftable = fused._encode_corpus(0)
        b0 = next(iter(fused.batcher.epoch_batches_sharded(K, 0)))
        cand_v = ftable[torch.as_tensor(b0.candidates[0], device=dev).long()]
        his_v = ftable[torch.as_tensor(b0.history[0], device=dev).long()]
        w = mf.user_encoder.fused_weights(torch.float32)
        nh = mf.cfg.num_heads
        sk, uk = fused_history_score(his_v, cand_v, None, w, nh)
        sp, up = fused_history_score_plain(his_v, cand_v, None, w, nh)
        err_b = max(max_err(sk, sp), max_err(uk, up))
    gs = torch.randn(tuple(sk.shape), generator=gen, device=dev)
    gu = torch.randn(tuple(uk.shape), generator=gen, device=dev)
    got_e = fused_history_score_bwd(his_v, cand_v, None, w, gs, gu, nh)
    want_e = fused_history_score_bwd_plain(his_v, cand_v, None, w, gs, gu, nh)
    # every output against the exact answer (float64), at E_PLAIN_FACTOR x
    # the plain f32 route's error or GRAD_REL of its own scale; dbk's true
    # value is zero (a softmax-row shift), so its bar is the plain route's
    ref_e = _tower_bwd_f64(his_v, cand_v, w, gs, gu, nh)
    names = ["dx", "dcand", *[f"d{f}" for f in w._fields]]
    e_rows = {}
    for name, a, b_, r in zip(names, [got_e[0], got_e[1], *got_e[2]],
                              [want_e[0], want_e[1], *want_e[2]],
                              [ref_e[0], ref_e[1], *ref_e[2]]):
        scale = float(r.abs().max())
        e_k, e_p = (float((t.double() - r).abs().max()) for t in (a, b_))
        bar = max(E_PLAIN_FACTOR * e_p, GRAD_REL["float32"] * scale)
        e_rows[name] = {"scale": scale, "kernel_vs_f64": e_k, "plain_vs_f64": e_p,
                        "kernel_vs_plain": max_err(a, b_), "bar": bar, "ok": e_k <= bar}
    err_e = max(r["kernel_vs_plain"] for r in e_rows.values())
    check(err_b <= F32_ATOL and all(r["ok"] for r in e_rows.values()),
          f"fused CNN leg vs plain: B {err_b}, E {[(k, r) for k, r in e_rows.items()]}")
    errs["fused_history_score"], errs["fused_history_score_bwd"] = err_b, err_e
    # the leg against the dense route (no kernel) from the same seeds: its
    # round loss, validation means and final parameters at the trajectory
    # bars, so that what B and E give the user tower reaches training intact
    dense_cfg = _family_cfg(args, "", "model.user_tower=mha", "model.fuse_hot_path=false",
                            "model.use_pallas=false", "fed.rounds=1", "train.eval_every=1")
    dense_counts = _PathLaunches()
    with dense_counts.segment(), quiet:
        dense = Trainer(dense_cfg, data, tokens, device=dev)
        dense_hist = dense.run()
    check(not any(dense_counts.total.values()),
          f"the fused CNN leg's dense route launched {dense_counts.total}")
    lk, ld = fhist[0].train_loss, dense_hist[0].train_loss
    check(math.isclose(lk, ld, rel_tol=TRAJ_LOSS_RTOL, abs_tol=TRAJ_LOSS_ATOL),
          f"fused CNN leg: kernel-route loss {lk!r} vs dense {ld!r}")
    val_diff = max(abs(v - dense_hist[0].val_metrics[k]) for k, v in fhist[0].val_metrics.items())
    check(val_diff <= VAL_ATOL, f"fused CNN leg: validation means differ by {val_diff}")
    param_worst, param_worst_noise = 0.0, 0.0
    for c, (sk, sd) in enumerate(zip(fused.states, dense.states)):
        bad, worst, worst_noise = _param_diffs(sk.model, sd.model)
        check(not bad, f"fused CNN leg, client {c}: kernel route vs dense: {bad} outside the bars")
        param_worst = max(param_worst, worst)
        param_worst_noise = max(param_worst_noise, worst_noise)
    del dense
    out["fused_cnn_leg"] = {"loss": fhist[0].train_loss, "val_metrics": fhist[0].val_metrics,
                            "kernel_vs_dense": {"losses": [lk, ld], "max_val_metric_diff": val_diff,
                                                "max_param_diff": param_worst,
                                                "max_zero_grad_leaf_diff": param_worst_noise},
                            "launches": fc, "max_abs_err_vs_plain": {
                                "fused_history_score": err_b, "fused_history_score_bwd": err_e},
                            "e_vs_f64": e_rows}
    del fused, mf, ftable
    torch.cuda.empty_cache()

    # ---- 6. one decoupled round: the CNN head's chunked corpus re-encode
    cfg = _family_cfg(args, "", "model.text_encoder_mode=table", "fed.rounds=1",
                      "train.eval_every=1")
    upd_ms: list = []
    with launches.segment(), quiet:
        dec = Trainer(cfg, data, tokens, device=dev)
        _time_calls(dec, "news_update", upd_ms)
        dhist = dec.run()
    check(math.isfinite(dhist[0].train_loss) and dec._table is not None
          and dec._table.shape == (args.num_news, D) and bool(torch.isfinite(dec._table).all()),
          f"decoupled GRU + CNN round: loss {dhist[0].train_loss}")
    out["decoupled"] = {"loss": dhist[0].train_loss, "val_metrics": dhist[0].val_metrics,
                        "news_update_ms": upd_ms, "chunk": 2048}
    del dec
    torch.cuda.empty_cache()

    # ---- 7. a nan chaos run on a small catalog (its table fits the dump's
    # 512 MB), replayed on the card from the flight recorder's dump
    small_n = args.family_chaos_news
    small = make_synthetic_mind(num_news=small_n, num_train=K * B * 2, num_valid=256,
                                title_len=T, seed=args.seed + 1)
    nan_dir = root / "obs_nan"
    cfg = _family_cfg(args, "", "fed.rounds=3", "train.eval_every=10", f"obs.dir={nan_dir}",
                      "chaos.enabled=true", "chaos.faults=nan@1:1")
    prev = set_registry(MetricsRegistry()), set_tracer(Tracer())
    raised = None
    try:
        with launches.segment(), quiet:
            try:
                Trainer(cfg, small, tokens[:small_n], device=dev).run()
            except TrainingHealthError as e:
                raised = str(e)
    finally:
        set_registry(prev[0])
        set_tracer(prev[1])
    check(raised is not None and "Forensics dumped to" in raised, f"nan run: {raised}")
    manifest = json.loads((nan_dir / "flightrec" / "manifest.json").read_text())
    check(manifest["table_file"] == "table.npy" and manifest["trigger"]["round"] == 1,
          f"dump manifest: {manifest.get('table_file')}, {manifest.get('trigger')}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with launches.segment(), contextlib.redirect_stdout(buf):
        rc = obs_cli.main(["replay", str(nan_dir), "--device", DEV, "--json"])
    verdict = json.loads(buf.getvalue())
    check(rc == 0 and verdict["reproduced_nonfinite"] and verdict["device"].startswith("cuda"),
          f"replay rc {rc}: {verdict.get('first_nonfinite')}")
    out["chaos_replay"] = {"catalog": small_n, "dump_mb": sum(
        f.stat().st_size for f in (nan_dir / "flightrec").iterdir()) / 2**20,
        "replay_s": time.perf_counter() - t0, "steps_replayed": verdict["steps_replayed"],
        "first_nonfinite": verdict["first_nonfinite"]}

    counts = launches.total
    for name in ("additive_pool", "fused_history_score", "fused_history_score_bwd"):
        check(counts.get(name, 0) > 0, f"kernel {name} never launched on the family path")
    state.setdefault("launches", {})["family_path"] = counts
    state.setdefault("family_errs", {}).update(errs)
    out["launches"] = counts
    out["max_abs_err_vs_plain"] = errs
    out["config"] = {"num_news": args.num_news, "news_dim": D, "bert_hidden": Dh,
                     "his_len": H, "title_len": T, "cnn_kernel": base.model.cnn_kernel,
                     "dtype": base.model.dtype, "tf32": False, "valid": args.valid}
    work.cleanup()
    return out


# ---------------------------------------------------------- coordinator_path
# coordinator_path: the reference deployment's rounds (more would cost a
# process start-up's worth each) and the codec legs' rounds
COORD_ROUNDS = 3
COORD_CODEC_ROUNDS = 2
# the wall limit of one world: no worker may hang the phase
COORD_WORLD_TIMEOUT_S = 420


def _coord_sets(args, *overrides: str) -> list[str]:
    """The coordinator path's ``--set`` flags: ExperimentConfig's widths,
    joint mode on the fused kernel route (the ``--mode joint`` flag), one
    full-pool evaluation at the end of round ``COORD_ROUNDS - 1``."""
    return ["model.fuse_hot_path=true", "model.use_pallas=true", f"train.seed={args.seed}",
            f"train.eval_every={COORD_ROUNDS}", "train.eval_protocol=full", *overrides]


def _coord_argv(args, art: Path, snaps: Path, rounds: int, *sets: str) -> list[str]:
    flags = [x for kv in _coord_sets(args, *sets) for x in ("--set", kv)]
    return [str(rounds), str(args.batch_size), "1", "--data-dir", str(art), "--device", DEV,
            "--clients", str(args.clients), "--mode", "joint", *flags,
            "--set", f"train.snapshot_dir={snaps}"]


def _coord_world(argv: list[str], n: int, logs: Path, name: str, flags=None,
                 supervise: bool = False, timeout_s: float = COORD_WORLD_TIMEOUT_S) -> dict:
    """``n`` coordinator processes of one world on 127.0.0.1, under one wall
    limit; their exit codes, outputs and reports. Process ``i`` gets
    ``flags(i)``, by default a fixed world's rendezvous on a free port.
    ``supervise`` runs each under ``--supervise`` in a session of its own
    (a supervisor and its worker are killed together), its log holding
    every incarnation's lines."""
    import os

    from fedrec_tpu_torch.parallel.membership import free_port

    if flags is None:
        port = free_port()

        def flags(i: int) -> list[str]:
            return ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
                    "--process-id", str(i)]
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    if supervise:
        env["FEDREC_SUPERVISE_MAX"] = "12"
    files = [logs / f"{name}_p{i}.log" for i in range(n)]
    t0 = time.perf_counter()
    procs = []
    for i, path in enumerate(files):
        with open(path, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "fedrec_tpu_torch.cli.coordinator", *argv,
                 *(["--supervise"] if supervise else []), *flags(i)], cwd=root, env=env,
                stdout=fh, stderr=subprocess.STDOUT, start_new_session=supervise))
    try:
        for p in procs:
            p.wait(timeout=max(timeout_s - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"{name}: a coordinator process outlived {timeout_s} s: "
                           f"{[f.read_text()[-1500:] for f in files]}")
    finally:
        for p in procs:
            if supervise:
                _stop_group(p)
            elif p.poll() is None:
                p.kill()
                p.wait()
    outs = [f.read_text() for f in files]
    reports = [[json.loads(ln.split("[coordinator] report ", 1)[1]) for ln in o.splitlines()
                if ln.startswith("[coordinator] report ")] for o in outs]
    return {"rcs": [p.returncode for p in procs], "outs": outs, "reports": reports,
            "wall_s": time.perf_counter() - t0}


def _coord_emulate(argv: list[str], tokens, procs: int, server_trains: bool, rounds: int):
    """The world's rounds in this process (``cli.coordinator.emulate_world``):
    one ``Trainer`` a training process on its shard, over the same token
    states (on the card, shared)."""
    import torch
    from fedrec_tpu_torch.cli import coordinator as coord
    from fedrec_tpu_torch.data import load_mind_artifacts
    from fedrec_tpu_torch.train import Trainer

    args = coord._build_parser().parse_args(argv)
    dev = torch.device(DEV)
    shards = procs if server_trains else procs - 1
    data = load_mind_artifacts(args.data_dir)
    trainers = [] if server_trains else [None]
    for i in range(shards):
        c = coord.config_from_args(args, dev)
        c.train.snapshot_dir = ""
        c.data.num_shards, c.data.shard_index = shards, i
        trainers.append(Trainer(c, data, tokens, device=dev))
    cfg = coord.config_from_args(args, dev)
    with contextlib.redirect_stdout(sys.stderr):
        globals_, losses = coord.emulate_world(trainers, cfg, range(rounds))
    del trainers
    torch.cuda.empty_cache()
    return globals_, losses, cfg


def _coord_hold(world: dict, snaps: Path, emulated, cfg, rounds: list[int]) -> dict:
    """Each round's server global and the clients' round losses against the
    emulation, at the trajectory bars; whether every global is bitwise."""
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import from_flax
    from fedrec_tpu_torch.train.checkpoint import load_state_bytes

    globals_, losses = emulated
    worst, bitwise = 0.0, True
    for r in rounds:
        snap = load_state_bytes((snaps / f"global_round_{r}.pt").read_bytes())
        model = NewsRecommender(cfg.model)
        from_flax(model.user_encoder, globals_[r][0])
        from_flax(model.news_tower, globals_[r][1])
        for part, module in (("user_params", model.user_encoder),
                             ("news_params", model.news_tower)):
            for name, p in module.named_parameters():
                got, want = snap[part][name].numpy(), p.detach().numpy()
                d = float(np.abs(got - want).max())
                worst = max(worst, d)
                bitwise &= bool(np.array_equal(got, want))
                if name.endswith(ZERO_GRAD_LEAVES):
                    check(d <= TRAJ_NOISE, f"round {r} global {part}.{name} off by {d}")
                else:
                    check(bool(np.all(np.abs(got - want) <= TRAJ_ATOL + TRAJ_RTOL * np.abs(want))),
                          f"round {r} global {part}.{name} off the emulation by {d}")
    for p, reps in enumerate(world["reports"]):
        if not reps or not reps[-1]["trains"]:
            continue
        got = reps[-1]["losses"]
        want = [losses[r][p] for r in range(len(got))]
        check(bool(np.allclose(got, want, rtol=TRAJ_LOSS_RTOL, atol=TRAJ_LOSS_ATOL)),
              f"process {p} round losses {got} vs the emulation's {want}")
    return {"max_abs_diff": worst, "bitwise": bitwise}


def _coord_leg_summary(world: dict, dense_bytes: int, rounds: int) -> dict:
    """Per process: rounds, round / fan-out / gather ms, bytes, peak device
    memory, the kernels' launches."""
    procs = []
    for p, reps in enumerate(world["reports"]):
        check(bool(reps), f"process {p} printed no report (rc {world['rcs'][p]})")
        r = reps[-1]
        procs.append({
            "process": p, "trains": r["trains"], "rc": world["rcs"][p],
            "round_ms": r["round_ms"], "sync_from_server_ms": r["sync_from_server_ms"],
            "aggregate_ms": r["aggregate_ms"], "aggregate_parts_ms": r["aggregate_parts_ms"],
            "bytes_up": r["bytes_up"],
            "bytes_down": r["bytes_down"], "peak_gpu_mb": r["peak_gpu_mb"],
            "launches": {KERNEL_LETTER[k]: v for k, v in r["launches"].items() if v},
            "compression_ratio_measured": (rounds * dense_bytes / r["bytes_up"]
                                           if r["bytes_up"] else None),
            "tier_reduce_ms": r["tier_reduce_ms"], "degraded": r["degraded"]})
    return {"wall_s": world["wall_s"], "server_round_ms": procs[0]["round_ms"],
            "processes": procs}


def _coord_check_launches(world: dict, k: int, steps: int, counts: dict) -> None:
    """Every training process launched C, D, B and E at least K times a
    step; the launches add up into the path's counts."""
    for p, reps in enumerate(world["reports"]):
        for r in reps:
            for name, n in r["launches"].items():
                counts[name] = counts.get(name, 0) + n
        last = reps[-1]
        if last["trains"] and not last["degraded"]:
            for name in ("fused_gather_encode", "fused_gather_encode_bwd",
                         "fused_history_score", "fused_history_score_bwd"):
                want = k * steps * len(last["rounds"])
                check(last["launches"][name] >= want,
                      f"process {p} launched {name} {last['launches'][name]} times, "
                      f"under K x steps = {want}")


def phase_coordinator_path(state: dict, args) -> dict:
    """The coordinator deployment at full width: real processes of
    ``fedrec_tpu_torch.cli.coordinator`` on 127.0.0.1, every one on this card,
    the gloo wire over host buffers.

    1. the reference deployment: 3 processes (the server does not train), 3
       rounds of K x 4 steps at B on each client's shard (2,049 rows dealt
       1,025 / 1,024, ``fed.weight_by_samples``), ``save_every`` 1, one
       full-pool evaluation; every round's global held to the in-process
       emulation (the two shards' ``Trainer``s here, the same reduction),
       the bytes on the wire to the dense tree's, then the last global
       served through ``load_checkpoint_params`` and the recommend CLI over
       ``--coord-rec-users`` users against the plain route;
    2. codecs: the same world for 2 rounds under topk (ratio 0.01, error
       feedback) and countsketch (width 0.1), each against the emulation
       through the same codec, the compression measured from the shipped
       bytes, the residual sidecars written;
    3. robust and hierarchical: 3 processes with ``--server-trains``,
       trimmed_mean (trim_k 1), ``agg.mode=hierarchical`` (fanout 2) over
       the int8 codec (its compression measured as in 2), against the
       emulation; ``agg.tier_reduce_ms``;
    4. a host fault: ``chaos.kill_process=2`` at ``kill_round=1`` with
       ``--collective-timeout 30``: the killed process exits 137, the
       survivors degrade, the client re-executes itself standalone and
       finishes, every process under a wall limit.
    """
    import copy
    import tempfile

    import torch
    from fedrec_tpu_torch.cli import coordinator as coord
    from fedrec_tpu_torch.cli import recommend
    from fedrec_tpu_torch.comms import tree_dense_nbytes
    from fedrec_tpu_torch.data import MindData, make_synthetic_mind
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import init_params, to_flax
    from fedrec_tpu_torch.serving import load_checkpoint_params, restore_model
    from fedrec_tpu_torch.train import encode_all_news

    dev = torch.device(DEV)
    K, B, S = args.clients, args.batch_size, args.trainer_steps
    base = coord.config_from_args(coord._build_parser().parse_args(
        _coord_argv(args, Path("."), Path("."), 1)), dev)
    T, H, Dh = base.data.max_title_len, base.data.max_his_len, base.model.bert_hidden
    tokens = _tokens(state, args, T, Dh)
    rows = K * B * S
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(prefix="coordinator_path_", dir=build)
    root = Path(work.name)
    logs = root / "logs"
    logs.mkdir()
    out: dict = {"clients": K, "batch_size": B, "steps": S, "num_news": args.num_news,
                 "news_dim": base.model.news_dim, "bert_hidden": Dh, "dtype": "float32",
                 "tf32": False}
    # two artifact dirs over one token file: 2 training shards of K x B x S
    # rows (one more row in the first, so the sample weights differ) and 3
    data3 = make_synthetic_mind(num_news=args.num_news, num_train=3 * rows + 1,
                                num_valid=args.coord_valid, title_len=T, seed=args.seed)
    data2 = MindData(data3.news_tokens, data3.nid2index, data3.train_samples[: 2 * rows + 1],
                     data3.valid_samples)
    art2, art3 = root / "UserData2", root / "UserData3"
    _write_artifacts(data2, art2)
    _write_artifacts(data3, art3)
    for art in (art2, art3):
        (art / "token_states.npy").hardlink_to(_token_file(state, args, tokens, out))
    dense = tree_dense_nbytes((to_flax(init_params(NewsRecommender(base.model)).user_encoder),
                               to_flax(init_params(NewsRecommender(base.model)).news_tower)))
    out["dense_tree_bytes"] = dense
    counts: dict = {}
    torch.cuda.empty_cache()
    peak_before = torch.cuda.memory_allocated()

    # ---- 1. the reference deployment
    snaps = root / "ref"
    argv = _coord_argv(args, art2, snaps, COORD_ROUNDS, "fed.weight_by_samples=1")
    world = _coord_world(argv, 3, logs, "reference")
    check(world["rcs"] == [0, 0, 0], f"reference world rcs {world['rcs']}: "
                                     f"{[o[-1500:] for o in world['outs']]}")
    leg = _coord_leg_summary(world, dense, COORD_ROUNDS)
    _coord_check_launches(world, K, S, counts)
    check([p["trains"] for p in leg["processes"]] == [False, True, True], "roles")
    for p in leg["processes"]:
        check(p["bytes_up"] == COORD_ROUNDS * dense and p["bytes_down"] == COORD_ROUNDS * dense,
              f"process {p['process']} shipped {p['bytes_up']} up / {p['bytes_down']} down, "
              f"not {COORD_ROUNDS} x the dense tree's {dense}")
    samples = sorted(r[-1]["num_local_samples"] for r in world["reports"][1:])
    check(samples == [rows, rows + 1], f"shard sizes {samples}")
    em = _coord_emulate(argv, tokens, 3, False, COORD_ROUNDS)
    leg["vs_emulation"] = _coord_hold(world, snaps, em[:2], em[2], list(range(COORD_ROUNDS)))
    # the last global served: the store's loader, then the recommend CLI
    user_state, news_state, round_, kind = load_checkpoint_params(snaps)
    check((round_, kind) == (COORD_ROUNDS - 1, "coordinator"), f"served {kind} round {round_}")
    model = restore_model(base.model, user_state, news_state, dev)
    table = encode_all_news(model, tokens, device=dev)
    users = recommend.collect_histories(data2, H)
    uids = sorted(users)[: args.coord_rec_users]
    recs = root / "recs.jsonl"
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = recommend.main(["--data-dir", str(art2), "--snapshot-dir", str(snaps), "--out",
                             str(recs), "--device", DEV, "--uids", *uids])
    rec_s = time.perf_counter() - t0
    check(rc == 0, f"recommend CLI rc {rc}: {err.getvalue()[-2000:]}")
    check("serving coordinator snapshot" in err.getvalue(), "the CLI served no coordinator global")
    lines = [json.loads(ln) for ln in recs.read_text().splitlines()]
    check([ln["uid"] for ln in lines] == uids, f"{len(lines)} lines for {len(uids)} users")
    hist = torch.tensor([[data2.nid2index[n] for n in users[ln["uid"]]]
                         + [0] * (H - len(users[ln["uid"]])) for ln in lines], device=dev)
    ref_scores, ref_ids = _plain_scores(model.user_encoder, table, hist, 10)
    got = torch.tensor([[data2.nid2index[n] for n in ln["news"]] for ln in lines], device=dev)
    mismatch = _topk_disagreements(got, ref_scores, ref_ids, 10)
    check(mismatch == 0, f"{mismatch} recommended ids differ from the plain route's")
    leg["recommend_cli"] = {"rc": rc, "users": len(lines), "wall_s": rec_s,
                            "id_mismatches": mismatch}
    del model, table
    out["reference"] = leg

    # ---- 2. codecs
    out["codecs"] = {}
    # int8 rides the hierarchical world below: a world of its own cost ~21 s
    for codec, sets in (("topk", ["fed.dcn_compress=topk", "fed.dcn_topk_ratio=0.01",
                                  "fed.dcn_error_feedback=true"]),
                        ("countsketch", ["fed.dcn_compress=countsketch",
                                         "fed.dcn_sketch_width=0.1"])):
        snaps = root / codec
        argv = _coord_argv(args, art2, snaps, COORD_CODEC_ROUNDS, "fed.weight_by_samples=1",
                           *sets)
        world = _coord_world(argv, 3, logs, codec)
        check(world["rcs"] == [0, 0, 0], f"{codec} world rcs {world['rcs']}: "
                                         f"{[o[-1500:] for o in world['outs']]}")
        leg = _coord_leg_summary(world, dense, COORD_CODEC_ROUNDS)
        _coord_check_launches(world, K, S, counts)
        ratios = {p["compression_ratio_measured"] for p in leg["processes"]}
        check(len(ratios) == 1, f"{codec}: processes shipped different byte counts {ratios}")
        leg["compression_ratio"] = ratios.pop()
        if codec == "topk":
            sidecars = sorted(p.name for p in snaps.glob("codec_state_p*.npz"))
            check(sidecars == [f"codec_state_p{i}.npz" for i in range(3)],
                  f"residual sidecars {sidecars}")
            leg["residual_sidecars"] = sidecars
        em = _coord_emulate(argv, tokens, 3, False, COORD_CODEC_ROUNDS)
        leg["vs_emulation"] = _coord_hold(world, snaps, em[:2], em[2],
                                          list(range(COORD_CODEC_ROUNDS)))
        out["codecs"][codec] = leg

    # ---- 3. robust and hierarchical, the server training
    snaps = root / "hier"
    argv = _coord_argv(args, art3, snaps, COORD_CODEC_ROUNDS, "fed.dcn_compress=int8",
                       "fed.robust.method=trimmed_mean", "fed.robust.trim_k=1",
                       "agg.mode=hierarchical", "agg.tree_fanout=2")
    world = _coord_world([*argv, "--server-trains"], 3, logs, "hierarchical")
    check(world["rcs"] == [0, 0, 0], f"hierarchical world rcs {world['rcs']}: "
                                     f"{[o[-1500:] for o in world['outs']]}")
    leg = _coord_leg_summary(world, dense, COORD_CODEC_ROUNDS)
    _coord_check_launches(world, K, S, counts)
    check(all(p["trains"] for p in leg["processes"]), "every process trains")
    check(all((p["tier_reduce_ms"] or 0) > 0 for p in leg["processes"]),
          "agg.tier_reduce_ms not set")
    ratios = {p["compression_ratio_measured"] for p in leg["processes"]}
    check(len(ratios) == 1, f"int8: processes shipped different byte counts {ratios}")
    leg["compression_ratio"] = ratios.pop()
    out["codecs"]["int8"] = {"compression_ratio": leg["compression_ratio"],
                             "world": "hierarchical"}
    em = _coord_emulate(argv, tokens, 3, True, COORD_CODEC_ROUNDS)
    leg["vs_emulation"] = _coord_hold(world, snaps, em[:2], em[2],
                                      list(range(COORD_CODEC_ROUNDS)))
    out["hierarchical"] = leg

    # ---- 4. a host fault
    snaps = root / "kill"
    argv = _coord_argv(args, art2, snaps, COORD_ROUNDS, "chaos.enabled=1",
                       "chaos.kill_process=2", "chaos.kill_round=1")
    world = _coord_world([*argv, "--collective-timeout", "30"], 3, logs, "kill")
    check(world["rcs"] == [0, 0, 137], f"kill world rcs {world['rcs']}: "
                                       f"{[o[-1500:] for o in world['outs']]}")
    killed_at = (snaps / "chaos_killed_p2").stat().st_mtime
    server, client = world["reports"][0][-1], world["reports"][1]
    check(server["degraded"] and server["deadline_misses"] >= 1, "the server did not degrade")
    check(len(client) == 2 and client[0]["degraded"] and client[1]["standalone"]
          and client[1]["rounds"] == [1, 2], f"client 1's continuation: {client}")
    lags = [server["degraded_at"] - killed_at, client[0]["degraded_at"] - killed_at]
    check(max(lags) <= 30 + 10, f"survivors degraded {lags} s after the kill")
    _coord_check_launches({"reports": [world["reports"][1][1:]]}, K, S, counts)
    out["kill"] = {"rcs": world["rcs"], "wall_s": world["wall_s"],
                   "degrade_after_kill_s": lags,
                   "continuation_rounds": client[1]["rounds"],
                   "continuation_round_ms": client[1]["round_ms"],
                   "server_rounds": server["rounds"]}
    out["peak_gpu_mb_this_process"] = (torch.cuda.max_memory_allocated() - peak_before) / 2**20
    for name in ("fused_gather_encode", "fused_gather_encode_bwd", "fused_history_score",
                 "fused_history_score_bwd", "additive_pool"):
        check(counts.get(name, 0) > 0, f"{name} never launched on the coordinator path")
    state.setdefault("launches", {})["coordinator"] = counts
    out["launches"] = {KERNEL_LETTER[k]: v for k, v in counts.items() if v}
    work.cleanup()
    return out


# ------------------------------------------------------------- elastic_path
# (a) a fault-free membership world's rounds; (b) the kill leg's rounds: 2
# before the kill, then enough that the shrunk world is still running when
# the killed worker's holdoff ends, and that the regrown world runs more.
# The shrunk world's first round comes 13-22 s after the kill and its
# rounds take 0.6-1.0 s, so it runs 2-21 rounds before the knock at
# holdoff + ~2 s (11 and 15 in two runs at 24 s; at 25 s and 14 rounds it
# once finished the run before the knock): 26 rounds leave the regrown
# world at least 3
ELASTIC_FIXED_ROUNDS = 3
ELASTIC_KILL_ROUNDS = 26
ELASTIC_KILL_ROUND = 2
# the membership service's policy, as the JAX package's elastic smoke sets
# it: a 6 s lease, heartbeats a second apart, a 4 s grace. The lease must
# outlast a worker's restart at a reformation (its exit, the supervisor's
# ~1 s, an interpreter, the join: the worker joins before it imports torch),
# or the world re-forms without it. The killed worker's holdoff outlasts the
# survivors' shrink (its lease, a restart, the grace) and their bring-up
# with the token states (their first round 13.3-19.8 s after their start,
# 15.5-22 s after the kill), so the shrunk world runs rounds before the
# rejoin (the knock comes ~2 s after the holdoff: the respawn, an
# interpreter): 24 s leaves it at least ~4 s of rounds, 30 s left it 10.
ELASTIC_LEASE_MS, ELASTIC_HEARTBEAT_MS, ELASTIC_GRACE_MS = 6000, 1000, 4000
ELASTIC_HOLDOFF_S = 24
ELASTIC_WORLD_TIMEOUT_S = 360


def _token_file(state: dict, args, tokens, out: dict) -> Path:
    """The token states as one ``.npy`` under ``build/``, written once a run
    for every path that reads them from disk (the paths hard-link it) and
    removed at the end of the run. The phase that writes it reports the
    write's seconds in its ``out`` (``token_states_write_s``)."""
    if "token_file" not in state:
        build = Path(__file__).resolve().parent / "build"
        build.mkdir(exist_ok=True)
        path = build / f"token_states_{args.num_news}_{args.seed}.npy"
        out["token_states_write_s"] = _write_token_states(tokens, path, args.chunk)
        state["token_file"] = path
    return state["token_file"]


def _membership_service(port: int, target: int, obs_dir: Path, log: Path):
    """The standalone service (``python -m fedrec_tpu_torch.parallel.membership``)
    with the path's policy, in a session of its own; returns the process once
    it serves."""
    import os

    root = Path(__file__).resolve().parent
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fedrec_tpu_torch.parallel.membership", f"127.0.0.1:{port}",
             "--target-world", str(target), "--lease-ms", str(ELASTIC_LEASE_MS),
             "--heartbeat-ms", str(ELASTIC_HEARTBEAT_MS),
             "--formation-grace-ms", str(ELASTIC_GRACE_MS), "--obs-dir", str(obs_dir)],
            cwd=root, env=dict(os.environ, PYTHONPATH=str(root)), stdout=fh,
            stderr=subprocess.STDOUT, start_new_session=True)
    deadline = time.perf_counter() + 60
    while "serving on" not in log.read_text():
        check(proc.poll() is None and time.perf_counter() < deadline,
              f"the membership service did not start: {log.read_text()[-2000:]}")
        time.sleep(0.2)
    return proc


def _stop_group(proc, sig=None) -> None:
    """Signal ``proc``'s whole session (a supervisor and its worker), then
    reap it."""
    import os
    import signal

    if proc.poll() is None:
        try:
            os.killpg(proc.pid, sig or signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()


def _round_logs(out: str) -> list[dict]:
    """The round records a coordinator worker's log prints
    (``[coordinator] process P {json}``)."""
    recs = []
    for ln in out.splitlines():
        if ln.startswith("[coordinator] process ") and " {" in ln:
            try:
                recs.append(json.loads(ln[ln.index("{"):]))
            except json.JSONDecodeError:
                continue
    return recs


def _saved_globals(outs: list[str]) -> list[int]:
    """The rounds whose global a server saved, once a save, over every
    incarnation's log."""
    return sorted(int(ln.rsplit("global_round_", 1)[1].split(".")[0])
                  for o in outs for ln in o.splitlines() if "saved global_round_" in ln)


def _globals_bitwise(a: Path, b: Path, rounds) -> bool:
    """Two worlds' server globals of ``rounds`` bitwise equal."""
    from fedrec_tpu_torch.train.checkpoint import load_state_bytes

    for r in rounds:
        x = load_state_bytes((a / f"global_round_{r}.pt").read_bytes())
        y = load_state_bytes((b / f"global_round_{r}.pt").read_bytes())
        for part in ("user_params", "news_params"):
            if x[part].keys() != y[part].keys() or not all(
                    bool((x[part][k] == y[part][k]).all()) for k in x[part]):
                return False
    return True


def _formation_ms(trace_path: Path) -> list[dict]:
    """Each epoch's formation from the service's trace, in milliseconds
    from the first join after the previous formation (a rejoin's knock, a
    survivor's return) and from the last lease expiry before it (what a
    shrink waits for)."""
    events = json.loads(trace_path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    out, first_join, last_expiry = [], None, None
    for ev in sorted((e for e in events if e.get("name", "").startswith("membership_")),
                     key=lambda e: e["ts"]):
        if ev["name"] == "membership_epoch_formed":
            a = ev.get("args", {})
            out.append({"epoch": a.get("epoch"), "world": a.get("world"),
                        "ms_from_first_join": (ev["ts"] - first_join) / 1e3
                        if first_join is not None else None,
                        "ms_from_lease_expiry": (ev["ts"] - last_expiry) / 1e3
                        if last_expiry is not None else None})
            first_join = last_expiry = None
        elif ev["name"] == "membership_worker_join" and first_join is None:
            first_join = ev["ts"]
        elif ev["name"] == "membership_lease_expired":
            last_expiry = ev["ts"]
    return out


def _incarnations(world: dict) -> list[dict]:
    """Every worker incarnation's report, with what the path prints of it."""
    rows = []
    for w, reps in enumerate(world["reports"]):
        for r in reps:
            first = r.get("first_round_at")
            rows.append({
                "worker": w, "epoch": r["epoch"], "world": r["world"], "rounds": r["rounds"],
                "start_to_first_round_s": (first - r["started_at"]) if first else None,
                "start_to_join_s": (r["joined_at"] - r["started_at"]) if r.get("joined_at")
                else None,
                "restore_ms": r["restore_ms"], "handoff_save_ms": r["handoff_save_ms"],
                "reformed": r["reformed"], "degraded": r["degraded"],
                "peak_gpu_mb": r["peak_gpu_mb"], "round_ms": r["round_ms"],
                "launches": {KERNEL_LETTER[k]: v for k, v in r["launches"].items() if v}})
    return rows


def _elastic_check_launches(world: dict, k: int, b: int, counts: dict) -> None:
    """Every training incarnation launched C, D, B and E at least K x steps
    a round (its shard's steps), and its counts add into the path's."""
    for reps in world["reports"]:
        for r in reps:
            for name, n in r["launches"].items():
                counts[name] = counts.get(name, 0) + n
            if not r["trains"] or not r["rounds"]:
                continue
            steps = (r["num_local_samples"] // k) // b
            want = k * steps * len(r["rounds"])
            for name in ("fused_gather_encode", "fused_gather_encode_bwd",
                         "fused_history_score", "fused_history_score_bwd"):
                check(r["launches"][name] >= want,
                      f"worker {r['worker']} epoch {r['epoch']} launched {name} "
                      f"{r['launches'][name]} times, under K x steps = {want}")


def phase_elastic_path(state: dict, args) -> dict:
    """Elastic membership and the supervisor at full width: the standalone
    membership service and supervised ``fedrec_tpu_torch.cli.coordinator``
    workers (``--supervise --membership``, ``--server-trains``) on
    127.0.0.1, every one on this card, the token states memory-mapped.

    (a) fault-free: a membership world of 3 for ``ELASTIC_FIXED_ROUNDS``
        rounds, every round's global bitwise the fixed world's (the same
        argv without the service) and the in-process emulation's;
    (b) kill, shrink, rejoin: a world of 4; worker 2 dies at round
        ``ELASTIC_KILL_ROUND``, the survivors re-form at 3 and train, worker
        2 holds off ``ELASTIC_HOLDOFF_S`` then rejoins, and the world
        re-forms at 4 and finishes ``ELASTIC_KILL_ROUNDS`` rounds with a
        full-pool evaluation: epoch history [4, 3, 4], one shrink, one
        rejoin, a round at world 3, every round's global written once, the
        evaluation in [0, 1], C, D, B and E launched in every training
        incarnation. Printed: each epoch's formation time, each
        incarnation's start to first round, hand-off save and restore,
        rounds at each world, peak device memory."""
    import signal
    import tempfile

    import torch
    from fedrec_tpu_torch.data import make_synthetic_mind
    from fedrec_tpu_torch.parallel.membership import MembershipClient, free_port

    K, B = args.clients, args.batch_size
    steps = 2
    base = _coord_sets(args)
    from fedrec_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig().apply_overrides(base)
    T, Dh = cfg.data.max_title_len, cfg.model.bert_hidden
    tokens = _tokens(state, args, T, Dh)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(prefix="elastic_path_", dir=build)
    root = Path(work.name)
    logs = root / "logs"
    logs.mkdir()
    # 3 shards of K x B x steps rows (one more in the first: weight_by_samples)
    rows = K * B * steps
    data = make_synthetic_mind(num_news=args.num_news, num_train=3 * rows + 1,
                               num_valid=args.coord_valid, title_len=T, seed=args.seed)
    art = root / "UserData"
    _write_artifacts(data, art)
    out: dict = {"clients": K, "batch_size": B, "steps_at_world_3": steps,
                 "num_news": args.num_news, "policy": {
                     "lease_ms": ELASTIC_LEASE_MS, "heartbeat_ms": ELASTIC_HEARTBEAT_MS,
                     "formation_grace_ms": ELASTIC_GRACE_MS, "rejoin_delay_s": ELASTIC_HOLDOFF_S}}
    (art / "token_states.npy").hardlink_to(_token_file(state, args, tokens, out))
    counts: dict = {}

    def membership_world(argv, n, name, target):
        port = free_port()
        svc = _membership_service(port, target, root / f"{name}_service_obs",
                                  logs / f"{name}_service.log")
        try:
            world = _coord_world(argv, n, logs, name, lambda i: [
                "--membership", f"127.0.0.1:{port}", "--process-id", str(i),
                "--collective-timeout", "30"], supervise=True, timeout_s=ELASTIC_WORLD_TIMEOUT_S)
            world["status"] = MembershipClient(f"127.0.0.1:{port}", "_smoke").status()
        finally:
            # SIGTERM: the service dumps its trace on the way out
            _stop_group(svc, signal.SIGTERM)
        world["formations"] = _formation_ms(root / f"{name}_service_obs" / "trace.json")
        return world

    # ---- (a) fault-free: the membership world, the fixed world, the emulation
    snaps_m, snaps_f = root / "a_membership", root / "a_fixed"
    sets = ["fed.weight_by_samples=1"]
    argv_m = [*_coord_argv(args, art, snaps_m, ELASTIC_FIXED_ROUNDS, *sets), "--server-trains"]
    world = membership_world(argv_m, 3, "fault_free", 3)
    check(world["rcs"] == [0, 0, 0], f"fault-free membership world rcs {world['rcs']}: "
                                     f"{[o[-1500:] for o in world['outs']]}")
    hist = [h["world"] for h in world["status"]["epoch_history"]]
    check(hist == [3], f"fault-free epoch history {hist}")
    _elastic_check_launches(world, K, B, counts)
    fixed = _coord_world([*_coord_argv(args, art, snaps_f, ELASTIC_FIXED_ROUNDS, *sets),
                          "--server-trains"], 3, logs, "fault_free_fixed")
    check(fixed["rcs"] == [0, 0, 0], f"fixed world rcs {fixed['rcs']}")
    _coord_check_launches(fixed, K, steps, counts)
    em = _coord_emulate(argv_m, tokens, 3, True, ELASTIC_FIXED_ROUNDS)
    rounds = list(range(ELASTIC_FIXED_ROUNDS))
    vs_em = _coord_hold(world, snaps_m, em[:2], em[2], rounds)
    check(vs_em["bitwise"], f"the membership world's globals are not the emulation's: {vs_em}")
    same = _globals_bitwise(snaps_m, snaps_f, rounds)
    check(same, "the membership world's globals are not the fixed world's")
    check(_saved_globals(world["outs"]) == rounds, "a fault-free global written twice or never")
    out["fault_free"] = {"wall_s": world["wall_s"], "fixed_wall_s": fixed["wall_s"],
                         "vs_emulation": vs_em, "bitwise_fixed_world": same,
                         "formations": world["formations"],
                         "incarnations": _incarnations(world)}
    del em

    # ---- (b) kill, shrink, rejoin: a world of 4
    snaps = root / "b_kill"
    argv = [*_coord_argv(args, art, snaps, ELASTIC_KILL_ROUNDS, *sets, "chaos.enabled=1",
                         "chaos.kill_process=2", f"chaos.kill_round={ELASTIC_KILL_ROUND}",
                         f"chaos.rejoin_delay_s={ELASTIC_HOLDOFF_S}",
                         f"train.eval_every={ELASTIC_KILL_ROUNDS}"), "--server-trains"]
    world = membership_world(argv, 4, "kill", 4)
    check(world["rcs"] == [0, 0, 0, 0], f"kill world rcs {world['rcs']}: "
                                        f"{[o[-2000:] for o in world['outs']]}")
    st = world["status"]
    hist = [h["world"] for h in st["epoch_history"]]
    check(hist == [4, 3, 4] and st["shrinks"] == 1 and st["rejoins"] == 1
          and st["lease_misses"] >= 1, f"membership status {st}")
    check(world["outs"][2].count(f"dying at round {ELASTIC_KILL_ROUND}") == 1,
          "the chaos kill did not fire once")
    check(f"holding off its rejoin {ELASTIC_HOLDOFF_S}s" in world["outs"][2],
          "the rejoin holdoff never applied")
    reps = [r for w in world["reports"] for r in w]
    at3 = sorted(x for r in reps if r["world"] == 3 for x in r["rounds"])
    check(bool(at3), "no round ran at world 3")
    check(_saved_globals(world["outs"]) == list(range(ELASTIC_KILL_ROUNDS)),
          f"globals saved {_saved_globals(world['outs'])}")
    finals = [w[-1] for w in world["reports"]]
    check(all(r["world"] == 4 and r["rounds"] and r["rounds"][-1] == ELASTIC_KILL_ROUNDS - 1
              for r in finals), "the regrown world did not finish")
    evals = [rec for rec in _round_logs(world["outs"][0]) if "auc" in rec]
    final_eval = evals[-1] if evals else {}
    metrics = {k: v for k, v in final_eval.items() if k not in ("round", "training_loss")}
    check(final_eval.get("round") == ELASTIC_KILL_ROUNDS - 1 and metrics
          and all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()),
          f"final evaluation {final_eval}")
    check(all(math.isfinite(x) for r in reps for x in r["losses"] if x is not None),
          "a non-finite round loss")
    _elastic_check_launches(world, K, B, counts)
    by_world: dict = {}
    for r in reps:
        by_world.setdefault(str(r["world"]), []).extend(r["rounds"])
    out["kill"] = {"wall_s": world["wall_s"], "status": st, "formations": world["formations"],
                   "rounds_by_world": {w: sorted(set(v)) for w, v in by_world.items()},
                   "final_eval": final_eval, "incarnations": _incarnations(world)}
    for name in ("fused_gather_encode", "fused_gather_encode_bwd", "fused_history_score",
                 "fused_history_score_bwd", "additive_pool"):
        check(counts.get(name, 0) > 0, f"{name} never launched on the elastic path")
    state.setdefault("launches", {})["elastic"] = counts
    out["launches"] = {KERNEL_LETTER[k]: v for k, v in counts.items() if v}
    work.cleanup()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- async_path
ASYNC_ROUNDS = 6
ASYNC_QUORUM = 3


def phase_async_path(state: dict, args) -> dict:
    """The in-process buffered quorum commit (``agg.mode=async``) at full
    width: the cohort path's population (``--cohort-population`` logical
    clients of ``--cohort-shard`` rows on K slots, dropout, lognormal
    stragglers, FedAvgM) without the round deadline, ``ASYNC_ROUNDS`` rounds
    synchronous (the barrier: the round waits for its slowest reporter),
    then the same rounds async at quorum ``ASYNC_QUORUM`` (the stragglers
    fold into the next commit, weighted 1 / (1 + staleness)): round times of
    both, each commit's ``agg.quorum_wait_ms`` and ``agg.gate_saved_ms``; a
    repeat, bitwise; the dense route against the kernel route at the train
    path's bars."""
    import torch
    from fedrec_tpu_torch.data import make_synthetic_mind
    from fedrec_tpu_torch.obs import MetricsRegistry, Tracer, set_registry, set_tracer
    from fedrec_tpu_torch.ops import launch_counts, reset_launch_counts
    from fedrec_tpu_torch.train import Trainer

    K, B, P = args.clients, args.batch_size, args.cohort_population
    dev = torch.device(DEV)
    # every sidecar resident (the cohort path measures the spills)
    rounds = [f"fed.rounds={ASYNC_ROUNDS}", f"train.eval_every={ASYNC_ROUNDS}",
              "fed.population.round_deadline_ms=0", "fed.population.min_reports=0",
              "fed.population.resident_cap=0"]
    async_over = ["agg.mode=async", f"agg.quorum={ASYNC_QUORUM}", "agg.staleness_cap=2"]
    cfg = _cohort_cfg(args, *rounds)
    tokens = _tokens(state, args, cfg.data.max_title_len, cfg.model.bert_hidden)
    data = make_synthetic_mind(num_news=args.num_news, num_train=P * args.cohort_shard,
                               num_valid=args.valid, title_len=cfg.data.max_title_len,
                               seed=args.seed)
    quiet = contextlib.redirect_stdout(sys.stderr)

    def run(*over):
        set_registry(MetricsRegistry())
        set_tracer(Tracer())
        with quiet:
            t = Trainer(_cohort_cfg(args, *rounds, *over), data, tokens, device=dev)
        clock = _Clock()
        clock.wrap(t, "train_round", "round")
        gauges: list = []
        round_fn = t.train_round

        def read_gauges(r):
            res = round_fn(r)
            gauges.append({k: t.registry.gauge(k).value() for k in (
                "agg.quorum_wait_ms", "agg.gate_saved_ms", "agg.buffer_pending",
                "agg.staleness")})
            return res

        t.train_round = read_gauges
        with quiet:
            hist = t.run()
        return t, hist, clock.ms["round"], gauges

    sync_t, sync_hist, sync_ms, _ = run()
    del sync_t
    torch.cuda.synchronize()
    reset_launch_counts()
    main, hist, round_ms, gauges = run(*async_over)
    torch.cuda.synchronize()
    launches = launch_counts()
    state.setdefault("launches", {})["async"] = launches
    reg = main.registry
    losses = [h.train_loss for h in hist]
    check(all(math.isfinite(v) for v in losses), f"non-finite async round loss {losses}")
    check(main._agg_version == ASYNC_ROUNDS, f"commit version {main._agg_version}")
    late = reg.counter("agg.late_folds_total").value()
    check(late > 0, "no late contribution folded")
    metrics = hist[-1].val_metrics
    check(metrics and all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()),
          f"final evaluation {metrics}")
    for name in ("fused_gather_encode", "fused_gather_encode_bwd", "fused_history_score",
                 "fused_history_score_bwd", "additive_pool"):
        check(launches.get(name, 0) > 0, f"{name} never launched on the async path")
    check(all(g["agg.quorum_wait_ms"] is not None and g["agg.gate_saved_ms"] is not None
              and g["agg.gate_saved_ms"] >= 0 for g in gauges), f"commit gauges {gauges}")

    again = run(*async_over)[0]
    repeat_ok = (again._agg_version == main._agg_version
                 and all(torch.equal(a, b) for a, b in zip(_trainer_params(main),
                                                           _trainer_params(again)))
                 and [(e.worker, e.based_on) for e in again.agg_buffer.entries]
                 == [(e.worker, e.based_on) for e in main.agg_buffer.entries])
    check(repeat_ok, "the async repeat differs")
    del again

    reset_launch_counts()
    dense, dense_hist, _, _ = run(*async_over, "model.fuse_hot_path=false",
                                  "model.use_pallas=false")
    check(not any(launch_counts().values()), "the dense route launched a kernel")
    traj = [(a.train_loss, b.train_loss) for a, b in zip(hist, dense_hist)]
    for r, (lk, ld) in enumerate(traj):
        check(math.isclose(lk, ld, rel_tol=TRAJ_LOSS_RTOL, abs_tol=TRAJ_LOSS_ATOL),
              f"round {r}: kernel-route loss {lk!r} vs dense {ld!r}")
    worst, worst_noise = 0.0, 0.0
    for c, (sk, sd) in enumerate(zip(main.states, dense.states)):
        bad, w, wn = _param_diffs(sk.model, sd.model)
        check(not bad, f"slot {c}: kernel vs dense route after {ASYNC_ROUNDS} async rounds: {bad}")
        worst, worst_noise = max(worst, w), max(worst_noise, wn)
    return {
        "config": {"population": P, "slots": K, "batch_size": B, "rounds": ASYNC_ROUNDS,
                   "quorum": ASYNC_QUORUM, "staleness_cap": 2,
                   "pop_straggle_ms": cfg.chaos.pop_straggle_ms,
                   "pop_drop_rate": cfg.chaos.pop_drop_rate, "server_opt": cfg.fed.server_opt},
        "round_ms": {"sync": sync_ms, "async": round_ms},
        "round_ms_median": {"sync": _median(sync_ms[:-1]), "async": _median(round_ms[:-1])},
        "commit_gauges": gauges,
        "commits": reg.counter("agg.commits_total").value(), "late_folds": late,
        "stale_drops": reg.counter("agg.stale_drops_total").value(),
        "losses": {"sync": [h.train_loss for h in sync_hist], "async": losses},
        "val_metrics": metrics, "repeat_bitwise": repeat_ok,
        "kernel_vs_dense": {"losses": traj, "max_param_diff": worst,
                            "max_zero_grad_leaf_diff": worst_noise},
        "launches": {KERNEL_LETTER[k]: v for k, v in launches.items() if v},
    }


# ---------------------------------------------------------------- wire_path
WIRE_ROUNDS = 4
# steps a round (1 client at B): four processes on the card take ~50 ms a
# step, so a round (~3 s) outlasts the straggler's one round and straggle
# (4 s) less than three times: held to the first commit, its round-0 push
# lands inside the others' run and its next after it
WIRE_STEPS = 64
WIRE_QUORUM, WIRE_WORLD = 3, 4
WIRE_STRAGGLER = 3
WIRE_STRAGGLE_MS = 4000
# rounds - 1: a fold in a run of WIRE_ROUNDS commits can never pass it (the
# JAX smoke's choice, 3 rounds at the default cap of 2)
WIRE_STALENESS_CAP = WIRE_ROUNDS - 1
# the fault and codec legs: 2 workers on a shard of this many steps
WIRE_SHORT_STEPS = 8
WIRE_CODEC_ROUNDS = 3
# the fault leg's least rounds; it runs enough more that the rounds after
# its fault windows outlast this many seconds (the second commit, the kill,
# the authority's restart, the circuit breaker's reset, a resync)
WIRE_FAULT_ROUNDS = 10
WIRE_RECOVERY_S = 8.0
# the fault leg's commit wait, which is also its breaker's reset window
WIRE_FAULT_WAIT_S = 1.0
# no fault window opens before this many seconds after a proxy's start: a
# worker's bootstrap (hello, the version-0 global) must pass, or it exits 75
WIRE_BOOTSTRAP_S = 2.0
WIRE_SKETCH_SEED = 7
WIRE_LEG_TIMEOUT_S = 300
# fleet observability over leg (a): the collector's straggler rule fires after
# this many consecutive breaching pushes; the authority's SLO over one of its
# agg.* gauges (a quorum wait under a minute: met); re-pushes of a worker's
# last snapshot that time a push
FLEET_STRAGGLER_EVALS = 2
WIRE_SLO = "quorum_wait:agg.quorum_wait_ms<60000"
FLEET_PUSH_PROBES = 20


def _wire_authority(port: int, log: Path, *flags: str):
    """The commit authority (``python -m fedrec_tpu_torch.agg.server``) in a
    session of its own; returns the process and the wall time of its first
    status reply."""
    import os

    from fedrec_tpu_torch.obs.fleet import request_json_line

    root = Path(__file__).resolve().parent
    with open(log, "a") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fedrec_tpu_torch.agg.server", f"127.0.0.1:{port}", *flags],
            cwd=root, env=dict(os.environ, PYTHONPATH=str(root)), stdout=fh,
            stderr=subprocess.STDOUT, start_new_session=True)
    deadline = time.perf_counter() + 60
    while True:
        check(proc.poll() is None and time.perf_counter() < deadline,
              f"the commit authority did not start: {log.read_text()[-2000:]}")
        try:
            request_json_line("127.0.0.1", port, {"cmd": "status"}, timeout_s=5.0)
            return proc, time.time()
        except (OSError, ValueError):
            time.sleep(0.05)


def _fleet_collector(port: int, directory: Path, log: Path):
    """The standalone collector (``python -m fedrec_tpu_torch.obs.fleet``,
    host only) with its fleet rules, in a session of its own; returns once
    it answers."""
    import os

    from fedrec_tpu_torch.obs.fleet import request_json_line

    root = Path(__file__).resolve().parent
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fedrec_tpu_torch.obs.fleet", f"127.0.0.1:{port}", "--dir",
             str(directory), "--watch", "--straggler-evals", str(FLEET_STRAGGLER_EVALS)],
            cwd=root, env=dict(os.environ, PYTHONPATH=str(root)), stdout=fh,
            stderr=subprocess.STDOUT, start_new_session=True)
    deadline = time.perf_counter() + 60
    while True:
        check(proc.poll() is None and time.perf_counter() < deadline,
              f"the collector did not start: {log.read_text()[-2000:]}")
        try:
            request_json_line("127.0.0.1", port, {"cmd": "telemetry_status"}, timeout_s=5.0)
            return proc
        except (OSError, ValueError):
            time.sleep(0.05)


def _edge_rtt_p50(snap: dict, peer: str) -> float | None:
    """The median of a worker's ``wire.rtt_ms`` toward ``peer``, every op's
    buckets together."""
    from fedrec_tpu_torch.obs.registry import DEFAULT_BUCKETS, quantile_from_counts

    rows = [r for r in snap["metrics"].get("wire.rtt_ms", {}).get("values", [])
            if r["labels"].get("peer") == peer]
    if not rows:
        return None
    counts = [sum(c) for c in zip(*(list(r["buckets"].values()) for r in rows))]
    return quantile_from_counts(0.5, DEFAULT_BUCKETS, counts)


def _fleet_checks(fleet_root: Path, collector_dir: Path, collector_port: int) -> dict:
    """fedrec-obs fleet / fleet-trace over leg (a)'s obs root and the
    collector's rules: five workers merged, the authority's commits and late
    folds, worker 3's gate under half its straggle, an edge to the authority
    from every worker with its RTT and clock offset (within the edge's
    median RTT / 2 of 0: one host, one clock), flow arrows from the workers'
    pushes into the authority's commit and from the commit into the
    workers' adoptions, ``fleet:straggler:3`` firing at the collector and no
    other straggler; then a push's time to the collector and the merge's."""
    from fedrec_tpu_torch.cli import obs as obs_cli
    from fedrec_tpu_torch.obs import wire
    from fedrec_tpu_torch.obs.fleet import load_fleet_dir, request_json_line
    from fedrec_tpu_torch.obs.report import load_jsonl

    merge_s = {}
    outs = {}
    trace_path = fleet_root / "fleet_trace.json"
    for name, argv in (("fleet_json", ["fleet", str(fleet_root), "--json"]),
                       ("fleet_text", ["fleet", str(fleet_root)]),
                       ("fleet_trace", ["fleet-trace", str(fleet_root), "-o", str(trace_path)])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = obs_cli.main(argv)
        merge_s[name] = time.perf_counter() - t0
        check(rc == 0, f"fedrec-obs {' '.join(argv[:1])} rc {rc}")
        outs[name] = buf.getvalue()
    report = json.loads(outs["fleet_json"])
    workers = [str(i) for i in range(WIRE_WORLD)]
    check(set(report["workers"]) == {*workers, "aggserver"},
          f"fleet merged {sorted(report['workers'])}")
    agg = report.get("agg", {}).get("aggserver", {})
    check(agg.get("role") == "agg_server" and agg.get("commits", 0) >= WIRE_ROUNDS
          and agg.get("late_folds", 0) >= 1, f"the fleet's agg section {agg}")
    gate3 = agg["worker_gate_ms"].get(str(WIRE_STRAGGLER))
    check(gate3 is not None and gate3 < WIRE_STRAGGLE_MS / 2,
          f"worker {WIRE_STRAGGLER}'s gate {gate3} ms, not under half its straggle")
    for section in ("## Aggregation", "## Wire", "clock offsets"):
        check(section in outs["fleet_text"], f"the fleet text has no {section!r}")
    fleet = load_fleet_dir(fleet_root)
    edges = {}
    for w in workers:
        rows = {(e["peer"], e["op"]): e for e in report["wire"]["edges"].get(w, [])}
        push = rows.get(("aggserver", "push"), {})
        off = report["wire"].get("offsets_ms", {}).get(w, {}).get("aggserver")
        p50 = _edge_rtt_p50(fleet[w].last_snapshot(), "aggserver")
        check("rtt_ms" in push and off is not None and p50 is not None,
              f"worker {w}'s edge to the authority: {rows}, offset {off}")
        check(abs(off) <= p50 / 2, f"worker {w}'s clock offset {off} ms past its edge's "
                                   f"median RTT / 2 ({p50 / 2} ms)")
        edges[w] = {"push_rtt_ms_mean": push["rtt_ms"], "push_server_ms_mean":
                    push.get("server_ms"), "rtt_ms_p50_all_ops": p50, "offset_ms": off,
                    "requests": {op: e.get("requests") for (peer, op), e in rows.items()
                                 if peer == "aggserver"}}
    doc = json.loads(trace_path.read_text())
    pid = doc["otherData"]["workers"]
    auth, ws = pid["aggserver"], {pid[w] for w in workers}
    ends: dict = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "wire":
            ends.setdefault(e["id"], {})[e["ph"]] = e["pid"]
    arrows = {"worker_to_authority": sum(v.get("s") in ws and v.get("f") == auth
                                         for v in ends.values()),
              "push_to_commit": sum(v.get("s") == auth and v.get("f") == auth
                                    for v in ends.values()),
              "commit_to_adoption": sum(v.get("s") == auth and v.get("f") in ws
                                        for v in ends.values())}
    check(all(arrows.values()), f"the merged trace's flow arrows {arrows}")
    recs = [r for r in load_jsonl(collector_dir / "worker_fleet" / "metrics.jsonl")[0]
            if r.get("kind") == "alert" and r.get("event") == "firing"
            and str(r.get("key", "")).startswith("fleet:straggler:")]
    keys = {r["key"] for r in recs}
    check(f"fleet:straggler:{WIRE_STRAGGLER}" in keys
          and not keys - {f"fleet:straggler:{WIRE_STRAGGLER}"},
          f"the collector's straggler alerts {sorted(keys)}")
    straggler = next(r for r in recs if r["key"] == f"fleet:straggler:{WIRE_STRAGGLER}")
    # a push's time: worker 0's last pushed snapshot, again, as its pusher
    # sends it, under another worker id (the rules have fired already)
    snap = fleet["0"].last_snapshot()
    req = {"cmd": "telemetry_push", "worker": "probe", "snapshot": snap, "events": [],
           "alerts": [], "final": False}
    push_ms = []
    for _ in range(FLEET_PUSH_PROBES):
        t0 = time.perf_counter()
        request_json_line("127.0.0.1", collector_port, req, 30.0)
        push_ms.append((time.perf_counter() - t0) * 1e3)
    return {"workers_merged": sorted(report["workers"]), "commits": agg["commits"],
            "late_folds": agg["late_folds"], "worker_gate_ms": agg["worker_gate_ms"],
            "edges": edges, "arrows": arrows, "merge_s": merge_s,
            "straggler_alert": {"summary": straggler["summary"], "value": straggler.get("value"),
                                "threshold": straggler.get("threshold")},
            "push_ms": {"median": _median(push_ms), "max": max(push_ms),
                        "snapshot_bytes": len(json.dumps(snap))},
            "envelope_bytes": wire.envelope_overhead_bytes({"cmd": "push", "worker": "0"}),
            "clock_offsets_s": doc["otherData"]["clock_offsets_s"]}


def _wire_status(port: int) -> dict:
    from fedrec_tpu_torch.obs.fleet import request_json_line

    return request_json_line("127.0.0.1", port, {"cmd": "status"}, timeout_s=30.0)


def _wire_stop(proc, log: Path) -> None:
    """SIGTERM the authority (it persists its state on the way out) and
    hold it to its exit line: no CUDA context."""
    import signal

    _stop_group(proc, signal.SIGTERM)
    tail = log.read_text()
    check("cuda initialised: False" in tail.splitlines()[-1] if tail else False,
          f"the authority's exit: {tail[-800:]}")


def _wire_sets(args, rounds: int, *overrides: str) -> list[str]:
    """A wire worker's ``--set`` flags: ExperimentConfig's widths on the
    fused kernel route, one full-pool evaluation at the last round, no
    snapshots, a 20 ms commit poll."""
    return ["model.fuse_hot_path=true", "model.use_pallas=true", f"train.seed={args.seed}",
            f"train.eval_every={rounds}", "train.eval_protocol=full", "train.snapshot_dir=",
            "agg.worker_poll_s=0.02", *overrides]


def _wire_argv(args, art: Path, rounds: int, port: int, worker: int, *sets: str) -> list[str]:
    flags = [x for kv in _wire_sets(args, rounds, *sets) for x in ("--set", kv)]
    return [str(rounds), str(args.batch_size), "1", "--data-dir", str(art), "--device", DEV,
            "--clients", "1", "--mode", "joint", *flags, "--agg-server", f"127.0.0.1:{port}",
            "--worker-id", str(worker)]


def _wire_workers(argvs: list, logs: Path, name: str) -> list:
    """One ``fedrec_tpu_torch.cli.run`` worker process an argv, each in a
    session of its own; returns the processes and their log files."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = []
    for i, argv in enumerate(argvs):
        path = logs / f"{name}_w{i}.log"
        with open(path, "w") as fh:
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "fedrec_tpu_torch.cli.run", *argv], cwd=root, env=env,
                stdout=fh, stderr=subprocess.STDOUT, start_new_session=True), path))
    return procs


def _wire_hold_straggler(proc, port: int, t0: float) -> float:
    """Hold the straggler (SIGSTOP) from its hello, its table uploaded, to
    the on-time workers' first commit, so that start-up skew (the workers
    reach their first round seconds apart) cannot pass for straggling: its
    round-0 push then lands straggle + one round after that commit, inside
    the others' run, and its next one after their last commit. Returns the
    seconds it was held (0 when it said hello after the first commit)."""
    import os
    import signal

    held_at = None
    try:
        while time.perf_counter() - t0 < WIRE_LEG_TIMEOUT_S:
            st = _wire_status(port)
            if st["version"] >= 1:
                break
            if held_at is None and str(WIRE_STRAGGLER) in st["workers"]:
                os.killpg(proc.pid, signal.SIGSTOP)
                held_at = time.perf_counter()
            check(proc.poll() is None, "the straggler exited before the first commit")
            time.sleep(0.01)
    finally:
        if held_at is not None:
            os.killpg(proc.pid, signal.SIGCONT)
    return time.perf_counter() - held_at if held_at is not None else 0.0


def _wire_join(procs: list, name: str, t0: float) -> list[dict]:
    """Wait for the workers under the leg's wall limit (the leg stops them
    on its way out); every one must exit 0 and print its report. Returns
    the reports."""
    try:
        for p, _ in procs:
            p.wait(timeout=max(WIRE_LEG_TIMEOUT_S - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"{name}: a worker outlived {WIRE_LEG_TIMEOUT_S} s: "
                           f"{[f.read_text()[-1500:] for _, f in procs]}")
    outs = [f.read_text() for _, f in procs]
    rcs = [p.returncode for p, _ in procs]
    check(rcs == [0] * len(procs), f"{name}: worker rcs {rcs}: {[o[-2000:] for o in outs]}")
    reps = []
    for i, o in enumerate(outs):
        lines = [ln for ln in o.splitlines() if ln.startswith(f"[agg-worker {i}] report ")]
        check(bool(lines), f"{name}: worker {i} printed no report")
        reps.append(json.loads(lines[-1].split(" report ", 1)[1]))
    return reps


def _ms_brief(values: list):
    """A short list as it is, a long one as its count, median and maximum."""
    if len(values) <= 8:
        return values
    return {"n": len(values), "median": _median(values), "max": max(values)}


def _wire_worker_rows(reps: list[dict], steps: int, counts: dict) -> list[dict]:
    """Each worker's times and launches: C, D, B, E at least steps x rounds
    (the one client's steps), A and B again in the final evaluation, whose
    metrics must lie in [0, 1]; the counts add into the path's."""
    rows = []
    for r in reps:
        n = len(r["rounds"])
        for name, v in r["launches"].items():
            counts[name] = counts.get(name, 0) + v
        for name in ("fused_gather_encode", "fused_gather_encode_bwd", "fused_history_score",
                     "fused_history_score_bwd"):
            check(r["launches"][name] >= steps * n,
                  f"worker {r['worker']} launched {name} {r['launches'][name]} times, under "
                  f"steps x rounds = {steps * n}")
        check(r["launches"]["additive_pool"] >= 1
              and r["launches"]["fused_history_score"] > steps * n,
              f"worker {r['worker']}: A and B not launched in its evaluation {r['launches']}")
        m = r["val_metrics"]
        check(bool(m) and all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()),
              f"worker {r['worker']} final evaluation {m}")
        check(all(math.isfinite(x) for x in r["losses"]), f"worker {r['worker']} losses")
        rows.append({
            "worker": r["worker"], "rounds": n, "round_ms": _ms_brief(r["round_ms"]),
            "start_to_first_round_s": r["first_round_at"] - r["started_at"],
            "push_ms": _ms_brief(r["push_ms"]), "poll_adopt_ms": _ms_brief(r["poll_adopt_ms"]),
            "peak_gpu_mb": r["peak_gpu_mb"], "resyncs": r["resyncs"],
            "dropped": r["dropped"], "undelivered": r["undelivered"],
            "uplink_bytes_per_push": _median(r["uplink_bytes"]), "val_metrics": m,
            "launches": {KERNEL_LETTER[k]: v for k, v in r["launches"].items() if v},
            **({"wire_faults_injected": r["wire_faults_injected"]}
               if "wire_faults_injected" in r else {})})
    return rows


def _wire_commits(st: dict) -> list[dict]:
    return [{k: c[k] for k in ("version", "folded", "late_folds", "stale_drops",
                               "max_staleness", "quorum", "closer", "gate_ms",
                               "quorum_wait_ms", "fold_ms")} for c in st["commits"]]


def _wire_bytes_per_push(st: dict) -> float:
    return sum(st["push_bytes"].values()) / max(sum(st["push_counts"].values()), 1)


def phase_wire_path(state: dict, args) -> dict:
    """The async wire deployment at full width: the commit authority
    (``python -m fedrec_tpu_torch.agg.server``, host only) and workers of
    ``python -m fedrec_tpu_torch.cli.run --agg-server --worker-id``, each a
    single-client ``Trainer`` on this card (1 client at B, ``WIRE_STEPS``
    steps a round, the fused kernels), over the shared token file.

    (a) quorum: an authority at quorum 3 of world 4 with a state directory,
        4 workers for ``WIRE_ROUNDS`` rounds, worker 3 straggling 4 s before
        every push (held from its hello to the first commit, so that
        start-up skew cannot pass for straggling): commits >= rounds, one
        version a commit, a late fold and
        no stale drop, worker 3's summed gate <= 5% of its straggle, every
        final evaluation in [0, 1], both sidecars on disk after the stop, C,
        D, B, E >= steps x rounds and A, B in the evaluation, per worker;
    (c) codec: 2 workers at quorum 2 under ``fed.dcn_compress=countsketch``
        (the authority's ``--sketch-seed`` the workers'), ``WIRE_SHORT_STEPS``
        steps a round: one version a round, the bytes a push <= 1/8 of
        (a)'s dense push;
    (b) faults: quorum 2 of 2, both workers through a ``ChaosProxy`` whose
        seeded plan duplicates every exchange and tears, then partitions,
        a window of it (the windows scaled by (c)'s round); the authority
        SIGKILLed after its second commit and restarted from its state
        directory: one incarnation bump, a resync per worker, a duplicate
        push, the version kept, every acked push with one disposition in
        the ledger or pending, each fault kind injected.

    The authority never creates a CUDA context (its exit line says so)."""
    import signal
    import tempfile

    import torch
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.data import MindData, make_synthetic_mind
    from fedrec_tpu_torch.parallel.membership import free_port

    B = args.batch_size
    cfg = ExperimentConfig().apply_overrides(_wire_sets(args, WIRE_ROUNDS))
    T, Dh = cfg.data.max_title_len, cfg.model.bert_hidden
    tokens = _tokens(state, args, T, Dh)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = tempfile.TemporaryDirectory(prefix="wire_path_", dir=build)
    root = Path(work.name)
    logs = root / "logs"
    logs.mkdir()
    data = make_synthetic_mind(num_news=args.num_news, num_train=B * WIRE_STEPS,
                               num_valid=args.coord_valid, title_len=T, seed=args.seed)
    out: dict = {"batch_size": B, "steps": WIRE_STEPS, "short_steps": WIRE_SHORT_STEPS,
                 "num_news": args.num_news, "valid": args.coord_valid}
    # two artifact dirs over one token file: (a)'s shard and a shorter one
    art, art_short = root / "UserData", root / "UserDataShort"
    _write_artifacts(data, art)
    _write_artifacts(MindData(data.news_tokens, data.nid2index,
                              data.train_samples[: B * WIRE_SHORT_STEPS], data.valid_samples),
                     art_short)
    for d in (art, art_short):
        (d / "token_states.npy").hardlink_to(_token_file(state, args, tokens, out))
    counts: dict = {}

    # ---- (a) quorum 3 of 4, worker 3 straggling; every worker pushes its
    # telemetry to a standalone collector and writes its obs dir under one
    # fleet root, beside the authority's (with its --slo)
    port, c_port = free_port(), free_port()
    fleet_root, collector_dir = root / "a_fleet", root / "a_collector"
    collector = _fleet_collector(c_port, collector_dir, logs / "a_collector.log")
    a_state, a_log = root / "a_state", logs / "a_authority.log"
    auth, _ = _wire_authority(port, a_log, "--quorum", str(WIRE_QUORUM), "--world",
                              str(WIRE_WORLD), "--staleness-cap", str(WIRE_STALENESS_CAP),
                              "--state-dir", str(a_state), "--obs-dir",
                              str(fleet_root / "worker_aggserver"), "--slo", WIRE_SLO)
    procs: list = []
    try:
        argvs = [[*_wire_argv(args, art, WIRE_ROUNDS, port, i, "agg.worker_global_wait_s=60",
                              f"obs.fleet.collector=127.0.0.1:{c_port}",
                              *(("chaos.enabled=true", f"chaos.straggle_ms={WIRE_STRAGGLE_MS}",
                                 "agg.worker_global_wait_s=1") if i == WIRE_STRAGGLER else ())),
                  "--obs-dir", str(fleet_root)]
                 for i in range(WIRE_WORLD)]
        t0 = time.perf_counter()
        procs = _wire_workers(argvs, logs, "a")
        held_s = _wire_hold_straggler(procs[WIRE_STRAGGLER][0], port, t0)
        reps = _wire_join(procs, "quorum", t0)
        wall = time.perf_counter() - t0
        st = _wire_status(port)
    finally:
        for p, _ in procs:
            _stop_group(p)
        _wire_stop(auth, a_log)
    try:
        fleet_out = _fleet_checks(fleet_root, collector_dir, c_port)
    finally:
        _stop_group(collector, signal.SIGINT)
    commits = st["commits"]
    launched = time.time() - wall
    timeline = {r["worker"]: {"first_round_s": r["first_round_at"] - launched,
                              "round_ms": [round(x) for x in r["round_ms"]],
                              "acked_s": [round(t - launched, 2) for t in r["acked_at"]]}
                for r in reps}
    check(st["version"] >= WIRE_ROUNDS and [c["version"] for c in commits]
          == list(range(1, st["version"] + 1)), f"quorum leg commits {_wire_commits(st)}")
    check(all(c["quorum"] >= WIRE_QUORUM for c in commits), "a commit under quorum")
    late = sum(c["late_folds"] for c in commits)
    check(late >= 1, f"no late fold: {_wire_commits(st)}; {timeline}")
    check(sum(c["stale_drops"] for c in commits) == 0, "a fold within the cap was dropped")
    gate = sum(c["gate_ms"] for c in commits if c["closer"] == str(WIRE_STRAGGLER))
    check(gate <= 0.05 * WIRE_STRAGGLE_MS,
          f"the straggler was charged {gate:.0f} ms, over 5% of its {WIRE_STRAGGLE_MS} ms: "
          f"{_wire_commits(st)}; {timeline}")
    check("straggling" in (logs / f"a_w{WIRE_STRAGGLER}.log").read_text(),
          "worker 3 never straggled")
    check((a_state / "agg_buffer.npz").exists() and (a_state / "agg_global.npz").exists(),
          "the authority's sidecars are not on disk after its stop")
    dense = _wire_bytes_per_push(st)
    rows = _wire_worker_rows(reps, WIRE_STEPS, counts)
    round_ms = _median([x for r in reps for x in r["round_ms"][1:]])
    out["quorum"] = {"wall_s": wall, "straggler_held_s": held_s, "version": st["version"],
                     "late_folds": late, "acked_s": {w: t["acked_s"] for w, t in timeline.items()},
                     "straggler_gate_ms": gate, "barrier_would_charge_ms":
                     WIRE_STRAGGLE_MS * WIRE_ROUNDS, "dense_bytes_per_push": dense,
                     "commits": _wire_commits(st), "workers": rows}
    fleet_out["envelope_share_of_dense_push"] = fleet_out["envelope_bytes"] / dense
    out["fleet"] = fleet_out
    # the slice's costs on a line of their own, beside the card
    emit({"fleet_costs": {
        "card": state.get("nvidia_smi"),
        "envelope_bytes_per_exchange": fleet_out["envelope_bytes"],
        "envelope_share_of_dense_push": fleet_out["envelope_share_of_dense_push"],
        "push_to_collector_ms": fleet_out["push_ms"],
        "edge_rtt_ms_p50": {w: e["rtt_ms_p50_all_ops"] for w, e in fleet_out["edges"].items()},
        "edge_offset_ms": {w: e["offset_ms"] for w, e in fleet_out["edges"].items()},
        "merge_s": fleet_out["merge_s"]}})

    # ---- (c) countsketch at quorum 2 of 2, on the shorter shard
    port = free_port()
    c_log = logs / "c_authority.log"
    auth, _ = _wire_authority(port, c_log, "--quorum", "2", "--world", "2", "--sketch-seed",
                              str(WIRE_SKETCH_SEED))
    procs = []
    try:
        argvs = [_wire_argv(args, art_short, WIRE_CODEC_ROUNDS, port, i,
                            "fed.dcn_compress=countsketch",
                            f"fed.dcn_sketch_seed={WIRE_SKETCH_SEED}",
                            "agg.worker_global_wait_s=60") for i in range(2)]
        t0 = time.perf_counter()
        procs = _wire_workers(argvs, logs, "c")
        reps = _wire_join(procs, "codec", t0)
        st = _wire_status(port)
    finally:
        for p, _ in procs:
            _stop_group(p)
        _wire_stop(auth, c_log)
    check(st["version"] == WIRE_CODEC_ROUNDS and [c["version"] for c in st["commits"]]
          == list(range(1, WIRE_CODEC_ROUNDS + 1)), f"codec leg commits {_wire_commits(st)}")
    sketch = _wire_bytes_per_push(st)
    check(sketch <= dense / 8, f"countsketch pushes {sketch:.0f} B against dense {dense:.0f} B")
    # a round of two workers on the short shard: the fault leg's time scale
    r_s = _median([x for r in reps for x in r["round_ms"][1:]]) / 1e3
    out["codec"] = {"wall_s": time.perf_counter() - t0, "version": st["version"],
                    "bytes_per_push": {"none": dense, "countsketch": sketch},
                    "ratio": dense / sketch, "commits": _wire_commits(st),
                    "workers": _wire_worker_rows(reps, WIRE_SHORT_STEPS, counts)}

    # ---- (b) wire faults and an authority restart, quorum 2 of 2. The
    # windows, in seconds since each worker's proxy started, scale with
    # (c)'s round: each outlasts the circuit breaker's reset (a failed push
    # opens it, and an open breaker sends nothing the window could catch)
    # by more than two rounds, the partition opens once the breaker has
    # closed after the tear, and the rounds outlast the windows by
    # WIRE_RECOVERY_S (the second commit, the kill, the restart, a resync)
    w = WIRE_FAULT_WAIT_S + 2.5 * r_s
    t0_tear = WIRE_BOOTSTRAP_S + r_s
    t1 = t0_tear + w + WIRE_FAULT_WAIT_S + r_s
    plan = (f"dup@*,tear@{t0_tear:.2f}-{t0_tear + w:.2f},"
            f"partition@{t1:.2f}-{t1 + w:.2f}")
    rounds = max(WIRE_FAULT_ROUNDS, math.ceil((t1 + w + WIRE_RECOVERY_S) / r_s))
    port = free_port()
    b_state, b_log = root / "b_state", logs / "b_authority.log"
    auth_flags = ("--quorum", "2", "--world", "2", "--staleness-cap", str(rounds),
                  "--state-dir", str(b_state))
    auth, _ = _wire_authority(port, b_log, *auth_flags)
    restarted, procs = None, []
    try:
        argvs = [_wire_argv(args, art_short, rounds, port, i, "chaos.enabled=true",
                            f"chaos.wire_faults={plan}", f"chaos.wire_seed={args.seed + i}",
                            f"agg.worker_global_wait_s={WIRE_FAULT_WAIT_S}",
                            "agg.worker_unreachable_budget_s=120")
                 for i in range(2)]
        t0 = time.perf_counter()
        procs = _wire_workers(argvs, logs, "b")
        while True:
            v_kill = _wire_status(port)["version"]
            if v_kill >= 2:
                break
            check(time.perf_counter() - t0 < WIRE_LEG_TIMEOUT_S
                  and all(p.poll() is None for p, _ in procs),
                  f"fault leg: no second commit: {[f.read_text()[-1500:] for _, f in procs]}")
            time.sleep(0.02)
        killed_at = time.time()
        _stop_group(auth, signal.SIGKILL)
        restarted, replied_at = _wire_authority(port, b_log, *auth_flags)
        reps = _wire_join(procs, "faults", t0)
        st = _wire_status(port)
    finally:
        for p, _ in procs:
            _stop_group(p)
        _stop_group(auth, signal.SIGKILL)
        if restarted is not None:
            _wire_stop(restarted, b_log)
    resumed = [ln for ln in b_log.read_text().splitlines() if "resumed committed global v" in ln]
    check(len(resumed) == 1, f"the restart did not resume once: {resumed}")
    restored = int(resumed[0].split("global v", 1)[1].split()[0])
    check(restored >= v_kill, f"restored v{restored} below v{v_kill}")
    check(st["incarnation"] == 2, f"incarnation {st['incarnation']} after one restart")
    check(all(r["resyncs"] >= 1 for r in reps), f"resyncs {[r['resyncs'] for r in reps]}")
    check(st["push_dups"] >= 1, "no duplicate push reached the ledger")
    ledger, pending = set(st["ledger"]), set(st["pending_push_ids"])
    acked = {pid for r in reps for pid in r["acked"]}
    check(acked <= ledger | pending and not ledger & pending,
          f"acked pushes lost: {sorted(acked - ledger - pending)}")
    injected: dict = {}
    for r in reps:
        for k, v in r.get("wire_faults_injected", {}).items():
            injected[k] = injected.get(k, 0) + v
    check(all(injected.get(k, 0) >= 1 for k in ("tear", "dup", "partition")),
          f"the plan's faults did not all fire: {injected}")
    first_ack_s = []
    for r in reps:
        after = [t for t in r["acked_at"] if t > replied_at]
        first_ack_s.append(min(after) - killed_at if after else None)
    out["faults"] = {
        "plan": plan, "rounds": rounds, "wall_s": time.perf_counter() - t0,
        "version_at_kill": v_kill, "restored_version": restored, "final_version": st["version"],
        "kill_to_first_reply_s": replied_at - killed_at,
        "kill_to_first_ack_after_resync_s": first_ack_s, "push_dups": st["push_dups"],
        "acked": len(acked), "ledgered": len(ledger), "pending": len(pending),
        "injected": injected, "commits_total": len(st["commits"]),
        "late_folds": sum(c["late_folds"] for c in st["commits"]),
        "first_commits": _wire_commits(st)[:6],
        "workers": _wire_worker_rows(reps, WIRE_SHORT_STEPS, counts)}

    for name in ("fused_gather_encode", "fused_gather_encode_bwd", "fused_history_score",
                 "fused_history_score_bwd", "additive_pool"):
        check(counts.get(name, 0) > 0, f"{name} never launched on the wire path")
    state.setdefault("launches", {})["wire"] = counts
    out["launches"] = {KERNEL_LETTER[k]: v for k, v in counts.items() if v}
    work.cleanup()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- seq_path
SEQ_SHARDS = 4
SEQ_CLIENTS, SEQ_BATCH = 2, 16
SEQ_RING_STEPS, SEQ_ULYSSES_STEPS, SEQ_FT_STEPS = 4, 2, 2
SEQ_FT_HISTORY = 64
SEQ_FT_NEWS = 4096
# the seq legs' catalog: the first 16,384 rows of the token states (cut
# from 65,536: four ranks' tables and activations must share the one card)
SEQ_NEWS = 16384
SEQ_WORLD_TIMEOUT_S = 420
# --set overrides appended to every seq leg's configuration (empty on the
# card; a CPU rehearsal adds small widths), handed to the ranks in the spec
SEQ_EXTRA_SETS: tuple = ()
# the seq legs against the one-process reference: losses, the first step's
# gradients, the parameters after the steps (JAX's own seq-vs-plain bar,
# tests/test_seq_parallel.py: Adam amplifies reduction-order noise)
SEQ_LOSS_ATOL, SEQ_GRAD_ATOL, SEQ_PARAM_ATOL = 1e-5, 2e-4, 2e-3


def _seq_cfg(args, leg: str, seq: int):
    """A seq leg's configuration: ExperimentConfig's widths, the unfused
    kernel route (use_pallas: kernel A on the text head's pools), K = 2 at
    B = 16, param_avg; the joint legs at ``--long-history`` clicks, the
    finetune leg at data_path's trunk and 64 clicks. ``seq`` = 1 is the
    reference: one process, the dense user tower."""
    from fedrec_tpu_torch.config import ExperimentConfig

    sets = ["model.use_pallas=true", "model.fuse_hot_path=false", f"fed.num_clients={SEQ_CLIENTS}",
            f"data.batch_size={SEQ_BATCH}", "fed.strategy=param_avg", f"fed.seq_shards={seq}",
            f"train.seed={args.seed}"]
    if leg == "finetune":
        sets += ["model.text_encoder_mode=finetune", "model.trunk_dropout=0",
                 "model.trunk_remat=true", f"data.max_his_len={SEQ_FT_HISTORY}"]
    else:
        sets += ["model.text_encoder_mode=head", f"data.max_his_len={args.long_history}"]
    sets.append("fed.seq_impl=ulysses" if leg == "ulysses" else "fed.seq_impl=ring")
    if seq == 1:
        sets.append("model.attn_impl=dense")
    return ExperimentConfig().apply_overrides([*sets, *SEQ_EXTRA_SETS])


def _seq_batches(args, cfg, steps: int) -> tuple[list[dict], object]:
    """The leg's whole (K, B, ...) batches and its feature table's source:
    the joint legs the seeded token states' catalog with 1,024-2,048-click
    histories, the finetune leg a synthetic token table."""
    from fedrec_tpu_torch.data import TrainBatcher, index_samples, make_synthetic_mind

    H, T = cfg.data.max_his_len, cfg.data.max_title_len
    finetune = cfg.model.text_encoder_mode == "finetune"
    # the same split whatever the leg's step count: a leg's batches are the
    # first of the reference's
    data = make_synthetic_mind(num_news=SEQ_FT_NEWS if finetune else SEQ_NEWS,
                               num_train=SEQ_CLIENTS * SEQ_BATCH * max(steps, SEQ_RING_STEPS),
                               num_valid=0,
                               title_len=T, his_len_range=(H // 2, H), seed=args.seed)
    batcher = TrainBatcher(index_samples(data.train_samples, data.nid2index, H), SEQ_BATCH,
                           cfg.data.npratio, seed=args.seed)
    batches = [{"candidates": b.candidates, "history": b.history, "labels": b.labels}
               for b in batcher.epoch_batches_sharded(SEQ_CLIENTS, 0)][:steps]
    check(len(batches) == steps, f"{len(batches)} batches for {steps} steps")
    return batches, data


def _seq_sample(x: np.ndarray, finetune: bool) -> np.ndarray:
    """What a rank ships of one tensor: all of it, but in finetune mode
    every 61st element of a leaf above 65,536 (the trunk's 66M weights
    would be half a GB a rank; the digests cover every bit)."""
    x = np.ascontiguousarray(x)
    return x.reshape(-1)[::61].copy() if finetune and x.size > 65536 else x


def _seq_run(args, leg: str, seq: int, group, tokens, steps: int, by_step: bool = False) -> dict:
    """One leg's steps through ``build_fed_train_step`` (with the seq world
    ``group`` when ``seq`` > 1): losses, step ms, the first step's
    gradients (client 0, after the world's sum), every client's parameters
    after the steps (after each step with ``by_step``) and their digest,
    launches, the wire's counters, the peak memory above the resident table,
    overflow."""
    import hashlib

    import torch
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.ops import launch_counts, reset_launch_counts
    from fedrec_tpu_torch.parallel.mesh import shard_fed_batch
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.train import build_fed_train_step, init_client_state, replicate_state

    cfg = _seq_cfg(args, leg, seq)
    dev = torch.device(DEV)
    batches, data = _seq_batches(args, cfg, steps)
    table = tokens
    if cfg.model.text_encoder_mode == "finetune":
        table = torch.as_tensor(np.asarray(data.news_tokens), dtype=torch.int64).to(dev)
    model = init_params(NewsRecommender(cfg.model), seed=args.seed + 7).to(dev)
    states = replicate_state(init_client_state(model, cfg, args.seed), SEQ_CLIENTS, args.seed)
    strategy = get_strategy("param_avg")
    first_grads: list = []
    inner = strategy.sync_grads

    finetune = cfg.model.text_encoder_mode == "finetune"

    calls = [0]

    def capture(grads):  # the first step's gradients, user then news, as the step syncs them
        if calls[0] < 2:
            first_grads.extend(None if g is None else _seq_sample(g.detach().cpu().numpy(),
                                                                  finetune)
                               for g in grads[0])
        calls[0] += 1
        return inner(grads)

    def params_now() -> list:
        return [[_seq_sample(p.detach().cpu().numpy(), finetune) for p in st.model.parameters()]
                for st in states]

    strategy.sync_grads = capture
    step = build_fed_train_step(model, cfg, strategy, device=dev,
                                seq_group=group if seq > 1 else None)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    if group is not None:
        group.reset_stats()
    losses, step_ms, overflow, first_step_at, kept = [], [], 0, None, []
    for b in batches:
        t0 = time.perf_counter()
        states, met = step(states, shard_fed_batch(b, group if seq > 1 else None), table)
        losses.append(met["loss"].tolist())  # a host read: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        first_step_at = first_step_at or time.time()
        overflow += met["unique_overflow"]
        if by_step:
            kept.append(params_now())
    peak = None
    if on_card:
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
        resident /= 1e9
    digest = hashlib.sha256()
    for st in states:
        for p in st.model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
    return {"losses": losses, "step_ms": step_ms, "overflow": overflow,
            "first_grads": first_grads,
            "params": params_now(), "params_by_step": kept, "digest": digest.hexdigest(),
            "launches": launch_counts(), "wire": dict(group.stats) if group else {},
            "peak_above_resident_gb": peak, "resident_gb": resident if on_card else None,
            "first_step_at": first_step_at}


def _seq_rank_main(argv: list[str]) -> int:
    """One rank of ``seq_path``'s world (``chip_smoke.py --seq-rank R ...``):
    the seeded token states rebuilt on the card (bitwise the parent's), then
    the ring, ring-again, Ulysses and finetune legs; results to ``--seq-out``."""
    import pickle

    import torch
    from fedrec_tpu_torch.cli.coordinator import _process_start_wall
    from fedrec_tpu_torch.parallel.mesh import seq_group
    from fedrec_tpu_torch.parallel.multihost import initialize_distributed

    global DEV, SEQ_EXTRA_SETS, SEQ_NEWS
    p = argparse.ArgumentParser()
    for name in ("--seq-rank", "--seq-world"):
        p.add_argument(name, type=int, required=True)
    for name in ("--seq-addr", "--seq-spec", "--seq-out", "--seq-device"):
        p.add_argument(name, required=True)
    a = p.parse_args(argv)
    DEV = a.seq_device
    started_at = _process_start_wall()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(a.seq_spec).read_text())
    args = argparse.Namespace(**spec["args"])
    SEQ_EXTRA_SETS, SEQ_NEWS = tuple(spec["extra_sets"]), int(spec["news"])
    world = initialize_distributed(a.seq_addr, a.seq_world, a.seq_rank)
    t0 = time.perf_counter()
    cfg = _seq_cfg(args, "ring", SEQ_SHARDS)
    # the table's first SEQ_NEWS rows, bitwise (the same seeded chunks)
    tokens = _tokens({}, argparse.Namespace(**{**vars(args), "num_news": SEQ_NEWS}),
                     cfg.data.max_title_len, cfg.model.bert_hidden)
    out = {"rank": a.seq_rank, "started_at": started_at, "table_s": time.perf_counter() - t0,
           "legs": {}}
    for leg, steps in (("ring", SEQ_RING_STEPS), ("ring_repeat", SEQ_RING_STEPS),
                       ("ulysses", SEQ_ULYSSES_STEPS), ("finetune", SEQ_FT_STEPS)):
        kind = "ring" if leg == "ring_repeat" else leg
        group = seq_group(_seq_cfg(args, kind, SEQ_SHARDS), world)
        out["legs"][leg] = _seq_run(args, kind, SEQ_SHARDS, group, tokens, steps)
        if DEV == "cuda":
            torch.cuda.empty_cache()
    with open(a.seq_out, "wb") as f:
        pickle.dump(out, f)
    return 0


def _seq_world(args, work: Path) -> dict:
    """``SEQ_SHARDS`` ranks of ``chip_smoke.py --seq-rank`` on 127.0.0.1,
    all on the one card, under one wall limit; the first rank to fail stops
    the others and fails the phase."""
    import os
    import pickle

    from fedrec_tpu_torch.parallel.membership import free_port

    spec = work / "spec.json"
    spec.write_text(json.dumps({"args": {k: v for k, v in vars(args).items()
                                         if isinstance(v, (int, float, str))},
                                "extra_sets": list(SEQ_EXTRA_SETS), "news": SEQ_NEWS}))
    address = f"127.0.0.1:{free_port()}"
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    logs = [work / f"rank{r}.log" for r in range(SEQ_SHARDS)]
    t0 = time.perf_counter()
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, str(root / "chip_smoke.py"), "--seq-rank", str(r),
                 "--seq-world", str(SEQ_SHARDS), "--seq-addr", address, "--seq-spec", str(spec),
                 "--seq-out", str(work / f"rank{r}.pkl"), "--seq-device", DEV],
                cwd=root, env=env, stdout=fh, stderr=subprocess.STDOUT))
    failed = None
    try:
        while any(pr.poll() is None for pr in procs):
            bad = [r for r, pr in enumerate(procs) if pr.poll() not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if time.perf_counter() - t0 > SEQ_WORLD_TIMEOUT_S:
                raise SmokeFailure(f"seq world outlived {SEQ_WORLD_TIMEOUT_S} s: "
                                   f"{[log.read_text()[-1500:] for log in logs]}")
            time.sleep(0.2)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
    rcs = [pr.returncode for pr in procs]
    if failed is None and any(rcs):
        failed = next(r for r, rc in enumerate(rcs) if rc)
    check(failed is None, f"seq rank {failed} failed (rcs {rcs}): "
                          f"{logs[failed].read_text()[-3000:] if failed is not None else ''}")
    results = []
    for r in range(SEQ_SHARDS):
        with open(work / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return {"rcs": rcs, "wall_s": time.perf_counter() - t0, "results": results}


def _seq_compare(got: dict, ref: dict) -> dict:
    """A leg's rank against the reference at the seq bars: losses, the
    first step's gradients, every client's parameters after the same
    number of steps."""
    steps = len(got["losses"])
    loss_err = max(abs(a - b) for ra, rb in zip(got["losses"], ref["losses"][:steps])
                   for a, b in zip(ra, rb))
    # a leaf one route leaves unused (the reference's user pool on kernel A
    # omits the softmax-invariant fc2 bias) has a gradient of 0
    grad_err = max(float(np.abs((0.0 if a is None else a) - (0.0 if b is None else b)).max())
                   for a, b in zip(got["first_grads"], ref["first_grads"])
                   if a is not None or b is not None)
    param_err = max(float(np.abs(a - b).max()) for ca, cb in zip(
        got["params"], ref["params_by_step"][steps - 1]) for a, b in zip(ca, cb))
    return {"loss": loss_err, "grad": grad_err, "param": param_err}


def _wire_summary(stats: dict) -> dict:
    return {op: {"calls": s["calls"], "bytes": s["bytes"], "ms": s["ms"],
                 "ms_per_call": s["ms"] / max(s["calls"], 1),
                 "bytes_per_call": s["bytes"] / max(s["calls"], 1)} for op, s in stats.items()}


def _seq_cli_leg(args, token_file: Path):
    """Leg (d): the run CLI starts its own world of ``SEQ_SHARDS`` ranks for
    one evaluated round over the mapped catalog; its completed process and
    wall seconds."""
    import os

    root = Path(__file__).resolve().parent
    argv = [sys.executable, "-m", "fedrec_tpu_torch.cli.run", "1", str(SEQ_BATCH), "1",
            "--synthetic", "--synthetic-news", str(SEQ_NEWS), "--synthetic-train",
            str(SEQ_CLIENTS * SEQ_BATCH * 2), "--clients", str(SEQ_CLIENTS), "--mode", "joint",
            "--token-states", str(token_file), "--device", DEV, "--set", "model.use_pallas=true",
            "--set", "model.fuse_hot_path=false", "--set", f"data.max_his_len={args.long_history}",
            "--set", f"fed.seq_shards={SEQ_SHARDS}", "--set", "train.snapshot_dir=",
            *(x for e in SEQ_EXTRA_SETS for x in ("--set", e))]
    t0 = time.perf_counter()
    cli = subprocess.run(argv, cwd=root, capture_output=True, text=True,
                         timeout=SEQ_WORLD_TIMEOUT_S, env=dict(os.environ, PYTHONPATH=str(root)))
    return cli, time.perf_counter() - t0


def phase_seq_path(state: dict, args) -> dict:
    """Sequence parallelism at full width: a world of 4 ranks on the one
    card, each with its quarter of every 2,048-click history."""
    import torch

    work = Path(__file__).resolve().parent / "build" / "seq_path"
    work.mkdir(parents=True, exist_ok=True)
    cfg = _seq_cfg(args, "ring", SEQ_SHARDS)
    T, Dh = cfg.data.max_title_len, cfg.model.bert_hidden
    out: dict = {}
    # the run CLI's leg maps the catalog's rows from disk, as a user's run would
    token_file = work / f"token_states_{SEQ_NEWS}_{args.seed}.npy"
    out["token_states_write_s"] = _write_token_states(
        _tokens(state, args, T, Dh)[:SEQ_NEWS], token_file, args.chunk)
    # the world's four tables take the card's room: this process's goes
    # while the world runs and is rebuilt (bitwise) for the reference
    state.pop("tokens", None)
    if DEV == "cuda":
        torch.cuda.empty_cache()
    try:
        world = _seq_world(args, work)
        res = world["results"]
        cli, cli_s = _seq_cli_leg(args, token_file)
    finally:
        token_file.unlink(missing_ok=True)
    finals = [ln for ln in cli.stdout.splitlines() if ln.startswith("final: ")]
    check(cli.returncode == 0 and len(finals) == 1,
          f"seq run CLI: rc {cli.returncode}, final {finals}: {cli.stderr[-3000:]}")
    fields = {k: float(v) for k, v in (kv.split("=") for kv in finals[0][7:].split())}
    check(math.isfinite(fields["loss"]) and 0.0 <= fields["auc"] <= 1.0, f"seq run CLI: {finals}")

    # ---- the reference: one process, seq_shards = 1, the dense user tower
    tokens = _tokens(state, args, T, Dh)[:SEQ_NEWS]
    refs = {"ring": _seq_run(args, "ring", 1, None, tokens, SEQ_RING_STEPS, by_step=True),
            "finetune": _seq_run(args, "finetune", 1, None, tokens, SEQ_FT_STEPS, by_step=True)}
    if DEV == "cuda":
        torch.cuda.empty_cache()

    legs_out, launches_total = {}, {}
    for leg in ("ring", "ulysses", "finetune"):
        ref = refs["finetune" if leg == "finetune" else "ring"]
        steps = len(res[0]["legs"][leg]["losses"])
        per_rank = []
        for r in res:
            g = r["legs"][leg]
            errs = _seq_compare(g, ref)
            check(errs["loss"] <= SEQ_LOSS_ATOL, f"{leg} rank {r['rank']}: loss error {errs}")
            check(errs["grad"] <= SEQ_GRAD_ATOL, f"{leg} rank {r['rank']}: gradient error {errs}")
            check(errs["param"] <= SEQ_PARAM_ATOL, f"{leg} rank {r['rank']}: parameter error {errs}")
            check(g["overflow"] == 0, f"{leg} rank {r['rank']}: unique_overflow {g['overflow']}")
            check(all(math.isfinite(v) for row in g["losses"] for v in row),
                  f"{leg} rank {r['rank']}: non-finite loss")
            # the joint legs' text head pools on kernel A; the finetune
            # TextEncoder's head pools densely, as in JAX
            check(leg == "finetune" or g["launches"].get("additive_pool", 0) > 0,
                  f"kernel additive_pool never launched on {leg} rank {r['rank']}")
            check(g["launches"].get("flash_forward", 0) == 0,
                  f"flash_forward launched on {leg} rank {r['rank']} (the ring replaces it)")
            if leg != "finetune":
                for name, n in g["launches"].items():
                    launches_total[name] = launches_total.get(name, 0) + n
            per_rank.append({"rank": r["rank"], "errors": errs,
                             "median_step_ms": float(np.median(g["step_ms"])),
                             "step_ms": g["step_ms"],
                             "peak_above_table_gb": g["peak_above_resident_gb"],
                             "resident_gb": g["resident_gb"],
                             "launches": {k: v for k, v in g["launches"].items() if v},
                             "wire": _wire_summary(g["wire"])})
        # every rank holds the same parameters, to the bit
        for r in res[1:]:
            check(r["legs"][leg]["digest"] == res[0]["legs"][leg]["digest"],
                  f"{leg}: rank {r['rank']}'s parameters differ from rank 0's")
        legs_out[leg] = {"steps": steps, "ranks": per_rank,
                         "reference_median_step_ms": float(np.median(ref["step_ms"][:steps])),
                         "reference_peak_above_table_gb": ref["peak_above_resident_gb"]}
    for r in res:
        a, b = r["legs"]["ring"], r["legs"]["ring_repeat"]
        check(a["losses"] == b["losses"] and a["digest"] == b["digest"],
              f"ring leg repeated on rank {r['rank']} gave other bits")
    state.setdefault("launches", {})["seq"] = launches_total
    hop = res[0]["legs"]["ring"]["wire"]["ring_hop"]
    a2a = res[0]["legs"]["ulysses"]["wire"]["all_to_all"]
    return {
        **out,
        "config": {"seq_shards": SEQ_SHARDS, "clients": SEQ_CLIENTS, "batch_size": SEQ_BATCH,
                   "history": args.long_history, "finetune_history": SEQ_FT_HISTORY,
                   "num_news": SEQ_NEWS, "finetune_num_news": SEQ_FT_NEWS, "dropout_rate": cfg.model.dropout_rate,
                   "wire": "gloo over pinned host buffers"},
        "legs": legs_out,
        "ring_repeat_bitwise": True,
        "ring_hop": {"ms": hop["ms"] / hop["calls"], "bytes": hop["bytes"] / hop["calls"],
                     "calls_per_step": hop["calls"] / SEQ_RING_STEPS},
        "ulysses_all_to_all": {"ms": a2a["ms"] / a2a["calls"],
                               "bytes": a2a["bytes"] / a2a["calls"],
                               "calls_per_step": a2a["calls"] / SEQ_ULYSSES_STEPS},
        "startup_to_first_step_s": [r["legs"]["ring"]["first_step_at"] - r["started_at"]
                                    for r in res],
        "table_on_card_s": [r["table_s"] for r in res],
        "world_wall_s": world["wall_s"],
        "cli": {"final": fields, "wall_s": cli_s},
        "launches": {KERNEL_LETTER.get(k, k): v for k, v in launches_total.items() if v},
    }


# ---------------------------------------------------------- auto_codec_path
AUTO_ROUNDS = 3


def _auto_run(state: dict, args, obs: Path | None):
    """The auto-codec ``Trainer.run``: param_avg, K x ``--trainer-steps``
    at B = ``--batch-size``, AUTO_ROUNDS evaluated rounds, the map pinned
    after round 0; each round's wall ms."""
    from fedrec_tpu_torch.data import MindData  # noqa: F401
    from fedrec_tpu_torch.train import Trainer

    cfg = _trainer_cfg(args, "", "fed.dcn_compress=auto", "fed.dcn_auto_warmup=1",
                       f"fed.rounds={AUTO_ROUNDS}", "train.keep_best=false",
                       *([f"obs.dir={obs}"] if obs is not None else []))
    T, Dh = cfg.data.max_title_len, cfg.model.bert_hidden
    trainer = Trainer(cfg, _mind_data(state, args, T), _tokens(state, args, T, Dh), device=DEV)
    round_ms: list = []
    _time_calls(trainer, "train_round", round_ms)
    with contextlib.redirect_stdout(io.StringIO()) as quiet:
        history = trainer.run()
    return trainer, history, round_ms, quiet.getvalue()


def phase_auto_codec_path(state: dict, args) -> dict:
    """``fed.dcn_compress=auto`` through ``Trainer``: the per-leaf codec
    map pinned from the warm-up round's delta, then the compressed rounds."""
    import tempfile

    import torch
    from fedrec_tpu_torch.comms.codecs import encode_tree, leaf_names, payload_nbytes
    from fedrec_tpu_torch.obs.report import build_report, load_jsonl
    from fedrec_tpu_torch.ops import launch_counts, reset_launch_counts

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        obs = Path(tmp) / "obs"
        reset_launch_counts()
        trainer, history, round_ms, printed = _auto_run(state, args, obs)
        torch.cuda.synchronize()
        launches = launch_counts()
        pin = trainer.auto_codec_pin
        check(pin is not None and pin["pinned_at_round"] == 0, f"the map pinned at {pin}")
        check("pinned per-leaf codec map after round 0" in printed, "no pin line printed")
        check(all(d["codec"] == "none" for d in pin["detail"] if d["n"] <= 64),
              "a leaf of <= 64 elements was compressed")
        saved = json.loads((obs / "codec_map.json").read_text())
        check(saved["map"] == pin["map"], "codec_map.json differs from the pinned map")
        report = build_report(*load_jsonl(obs / "metrics.jsonl"))
        check(report.get("communication", {}).get("auto_codec_map") == pin["map"],
              "the report carries no auto_codec_map")
    codec_b, dense_b = trainer._codec_bytes_per_client, trainer._dense_bytes_per_client
    check(codec_b is not None and codec_b < dense_b,
          f"bytes up a client after the pin {codec_b} vs the dense tree's {dense_b}")
    for r in history:
        check(math.isfinite(r.train_loss), f"round {r.round_idx}: loss {r.train_loss}")
        check(all(0.0 <= r.val_metrics[k] <= 1.0 for k in ("auc", "mrr", "ndcg5", "ndcg10")),
              f"round {r.round_idx}: metrics {r.val_metrics}")
    K, S = args.clients, args.trainer_steps
    for name in ("fused_gather_encode", "fused_gather_encode_bwd", "fused_history_score",
                 "fused_history_score_bwd"):
        check(launches.get(name, 0) >= K * S * AUTO_ROUNDS,
              f"{name} launched {launches.get(name, 0)} times in {AUTO_ROUNDS} rounds of "
              f"{K} x {S} steps")
    params = _trainer_params(trainer)
    again, history2, _, _ = _auto_run(state, args, None)
    check(again.auto_codec_pin["map"] == pin["map"]
          and [r.train_loss for r in history2] == [r.train_loss for r in history]
          and all(torch.equal(a, b) for a, b in zip(_trainer_params(again), params)),
          "the auto run repeated gave other bits")
    state.setdefault("launches", {})["auto_codec"] = launches
    # compression by leaf under the pinned map
    host = trainer._client0_params()
    enc = encode_tree(host, "auto", trainer.cfg.fed.dcn_topk_ratio,
                      sketch_width=trainer.cfg.fed.dcn_sketch_width,
                      sketch_seed=trainer.cfg.fed.dcn_sketch_seed,
                      leaf_codecs=list(pin["map"].values()))
    by_leaf = {name: {"codec": c, "n": int(np.prod(shape)) if shape else 1,
                      "ratio": (4 * (int(np.prod(shape)) if shape else 1))
                      / max(payload_nbytes(p), 1)}
               for name, c, p, shape in zip(leaf_names(host), pin["map"].values(), enc.payloads,
                                             enc.shapes)}
    counts: dict = {}
    for c in pin["map"].values():
        counts[c] = counts.get(c, 0) + 1
    del trainer, again
    torch.cuda.empty_cache()
    return {
        "config": {"clients": K, "steps": S, "batch_size": args.batch_size,
                   "rounds": AUTO_ROUNDS, "warmup": 1, "valid": args.valid},
        "pin_ms": pin["pin_ms"], "map_counts": counts,
        "round_ms": round_ms, "round_ms_before_pin": round_ms[0],
        "round_ms_after_pin": round_ms[1:],
        "bytes_up_per_client": {"dense": dense_b, "after_pin": codec_b,
                                "ratio": dense_b / codec_b},
        "compression_by_leaf": by_leaf,
        "losses": [r.train_loss for r in history],
        "val_auc": [r.val_metrics["auc"] for r in history],
        "repeat_bitwise": True,
        "launches": {KERNEL_LETTER.get(k, k): v for k, v in launches.items() if v},
    }


def kernels_line(state: dict) -> dict:
    """One entry per kernel: launches and error from the path that runs it
    (A, B: main_path; C, D, E: train_path; A2, F1, F2, F3: long_path), its
    launches on every path (safety_path runs A through F3, A and F1-F3
    under the per-example transform; trainer_path, cohort_path, async_path and
    data_path run A through E, decoupled_path and family_path A, B and E,
    serving_path A and B, auto_codec_path A through E), times from the
    kernels phase. ``launches_by_path["coordinator"]``, ``["elastic"]``,
    ``["wire"]`` and ``["seq"]`` sum the worker processes' own counts (A
    through E; the seq ranks' joint legs A)."""
    out = []
    for name, meta in KERNEL_META.items():
        t = state["timing"][name]
        out.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "path": meta["path"],
            "launches": state["launches"][meta["path"]][name],
            "launches_by_path": {path: counts[name] for path, counts in state["launches"].items()
                                 if counts.get(name)},
            "max_abs_err": state["path_errs"][name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "dtype": t["dtype"],
            **({"library": t["library"]} if "library" in t else {}),
        })
    return {"kernels": out}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--seq-rank" in argv:  # one rank of seq_path's world
        return _seq_rank_main(argv)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ",".join(PHASES))
    p.add_argument("--num-news", type=int, default=65536)
    p.add_argument("--chunk", type=int, default=2048)
    p.add_argument("--pool-rows", type=int, default=4096,
                   help="rows of the additive_pool check against its plain version")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--waves", default="1,1,1,1,8,8,8,32,32,128,128,200",
                   help="requests sent together, wave after wave")
    p.add_argument("--scorer-reps", type=int, default=20)
    p.add_argument("--clients", type=int, default=4, help="train_path: federated clients")
    p.add_argument("--local-steps", type=int, default=8, help="train_path: steps per client in the round")
    p.add_argument("--batch-size", type=int, default=64, help="train_path: per-client batch")
    p.add_argument("--long-history", type=int, default=2048,
                   help="long_path: history length (requests carry half to all of it)")
    p.add_argument("--long-waves", default="1,8,32,128", help="long_path: request waves")
    p.add_argument("--long-scorer-reps", type=int, default=5)
    p.add_argument("--long-clients", type=int, default=2, help="long_path: federated clients")
    p.add_argument("--long-local-steps", type=int, default=4)
    p.add_argument("--long-batch-size", type=int, default=16)
    p.add_argument("--long-traj-steps", type=int, default=3,
                   help="long_path: steps of the kernel route against the dense route")
    p.add_argument("--flash-bh", type=int, default=320,
                   help="kernels: batch x heads of the flash kernels' checks (16 x 20)")
    p.add_argument("--trainer-steps", type=int, default=4,
                   help="trainer_path, decoupled_path: steps per client a local epoch")
    p.add_argument("--valid", type=int, default=8192,
                   help="trainer_path, decoupled_path: validation impressions (full-pool evaluation)")
    p.add_argument("--serving-waves", default="1,8,32,128",
                   help="serving_path: concurrent requests a wave, round after round")
    p.add_argument("--serving-clusters", type=int, default=256,
                   help="serving_path: k-means clusters over the catalog")
    p.add_argument("--serving-probe", type=int, default=16,
                   help="serving_path: clusters reranked a request")
    p.add_argument("--million-news", type=int, default=1_000_000,
                   help="serving_path: the serve CLI's million-item mode's catalog")
    p.add_argument("--cohort-population", type=int, default=256,
                   help="cohort_path: logical clients sampled onto the --clients slots")
    p.add_argument("--cohort-shard", type=int, default=128,
                   help="cohort_path: training rows a logical client owns")
    p.add_argument("--cohort-resident", type=int, default=8,
                   help="cohort_path: sidecars kept in host memory; the rest spill to disk")
    p.add_argument("--robust-clients", type=int, default=16,
                   help="safety_path: the clients of the second round-end sync timing")
    p.add_argument("--data-users", type=int, default=50_000,
                   help="data_path: users of the raw MIND tsv (MIND-small's 50,000)")
    p.add_argument("--data-impressions", type=int, default=157_000,
                   help="data_path: training impressions of the raw tsv (MIND-small's ~157,000)")
    p.add_argument("--data-joint-steps", type=int, default=4,
                   help="data_path: steps a client in the joint round on the trunk's states")
    p.add_argument("--finetune-steps", type=int, default=2,
                   help="data_path: steps a client a finetune round (2 rounds)")
    p.add_argument("--data-rec-users", type=int, default=8192,
                   help="data_path: users the recommend CLI serves from the finetune snapshot")
    p.add_argument("--family-fill-samples", type=int, default=204_800,
                   help="family_path: click samples of the native-vs-Python epoch fill "
                        "(MIND-small's ~204k)")
    p.add_argument("--family-rec-users", type=int, default=2048,
                   help="family_path: users the recommend CLI serves from the GRU+CNN snapshot")
    p.add_argument("--family-chaos-news", type=int, default=2048,
                   help="family_path: the nan chaos run's catalog (its dump keeps the table)")
    p.add_argument("--coord-valid", type=int, default=2048,
                   help="coordinator_path: validation impressions of the one evaluation")
    p.add_argument("--coord-rec-users", type=int, default=2048,
                   help="coordinator_path: users the recommend CLI serves from the last global")
    args = p.parse_args(argv)
    args.waves = [int(w) for w in args.waves.split(",")]
    args.serving_waves = [int(w) for w in args.serving_waves.split(",")]
    args.long_waves = [int(w) for w in args.long_waves.split(",")]
    phases = [ph for ph in args.phases.split(",") if ph]
    unknown = set(phases) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")
    for path in PATHS[:-1]:  # serving_path reports no kernel's own time
        if path in phases and "kernels" not in phases:
            p.error(f"{path} needs the kernels phase (it reports the kernels' times)")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 2
    try:
        import fedrec_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the fedrec_tpu_torch package is not here: {e}", file=sys.stderr)
        return 3

    state: dict = {}
    runners = {
        "device": lambda: phase_device(state),
        "build": lambda: phase_build(state),
        "kernels": lambda: phase_kernels(state, args),
        "main_path": lambda: phase_main_path(state, args),
        "train_path": lambda: phase_train_path(state, args),
        "long_path": lambda: phase_long_path(state, args),
        "trainer_path": lambda: phase_trainer_path(state, args),
        "decoupled_path": lambda: phase_decoupled_path(state, args),
        "safety_path": lambda: phase_safety_path(state, args),
        "cohort_path": lambda: phase_cohort_path(state, args),
        "data_path": lambda: phase_data_path(state, args),
        "family_path": lambda: phase_family_path(state, args),
        "coordinator_path": lambda: phase_coordinator_path(state, args),
        "elastic_path": lambda: phase_elastic_path(state, args),
        "async_path": lambda: phase_async_path(state, args),
        "wire_path": lambda: phase_wire_path(state, args),
        "seq_path": lambda: phase_seq_path(state, args),
        "auto_codec_path": lambda: phase_auto_codec_path(state, args),
        "serving_path": lambda: phase_serving_path(state, args),
    }
    try:
        for ph in ["device", *[q for q in PHASES[1:] if q in phases]]:
            t0 = time.perf_counter()
            try:
                result = runners[ph]()
            except Exception as e:  # noqa: BLE001 — report the phase, then fail the run
                traceback.print_exc()
                emit({"phase": ph, "ok": False, "error": f"{type(e).__name__}: {e}"[:4000]})
                return 1
            emit({"phase": ph, "ok": True, "seconds": time.perf_counter() - t0, **result})
    finally:
        if "token_file" in state:
            state["token_file"].unlink(missing_ok=True)
    if all(path in phases for path in PATHS):
        emit(kernels_line(state))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
