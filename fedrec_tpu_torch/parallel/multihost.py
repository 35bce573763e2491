"""Multi-process rendezvous and the coordinator's round control on
``torch.distributed`` (gloo), the port of ``fedrec_tpu/parallel/multihost.py``.

The reference's deployment (``client.py`` / ``server.py``, ``README.md:27-46``)
is a server that broadcasts the weights, clients that train disjoint shards,
and a gather of their updates. Here:

* rendezvous: a ``TCPStore`` hosted by process 0 and a ``ProcessGroupGloo``
  over it (:func:`initialize_distributed`), an object of its own
  (:class:`World`) rather than the default process group, so that a failed
  bring-up is abandoned in place and retried on the next port;
* the server's fan-out (:func:`broadcast_params`), the round counter
  (:func:`broadcast_round_index`, -1 = stop) and the gather
  (:func:`aggregate_from_hosts`) travel as fixed-size host byte tensors: every
  process holds the same tree and codec, so a contribution packs to the same
  number of bytes everywhere (no pickling);
* every collective runs under a watchdog (:class:`CoordinatorRuntime`): the
  first timeout or error marks the world broken (``degraded``), later calls
  take the local path, and the exit is device-free (``os._exit``).

Every rank uses one device (``cuda:0`` on a one-card machine): the wire is
gloo over host buffers and the reduction is numpy on the host, as in the JAX
package. NCCL, which wants a GPU per rank, is ROADMAP.md's Queue A item 9.
"""

from __future__ import annotations

import atexit
import datetime
import os
import random
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from fedrec_tpu_torch.comms.codecs import (
    CodecState,
    codec_caps,
    codec_uses_feedback,
    decode_gathered,
    decode_leaf,
    decode_tree,
    encode_tree,
    leaf_names,
    payload_nbytes,
    sum_payloads,
    tree_dense_nbytes,
    tree_rmse,
    validate_codec,
)
from fedrec_tpu_torch.fed.robust import robust_reduce_tree_np, validate_robust_method
from fedrec_tpu_torch.obs import get_registry
from fedrec_tpu_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten

# gloo's own per-operation timeout: a backstop behind the watchdog, so that
# a collective abandoned by the watchdog ends its thread eventually
_GLOO_TIMEOUT_S = 600.0

# start_round's control value beside -1 (stop): the elastic membership layer
# wants the world to reform at this boundary (a peer rejoined, or a lease
# expired); every worker that receives it saves a hand-off state and leaves
REFORM_SIGNAL = -2


@dataclass
class World:
    """One process's membership in a fixed world: its rank, the world size,
    the rendezvous store (hosted by rank 0) and the gloo process group."""

    rank: int
    size: int
    store: Any = None
    pg: Any = None


def _attempt_address(addr: str, attempt: int) -> str:
    """Rendezvous address of retry ``attempt``: the port plus the attempt
    index, a schedule every peer derives alike."""
    if attempt == 0:
        return addr
    host, port = addr.rsplit(":", 1)
    return f"{host}:{int(port) + attempt}"


def _probe_transport(world: World, timeout_s: float) -> None:
    """One bounded barrier after the rendezvous: gloo's pairs connect at the
    first collective, where a transport flake shows. A failure or a timeout
    fails the attempt on every peer, which then realign on the next port."""
    errs: list = []

    def target():
        try:
            world.pg.barrier().wait()
        except RuntimeError as exc:  # the transport's own failure
            errs.append(exc)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout_s)
    if errs:
        raise RuntimeError(f"transport probe failed: {errs[0]!r}")
    if t.is_alive():
        raise RuntimeError(f"transport probe timed out after {timeout_s}s")


def initialize_distributed(
    coordinator_address: str | None,
    num_processes: int | None,
    process_id: int | None,
    initialization_timeout: float | None = None,
    rendezvous_retries: int = 2,
    probe_timeout_s: float = 30.0,
) -> World:
    """Join the fixed world at ``coordinator_address`` (``HOST:PORT``, where
    process 0 hosts the store) as ``process_id`` of ``num_processes``; a
    one-process world when no address is given or the size is 1.

    Each attempt ends with a bounded transport probe; a failed probe
    abandons the attempt's store and group in place (they are never torn
    down: a teardown on a broken world can block) and every peer
    re-rendezvouses on ``port + attempt`` after a jittered backoff. A
    rendezvous that itself fails raises at once: it is not collective, and
    retrying it alone would walk this peer off the schedule."""
    size = int(num_processes or 1)
    if coordinator_address is None or size == 1:
        return World(rank=int(process_id or 0), size=1)
    rank = int(process_id)
    if not 0 <= rank < size:
        raise ValueError(f"--process-id {rank} is outside the world of {size}")
    timeout = datetime.timedelta(seconds=float(initialization_timeout or 300.0))
    attempts = max(int(rendezvous_retries), 0) + 1
    rng = random.Random(os.getpid())
    for attempt in range(attempts):
        host, port = _attempt_address(coordinator_address, attempt).rsplit(":", 1)
        store = dist.TCPStore(host, int(port), size, rank == 0, timeout=timeout)
        pg = dist.ProcessGroupGloo(store, rank, size,
                                   datetime.timedelta(seconds=_GLOO_TIMEOUT_S))
        world = World(rank=rank, size=size, store=store, pg=pg)
        try:
            _probe_transport(world, probe_timeout_s)
            return world
        except RuntimeError as exc:
            if attempt + 1 >= attempts:
                raise
            delay = min(1.0 * (attempt + 1), 5.0) * (0.5 + rng.random())
            print(f"[multihost] transport probe attempt {attempt + 1}/{attempts} failed "
                  f"({exc}); re-rendezvous on "
                  f"{_attempt_address(coordinator_address, attempt + 1)} in {delay:.1f}s",
                  flush=True)
            time.sleep(delay)
    raise AssertionError("unreachable")


# ------------------------------------------------------------ byte packing
def _pack(leaves: list[np.ndarray]) -> tuple[np.ndarray, list[tuple]]:
    """Leaves as one contiguous uint8 buffer and the layout that unpacks it."""
    # np.array, not ascontiguousarray, which makes a 0-d scale 1-d
    arrays = [np.array(x, order="C") for x in leaves]
    layout = [(a.dtype, a.shape) for a in arrays]
    buf = (np.concatenate([a.reshape(-1).view(np.uint8) for a in arrays]) if arrays
           else np.zeros(0, np.uint8))
    return buf, layout


def _unpack_rows(rows: np.ndarray, layout: list[tuple]) -> list[np.ndarray]:
    """(P, nbytes) gathered buffers to one (P, *shape) stack per leaf."""
    out, offset = [], 0
    for dtype, shape in layout:
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        chunk = np.ascontiguousarray(rows[:, offset:offset + n])
        out.append(chunk.view(dtype).reshape((rows.shape[0],) + tuple(shape)))
        offset += n
    return out


def _allgather_stacked(tree_and_weight: tuple, world: World | None = None) -> tuple:
    """Gather ``(tree, weight)`` from every process in one collective: the
    tree's leaves and the f32 weight packed into one byte tensor of the
    same size everywhere. Returns the tree with a leading (P,) dim on every
    leaf and the (P,) f32 weights; a one-process world adds the dim by
    hand."""
    tree, weight = tree_and_weight
    leaves, treedef = tree_flatten(tree)
    w = np.asarray(weight, np.float32).reshape(())
    if world is None or world.size == 1:
        return tree_unflatten(treedef, [np.asarray(x)[None] for x in leaves]), w[None]
    buf, layout = _pack([*leaves, w])
    send = torch.from_numpy(buf)
    outs = [torch.empty_like(send) for _ in range(world.size)]
    world.pg.allgather([outs], [send]).wait()
    stacked = _unpack_rows(torch.stack(outs).numpy(), layout)
    return tree_unflatten(treedef, stacked[:-1]), stacked[-1].astype(np.float32)


def broadcast_params(params: Any, world: World, is_source: bool) -> Any:
    """The server's fan-out: ``params`` (a tree of arrays) from process 0 to
    all, as one byte buffer of the tree's leaves."""
    leaves, treedef = tree_flatten(params)
    buf, layout = _pack([np.asarray(x) for x in leaves])
    t = torch.from_numpy(buf.copy())
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    world.pg.broadcast([t], opts).wait()
    if is_source:
        return params
    return tree_unflatten(treedef, [x[0] for x in _unpack_rows(t.numpy()[None], layout)])


def broadcast_round_index(round_idx: int, world: World) -> int:
    """The server's round counter to every process; -1 = stop. Pins every
    process to the server's counter (batch seeds, save cadence, labels)."""
    t = torch.tensor([int(round_idx)], dtype=torch.int64)
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    world.pg.broadcast([t], opts).wait()
    return int(t.item())


def _bank_dcn_bytes(up: int = 0, down: int = 0, dense: int = 0, encoded: int = 0) -> None:
    """Publish the bytes that crossed the wire (``path="dcn"``), measured
    from the buffers shipped."""
    reg = get_registry()
    if up:
        reg.counter("fed.dcn_bytes_up_total",
                    "client->server round-update bytes shipped, by path",
                    labels=("path",)).inc(float(up), path="dcn")
    if down:
        reg.counter("fed.dcn_bytes_down_total",
                    "server->client fan-out bytes (full precision), by path",
                    labels=("path",)).inc(float(down), path="dcn")
    if dense and encoded:
        reg.gauge("fed.dcn_compression_ratio",
                  "dense/encoded byte ratio of one client's round-update payload"
                  ).set(dense / encoded)


def aggregate_from_hosts(
    params: Any,
    weight: float = 1.0,
    compress: str = "none",
    base: Any = None,
    robust: Any = None,
    codec_state: CodecState | None = None,
    topk_ratio: float = 0.01,
    error_feedback: bool = True,
    agg: Any = None,
    sketch_width: float = 0.1,
    sketch_seed: int = 0,
    world: World | None = None,
    gather: Callable | None = None,
    timings: dict | None = None,
) -> Any:
    """Participation-weighted FedAvg across processes; every process gets
    the aggregate. ``params`` is this process's contribution tree (the
    Flax-layout ``(user, news)`` pair), ``weight`` its mass (0 = sat out).

    With a codec (``compress``) the round delta ``params - base`` (plus the
    error-feedback residual in ``codec_state`` for a biased codec, banked
    only when ``weight > 0``) is encoded and the payloads travel. Codecs
    that decode per contribution are densified per process before any
    reduction, so ``robust`` (a ``fed.robust`` section, method not
    ``mean``) composes with them; the linear sketches are summed in sketch
    space and decoded once (mean only). ``agg`` with ``mode =
    "hierarchical"`` reduces a robust method up an ``agg.tree_fanout``
    tree (``agg.tier_reduce_ms``); with ``mean`` it lowers to the flat
    reduce. Without a codec the dense tree travels: ``params * weight``
    summed over the processes and divided by the total weight, or the
    robust reduction of the raw stacks. Nobody reporting keeps ``params``.
    The arithmetic is the JAX package's, line for line. ``gather`` replaces
    the collective (``_allgather_stacked``'s signature): the in-process
    emulation (:func:`emulate_aggregate`) uses it. ``timings`` (out)
    receives ``encode_ms`` (up to the collective) and ``gather_ms`` (the
    collective, its wait for the slowest peer included)."""
    collective = gather or _allgather_stacked
    t_start = time.perf_counter()

    def gather(tree_and_weight, world):
        t0 = time.perf_counter()
        out = collective(tree_and_weight, world)
        if timings is not None:
            timings["encode_ms"] = (t0 - t_start) * 1e3
            timings["gather_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    validate_codec(compress)
    w_arr = np.asarray(weight, np.float32)
    method = getattr(robust, "method", "mean") if robust is not None else "mean"
    hier = getattr(agg, "mode", "flat") == "hierarchical" and method != "mean"

    def _robust_reduce(stacks, w_np, fallback):
        if not hier:
            return robust_reduce_tree_np(stacks, w_np, method, trim_k=robust.trim_k,
                                         clip_norm=robust.clip_norm, fallback_tree=fallback)
        from fedrec_tpu_torch.agg.hierarchy import tree_critical_path_ms, tree_reduce_np

        stats: dict = {}
        reduced = tree_reduce_np(stacks, w_np, int(getattr(agg, "tree_fanout", 2)), method,
                                 trim_k=robust.trim_k, clip_norm=robust.clip_norm,
                                 fallback_tree=fallback, stats=stats)
        get_registry().gauge(
            "agg.tier_reduce_ms",
            "per-level-max tier-reduce time of the last hierarchical round, summed over "
            "levels (the tree's parallel critical path)").set(tree_critical_path_ms(stats))
        return reduced

    if method != "mean":
        validate_robust_method(method)
        if compress != "none" and not codec_caps(compress).decodes_per_contribution:
            raise ValueError(
                f"fed.robust.method={method!r} needs per-contribution decode, which codec "
                f"{compress!r} cannot provide (its contributions only exist pre-aggregated: "
                "order statistics like trimmed-mean/median judge CLIENTS, and sketch "
                "collisions mix every client's coordinates before any decode exists); use "
                "one of the decodable codecs (int8/sign1bit/topk) or fed.robust.method='mean'"
            )

    def _as_params(reduced):
        return tree_map(lambda m, p: np.asarray(m, np.asarray(p).dtype), reduced, params)

    if compress != "none":
        raw = tree_map(lambda p: np.asarray(p, np.float32), params)
        contrib = (tree_map(lambda p, b: p - np.asarray(b, np.float32), raw, base)
                   if base is not None else raw)
        use_ef = codec_uses_feedback(compress, error_feedback)
        if use_ef and codec_state is not None and codec_state.residual is not None:
            acc = tree_map(lambda c, r: c + np.asarray(r, np.float32), contrib,
                           codec_state.residual)
        else:
            acc = contrib
        enc = encode_tree(acc, compress, topk_ratio, sketch_width=sketch_width,
                          sketch_seed=sketch_seed)
        own_decoded = decode_tree(enc)
        if use_ef and codec_state is not None and float(w_arr) > 0:
            codec_state.residual = tree_map(lambda a, d: a - d, acc, own_decoded)
        any_sketch = not codec_caps(compress).decodes_per_contribution
        # one collective for payload and weight
        gathered, weights = gather((enc.payloads, w_arr), world)
        _bank_dcn_bytes(up=enc.nbytes(), dense=tree_dense_nbytes(acc), encoded=enc.nbytes())
        reg = get_registry()
        ratio_leaf = reg.gauge("fed.dcn_compression_ratio_leaf",
                               "dense/encoded byte ratio of one round-update tensor, by leaf",
                               labels=("leaf",))
        for name, payload, shape in zip(leaf_names(acc), enc.payloads, enc.shapes):
            dense_b = 4 * int(np.prod(shape)) if shape else 4
            ratio_leaf.set(dense_b / max(payload_nbytes(payload), 1), leaf=name)
        if any_sketch:
            reg.gauge("fed.dcn_sketch_rmse",
                      "RMSE of this process's sketch round-trip (decode(encode(x)) vs x), "
                      "pooled over all sketched coordinates").set(tree_rmse(own_decoded, acc))
        total = float(np.sum(weights))
        if total == 0.0:
            return params
        w_np = np.asarray(weights)
        if method != "mean":
            # m == 0 coordinates keep this process's own decoded contribution
            reduced = _robust_reduce(decode_gathered(gathered, enc), w_np, own_decoded)
        else:
            coeff = (np.where(w_np > 0, w_np, 0.0) / total).astype(np.float32)
            mask_p = w_np > 0

            def _mask_rows(v):
                # a zero-weight row is masked out, not multiplied in: a
                # quarantined process's NaN payload contributes nothing
                a = np.asarray(v, np.float32)
                return np.where(mask_p.reshape((-1,) + (1,) * (a.ndim - 1)), a, 0.0)

            out_leaves = []
            for i, (payload, shape) in enumerate(zip(gathered, enc.shapes)):
                masked = {k: _mask_rows(v) for k, v in payload.items()}
                if any_sketch:
                    out_leaves.append(decode_leaf(sum_payloads(masked, coeff), compress, shape,
                                                  sketch_seed=enc.sketch_seed, leaf_id=i))
                else:
                    rows = np.stack([
                        decode_leaf({k: v[p] for k, v in masked.items()}, compress, shape,
                                    sketch_seed=enc.sketch_seed, leaf_id=i)
                        for p in range(len(w_np))])
                    out_leaves.append(np.einsum("p,p...->...", coeff, rows))
            reduced = tree_unflatten(enc.treedef, out_leaves)
        if base is not None:
            reduced = tree_map(lambda m, b: m + np.asarray(b, np.float32), reduced, base)
        return _as_params(reduced)

    if method != "mean":
        raw = tree_map(lambda p: np.asarray(p, np.float32), params)
        gathered, weights = gather((raw, w_arr), world)
        _bank_dcn_bytes(up=tree_dense_nbytes(raw))
        if float(np.sum(weights)) == 0.0:
            return params
        return _as_params(_robust_reduce(gathered, np.asarray(weights), raw))
    weighted = tree_map(lambda p: np.asarray(p) * weight, params)
    _bank_dcn_bytes(up=tree_dense_nbytes(weighted))
    gathered, weights = gather((weighted, w_arr), world)
    total = float(np.sum(weights))
    if total == 0.0:
        return params
    return tree_map(lambda g: np.sum(g, axis=0) / total, gathered)


class _Sent(Exception):
    """Ends an emulated process's first pass at its gather."""


def emulate_aggregate(params_list: list, weights: list, base: Any = None,
                      codec_states: list | None = None, **kwargs) -> list:
    """One gathered round of :func:`aggregate_from_hosts` over
    ``len(params_list)`` processes, run in this process: each process's
    contribution is first encoded as it would travel (on a copy of its
    codec state), the contributions are stacked as the collective stacks
    them, then every process reduces the same stacks, banking its residual
    into ``codec_states[p]``. Returns each process's aggregate. The twin of a
    real world that the coordinator's checks hold it to."""
    import copy

    codec_states = codec_states or [None] * len(params_list)
    sent: list = []

    def record(tree_and_weight, world=None):
        sent.append(tree_and_weight)
        raise _Sent

    for params, w, cs in zip(params_list, weights, codec_states):
        try:
            aggregate_from_hosts(params, w, base=base, codec_state=copy.deepcopy(cs),
                                 gather=record, **kwargs)
        except _Sent:
            pass
    stacked = (tree_map(lambda *xs: np.stack(xs), *[t for t, _ in sent]),
               np.asarray([np.asarray(w, np.float32) for _, w in sent], np.float32))
    return [aggregate_from_hosts(params, w, base=base, codec_state=cs,
                                 gather=lambda tw, world=None: stacked, **kwargs)
            for params, w, cs in zip(params_list, weights, codec_states)]


class CoordinatorRuntime:
    """The host-level round loop's collectives for the client/server
    deployment; process 0 is the server. In a one-process world every
    method takes the local path.

    Every collective runs under a watchdog (``collective_timeout_s``): on
    the first timeout or error the runtime flips to ``degraded``, says so
    on stdout, and every later call returns its local fallback; the thread
    left in the dead collective is a daemon and is never joined. Every such
    failure counts ``fed.dcn_deadline_misses_total`` (the JAX package counts
    only the round deadline's); ``round_deadline_s`` bounds the round's
    gather in particular (``deadline_misses``). The store lives in process 0,
    so a server that has gone while a slow client waits makes that
    client's next collective fail (bounded), never wedge.
    """

    def __init__(
        self,
        world: World,
        collective_timeout_s: float | None = None,
        compress: str = "none",
        robust: Any = None,
        round_deadline_s: float | None = None,
        topk_ratio: float = 0.01,
        error_feedback: bool = True,
        agg: Any = None,
        sketch_width: float = 0.1,
        sketch_seed: int = 0,
        membership: Any = None,
        epoch: int = 0,
    ):
        self.world = world
        self.process_id = world.rank
        self.num_processes = world.size
        # elastic membership (parallel.membership): the client whose lease
        # thread latches reform_pending, and this world's epoch; None is the
        # fixed world, where start_round never signals a reform
        self.membership = membership
        self.epoch = int(epoch)
        self.collective_timeout_s = collective_timeout_s
        self.round_deadline_s = round_deadline_s
        self.deadline_misses = 0
        self.degraded_by_timeout = False
        self.compress = validate_codec(compress)
        self.robust = robust
        self.agg = agg
        self.topk_ratio = topk_ratio
        self.error_feedback = error_feedback
        self.sketch_width = sketch_width
        self.sketch_seed = sketch_seed
        # this process's wire-endpoint error-feedback residual
        self.codec_state = (CodecState() if codec_uses_feedback(self.compress, error_feedback)
                            else None)
        self.degraded = False
        self.degraded_at: float | None = None  # wall clock (time.time) of the degrade
        self._shutdown_done = False
        # wall ms of the last call of each kind (the gather's encode, gather
        # and decode + reduce parts too), for the caller's report
        self.last_ms: dict[str, float] = {}
        if self.num_processes > 1:
            # a caller that never reaches finalize still gets the barrier
            atexit.register(self._synchronized_shutdown)

    @property
    def is_server(self) -> bool:
        return self.process_id == 0

    def _collective(self, fn: Callable[[], Any], fallback: Callable[[], Any],
                    timeout_s: float | None = None, kind: str = "collective") -> Any:
        """One collective under the watchdog; the local fallback once the
        world is known broken."""
        if self.degraded:
            return fallback()
        timeout = timeout_s if timeout_s is not None else self.collective_timeout_s
        box: list = []
        errs: list = []

        def target():
            try:
                box.append(fn())
            except Exception as exc:  # noqa: BLE001 — a collective error is a peer failure
                errs.append(exc)

        t = threading.Thread(target=target, daemon=True)
        t.start()
        t.join(timeout or None)
        if t.is_alive() or errs:
            timed_out = t.is_alive()
            why = f"error: {errs[0]!r}" if errs else f"timeout after {timeout}s"
            print(f"[multihost] process {self.process_id}: {kind} failed ({why}); degrading "
                  "to standalone training for the remaining rounds", flush=True)
            self.degraded = True
            self.degraded_at = time.time()
            self.degraded_by_timeout = timed_out
            get_registry().counter(
                "fed.dcn_deadline_misses_total",
                "collectives that did not complete by their watchdog or the round "
                "deadline (the host degraded to standalone)").inc()
            return fallback()
        return box[0]

    def start_round(self, round_idx: int, total_rounds: int) -> int:
        """The server's round index for the next round, -1 to stop, or
        :data:`REFORM_SIGNAL` when the server's membership client has
        latched ``reform_pending``; locally (one process, or degraded) the
        caller's own counter. The reform travels in the round index's
        broadcast, so every worker leaves at the same boundary."""
        local = round_idx if round_idx < total_rounds else -1
        if (self.membership is not None and self.is_server and local >= 0
                and self.membership.reform_pending):
            local = REFORM_SIGNAL
        if self.num_processes == 1:
            return local
        return self._collective(
            lambda: broadcast_round_index(local if self.is_server else 0, self.world),
            lambda: local)

    def sync_from_server(self, params: Any) -> Any:
        """Every process adopts the server's ``params`` (full precision in
        every codec mode)."""
        if self.num_processes == 1:
            return params
        t0 = time.perf_counter()
        out = self._collective(
            lambda: broadcast_params(params, self.world, self.is_server), lambda: params)
        self.last_ms["sync_from_server"] = (time.perf_counter() - t0) * 1e3
        if not self.degraded:
            _bank_dcn_bytes(down=tree_dense_nbytes(params))
        return out

    def aggregate(self, params: Any, participated: bool = True, weight: float = 1.0,
                  base: Any = None) -> Any:
        """Weighted FedAvg across processes (:func:`aggregate_from_hosts`):
        this process's mass is ``weight``, 0 when it did not participate;
        ``base`` is the round-start global every process holds."""
        if self.num_processes == 1:
            return params
        w = float(weight) if participated else 0.0
        deadline = self.round_deadline_s
        before = self.degraded
        parts: dict = {}
        t0 = time.perf_counter()
        out = self._collective(
            lambda: aggregate_from_hosts(
                params, w, compress=self.compress, base=base, robust=self.robust,
                codec_state=self.codec_state, topk_ratio=self.topk_ratio,
                error_feedback=self.error_feedback, agg=self.agg,
                sketch_width=self.sketch_width, sketch_seed=self.sketch_seed,
                world=self.world, timings=parts),
            lambda: params,
            timeout_s=deadline if deadline else None,
            kind=f"round aggregation (deadline {deadline}s)" if deadline else "collective")
        self.last_ms["aggregate"] = (time.perf_counter() - t0) * 1e3
        if "gather_ms" in parts:
            # the rest of the call: decode and reduce
            self.last_ms.update(
                encode=parts["encode_ms"], gather=parts["gather_ms"],
                reduce=self.last_ms["aggregate"] - parts["encode_ms"] - parts["gather_ms"])
        if deadline and self.degraded and not before and self.degraded_by_timeout:
            self.deadline_misses += 1
        return out

    def _synchronized_shutdown(self) -> None:
        """A healthy world's exit: one barrier under the watchdog (bounded at
        60 s without one), so no process leaves while another still needs
        the store that process 0 hosts."""
        if self._shutdown_done or self.degraded or self.num_processes == 1:
            return
        self._shutdown_done = True
        if not self.collective_timeout_s:
            self.collective_timeout_s = 60.0
        self._collective(lambda: self.world.pg.barrier().wait(), lambda: None,
                         kind="shutdown barrier")

    def finalize(self, exit_code: int = 0) -> None:
        """After the round loop: a healthy world's barrier, then return; a
        degraded world exits here with ``os._exit`` (a teardown on a broken
        gloo group can block)."""
        if not self.degraded:
            self._synchronized_shutdown()
        if not self.degraded:
            return
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(exit_code)
