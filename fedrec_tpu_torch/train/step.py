"""The federated train steps, the epoch-end news update, the round-end
parameter sync and the corpus encode: the port of
``fedrec_tpu/train/step.py``.

The joint ("head") step trains both towers end to end over the frozen
trunk's cached token states, a (N, T, bert_hidden) table on the device:

  1. the batch's candidate and history ids are deduplicated once (a sorted
     unique, padded with id 0 to a static size, as ``jnp.unique(size=...,
     fill_value=0)``), so a news id that recurs is encoded once;
  2. the unique ids' token-state rows go through the text head — with
     ``model.fuse_hot_path`` and the additive head, kernels C (forward) and
     D (backward) gather each row straight from the table; otherwise (the
     CNN head too, as in JAX) the rows are gathered and run through the
     text head (kernel A under ``use_pallas``);
  3. the user tower and scorer run on the gathered vectors (kernels B and E
     with ``fuse_hot_path``), then sigmoid-then-CE in f32;
  4. each tower steps its own optimizer chain (``train.state``), after the
     strategy's gradient sync.

``data.gather_chunk`` tiles step 2 (``_encode_gathered``): the unique ids
are gathered and encoded a tile at a time, each tile recomputed in backward
(``torch.utils.checkpoint``), so one tile's (chunk, T, bert_hidden) rows
live at a time; the encode is row-wise, so the result equals the untiled
route's.

The finetune step (``model.text_encoder_mode='finetune'``) is the joint
step over the (N, 2, L) token table instead of cached states: the batch's
distinct ids go through the whole ``TextEncoder`` (the DistilBERT trunk,
each block recomputed in backward under ``model.trunk_remat``, and its
additive head, pooled densely as in JAX), and the news Adam steps trunk and
head. The user tower still rides the model (kernels B and E under
``model.fuse_hot_path``); kernels C and D do not apply, since there is no
token-state table to gather from.

The decoupled ("table") step trains the user tower only, on vectors
gathered from an (N, news_dim) news-vector table: the gathered candidate
and history vectors are leaves of the gradient (kernel E's dx and dcand
under ``fuse_hot_path``), and their gradients are summed per news id into
the client's ``news_grad_accum`` (``scatter_add_rows``: sorted, summed per
id, then added to those rows; no atomics). At each epoch end
``build_news_update_step`` replays the accumulator through the text head
over the whole corpus (kernel A under ``use_pallas``, its backward the
autograd of the plain pool), steps the news Adam chain once and re-encodes
the table (reference ``model.py:66-90``).

With ``privacy.enabled`` and ``mechanism='ldp_news'`` the news parts of
each client's gradients get ``N(0, sigma^2)`` noise before any sync: the
text head's gradients in joint mode, the candidate and history vectors'
in decoupled mode (``privacy.dpsgd``). With ``mechanism='dpsgd'`` (joint
mode) each client's gradient is the mean of per-example gradients clipped
to C, plus ``N(0, (sigma C / B)^2)`` (``per_example_dp_grads``): each
example encodes its own news, and under ``model.use_pallas`` kernels A and
F1-F3 run inside ``torch.func.vmap``, folding the examples into their rows.

Under ``fed.seq_shards = S > 1`` (joint and finetune modes) the step runs on
every rank of a seq world (``parallel.ring``, ``parallel.mesh``) with this
rank's columns of every history: the user tower attends by ring or Ulysses
collectives and pools over the world, and one collective sums the clients'
gradients over the world before the optimizers (``build_fed_train_step``).

Every step returns the health sentry's per-client vector
(``obs.health.sentry``, on by default; device tensors, no host read), and
applies the chaos plan's update faults (``chaos.enabled``) between an
update's computation and its application. K clients run in a Python loop
on one device. ``build_param_sync`` is the round-end aggregate: the
weighted mean, or ``fed.robust``'s clip, trimmed mean or median over both
towers. The levers the port does not run yet raise
``NotImplementedError`` at build time and name the lever and its
``ROADMAP.md`` Queue A item; the combinations the JAX package refuses
raise with its wording.

The eval steps (``build_eval_step``, ``build_full_eval_step``) score
validation impressions against a news-vector table from
``encode_all_news``: the user vectors come from kernel B (``n`` = the eval
batch, no candidates) under ``model.fuse_hot_path``. A step takes the
client's ``UserEncoder`` where the JAX step takes ``user_params``: the
module holds its architecture and weights, so JAX's ``model`` argument has
no counterpart here (as in ``serve.py``). ``build_full_eval_step_sharded``
is not ported: on one card it is the unsharded step.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from fedrec_tpu_torch.comms.codecs import (
    codec_caps,
    codec_uses_feedback,
    torch_encode_decode,
    validate_codec,
)
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.device import resolve_device, torch_dtype
from fedrec_tpu_torch.eval.metrics import (
    full_pool_metrics_batch,
    quality_stats_batch,
    ranking_metrics_batch,
)
from fedrec_tpu_torch.fed.chaos import apply_update_fault
from fedrec_tpu_torch.fed.robust import robust_aggregate, validate_robust_method
from fedrec_tpu_torch.fed.strategies import FedStrategy, ParamAvg, weighted_param_avg
from fedrec_tpu_torch.models import NewsRecommender, score_candidates, score_loss
from fedrec_tpu_torch.models.encoders import apply_dropout_mask
from fedrec_tpu_torch.ops import fused_gather_encode
from fedrec_tpu_torch.parallel.ring import SeqGroup, scale_grad
from fedrec_tpu_torch.params import flax_leaf_count, flax_leaves, load_flax_leaves
from fedrec_tpu_torch.privacy import make_noise_fn, per_example_clipped_grads
from fedrec_tpu_torch.train.state import ClientState, make_optimizers

MODES = {"table": "decoupled", "head": "joint", "finetune": "finetune"}


def parse_cap_buckets(spec: str) -> list[tuple[int, int]]:
    """Parse ``data.unique_news_cap_buckets`` ("64:2560,256:4096") into a
    B-ascending list of (max_batch, cap) pairs; malformed entries raise."""
    buckets = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        try:
            b_s, cap_s = item.split(":")
            b, cap = int(b_s), int(cap_s)
        except ValueError:
            raise ValueError(
                f"data.unique_news_cap_buckets entry {item!r} is not "
                "'<max_batch>:<cap>' (e.g. '64:2560,256:4096')"
            ) from None
        if b <= 0 or cap <= 0:
            raise ValueError(
                f"data.unique_news_cap_buckets entry {item!r}: both the "
                "batch bound and the cap must be positive"
            )
        buckets.append((b, cap))
    bounds = [b for b, _ in buckets]
    if len(set(bounds)) != len(bounds):
        raise ValueError(
            f"data.unique_news_cap_buckets has duplicate batch bounds ({spec!r}); "
            "each bound may appear once"
        )
    return sorted(buckets)


def resolve_unique_cap(cfg: ExperimentConfig, batch_size: int) -> int:
    """The unique-news cap for one per-client batch size: the cap of the
    smallest bucket whose bound covers ``batch_size`` (uncapped, 0, past
    every bucket), or the global ``data.unique_news_cap`` without buckets."""
    buckets = parse_cap_buckets(cfg.data.unique_news_cap_buckets)
    if buckets:
        for b, cap in buckets:
            if batch_size <= b:
                return cap
        return 0
    return cfg.data.unique_news_cap


def unique_padded(ids: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jnp.unique(ids, size=size, fill_value=0, return_inverse=True)``:
    the sorted distinct ids cut or padded with 0 to ``size``, and each id's
    slot. Past the size, JAX's clamped gather reads the last slot; so does
    the inverse here."""
    uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
    if uniq.shape[0] >= size:
        return uniq[:size], inv.clamp(max=size - 1)
    pad = torch.zeros(size - uniq.shape[0], dtype=uniq.dtype, device=uniq.device)
    return torch.cat([uniq, pad]), inv


def unique_overflow(candidates: torch.Tensor, history: torch.Tensor, cap: int, n_news: int) -> int:
    """1 when the batch's distinct news ids exceed ``min(cap, ids, n_news)``:
    a capped dedup then dropped ids and the step's result is invalid."""
    ids = torch.cat([candidates.reshape(-1), history.reshape(-1)])
    distinct = int(torch.unique(ids).numel())
    bound = min(cap, ids.numel(), n_news) if cap else min(ids.numel(), n_news)
    return int(distinct > bound)


def take_rows_backward(g: torch.Tensor, inv: torch.Tensor, rows: int) -> torch.Tensor:
    """The cotangent of ``vecs[inv]`` for ``vecs`` of ``rows`` rows: each
    row's cotangents summed in a fixed order, deterministic on the CPU and
    the GPU. ``inv`` is sorted once (stable), so each row's cotangents lie
    together in their original order, and ``torch.segment_reduce`` sums
    each segment left to right (one thread per row and feature, no atomics).
    Memory and work are linear in ``len(inv)``; a row no id maps to gets 0."""
    order = torch.argsort(inv, stable=True)
    lengths = torch.bincount(inv, minlength=rows)
    return torch.segment_reduce(g[order], "sum", lengths=lengths, unsafe=True)


def scatter_add_rows(accum: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> None:
    """``accum[ids] += rows`` in place with every id's rows summed, as
    ``np.add.at`` / JAX's ``.at[ids].add``, deterministic on the CPU and the
    GPU: the ids are sorted once (stable), each distinct id's rows summed
    left to right (``torch.segment_reduce``), and the sums added to those
    distinct rows, each written once. (``index_add_`` and
    ``index_put_(accumulate=True)`` use atomics on the GPU.) The sum order
    differs from JAX's, which adds each row to the accumulator in turn."""
    order = torch.argsort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(ids[order], return_counts=True)
    sums = torch.segment_reduce(rows[order].to(accum.dtype), "sum", lengths=counts,
                                unsafe=True)
    accum.index_copy_(0, uniq, accum.index_select(0, uniq) + sums)


class _TakeRows(torch.autograd.Function):
    """``vecs[inv]`` with a deterministic backward (``take_rows_backward``).
    Indexing's own backward accumulates with atomics on the GPU and with
    threads on the CPU, so a step would not repeat to the bit."""

    @staticmethod
    def forward(ctx, vecs, inv):
        ctx.save_for_backward(inv)
        ctx.rows = vecs.shape[0]
        return vecs[inv]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return take_rows_backward(g, inv, ctx.rows), None


def _encode_gathered(model: NewsRecommender, token_states: torch.Tensor,
                     uniq: torch.Tensor, fused: bool, chunk: int = 0) -> torch.Tensor:
    """The text head over the unique ids' rows of the frozen table (no
    gradient ever reaches the table): kernels C/D when ``fused``, else the
    gathered rows through ``TextHead``. ``chunk`` (``data.gather_chunk``)
    tiles the gather and encode, each tile recomputed in backward, as the
    JAX ``lax.map`` over ``jax.checkpoint`` tiles does; the last tile is
    not padded."""

    def encode(ids: torch.Tensor) -> torch.Tensor:
        if fused:
            return fused_gather_encode(token_states, ids, model.text_head,
                                       torch_dtype(model.cfg.dtype))
        return model.encode_news(token_states.detach()[ids])

    if not chunk or uniq.shape[0] <= chunk:
        return encode(uniq)
    return torch.cat([checkpoint(encode, tile, use_reentrant=False, preserve_rng_state=False)
                      for tile in uniq.split(chunk)])


def _batch_news_vecs(model: NewsRecommender, token_states: torch.Tensor,
                     candidates: torch.Tensor, history: torch.Tensor,
                     cap: int = 0, fused: bool = False,
                     chunk: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode the batch's unique news once; gather into the (B, C, D)
    candidate and (B, H, D) history slots. ``cap`` bounds the unique slots
    (exact while the distinct ids fit; see ``unique_overflow``)."""
    b, c = candidates.shape
    h = history.shape[1]
    ids = torch.cat([candidates.reshape(-1), history.reshape(-1)])
    size = min(ids.shape[0], token_states.shape[0])
    if cap:
        size = min(size, cap)
    uniq, inv = unique_padded(ids, size)
    vecs = _encode_gathered(model, token_states, uniq, fused, chunk)
    flat = _TakeRows.apply(vecs, inv)
    return flat[: b * c].reshape(b, c, -1), flat[b * c:].reshape(b, h, -1)


def _encode_unique_tokens(text_encoder, tokens_table: torch.Tensor, ids: torch.Tensor,
                          train: bool, generator: torch.Generator | None = None,
                          cap: int = 0) -> torch.Tensor:
    """A flat id vector's news through the whole ``TextEncoder``, each
    distinct id once: its token rows are gathered from the (N, 2, L) table,
    run through trunk and head, and the vectors scattered back to
    (len(ids), D). ``cap`` bounds the distinct ids as in ``_batch_news_vecs``
    (past it the step reports ``unique_overflow``).

    JAX pads the unique slots to a static size with id 0 and encodes them
    all. The padded rows feed nothing, so only the distinct ids are encoded
    here; at trunk dropout 0 the results are equal (with dropout the masks
    are torch's own draws either way)."""
    size = min(ids.shape[0], tokens_table.shape[0])
    if cap:
        size = min(size, cap)
    uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
    if uniq.shape[0] > size:  # unique_padded's cut: the overflow case
        uniq, inv = uniq[:size], inv.clamp(max=size - 1)
    vecs = text_encoder(tokens_table[uniq], train, generator)
    return _TakeRows.apply(vecs, inv)


def _batch_news_vecs_tokens(text_encoder, tokens_table: torch.Tensor,
                            candidates: torch.Tensor, history: torch.Tensor, train: bool,
                            generator: torch.Generator | None = None,
                            cap: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Finetune mode's ``_batch_news_vecs``: one dedup over candidate and
    history ids, the whole trainable ``TextEncoder`` on the distinct rows."""
    b, c = candidates.shape
    h = history.shape[1]
    ids = torch.cat([candidates.reshape(-1), history.reshape(-1)])
    flat = _encode_unique_tokens(text_encoder, tokens_table, ids, train, generator, cap)
    return flat[: b * c].reshape(b, c, -1), flat[b * c:].reshape(b, h, -1)


def _encode_tokens_rows(text_encoder, tokens_table: torch.Tensor, ids_2d: torch.Tensor,
                        generator: torch.Generator | None) -> torch.Tensor:
    """One (B, K) id block's distinct news through the whole ``TextEncoder``
    (training), (B, K, D). Under a seq world in finetune mode candidates and
    the local history shard are encoded separately: a joint dedup over both
    would put the same candidate at another row on each rank and give it
    another trunk dropout mask, de-replicating the candidate encode (and the
    1/S gradient correction with it). Alone, the candidates' rows and masks
    are the same on every rank."""
    b, k = ids_2d.shape
    flat = _encode_unique_tokens(text_encoder, tokens_table, ids_2d.reshape(-1), True, generator)
    return flat.reshape(b, k, -1)


@torch.no_grad()
def encode_corpus_tokens(
    text_encoder,
    news_tokens: Any,
    chunk: int = 512,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """(N, 2, L) token table -> (N, D) news vectors through the whole
    ``TextEncoder`` (finetune mode's corpus encode for evaluation, the
    export and the recommend CLI), ``chunk`` titles at a time, on ``device``
    (default ``cuda``, which raises without a GPU; ``text_encoder`` must
    live there). A host table (numpy or a tensor) crosses to the device one
    chunk at a time."""
    dev = resolve_device(device)
    tokens = torch.as_tensor(news_tokens)
    n = tokens.shape[0]
    out = torch.empty((n, text_encoder.news_dim), dtype=text_encoder.trunk.dtype,
                      device=dev)
    for start in range(0, n, chunk):
        vecs = text_encoder(tokens[start:start + chunk].to(dev))
        out[start:start + vecs.shape[0]] = vecs
    return out


def _refuse_unported(cfg: ExperimentConfig, mode: str) -> None:
    """Fail at build time, naming the lever, for what the port cannot run
    and for the combinations the JAX ``build_fed_train_step`` refuses (with its
    wording, in its order): the one list of refusals, which the train step,
    ``Trainer`` and the run CLI share."""
    if mode not in ("joint", "decoupled", "finetune"):
        raise ValueError(f"unknown step mode {mode!r}")
    n_seq = cfg.fed.seq_shards
    if n_seq > 1 and mode not in ("joint", "finetune"):
        raise NotImplementedError(
            "fed.seq_shards > 1 requires mode='joint'/'finetune' (the "
            "decoupled news-grad accumulator is not seq-sharded)"
        )
    if _uses_dpsgd(cfg):
        # the JAX build_fed_train_step's refusals (fedrec_tpu/train/step.py), in its
        # order; decoupled mode's dpsgd ValueError is _noise_hook's
        if n_seq > 1:
            raise NotImplementedError(
                "per-example DP-SGD with sequence parallelism is not supported; "
                "use seq_shards=1 with mechanism='dpsgd'"
            )
        if mode == "finetune":
            raise NotImplementedError(
                "per-example DP-SGD over the full trunk is not supported; use "
                "mode='joint' (frozen trunk) for DP training"
            )
        if mode == "joint" and cfg.model.fuse_hot_path:
            raise NotImplementedError(
                "model.fuse_hot_path with privacy.mechanism='dpsgd' is not "
                "supported (per-example clipping would pay the kernel "
                "launch per example, exactly the overhead regime where "
                "fusion loses); unset one of the two"
            )
        if mode == "joint" and cfg.shard.table:
            raise NotImplementedError(
                "shard.table with privacy.mechanism='dpsgd' is not "
                "supported (per-example clipping gathers each example's "
                "rows directly, bypassing the owner-bucketed exchange); "
                "unset one of the two"
            )
    if n_seq > 1:
        if cfg.model.fuse_hot_path:
            raise NotImplementedError(
                "model.fuse_hot_path with fed.seq_shards>1 is not supported "
                "(the fused kernel holds the whole history per row); use "
                "the ring/Ulysses path for sharded histories"
            )
        if mode == "joint" and cfg.shard.table:
            raise NotImplementedError(
                "shard.table with fed.seq_shards>1 is not supported (the "
                "catalog shards over the clients axis; a seq-sharded mesh "
                "would need a 2-D exchange); unset one of the two"
            )
        if cfg.chaos.enabled:
            raise NotImplementedError(
                "chaos fault injection with fed.seq_shards > 1 is not supported "
                "(the seq-parallel batch spec does not carry the per-client "
                "fault vectors); run the plan with seq_shards=1"
            )
        if cfg.fed.seq_impl not in ("ring", "ulysses"):
            raise ValueError(f"seq_impl must be 'ring' or 'ulysses', got {cfg.fed.seq_impl!r}")
    levers = [
        ("shard.table (ROADMAP.md's Queue A item 9)", cfg.shard.table),
        ("shard.fsdp>1 (ROADMAP.md's Queue A item 9)", cfg.shard.fsdp > 1),
    ]
    for name, on in levers:
        if on:
            raise NotImplementedError(f"{name} is not ported to fedrec_tpu_torch yet; unset it")


def refuse_unported(cfg: ExperimentConfig) -> None:
    """``_refuse_unported`` for the mode ``cfg`` names: the run CLI's check
    before it loads data."""
    _refuse_unported(cfg, MODES.get(cfg.model.text_encoder_mode, "joint"))


def _uses_dpsgd(cfg: ExperimentConfig) -> bool:
    return cfg.privacy.enabled and cfg.privacy.mechanism == "dpsgd"


def _noise_hook(cfg: ExperimentConfig, mode: str) -> Callable | None:
    """The privacy checks of the JAX step builder, then the noise hook
    (``privacy.make_noise_fn``: ``sigma <= 0`` raises), or None."""
    p = cfg.privacy
    if not p.enabled:
        return None
    use_dpsgd = p.mechanism == "dpsgd"
    if use_dpsgd and mode != "joint":
        # decoupled mode has no per-example clipping path; noising
        # unclipped grads with a DP-SGD-calibrated sigma would claim an
        # (epsilon, delta) guarantee that does not hold
        raise ValueError(
            "mechanism='dpsgd' requires mode='joint'; use mechanism='ldp_news' "
            "(reference-parity noise, no rigorous epsilon) for decoupled mode"
        )
    if p.dp_scope not in ("all", "user"):
        raise ValueError(f"unknown privacy.dp_scope {p.dp_scope!r}; expected 'all' or 'user'")
    if p.dp_scope == "user" and not use_dpsgd:
        raise ValueError(
            "privacy.dp_scope='user' requires mechanism='dpsgd' — ldp_news "
            "noises only the news grads, which contradicts a user-only scope"
        )
    return make_noise_fn(p, cfg.data.batch_size)


def _leaves(*trees) -> list[torch.Tensor]:
    """The tensors of ``trees`` (tensors, sequences of tensors or None),
    Nones skipped."""
    out = []
    for t in trees:
        if t is None:
            continue
        if torch.is_tensor(t):
            out.append(t)
        else:
            out.extend(x for x in t if x is not None)
    return out


@torch.no_grad()
def _group_norms(groups: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """The f32 global L2 norm of each group of tensors, (len(groups),): the
    health sentry's one norm definition (grad, update and param norms all
    use it, so their scales compare). A step's worth at once, in two
    multi-tensor passes (each tensor's norm, then each group's norm of
    those), since a call per norm costs the host more than the device; a
    device tensor, no host read."""
    per_tensor = torch.stack(torch._foreach_norm([x.float() for g in groups for x in g]))
    return torch.stack(torch._foreach_norm(list(per_tensor.split([len(g) for g in groups]))))


def _optimizer_updates(tx, st: ClientState, which: str, params, grads) -> list[torch.Tensor]:
    """One step of chain ``tx``: the updates to add to ``params``; the new
    optimizer state goes to ``st.<which>`` (``opt_user`` or ``opt_news``).
    The updates are applied separately (``_apply_updates``), so that a
    chaos fault and the sentry see them first."""
    updates, new_opt = tx.update(grads, getattr(st, which), params)
    setattr(st, which, new_opt)
    return updates


@torch.no_grad()
def _apply_updates(params, updates) -> None:
    for p, u in zip(params, updates):
        p.add_(u)


def _optimizer_step(tx, st: ClientState, which: str, params, grads) -> None:
    """One step of chain ``tx`` on ``params`` with ``grads``, applied."""
    _apply_updates(params, _optimizer_updates(tx, st, which, params, grads))


def _as_device(a: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(device)


def _dropout_keep(shape, rate: float, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor | None:
    """The keep mask ``models.encoders.dropout`` would draw for ``shape``
    from ``generator``; None when dropout is off."""
    if rate == 0.0:
        return None
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def per_example_dp_grads(
    model: NewsRecommender,
    token_states: torch.Tensor,
    candidates: torch.Tensor,
    history: torch.Tensor,
    labels: torch.Tensor,
    clip_norm: float,
    generator: torch.Generator | None = None,
    user_only: bool = False,
    sigmoid_ce: bool = True,
) -> tuple:
    """One client's DP-SGD gradient estimate before the noise: the mean over
    the batch of each example's gradient clipped to global norm
    ``clip_norm`` (the JAX step's ``per_example_loss`` under
    ``privacy.per_example_clipped_grads``).

    Each example gathers its own 1+C candidate and H history token-state
    rows and encodes them (no cross-example dedup, which would couple
    examples and break the per-example bound). The loss is mapped over the
    examples with ``torch.func``, so under ``model.use_pallas`` kernels A
    (both pools) and F1-F3 (the user tower's attention) run inside the
    transform, each launching once for the whole batch. The dropout keep
    masks are drawn from ``generator`` before the transform, one per
    example. ``user_only`` (``dp_scope='user'``) differentiates the user
    tower alone, the text head held fixed.

    Returns ``(mean loss, user grads, news grads or None, {"clip_rate",
    "max_norm"})``, the gradients as lists in ``parameters()`` order.
    """
    c = candidates.shape[1]
    rate = model.cfg.dropout_rate
    toks = token_states.detach()[torch.cat([candidates, history], 1).long()]
    keep = _dropout_keep((history.shape[0], 1, history.shape[1], model.cfg.news_dim), rate,
                         generator, token_states.device)
    # the transform differentiates detached copies: the live parameters
    # take no part in an outer autograd graph
    user_p = {k: v.detach() for k, v in model.user_encoder.named_parameters()}
    news_p = {k: v.detach() for k, v in model.text_head.named_parameters()}

    def per_example_loss(params, toks_row, label, *keep_row):
        user_params, news_params = (params, news_p) if user_only else params
        vecs = torch.func.functional_call(model.text_head, news_params, (toks_row,))
        his = vecs[c:][None]
        if keep_row:  # this example's mask, drawn outside the transform
            his = apply_dropout_mask(his, keep_row[0], rate)
        user = torch.func.functional_call(model.user_encoder, user_params, (his,))
        return score_loss(score_candidates(vecs[:c][None], user), label[None], sigmoid_ce)

    args = (toks, labels) + (() if keep is None else (keep,))
    loss, grads, stats = per_example_clipped_grads(
        per_example_loss, user_p if user_only else (user_p, news_p), args, clip_norm,
        with_stats=True)
    if user_only:
        return loss, list(grads.values()), None, stats
    return loss, list(grads[0].values()), list(grads[1].values()), stats


def build_fed_train_step(
    model: NewsRecommender,
    cfg: ExperimentConfig,
    strategy: FedStrategy,
    mode: str | None = None,
    device: str | torch.device | None = None,
    seq_group: SeqGroup | None = None,
) -> Callable:
    """The per-batch federated train step.

    Returns ``step(states, batch, table) -> (states, metrics)``: ``states``
    is the list of K ``ClientState``s (updated in place and returned),
    ``batch`` a dict of ``(K, B, ...)`` ``candidates`` / ``history`` /
    ``labels`` arrays (numpy or tensors), ``table`` on ``device``: the
    (N, T, bert_hidden) frozen-trunk token states in joint mode, the
    (N, news_dim) news-vector table in decoupled mode, the (N, 2, L) token
    table in finetune mode. ``metrics`` holds
    each client's ``loss`` (K,), their ``mean_loss`` and ``unique_overflow``
    (how many clients' batches held more distinct ids than the cap; 0 in
    decoupled mode, which encodes nothing, and under DP-SGD, which does not
    deduplicate).

    With ``obs.health.sentry`` (the default) ``metrics`` also holds each
    client's ``health.grad_norm`` (after any noise, before the sync),
    ``health.update_norm`` (after any chaos fault), ``health.param_norm``
    (after the update) and ``health.nonfinite`` (int32, 1 when the loss or
    a norm is not finite), and under dpsgd ``health.clip_rate`` and
    ``health.clip_max_norm``: (K,) device tensors, read by nobody here.
    They only observe: the trajectory is bitwise the one without them.
    With ``chaos.enabled`` the batch carries ``chaos.code`` / ``chaos.scale``
    (K,) host vectors (``fed.chaos.FaultPlan.batch_keys``), applied to each
    client's updates before they are added.

    Joint mode with ``privacy.mechanism='dpsgd'`` runs per-example DP-SGD:
    each example gathers and encodes its own 1+C candidates and H history
    ids (no cross-example dedup), ``privacy.per_example_clipped_grads``
    maps the loss over the examples (kernels A and F1-F3 under
    ``model.use_pallas`` fold the examples into their rows), and
    ``N(0, (sigma C / B)^2)`` noise follows. The dropout masks are drawn
    from the client's generator before the transform. ``dp_scope='user'``
    freezes the text head: no gradient, no noise, no Adam step.

    ``mode`` defaults to the one ``model.text_encoder_mode`` names ("head"
    -> "joint", "table" -> "decoupled", "finetune" -> "finetune"). Finetune
    mode encodes the batch's distinct ids through the client's whole
    ``TextEncoder`` (trunk dropout from the client's generator, before the
    user tower's) and steps trunk and head with the news Adam; under
    ``data.unique_news_cap`` it reports ``unique_overflow`` as joint mode
    does. In decoupled mode each client's
    ``news_grad_accum`` is allocated at its first step, (N, news_dim) f32,
    and the text head does not move (``build_news_update_step`` steps it).

    ``model`` is the clients' architecture (``model.cfg``); the step runs
    each client's own copy. ``device`` defaults to ``cuda`` and raises
    without a GPU unless ``device="cpu"``.

    Sequence parallelism (``fed.seq_shards = S > 1``, joint and finetune
    modes): the step runs on every rank of the seq world ``seq_group``
    (``parallel.mesh.seq_group``), each holding all K clients, and
    ``batch["history"]`` holds this rank's (K, B, H/S) columns
    (``parallel.mesh.shard_fed_batch``). Each client's user tower runs over
    the world (``NewsRecommender.seq_parallel``: ring or Ulysses attention
    by ``fed.seq_impl``, the seq-sharded pool); the candidate vectors, the
    same on every rank, have their cotangent scaled by 1/S, and after the K
    backward passes one collective sums every client's user and news
    gradients over the world (and each client's ``unique_overflow`` flag,
    per rank's own dedup), before any noise, sync or optimizer step, so every
    rank steps the same parameters. Finetune mode encodes the candidates and
    the local history shard separately (``_encode_tokens_rows``): the
    candidates' trunk dropout from the client's stream, the same on every
    rank, the history's from a stream forked per rank; it reports no
    ``unique_overflow``, as in JAX.
    """
    dev = resolve_device(device)
    if mode is None:
        mode = MODES.get(cfg.model.text_encoder_mode, "joint")
    _refuse_unported(cfg, mode)
    n_seq = cfg.fed.seq_shards
    seq = seq_group if n_seq > 1 else None
    if n_seq > 1 and (seq_group is None or seq_group.size != n_seq):
        got = "none" if seq_group is None else f"one of {seq_group.size}"
        raise ValueError(
            f"fed.seq_shards={n_seq} but the step has {got} for a seq world — build it with "
            "parallel.mesh.seq_group")
    if seq is not None:
        model.seq_parallel(seq, cfg.fed.seq_impl)  # the model's own refusals, at build time
    noise_fn = _noise_hook(cfg, mode)
    opt_user, opt_news = make_optimizers(cfg)
    # kernels B/E ride the model's user tower in every mode
    # (model.fuse_hot_path); C/D replace the joint step's gather + text head
    fuse_gather = (mode == "joint" and model.cfg.fuse_hot_path
                   and model.cfg.text_head_arch == "additive")
    gather_chunk = cfg.data.gather_chunk
    sigmoid_ce = cfg.model.sigmoid_before_ce
    joint = mode == "joint"
    encodes = mode in ("joint", "finetune")  # both towers train on this client
    use_dpsgd = joint and _uses_dpsgd(cfg)
    dp_user_only = use_dpsgd and cfg.privacy.dp_scope == "user"
    sentry = cfg.obs.health.sentry
    chaos = cfg.chaos.enabled

    def joint_grads(st: ClientState, cand, hist, lab, table, cap: int):
        m = st.model
        user_p, news_p = st.user_params(), st.news_params()
        if joint:
            cand_vecs, his_vecs = _batch_news_vecs(m, table, cand, hist, cap, fuse_gather,
                                                   gather_chunk)
        elif seq is not None:
            # finetune under a seq world: candidates alone (the same rows and
            # dropout on every rank), then the local history shard
            cand_vecs = _encode_tokens_rows(m.text_encoder, table, cand, st.generator)
            his_vecs = _encode_tokens_rows(m.text_encoder, table, hist, _rank_stream(st))
        else:  # finetune: the table holds token ids
            cand_vecs, his_vecs = _batch_news_vecs_tokens(m.text_encoder, table, cand, hist,
                                                          True, st.generator, cap)
        if seq is not None:
            # replicated on every rank: the world's gradient sum counts it once
            cand_vecs = scale_grad(cand_vecs, 1.0 / n_seq)
            m = m.seq_parallel(seq, cfg.fed.seq_impl)
        scores = m(cand_vecs, his_vecs, None, train=True, generator=st.generator)
        loss = score_loss(scores, lab, sigmoid_ce)
        grads = torch.autograd.grad(loss, user_p + news_p, allow_unused=True)
        return loss, list(grads[:len(user_p)]), list(grads[len(user_p):])

    def _rank_stream(st: ClientState) -> torch.Generator | None:
        """This rank's history-encode stream, forked from the client's
        (replicated) one when the trunk draws dropout masks."""
        if cfg.model.trunk_dropout == 0.0:
            return st.generator
        base = int(torch.randint(0, 2**62, (1,), generator=st.generator, device=dev))
        return torch.Generator(device=dev).manual_seed(base + 1 + seq.rank)

    def add_noise(st: ClientState, user_g, news_g):
        # an unused leaf's gradient is zero, and noised as one
        news_g = [torch.zeros_like(p) if g is None else g
                  for g, p in zip(news_g, st.news_params())]
        return noise_fn((user_g, news_g), st.noise_generator)

    def seq_sum(user_g: list, news_g: list, flags: list[int]) -> tuple[list, list, int]:
        """Every client's gradients (and overflow flags) summed over the seq
        world in one collective; a missing gradient stays missing (the
        pattern is the same on every rank)."""
        cells = [g for gs in user_g + news_g for g in gs if g is not None]
        flat = torch.cat([*(g.reshape(-1).float() for g in cells),
                          torch.tensor(flags, dtype=torch.float32, device=dev)])
        total = seq.sum(flat)
        parts = iter(total[:flat.numel() - len(flags)].split([g.numel() for g in cells]))
        out = [[None if g is None else next(parts).view_as(g).to(g.dtype) for g in gs]
               for gs in user_g + news_g]
        k = len(user_g)
        return out[:k], out[k:], int(total[flat.numel() - len(flags):].sum().item())

    def dpsgd_grads(st: ClientState, cand, hist, lab, token_states):
        loss, user_g, news_g, stats = per_example_dp_grads(
            st.model, token_states, cand, hist, lab, cfg.privacy.clip_norm, st.generator,
            user_only=dp_user_only, sigmoid_ce=sigmoid_ce)
        if noise_fn is not None:
            if news_g is None:
                (user_g,) = noise_fn((user_g,), st.noise_generator)
            else:
                user_g, news_g = noise_fn((user_g, news_g), st.noise_generator)
        return loss, user_g, news_g, stats

    def decoupled_grads(st: ClientState, cand, hist, lab, table):
        # the gathered vectors are the gradient's leaves; the table is not
        cand_vecs0 = table[cand.long()].requires_grad_()
        his_vecs0 = table[hist.long()].requires_grad_()
        scores = st.model(cand_vecs0, his_vecs0, None, train=True, generator=st.generator)
        loss = score_loss(scores, lab, sigmoid_ce)
        user_p = st.user_params()
        grads = torch.autograd.grad(loss, [*user_p, cand_vecs0, his_vecs0], allow_unused=True)
        user_g, (cand_g, his_g) = grads[:len(user_p)], grads[len(user_p):]
        if noise_fn is not None:
            user_g, cand_g, his_g = noise_fn((user_g, cand_g, his_g), st.noise_generator)
        # per-nid scatter-add (reference process_news_grad, main.py:20-42)
        n, d = table.shape
        if st.news_grad_accum is None:
            st.news_grad_accum = torch.zeros((n, d), dtype=torch.float32, device=dev)
        elif st.news_grad_accum.shape != (n, d):
            raise ValueError(f"news_grad_accum {tuple(st.news_grad_accum.shape)} does not "
                             f"match the table {(n, d)}")
        ids = torch.cat([cand.reshape(-1), hist.reshape(-1)]).long()
        rows = torch.cat([cand_g.reshape(-1, d), his_g.reshape(-1, d)])
        scatter_add_rows(st.news_grad_accum, ids, rows)
        return loss, user_g, (cand_g, his_g)

    def step(states: list[ClientState], batch: dict, table: torch.Tensor):
        cands = _as_device(batch["candidates"], dev)
        hists = _as_device(batch["history"], dev)
        labels = _as_device(batch["labels"], dev)
        k = len(states)
        if cands.shape[0] != k:
            raise ValueError(f"batch holds {cands.shape[0]} clients, states {k}")
        codes = scales = None
        if chaos:
            # host vectors: the fault branch costs no device read
            codes = np.asarray(batch["chaos.code"]).reshape(k)
            scales = np.asarray(batch["chaos.scale"]).reshape(k)
        cap = resolve_unique_cap(cfg, labels.shape[1]) if encodes and not use_dpsgd else 0
        # finetune mode under a seq world encodes rows apart: no capped dedup
        capped = cap and not (seq is not None and not joint)
        losses, user_g, news_g, flags, extras = [], [], [], [], []
        health: dict[str, list] = {}  # DP-SGD's clip statistics
        for st, cand, hist, lab in zip(states, cands, hists, labels):
            extra = None  # decoupled mode: the gathered vectors' gradients
            if use_dpsgd:
                loss, ug, ng, stats = dpsgd_grads(st, cand, hist, lab, table)
                if sentry:
                    health.setdefault("health.clip_rate", []).append(stats["clip_rate"])
                    health.setdefault("health.clip_max_norm", []).append(stats["max_norm"])
            elif encodes:
                loss, ug, ng = joint_grads(st, cand, hist, lab, table, cap)
                flags.append(unique_overflow(cand, hist, cap, table.shape[0]) if capped else 0)
            else:
                loss, ug, extra = decoupled_grads(st, cand, hist, lab, table)
                ng = None
            losses.append(loss.detach())
            user_g.append(ug)
            news_g.append(ng)
            extras.append(extra)
        overflow = sum(flags)
        if seq is not None:
            # each rank holds partial gradients (its history slice): the sum
            # is the whole gradient, the same on every rank
            user_g, news_g, overflow = seq_sum(user_g, news_g, flags)
        if noise_fn is not None and encodes and not use_dpsgd:
            for c, st in enumerate(states):
                user_g[c], news_g[c] = add_noise(st, user_g[c], news_g[c])
        # the sentry's norm groups: each client's grads (after the noise and
        # before the sync blends them into the cohort's), updates, params
        groups: list[list] = [[_leaves(ug, ng, *(ex or ())) for ug, ng, ex
                               in zip(user_g, news_g, extras)] if sentry else [], [], []]
        user_g = strategy.sync_grads(user_g)
        if news_g[0] is not None:
            news_g = strategy.sync_grads(news_g)
        for c, (st, ug, ng) in enumerate(zip(states, user_g, news_g)):
            user_p = st.user_params()
            u_up = _optimizer_updates(opt_user, st, "opt_user", user_p, ug)
            n_up = None
            if ng is not None:
                n_up = _optimizer_updates(opt_news, st, "opt_news", st.news_params(), ng)
            if chaos:
                # at the update boundary: the sentry below sees the faulted
                # update, as it would a real bad client's
                u_up = apply_update_fault(u_up, codes[c], scales[c])
                if n_up is not None:
                    n_up = apply_update_fault(n_up, codes[c], scales[c])
            _apply_updates(user_p, u_up)
            if n_up is not None:
                _apply_updates(st.news_params(), n_up)
            st.step += 1
            if sentry:
                groups[1].append(_leaves(u_up, n_up))
                groups[2].append(_leaves(user_p, st.news_params()))
        loss_vec = torch.stack(losses)
        metrics = {
            "loss": loss_vec,
            "mean_loss": loss_vec.mean(),
            "unique_overflow": overflow,
        }
        if sentry:
            metrics.update({key: torch.stack(v) for key, v in health.items()})
            norms = _group_norms(groups[0] + groups[1] + groups[2]).reshape(3, k)
            for i, key in enumerate(("grad_norm", "update_norm", "param_norm")):
                metrics[f"health.{key}"] = norms[i]
            finite = torch.isfinite(loss_vec) & torch.isfinite(norms).all(0)
            metrics["health.nonfinite"] = 1 - finite.to(torch.int32)
        return states, metrics

    return step


def _head_grads(model: NewsRecommender, token_states: torch.Tensor, cotangent: torch.Tensor,
                chunk: int, dev: torch.device) -> list[torch.Tensor]:
    """The vector-Jacobian product of the corpus encode with ``cotangent``
    (N, news_dim): the text head's gradients, ``chunk`` rows at a time.
    Each chunk runs the head forward (kernel A under ``use_pallas``) and its
    backward at once, so one chunk's activations live at a time, and the
    chunks' gradients are summed in chunk order (``encode_all_news`` runs
    without a graph)."""
    params = list(model.text_head.parameters())
    total = [torch.zeros_like(p) for p in params]
    for start in range(0, token_states.shape[0], chunk):
        with torch.enable_grad():
            vecs = model.encode_news(token_states[start:start + chunk].to(dev))
            grads = torch.autograd.grad(
                vecs, params, cotangent[start:start + vecs.shape[0]].to(vecs.dtype),
                allow_unused=True)
        for t, g in zip(total, grads):
            if g is not None:
                t.add_(g)
    return total


def build_news_update_step(
    model: NewsRecommender,
    cfg: ExperimentConfig,
    strategy: FedStrategy | None = None,
    chunk: int = 2048,
    device: str | torch.device | None = None,
) -> Callable:
    """Epoch-end news-head update for ``decoupled`` mode.

    Returns ``update(states, token_states) -> (states, tables)``. For every
    client it replays the accumulated per-nid embedding gradients through
    the text head — the vector-Jacobian product of the corpus encode with
    ``news_grad_accum`` as cotangent, semantically the reference's
    ``update_news_grad`` (``model.py:72-90``: forward touched news, then
    ``news_vecs.backward(news_grad)``, then an Adam step) — takes one step of
    the news Adam chain, re-encodes the corpus into that client's new
    (N, news_dim) table and zeroes its accumulator. All news rows take part
    (an untouched row's zero cotangent adds nothing), so no touched-rows
    gather is needed; the head gradient is summed over ``chunk``-row chunks
    in chunk order (``_head_grads``).

    Under ``GradAvg`` the head gradients are averaged over clients
    (``sync_grads``) before the Adam step: the accumulator and the product
    are linear, so averaging once here equals averaging the per-step
    embedding gradients. ``tables`` holds every client's new table; the
    trainer keeps client 0's for every client's next epoch, as the JAX
    trainer does. ``device`` defaults to ``cuda`` and raises without a GPU
    unless ``device="cpu"``.
    """
    dev = resolve_device(device)
    _, opt_news = make_optimizers(cfg)
    strategy = strategy or FedStrategy()
    d = model.cfg.news_dim

    def update(states: list[ClientState], token_states: torch.Tensor):
        n = token_states.shape[0]
        head_g = []
        for st in states:
            accum = st.news_grad_accum
            if accum is None:
                accum = st.news_grad_accum = torch.zeros((n, d), dtype=torch.float32, device=dev)
            head_g.append(_head_grads(st.model, token_states, accum, chunk, dev))
        head_g = strategy.sync_grads(head_g)
        tables = []
        for st, grads in zip(states, head_g):
            _optimizer_step(opt_news, st, "opt_news", st.news_params(), grads)
            tables.append(encode_all_news(st.model, token_states, chunk, device=dev))
            st.news_grad_accum.zero_()
        return states, tables

    return update


def compressed_sync_active(cfg: ExperimentConfig, strategy: FedStrategy) -> bool:
    """True when the round-end sync runs the codec body, which takes each
    client's round-entry parameters (``contribution_leaves``) as a third
    argument: a codec compresses round deltas."""
    return cfg.fed.dcn_compress != "none" and strategy.sync_params_every_round


def contribution_leaves(st: ClientState) -> list[torch.Tensor]:
    """A client's ``(user, news)`` contribution as f32 tensors in Flax
    layout and leaf order (``params.flax_leaves``): what a codec encodes."""
    return flax_leaves(st.model.user_encoder) + flax_leaves(st.model.news_tower)


def load_contribution(st: ClientState, leaves: Sequence) -> None:
    """The inverse of :func:`contribution_leaves`: Flax-layout leaves
    (tensors or numpy) into the client's parameters, in place."""
    n_user = flax_leaf_count(st.model.user_encoder)
    load_flax_leaves(st.model.user_encoder, leaves[:n_user])
    load_flax_leaves(st.model.news_tower, leaves[n_user:])


def build_param_sync(cfg: ExperimentConfig, strategy: FedStrategy | None = None,
                     leaf_codecs: Sequence[str] | None = None) -> Callable:
    """Round-end parameter aggregation through the strategy.

    ``sync(states, weights) -> states``, ``weights`` one round weight per
    client (equal weights = FedAvg, zeros = clients that did not report or
    sit in quarantine). ``ParamAvg`` writes the aggregate of both towers
    into every client; ``Local``/``GradAvg`` leave parameters alone.
    Optimizer states stay local, as in the reference.

    ``fed.robust.method`` picks the aggregate: "mean" is the strategy's
    weighted mean, one tower at a time (bitwise ``weighted_param_avg``);
    "clip", "trimmed_mean" and "median" run ``fed.robust.robust_aggregate``
    over both towers at once, so that ``clip``'s deviation norm spans the
    whole client update.

    With an update codec (``fed.dcn_compress``, ``compressed_sync_active``)
    the sync is ``sync(states, weights, entry)``, ``entry`` each client's
    round-entry ``contribution_leaves``, and models the compressed uplink
    as the JAX package's ``_make_local_sync`` does, in Flax layout and leaf
    order: each client's delta from its entry (plus its error-feedback
    residual under a biased codec) goes through
    ``comms.torch_encode_decode``; a client of weight > 0 banks what the
    codec dropped as its new residual; the mean or the ``fed.robust``
    method runs over the decoded deltas (decode before reduce); every
    client adopts entry + aggregate. A round with no reporter keeps every
    client's parameters.

    ``leaf_codecs`` (``fed.dcn_compress='auto'``): the pinned per-leaf codec
    map, one concrete codec a contribution leaf, over the tree-wide codec;
    error feedback then applies per leaf, only where the leaf's codec is
    biased (``codec_caps(c).supports_error_feedback``). Under "auto" with no
    map yet (the warm-up window) every leaf runs the codec body as "none".
    """
    strategy = strategy or ParamAvg()
    rb = cfg.fed.robust
    method = validate_robust_method(rb.method)

    @torch.no_grad()
    def write(params, new) -> None:
        pairs = [(p, q) for old, fresh in zip(params, new) for p, q in zip(old, fresh)
                 if p is not q]
        if pairs:
            torch._foreach_copy_([p for p, _ in pairs], [q for _, q in pairs])

    if compressed_sync_active(cfg, strategy):
        fed = cfg.fed
        codec = fed.dcn_compress
        if leaf_codecs is None and codec != "auto":
            validate_codec(codec)
        use_ef = codec_uses_feedback(codec, fed.dcn_error_feedback)
        # codec="auto" with no pinned map yet is the warm-up window: an
        # all-"none" map through the codec body
        tree_wide = "none" if codec == "auto" else codec

        @torch.no_grad()
        def sync_codec(states: list[ClientState], weights, entry) -> list[ClientState]:
            w = np.asarray(weights, dtype=np.float32).reshape(-1)
            n_leaves = len(entry[0])
            per_leaf = ([tree_wide] * n_leaves if leaf_codecs is None
                        else [validate_codec(c) for c in leaf_codecs])
            if len(per_leaf) != n_leaves:
                raise ValueError(f"per-leaf codec map has {len(per_leaf)} entries but the "
                                 f"contribution tree has {n_leaves} leaves")
            # error feedback per leaf, only where the leaf's codec is biased
            ef = [use_ef and codec_caps(c).supports_error_feedback for c in per_leaf]
            decoded = []
            for st, base, wc in zip(states, entry, w):
                decs = []
                for i, (t, e) in enumerate(zip(contribution_leaves(st), base)):
                    a = t - e
                    if ef[i]:
                        a = a + st.ef_residual[i]
                    dec = torch_encode_decode(a, per_leaf[i], fed.dcn_topk_ratio,
                                              sketch_width=fed.dcn_sketch_width,
                                              sketch_seed=fed.dcn_sketch_seed, leaf_id=i)
                    if ef[i] and wc > 0:
                        # a weight-0 client sent nothing: its residual carries over
                        st.ef_residual[i] = a - dec
                    decs.append(dec)
                decoded.append(decs)
            if not (w > 0).any():
                return states
            agg = (weighted_param_avg(decoded, w) if method == "mean" else
                   robust_aggregate(decoded, w, method, trim_k=rb.trim_k,
                                    clip_norm=rb.clip_norm))
            for st, base, rows in zip(states, entry, agg):
                load_contribution(st, [e + a for e, a in zip(base, rows)])
            return states

        return sync_codec

    def sync(states: list[ClientState], weights) -> list[ClientState]:
        if not strategy.sync_params_every_round:
            return states
        if method == "mean":
            for part in ("user_params", "news_params"):
                params = [getattr(st, part)() for st in states]
                write(params, strategy.sync_params(params, weights))
            return states
        params = [st.user_params() + st.news_params() for st in states]
        with torch.no_grad():
            new = robust_aggregate(params, weights, method, trim_k=rb.trim_k,
                                   clip_norm=rb.clip_norm)
        write(params, new)
        return states

    return sync


@torch.no_grad()
def encode_all_news(
    model: NewsRecommender,
    token_states: torch.Tensor,
    chunk: int = 2048,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """(N, L, bert_hidden) -> (N, news_dim) news-vector table on ``device``
    (default ``cuda``, which raises without a GPU; ``model`` must live
    there), ``chunk`` rows at a time: that bounds the text head's
    activations, as the JAX ``lax.map`` over chunks does, and lets the token
    states stay in host memory, one chunk crossing to the device at a time.
    With ``model.use_pallas`` each chunk is one launch of kernel A."""
    dev = resolve_device(device)
    n = token_states.shape[0]
    # the text head's last Dense computes in the model dtype, as Flax's does
    dtype = torch_dtype(model.cfg.dtype)
    out = torch.empty((n, model.cfg.news_dim), dtype=dtype, device=dev)
    for start in range(0, n, chunk):
        vecs = model.encode_news(token_states[start:start + chunk].to(dev))
        out[start:start + vecs.shape[0]] = vecs
    return out


# --------------------------------------------------------------- eval steps
def _eval_inputs(batch: dict, news_vecs: torch.Tensor, dev: torch.device) -> dict:
    if news_vecs.device.type != dev.type:
        raise ValueError(f"news_vecs live on {news_vecs.device}, the eval step runs on {dev}")
    return {k: _as_device(v, dev) for k, v in batch.items()}


def build_eval_step(cfg: ExperimentConfig, device: str | torch.device | None = None) -> Callable:
    """Per-impression validation metrics of 1 positive + ``npratio``
    sampled negatives (reference ``Trainer.validate``, ``client.py:149-171``).

    ``evaluate(user_encoder, news_vecs, batch) -> dict of (B,) tensors``:
    ``batch`` holds ``candidates`` (B, C), ``history`` (B, H) and ``labels``
    (B,); the history runs through ``user_encoder`` with no mask, as in the
    JAX step, and the candidates score by dot product. Returns
    ``ranking_metrics_batch`` and the per-row ``loss``, so that the caller
    can trim batch padding before averaging. ``device`` defaults to
    ``cuda`` and raises without a GPU unless ``device="cpu"``.
    """
    dev = resolve_device(device)
    sigmoid_ce = cfg.model.sigmoid_before_ce

    @torch.no_grad()
    def evaluate(user_encoder, news_vecs: torch.Tensor, batch: dict) -> dict:
        b = _eval_inputs(batch, news_vecs, dev)
        cand_vecs = news_vecs[b["candidates"].long()]
        user_vec = user_encoder(news_vecs[b["history"].long()])
        scores = score_candidates(cand_vecs, user_vec)
        out = ranking_metrics_batch(scores)
        out["loss"] = score_loss(scores, b["labels"], sigmoid_ce, reduce=False)
        return out

    return evaluate


def _full_eval_body(dev: torch.device, quality: tuple | None = None) -> Callable:
    """Per-impression full-pool scoring. ``quality`` = ``(score_bins,
    score_range, ece_bins)`` adds ``quality_stats_batch``'s fixed-shape sums
    of the same scores; the batch then carries ``keep`` (B,), 0 on padded
    impressions."""

    @torch.no_grad()
    def evaluate(user_encoder, news_vecs: torch.Tensor, batch: dict) -> dict:
        b = _eval_inputs(batch, news_vecs, dev)
        user_vec = user_encoder(news_vecs[b["history"].long()])              # (B, D)
        pos_scores = torch.einsum("bd,bd->b", news_vecs[b["pos"].long()], user_vec)
        neg_scores = torch.einsum("bpd,bd->bp", news_vecs[b["neg_pools"].long()], user_vec)
        out = full_pool_metrics_batch(pos_scores, neg_scores, b["neg_mask"])
        if quality is not None:
            score_bins, score_range, ece_bins = quality
            out.update(quality_stats_batch(pos_scores, neg_scores, b["neg_mask"], b["keep"],
                                           score_bins, score_range, ece_bins))
        return out

    return evaluate


def build_full_eval_step(
    quality: tuple | None = None, device: str | torch.device | None = None
) -> Callable:
    """Deterministic full-pool evaluation: the protocol behind the
    reference's published MIND table (``evaluation_split``, reference
    ``evaluation_functions.py:33-47``), every real pool negative against the
    one positive, no sampling noise.

    ``evaluate(user_encoder, news_vecs, batch) -> dict of (B,) tensors``
    with ``batch`` holding ``pos`` (B,), ``neg_pools`` (B, P), ``neg_mask``
    (B, P) and ``history`` (B, H) (and ``keep`` (B,) with ``quality``).
    ``device`` defaults to ``cuda`` and raises without a GPU unless
    ``device="cpu"``.
    """
    return _full_eval_body(resolve_device(device), quality)
