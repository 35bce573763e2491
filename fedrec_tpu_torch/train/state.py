"""Training state and optimizers, the port of ``fedrec_tpu/train/state.py``.

A client's state is its own copy of the two towers (a ``NewsRecommender``
whose parameters are the client's; its news tower is the text head, or in
finetune mode the whole ``TextEncoder``, trunk and head, with the news Adam
over all of it), one optimizer state per tower, a step
count, a ``torch.Generator`` for its dropout and another for its DP noise
(the JAX step splits one key into the two), and, in decoupled mode, its
``(N, news_dim)`` f32 news-gradient accumulator. K federated clients are a
Python list of K states on one device, not a leading axis.

``make_optimizers`` builds the two optax chains of the JAX package by hand —
an optional ``clip_by_global_norm``, then Adam (or SGD) under a constant or
cosine schedule — so that the arithmetic follows optax's step for step:
the clip scales by ``max_norm / norm`` only when ``norm >= max_norm`` (no
epsilon, unlike ``torch.nn.utils.clip_grad_norm_``); Adam's moments update
as ``(1 - b) g + b m``, its bias correction reads the incremented count, and
the schedule reads the count before the increment.

Under a biased update codec with error feedback (``fed.dcn_compress`` in
sign1bit/topk, ``fed.dcn_error_feedback``) a client also carries
``ef_residual``: one f32 tensor per leaf of its ``(user, news)``
contribution, in the Flax layout and leaf order the codecs address
(``params.flax_leaves``), zero at init; the mass its encodes dropped, added
to its next round's update (``train.step.build_param_sync``).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from fedrec_tpu_torch.comms.codecs import codec_uses_feedback
from fedrec_tpu_torch.config import ExperimentConfig
from fedrec_tpu_torch.params import flax_leaves

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
# a client's noise stream is seeded this far from its dropout stream, so the
# two never coincide (dropout seeds are small: train.seed + client)
_NOISE_SEED_OFFSET = 1 << 32


@dataclass
class OptState:
    """optax's count (shared by Adam's bias correction and the schedule) and
    Adam's first and second moments, one per parameter (None for SGD)."""

    count: int = 0
    mu: list[torch.Tensor] | None = None
    nu: list[torch.Tensor] | None = None


class Optimizer:
    """One optax chain: optional global-norm clip, then Adam or SGD scaled
    by ``-lr(count)``. ``update`` returns the updates to add to the
    parameters, as an optax ``GradientTransformation`` does."""

    def __init__(self, schedule: Callable[[int], float], optimizer: str = "adam",
                 clip_norm: float = 0.0):
        if optimizer not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self.schedule, self.optimizer, self.clip_norm = schedule, optimizer, clip_norm

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        if self.optimizer == "sgd":
            return OptState()
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return OptState(0, zeros, [z.clone() for z in zeros])

    def update(self, grads: Sequence[torch.Tensor | None], state: OptState,
               params: Sequence[torch.Tensor]) -> tuple[list[torch.Tensor], OptState]:
        g = [torch.zeros_like(p) if x is None else x for x, p in zip(grads, params)]
        if self.clip_norm > 0:
            norm = torch.sqrt(sum(torch.sum(x.float() * x.float()) for x in g))
            keep = norm < self.clip_norm
            g = [torch.where(keep, x, x / norm.to(x.dtype) * self.clip_norm) for x in g]
        step_size = -np.float32(self.schedule(state.count))
        if self.optimizer == "sgd":
            return [x * step_size for x in g], OptState(state.count + 1)
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(_B1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(_B2) ** np.float32(count))
        mu = [(1 - _B1) * x + _B1 * m for x, m in zip(g, state.mu)]
        nu = [(1 - _B2) * (x * x) + _B2 * v for x, v in zip(g, state.nu)]
        updates = [
            (m / bc1) / (torch.sqrt(v / bc2) + _EPS) * float(step_size)
            for m, v in zip(mu, nu)
        ]
        return updates, OptState(count, mu, nu)


def _schedule(cfg: ExperimentConfig, lr: float) -> Callable[[int], float]:
    o = cfg.optim
    if o.lr_schedule not in ("constant", "cosine"):
        raise ValueError(f"unknown lr_schedule {o.lr_schedule!r} (constant|cosine)")
    if o.lr_schedule == "constant" or o.decay_steps <= 0:
        return lambda count: lr
    f32 = np.float32

    def cosine(count: int) -> float:  # optax.cosine_decay_schedule, in f32
        c = f32(min(count, o.decay_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(o.decay_steps), dtype=f32))
        return float(f32(lr) * ((f32(1) - f32(o.lr_min_frac)) * decay + f32(o.lr_min_frac)))

    return cosine


def make_optimizers(cfg: ExperimentConfig) -> tuple[Optimizer, Optimizer]:
    """The user tower's and the text head's chains (``optim.*``): each tower
    has its own clip and its own Adam."""
    o = cfg.optim

    def make(lr: float) -> Optimizer:
        return Optimizer(_schedule(cfg, lr), o.optimizer, o.grad_clip_norm)

    return make(o.user_lr), make(o.news_lr)


@dataclass
class ClientState:
    step: int
    model: torch.nn.Module            # this client's NewsRecommender
    opt_user: OptState
    opt_news: OptState
    generator: torch.Generator = field(repr=False)
    noise_generator: torch.Generator | None = field(default=None, repr=False)
    # decoupled mode: the (N, news_dim) f32 per-news-id gradient sum of the
    # current epoch; allocated by the train step from the table it is given,
    # zeroed by the epoch-end news update
    news_grad_accum: torch.Tensor | None = field(default=None, repr=False)
    # the codec's error-feedback residual, Flax layout and leaf order
    # (None without a biased codec under fed.dcn_error_feedback)
    ef_residual: list[torch.Tensor] | None = field(default=None, repr=False)

    def user_params(self) -> list[torch.Tensor]:
        return list(self.model.user_encoder.parameters())

    def news_params(self) -> list[torch.Tensor]:
        return list(self.model.news_tower.parameters())


def init_client_state(model: torch.nn.Module, cfg: ExperimentConfig, seed: int = 0) -> ClientState:
    """One client's state around ``model`` (already initialised, e.g. by
    ``params.init_params`` or ``params.from_flax``, and on its device)."""
    opt_user, opt_news = make_optimizers(cfg)
    dev = next(model.parameters()).device
    residual = None
    if codec_uses_feedback(cfg.fed.dcn_compress, cfg.fed.dcn_error_feedback):
        residual = [torch.zeros_like(x) for x in
                    flax_leaves(model.user_encoder) + flax_leaves(model.news_tower)]
    return ClientState(
        step=0,
        model=model,
        opt_user=opt_user.init(list(model.user_encoder.parameters())),
        opt_news=opt_news.init(list(model.news_tower.parameters())),
        generator=torch.Generator(device=dev).manual_seed(seed),
        noise_generator=torch.Generator(device=dev).manual_seed(seed + _NOISE_SEED_OFFSET),
        ef_residual=residual,
    )


def replicate_state(state: ClientState, num_clients: int, seed: int = 0) -> list[ClientState]:
    """One init copied to every client, each with its own dropout stream
    (seeded ``seed + c``) and noise stream: all clients start from identical
    parameters, as the reference's server broadcasts the initial model."""
    dev = state.generator.device
    return [
        ClientState(
            step=state.step,
            model=copy.deepcopy(state.model),
            opt_user=copy.deepcopy(state.opt_user),
            opt_news=copy.deepcopy(state.opt_news),
            generator=torch.Generator(device=dev).manual_seed(seed + c),
            noise_generator=torch.Generator(device=dev).manual_seed(
                seed + c + _NOISE_SEED_OFFSET),
            ef_residual=(None if state.ef_residual is None
                         else [r.clone() for r in state.ef_residual]),
        )
        for c in range(num_clients)
    ]


def stack_states(states: Sequence[ClientState]) -> list[ClientState]:
    """The clients as one list (the JAX package stacks them on a leading
    axis); every state must hold the same parameter shapes."""
    states = list(states)
    shapes = [[tuple(p.shape) for p in s.model.parameters()] for s in states]
    if any(s != shapes[0] for s in shapes):
        raise ValueError("stack_states: the clients' parameter shapes differ")
    return states
