"""Federated aggregation strategies, the port of ``fedrec_tpu/fed/strategies.py``.

The JAX package calls these hooks inside one SPMD program, as collectives
over the mesh's clients axis. Here the K clients are a list on one device, so
a hook takes the K clients' tensors and returns K results:

  * ``GradAvg``  — ``sync_grads``: every client steps with the mean of the K
    clients' gradients, each step (DDP parity)
  * ``ParamAvg`` — ``sync_params``: every client adopts the participation-
    weighted mean of the K clients' parameters at round end (FedAvg)
  * ``Local``    — no communication
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# one client's tensors, in a fixed order (its gradients or parameters)
Leaves = Sequence[torch.Tensor | None]


class FedStrategy:
    """Hooks over the K clients. Default: no communication."""

    name = "local"
    sync_grads_every_step = False
    sync_params_every_round = False

    def sync_grads(self, grads: Sequence[Leaves]) -> list[Leaves]:
        return list(grads)

    def sync_params(self, params: Sequence[Leaves], weights) -> list[Leaves]:
        return list(params)


class Local(FedStrategy):
    pass


class GradAvg(FedStrategy):
    """Per-step gradient averaging: the mean over clients (``lax.pmean``)."""

    name = "grad_avg"
    sync_grads_every_step = True

    def sync_grads(self, grads: Sequence[Leaves]) -> list[Leaves]:
        k = len(grads)
        mean = []
        for leaf in zip(*grads):
            if all(g is None for g in leaf):
                mean.append(None)
                continue
            total = sum(torch.zeros(()) if g is None else g for g in leaf)
            mean.append(total / k)
        return [mean] * k


class ParamAvg(FedStrategy):
    """Per-round participation-weighted parameter averaging (FedAvg)."""

    name = "param_avg"
    sync_params_every_round = True

    def sync_params(self, params: Sequence[Leaves], weights) -> list[Leaves]:
        return weighted_param_avg(params, weights)


_STRATEGIES = {s.name: s for s in (Local, GradAvg, ParamAvg)}


def get_strategy(name: str) -> FedStrategy:
    # "coordinator" shares the round-end math with param_avg (as in the JAX
    # package, whose coordinator deployment runs its own host-side round loop)
    key = "param_avg" if name == "coordinator" else name
    if key not in _STRATEGIES:
        raise ValueError(f"unknown federation strategy {name!r}; have {sorted(_STRATEGIES)}")
    return _STRATEGIES[key]()


def participation_mask(rng: np.random.Generator, num_clients: int, fraction: float) -> np.ndarray:
    """(num_clients,) float32 round weights with at least one participant:
    all ones at ``fraction >= 1``; otherwise uniform scores and the
    ``k = max(1, round(fraction * num_clients))`` lowest kept.

    The algorithm of the JAX package's mask, drawn from a numpy
    ``Generator`` instead of ``jax.random`` (which the port cannot
    reproduce): for the same seed the two packages pick different clients.
    """
    if fraction >= 1.0:
        return np.ones((num_clients,), dtype=np.float32)
    scores = rng.random(num_clients, dtype=np.float32)
    k = max(1, int(round(fraction * num_clients)))
    threshold = np.sort(scores)[k - 1]
    return (scores <= threshold).astype(np.float32)


def weighted_param_avg(params: Sequence[Leaves], weights) -> list[Leaves]:
    """Participation-weighted FedAvg over the K clients' parameters.

    ``weights`` holds one round weight per client (0 = dropped out). Every
    client, non-participants included, adopts the weighted mean. A round
    where no client reports keeps everyone's local parameters (rather than
    dividing by zero). Zero-weight clients are left out of the sum, not
    multiplied in: a faulted client whose parameters are NaN must contribute
    nothing, and ``NaN * 0`` would still poison the mean.
    """
    w = np.asarray(weights, dtype=np.float32).reshape(-1)
    if w.shape[0] != len(params):
        raise ValueError(f"{w.shape[0]} weights for {len(params)} clients")
    total = np.float32(w.sum(dtype=np.float32))
    if not total > 0:
        return [list(p) for p in params]
    mean = []
    for leaf in zip(*params):
        acc = None
        for p, wc in zip(leaf, w):
            if wc > 0:
                acc = p * float(wc) if acc is None else acc + p * float(wc)
        mean.append(acc / float(total))
    return [list(mean) for _ in params]
