"""Federated aggregation strategies, the port of ``fedrec_tpu/fed/strategies.py``.

The JAX package calls these hooks inside one SPMD program, as collectives
over the mesh's clients axis. Here the K clients are a list on one device, so
a hook takes the K clients' tensors and returns K results:

  * ``GradAvg``  — ``sync_grads``: every client steps with the mean of the K
    clients' gradients, each step (DDP parity)
  * ``ParamAvg`` — ``sync_params``: every client adopts the participation-
    weighted mean of the K clients' parameters at round end (FedAvg)
  * ``Local``    — no communication

``ServerOptimizer`` is FedOpt over round deltas (sgd, FedAvgM, FedAdam), a
numpy step on the host over the parameters as one ordered list of arrays,
with the JAX package's expressions and dtypes, so that on the same inputs
its step is bitwise the JAX one.
"""

from __future__ import annotations

import io
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


_U32 = np.uint32
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) of ``jax.random``'s default
    generator, in numpy: ``key`` two 32-bit words, ``x0``/``x1`` the counter
    words, uint32 arrays of one shape."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0, x1 = x0.astype(_U32) + ks[0], x1.astype(_U32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _THREEFRY_ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            # key injection every 4 rounds
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def jax_uniform(seed: int, n: int) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), (n,))`` bitwise, for a
    seed in [0, 2**32) under JAX's partitionable threefry: key ``(0, seed)``,
    counters ``(0, arange(n))``, bits ``out0 ^ out1``, the top 23 bits as an
    f32 mantissa in [1, 2), minus 1."""
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"jax_uniform: seed {seed} is outside [0, 2**32)")
    hi, lo = threefry2x32((0, seed), np.zeros(n, _U32), np.arange(n, dtype=_U32))
    bits = (hi ^ lo) >> _U32(9) | _U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def participation_mask(seed: int, num_clients: int, fraction: float) -> np.ndarray:
    """(num_clients,) float32 round weights with at least one participant:
    all ones at ``fraction >= 1``; otherwise uniform scores and the
    ``k = max(1, round(fraction * num_clients))`` lowest kept.

    The JAX package's mask bitwise: its scores are
    ``jax.random.uniform(PRNGKey(seed), (num_clients,))``, drawn here by
    ``jax_uniform``, so for the same seed both packages pick the same
    clients. The trainer keys the mask ``hash((train.seed, round)) &
    0x7FFFFFFF``, as the JAX trainer does.
    """
    if fraction >= 1.0:
        return np.ones((num_clients,), dtype=np.float32)
    scores = jax_uniform(seed, num_clients)
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


class ServerOptimizer:
    """Server-side optimization over round deltas (FedOpt, Reddi et al.
    2021). FedAvg adopts the client mean; FedOpt treats ``global - mean`` as
    a pseudo-gradient and steps the global with it::

        delta  = global - mean
        global = global + server_opt(delta)

    ``kind='sgd'`` with ``lr=1, momentum=0`` is FedAvg exactly,
    ``momentum > 0`` FedAvgM, ``kind='adam'`` FedAdam (optax's bias
    correction). The parameters are an ordered list of f32 numpy arrays (the
    trainer's user-tower then text-head parameters); the buffers stay on the
    host, as in the JAX package, and ``state_bytes`` / ``load_state``
    persist them round-tagged in the port's own format (an ``.npz``).
    """

    def __init__(self, kind: str = "sgd", lr: float = 1.0, momentum: float = 0.0):
        if kind not in ("sgd", "adam"):
            raise ValueError(f"unknown server optimizer {kind!r}; 'sgd' | 'adam'")
        self.kind, self.lr, self.momentum = kind, float(lr), float(momentum)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8  # optax.adam defaults
        self._state: dict | None = None

    def _init_state(self, params: Sequence[np.ndarray]) -> dict:
        zeros = [np.zeros_like(np.asarray(p)) for p in params]
        if self.kind == "sgd":
            return {"buf": zeros, "t": 0}
        return {"m": zeros, "v": [np.zeros_like(np.asarray(p)) for p in params], "t": 0}

    def step(self, global_params: Sequence[np.ndarray],
             mean_params: Sequence[np.ndarray]) -> list[np.ndarray]:
        """One server update on host arrays: the new global parameters.
        ``mean_params`` is the round's aggregate, ``global_params`` the
        global it was built from."""
        g = [np.asarray(x) for x in global_params]
        delta = [a - np.asarray(b) for a, b in zip(g, mean_params)]
        if self._state is None:
            self._state = self._init_state(g)
        st = self._state
        st["t"] += 1
        if self.kind == "sgd":
            if self.momentum:
                st["buf"] = [self.momentum * b + d for b, d in zip(st["buf"], delta)]
                upd = st["buf"]
            else:
                upd = delta
            return [p - self.lr * u for p, u in zip(g, upd)]
        st["m"] = [self.b1 * m + (1 - self.b1) * d for m, d in zip(st["m"], delta)]
        st["v"] = [self.b2 * v + (1 - self.b2) * d * d for v, d in zip(st["v"], delta)]
        t = st["t"]
        c1, c2 = 1 - self.b1**t, 1 - self.b2**t
        return [p - self.lr * (m / c1) / (np.sqrt(v / c2) + self.eps)
                for p, m, v in zip(g, st["m"], st["v"])]

    def state_bytes(self, round_idx: int = -1) -> bytes:
        """The buffers as ``.npz`` bytes, tagged with ``round_idx`` (the
        snapshot round they pair with)."""
        arrays = {"round": np.int64(round_idx), "kind": np.str_(self.kind)}
        if self._state is not None:
            arrays["t"] = np.int64(self._state["t"])
            for name in ("buf", "m", "v"):
                for i, x in enumerate(self._state.get(name, ())):
                    arrays[f"{name}_{i}"] = x
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    def load_state(self, blob: bytes, params_template: Sequence | None = None) -> int:
        """Restore the buffers from ``state_bytes``; returns the round they
        were written at. The saved buffers must match ``params_template``'s
        shapes (arrays or shape tuples) when one is given."""
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            files = set(z.files)
            if str(z["kind"]) != self.kind:
                raise ValueError(f"server optimizer state is {str(z['kind'])!r}, "
                                 f"this run's fed.server_opt is {self.kind!r}")
            round_idx = int(z["round"])
            if "t" not in files:
                self._state = None
                return round_idx
            names = ("buf",) if self.kind == "sgd" else ("m", "v")
            state: dict = {"t": int(z["t"])}
            for name in names:
                n = sum(1 for f in files if f.startswith(f"{name}_"))
                state[name] = [z[f"{name}_{i}"] for i in range(n)]
        if params_template is not None:
            want = [tuple(getattr(p, "shape", p)) for p in params_template]
            for name in names:
                got = [x.shape for x in state[name]]
                if got != want:
                    raise ValueError(f"server optimizer buffers {name}: saved shapes {got} "
                                     f"vs this run's parameters {want}")
        self._state = state
        return round_idx
