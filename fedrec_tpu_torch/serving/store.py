"""Versioned news-embedding store with atomic hot-swap, the port of
``fedrec_tpu/serving/store.py``: the store, its pre-swap drift probe and
the checkpoint restore (``load_checkpoint_params``,
``publish_from_checkpoint``). The sharded store is ROADMAP.md's Queue A
item 9.

The store holds immutable :class:`Generation` snapshots. ``publish`` builds
the new generation completely and then swaps it in with one reference
assignment; readers call ``current()`` once per batch, so no batch ever
mixes two generations.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from fedrec_tpu_torch.config import ModelConfig
from fedrec_tpu_torch.device import resolve_device, torch_dtype
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.obs import DriftProbe, get_registry
from fedrec_tpu_torch.train.checkpoint import (
    SnapshotManager,
    coordinator_globals,
    global_round_of,
    load_state_bytes,
)


class EmptyStoreError(RuntimeError):
    """``current()`` before any generation was published."""


@dataclass(frozen=True)
class Generation:
    """One immutable serving snapshot."""

    generation: int
    news_vecs: Any                    # (N, D) news-vector table (torch tensor)
    user_params: Any                  # the user-tower module that scores it
    valid_mask: np.ndarray | None     # (N,) bool; False rows never served
    round: int | None                 # federated round, when known
    source: str                       # "synthetic" | "manual" | ...
    published_at: float

    @property
    def num_news(self) -> int:
        return int(self.news_vecs.shape[0])


class EmbeddingStore:
    """Holds the current :class:`Generation` and swap bookkeeping."""

    def __init__(self, clock=time.time, registry=None, drift_probe: DriftProbe | None = None):
        self._clock = clock
        self._lock = threading.Lock()
        self._gen: Generation | None = None
        self._swap_count = 0
        self._registry = reg = registry or get_registry()
        self._g_generation = reg.gauge(
            "serve.generation", "embedding-store generation being served"
        )
        self._g_swaps = reg.gauge("serve.swap_count", "hot-swaps since the store was created")
        self._g_num_news = reg.gauge("serve.num_news", "catalog rows in the current generation")
        # pre-swap quality probe (obs.quality): scores a pinned probe set
        # against the outgoing AND incoming table BEFORE the swap, so a bad
        # table push shows in serve.drift_* before it serves traffic
        self._drift = drift_probe

    def enable_drift_probe(self, num_probes: int = 32, topk: int = 10, seed: int = 0) -> None:
        """Arm the pre-swap drift probe (``obs.quality.probe_users`` /
        ``probe_topk`` in the serving CLI)."""
        self._drift = DriftProbe(num_probes=num_probes, topk=topk, seed=seed,
                                 registry=self._registry)

    def current(self) -> Generation:
        gen = self._gen
        if gen is None:
            raise EmptyStoreError("no generation published yet")
        return gen

    def metrics(self) -> dict:
        gen = self._gen
        if gen is None:
            return {"generation": None, "swap_count": self._swap_count}
        out = {
            "generation": gen.generation,
            "swap_count": self._swap_count,
            "round": gen.round,
            "source": gen.source,
            "num_news": gen.num_news,
            "staleness_sec": round(self._clock() - gen.published_at, 3),
        }
        if self._drift is not None and self._drift.last is not None:
            out.update({f"drift_{k}": v for k, v in self._drift.last.items()
                        if isinstance(v, (int, float, bool))})
        return out

    def publish(
        self,
        news_vecs,
        user_params,
        valid_mask: np.ndarray | None = None,
        round: int | None = None,
        source: str = "manual",
    ) -> Generation:
        """Build the full new generation, then swap it in atomically. The
        first publish is generation 0 and does not count as a swap. With a
        drift probe armed, the incoming table is scored against the
        outgoing one BEFORE the swap (``serve.drift_*``); a probe failure is
        reported, never allowed to block the publish."""
        with self._lock:
            prev = self._gen
            if self._drift is not None and prev is not None:
                try:
                    self._drift.compare(_host(prev.news_vecs), prev.valid_mask,
                                        _host(news_vecs), valid_mask)
                except Exception as e:  # noqa: BLE001 — the probe is telemetry
                    print(f"[store] drift probe failed: {type(e).__name__}: {e}")
            gen = Generation(
                generation=0 if prev is None else prev.generation + 1,
                news_vecs=news_vecs,
                user_params=user_params,
                valid_mask=valid_mask,
                round=round,
                source=source,
                published_at=self._clock(),
            )
            self._gen = gen  # the one atomic publish point
            if prev is not None:
                self._swap_count += 1
            self._g_generation.set(gen.generation)
            self._g_swaps.set(self._swap_count)
            self._g_num_news.set(gen.num_news)
            return gen


def _host(vecs) -> np.ndarray:
    if isinstance(vecs, torch.Tensor):
        return vecs.detach().float().cpu().numpy()
    return np.asarray(vecs)


class SnapshotFormatError(RuntimeError):
    """The snapshot directory holds only a format the port cannot restore."""


def _orbax_rounds(snap_dir: Path) -> list[int]:
    """Step directories of the JAX package's orbax manager (``<dir>/<r>/``)."""
    return sorted(int(p.name) for p in snap_dir.iterdir() if p.is_dir() and p.name.isdigit())


def _jax_coordinator_globals(snap_dir: Path) -> list[Path]:
    """The JAX coordinator deployment's ``global_round_<r>.msgpack`` files."""
    return [p for p in snap_dir.glob("global_round_*.msgpack")
            if p.stem.rsplit("_", 1)[-1].isdigit()]


def load_checkpoint_params(
    snap_dir: str | Path, log: Callable[[str], None] | None = None
) -> tuple[dict, dict, int, str]:
    """Restore ``(user_state, news_state, round, kind)`` from the newest of
    the port's own snapshots in ``snap_dir``: a trainer snapshot
    (``train.checkpoint``: ``round_<r>/state.pt``, ``kind="torch"``) or a
    coordinator server's global (``global_round_<r>.pt``,
    ``kind="coordinator"``), whichever holds the later round. The
    parameters are client 0's user-tower and news-tower parameters as host
    tensors by name (every client holds the same after a ``param_avg``
    round end).

    The JAX package's formats are refused by name: its coordinator's
    msgpack globals wait for a msgpack reader (ROADMAP.md's Queue A item
    9), and its orbax trees for an orbax-to-npz bridge that is not ported.
    Where they sit beside the port's snapshots, ``log`` (optional) is told
    they were passed over.
    """
    snap_dir = Path(snap_dir)
    if not snap_dir.is_dir():
        raise FileNotFoundError(f"no snapshot directory {snap_dir}")
    orbax, globals_ = _orbax_rounds(snap_dir), _jax_coordinator_globals(snap_dir)
    mgr = SnapshotManager(snap_dir)
    try:
        round_ = mgr.latest_round()
        port_globals = coordinator_globals(snap_dir)
        if port_globals and (round_ is None or global_round_of(port_globals[-1]) >= round_):
            # written atomically: a concurrent writer never shows a torn file
            g = load_state_bytes(port_globals[-1].read_bytes())
            return g["user_params"], g["news_params"], int(g["round"]), "coordinator"
        raw = mgr.restore_raw(round_) if round_ is not None else None
    finally:
        mgr.close()
    if raw is not None:
        if log is not None and (orbax or globals_):
            log(f"passing over the JAX package's snapshots in {snap_dir} "
                f"(orbax rounds {orbax}, coordinator globals {len(globals_)}); "
                f"serving the port's round {round_}")
        client0 = raw["clients"][0]
        return client0["user_params"], client0["news_params"], int(raw["round"]), "torch"
    if globals_:
        raise SnapshotFormatError(
            f"{snap_dir} holds coordinator msgpack globals (global_round_<r>.msgpack) "
            "written by the JAX package's coordinator; restoring them waits for a "
            "msgpack reader (ROADMAP.md Queue A item 9). The port's coordinator writes "
            "global_round_<r>.pt, which this loader serves"
        )
    if orbax:
        raise SnapshotFormatError(
            f"{snap_dir} holds only orbax snapshot trees (rounds {orbax}) written by the "
            "JAX package; the orbax-to-npz bridge is not ported. Serve a snapshot of "
            "fedrec_tpu_torch's Trainer (round_<r>/state.pt)"
        )
    raise FileNotFoundError(
        f"no snapshot (round_<r>/state.pt or global_round_<r>.pt) under {snap_dir}")


def restore_model(
    cfg: ModelConfig, user_state: dict, news_state: dict,
    device: str | torch.device | None = None,
) -> NewsRecommender:
    """A fresh ``NewsRecommender(cfg)`` holding the restored parameters, in
    eval mode on ``device`` (default ``cuda``); raises ``ValueError`` when
    the snapshot's parameter shapes do not fit ``cfg``."""
    dev = resolve_device(device)
    model = NewsRecommender(cfg)
    with torch.no_grad():
        for part, module, state in (("user_params", model.user_encoder, user_state),
                                    ("news_params", model.news_tower, news_state)):
            want = {k: tuple(v.shape) for k, v in module.named_parameters()}
            got = {k: tuple(v.shape) for k, v in state.items()}
            if got != want:
                raise ValueError(f"snapshot {part} {got} do not fit the model config's {want}: "
                                 "serve with the training run's model settings")
            for name, p in module.named_parameters():
                p.copy_(state[name])
    return model.to(dev).eval().requires_grad_(False)


def publish_from_checkpoint(
    store: EmbeddingStore,
    cfg: ModelConfig,
    snap_dir: str | Path,
    token_states,
    valid_mask: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> Generation:
    """Refresh flow: checkpoint -> ``encode_all_news`` (kernel A under
    ``cfg.use_pallas``) -> atomic publish, on ``device`` (default
    ``cuda``). ``token_states`` is the (N, L, bert_hidden) cached-trunk
    table (numpy or a tensor); a host table crosses to the device one chunk
    at a time."""
    from fedrec_tpu_torch.train.step import encode_all_news

    dev = resolve_device(device)
    user_state, news_state, round_, kind = load_checkpoint_params(snap_dir)
    model = restore_model(cfg, user_state, news_state, dev)
    tokens = torch.as_tensor(token_states).to(dtype=torch_dtype(cfg.dtype))
    table = encode_all_news(model, tokens, device=dev)
    return store.publish(table, model.user_encoder, valid_mask=valid_mask,
                         round=round_, source=f"checkpoint:{kind}")
