"""Device-layer telemetry, the port of ``fedrec_tpu/obs/device.py`` for CUDA:

* ``sample_device_memory``: the caching allocator's bytes in use, their
  peak and the card's memory (``torch.cuda.memory_stats`` and
  ``mem_get_info``) into the JAX package's gauges
  ``device.memory.{bytes_in_use,peak_bytes_in_use,bytes_limit}{device=}``,
  sampled at round boundaries and stamped into the trace as an ``hbm``
  instant inside the current ``fed_round`` span. A no-op on the CPU.
* ``BuildWatch``: the counterpart of the JAX package's ``CompileWatchdog``.
  The port compiles no XLA programs, so there are no recompiles to detect;
  the one kind of compile it has is the build of its native code at first
  use: each kernel source's ``nvcc`` (``ops._build``) and the data engine's
  ``g++`` (``data.native_batcher``). ``BuildWatch.publish`` counts the
  builds of this process (``kernel.builds_total{kernel=}``, a library
  loaded from the build cache is no build) and their seconds
  (``kernel.build_seconds{kernel=}``).
"""

from __future__ import annotations

from typing import Any

from fedrec_tpu_torch.obs.registry import MetricsRegistry, get_registry

_MEMORY_STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def _cuda_stats(device) -> dict[str, int] | None:
    import torch

    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def sample_device_memory(
    registry: MetricsRegistry | None = None,
    tracer: Any = None,
    device: Any = None,
    **annotations: Any,
) -> int:
    """Sample the allocator stats of ``device`` (a torch device; default
    the current CUDA device when one is there) into gauges, plus one trace
    instant. Returns how many devices reported stats: 0 on the CPU."""
    import torch

    registry = registry or get_registry()
    if device is None:
        if not torch.cuda.is_available():
            return 0
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    stats = _cuda_stats(device)
    dev = str(device.index if device.index is not None else torch.cuda.current_device())
    ev: dict[str, Any] = {"device": dev, **annotations}
    for key in _MEMORY_STAT_KEYS:
        registry.gauge(
            f"device.memory.{key}",
            "device allocator stats sampled at round boundaries",
            labels=("device",),
        ).set(float(stats[key]), device=dev)
        ev[key] = stats[key]
    if tracer is not None:
        tracer.instant("hbm", **ev)
    return 1


class BuildWatch:
    """Counts the native builds of this process into the registry: one
    ``kernel.builds_total{kernel=}`` increment and a
    ``kernel.build_seconds{kernel=}`` gauge per library compiled here (not
    one loaded from the build cache). ``publish`` is idempotent: a build
    is counted once however often it is called (the trainer calls it at
    every round boundary, after that round's first launches built what
    they needed)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or get_registry()
        self._c_builds = self.registry.counter(
            "kernel.builds_total",
            "native libraries compiled by this process (nvcc kernels, the g++ "
            "data engine), by library", labels=("kernel",))
        self._g_secs = self.registry.gauge(
            "kernel.build_seconds", "wall seconds of each native build", labels=("kernel",))
        self._seen: set[str] = set()

    @staticmethod
    def builds() -> dict[str, float]:
        """``{library: seconds}`` of every build so far (0.0 = loaded from
        the cache)."""
        from fedrec_tpu_torch.data import native_batcher
        from fedrec_tpu_torch.ops import _build

        out = dict(_build.build_seconds)
        if native_batcher.build_seconds is not None:
            out["fedrec_data"] = native_batcher.build_seconds
        return out

    def publish(self) -> dict[str, float]:
        """Count the builds not counted yet; returns every build's seconds."""
        builds = self.builds()
        for name, secs in builds.items():
            if name in self._seen:
                continue
            self._seen.add(name)
            self._g_secs.set(float(secs), kernel=name)
            if secs > 0:
                self._c_builds.inc(kernel=name)
        return builds
