"""Device selection for the port's entry points.

Entry points run on the GPU: ``resolve_device(None)`` is ``cuda``, and it
raises when no GPU is present instead of falling back to the CPU. Callers
that want the CPU (the parity tests, a laptop smoke run) pass
``device="cpu"`` explicitly; on CPU tensors every kernel wrapper takes its
plain PyTorch version.
"""

from __future__ import annotations

import torch


class NoGPUError(RuntimeError):
    """A GPU entry point was called on a machine without CUDA."""


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoGPUError(
            "no CUDA device: the port's entry points run on the GPU; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string -> torch dtype."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"model.dtype must be one of {sorted(table)}, got {name!r}")
    return table[name]
