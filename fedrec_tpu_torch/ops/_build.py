"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/fedrec_tpu_torch_kernels/<name>_<hash>.so <name>.cu

The library's file name carries a hash of the source and of every header
under ``csrc/``, so an edit rebuilds it and an unchanged source is loaded
from the build directory. A failed build raises ``KernelBuildError`` with
the compiler's output. ``build_all`` starts one ``nvcc`` for each source at
once (``chip_smoke.py`` calls it before the first launch).

The build directory is ``build/fedrec_tpu_torch_kernels/`` at the root of
the checkout that holds the package; ``build/`` is git-ignored.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_bound: set[str] = set()  # libraries whose C functions are typed
# seconds each source's nvcc took in this process (0.0 = loaded from cache)
build_seconds: dict[str, float] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def build_dir() -> Path:
    return CSRC.parents[2] / "build" / "fedrec_tpu_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def sources() -> list[str]:
    """Kernel names: one per ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start ``nvcc`` for ``name`` unless its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, tmp, proc


def _finish(name: str, started, t0: float) -> None:
    if started is None:
        build_seconds.setdefault(name, 0.0)
        return
    out, tmp, proc = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_seconds[name] = time.perf_counter() - t0


def build_all() -> dict[str, float]:
    """Compile every source, all ``nvcc`` processes started together.
    Returns the seconds each build took (0.0 where it was cached)."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in sources()}
        errors = []
        for n, s in started.items():
            try:
                _finish(n, s, t0)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))
        return {n: build_seconds[n] for n in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not (CSRC / f"{name}.cu").exists():
                raise KernelBuildError(f"no kernel source csrc/{name}.cu")
            _finish(name, _start(name), time.perf_counter())
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """``load(name)`` with its C functions typed for ctypes:
    ``signatures`` maps a function name to ``(argtypes, restype)``. Pointers
    must be ``c_void_p``, or ctypes passes them as 32-bit ints."""
    lib = load(name)
    if name not in _bound:
        for fn, (argtypes, restype) in signatures.items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, restype
        _bound.add(name)
    return lib


def library_path(name: str) -> str:
    return str(_lib_path(name))


def smem_limit(device) -> int:
    """Dynamic shared memory one block may opt into on ``device`` (bytes)."""
    import torch

    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C launcher: a
    refused launch never runs, and only ``cudaGetLastError`` reports it."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
