"""ctypes binding for the port's native C++ data engine
(``fedrec_tpu_torch/data/csrc/fedrec_data.cpp``), the port of
``fedrec_tpu/data/native_batcher.py``.

``NativeTrainBatcher`` is a drop-in replacement for
``data.batcher.TrainBatcher`` whose host-side hot loop (epoch shuffling,
round-robin client sharding, negative sampling, batch packing) runs in the
C++ library, threaded for whole-epoch fills (``data.native_loader``). Shapes,
sharding, padding and the pool-shorter-than-ratio semantics match the Python
batcher; the negative-sampling RNG is the engine's own deterministic
per-(seed, epoch, client, batch) stream, so its batches equal the JAX
package's engine's bitwise for the same seed, but not numpy's draws.

The library is built from the port's own copy of the source with ``g++``
at first use, into ``build/fedrec_tpu_torch_native/`` at the root of the
checkout (git-ignored); its file name carries a hash of the source and the
flags, so an edit rebuilds it. It never loads the JAX package's
``native/libfedrec_data.so``. A failed build raises ``NativeBuildError``
with the compiler's output: unlike the JAX trainer, the port does not fall
back to the Python batcher.
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
from typing import Iterator

import numpy as np

from fedrec_tpu_torch.data.batcher import Batch, IndexedSamples

SOURCE = Path(__file__).resolve().parent / "csrc" / "fedrec_data.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# seconds the last g++ build of this process took (0.0 = loaded from cache)
build_seconds: float | None = None


class NativeBuildError(RuntimeError):
    """``g++`` is missing or refused the engine's source."""


def build_dir() -> Path:
    return SOURCE.parents[3] / "build" / "fedrec_tpu_torch_native"


def library_path(source: Path | None = None) -> Path:
    h = hashlib.sha256((source or SOURCE).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return build_dir() / f"libfedrec_data_{h.hexdigest()[:16]}.so"


def build(source: Path | None = None, timeout_s: float = 300.0) -> Path:
    """Compile ``source`` (default the engine's) unless its library is built
    already; returns the library's path. Raises ``NativeBuildError`` naming
    the failure."""
    global build_seconds
    source = source or SOURCE
    out = library_path(source)
    if out.exists():
        build_seconds = 0.0
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError("g++ not found on PATH (set CXX to a C++17 compiler)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, timeout=timeout_s)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"native engine build failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native engine build failed ({cxx} exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.frd_create.restype = ctypes.c_void_p
    lib.frd_create.argtypes = [
        i32p, i32p, i32p, i32p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.frd_destroy.restype = None
    lib.frd_destroy.argtypes = [ctypes.c_void_p]
    lib.frd_num_batches.restype = ctypes.c_int64
    lib.frd_num_batches.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.frd_fill_epoch.restype = ctypes.c_int
    lib.frd_fill_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, i32p, i32p, i32p, i32p]
    return lib


def load() -> ctypes.CDLL:
    """The engine's library, built first if needed (raises
    ``NativeBuildError`` when it cannot be built or loaded)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except OSError as e:
                raise NativeBuildError(f"cannot load the native engine {path}: {e}") from e
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeTrainBatcher:
    """``TrainBatcher``-compatible facade over the C++ engine. The engine
    copies the sample arrays at creation. Every epoch is filled in one
    threaded call, whose output arrays are allocated here and referenced
    until it returns: its threads write them and are all joined before it
    returns. An epoch's batches are then views of those arrays (an epoch of
    MIND-small's ~204k samples at 50 clicks holds ~47 MB)."""

    def __init__(
        self,
        indexed: IndexedSamples,
        batch_size: int,
        npratio: int = 4,
        shuffle: bool = True,
        drop_remainder: bool = True,
        seed: int = 0,
        num_threads: int = 0,
    ):
        self._lib = load()
        self.batch_size = batch_size
        self.npratio = npratio
        self.num_threads = num_threads
        self.max_his = indexed.history.shape[1]
        self.drop_remainder = drop_remainder
        self._n = len(indexed)

        arrays = [np.ascontiguousarray(a, dtype=np.int32) for a in (
            indexed.pos, indexed.neg_pools, indexed.neg_lens, indexed.history,
            indexed.his_len)]
        pos, pools, lens, hist, hlen = arrays
        self._handle = self._lib.frd_create(
            _ptr(pos), _ptr(pools), _ptr(lens), _ptr(hist), _ptr(hlen),
            len(indexed), pools.shape[1], self.max_his,
            batch_size, npratio, int(shuffle), int(drop_remainder),
            ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF).value,
        )
        if not self._handle:
            raise ValueError("frd_create rejected the arguments")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.frd_destroy(handle)
            self._handle = None

    # ------------------------------------------------------------------
    def num_batches(self, n: int | None = None) -> int:
        """Batches per epoch for ``n`` samples (default: the dataset)."""
        n = self._n if n is None else n
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _steps(self, num_clients: int) -> int:
        """Steps per epoch when dealt round-robin over ``num_clients``."""
        return int(self._lib.frd_num_batches(self._handle, num_clients))

    def _alloc(self, num_clients: int, steps: int):
        b, c, h = self.batch_size, 1 + self.npratio, self.max_his
        return (
            np.empty((steps, num_clients, b, c), np.int32),
            np.empty((steps, num_clients, b, h), np.int32),
            np.empty((steps, num_clients, b), np.int32),
            np.empty((steps, num_clients, b), np.int32),
        )

    # ------------------------------------------------------------------
    def epoch_batches(self, epoch: int = 0) -> Iterator[Batch]:
        for b in self.epoch_batches_sharded(1, epoch):
            yield Batch(b.candidates[0], b.history[0], b.his_len[0], b.labels[0])

    def epoch_batches_sharded(self, num_clients: int, epoch: int = 0) -> Iterator[Batch]:
        """The epoch's (clients, B, ...) steps in order: views of one
        threaded whole-epoch fill (``epoch_arrays_sharded``), made at the
        first step."""
        if self._steps(num_clients) == 0:
            return
        arr = self.epoch_arrays_sharded(num_clients, epoch)
        for i in range(arr.candidates.shape[0]):
            yield Batch(arr.candidates[i], arr.history[i], arr.his_len[i], arr.labels[i])

    def epoch_arrays_sharded(self, num_clients: int, epoch: int = 0) -> Batch:
        """The whole epoch as (steps, clients, B, ...) arrays, filled by the
        engine's threads."""
        steps = self._steps(num_clients)
        if steps == 0:
            raise ValueError("no batches: dataset smaller than num_clients*batch_size")
        cand, hist, hlen, labels = self._alloc(num_clients, steps)
        rc = self._lib.frd_fill_epoch(self._handle, epoch, num_clients, self.num_threads,
                                      _ptr(cand), _ptr(hist), _ptr(hlen), _ptr(labels))
        if rc != 0:
            raise ValueError(f"frd_fill_epoch failed (rc={rc})")
        return Batch(cand, hist, hlen, labels)
