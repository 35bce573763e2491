"""Small host utilities of the port (``utils.logging.MetricLogger``) and
its one atomic file write, which needs no torch."""

import os
from pathlib import Path


def atomic_write_bytes(path: Path, blob: bytes) -> None:
    """Write to a temporary name, flush to disk, then rename, so that a
    reader never sees a torn file."""
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
