"""The seq world's layout, the seq half of ``fedrec_tpu/parallel/mesh.py``.

The JAX module builds a device mesh: a ``clients`` axis, and a second axis
(``seq`` under ``fed.seq_shards > 1``, or ``fsdp``). The port keeps its K
clients in one process as a Python loop over ``ClientState``s, so the
clients axis has no counterpart here; the seq axis becomes a world of
``fed.seq_shards`` processes (``parallel.ring.SeqGroup``), each holding all
K clients, the parameters and the candidates, and one slice of every
history:

* :func:`seq_group`: the counterpart of ``fed_mesh``'s seq branch, with its
  refusals (``shard.fsdp`` with ``fed.seq_shards``, a history length the
  world does not divide), over a ``parallel.multihost.World`` (a TCPStore on
  rank 0 and a gloo group of its own);
* :func:`shard_fed_batch`: the counterpart of ``fed_batch_spec`` /
  ``shard_fed_batch``: ``history``'s last dim split over the world, every
  other key whole.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from fedrec_tpu_torch.parallel.ring import SeqGroup


def check_seq_layout(cfg: Any) -> int:
    """``fed.seq_shards`` after the JAX ``fed_mesh``'s refusals, with its
    wording."""
    n_seq = cfg.fed.seq_shards
    n_fsdp = cfg.shard.fsdp
    if n_fsdp > 1 and n_seq > 1:
        raise ValueError(
            f"shard.fsdp={n_fsdp} with fed.seq_shards={n_seq} is not supported: both claim "
            "the mesh's second axis — unset one of the two")
    if n_seq > 1 and cfg.data.max_his_len % n_seq != 0:
        raise ValueError(
            f"data.max_his_len={cfg.data.max_his_len} must be divisible by "
            f"fed.seq_shards={n_seq} to shard the history axis")
    return n_seq


def seq_group(cfg: Any, world: Any = None) -> SeqGroup | None:
    """This process's :class:`SeqGroup` for ``cfg`` in ``world`` (a
    ``parallel.multihost.World`` of ``fed.seq_shards`` processes), or None
    when ``fed.seq_shards`` is 1."""
    n_seq = check_seq_layout(cfg)
    if n_seq <= 1:
        return None
    if world is None or world.size != n_seq:
        got = "none" if world is None else f"a world of {world.size}"
        raise ValueError(f"fed.seq_shards={n_seq} needs a world of {n_seq} processes, got {got} "
                         "(the run CLI starts one itself)")
    return SeqGroup(world.rank, world.size, world.pg)


def shard_fed_batch(batch: dict, group: SeqGroup | None) -> dict:
    """``batch`` with ``history``'s last dim cut to this rank's columns
    ``[r H/S, (r+1) H/S)``; the other keys whole (candidates and labels are
    replicated). A world of one, or none, returns ``batch``."""
    if group is None or group.size == 1:
        return batch
    out = dict(batch)
    h = batch["history"]
    width = h.shape[-1]
    if width % group.size:
        raise ValueError(f"history length {width} does not divide over {group.size} seq ranks")
    cut = width // group.size
    cols = slice(group.rank * cut, (group.rank + 1) * cut)
    out["history"] = h[..., cols] if not isinstance(h, np.ndarray) else np.ascontiguousarray(
        h[..., cols])
    return out
