"""The buffered commit's pending contributions (``agg.mode = "async"``), the
port of ``fedrec_tpu/agg/buffer.py``.

An entry is one worker's round contribution: a delta against the global
version it trained from (``based_on``), with its membership epoch, its
aggregation weight and its report latency. Entries wait here until
``agg.commit.fold_commit`` folds them: on time at quorum, weighted by their
staleness into a later commit, or dropped past ``agg.staleness_cap``.

A contribution is an ordered list of numpy leaves (the caller flattens and
unflattens). Its ``codec`` tag names what the leaves hold: ``"none"`` for a
dense delta (per-contribution codecs decode when they are pushed) or a
linear sketch codec whose per-leaf sketches fold in sketch space. The buffer
also banks each worker's error-feedback residual, tagged with the version
its contribution was based on.

The buffer saves beside the model snapshot as ``agg_buffer.npz``
(:meth:`AggBuffer.state_bytes` / :meth:`AggBuffer.load_state`), in the JAX
package's layout byte for byte: a ``__meta__`` JSON blob as uint8 and
``e<i>_leaf<j>`` / ``r<k>_leaf<j>`` arrays, so each package reads the
other's.
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass, field

import numpy as np

__all__ = ["AGG_BUFFER_SIDECAR", "AggBuffer", "BufferEntry"]

# the sidecar's name beside the model snapshot
AGG_BUFFER_SIDECAR = "agg_buffer.npz"

_MAGIC = "fedrec-agg-buffer-v1"


@dataclass
class BufferEntry:
    """One worker's pending round contribution (a delta against
    ``based_on``)."""

    worker: str
    round: int
    epoch: int                      # membership epoch the delta was produced under
    based_on: int                   # global version the worker trained from
    weight: float
    arrival_ms: float               # simulated or measured report latency
    leaves: list = field(default_factory=list)  # ordered np.ndarray leaves
    # "none" = dense delta leaves; a linear sketch codec's name = its
    # per-leaf sketch arrays
    codec: str = "none"
    # the async wire's idempotency token ("" in process)
    push_id: str = ""


class AggBuffer:
    """Epoch-keyed pending contributions and banked residuals, with
    sidecar persistence."""

    def __init__(self, epoch: int = 0):
        self.epoch = int(epoch)
        self.entries: list[BufferEntry] = []
        # worker id -> {"based_on": int, "leaves": [np.ndarray, ...]}
        self.ef_residuals: dict[str, dict] = {}

    def __len__(self) -> int:
        return len(self.entries)

    def add(self, entry: BufferEntry) -> BufferEntry | None:
        """Buffer ``entry``; a re-push of the same worker's round replaces
        its pending entry (a retry must not double its weight). Returns the
        replaced entry, or None."""
        replaced: BufferEntry | None = None
        kept: list[BufferEntry] = []
        for e in self.entries:
            if e.worker == entry.worker and e.round == entry.round:
                replaced = e
            else:
                kept.append(e)
        kept.append(entry)
        self.entries = kept
        return replaced

    def pending_workers(self) -> set[str]:
        return {e.worker for e in self.entries}

    def bank_residual(self, worker: str, based_on: int, leaves: list) -> None:
        """Bank ``worker``'s encode residual against the version its
        contribution was based on, replacing the one before."""
        self.ef_residuals[str(worker)] = {"based_on": int(based_on),
                                          "leaves": [np.asarray(x) for x in leaves]}

    def residual_for(self, worker: str) -> list | None:
        """The residual banked for ``worker``, or None."""
        banked = self.ef_residuals.get(str(worker))
        return None if banked is None else banked["leaves"]

    def take_all(self) -> list[BufferEntry]:
        out, self.entries = self.entries, []
        return out

    def advance_epoch(self, epoch: int, drop_dead: set[str] | None = None) -> int:
        """A reformed membership: adopt ``epoch`` and drop the pending
        entries and residuals of the workers in ``drop_dead`` (folding a dead
        member's delta would revive its weight); the survivors' stay. Returns
        the number of entries dropped."""
        if epoch < self.epoch:
            raise ValueError(f"membership epoch moved backwards: {self.epoch} -> {epoch}")
        self.epoch = int(epoch)
        if not drop_dead:
            return 0
        before = len(self.entries)
        self.entries = [e for e in self.entries if e.worker not in drop_dead]
        for w in drop_dead:
            self.ef_residuals.pop(str(w), None)
        return before - len(self.entries)

    # ------------------------------------------------------- persistence
    def state_bytes(self, round_idx: int, version: int) -> bytes:
        """The round-tagged npz sidecar, one blob."""
        residual_workers = sorted(self.ef_residuals)
        meta = {
            "magic": _MAGIC,
            "round": int(round_idx),
            "version": int(version),
            "epoch": self.epoch,
            "entries": [
                {"worker": e.worker, "round": e.round, "epoch": e.epoch,
                 "based_on": e.based_on, "weight": float(e.weight),
                 "arrival_ms": float(e.arrival_ms), "num_leaves": len(e.leaves),
                 "codec": e.codec, "push_id": e.push_id}
                for e in self.entries
            ],
            "residuals": [
                {"worker": w, "based_on": int(self.ef_residuals[w]["based_on"]),
                 "num_leaves": len(self.ef_residuals[w]["leaves"])}
                for w in residual_workers
            ],
        }
        arrays = {f"e{i}_leaf{j}": np.asarray(leaf)
                  for i, e in enumerate(self.entries) for j, leaf in enumerate(e.leaves)}
        arrays.update({f"r{k}_leaf{j}": np.asarray(leaf)
                       for k, w in enumerate(residual_workers)
                       for j, leaf in enumerate(self.ef_residuals[w]["leaves"])})
        buf = io.BytesIO()
        np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
        return buf.getvalue()

    @classmethod
    def load_state(cls, blob: bytes) -> tuple["AggBuffer", int, int]:
        """``(buffer, round, version)`` from :meth:`state_bytes`'s blob;
        ``ValueError`` on a foreign or torn one (late contributions are
        droppable, so the caller may start empty)."""
        with np.load(io.BytesIO(blob)) as z:
            try:
                meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
            except (KeyError, json.JSONDecodeError) as e:
                raise ValueError(f"not an agg-buffer sidecar: {e}") from e
            if meta.get("magic") != _MAGIC:
                raise ValueError(f"not an agg-buffer sidecar (magic={meta.get('magic')!r})")
            buf = cls(epoch=meta["epoch"])
            for i, ent in enumerate(meta["entries"]):
                buf.entries.append(BufferEntry(
                    worker=ent["worker"], round=int(ent["round"]), epoch=int(ent["epoch"]),
                    based_on=int(ent["based_on"]), weight=float(ent["weight"]),
                    arrival_ms=float(ent["arrival_ms"]),
                    leaves=[np.asarray(z[f"e{i}_leaf{j}"]) for j in range(ent["num_leaves"])],
                    codec=str(ent.get("codec", "none")), push_id=str(ent.get("push_id", ""))))
            for k, res in enumerate(meta.get("residuals", [])):
                buf.ef_residuals[str(res["worker"])] = {
                    "based_on": int(res["based_on"]),
                    "leaves": [np.asarray(z[f"r{k}_leaf{j}"]) for j in range(res["num_leaves"])],
                }
        return buf, int(meta["round"]), int(meta["version"])
