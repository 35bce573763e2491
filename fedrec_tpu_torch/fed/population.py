"""Logical-client population for cross-device federation: the port of
``fedrec_tpu/fed/population.py``.

A population of N logical clients is sampled onto the trainer's K device
slots, a cohort a round. This module is the host-side state behind
``fed.population``:

* :class:`ClientPopulation`: N clients, each owning a static, seeded,
  equal-size row shard of the training set (equal sizes keep the steps a
  round fixed), a sample count (the ``weighted`` sampler's weight), an
  optimizer **sidecar** under ``client_state="persist"`` and a
  participation-ledger row. A sidecar is the slot state that follows a
  logical client across selections (``SIDECAR_FIELDS``) as host arrays,
  written back when the client leaves its slot and reloaded on its next
  selection. Sidecars live in an LRU store and spill to ``spill_dir`` above
  ``resident_cap``, each spill written atomically (a temporary file, then
  ``replace``). ``save_store`` / ``load_store`` carry the whole store with
  a snapshot, so a resumed run reloads exactly the sidecars the
  uninterrupted run holds.
* :class:`CohortPlan` and :func:`build_cohort_plan`: one round's cohort,
  ``ceil(slots * over_select)`` drawn candidates in priority order, the
  chaos plan's dropouts removed, the survivors packed into the slots front
  to back, a short cohort padded by repeating survivors at weight 0 (pads
  never write back).
* :func:`plan_round_weights`: the slots' participation weights, 0 for pads,
  dropouts and clients past the round deadline, from the same ``(seed,
  round, attempt, client)`` draws as the packing.
* :exc:`QuorumFailure`: fewer than ``min_reports`` reporters; the trainer
  discards the round from its entry state and replays it with a fresh draw.

Everything here is numpy; the sampled round runs the fixed world's train
step on another batch stack and weight vector.
"""

from __future__ import annotations

import os
import shutil
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterator

import numpy as np

from fedrec_tpu_torch.fed.chaos import population_report

# the ClientState fields that follow a logical client across selections,
# in the order a sidecar holds them: the step count, both optimizer states,
# the dropout and DP-noise generator states, and decoupled mode's
# news-gradient accumulator (zero at every round boundary, so carried as an
# empty marker; train.trainer)
SIDECAR_FIELDS = ("step", "opt_user", "opt_news", "generator", "noise_generator",
                  "news_grad_accum", "ef_residual")


class QuorumFailure(Exception):
    """A round's reporting cohort fell below ``fed.population.min_reports``.

    Control flow, not an error: the trainer raises it while it computes the
    round's weights, before any step, counts a quorum replay and re-enters
    the round with ``attempt + 1`` (a fresh draw and fresh fault dice), up
    to ``quorum_retries`` times, then aborts.
    """

    def __init__(self, anchor_round: int, round_idx: int, reporting: int,
                 min_reports: int, attempt: int):
        super().__init__(
            f"round {round_idx}: {reporting} reporting clients < quorum "
            f"min_reports={min_reports} (draw attempt {attempt})"
        )
        self.anchor_round = int(anchor_round)
        self.round_idx = int(round_idx)
        self.reporting = int(reporting)
        self.attempt = int(attempt)


@dataclass
class CohortPlan:
    """One round's resolved cohort."""

    round_idx: int                     # the draw anchor round
    attempt: int                       # quorum re-draw counter
    sampled: np.ndarray                # (S,) drawn candidates, priority order
    start_dropped: np.ndarray          # sampled ids that never started
    slot_clients: np.ndarray           # (slots,) logical occupant per slot
    slot_real: np.ndarray              # (slots,) bool; False = weight-0 pad

    @property
    def spares_unused(self) -> int:
        """Over-selected survivors that found no free slot."""
        survivors = len(self.sampled) - len(self.start_dropped)
        return max(0, survivors - int(self.slot_real.sum()))


def build_cohort_plan(
    sampler: Any,
    slots: int,
    round_idx: int,
    over_select: float,
    chaos: Any = None,
    exclude: set | tuple = (),
    attempt: int = 0,
    pack: bool = True,
) -> CohortPlan:
    """Draw and pack one round's cohort. ``pack=False`` is the degenerate
    world (population == slots): the slots are the clients, so a dropout
    keeps its slot and loses its weight in :func:`plan_round_weights`."""
    if over_select < 1.0:
        raise ValueError(
            f"fed.population.over_select must be >= 1.0, got {over_select}"
        )
    want = int(np.ceil(slots * over_select))
    sampled = sampler.draw(round_idx, want, exclude=exclude, attempt=attempt)
    if sampled.size == 0:
        raise RuntimeError(
            "cohort sampling found no eligible clients (population "
            "exhausted by quarantine?)"
        )
    if not pack:
        return CohortPlan(
            round_idx=int(round_idx),
            attempt=int(attempt),
            sampled=np.asarray(sampled, np.int64),
            start_dropped=np.zeros((0,), np.int64),
            slot_clients=np.resize(sampled, slots).astype(np.int64),
            slot_real=np.arange(slots) < len(sampled),
        )
    dropped, _ = population_report(chaos, round_idx, sampled, attempt)
    survivors = sampled[~dropped]
    # everyone dropped: pad from the raw draw so the shapes stay fixed; every
    # slot then has weight 0 and the quorum policy decides
    occupants = survivors[:slots] if survivors.size else sampled[:1]
    n_real = int(min(len(occupants), slots)) if survivors.size else 0
    return CohortPlan(
        round_idx=int(round_idx),
        attempt=int(attempt),
        sampled=np.asarray(sampled, np.int64),
        start_dropped=np.asarray(sampled[dropped], np.int64),
        slot_clients=np.resize(occupants, slots).astype(np.int64),
        slot_real=np.arange(slots) < n_real,
    )


def plan_round_weights(
    plan: CohortPlan,
    round_idx: int,
    deadline_ms: float = 0.0,
    chaos: Any = None,
) -> tuple[np.ndarray, dict]:
    """(slots,) float32 participation weights for ``round_idx`` under
    ``plan``, and the ledger's events ``{"reported", "dropped",
    "deadline_cut"}`` (unique ids). For the plan's anchor round the dropout
    draws replay the packing's, so an occupant can only lose its weight to
    the deadline."""
    slots = plan.slot_clients.shape[0]
    dropped, latency = population_report(chaos, round_idx, plan.slot_clients, plan.attempt)
    w = plan.slot_real & ~dropped
    cut = np.zeros(slots, bool)
    if deadline_ms and deadline_ms > 0:
        cut = w & (latency > deadline_ms)
        w = w & ~cut
    events = {
        "reported": _unique_ids(plan.slot_clients[w]),
        "dropped": _unique_ids(plan.slot_clients[plan.slot_real & dropped]),
        "deadline_cut": _unique_ids(plan.slot_clients[cut]),
    }
    return w.astype(np.float32), events


def _unique_ids(ids: np.ndarray) -> np.ndarray:
    return np.unique(np.asarray(ids, np.int64))


class ParticipationLedger:
    """Per-logical-client participation counts and quarantine expiries."""

    def __init__(self, population: int):
        self.population = int(population)
        self.selected = np.zeros((population,), np.int64)
        self.reported = np.zeros((population,), np.int64)
        self.dropped = np.zeros((population,), np.int64)
        self.deadline_cut = np.zeros((population,), np.int64)
        # client id -> first round it may be drawn again
        self.quarantined: dict[int, int] = {}

    def commit(self, cohort: np.ndarray, events: dict) -> None:
        np.add.at(self.selected, np.asarray(cohort, np.int64), 1)
        for key, arr in (("reported", self.reported), ("dropped", self.dropped),
                         ("deadline_cut", self.deadline_cut)):
            ids = np.asarray(events.get(key, ()), np.int64)
            if ids.size:
                np.add.at(arr, ids, 1)

    def quarantine(self, client_id: int, until_round: int) -> None:
        cid = int(client_id)
        self.quarantined[cid] = max(self.quarantined.get(cid, 0), int(until_round))

    def active_quarantine(self, round_idx: int) -> set[int]:
        """Clients still excluded at ``round_idx`` (expired entries pruned)."""
        for c in [c for c, until in self.quarantined.items() if until <= round_idx]:
            del self.quarantined[c]
        return set(self.quarantined)

    def coverage(self) -> float:
        """Fraction of the population selected at least once."""
        return float((self.selected > 0).mean())

    def state_dict(self) -> dict:
        q_ids = np.asarray(sorted(self.quarantined), np.int64)
        return {
            "population": np.int64(self.population),
            "selected": self.selected.copy(),
            "reported": self.reported.copy(),
            "dropped": self.dropped.copy(),
            "deadline_cut": self.deadline_cut.copy(),
            "quarantine_ids": q_ids,
            "quarantine_until": np.asarray([self.quarantined[int(c)] for c in q_ids], np.int64),
        }

    def load_state_dict(self, state: dict, resize: bool = False) -> None:
        """Restore the ledger. ``resize=False`` demands the same population;
        ``resize=True`` copies the overlapping prefix of every counter
        (clients past the saved population start fresh, counts of clients
        that no longer exist are dropped) and keeps the quarantine entries
        still addressable."""
        pop = int(state["population"])
        if pop != self.population and not resize:
            raise ValueError(
                f"ledger population mismatch: saved {pop} vs configured "
                f"{self.population}"
            )
        n = min(pop, self.population)
        for key in ("selected", "reported", "dropped", "deadline_cut"):
            arr = np.asarray(state[key], np.int64)
            if arr.shape != (pop,):
                raise ValueError(f"ledger {key} shape {arr.shape}")
            fresh = np.zeros((self.population,), np.int64)
            fresh[:n] = arr[:n]
            setattr(self, key, fresh)
        ids = np.asarray(state.get("quarantine_ids", ()), np.int64)
        until = np.asarray(state.get("quarantine_until", ()), np.int64)
        self.quarantined = {int(c): int(u) for c, u in zip(ids.reshape(-1), until.reshape(-1))
                            if int(c) < self.population}


def _flatten(sidecar: dict) -> tuple[tuple, list[np.ndarray]]:
    """A sidecar (field -> array or list of arrays, in insertion order) as
    its structure and its flat leaves."""
    structure, leaves = [], []
    for key, value in sidecar.items():
        if isinstance(value, (list, tuple)):
            structure.append((key, len(value)))
            leaves.extend(np.asarray(x) for x in value)
        else:
            structure.append((key, None))
            leaves.append(np.asarray(value))
    return tuple(structure), leaves


def _unflatten(structure: tuple, leaves: list) -> dict:
    out, i = {}, 0
    for key, n in structure:
        if n is None:
            out[key], i = leaves[i], i + 1
        else:
            out[key], i = list(leaves[i:i + n]), i + n
    return out


def _link_or_copy(src: Path, dst: Path) -> None:
    """``dst`` becomes a hard link to ``src`` (a copy across filesystems),
    put in place atomically. A later spill replaces ``src`` by a new file,
    so the link keeps the old contents."""
    tmp = dst.with_name(dst.name + ".tmp")
    tmp.unlink(missing_ok=True)
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


class ClientPopulation:
    """N logical clients: data shards, the sidecar store and the ledger.

    ``shard_rows(i)`` is client *i*'s static row shard: a ``(data_seed,
    0x909)``-seeded permutation of the rows dealt round-robin, each shard cut
    to the common ``shard_size = num_rows // N`` and sorted, so shards are
    equal, disjoint and deterministic.
    """

    def __init__(
        self,
        num_clients: int,
        num_rows: int,
        data_seed: int = 0,
        batch_size: int = 0,
        resident_cap: int = 0,
        spill_dir: str | Path | None = None,
    ):
        if num_clients <= 0:
            raise ValueError(f"population num_clients must be > 0, got {num_clients}")
        self.num_clients = int(num_clients)
        self.num_rows = int(num_rows)
        self.data_seed = int(data_seed)
        self.shard_size = self.num_rows // self.num_clients
        if self.shard_size < 1:
            raise ValueError(
                f"population of {num_clients} clients over {num_rows} "
                "training rows leaves empty shards; shrink "
                "fed.population.num_clients or bring more data"
            )
        if batch_size and self.shard_size < batch_size:
            raise ValueError(
                f"per-client shard ({self.shard_size} rows = {num_rows} // "
                f"{num_clients}) is smaller than data.batch_size="
                f"{batch_size}: a selected client could not fill one step. "
                "Shrink the batch size or the population."
            )
        perm = np.random.default_rng([self.data_seed, 0x909]).permutation(self.num_rows)
        self._rows = np.stack([np.sort(perm[i::self.num_clients][: self.shard_size])
                               for i in range(self.num_clients)])
        self.sample_counts = np.full((self.num_clients,), self.shard_size, np.int64)
        self.ledger = ParticipationLedger(self.num_clients)
        # the sidecar store: resident leaves in LRU order; _on_disk holds the
        # clients whose spill file has their current sidecar
        self.resident_cap = int(resident_cap)
        self.spill_dir = Path(spill_dir) if spill_dir else None
        self._resident: OrderedDict[int, list] = OrderedDict()
        self._on_disk: set[int] = set()
        self._structure: tuple | None = None
        self.spill_count = 0
        # per-client IndexedSamples.take views, LRU-bounded: rebuilding them
        # every epoch is host time between steps
        self._take_cache: OrderedDict[int, Any] = OrderedDict()
        self._take_cache_src: int | None = None

    # ------------------------------------------------------------- shards
    def shard_rows(self, client_id: int) -> np.ndarray:
        return self._rows[int(client_id)]

    def steps_per_epoch(self, batch_size: int) -> int:
        return max(self.shard_size // int(batch_size), 1)

    def client_seed(self, client_id: int) -> int:
        """Stable per-client batcher seed (shuffle and negative sampling)."""
        return (self.data_seed * 1_000_003 + 0x5EED + int(client_id)) % (2**31)

    def cohort_epoch_batches(self, cohort: np.ndarray, indexed: Any, data_cfg: Any,
                             epoch_idx: int) -> Iterator[Any]:
        """Stacked (slots, B, ...) batches where slot *j* iterates client
        ``cohort[j]``'s own shard, its order and negatives keyed by
        ``(client_seed, epoch_idx)``."""
        from fedrec_tpu_torch.data.batcher import Batch, TrainBatcher

        cohort = np.asarray(cohort, np.int64)
        iters = [
            TrainBatcher(
                self._client_view(int(cid), indexed, cap=4 * len(cohort)),
                data_cfg.batch_size, data_cfg.npratio, shuffle=data_cfg.shuffle,
                drop_remainder=True, seed=self.client_seed(cid),
            ).epoch_batches(epoch_idx)
            for cid in cohort
        ]
        for _ in range(self.steps_per_epoch(data_cfg.batch_size)):
            bs = [next(it) for it in iters]
            yield Batch(
                candidates=np.stack([b.candidates for b in bs]),
                history=np.stack([b.history for b in bs]),
                his_len=np.stack([b.his_len for b in bs]),
                labels=np.stack([b.labels for b in bs]),
            )

    def _client_view(self, cid: int, indexed: Any, cap: int) -> Any:
        """LRU-cached ``indexed.take(shard_rows(cid))``, dropped when another
        ``indexed`` arrives."""
        if self._take_cache_src is not id(indexed):
            self._take_cache.clear()
            self._take_cache_src = id(indexed)
        view = self._take_cache.get(cid)
        if view is None:
            view = self._take_cache[cid] = indexed.take(self.shard_rows(cid))
        else:
            self._take_cache.move_to_end(cid)
        while len(self._take_cache) > max(int(cap), 8):
            self._take_cache.popitem(last=False)
        return view

    # ----------------------------------------------------------- sidecars
    def _spill_path(self, client_id: int) -> Path:
        assert self.spill_dir is not None
        return self.spill_dir / f"client_{int(client_id):08d}.npz"

    def put_sidecar(self, client_id: int, sidecar: dict) -> None:
        """Store a client's sidecar (host arrays), spilling the least
        recently stored resident above ``resident_cap``."""
        cid = int(client_id)
        structure, leaves = _flatten(sidecar)
        if self._structure is None:
            self._structure = structure
        elif structure != self._structure:
            raise ValueError("sidecar structure changed mid-run")
        self._resident[cid] = leaves
        self._resident.move_to_end(cid)
        self._on_disk.discard(cid)
        if self.resident_cap > 0:
            while len(self._resident) > self.resident_cap:
                old_cid, old_leaves = self._resident.popitem(last=False)
                if old_cid not in self._on_disk:
                    self._spill(old_cid, old_leaves)

    def _spill(self, cid: int, leaves: list) -> None:
        if self.spill_dir is None:
            raise ValueError(
                "fed.population.resident_cap is set but no spill_dir is "
                "available (set fed.population.spill_dir or a snapshot dir)"
            )
        self.spill_dir.mkdir(parents=True, exist_ok=True)
        tmp = self._spill_path(cid).with_suffix(".npz.tmp")
        with open(tmp, "wb") as f:  # a handle: np.savez would append .npz
            np.savez(f, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
        tmp.replace(self._spill_path(cid))
        self._on_disk.add(cid)
        self.spill_count += 1

    def get_sidecar(self, client_id: int) -> dict | None:
        """The client's stored sidecar, or None if it has none (a first
        selection: the caller loads the template)."""
        cid = int(client_id)
        if cid in self._resident:
            self._resident.move_to_end(cid)
            return _unflatten(self._structure, list(self._resident[cid]))
        if cid in self._on_disk:
            with np.load(self._spill_path(cid)) as z:
                leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
            return _unflatten(self._structure, leaves)
        return None

    def reset_sidecar(self, client_id: int) -> None:
        """Forget a client's sidecar (quarantine healing: its next selection
        restarts from the template)."""
        cid = int(client_id)
        self._resident.pop(cid, None)
        if cid in self._on_disk:
            self._on_disk.discard(cid)
            self._spill_path(cid).unlink(missing_ok=True)

    @property
    def resident_sidecars(self) -> int:
        return len(self._resident)

    def stored_ids(self) -> list[int]:
        """Every client with a stored sidecar, ascending."""
        return sorted(set(self._resident) | self._on_disk)

    def save_store(self, directory: str | Path) -> dict:
        """Persist the whole store into ``directory`` (a snapshot's): each
        resident sidecar not yet on disk is spilled (and stays resident),
        then every stored client's spill file is linked in. Returns the
        manifest :meth:`load_store` takes: the stored ids and the store's
        structure."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        for cid, leaves in self._resident.items():
            if cid not in self._on_disk:
                self._spill(cid, leaves)
        ids = self.stored_ids()
        for cid in ids:
            _link_or_copy(self._spill_path(cid), directory / self._spill_path(cid).name)
        return {"ids": np.asarray(ids, np.int64),
                "structure": [] if self._structure is None else list(self._structure)}

    def load_store(self, directory: str | Path, manifest: dict) -> None:
        """Replace the store by the one :meth:`save_store` wrote into
        ``directory``: its files are linked back into ``spill_dir``."""
        directory = Path(directory)
        self._resident.clear()
        self._on_disk.clear()
        ids = [int(c) for c in np.asarray(manifest["ids"]).reshape(-1)]
        self._structure = tuple((str(k), None if n is None else int(n))
                                for k, n in manifest["structure"]) or None
        if ids:
            if self.spill_dir is None:
                raise ValueError("restoring population sidecars needs a spill_dir")
            self.spill_dir.mkdir(parents=True, exist_ok=True)
        for cid in ids:
            _link_or_copy(directory / self._spill_path(cid).name, self._spill_path(cid))
            self._on_disk.add(cid)
