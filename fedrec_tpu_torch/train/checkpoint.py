"""Snapshots of the federated state with resume, the torch-native
counterpart of ``fedrec_tpu/train/checkpoint.py``.

A snapshot holds everything a bitwise resume needs, per client: both
towers' parameters, both optimizer states (Adam's ``count``, ``mu``,
``nu``), the step count and the states of the dropout and DP-noise
``torch.Generator``s, the codec's error-feedback residual when the run
keeps one; and the round index. The batchers are stateless in
``(seed, epoch)``, so they need none. Decoupled mode's news-gradient
accumulators are zero at every round end (each epoch's news update zeroes
them), so a snapshot leaves them out and a restore drops them; the next
step allocates them anew. (The reference's params-only snapshot resets Adam's moments on
resume; the JAX package's holds its PRNG keys for the same reason this one
holds the generators.)

Layout: one directory per round, ``round_<r>/state.pt``, written by
``torch.save`` to a temporary name and moved into place with
``os.replace``, so a torn write is never visible; the newest ``max_to_keep``
rounds are retained. A save may put files of its own beside ``state.pt``
first (``extras``): the trainer's FedOpt buffers (``SERVER_OPT_SIDECAR``),
the cohort engine's state (``POPULATION_SIDECAR``,
``population_state_bytes``) and its per-client sidecars
(``POPULATION_STORE``), each tagged with its round, so a snapshot that is
visible has them. Loading uses ``torch.load(..., weights_only=True)``:
tensors, numbers, lists and dicts only.

The coordinator deployment (``cli.coordinator``) writes flat files beside
its ``config.json`` instead, in the same format and atomically: each
process's whole local state (``local_state_p<i>.pt``: ``host_states`` of
its clients and the round) and the server's global model of each saved
round (``global_round_<r>.pt``: client 0's named user-tower and news-tower
parameters and the round, the newest three kept). ``coordinator_globals``
and ``global_round_of`` are the one definition of that file name, shared by
the writer, its retention and the serving store.
"""

from __future__ import annotations

import io
import shutil
import json
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from fedrec_tpu_torch.train.state import ClientState, OptState
from fedrec_tpu_torch.utils import atomic_write_bytes

_STATE_FILE = "state.pt"
_ROUND_PREFIX = "round_"
# the files a round's snapshot holds beside state.pt when the trainer runs
# FedOpt or the cohort engine
SERVER_OPT_SIDECAR = "server_opt_state.npz"
POPULATION_SIDECAR = "population_state.npz"
POPULATION_STORE = "popstore"


class SnapshotIntegrityError(RuntimeError):
    """A restored snapshot failed verification (non-finite parameters):
    the bytes parsed but the state is not trainable."""


def verify_state_tree(state: Any, samples_per_leaf: int = 256) -> None:
    """A strided sample of every float parameter of every client must be
    finite. Parameters only: an optimizer moment may legitimately be
    non-finite, a parameter never (every client adopts the finite mean at
    round end). Raises :class:`SnapshotIntegrityError` on the first bad
    leaf."""
    for c, client in enumerate(state["clients"]):
        for part in ("user_params", "news_params"):
            for name, leaf in client[part].items():
                if not torch.is_floating_point(leaf):
                    continue
                flat = leaf.reshape(-1)
                stride = max(1, flat.numel() // samples_per_leaf)
                if not bool(torch.isfinite(flat[::stride]).all()):
                    raise SnapshotIntegrityError(
                        f"non-finite values in restored clients[{c}].{part}.{name}"
                    )


def _pack(tree: dict) -> bytes:
    """A nested dict of numpy arrays and JSON values as ``.npz`` bytes: the
    arrays under their dotted paths, the rest in one JSON entry."""
    arrays: dict[str, np.ndarray] = {}
    plain: dict[str, Any] = {}

    def walk(node: dict, prefix: str) -> None:
        for key, value in node.items():
            path = f"{prefix}{key}"
            if isinstance(value, dict):
                walk(value, path + ".")
            elif isinstance(value, (np.ndarray, np.generic)):
                arrays[path] = np.asarray(value)
            else:
                plain[path] = value

    walk(tree, "")
    arrays["__json__"] = np.str_(json.dumps(plain))
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        flat: dict[str, Any] = {k: z[k] for k in z.files if k != "__json__"}
        flat.update(json.loads(str(z["__json__"])))
    out: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split(".")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def population_state_bytes(sampler_state: dict, ledger_state: dict, slot_occupants,
                           slot_writeback, round_idx: int, store: dict | None = None) -> bytes:
    """The cohort engine's state as bytes (the port's format, an ``.npz``):
    the sampler's fairness counters, the participation ledger with its
    quarantine expiries, the slot occupancy, the write-back mask, the round
    it describes and, when given, the sidecar store's manifest
    (``ClientPopulation.save_store``). Restoring it makes the resumed cohort
    schedule the uninterrupted run's."""
    return _pack({
        "sampler": dict(sampler_state),
        "ledger": dict(ledger_state),
        "slot_occupants": np.asarray(slot_occupants, np.int64),
        "slot_writeback": np.asarray(slot_writeback, bool),
        "round": np.int64(round_idx),
        **({"store": store} if store is not None else {}),
    })


def load_population_state(blob: bytes) -> dict:
    """Inverse of :func:`population_state_bytes`; ``round`` as an int."""
    state = _unpack(blob)
    state["round"] = int(state["round"])
    state["sampler"]["mode"] = str(state["sampler"]["mode"])
    return state


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _opt_dict(opt: OptState) -> dict:
    moments = lambda ts: None if ts is None else [_host(t) for t in ts]  # noqa: E731
    return {"count": opt.count, "mu": moments(opt.mu), "nu": moments(opt.nu)}


def _client_snapshot(st: ClientState) -> dict:
    """One client's state as host tensors, numbers, lists and dicts."""
    m = st.model
    return {
        "step": st.step,
        "user_params": {k: _host(v) for k, v in m.user_encoder.named_parameters()},
        "news_params": {k: _host(v) for k, v in m.news_tower.named_parameters()},
        "opt_user": _opt_dict(st.opt_user),
        "opt_news": _opt_dict(st.opt_news),
        "generator": st.generator.get_state(),
        "noise_generator": st.noise_generator.get_state(),
        "ef_residual": (None if st.ef_residual is None
                        else [_host(r) for r in st.ef_residual]),
    }


def _check_against(template: list[ClientState], snap: dict) -> None:
    """The snapshot must hold the template's clients, parameter names and
    shapes, and moment shapes; raises ``ValueError`` naming the first
    difference."""
    clients = snap["clients"]
    if len(clients) != len(template):
        raise ValueError(f"snapshot holds {len(clients)} clients, this run {len(template)}")
    for c, (st, cs) in enumerate(zip(template, clients)):
        for part, module in (("user_params", st.model.user_encoder),
                             ("news_params", st.model.news_tower)):
            want = {k: tuple(v.shape) for k, v in module.named_parameters()}
            got = {k: tuple(v.shape) for k, v in cs[part].items()}
            if got != want:
                raise ValueError(f"clients[{c}].{part}: snapshot {got} vs this run {want}")
        for part, params in (("opt_user", st.user_params()), ("opt_news", st.news_params())):
            for moment in ("mu", "nu"):
                ts = cs[part][moment]
                shapes = None if ts is None else [tuple(t.shape) for t in ts]
                want = None if getattr(getattr(st, part), moment) is None else [
                    tuple(p.shape) for p in params]
                if shapes != want:
                    raise ValueError(f"clients[{c}].{part}.{moment}: snapshot shapes {shapes} "
                                     f"vs this run {want}")


def _load_into(template: list[ClientState], snap: dict) -> list[ClientState]:
    with torch.no_grad():
        for st, cs in zip(template, snap["clients"]):
            for part, module in (("user_params", st.model.user_encoder),
                                 ("news_params", st.model.news_tower)):
                for name, p in module.named_parameters():
                    p.copy_(cs[part][name])
            dev = st.generator.device
            for part in ("opt_user", "opt_news"):
                o = cs[part]
                moments = lambda ts: None if ts is None else [t.to(dev) for t in ts]  # noqa: E731
                setattr(st, part, OptState(int(o["count"]), moments(o["mu"]), moments(o["nu"])))
            st.step = int(cs["step"])
            st.generator.set_state(cs["generator"])
            if "noise_generator" in cs:  # absent from snapshots that predate DP noise
                st.noise_generator.set_state(cs["noise_generator"])
            st.news_grad_accum = None
            saved = cs.get("ef_residual")
            if st.ef_residual is not None:
                # a snapshot without one (no biased codec then) restarts the
                # residual from zero, as a fresh client does
                st.ef_residual = ([torch.zeros_like(r) for r in st.ef_residual]
                                  if saved is None else [r.to(dev) for r in saved])
    return template


def host_states(states: list[ClientState], round_idx: int) -> dict:
    """Every client's state as host tensors, in a snapshot's layout (the
    flight recorder's round-entry copy)."""
    return {"round": int(round_idx), "clients": [_client_snapshot(st) for st in states]}


def load_host_states(template: list[ClientState], snap: dict) -> list[ClientState]:
    """``host_states``' dict (or a loaded snapshot) into ``template``'s
    clients in place, after the same structure check as ``restore``."""
    _check_against(template, snap)
    return _load_into(template, snap)


GLOBAL_PREFIX = "global_round_"
GLOBAL_SUFFIX = ".pt"


def global_round_of(path: Path) -> int | None:
    """The round of a ``global_round_<r>.pt`` file; None when the suffix is
    not an integer (an operator's ``global_round_19_backup.pt``)."""
    try:
        return int(Path(path).stem.rsplit("_", 1)[1])
    except (ValueError, IndexError):
        return None


def coordinator_globals(directory: str | Path) -> list[Path]:
    """The coordinator's global-model files in ``directory``, oldest to
    newest round."""
    out = []
    for p in Path(directory).glob(f"{GLOBAL_PREFIX}*{GLOBAL_SUFFIX}"):
        r = global_round_of(p)
        if r is not None:
            out.append((r, p))
    return [p for _, p in sorted(out)]


def global_state_bytes(states: list[ClientState], round_idx: int) -> bytes:
    """Client 0's named parameters (the global after the round's mean) and
    the round, as a ``global_round_<r>.pt`` file's bytes."""
    m = states[0].model
    snap = {"round": int(round_idx),
            "user_params": {k: _host(v) for k, v in m.user_encoder.named_parameters()},
            "news_params": {k: _host(v) for k, v in m.news_tower.named_parameters()}}
    buf = io.BytesIO()
    torch.save(snap, buf)
    return buf.getvalue()


def local_state_bytes(states: list[ClientState], round_idx: int) -> bytes:
    """A coordinator process's whole local state (every client's) as a
    ``local_state_p<i>.pt`` file's bytes."""
    buf = io.BytesIO()
    torch.save(host_states(states, round_idx), buf)
    return buf.getvalue()


def load_state_bytes(blob: bytes) -> dict:
    """A ``local_state_*.pt`` or ``global_round_*.pt`` file's contents (host
    tensors); raises on a torn or truncated file."""
    return torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)


class SnapshotManager:
    """``save`` / ``latest_round`` / ``restore`` over a directory of
    per-round snapshots, the interface of the JAX package's orbax manager.

    ``save`` copies the state to host memory at once (the values are those
    of the call) and writes in a background thread; readers
    (``latest_round``, ``restore``, ``restore_raw``) and ``close`` wait for
    writes in flight first, so no torn snapshot is ever observed.
    """

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: list[Future] = []
        # the round restore() landed on: older than latest_round() when the
        # newest snapshot failed to load or verify
        self.last_restored_round: int | None = None

    def _path(self, round_idx: int) -> Path:
        return self.directory / f"{_ROUND_PREFIX}{round_idx}" / _STATE_FILE

    def all_rounds(self) -> list[int]:
        out = []
        for p in self.directory.glob(f"{_ROUND_PREFIX}*/{_STATE_FILE}"):
            try:
                out.append(int(p.parent.name[len(_ROUND_PREFIX):]))
            except ValueError:
                continue
        return sorted(out)

    def wait(self) -> None:
        """Settle writes in flight; re-raises a write's error."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def latest_round(self) -> int | None:
        self.wait()
        rounds = self.all_rounds()
        return rounds[-1] if rounds else None

    def round_dir(self, round_idx: int) -> Path:
        """The directory of ``round_idx``'s snapshot (state.pt and extras)."""
        return self._path(round_idx).parent

    def _write(self, round_idx: int, snap: dict,
               extras: Callable[[Path], None] | None = None) -> None:
        buf = io.BytesIO()
        torch.save(snap, buf)
        path = self._path(round_idx)
        path.parent.mkdir(parents=True, exist_ok=True)
        if extras is not None:
            # before state.pt: a snapshot is visible only once its extras are
            extras(path.parent)
        atomic_write_bytes(path, buf.getvalue())
        for old in self.all_rounds()[: -self.max_to_keep]:
            shutil.rmtree(self._path(old).parent, ignore_errors=True)

    def save(self, round_idx: int, states: list[ClientState], wait: bool = False,
             extras: Callable[[Path], None] | None = None) -> None:
        """Persist every client's state for ``round_idx``; ``wait=True``
        returns only once the file is in place. ``extras(round_dir)``
        writes the caller's own files into the round's directory first, on
        the writer thread (a caller whose extras read live state passes
        ``wait=True``)."""
        snap = {"round": int(round_idx), "clients": [_client_snapshot(st) for st in states]}
        self._pending.append(self._pool.submit(self._write, int(round_idx), snap, extras))
        if wait:
            self.wait()

    def restore_raw(self, round_idx: int | None = None) -> dict:
        """The saved snapshot as host tensors, without a template."""
        r = self.latest_round() if round_idx is None else round_idx
        if r is None:
            raise FileNotFoundError(f"no snapshot under {self.directory}")
        return torch.load(self._path(r), map_location="cpu", weights_only=True)

    def restore(
        self,
        template: list[ClientState],
        round_idx: int | None = None,
        verify: bool = True,
    ) -> list[ClientState]:
        """Load a snapshot into ``template`` (the run's client states, in
        place) and return it. The snapshot must fit the template's
        structure and, with ``verify``, pass :func:`verify_state_tree`.
        Without an explicit ``round_idx``, a newest snapshot that fails to
        load or verify (a torn or truncated file, a bad disk) falls back to
        the previous retained one; ``last_restored_round`` records which
        round loaded, and a caller resumes from the round after it."""
        newest = self.latest_round() if round_idx is None else round_idx
        if newest is None:
            raise FileNotFoundError(f"no snapshot under {self.directory}")
        if round_idx is not None:
            candidates = [round_idx]
        else:
            candidates = sorted((r for r in self.all_rounds() if r <= newest), reverse=True)
        last_err: Exception | None = None
        for r in candidates:
            try:
                snap = torch.load(self._path(r), map_location="cpu", weights_only=True)
                _check_against(template, snap)
                if verify:
                    verify_state_tree(snap)
            except Exception as e:  # noqa: BLE001 — each retained snapshot gets its
                # chance; the last error is raised below
                last_err = e
                print(f"[checkpoint] snapshot at round {r} failed to restore/verify "
                      f"({type(e).__name__}: {e}); "
                      + ("trying the previous retained snapshot" if r != candidates[-1]
                         else "no older snapshot left"))
                continue
            self.last_restored_round = int(r)
            if r != candidates[0]:
                print(f"[checkpoint] fell back to the round-{r} snapshot (newest at round "
                      f"{candidates[0]} is corrupt: {type(last_err).__name__})")
            return _load_into(template, snap)
        raise RuntimeError(
            f"every retained snapshot under {self.directory} failed to restore "
            f"(rounds {candidates}); point train.snapshot_dir somewhere fresh"
        ) from last_err

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
