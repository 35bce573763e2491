"""The async deployment's commit authority (``agg.mode=async`` across
processes), the port of ``fedrec_tpu/agg/server.py``.

The synchronous deployments aggregate inside an all-process collective,
which is the barrier async mode removes: async workers form no world. Each
is a single-process ``Trainer`` (``agg.worker.run_async_worker``) that
speaks to this service over the one-shot JSON-lines exchange
(``obs.fleet.serve_json_line``, the membership service's wire)::

    hello  {worker, epoch}                 -> {version, quorum, have_global,
                                               incarnation}
    init   {worker, payload}               -> {version, incarnation}
    push   {worker, round, epoch, based_on,
            weight, payload[, codec]
            [, push_id]}                   -> {version, committed,
                                               incarnation[, duplicate]}
    global {since}                         -> {version[, payload], incarnation}
    status {}                              -> commit, gate, buffer and ledger
                                              accounting

A payload is a base64 npz of an ordered leaf list: the ``(user, news)``
Flax trees flattened as JAX flattens them (``params.flax_leaves``), so JAX
and torch workers can share one authority. A push lands in the
``AggBuffer``; once ``agg.quorum`` distinct workers are pending, the commit
folds everything buffered through ``agg.commit.fold_commit``, and a
straggler's later push folds, weighted by its staleness, into the next one.
A dense push whose leaf count or shapes differ from the global is refused
with an error reply (the JAX authority would fail at the commit instead).

A push may name a ``codec`` (the worker's ``fed.dcn_compress``): its payload
is then the per-leaf encoded payload dicts (``p{i}__{key}`` arrays).
Per-contribution codecs (int8, sign1bit, topk) are decoded when pushed
against the global's shapes (the worker keeps its own error-feedback
residual); the linear sketches (countsketch, randproj) stay sketches and
fold in sketch space at the commit (``--sketch-seed`` must be the workers'
``fed.dcn_sketch_seed``). ``agg.push_bytes_total`` counts the bytes each
worker's pushes carried.

Gate accounting: a commit charges its quorum-closing arrival ``t_K -
t_{K-1}``, the delay it added to the commit, and every other worker 0; a
straggler that never closes a quorum stays at about 0.

The state persists to ``--state-dir`` at every change: the pending buffer
(``agg_buffer.npz``) and ``agg_global.npz`` (the committed global, version,
incarnation and push ledger), both in the JAX package's layout. A restarted
authority resumes at the committed version as incarnation + 1, which every
reply carries: a worker that sees it change re-hellos and resyncs. Each
acked ``push_id`` gets one disposition in the ledger (``folded``,
``stale_dropped``, ``superseded``); a re-delivered id is a duplicate
(``agg.push_dups_total``) and never folds twice.

The fold is numpy on the host: the authority imports no torch, so it never
creates a CUDA context and restarts in an interpreter's time.

Wire observability (``obs.wire``): a request's envelope is stripped before
dispatch; an enveloped reply also carries the incarnation, and a ``global``
reply the commit's flow id (``commit_flow``). A push starts a flow arrow
inside its ``wire.serve`` span, the commit that folds it finishes that
arrow and starts its own, and the adopting worker finishes the commit's, so
the merged fleet trace (``fedrec-obs fleet-trace``) draws push -> commit ->
adoption across processes. ``--slo`` evaluates SLOs over the authority's
own registry (``agg.quorum_wait_ms``, ``agg.staleness`` ...) every 2 s.

Run it alone::

    python -m fedrec_tpu_torch.agg.server 127.0.0.1:9200 --quorum 3 --world 4 \\
        --state-dir aggstate --obs-dir obs/worker_aggserver \\
        --slo "quorum_wait:agg.quorum_wait_ms<2000"
"""

from __future__ import annotations

import base64
import io
import json
import socket
import threading
import time

import numpy as np

from fedrec_tpu_torch.agg.buffer import AGG_BUFFER_SIDECAR, AggBuffer, BufferEntry
from fedrec_tpu_torch.agg.commit import CommitPolicy, fold_commit
from fedrec_tpu_torch.comms import SKETCH_PAYLOAD_KEY, codec_caps, decode_leaf, validate_codec
from fedrec_tpu_torch.obs import wire as wireobs
from fedrec_tpu_torch.obs.tracing import get_tracer

__all__ = [
    "AGG_GLOBAL_SIDECAR",
    "AggServer",
    "decode_leaves",
    "decode_payloads",
    "encode_leaves",
    "encode_payloads",
    "main",
]

# the crash-recovery record beside the buffer sidecar
AGG_GLOBAL_SIDECAR = "agg_global.npz"
_GLOBAL_MAGIC = "fedrec-agg-global-v1"


def encode_leaves(leaves: list[np.ndarray]) -> str:
    """An ordered leaf list as a base64 npz (``leaf{i}`` arrays)."""
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf{i}": np.asarray(x) for i, x in enumerate(leaves)})
    return base64.b64encode(buf.getvalue()).decode()


def decode_leaves(payload: str) -> list[np.ndarray]:
    with np.load(io.BytesIO(base64.b64decode(payload))) as z:
        return [np.asarray(z[f"leaf{i}"]) for i in range(len(z.files))]


def encode_payloads(payloads: list[dict]) -> str:
    """The encoded twin of :func:`encode_leaves`: each leaf's codec payload
    dict flattened to ``p{i}__{key}`` arrays in one base64 npz."""
    buf = io.BytesIO()
    np.savez(buf, **{f"p{i}__{k}": np.asarray(v)
                     for i, p in enumerate(payloads) for k, v in p.items()})
    return base64.b64encode(buf.getvalue()).decode()


def decode_payloads(payload: str) -> list[dict]:
    """The inverse of :func:`encode_payloads`: the ordered per-leaf payload
    dicts."""
    out: dict[int, dict] = {}
    with np.load(io.BytesIO(base64.b64decode(payload))) as z:
        for name in z.files:
            head, key = name.split("__", 1)
            out.setdefault(int(head[1:]), {})[key] = np.asarray(z[name])
    return [out[i] for i in range(len(out))]


class AggServer:
    """The commit authority: the global leaves, the buffer and the quorum
    policy, behind a threaded TCP JSON-lines front (:meth:`start`) or called
    in process through :meth:`handle`."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        policy: CommitPolicy | None = None,
        method: str = "mean",
        trim_k: int = 1,
        clip_norm: float = 10.0,
        world: int = 0,
        obs_dir: str | None = None,
        state_dir: str | None = None,
        sketch_seed: int = 0,
    ):
        self.host = host
        self.port = port
        self.policy = policy or CommitPolicy()
        self.method = method
        self.trim_k = trim_k
        self.clip_norm = clip_norm
        self.world = int(world)
        # every worker's fed.dcn_sketch_seed: a summed sketch decodes only
        # under the hash geometry its addends were encoded with
        self.sketch_seed = int(sketch_seed)
        self.obs_dir = obs_dir
        self.state_dir = state_dir
        self.version = 0
        self.global_leaves: list[np.ndarray] | None = None
        # bumps at every start that restores state; every reply carries it
        self.incarnation = 1
        self.buffer = AggBuffer()
        # push_id -> its one terminal disposition; an id here is done
        self._push_ledger: dict[str, dict] = {}
        self._ledger_cap = 100_000
        self._dup_pushes = 0
        self.commit_log: list[dict] = []
        self._arrival: dict[str, float] = {}   # pending worker -> arrival ms
        self._gate_ms: dict[str, float] = {}   # worker -> its last commit's gate
        self._push_bytes: dict[str, float] = {}
        self._push_counts: dict[str, int] = {}
        self._push_flows: dict[str, int] = {}  # pending worker -> its push's flow id
        # the last commit's (version, flow id): a `global` reply at that
        # version carries the id in its envelope
        self._commit_flow: tuple[int, int] | None = None
        self._workers: set[str] = set()
        self._lock = threading.Lock()
        self._srv: socket.socket | None = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._instrument()
        self._restore()
        self._g_incarnation.set(float(self.incarnation))

    # --------------------------------------------------------------- obs
    def _instrument(self) -> None:
        from fedrec_tpu_torch.obs.registry import get_registry

        reg = get_registry()
        self._m_commits = reg.counter(
            "agg.commits_total", "async global commits the service performed (version bumps)")
        self._m_late = reg.counter(
            "agg.late_folds_total",
            "buffered contributions folded with staleness > 0 (the straggler path)")
        self._m_stale = reg.counter(
            "agg.stale_drops_total", "buffered contributions dropped past agg.staleness_cap")
        self._g_staleness = reg.gauge(
            "agg.staleness", "mean staleness (commits behind) of the last commit's folds")
        self._g_quorum_wait = reg.gauge(
            "agg.quorum_wait_ms",
            "first arrival -> quorum close wall time of the last commit")
        self._g_pending = reg.gauge(
            "agg.buffer_pending", "contributions sitting in the async buffer now")
        self._g_gate = reg.gauge(
            "agg.worker_gate_ms",
            "commit delay charged to this worker at its last commit (a straggler that "
            "never closes a quorum stays ~0)", labels=("worker",))
        self._g_fold = reg.gauge("agg.commit_fold_ms", "host fold time of the last commit")
        self._g_incarnation = reg.gauge(
            "agg.incarnation",
            "this authority's restart incarnation (workers re-hello on a bump)")
        self._m_dups = reg.counter(
            "agg.push_dups_total",
            "duplicate push deliveries dropped by push-id dedup (each acked push folds "
            "at most once)")
        self._m_push_bytes = reg.counter(
            "agg.push_bytes_total",
            "contribution bytes received per worker (base64 npz as shipped)",
            labels=("worker",))

    def dump_obs(self) -> None:
        """Write the service's artifacts under ``obs_dir`` (none without
        one); a full disk does not take the authority down."""
        if not self.obs_dir:
            return
        from pathlib import Path

        from fedrec_tpu_torch.obs import dump_artifacts, rotate_jsonl

        try:
            rotate_jsonl(Path(self.obs_dir) / "metrics.jsonl", 64.0)
            dump_artifacts(self.obs_dir)
        except OSError:
            pass

    # ------------------------------------------------------- persistence
    def _state_path(self, name: str):
        from pathlib import Path

        return Path(self.state_dir) / name if self.state_dir else None

    def _persist(self) -> None:
        """Caller holds the lock. The pending buffer, then the committed
        global with its version, incarnation and ledger."""
        path = self._state_path(AGG_BUFFER_SIDECAR)
        if path is None:
            return
        from fedrec_tpu_torch.utils import atomic_write_bytes

        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            atomic_write_bytes(path, self.buffer.state_bytes(0, self.version))
            if self.global_leaves is not None:
                meta = {"magic": _GLOBAL_MAGIC, "version": int(self.version),
                        "incarnation": int(self.incarnation),
                        "num_leaves": len(self.global_leaves), "ledger": self._push_ledger}
                buf = io.BytesIO()
                np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                         **{f"leaf{i}": np.asarray(x) for i, x in enumerate(self.global_leaves)})
                atomic_write_bytes(self._state_path(AGG_GLOBAL_SIDECAR), buf.getvalue())
        except OSError:
            pass

    def _restore(self) -> None:
        path = self._state_path(AGG_BUFFER_SIDECAR)
        if path is not None and path.exists():
            try:
                self.buffer, _, self.version = AggBuffer.load_state(path.read_bytes())
                print(f"[aggserver] restored {len(self.buffer)} pending contribution(s) at "
                      f"version {self.version}", flush=True)
            except (ValueError, OSError) as e:
                print(f"[aggserver] ignoring unreadable buffer sidecar: {e}", flush=True)
        gpath = self._state_path(AGG_GLOBAL_SIDECAR)
        if gpath is None or not gpath.exists():
            return
        try:
            with np.load(io.BytesIO(gpath.read_bytes())) as z:
                meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
                if meta.get("magic") != _GLOBAL_MAGIC:
                    raise ValueError(f"not an agg-global sidecar (magic={meta.get('magic')!r})")
                self.global_leaves = [np.asarray(z[f"leaf{i}"])
                                      for i in range(int(meta["num_leaves"]))]
            # written after every commit: its version is the committed one,
            # and the buffer sidecar can never be ahead of it
            self.version = max(self.version, int(meta["version"]))
            self.incarnation = int(meta.get("incarnation", 0)) + 1
            ledger = meta.get("ledger") or {}
            if isinstance(ledger, dict):
                self._push_ledger = {str(k): dict(v) for k, v in ledger.items()
                                     if isinstance(v, dict)}
            print(f"[aggserver] resumed committed global v{self.version} as incarnation "
                  f"{self.incarnation} ({len(self._push_ledger)} ledgered push(es))",
                  flush=True)
        except (ValueError, OSError, KeyError) as e:
            print(f"[aggserver] ignoring unreadable global sidecar: {e}", flush=True)

    # ----------------------------------------------------------- serving
    def start(self) -> "AggServer":
        srv = socket.create_server((self.host, self.port))
        srv.settimeout(0.5)
        self._srv = srv
        self.port = srv.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads = [t]
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2.0)
        with self._lock:
            self._persist()
        self.dump_obs()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        from fedrec_tpu_torch.obs.fleet import serve_json_line

        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=serve_json_line, args=(conn, self.handle),
                             kwargs={"timeout_s": 120.0, "recv_bytes": 1 << 22},
                             daemon=True).start()

    # ---------------------------------------------------------- handlers
    def handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd == "hello":
            return self._hello(str(req["worker"]), int(req.get("epoch", 0)))
        if cmd == "init":
            return self._init(str(req["worker"]), req["payload"])
        if cmd == "push":
            return self._push(req)
        if cmd == "global":
            return self._global(int(req.get("since", -1)))
        if cmd == "status":
            return self.status()
        return {"error": f"unknown cmd {cmd!r}"}

    def _ledger_set(self, push_id: str, disposition: str, **kv) -> None:
        """Caller holds the lock. Record a push id's terminal disposition,
        trimmed oldest-first at ``_ledger_cap``."""
        if not push_id:
            return
        self._push_ledger[push_id] = {"disposition": disposition, **kv}
        if len(self._push_ledger) > self._ledger_cap:
            for k in list(self._push_ledger)[: self._ledger_cap // 2]:
                del self._push_ledger[k]

    def _advertise(self) -> None:
        """The incarnation in the reply envelope too (additive: the reply
        carries it as a plain key either way)."""
        if wireobs.current_envelope() is not None:
            wireobs.serve_extra(incarnation=self.incarnation)

    def _hello(self, worker: str, epoch: int) -> dict:
        with self._lock:
            self._workers.add(worker)
            world = self.world or len(self._workers)
            if epoch > self.buffer.epoch:
                self.buffer.advance_epoch(epoch)
            self._advertise()
            return {"version": self.version, "quorum": self.policy.quorum_for(world),
                    "have_global": self.global_leaves is not None,
                    "incarnation": self.incarnation}

    def _init(self, worker: str, payload: str) -> dict:
        with self._lock:
            if self.global_leaves is None:
                self.global_leaves = decode_leaves(payload)
                print(f"[aggserver] v0 global seeded by {worker!r}", flush=True)
                # the v0 global must survive a crash before the first commit
                self._persist()
            self._advertise()
            return {"version": self.version, "incarnation": self.incarnation}

    def _push(self, req: dict) -> dict:
        worker = str(req["worker"])
        codec = str(req.get("codec", "none"))
        push_id = str(req.get("push_id", "") or "")
        with self._lock:
            if self.global_leaves is None:
                return {"error": "push before init: no v0 global"}
            based_on = int(req["based_on"])
            if based_on > self.version:
                # a restore a commit behind the worker's adopted version:
                # folding this entry would fail at quorum time and poison
                # every pending worker's commit
                return {"error": (
                    f"rebase: push based_on v{based_on} is ahead of the restored global "
                    f"v{self.version} (authority restarted); re-hello and adopt the current "
                    "global")}
            if push_id and push_id in self._push_ledger:
                # an already-disposed push delivered again: ack, never refold
                self._dup_pushes += 1
                self._m_dups.inc()
                self._advertise()
                return {"version": self.version, "committed": False, "duplicate": True,
                        "incarnation": self.incarnation}
            nbytes = float(len(req["payload"]))
            self._m_push_bytes.inc(nbytes, worker=worker)
            self._push_bytes[worker] = self._push_bytes.get(worker, 0.0) + nbytes
            self._push_counts[worker] = self._push_counts.get(worker, 0) + 1
            try:
                if codec == "none":
                    leaves, entry_codec = self._check_dense(decode_leaves(req["payload"])), "none"
                else:
                    leaves, entry_codec = self._decode_push(codec, req["payload"])
            except ValueError as e:
                return {"error": f"bad push{'' if codec == 'none' else ' codec'}: {e}"}
            entry = BufferEntry(
                worker=worker, round=int(req["round"]),
                epoch=int(req.get("epoch", self.buffer.epoch)), based_on=based_on,
                weight=float(req.get("weight", 1.0)), arrival_ms=time.monotonic() * 1e3,
                leaves=leaves, codec=entry_codec, push_id=push_id)
            replaced = self.buffer.add(entry)
            if replaced is not None and replaced.push_id:
                if replaced.push_id == push_id:
                    # the same contribution twice while pending: one entry
                    self._dup_pushes += 1
                    self._m_dups.inc()
                else:
                    self._ledger_set(replaced.push_id, "superseded", by=push_id)
            self._workers.add(worker)
            self._arrival[worker] = entry.arrival_ms
            # a buffer -> commit arrow starts inside this push's serve span;
            # the commit that folds the contribution finishes it
            if wireobs.current_envelope() is not None:
                fid = wireobs.new_span_id()
                get_tracer().flow("out", fid, worker=worker)
                self._push_flows[worker] = fid
            committed = self._maybe_commit()
            self._g_pending.set(float(len(self.buffer)))
            self._persist()
            self._advertise()
            return {"version": self.version, "committed": committed,
                    "incarnation": self.incarnation}

    def _check_dense(self, leaves: list[np.ndarray]) -> list[np.ndarray]:
        """Caller holds the lock. A dense push must fit the global leaf for
        leaf: a misfit would fail inside the commit and lose every pending
        contribution with it."""
        if len(leaves) != len(self.global_leaves):
            raise ValueError(f"push has {len(leaves)} leaves, global has "
                             f"{len(self.global_leaves)}")
        for j, (x, g) in enumerate(zip(leaves, self.global_leaves)):
            if x.shape != np.asarray(g).shape:
                raise ValueError(f"leaf {j} has shape {x.shape}, the global's is "
                                 f"{np.asarray(g).shape}")
        return leaves

    def _decode_push(self, codec: str, payload: str) -> tuple[list, str]:
        """Caller holds the lock. Per-contribution codecs densify now (the
        worker's residual already carries what the encode drops); linear
        sketches buffer raw and fold in sketch space at the commit."""
        validate_codec(codec)
        payloads = decode_payloads(payload)
        if len(payloads) != len(self.global_leaves):
            raise ValueError(f"push has {len(payloads)} encoded leaves, global has "
                             f"{len(self.global_leaves)}")
        if codec_caps(codec).decodes_per_contribution:
            leaves = [decode_leaf(p, codec, tuple(np.asarray(g).shape),
                                  sketch_seed=self.sketch_seed, leaf_id=j)
                      for j, (p, g) in enumerate(zip(payloads, self.global_leaves))]
            return leaves, "none"
        if self.method != "mean":
            # refused at the wire: a sketch entry under a robust fold would
            # fail at quorum time and poison every pending worker's commit
            raise ValueError(f"sketch codec {codec!r} cannot fold under robust method "
                             f"{self.method!r}; push int8/sign1bit/topk/none instead")
        key = SKETCH_PAYLOAD_KEY[codec]
        return [np.asarray(p[key]) for p in payloads], codec

    def _maybe_commit(self) -> bool:
        """Caller holds the lock. Fires once quorum-many distinct workers
        are pending, and folds everything buffered (on time and late)."""
        world = self.world or max(len(self._workers), 1)
        k = self.policy.quorum_for(world)
        pending = self.buffer.pending_workers()
        if len(pending) < k:
            return False
        entries = self.buffer.take_all()
        # every folded or dropped push id is ledgered before the bump, with
        # fold_commit's staleness filter: one disposition per acked push
        for e in entries:
            s = self.version - e.based_on
            self._ledger_set(e.push_id,
                             "stale_dropped" if s > self.policy.staleness_cap else "folded",
                             version=self.version + 1, staleness=max(s, 0))
        tracer = get_tracer()
        commit_flow = wireobs.new_span_id()
        fold_t0 = time.perf_counter()
        with tracer.span("agg.commit", quorum=len(pending)):
            # the folded pushes' arrows end inside the commit span; the
            # commit's own starts there (the adopting workers end it)
            for w in {e.worker for e in entries}:
                fid = self._push_flows.pop(w, None)
                if fid is not None:
                    tracer.flow("in", fid)
            self.global_leaves, stats = fold_commit(
                self.global_leaves, entries, self.version, self.policy, method=self.method,
                trim_k=self.trim_k, clip_norm=self.clip_norm, sketch_seed=self.sketch_seed)
            tracer.flow("out", commit_flow, version=stats.version)
        fold_ms = (time.perf_counter() - fold_t0) * 1e3
        self._g_fold.set(fold_ms)
        self._commit_flow = (stats.version, commit_flow)
        self.version = stats.version
        # the quorum-closing arrival is charged its delay over the runner-up
        arrivals = sorted(self._arrival[w] for w in pending if w in self._arrival)
        closer = max((w for w in pending if w in self._arrival), key=lambda w: self._arrival[w])
        gate = arrivals[-1] - arrivals[-2] if len(arrivals) > 1 else 0.0
        wait = arrivals[-1] - arrivals[0] if len(arrivals) > 1 else 0.0
        for w in pending:
            g = gate if w == closer else 0.0
            self._gate_ms[w] = g
            self._g_gate.set(g, worker=w)
        self._arrival.clear()
        self._m_commits.inc()
        self._m_late.inc(float(stats.late_folds))
        self._m_stale.inc(float(stats.stale_drops))
        self._g_staleness.set(stats.mean_staleness)
        self._g_quorum_wait.set(wait)
        self.commit_log.append({
            "version": stats.version, "folded": stats.folded, "late_folds": stats.late_folds,
            "stale_drops": stats.stale_drops, "mean_staleness": stats.mean_staleness,
            "max_staleness": stats.max_staleness, "quorum": len(pending),
            "quorum_wait_ms": wait, "closer": closer, "gate_ms": gate, "fold_ms": fold_ms,
        })
        self.dump_obs()
        return True

    def _global(self, since: int) -> dict:
        with self._lock:
            self._advertise()
            if self.global_leaves is None:
                return {"version": -1, "incarnation": self.incarnation}
            out: dict = {"version": self.version, "incarnation": self.incarnation}
            if self.version > since:
                out["payload"] = encode_leaves(self.global_leaves)
                if self._commit_flow is not None and self._commit_flow[0] == self.version:
                    # in the reply envelope (the worker's
                    # wire.last_reply_envelope): the reply dict is unchanged
                    wireobs.serve_extra(commit_flow=self._commit_flow[1])
            return out

    def status(self) -> dict:
        with self._lock:
            return {
                "version": self.version,
                "incarnation": self.incarnation,
                "pending": len(self.buffer),
                "pending_workers": sorted(self.buffer.pending_workers()),
                "pending_push_ids": sorted(e.push_id for e in self.buffer.entries if e.push_id),
                "workers": sorted(self._workers),
                "epoch": self.buffer.epoch,
                "commits": list(self.commit_log),
                "gate_ms": dict(self._gate_ms),
                "push_bytes": dict(self._push_bytes),
                "push_counts": dict(self._push_counts),
                "push_dups": self._dup_pushes,
                "ledger": {k: dict(v) for k, v in self._push_ledger.items()},
            }


def main(argv: list[str] | None = None) -> int:
    """The standalone commit authority."""
    import argparse
    import signal
    import sys

    parser = argparse.ArgumentParser(description="fedrec buffered-aggregation (async commit) "
                                                 "service")
    parser.add_argument("address", metavar="HOST:PORT")
    parser.add_argument("--quorum", type=int, default=0,
                        help="commit once this many distinct workers are pending (agg.quorum; "
                             "0 = all-reporting)")
    parser.add_argument("--staleness-cap", type=int, default=2,
                        help="drop buffered updates older than this many commits "
                             "(agg.staleness_cap)")
    parser.add_argument("--world", type=int, default=0,
                        help="expected worker count (0 = learn from hellos)")
    parser.add_argument("--method", default="mean",
                        help="fed.robust.method applied to the delta fold")
    parser.add_argument("--obs-dir", default=None,
                        help="write the service's metrics.jsonl, trace.json and prometheus.txt "
                             "here (at every commit and at exit); name it worker_aggserver "
                             "under the fleet's obs root so fedrec-obs fleet merges it")
    parser.add_argument("--state-dir", default=None,
                        help="persist the pending buffer and the committed global here "
                             "(agg_buffer.npz, agg_global.npz); a restart resumes from them")
    parser.add_argument("--sketch-seed", type=int, default=0,
                        help="the workers' fed.dcn_sketch_seed, to decode sketch-coded pushes")
    parser.add_argument("--slo", default="",
                        help="obs.slo.objectives evaluated every 2 s over this service's own "
                             "registry (agg.quorum_wait_ms, agg.staleness, agg.buffer_pending, "
                             "...); alert records land in --obs-dir's metrics.jsonl")
    args = parser.parse_args(argv)
    host, port = args.address.rsplit(":", 1)
    if args.obs_dir:
        from fedrec_tpu_torch.obs.fleet import set_fleet_identity

        set_fleet_identity(worker="aggserver")
    watch = None
    if args.slo:
        from pathlib import Path

        from fedrec_tpu_torch.config import SloConfig, WatchConfig
        from fedrec_tpu_torch.obs.watch import Watch

        if args.obs_dir:
            Path(args.obs_dir).mkdir(parents=True, exist_ok=True)
        watch = Watch(SloConfig(enabled=True, objectives=args.slo), WatchConfig(),
                      jsonl_path=Path(args.obs_dir) / "metrics.jsonl" if args.obs_dir else None)
    server = AggServer(
        host=host, port=int(port),
        policy=CommitPolicy(quorum=args.quorum, staleness_cap=args.staleness_cap),
        method=args.method, world=args.world, obs_dir=args.obs_dir,
        state_dir=args.state_dir, sketch_seed=args.sketch_seed).start()
    print(f"[aggserver] serving on {server.address} (incarnation {server.incarnation}, "
          f"version {server.version})", flush=True)

    def _term(signum, frame):  # noqa: ARG001 — a signal handler's signature
        raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        pass  # not the main thread: no SIGTERM handler
    try:
        last = None
        while True:
            time.sleep(2)
            if watch is not None:
                watch.evaluate()  # commit-cadence SLOs over the agg.* gauges
            if args.obs_dir:
                status = server.status()
                if status != last:
                    server.dump_obs()
                    last = status
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        server.stop()
        torch = sys.modules.get("torch")
        print(f"[aggserver] stopped at version {server.version}; cuda initialised: "
              f"{bool(torch is not None and torch.cuda.is_initialized())}", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
