"""The async worker loop, one process's side of the buffered-commit wire:
the port of ``fedrec_tpu/agg/worker.py``.

An async worker is a single-process ``Trainer`` (no world: async mode
removes the all-process barrier) that, each round:

1. trains its local round (``Trainer.train_round_recovering``);
2. computes its contribution delta against the global version it trained
   from, on the device: parameters and optimizer state stay on the card,
   and only the delta crosses to the host;
3. encodes it: dense leaves, or under ``fed.dcn_compress`` the per-leaf
   payloads. Linear sketches go up raw (the authority folds them in sketch
   space); per-contribution codecs go up with this worker's error-feedback
   residual folded in (``comms.CodecState``, banked against the version the
   push is based on: what the encode drops rides the next round's delta);
4. sleeps ``chaos.straggle_ms`` when chaos is on (the straggler's knob acts
   here, at the push boundary, outside the round's time), then pushes to
   the commit authority (``agg.server``) with a ``push_id`` that stays the
   same on every retry;
5. polls for a newer committed global within ``agg.worker_global_wait_s``
   and adopts it. A timeout is the async contract, not an error: the worker
   trains on from its own parameters and its next push is staler.

The pushed leaves are the ``(user, news)`` Flax trees in JAX's leaf order
and layout (``params.flax_leaves``), so JAX and torch workers can share an
authority. Every worker seeds alike, so the first worker's ``init`` is the
version-0 global and the others adopt it.

Failures ride ``parallel.rpc.FleetRpc``: transport failures retry inside
the ``agg.worker_*`` budgets. A push that cannot be delivered parks on an
unacked list (its ``push_id`` reused on the retry) and training goes on,
until the wire has been silent for ``agg.worker_unreachable_budget_s``; then
the worker raises ``AuthorityUnreachable`` (the run CLI exits 75). A reply
with a new incarnation (the authority restarted) means re-hello, flush the
unacked list, adopt the restored global (``agg.resyncs_total``); a
``rebase`` error reply (the push's base is ahead of the restored global)
drops the push and adopts.
"""

from __future__ import annotations

import time
import zlib

import numpy as np

__all__ = ["run_async_worker"]


def _device_leaves(trainer) -> list:
    """Client 0's contribution leaves (the global after a flat round), on
    the device, in Flax layout and JAX's leaf order."""
    from fedrec_tpu_torch.train.step import contribution_leaves

    return contribution_leaves(trainer.states[0])


def _to_host(leaves: list) -> list[np.ndarray]:
    """Device leaves to host arrays in one device-to-host copy."""
    import torch

    with torch.no_grad():
        flat = torch.cat([x.reshape(-1) for x in leaves]).cpu().numpy()
    sizes = np.cumsum([x.numel() for x in leaves])[:-1]
    return [v.reshape(tuple(x.shape)) for v, x in zip(np.split(flat, sizes), leaves)]


def _adopt(trainer, leaves: list[np.ndarray]) -> list:
    """Every client adopts the global's host leaves; returns them on the
    device, the base of the next delta."""
    trainer._adopt_contribution(leaves)
    return _device_leaves(trainer)


def run_async_worker(trainer, server: str, worker_id: str, timeout_s: float | None = None,
                     poll_s: float | None = None, global_wait_s: float | None = None,
                     report: dict | None = None) -> list:
    """Drive ``trainer`` for its configured rounds against the commit
    authority at ``server`` ("HOST:PORT"); returns the round history, as
    ``Trainer.run`` does. The keyword knobs default to the ``agg.worker_*``
    fields. ``report``, when given, is filled with the worker's accounting:
    the acked push ids and their wall times, round, push and poll-and-adopt
    times, the resyncs' wall times, the uplink's bytes. Raises
    ``AuthorityUnreachable`` when the authority stays dark past
    ``agg.worker_unreachable_budget_s``."""
    import torch

    from fedrec_tpu_torch.agg.server import decode_leaves, encode_leaves, encode_payloads
    from fedrec_tpu_torch.comms import (
        CodecState,
        codec_caps,
        decode_leaf,
        encode_leaf,
        payload_nbytes,
        validate_codec,
    )
    from fedrec_tpu_torch.obs import wire
    from fedrec_tpu_torch.parallel.rpc import (
        AuthorityUnreachable,
        FleetRpc,
        RpcPolicy,
        new_push_id,
    )

    cfg = trainer.cfg
    host, port_s = server.rsplit(":", 1)
    timeout_s = float(cfg.agg.worker_timeout_s if timeout_s is None else timeout_s)
    poll_s = float(cfg.agg.worker_poll_s if poll_s is None else poll_s)
    global_wait_s = float(cfg.agg.worker_global_wait_s if global_wait_s is None
                          else global_wait_s)
    unreachable_budget_s = float(cfg.agg.worker_unreachable_budget_s)
    codec = cfg.fed.dcn_compress
    if codec != "none":
        validate_codec(codec)   # a bad name fails before any training
    use_ef = (codec != "none" and codec_caps(codec).supports_error_feedback
              and cfg.fed.dcn_error_feedback)
    ef = CodecState()           # this edge's encode residual

    rpc = FleetRpc(host, int(port_s), RpcPolicy(
        connect_timeout_s=cfg.agg.worker_connect_timeout_s,
        read_timeout_s=timeout_s,
        attempts=cfg.agg.worker_rpc_attempts,
        backoff_base_ms=cfg.agg.worker_backoff_ms,
        backoff_max_ms=cfg.agg.worker_backoff_cap_ms,
        # the bounded poll loop is the retry of `global`
        op_attempts={"global": 1},
        # an open breaker fails the round loop fast; its reset window paces
        # how soon a dead authority is probed again: at most a round's wait
        breaker_reset_s=min(10.0, global_wait_s),
        # a jitter stream per worker, without per-worker config
        seed=zlib.crc32(worker_id.encode()),
    ))

    reg = trainer.registry
    g_version = reg.gauge("agg.global_version",
                          "committed global version this worker last adopted")
    g_staleness = reg.gauge("agg.staleness",
                            "commits the global had advanced past this worker's base when it "
                            "pushed (worker-side view)")
    c_pushes = reg.counter("agg.pushes_total", "contribution deltas this worker pushed")
    c_uplink = reg.counter("agg.uplink_bytes_total",
                           "encoded contribution bytes this worker pushed (payload buffers, "
                           "before base64)")
    c_resyncs = reg.counter("agg.resyncs_total",
                            "re-hello/re-adopt cycles after an authority incarnation bump or "
                            "a rebase reply (0 when the authority never restarted)")
    rep = report if report is not None else {}
    rep.update({"acked": [], "acked_at": [], "round_ms": [], "push_ms": [],
                "poll_adopt_ms": [], "first_round_at": None, "resyncs": 0, "resync_at": [],
                "uplink_bytes": [], "dropped": 0})

    epoch = 0
    incarnation: int | None = None
    # pushes the wire failed to deliver, each keeping its push_id
    unacked: list[dict] = []
    version = 0
    base: list = []

    def note_incarnation(resp: dict) -> bool:
        """Adopt the advertised incarnation; True when it changed."""
        nonlocal incarnation
        adv = resp.get("incarnation")
        if adv is None:
            return False
        adv = int(adv)
        bumped = incarnation is not None and adv != incarnation
        incarnation = adv
        return bumped

    def acked(req: dict) -> None:
        rep["acked"].append(req["push_id"])
        rep["acked_at"].append(time.time())

    def check_budget(cause: Exception | None = None) -> None:
        silent = rpc.unreachable_for()
        if silent > unreachable_budget_s:
            raise AuthorityUnreachable(
                f"commit authority {rpc.peer} unreachable for {silent:.0f}s (budget "
                f"agg.worker_unreachable_budget_s={unreachable_budget_s:g}s, {len(unacked)} "
                "unacked pushes parked); exiting 75 for the supervisor") from cause

    def flush_unacked() -> bool:
        """Re-deliver the parked pushes oldest first, stopping at the first
        transport failure; True when a reply carried a new incarnation."""
        bumped = False
        while unacked:
            req = unacked[0]
            try:
                resp = rpc.call(req, op="push")
            except OSError as e:
                check_budget(e)
                return bumped
            except ValueError:
                # refused (the restored global is behind its base): unfoldable
                print(f"[agg-worker {worker_id}] dropping unacked push {req['push_id']} "
                      "(authority refused it after restart)", flush=True)
                unacked.pop(0)
                rep["dropped"] += 1
                continue
            unacked.pop(0)
            acked(req)
            bumped = note_incarnation(resp) or bumped
            if resp.get("duplicate"):
                print(f"[agg-worker {worker_id}] push {req['push_id']} was already folded "
                      "(idempotent retry)", flush=True)
        return bumped

    def resync(reason: str) -> bool:
        """Re-hello, flush the unacked list, adopt the authority's current
        global; True when a global was adopted. On a dead wire the degrade
        budget is the backstop."""
        nonlocal version, base
        c_resyncs.inc()
        rep["resyncs"] += 1
        rep["resync_at"].append(time.time())
        print(f"[agg-worker {worker_id}] resyncing with {rpc.peer} ({reason})", flush=True)
        try:
            note_incarnation(rpc.call({"cmd": "hello", "worker": worker_id, "epoch": epoch},
                                      op="hello"))
            flush_unacked()
            resp = rpc.call({"cmd": "global", "since": -1}, op="global")
        except OSError as e:
            check_budget(e)
            return False
        note_incarnation(resp)
        if "payload" in resp:
            version = int(resp["version"])
            base = _adopt(trainer, decode_leaves(resp["payload"]))
            g_version.set(float(version))
            return True
        return False

    # ---- bootstrap: without a hello and a version-0 global there is
    # nothing to train against, so a failure here exits 75 at once
    try:
        hello = rpc.call({"cmd": "hello", "worker": worker_id, "epoch": epoch}, op="hello")
        note_incarnation(hello)
        version = int(hello["version"])
        base = _device_leaves(trainer)
        if not hello.get("have_global"):
            rpc.call({"cmd": "init", "worker": worker_id,
                      "payload": encode_leaves(_to_host(base))}, op="init")
        resp = rpc.call({"cmd": "global", "since": -1}, op="global")
    except OSError as e:
        raise AuthorityUnreachable(f"commit authority {rpc.peer} unreachable during bootstrap "
                                   f"({e}); exiting 75 for the supervisor") from e
    note_incarnation(resp)
    if "payload" in resp:
        version = int(resp["version"])
        base = _adopt(trainer, decode_leaves(resp["payload"]))

    straggle_s = (cfg.chaos.straggle_ms / 1e3
                  if cfg.chaos.enabled and cfg.chaos.straggle_ms > 0 else 0.0)
    history = []
    for round_idx in range(trainer.start_round, cfg.fed.rounds):
        if rep["first_round_at"] is None:
            rep["first_round_at"] = time.time()
        t0 = time.perf_counter()
        result = trainer.train_round_recovering(round_idx)
        rep["round_ms"].append((time.perf_counter() - t0) * 1e3)
        history.append(result)
        # the run loop's other half: the log line, the snapshots
        trainer._after_round(result)

        adopted_this_round = False
        after = _device_leaves(trainer)
        with torch.no_grad():
            delta = _to_host([a - b for a, b in zip(after, base)])
        if codec == "none":
            wire_payload = encode_leaves(delta)
            nbytes = float(sum(d.nbytes for d in delta))
        else:
            # last round's dropped mass rides this round's delta; this
            # encode's dropped mass is banked for the next
            acc = ([d + r for d, r in zip(delta, ef.residual)]
                   if use_ef and ef.residual is not None else delta)
            payloads = [encode_leaf(a, codec, cfg.fed.dcn_topk_ratio,
                                    sketch_width=cfg.fed.dcn_sketch_width,
                                    sketch_seed=cfg.fed.dcn_sketch_seed, leaf_id=j)
                        for j, a in enumerate(acc)]
            if use_ef:
                ef.residual = [a - decode_leaf(p, codec, a.shape, leaf_id=j)
                               for j, (a, p) in enumerate(zip(acc, payloads))]
            wire_payload = encode_payloads(payloads)
            nbytes = float(sum(payload_nbytes(p) for p in payloads))
        c_uplink.inc(nbytes)
        rep["uplink_bytes"].append(nbytes)
        # based_on is the version this delta was computed against, taken
        # now: the flush below can resync and move `version`
        push_req = {"cmd": "push", "worker": worker_id, "round": round_idx, "epoch": epoch,
                    "based_on": version, "weight": 1.0, "payload": wire_payload,
                    "codec": codec, "push_id": new_push_id(worker_id, round_idx)}
        if straggle_s > 0:
            print(f"[agg-worker {worker_id}] straggling {straggle_s:.1f}s before the "
                  f"round-{round_idx} push", flush=True)
            time.sleep(straggle_s)

        # the backlog first, oldest first, so this round's push lands last;
        # a bump seen there means the authority restarted meanwhile
        if unacked and flush_unacked():
            adopted_this_round = resync("incarnation bump") or adopted_this_round
        t0 = time.perf_counter()
        with trainer.tracer.span("agg.push", round=round_idx, based_on=version):
            try:
                resp = rpc.call(push_req, op="push")
            except OSError as e:
                # park it (same push_id on the retry) and train on
                unacked.append(push_req)
                print(f"[agg-worker {worker_id}] authority unreachable for round-{round_idx} "
                      f"push ({e.__class__.__name__}); parked ({len(unacked)} unacked), "
                      "training on", flush=True)
                check_budget(e)
                resp = None
            except ValueError as e:
                if "rebase" not in str(e) and "ahead of" not in str(e):
                    raise
                # the authority restarted behind us: this delta's base is
                # gone, so drop it and adopt the restored global
                print(f"[agg-worker {worker_id}] round-{round_idx} push refused ({e}); "
                      "dropping it and resyncing", flush=True)
                rep["dropped"] += 1
                adopted_this_round = resync("rebase reply")
                resp = None
        rep["push_ms"].append((time.perf_counter() - t0) * 1e3)
        if resp is not None:
            acked(push_req)
            c_pushes.inc()
            g_staleness.set(float(max(0, int(resp["version"]) - version)))
            if note_incarnation(resp):
                # the restarted authority took this push; adopt its global
                adopted_this_round = resync("incarnation bump") or adopted_this_round

        # the bounded wait for a commit newer than our base
        t0 = time.perf_counter()
        deadline = time.monotonic() + global_wait_s
        new_version, payload, commit_flow = version, None, None
        while time.monotonic() < deadline:
            try:
                resp = rpc.call({"cmd": "global", "since": version}, op="global")
            except OSError as e:
                # a dead wire: proceed stale now; the next round's flush and
                # push probe for recovery
                check_budget(e)
                break
            if note_incarnation(resp):
                adopted_this_round = resync("incarnation bump") or adopted_this_round
                break
            if "payload" in resp:
                new_version, payload = int(resp["version"]), resp["payload"]
                # the commit's flow id rides the reply envelope: its arrow
                # ends inside this worker's adoption span
                reply_env = wire.last_reply_envelope()
                if reply_env is not None:
                    commit_flow = reply_env.get("commit_flow")
                break
            time.sleep(poll_s)
        if payload is not None:
            with trainer.tracer.span("agg.adopt", version=new_version, round=round_idx):
                if commit_flow is not None:
                    trainer.tracer.flow("in", int(commit_flow))
                version = new_version
                base = _adopt(trainer, decode_leaves(payload))
            g_version.set(float(version))
        elif not adopted_this_round:
            base = after
            print(f"[agg-worker {worker_id}] no commit within {global_wait_s:.0f}s after "
                  f"round {round_idx}; proceeding stale", flush=True)
        rep["poll_adopt_ms"].append((time.perf_counter() - t0) * 1e3)

    # one last delivery attempt: after this the contributions leave with
    # the process
    if unacked:
        flush_unacked()
        if unacked:
            print(f"[agg-worker {worker_id}] exiting with {len(unacked)} undelivered pushes "
                  "(authority still unreachable)", flush=True)
    rep["undelivered"] = len(unacked)

    # the run loop's exit: settle the snapshots, write the artifacts
    if trainer.snapshots is not None:
        trainer.snapshots.wait()
    if trainer._obs_dir is not None:
        from fedrec_tpu_torch.obs import dump_artifacts

        for attempt in (0, 1):
            try:
                dump_artifacts(trainer._obs_dir, registry=trainer.registry,
                               tracer=trainer.tracer)
                break
            except OSError as e:
                if attempt == 0:
                    time.sleep(0.5)
                    continue
                print(f"[agg-worker {worker_id}] could not write obs artifacts: {e}",
                      flush=True)
    if trainer.fleet_pusher is not None:
        trainer.fleet_pusher.push(final=True)
    trainer.logger.finish()
    return history
