"""The coordinator deployment, the port of ``python -m
fedrec_tpu.cli.coordinator`` (the reference's ``client.py`` / ``server.py``
pair): one script for both roles, a fixed world on ``torch.distributed``
(gloo). Each process runs:

  python -m fedrec_tpu_torch.cli.coordinator ROUNDS BATCH SAVE_EVERY \\
      --coordinator HOST:PORT --num-processes N --process-id I \\
      [--server-trains] [--collective-timeout S] [--device cpu] [--set ...]

Process 0 is the server. A round: every process adopts the server's round
index (``-1`` stops) and its parameters; each client trains its disjoint
shard (``apply_process_sharding``) through ``Trainer.train_round_recovering``
(its own K device slots, its own round-end mean); the contributions
(client 0's Flax-layout ``(user, news)`` trees) are gathered, weighted by
participation (0 for a server that does not train) and, under
``fed.weight_by_samples``, by shard size, encoded by ``fed.dcn_compress``
and reduced by ``fed.robust`` and ``agg.mode``
(``parallel.multihost.aggregate_from_hosts``); under ``fed.server_opt`` only
the server steps FedOpt, and the clients receive its result at the next
fan-out. Every ``SAVE_EVERY`` rounds each process writes its whole local
state (``local_state_p<i>.pt``) and, under a biased codec, its
error-feedback residual (``codec_state_p<i>.npz``); the server writes its
global (``global_round_<r>.pt``, the last three kept), the FedOpt buffers
and, once, ``config.json``, all atomically under ``train.snapshot_dir``.
A restart resumes from them (``train.resume``); a torn local state starts
that shard fresh, to be re-integrated by the server's next fan-out.

Every collective runs under ``--collective-timeout`` (0 = wait forever). A
process whose collective fails or times out says so and degrades: a client
leaves the world at once, device-free, and re-executes itself as a
standalone continuation of its shard from its last saved local state
(``--resume-local-state``); the server finishes its rounds alone and exits
through ``os._exit``. The host faults ``chaos.kill_process`` /
``chaos.kill_round`` (that process exits 137 at the round's entry, once: a
marker file guards the rerun) and ``chaos.torn_snapshot_round`` (every
process truncates its local state of that round) exercise it.

At exit each process prints one line ``[coordinator] report {...}``: its
rounds, the round, fan-out and gather wall times (the gather split into its
encode, the collective and the decode + reduce), the bytes it shipped
(``fed.dcn_bytes_*_total``, ``path="dcn"``), its peak device memory and
its kernel launches, whether it degraded.

Supervision and elastic membership. ``--supervise`` wraps the worker in a
respawn loop (:func:`_supervise`): a worker that dies (a signal, the chaos
kill's 137) or leaves a broken world (:data:`RESPAWN_EXIT`, 75) relaunches
after a jittered backoff and resumes from its local state; every degraded
process, the server too, exits 75 under supervision instead of going
standalone. With it alone the fixed world relaunches whole. ``--supervise
--membership HOST:PORT`` is the elastic world: each worker joins the
membership service (``parallel.membership``) as its stable ``--process-id``
and takes its epoch's rank, world and rendezvous address; a lost peer's
lease expires and the survivors re-form a smaller epoch, a rejoining
worker's knock makes the server broadcast ``REFORM_SIGNAL`` at the next
round boundary, where every worker saves a hand-off state and exits 75 to
join the next epoch. State files then key on the worker id
(``local_state_w<ID>.pt``, ``population_state_w<ID>.npz``), and
``chaos.rejoin_delay_s`` holds the killed worker's first rejoin back. Each
process stamps its fleet identity (the stable worker id, its rank and
membership epoch) on its spans, snapshots and records; under membership it
saves its counter totals at every state save and artifact dump
(``counters.json``) and the next incarnation resumes from them, so
``fedrec-obs report`` totals stay monotone across a rejoin. With
``obs.fleet.collector`` each round's telemetry is pushed to the collector.

``--device`` defaults to ``cuda`` and raises without a GPU unless it is
``cpu``; every process of a one-card machine uses that card. Without
``--coordinator`` (and ``--membership``) the script runs standalone (local
FedAvg). ``fed.dcn_compress="auto"`` and ``shard.table`` are refused by name.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from fedrec_tpu_torch.cli.run import _device_count, build_parser, make_synthetic_from_args

_KEEP_GLOBALS = 3
# EX_TEMPFAIL: a supervised worker's "the world broke, relaunch me"
RESPAWN_EXIT = 75


def _argv_value(tokens: list[str], flag: str) -> str | None:
    """The value of ``--flag X`` or ``--flag=X`` in an argv slice, or None."""
    for i, tok in enumerate(tokens):
        if tok == flag and i + 1 < len(tokens):
            return tokens[i + 1]
        if tok.startswith(flag + "="):
            return tok.split("=", 1)[1]
    return None


def _membership_status(address: str) -> dict | None:
    """The membership service's status, or None when it cannot answer (a
    service that is down must not stop a respawn)."""
    from fedrec_tpu_torch.parallel.membership import MembershipClient, MembershipError

    try:
        return MembershipClient(address, worker_id="_supervisor", rpc_timeout_s=5.0).status()
    except (OSError, MembershipError, ValueError):
        return None


def _reforming(address: str, last_epoch: int | None) -> bool:
    """The service shows a reformation under way: a join pending, a reform
    flagged, or an epoch other than the one the child was spawned into."""
    st = _membership_status(address)
    return st is not None and bool(st.get("reform_pending") or st.get("pending")
                                   or (last_epoch is not None
                                       and int(st["epoch"]) != last_epoch))


def _supervise(argv: list[str]) -> int:
    """``--supervise``: run the worker (this command without the flag) as a
    child and relaunch it whenever it dies by a signal, by the chaos kill's
    137 or with :data:`RESPAWN_EXIT`, after a jittered backoff from about
    ``--collective-timeout`` (clamped to [2, 30] s, 5 s without it), growing
    1.5x a respawn up to 60 s. Other exit codes are deterministic failures
    and return at once. ``FEDREC_SUPERVISE_MAX`` (default 20) bounds the
    respawns; ``FEDREC_WORKER_PIDFILE`` receives the live child's pid.

    With ``--membership`` the supervisor asks the service for its epoch
    before every spawn and hands it to the child (``FEDREC_MEMBERSHIP_EPOCH``);
    while a reformation is under way (a join pending, a reform flagged, or
    the epoch moved since the last spawn) the backoff is cut to about 1 s:
    the exit was the reformation, and the forming epoch waits on this
    worker. The JAX supervisor looks once, when the child exits; this one
    looks again every second of the backoff, because gloo reports a dead peer
    at once, before the peer's lease has expired and flagged the reform:
    looked at only then, the survivors would each sleep a crash-grade
    backoff and rejoin too far apart for one formation window."""
    import random
    import subprocess

    keep = [t for t in argv if t != "--supervise"]
    env = dict(os.environ, FEDREC_SUPERVISED="1")
    pidfile = os.environ.get("FEDREC_WORKER_PIDFILE")
    membership_addr = _argv_value(keep, "--membership")
    last_epoch: int | None = None
    base_delay = 5.0
    timeout = _argv_value(keep, "--collective-timeout")
    if timeout is not None:
        try:
            base_delay = max(2.0, min(float(timeout), 30.0))
        except ValueError:
            pass
    max_respawns = int(os.environ.get("FEDREC_SUPERVISE_MAX", "20"))
    rng = random.Random(os.getpid())
    attempt = 0
    while True:
        if membership_addr:
            st = _membership_status(membership_addr)
            if st is not None:
                env["FEDREC_MEMBERSHIP_EPOCH"] = str(st["epoch"])
                last_epoch = int(st["epoch"])
        proc = subprocess.Popen([sys.executable, "-m", "fedrec_tpu_torch.cli.coordinator",
                                 *keep], env=env)
        if pidfile:
            try:
                Path(pidfile).write_text(str(proc.pid))
            except OSError:
                pass
        rc = proc.wait()
        if rc == 0:
            if attempt:
                print(f"[supervisor] worker finished after {attempt} respawn(s)", flush=True)
            return 0
        # a config error (1) or argparse (2) would fail the same way again
        if rc > 0 and rc not in (RESPAWN_EXIT, 137):
            print(f"[supervisor] worker exited rc={rc} (non-retryable); not respawning",
                  flush=True)
            return rc
        attempt += 1
        if attempt > max_respawns:
            print(f"[supervisor] giving up after {max_respawns} respawns (last rc={rc})",
                  flush=True)
            return rc if rc > 0 else 1
        delay = min(base_delay * (1.5 ** min(attempt - 1, 6)), 60.0)
        delay *= 0.5 + rng.random()  # desynchronize the peers' supervisors
        cut = membership_addr is not None and _reforming(membership_addr, last_epoch)
        if cut:
            delay = 0.5 + rng.random()
        print(f"[supervisor] worker exited rc={rc}; respawn {attempt}/{max_respawns} in "
              f"{delay:.1f}s", flush=True)
        deadline = time.monotonic() + delay
        while (left := deadline - time.monotonic()) > 0:
            time.sleep(min(left, 1.0))
            if not cut and membership_addr is not None and _reforming(membership_addr,
                                                                      last_epoch):
                cut = True
                deadline = min(deadline, time.monotonic() + 0.5 + rng.random())
                print("[supervisor] a reformation is under way; respawning now", flush=True)


def _process_start_wall() -> float:
    """The wall-clock time this process started (Linux ``/proc``), else
    now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        # field 22, starttime, in clock ticks since boot
        return time.time() - uptime + int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def params_digest(tree) -> str:
    """SHA-256 of a parameter tree's leaves in JAX's leaf order (their
    bytes as f32): equal digests are bitwise-equal trees."""
    import hashlib

    from fedrec_tpu_torch.utils.pytree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(np.ascontiguousarray(np.asarray(leaf, np.float32)).tobytes())
    return h.hexdigest()


def apply_process_sharding(cfg, rt, server_trains: bool) -> None:
    """Default ``data.num_shards`` / ``data.shard_index`` so that each
    process trains a disjoint slice (the reference's per-rank
    ``DistributedSampler``). An explicit ``--set data.num_shards=...`` wins,
    ``1`` included (every process trains the whole corpus). With a server
    that does not train, the shards are dealt over the ``N - 1`` clients."""
    if rt.num_processes <= 1 or cfg.data.num_shards != 0:
        return
    if server_trains:
        cfg.data.num_shards = rt.num_processes
        cfg.data.shard_index = rt.process_id
    else:
        cfg.data.num_shards = max(rt.num_processes - 1, 1)
        # the server holds shard 0 but never trains on it
        cfg.data.shard_index = max(rt.process_id - 1, 0)


def emulate_world(trainers: list, cfg, rounds: range, server_params=None) -> tuple[list, list]:
    """The coordinator loop of ``len(trainers)`` processes run in this
    process, the reference the deployment's checks hold it to: process
    ``p`` is ``trainers[p]`` (each built on its own shard), or None for a
    server that does not train, whose contribution is the global it was
    sent. Each round every trainer adopts the global, trains
    (``train_round_recovering``), and the contributions go through
    ``parallel.multihost.emulate_aggregate`` with ``main``'s weights and
    codec; the server steps FedOpt under ``fed.server_opt``. Returns the
    server's global (Flax-layout ``(user, news)``) after each round, and
    each round's training losses (None for the server).
    ``server_params`` is the first global (default: the first trainer's
    parameters, which every process's init holds)."""
    from fedrec_tpu_torch.comms import CodecState, codec_uses_feedback
    from fedrec_tpu_torch.fed.strategies import ServerOptimizer
    from fedrec_tpu_torch.parallel.multihost import emulate_aggregate
    from fedrec_tpu_torch.utils.pytree import tree_flatten, tree_unflatten

    fed = cfg.fed
    if server_params is None:
        server_params = next(t for t in trainers if t is not None)._client0_params()
    ef = codec_uses_feedback(fed.dcn_compress, fed.dcn_error_feedback)
    codec_states = [CodecState() if ef else None for _ in trainers]
    server_opt = (ServerOptimizer(fed.server_opt, fed.server_lr, fed.server_momentum)
                  if fed.server_opt != "none" else None)
    for t in trainers:
        if t is not None and server_opt is not None:
            t.server_opt = None  # only the server steps FedOpt
    g, out, losses = server_params, [], []
    for r in rounds:
        contribs, weights, round_losses = [], [], []
        for t in trainers:
            if t is None:
                contribs.append(g)
                weights.append(0.0)
                round_losses.append(None)
                continue
            t.set_global_params(*g)
            round_losses.append(t.train_round_recovering(r).train_loss)
            contribs.append(t._client0_params())
            weights.append(float(t.num_local_samples) if fed.weight_by_samples else 1.0)
        new = emulate_aggregate(contribs, weights, base=g, codec_states=codec_states,
                                compress=fed.dcn_compress, robust=fed.robust,
                                topk_ratio=fed.dcn_topk_ratio,
                                error_feedback=fed.dcn_error_feedback, agg=cfg.agg,
                                sketch_width=fed.dcn_sketch_width,
                                sketch_seed=fed.dcn_sketch_seed)[0]
        if server_opt is not None:
            leaves, treedef = tree_flatten(new)
            new = tree_unflatten(treedef, server_opt.step(tree_flatten(g)[0], leaves))
        g = new
        out.append(g)
        losses.append(round_losses)
    return out, losses


def config_from_args(args, dev):
    """The run's ``ExperimentConfig`` from the command line, before the
    process sharding: the positional arguments, the run CLI's options and
    the ``--set`` overrides."""
    from fedrec_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig()
    cfg.fed.rounds = args.total_epochs
    cfg.data.batch_size = args.batch_size
    cfg.train.save_every = args.save_every
    # within a process the K slots take param_avg; across processes the
    # coordinator runtime aggregates
    cfg.fed.strategy = "param_avg"
    cfg.fed.local_epochs = args.local_epochs
    cfg.fed.num_clients = args.clients or _device_count(dev)
    if args.mode:
        cfg.model.text_encoder_mode = "table" if args.mode == "decoupled" else "head"
    cfg.data.data_dir = args.data_dir
    if args.synthetic:
        cfg.data.dataset = "synthetic"
    if args.obs_dir:
        cfg.obs.dir = args.obs_dir
    return cfg.apply_overrides(args.overrides)


def load_inputs(args, cfg):
    """``(data, token_states)``: the synthetic corpus or the artifacts, and
    the cached token states (memory-mapped, so the processes of one host
    share its page cache), random seeded states without a file, None in
    finetune mode."""
    from fedrec_tpu_torch.data import load_mind_artifacts

    data = (make_synthetic_from_args(args, cfg) if cfg.data.dataset == "synthetic"
            else load_mind_artifacts(cfg.data.data_dir))
    token_path = args.token_states or str(Path(cfg.data.data_dir) / "token_states.npy")
    if cfg.model.text_encoder_mode == "finetune":
        return data, None
    if Path(token_path).exists():
        return data, np.load(token_path, mmap_mode="c")
    return data, np.random.default_rng(0).standard_normal(
        (data.num_news, data.title_len, cfg.model.bert_hidden)).astype(np.float32)


def _build_parser():
    parser = build_parser()
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="rendezvous address, process 0 hosts it (omit for one process)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--server-trains", action="store_true",
                        help="process 0 also trains (the reference server does not)")
    parser.add_argument("--collective-timeout", type=float, default=300.0,
                        help="seconds before a hung collective marks the world broken and "
                             "this process finishes standalone (0 = wait forever)")
    parser.add_argument("--resume-local-state", default=None, metavar="PATH",
                        help="internal: resume standalone from a per-process local state "
                             "(a degraded client's continuation)")
    parser.add_argument("--supervise", action="store_true",
                        help="run the worker under an auto-respawn supervisor: a dead or "
                             "degraded worker relaunches and resumes from its local state")
    parser.add_argument("--membership", default=None, metavar="HOST:PORT",
                        help="the elastic membership service (parallel.membership): the world "
                             "becomes a membership epoch that shrinks when a peer is lost and "
                             "re-forms when one rejoins; --process-id is the stable worker "
                             "identity; needs --supervise")
    return parser


def _standalone_argv(original_argv: list[str], local_snap: Path, cfg) -> list[str]:
    """The command line of a degraded client's standalone continuation:
    the world's flags dropped, the local state and the shard pinned. The
    process id stays, so the continuation keeps this process's file names
    (its codec residual) and is never taken for the server."""
    world_flags = {"--coordinator", "--num-processes", "--collective-timeout",
                   "--resume-local-state"}
    keep: list[str] = []
    skip_value = False
    for tok in original_argv:
        if skip_value:
            skip_value = False
            continue
        base = tok.split("=", 1)[0]
        if base in world_flags:
            skip_value = "=" not in tok
            continue
        if base == "--server-trains":
            continue
        keep.append(tok)
    return [sys.executable, "-m", "fedrec_tpu_torch.cli.coordinator", *keep,
            "--resume-local-state", str(local_snap),
            "--set", f"data.num_shards={cfg.data.num_shards}",
            "--set", f"data.shard_index={cfg.data.shard_index}"]


def _join_membership(parser, args):
    """The elastic worker's join: the chaos holdoff, the join (exit
    :data:`RESPAWN_EXIT` when it fails: retryable under supervision), the
    lease heartbeats (started before the rendezvous, which can outlast a
    lease). Returns ``(client, assignment)``."""
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.fed.chaos import rejoin_holdoff
    from fedrec_tpu_torch.parallel.membership import (
        MembershipClient,
        MembershipError,
        elastic_policy,
        publish_membership_metrics,
    )

    if args.process_id is None:
        parser.error("--membership requires --process-id (the stable worker identity snapshots "
                     "are keyed by)")
    if os.environ.get("FEDREC_SUPERVISED") != "1":
        parser.error("--membership requires --supervise: reforming an epoch LEAVES the process "
                     "(rc 75) and only the supervisor can rejoin it at the next epoch")
    pre_cfg = ExperimentConfig().apply_overrides(args.overrides)
    el = pre_cfg.fed.elastic
    holdoff = rejoin_holdoff(pre_cfg.chaos, args.process_id,
                             Path(pre_cfg.train.snapshot_dir or "snapshots"))
    if holdoff > 0:
        print(f"[chaos] worker {args.process_id} holding off its rejoin {holdoff:.0f}s "
              "(chaos.rejoin_delay_s) so the survivors' shrunk epoch forms first", flush=True)
        time.sleep(holdoff)
    client = MembershipClient(args.membership, worker_id=str(args.process_id),
                              join_timeout_s=el.join_timeout_s)
    handed = os.environ.get("FEDREC_MEMBERSHIP_EPOCH")
    try:
        assignment = client.join(policy=elastic_policy(el))
    except (OSError, MembershipError, ValueError) as e:
        print(f"[membership] worker {args.process_id} join failed ({type(e).__name__}: {e}); "
              f"exiting for retry (rc {RESPAWN_EXIT})", flush=True)
        sys.exit(RESPAWN_EXIT)
    print(f"[membership] worker {args.process_id} joined epoch {assignment.epoch} as rank "
          f"{assignment.rank}/{assignment.world} (coordinator {assignment.coordinator}"
          + (f"; supervisor handed epoch {handed}" if handed else "") + ")", flush=True)
    client.start_heartbeat()
    publish_membership_metrics(assignment=assignment, client=client)
    return client, assignment


def main(argv: list[str] | None = None) -> int:
    started_at = _process_start_wall()
    parser = _build_parser()
    original_argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    if args.agg_server or args.worker_id:
        raise ValueError("--agg-server and --worker-id start a worker of the async deployment "
                         "(python -m fedrec_tpu_torch.cli.run); the coordinator deployment "
                         "takes --coordinator or --membership")
    if args.supervise:
        return _supervise(original_argv)
    supervised = os.environ.get("FEDREC_SUPERVISED") == "1"
    membership = assignment = None
    joined_at = None
    if args.membership is not None:
        # first, before torch and the trainer stack are imported (seconds
        # with CUDA), as the JAX worker joins before it imports jax: a
        # restart's join must land within its old lease
        membership, assignment = _join_membership(parser, args)
        joined_at = time.time()

    import torch

    # full-f32 products on the card, as the run CLI sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from fedrec_tpu_torch import ops
    from fedrec_tpu_torch.comms import codec_caps, codec_state_bytes, load_codec_state
    from fedrec_tpu_torch.device import resolve_device
    from fedrec_tpu_torch.fed.strategies import ServerOptimizer
    from fedrec_tpu_torch.obs import get_registry
    from fedrec_tpu_torch.obs.fleet import (
        restore_counter_baseline,
        save_counter_baseline,
        set_fleet_identity,
    )
    from fedrec_tpu_torch.parallel.membership import publish_membership_metrics
    from fedrec_tpu_torch.parallel.multihost import (
        REFORM_SIGNAL,
        CoordinatorRuntime,
        initialize_distributed,
    )
    from fedrec_tpu_torch.privacy import calibrate_from_config
    from fedrec_tpu_torch.train.checkpoint import (
        SnapshotIntegrityError,
        atomic_write_bytes,
        coordinator_globals,
        global_state_bytes,
        load_state_bytes,
        local_state_bytes,
        verify_state_tree,
    )
    from fedrec_tpu_torch.train.step import refuse_unported
    from fedrec_tpu_torch.train.trainer import Trainer
    from fedrec_tpu_torch.utils.pytree import tree_flatten, tree_unflatten

    # before the rendezvous: a process without its device fails alone
    dev = resolve_device(args.device)
    address, size, rank = args.coordinator, args.num_processes, args.process_id
    if assignment is not None:
        # the epoch's assignment sets the world
        address, size, rank = assignment.coordinator, assignment.world, assignment.rank
    # a supervised rendezvous is bounded: a respawn racing the dying world
    # fails fast and retries
    init_timeout = (max(30.0, min(args.collective_timeout * 2, 120.0))
                    if supervised and args.collective_timeout else None)
    try:
        world = initialize_distributed(address, size, rank, initialization_timeout=init_timeout)
    except (RuntimeError, OSError) as e:
        if not supervised:
            raise
        print(f"[coordinator] supervised rendezvous failed ({type(e).__name__}: {e}); exiting "
              f"for retry (rc {RESPAWN_EXIT})", flush=True)
        sys.exit(RESPAWN_EXIT)

    cfg = config_from_args(args, dev)
    if membership is not None:
        cfg.fed.elastic.enabled = True  # config.json records it
    elif cfg.fed.elastic.enabled:
        raise ValueError(
            "fed.elastic.enabled is set but no membership service was given: pass --membership "
            "HOST:PORT (and run under --supervise) — the epoch layer cannot form without the "
            "lease service")
    if cfg.fed.dcn_compress == "auto":
        raise ValueError(
            "fed.dcn_compress='auto' needs the trainer's warmup telemetry and is not available "
            "on the coordinator path; pin a concrete codec "
            "(int8/sign1bit/topk/countsketch/randproj) per deployment")
    if (cfg.fed.robust.method != "mean" and cfg.fed.dcn_compress != "none"
            and not codec_caps(cfg.fed.dcn_compress).decodes_per_contribution):
        # here, not inside the gather: raised there, a watchdog would read
        # it as a peer failure and degrade every process
        raise ValueError(
            f"fed.robust.method={cfg.fed.robust.method!r} needs per-contribution decode, "
            f"which codec {cfg.fed.dcn_compress!r} cannot provide (order statistics judge "
            "CLIENTS, and sketch collisions mix every client's coordinates before any decode "
            "exists); use one of the decodable codecs (int8/sign1bit/topk) or "
            "fed.robust.method='mean'")
    refuse_unported(cfg)
    rt = CoordinatorRuntime(
        world,
        collective_timeout_s=args.collective_timeout or None,
        compress=cfg.fed.dcn_compress,
        robust=cfg.fed.robust,
        topk_ratio=cfg.fed.dcn_topk_ratio,
        error_feedback=cfg.fed.dcn_error_feedback,
        sketch_width=cfg.fed.dcn_sketch_width,
        sketch_seed=cfg.fed.dcn_sketch_seed,
        # a real wall-clock bound on the round's gather
        round_deadline_s=(cfg.fed.population.round_deadline_ms / 1e3
                          if cfg.fed.population.round_deadline_ms > 0 else None),
        agg=cfg.agg,
        membership=membership,
        epoch=assignment.epoch if assignment is not None else 0,
    )
    apply_process_sharding(cfg, rt, args.server_trains)
    data, token_states = load_inputs(args, cfg)
    if args.dp_epsilon > 0:
        cfg.privacy.enabled = True
        cfg.privacy.epsilon = args.dp_epsilon
        if cfg.model.text_encoder_mode == "table":
            cfg.privacy.mechanism = "ldp_news"
        # calibrated against this process's shard: a global count would
        # underestimate the sample rate and under-noise every round
        n_local = len(data.train_samples)
        if cfg.data.num_shards > 1:
            n_local = -(-(n_local - cfg.data.shard_index) // cfg.data.num_shards)
        cfg.privacy.sigma = calibrate_from_config(cfg, n_local)
    # under membership the stable worker id (ranks are re-dealt every epoch)
    # names the obs subdirectory, the state files and the chaos kill's target
    ident = int(args.process_id) if membership is not None else rt.process_id
    set_fleet_identity(worker=str(ident), rank=rt.process_id,
                       epoch=assignment.epoch if assignment is not None else None)
    if cfg.obs.dir and (rt.num_processes > 1 or membership is not None):
        cfg.obs.dir = str(Path(cfg.obs.dir) / f"worker_{ident}")
    if cfg.obs.dir and membership is not None:
        # a respawned worker's counters resume from its last baseline
        restore_counter_baseline(Path(cfg.obs.dir))

    trains = args.server_trains or not rt.is_server or rt.num_processes == 1
    # a degraded client's standalone continuation keeps the per-process
    # files; so does an elastic world shrunk to one (the next may grow)
    per_process_files = (rt.num_processes > 1 or args.resume_local_state is not None
                         or membership is not None)
    state_suffix = f"w{args.process_id}" if membership is not None else f"p{rt.process_id}"
    snapshot_dir = Path(cfg.train.snapshot_dir or "snapshots")
    if per_process_files:
        cfg.train.snapshot_dir = ""
    trainer = Trainer(cfg, data, token_states, device=dev)
    if rt.num_processes > 1 and rt.is_server:
        # the model settings serving reads back; server-only and atomic
        snapshot_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_bytes(snapshot_dir / "config.json", cfg.to_json().encode())
    if cfg.data.num_shards > 1:
        print(f"[coordinator] process {rt.process_id} data shard "
              f"{cfg.data.shard_index + 1}/{cfg.data.num_shards}: "
              f"{trainer.num_local_samples} samples", flush=True)

    codec_snap = None
    if per_process_files and rt.codec_state is not None:
        codec_snap = snapshot_dir / f"codec_state_{state_suffix}.npz"
        if cfg.train.resume and codec_snap.exists():
            try:
                rt.codec_state, ef_round = load_codec_state(codec_snap.read_bytes(),
                                                            trainer._client0_params())
                print(f"[coordinator] process {rt.process_id} resumed codec residual from "
                      f"round {ef_round}", flush=True)
            except (OSError, ValueError, KeyError) as e:
                # a torn sidecar costs one round's banked encode error
                print(f"[coordinator] process {rt.process_id} codec residual sidecar "
                      f"unreadable ({type(e).__name__}: {e}); starting the residual from "
                      "zero", flush=True)

    local_snap = None
    server_optimizer = None
    restore_ms = None
    if per_process_files:
        local_snap = (Path(args.resume_local_state) if args.resume_local_state
                      else snapshot_dir / f"local_state_{state_suffix}.pt")
        if cfg.train.resume and local_snap.exists():
            t_restore = time.perf_counter()
            try:
                restored = load_state_bytes(local_snap.read_bytes())
                verify_state_tree(restored)
            except (RuntimeError, OSError, EOFError, KeyError, ValueError,
                    SnapshotIntegrityError) as e:
                # torn or corrupt: this shard restarts fresh, and the server's
                # fan-out re-integrates it
                print(f"[coordinator] process {rt.process_id} local snapshot "
                      f"{local_snap.name} is corrupt/torn ({type(e).__name__}: "
                      f"{str(e)[:200]}); starting this shard fresh — the server's fan-out "
                      "re-integrates it next round", flush=True)
                restored = None
            if restored is not None:
                trainer.adopt_state(restored)
                trainer.start_round = int(restored["round"]) + 1
                print(f"[coordinator] process {rt.process_id} resumed local state at round "
                      f"{trainer.start_round - 1}", flush=True)
            restore_ms = (time.perf_counter() - t_restore) * 1e3
        pop_snap = snapshot_dir / f"population_state_{state_suffix}.npz"
        if (membership is not None and cfg.train.resume and pop_snap.exists()
                and trainer._pop_engine):
            # the participation ledger carries across epochs, resized: the
            # re-formed world may deal other local data
            try:
                pop_round = trainer.adopt_population_sidecar(pop_snap.read_bytes(), resize=True)
                print(f"[membership] worker {ident} carried its participation ledger from "
                      f"round {pop_round}", flush=True)
            except (OSError, ValueError, KeyError) as e:
                # a torn sidecar costs history, never the resume
                print(f"[membership] population sidecar unreadable ({type(e).__name__}: {e}); "
                      "ledger restarts fresh", flush=True)
        if cfg.fed.server_opt != "none":
            # hub-and-spoke FedOpt: only the server holds and steps it; a
            # client (a standalone continuation too) never does
            trainer.server_opt = None
            if rt.is_server and rt.num_processes > 1:
                server_optimizer = ServerOptimizer(cfg.fed.server_opt, cfg.fed.server_lr,
                                                   cfg.fed.server_momentum)
                opt_snap = snapshot_dir / "server_opt_state.npz"
                if cfg.train.resume and opt_snap.exists():
                    loaded = server_optimizer.load_state(
                        opt_snap.read_bytes(), tree_flatten(trainer._client0_params())[0])
                    if loaded != trainer.start_round - 1:
                        print(f"[coordinator] server_opt sidecar is from round {loaded}, local "
                              f"snapshot from round {trainer.start_round - 1} — momentum may "
                              "be skewed for the first resumed round", flush=True)

    report = {"process": rt.process_id, "worker": ident, "world": rt.num_processes,
              "epoch": rt.epoch, "trains": bool(trains), "rounds": [], "losses": [],
              "round_ms": [], "sync_from_server_ms": [], "aggregate_ms": [],
              "aggregate_parts_ms": [],
              "degraded": False, "standalone": args.resume_local_state is not None,
              "reformed": False, "started_at": started_at, "joined_at": joined_at,
              "first_round_at": None,
              "restore_ms": restore_ms, "handoff_save_ms": None}
    if membership is not None:
        # params_digest of the global each round's fan-out delivered and,
        # on the server, of each global it saved
        report["fanout_sha256"], report["global_sha256"] = [], []

    def final_push() -> None:
        if trainer.fleet_pusher is not None:
            trainer.fleet_pusher.push(final=True)

    def print_report() -> None:
        reg = get_registry()
        for key, name in (("bytes_up", "fed.dcn_bytes_up_total"),
                          ("bytes_down", "fed.dcn_bytes_down_total")):
            report[key] = reg.counter(name, labels=("path",)).value(path="dcn")
        report["deadline_misses"] = reg.counter("fed.dcn_deadline_misses_total").value()
        report["degraded"] = rt.degraded
        report["launches"] = ops.launch_counts()
        report["peak_gpu_mb"] = (torch.cuda.max_memory_allocated() / 2**20
                                 if dev.type == "cuda" else None)
        report["num_local_samples"] = int(trainer.num_local_samples)
        report["degraded_at"] = rt.degraded_at
        for key, name in (("compression_ratio", "fed.dcn_compression_ratio"),
                          ("tier_reduce_ms", "agg.tier_reduce_ms")):
            report[key] = reg.gauge(name).value()
        print(f"[coordinator] report {json.dumps(report)}", flush=True)
        if cfg.obs.dir:
            # this loop never runs Trainer.run, whose exit writes them
            from fedrec_tpu_torch.obs.report import dump_artifacts

            try:
                # an elastic worker's trace of each epoch survives the respawn
                dump_artifacts(Path(cfg.obs.dir), registry=trainer.registry,
                               tracer=trainer.tracer,
                               trace_tag=f"e{rt.epoch}" if membership is not None else None)
                if membership is not None:
                    save_counter_baseline(Path(cfg.obs.dir), registry=trainer.registry,
                                          epoch=rt.epoch)
            except OSError as e:
                print(f"[coordinator] obs artifact dump failed: {e}", flush=True)

    def respawn_standalone() -> None:
        """A degraded client leaves the broken world device-free and
        re-executes itself as a standalone continuation of its shard from
        its last saved local state; the round in flight is retrained. The
        server finishes its rounds in process (``finalize`` exits). Under a
        supervisor every degraded process, the server too, exits
        :data:`RESPAWN_EXIT` device-free, and the relaunched world resumes
        from the local states (the server's exit frees the rendezvous)."""
        if rt.num_processes == 1:
            return
        if supervised:
            print(f"[coordinator] process {rt.process_id} world degraded under supervision — "
                  f"exiting for re-rendezvous (rc {RESPAWN_EXIT})", flush=True)
            report["degraded"] = True
            # device-free, so safe on the way out: this incarnation's spans
            # reach the fleet merge
            final_push()
            print_report()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(RESPAWN_EXIT)
        if rt.is_server or local_snap is None:
            return
        print(f"[coordinator] process {rt.process_id} world degraded — respawning "
              f"standalone, resuming from "
              f"{local_snap.name if local_snap.exists() else 'scratch'}", flush=True)
        report["degraded"] = True
        print_report()
        sys.stdout.flush()
        sys.stderr.flush()
        os.execv(sys.executable, _standalone_argv(original_argv, local_snap, cfg))

    def save_local(round_idx: int) -> None:
        """The local state and its sidecars: the FedOpt buffers (server),
        the codec residual, under membership the population sidecar."""
        snapshot_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_bytes(local_snap, local_state_bytes(trainer.states, round_idx))
        if server_optimizer is not None:
            atomic_write_bytes(snapshot_dir / "server_opt_state.npz",
                               server_optimizer.state_bytes(round_idx))
        if codec_snap is not None:
            atomic_write_bytes(codec_snap, codec_state_bytes(rt.codec_state, round_idx))
        if membership is not None:
            blob = trainer.population_sidecar_bytes(round_idx)
            if blob is not None:
                atomic_write_bytes(pop_snap, blob)
            if cfg.obs.dir:
                # at the save cadence too: a worker killed between two
                # reformations still resumes its totals
                try:
                    save_counter_baseline(Path(cfg.obs.dir), registry=trainer.registry,
                                          epoch=rt.epoch)
                except OSError:
                    pass

    def reform_handoff(next_round: int) -> None:
        """The reformation barrier's worker half: every member got
        :data:`REFORM_SIGNAL` in the same broadcast, so the whole world is
        at one boundary. Save the hand-off state (round ``next_round - 1``),
        close the still-healthy world in step, and exit
        :data:`RESPAWN_EXIT` so the supervisor joins the forming epoch."""
        print(f"[membership] worker {ident} leaving epoch {rt.epoch} at round boundary "
              f"{next_round} for reformation", flush=True)
        trainer.tracer.instant("membership_reform", epoch=rt.epoch, round=next_round)
        t0 = time.perf_counter()
        save_local(next_round - 1)
        report["handoff_save_ms"] = (time.perf_counter() - t0) * 1e3
        report["reformed"] = True
        publish_membership_metrics(reforms=1, client=membership)
        final_push()
        print_report()
        trainer.logger.finish()
        rt._synchronized_shutdown()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(RESPAWN_EXIT)

    def save(round_idx: int) -> None:
        save_local(round_idx)
        if cfg.chaos.enabled and cfg.chaos.torn_snapshot_round == round_idx:
            # a crash mid-write: the resume must survive it
            blob = local_snap.read_bytes()
            local_snap.write_bytes(blob[: max(len(blob) // 2, 1)])
            print(f"[chaos] process {rt.process_id} tore its local snapshot at round "
                  f"{round_idx}", flush=True)
        if rt.is_server and rt.num_processes > 1:
            # a standalone continuation is a client: its params are not the global
            atomic_write_bytes(snapshot_dir / f"global_round_{round_idx}.pt",
                               global_state_bytes(trainer.states, round_idx))
            print(f"[coordinator] process {rt.process_id} saved global_round_{round_idx}.pt",
                  flush=True)
            if membership is not None:
                report["global_sha256"].append(params_digest(trainer._client0_params()))
            for old in coordinator_globals(snapshot_dir)[:-_KEEP_GLOBALS]:
                old.unlink(missing_ok=True)

    round_idx = trainer.start_round
    while True:
        t_round = time.perf_counter()
        # every process adopts the server's counter
        server_round = rt.start_round(round_idx, cfg.fed.rounds)
        if rt.degraded:
            respawn_standalone()
        if server_round == REFORM_SIGNAL:
            reform_handoff(round_idx)
        if server_round < 0:
            break
        round_idx = server_round
        if report["first_round_at"] is None:
            report["first_round_at"] = time.time()
        if (cfg.chaos.enabled and cfg.chaos.kill_round == round_idx
                and cfg.chaos.kill_process == ident):
            marker_dir = snapshot_dir if per_process_files else Path(
                cfg.train.snapshot_dir or "snapshots")
            marker_dir.mkdir(parents=True, exist_ok=True)
            marker = marker_dir / f"chaos_killed_p{ident}"
            if not marker.exists():
                marker.write_text(str(round_idx))
                print(f"[chaos] process {rt.process_id} dying at round {round_idx} "
                      "(chaos.kill_round)", flush=True)
                os._exit(137)
        # the server's fan-out: everyone adopts the global
        u, n = rt.sync_from_server(trainer._client0_params())
        if rt.degraded:
            respawn_standalone()
        if membership is not None:
            report["fanout_sha256"].append(params_digest((u, n)))
        trainer.set_global_params(u, n)
        round_start_global = (u, n)
        result = trainer.train_round_recovering(round_idx) if trains else None
        # the gather: weight 0 for a server that does not train; the shard
        # size under fed.weight_by_samples (classic FedAvg n_k)
        w = float(trainer.num_local_samples) if cfg.fed.weight_by_samples else 1.0
        u, n = rt.aggregate(trainer._client0_params(), participated=trains, weight=w,
                            base=round_start_global)
        if rt.degraded:
            # device-free exit now; the standalone continuation retrains
            # the round in flight
            respawn_standalone()
        if server_optimizer is not None:
            leaves, treedef = tree_flatten((u, n))
            u, n = tree_unflatten(treedef, server_optimizer.step(
                tree_flatten(round_start_global)[0], leaves))
        trainer.set_global_params(u, n)
        # this loop completes the rounds outside Trainer.run
        trainer.registry.counter("train.rounds_total").inc()
        report["losses"].append(None if result is None else result.train_loss)
        if result is not None:
            log = {"round": round_idx, "training_loss": result.train_loss}
            log.update(result.val_metrics)
            trainer.logger.log(round_idx, log)
            print(f"[coordinator] process {rt.process_id} {json.dumps(log)}", flush=True)
        if local_snap is not None and (round_idx + 1) % cfg.train.save_every == 0:
            save(round_idx)
        report["rounds"].append(round_idx)
        report["round_ms"].append((time.perf_counter() - t_round) * 1e3)
        report["sync_from_server_ms"].append(rt.last_ms.get("sync_from_server"))
        report["aggregate_ms"].append(rt.last_ms.get("aggregate"))
        report["aggregate_parts_ms"].append(
            {k: rt.last_ms.get(k) for k in ("encode", "gather", "reduce")})
        if trainer.fleet_pusher is not None:
            # this loop runs the rounds outside Trainer._after_round: the
            # round-cadence push lands at this boundary
            trainer.fleet_pusher.maybe_push(round_idx)
        round_idx += 1

    state = "degraded" if rt.degraded else "done"
    print(f"[coordinator] process {rt.process_id} {state} after {round_idx} rounds", flush=True)
    if membership is not None:
        # a finished worker leaves: the service reads completion, not death
        publish_membership_metrics(client=membership)
        membership.leave()
        membership.close()
    final_push()
    print_report()
    trainer.logger.finish()
    rt.finalize(0)  # a broken world exits here
    return 0


if __name__ == "__main__":
    sys.exit(main())
