"""The port's training entry point, the counterpart of
``python -m fedrec_tpu.cli.run`` (the reference's ``main.py`` flow): the
same positional arguments and options, one federated run through
``train.trainer.Trainer`` on one card.

Usage:
  python -m fedrec_tpu_torch.cli.run EPOCHS BATCH SAVE_EVERY \\
      [--strategy param_avg] [--clients 4] [--data-dir UserData] \\
      [--dp-epsilon 10] [--mode joint|decoupled] [--set section.key=value ...]
  python -m fedrec_tpu_torch.cli.run 2 16 1 --synthetic --device cpu --clients 2 \\
      --set model.news_dim=32 --set model.num_heads=4 --set model.head_dim=8 \\
      --set model.query_dim=16 --set model.bert_hidden=48 --set train.snapshot_dir=

Without ``--mode`` the run is decoupled (``model.text_encoder_mode``'s
default); ``--set model.text_encoder_mode=finetune`` trains the DistilBERT
trunk in the loop (the ``model.trunk_*`` widths), reading the titles'
tokens and no token states. ``--dp-epsilon`` turns on ``ldp_news`` in decoupled mode; in
joint mode it means per-example DP-SGD (``privacy.mechanism='dpsgd'``), the
route with a real (epsilon, delta); either way sigma comes from the
accountant. ``--device`` defaults to ``cuda`` and
raises without a GPU unless it is ``cpu``; ``--clients`` defaults to the
number of devices of that kind (the JAX CLI's ``len(jax.local_devices())``).
``--agg-server HOST:PORT --worker-id ID`` makes the run one worker of the
async deployment (``agg.mode=async`` across processes): a single-client
``Trainer`` in flat mode that pushes each round's delta to the commit
authority (``python -m fedrec_tpu_torch.agg.server``) and adopts its
commits (``agg.worker.run_async_worker``, the ``agg.worker_*`` fields);
``obs.dir`` becomes ``obs.dir/worker_<ID>``, ``chaos.wire_faults`` (with
``chaos.enabled``) puts a seeded ``ChaosProxy`` between the worker and the
authority, and an authority that stays unreachable past
``agg.worker_unreachable_budget_s`` exits 75. The worker ends with one
``[agg-worker ID] report {...}`` line. ``--obs-dir DIR`` (``obs.dir``)
writes the run's observability artifacts there (``metrics.jsonl``, ``trace.json``,
``prometheus.txt``, the flight recorder's dump), which ``python -m
fedrec_tpu_torch.cli.obs report DIR`` reads. The other model families run
with ``--set model.user_tower=gru --set model.text_head_arch=cnn``, the
native batcher with ``--set data.native_loader=1``. Snapshots go to
``train.snapshot_dir`` (``snapshots`` in the working directory; empty for
none). Ends with ``final: loss=... auc=... ndcg10=...`` when the last
round was evaluated. The cohort engine, FedOpt and the data path's knobs
have no flags of their own, as in the JAX CLI: ``--set
fed.population.num_clients=256 --set fed.server_opt=adam --set
chaos.enabled=1 --set chaos.pop_drop_rate=0.2 --set
data.prefetch_batches=2``.

``--set fed.seq_shards=S`` (joint or finetune mode, ``--set
fed.seq_impl=ring|ulysses``) runs the job as a seq world: this command
starts S ranks on the local device with ``torch.multiprocessing`` (a gloo
world on a free local port), each running the same ``Trainer`` over all
clients with its slice of every history (``parallel.mesh``); rank 0 prints,
logs, snapshots, evaluates and writes ``obs.dir``. A failed rank stops the
others, and the command exits with the first failure's code.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
from pathlib import Path

import numpy as np

# this process's seat in a seq world (rank, size, address), set in each rank
_SEQ_SEAT: tuple[int, int, str] | None = None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("total_epochs", type=int, help="global rounds (reference argv 1)")
    p.add_argument("batch_size", type=int, help="per-client batch size (argv 2)")
    p.add_argument("save_every", type=int, help="snapshot cadence in rounds (argv 3)")
    p.add_argument("--strategy", default="param_avg",
                   choices=["local", "grad_avg", "param_avg", "coordinator"])
    p.add_argument("--clients", type=int, default=None,
                   help="default: the number of devices of --device's kind")
    p.add_argument("--data-dir", default="UserData",
                   help="directory with bert_news_index.npy etc.")
    p.add_argument("--token-states", default=None,
                   help="path to cached (N, L, H) trunk token states .npy; "
                        "default <data-dir>/token_states.npy if present, else "
                        "random states (smoke mode)")
    p.add_argument("--dp-epsilon", type=float, default=0.0,
                   help="enable LDP with this epsilon (reference argv 4; 0 = off)")
    p.add_argument("--local-epochs", type=int, default=1)
    p.add_argument("--participation", type=float, default=1.0)
    p.add_argument("--mode", default=None, choices=[None, "joint", "decoupled"])
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic data instead of --data-dir artifacts")
    p.add_argument("--synthetic-train", type=int, default=2048,
                   help="synthetic corpus size (train samples)")
    p.add_argument("--synthetic-news", type=int, default=512,
                   help="synthetic corpus size (distinct news)")
    p.add_argument("--obs-dir", default=None,
                   help="observability artifacts (obs.dir): metrics.jsonl, trace.json, "
                        "prometheus.txt, the flight recorder's dump; read them with "
                        "python -m fedrec_tpu_torch.cli.obs report DIR")
    p.add_argument("--agg-server", default=None, metavar="HOST:PORT",
                   help="async federation (agg.mode=async across processes): drive rounds "
                        "against this fedrec_tpu_torch.agg.server commit authority instead "
                        "of a collective world")
    p.add_argument("--worker-id", default=None,
                   help="this worker's name on the agg server (required with --agg-server)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without a GPU unless 'cpu')")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="SECTION.KEY=VALUE")
    return p


def make_synthetic_from_args(args, cfg):
    """The synthetic corpus of the JAX CLI (one definition of the valid-set
    sizing)."""
    from fedrec_tpu_torch.data import make_synthetic_mind

    return make_synthetic_mind(
        num_news=args.synthetic_news, num_train=args.synthetic_train,
        num_valid=max(args.synthetic_train // 8, 32),
        title_len=cfg.data.max_title_len, popular_frac=0.2,
    )


def _device_count(dev) -> int:
    import torch

    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _seq_rank(rank: int, argv: list[str], size: int, address: str) -> None:
    """One rank of the seq world: ``main`` with its seat set; a non-zero
    return is this process's exit code."""
    global _SEQ_SEAT
    _SEQ_SEAT = (rank, size, address)
    rc = main(argv)
    if rc:
        sys.exit(rc)


def _run_seq_world(argv: list[str], size: int) -> int:
    """Start the ``size`` ranks of a seq world on this host and wait for
    them; the first failure stops the others and gives the exit code."""
    import torch.multiprocessing as mp

    address = f"127.0.0.1:{_free_port()}"
    try:
        mp.spawn(_seq_rank, args=(argv, size, address), nprocs=size, join=True)
    except mp.ProcessExitedException as e:
        print(f"[run] seq rank {e.error_index} exited with code {e.exit_code}", file=sys.stderr)
        return e.exit_code or 1
    except mp.ProcessRaisedException as e:
        print(f"[run] seq rank {e.error_index} failed: {e}", file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.agg_server and not args.worker_id:
        print("[run] --agg-server requires --worker-id", file=sys.stderr)
        return 2

    import torch

    # full-f32 products on the card, as the serve and recommend CLIs set
    # them: cuDNN's default is TF32 on, and the CNN head's first cuDNN op
    # would quietly compute in it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.data import load_mind_artifacts
    from fedrec_tpu_torch.device import resolve_device
    from fedrec_tpu_torch.privacy import calibrate_from_config
    from fedrec_tpu_torch.train.step import refuse_unported
    from fedrec_tpu_torch.train.trainer import Trainer

    dev = resolve_device(args.device)
    cfg = ExperimentConfig()
    cfg.fed.rounds = args.total_epochs
    cfg.data.batch_size = args.batch_size
    cfg.train.save_every = args.save_every
    cfg.fed.strategy = args.strategy
    cfg.fed.local_epochs = args.local_epochs
    cfg.fed.participation = args.participation
    cfg.fed.num_clients = args.clients or _device_count(dev)
    if args.mode:
        cfg.model.text_encoder_mode = "table" if args.mode == "decoupled" else "head"
    # the data source is recorded in the config (a snapshot's config.json is
    # the record of what a run trained on); --set data.* still wins
    cfg.data.data_dir = args.data_dir
    if args.synthetic:
        cfg.data.dataset = "synthetic"
    if args.obs_dir:
        cfg.obs.dir = args.obs_dir
    cfg.apply_overrides(args.overrides)

    if args.dp_epsilon > 0:
        cfg.privacy.enabled = True
        cfg.privacy.epsilon = args.dp_epsilon
        if cfg.model.text_encoder_mode == "table":
            # decoupled path: reference-parity noise-only mechanism (the
            # reference's sigma-from-Opacus + unclipped noise, client.py:87-89,
            # 271-281 — carries no rigorous epsilon)
            cfg.privacy.mechanism = "ldp_news"
            print("[run] decoupled mode: using ldp_news (reference-parity, no rigorous "
                  "epsilon); use --mode joint for real DP-SGD", file=sys.stderr)
    # what the Trainer would refuse, before the data loads
    refuse_unported(cfg)
    seq_world = None
    if cfg.fed.seq_shards > 1:
        from fedrec_tpu_torch.parallel.mesh import check_seq_layout

        check_seq_layout(cfg)
        if args.agg_server:
            print("[run] --agg-server runs one single-client worker; fed.seq_shards>1 is not "
                  "supported there", file=sys.stderr)
            return 2
        if _SEQ_SEAT is None:
            return _run_seq_world(argv, cfg.fed.seq_shards)
        from fedrec_tpu_torch.parallel.mesh import seq_group
        from fedrec_tpu_torch.parallel.multihost import initialize_distributed

        rank, size, address = _SEQ_SEAT
        if dev.type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
        seq_world = seq_group(cfg, initialize_distributed(address, size, rank))
    lead = seq_world is None or seq_world.rank == 0

    if cfg.data.dataset == "synthetic":
        data = make_synthetic_from_args(args, cfg)
    else:
        # "mind" and "adressa" share the artifact schema
        data = load_mind_artifacts(cfg.data.data_dir)

    token_path = args.token_states or str(Path(cfg.data.data_dir) / "token_states.npy")
    if cfg.model.text_encoder_mode == "finetune":
        # the trunk trains in the loop over data.news_tokens: no cached states
        token_states = None
    elif Path(token_path).exists():
        # mapped, not read: the trainer uploads the table in chunks, and
        # several workers on one host share the page cache
        token_states = np.load(token_path, mmap_mode="c")
    else:
        if lead:
            print(f"[run] no cached token states at {token_path}; using random states "
                  "(smoke mode)", file=sys.stderr)
        token_states = np.random.default_rng(0).standard_normal(
            (data.num_news, data.title_len, cfg.model.bert_hidden)
        ).astype(np.float32)

    if args.dp_epsilon > 0:
        cfg.privacy.sigma = calibrate_from_config(cfg, len(data.train_samples))
        if lead:
            print(f"[run] DP enabled: eps={cfg.privacy.epsilon} delta={cfg.privacy.delta} "
                  f"sigma={cfg.privacy.sigma:.4f} clip={cfg.privacy.clip_norm}", file=sys.stderr)

    if args.agg_server:
        rc, history = _run_async_worker(args, cfg, data, token_states, dev)
        if rc:
            return rc
    else:
        trainer = Trainer(cfg, data, token_states, device=dev, seq_group=seq_world)
        history = trainer.run()
    if history and history[-1].val_metrics and lead:
        m = history[-1].val_metrics
        print(
            f"final: loss={history[-1].train_loss:.4f} "
            f"auc={m.get('auc', float('nan')):.4f} "
            f"ndcg10={m.get('ndcg10', float('nan')):.4f}"
        )
    return 0


def _run_async_worker(args, cfg, data, token_states, dev):
    """One worker of the async deployment: ``(0, round history)``, or ``(75,
    None)`` when the authority stayed unreachable. The trainer stays in
    flat mode (its one-client sync is the identity; the buffered commit is
    the authority's): ``agg.mode=async`` is the in-process knob, not this
    path. Prints the worker's ``report`` line at the end."""
    import json

    import torch

    from fedrec_tpu_torch.agg.worker import run_async_worker
    from fedrec_tpu_torch.cli.coordinator import _process_start_wall
    from fedrec_tpu_torch.obs.fleet import set_fleet_identity
    from fedrec_tpu_torch.ops import launch_counts
    from fedrec_tpu_torch.parallel.rpc import AuthorityUnreachable
    from fedrec_tpu_torch.train.trainer import Trainer

    started_at = _process_start_wall()
    # the worker id on every span, snapshot, record and wire envelope
    set_fleet_identity(worker=str(args.worker_id))
    if cfg.obs.dir:
        # the per-worker layout of the fleet's artifacts
        cfg.obs.dir = str(Path(cfg.obs.dir) / f"worker_{args.worker_id}")
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(cfg, data, token_states, device=dev)
    # the wire faults: a seeded chaos proxy in front of the authority, which
    # this worker dials through; no spec, no proxy
    proxy = None
    if cfg.chaos.wire_faults:
        if not cfg.chaos.enabled:
            raise ValueError("wire fault injection requires chaos.enabled=true "
                             "(chaos.wire_faults is part of the chaos plan)")
        from fedrec_tpu_torch.fed.chaos import ChaosProxy, WireFaultPlan

        up_host, up_port = args.agg_server.rsplit(":", 1)
        proxy = ChaosProxy(up_host, int(up_port),
                           plan=WireFaultPlan(cfg.chaos.wire_faults, seed=cfg.chaos.wire_seed))
        proxy.start()
        print(f"[run] chaos wire proxy {proxy.address} -> {args.agg_server} "
              f"({cfg.chaos.wire_faults})", file=sys.stderr)
    report: dict = {"worker": str(args.worker_id), "started_at": started_at}
    try:
        history = run_async_worker(trainer, proxy.address if proxy else args.agg_server,
                                   str(args.worker_id), report=report)
    except AuthorityUnreachable as e:
        print(f"[run] {e}", file=sys.stderr)
        return e.returncode, None
    finally:
        if proxy is not None:
            proxy.stop()
            report["wire_faults_injected"] = dict(proxy.injected)
    if on_card:
        torch.cuda.synchronize(dev)
    report.update({
        "rounds": [r.round_idx for r in history],
        "losses": [r.train_loss for r in history],
        "launches": launch_counts(),
        "peak_gpu_mb": torch.cuda.max_memory_allocated(dev) / 2**20 if on_card else None,
        "val_metrics": history[-1].val_metrics if history else {},
    })
    print(f"[agg-worker {args.worker_id}] report {json.dumps(report)}", flush=True)
    return 0, history


if __name__ == "__main__":
    sys.exit(main())
