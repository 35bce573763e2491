"""Long-lived serving entry point of the port (``fedrec-serve``).

Starts the TCP/JSON-lines service (:mod:`fedrec_tpu_torch.serving`) whose
embedding store can be hot-swapped from new training snapshots while
requests are in flight (``{"cmd": "refresh", ...}`` on any connection).
It serves either a training run's snapshot (``fedrec_tpu_torch.train``'s
``round_<r>/state.pt``) over the reference artifacts' catalog, or a
synthetic catalog: a seeded random (N, news_dim) table and freshly
initialised user-tower weights, so every serving code path runs without a
training artifact (scores are meaningless).

Usage:
  # a training snapshot over the reference UserData layout:
  python -m fedrec_tpu_torch.cli.serve --data-dir UserData --snapshot-dir snapshots
  # synthetic catalog, no artifacts needed:
  python -m fedrec_tpu_torch.cli.serve --synthetic 65536 --port 7607
  # million-item mode: two-stage retrieval past --exact-threshold
  python -m fedrec_tpu_torch.cli.serve --synthetic 1000000 --clusters 1024 --n-probe 64
  # on the CPU, at small widths:
  python -m fedrec_tpu_torch.cli.serve --synthetic 3000 --device cpu \\
      --set model.news_dim=32 --set model.num_heads=4 --set model.head_dim=8
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7607)
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--keep-history", action="store_true",
                   help="allow already-clicked news in responses")
    p.add_argument("--batch-sizes", default="1,8,32,128",
                   help="fixed padded batch buckets (comma-separated)")
    p.add_argument("--flush-ms", type=float, default=2.0,
                   help="max coalescing wait for the oldest pending request")
    p.add_argument("--max-queue", type=int, default=1024,
                   help="queue-depth backpressure threshold")
    p.add_argument("--clusters", type=int, default=0,
                   help="k-means coarse clusters (0 = exact full-catalog scoring)")
    p.add_argument("--n-probe", type=int, default=8, help="clusters reranked per request")
    p.add_argument("--exact-threshold", type=int, default=4096,
                   help="catalogs at/below this size always use exact scoring")
    p.add_argument("--shard-store", action="store_true",
                   help="not ported (the sharded store is ROADMAP Queue A item 9); refused")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="serve a random N-item catalog with fresh-init weights")
    p.add_argument("--data-dir", default="UserData",
                   help="reference UserData artifact layout (the catalog and its id map)")
    p.add_argument("--snapshot-dir", default=None,
                   help="training snapshots (default: train.snapshot_dir)")
    p.add_argument("--token-states", default=None,
                   help="(N, L, bert_hidden) .npy of cached trunk states "
                        "(default <data-dir>/token_states.npy)")
    p.add_argument("--obs-dir", default=None,
                   help="observability artifacts: metrics.jsonl (a record and a registry "
                        "snapshot every --metrics-every), trace.json and prometheus.txt "
                        "at shutdown")
    p.add_argument("--seed", type=int, default=0, help="seed of the synthetic table and weights")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; raises without a GPU unless 'cpu')")
    p.add_argument("--metrics-every", type=float, default=30.0,
                   help="seconds between metric JSON lines on stdout")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="SECTION.KEY=VALUE")
    return p


def synthetic_service(args, cfg):
    """Random catalog + fresh-init user tower: batching, retrieval and
    scoring end to end without any training artifact."""
    from fedrec_tpu_torch.device import resolve_device
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.serving import EmbeddingStore

    dev = resolve_device(args.device)
    model = init_params(NewsRecommender(cfg.model), seed=args.seed).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # an f32 table, as the JAX CLI's: the user tower computes in its dtype
    table = torch.randn((args.synthetic, cfg.model.news_dim), generator=gen, device=dev)
    store = EmbeddingStore()
    store.publish(table, model.user_encoder, source="synthetic")
    return make_service(args, cfg, store)


def checkpoint_service(args, cfg):
    """The newest training snapshot, encoded over the artifacts' catalog
    (kernel A), as generation 0; None (after an error line) when the token
    states are missing."""
    from fedrec_tpu_torch.data import load_mind_artifacts
    from fedrec_tpu_torch.serving import EmbeddingStore, publish_from_checkpoint

    snap_dir = args.snapshot_dir or cfg.train.snapshot_dir
    data = load_mind_artifacts(args.data_dir)
    token_path = args.token_states or str(Path(args.data_dir) / "token_states.npy")
    if not Path(token_path).exists():
        print(f"[serve] ERROR: no token states at {token_path}; export them or pass "
              "--token-states (or use --synthetic for a smoke catalog)", file=sys.stderr)
        return None
    index2nid = {i: n for n, i in data.nid2index.items()}
    valid = np.zeros(data.num_news, bool)
    valid[[i for i in index2nid if 0 <= i < data.num_news]] = True
    store = EmbeddingStore()
    gen = publish_from_checkpoint(store, cfg.model, snap_dir, np.load(token_path),
                                  valid_mask=valid, device=args.device)
    print(f"[serve] generation 0 from {gen.source} round {gen.round}", file=sys.stderr)
    return make_service(args, cfg, store, id_map=index2nid)


def make_service(args, cfg, store, id_map=None):
    from fedrec_tpu_torch.serving import ServingService

    return ServingService(
        store,
        history_len=cfg.data.max_his_len,
        top_k=args.top_k,
        exclude_history=not args.keep_history,
        batch_sizes=tuple(int(b) for b in args.batch_sizes.split(",")),
        flush_ms=args.flush_ms,
        max_queue=args.max_queue,
        num_clusters=args.clusters,
        n_probe=args.n_probe,
        exact_threshold=args.exact_threshold,
        id_map=id_map,
        model_cfg=cfg.model,
        device=args.device,
    )


def build_service(args, cfg):
    """The service ``main`` serves (the synthetic or the checkpoint one),
    with the drift probe armed under ``obs.quality``; None after an error
    line when it cannot be built."""
    if args.shard_store:
        print("[serve] ERROR: --shard-store is not ported to fedrec_tpu_torch (the sharded "
              "store is ROADMAP Queue A item 9)", file=sys.stderr)
        return None
    service = synthetic_service(args, cfg) if args.synthetic else checkpoint_service(args, cfg)
    if service is not None and cfg.obs.quality.enabled and cfg.obs.quality.probe_users > 0:
        # every refresh scores the pinned probe set against both generations
        # first, so a bad table push surfaces in serve.drift_* before it
        # serves traffic
        service.store.enable_drift_probe(num_probes=cfg.obs.quality.probe_users,
                                         topk=cfg.obs.quality.probe_topk,
                                         seed=cfg.obs.quality.seed)
    return service


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.serving import serve_forever

    # full-f32 products on the card: TF32 would keep ~3 decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ExperimentConfig()
    cfg.apply_overrides(args.overrides)
    service = build_service(args, cfg)
    if service is None:
        return 2
    service.warmup()  # every bucket once before accepting traffic
    import os

    from fedrec_tpu_torch.obs import get_tracer
    from fedrec_tpu_torch.obs.fleet import ensure_fleet_identity
    from fedrec_tpu_torch.obs.wire import configure_wire

    # spans are worth their memory only when a trace.json will hold them
    get_tracer().enabled = bool(args.obs_dir)
    # fleet correlation keys: the server's spans and snapshots join a fleet's
    # training artifacts by worker id (FEDREC_WORKER_ID when it sits beside
    # a training worker)
    ensure_fleet_identity(worker=os.environ.get("FEDREC_WORKER_ID") or "serve")
    configure_wire(enabled=cfg.obs.wire.enabled, window=cfg.obs.wire.window)
    if cfg.obs.slo.enabled:
        # heartbeat-cadence watch over the serve.* keys; {"cmd": "alerts"}
        # and fedrec-obs alerts read the same engine
        from fedrec_tpu_torch.obs.watch import Watch

        jsonl = None
        if args.obs_dir:
            Path(args.obs_dir).mkdir(parents=True, exist_ok=True)
            jsonl = str(Path(args.obs_dir) / "metrics.jsonl")
        service.watch = Watch(cfg.obs.slo, cfg.obs.watch, registry=service.registry,
                              jsonl_path=jsonl, jsonl_max_mb=cfg.obs.jsonl_max_mb)
    try:
        asyncio.run(serve_forever(
            service, host=args.host, port=args.port, metrics_every_s=args.metrics_every,
            obs_dir=args.obs_dir, jsonl_max_mb=cfg.obs.jsonl_max_mb,
        ))
    except KeyboardInterrupt:
        print("[serve] interrupted; shutting down", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
