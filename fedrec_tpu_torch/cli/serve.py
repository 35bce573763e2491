"""Long-lived serving entry point of the port.

Starts the TCP/JSON-lines service (:mod:`fedrec_tpu_torch.serving`) over a
synthetic catalog: a seeded random (N, news_dim) table and freshly
initialised user-tower weights, so every serving code path runs without a
training artifact (scores are meaningless). Serving from a checkpoint and
the refresh command come with a later slice.

Usage:
  python -m fedrec_tpu_torch.cli.serve --synthetic 65536 --port 7607
  python -m fedrec_tpu_torch.cli.serve --synthetic 3000 --device cpu \\
      --set model.news_dim=32 --set model.num_heads=4 --set model.head_dim=8
"""

from __future__ import annotations

import argparse
import asyncio
import sys

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
                   help="k-means coarse clusters (0 = exact; k-means is not ported yet)")
    p.add_argument("--exact-threshold", type=int, default=4096,
                   help="catalogs at/below this size always use exact scoring")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="serve a random N-item catalog with fresh-init weights")
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


def make_service(args, cfg, store):
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
        exact_threshold=args.exact_threshold,
        device=args.device,
    )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.serving import serve_forever

    # full-f32 products on the card: TF32 would keep ~3 decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ExperimentConfig()
    cfg.apply_overrides(args.overrides)
    if not args.synthetic:
        print("[serve] ERROR: only --synthetic N is ported; checkpoint serving "
              "comes with a later slice", file=sys.stderr)
        return 2
    service = synthetic_service(args, cfg)
    service.warmup()  # every bucket once before accepting traffic
    try:
        asyncio.run(serve_forever(
            service, host=args.host, port=args.port, metrics_every_s=args.metrics_every,
        ))
    except KeyboardInterrupt:
        print("[serve] interrupted; shutting down", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
