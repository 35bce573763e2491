#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``fedrec_tpu_torch``).

Builds the port's CUDA kernels from ``fedrec_tpu_torch/ops/csrc``, holds
each against its plain PyTorch version on the card, then drives the serving
main path at full width through the entry points a user calls: corpus
encode of a 65,536-news catalog of seeded frozen-trunk token states
(50 x 768, kernel A), publish, ``ServingService.warmup`` and a JSON-lines
TCP server answering a few hundred requests (kernel B on every batch).

Every phase prints one JSON line; any failure exits non-zero without the
final result line. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Needs one CUDA device; imports nothing of JAX or of ``fedrec_tpu``.

Usage:
  python3 chip_smoke.py                           # every phase
  python3 chip_smoke.py --phases build,kernels    # kernels only
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import subprocess
import sys
import time
import traceback

import numpy as np

PHASES = ("device", "build", "kernels", "main_path")
DEV = "cuda"

# Published peaks (data sheets): FP32 outside the tensor cores, dense bf16
# tensor-core rate, HBM bandwidth. Bounds use the row of the card in use.
_PEAKS = {
    "H100 PCIe": {"f32": 51.2e12, "bf16": 756e12, "bytes": 2.0e12},
    "H100": {"f32": 67e12, "bf16": 989e12, "bytes": 3.35e12},   # SXM
    "H200": {"f32": 67e12, "bf16": 989e12, "bytes": 4.8e12},
}

# f32 tolerance: kernel and plain version sum the same f32 products in
# different orders (reductions of length <= 768 over O(1) values), which
# moves results by ~1e-6; 1e-4 leaves room without hiding a wrong term.
F32_ATOL = 1e-4
# bf16: both round at the same points, but a different summation order can
# flip one bf16 rounding (2**-8 relative) and carry it on: the JAX band.
BF16_ATOL, BF16_RTOL = 0.15, 0.05

KERNEL_META = {
    "additive_pool": {
        "source": "fedrec_tpu_torch/ops/csrc/additive_pool.cu",
        "replaces": "fedrec_tpu/ops/attention_kernels.py:537",
    },
    "fused_history_score": {
        "source": "fedrec_tpu_torch/ops/csrc/fused_history_score.cu",
        "replaces": "fedrec_tpu/ops/fused_hot_path.py:457",
    },
}


class SmokeFailure(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def peaks_for(name: str) -> dict:
    for key in ("H100 PCIe", "H200", "H100"):
        if all(part in name for part in key.split()):
            return dict(_PEAKS[key], table_row=key)
    return dict(_PEAKS["H100"], table_row="H100 (card not in table)")


def bound(flops: float, nbytes: float, peak_ops: float, peaks: dict) -> tuple[float, str]:
    t_ops = flops / peak_ops * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pool_cost(n: int, L: int, D: int, hd: int, itemsize: int) -> tuple[float, float]:
    """FLOPs and bytes of additive_pool on (n, L, D) with hidden hd."""
    flops = n * L * (2 * D * hd + 2 * hd + 2 * D) + n * L * hd  # products + bias
    nbytes = n * L * D * itemsize + (D * hd + 2 * hd) * 4 + n * D * itemsize
    return flops, nbytes


def hist_cost(n: int, H: int, D: int, Q: int, nh: int, C: int, itemsize: int):
    """FLOPs and bytes of fused_history_score on n rows of (H, D)."""
    dh = D // nh
    per_row = (
        3 * 2 * H * D * D          # q, k, v projections
        + nh * 2 * 2 * H * H * dh  # scores and a . v per head
        + 2 * H * D * Q + 2 * H * Q  # pool hidden and logits
        + 2 * H * D + 2 * C * D    # user vector and candidate scores
    )
    weights = (3 * D * D + 3 * D + D * Q + 2 * Q) * itemsize
    nbytes = n * (H * D + C * D + D + C) * itemsize + n * H * 4 + weights
    return n * per_row, nbytes


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max()) if a.numel() else 0.0


def within(got, want, dtype) -> tuple[bool, float, str]:
    import torch

    err = max_err(got, want)
    if dtype == torch.float32:
        return err <= F32_ATOL, err, f"atol {F32_ATOL}"
    ok = bool(((got.float() - want.float()).abs()
               <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
    return ok, err, f"atol {BF16_ATOL} rtol {BF16_RTOL}"


# ------------------------------------------------------------------ phases
def phase_device(state: dict) -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    check(smi.returncode == 0 and bool(smi.stdout.strip()), f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    # full-f32 products and convolutions: TF32 keeps about 3 decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state["peaks"] = peaks_for(name)
    return {
        "kind": name,
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi_line,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn": torch.backends.cudnn.allow_tf32},
        "peaks": state["peaks"],
    }


def phase_build(state: dict) -> dict:
    from fedrec_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    return {
        "wall_s": time.perf_counter() - t0,
        "nvcc_s": secs,
        "libraries": {n: _build.library_path(n) for n in secs},
        "flags": " ".join(_build.NVCC_FLAGS),
    }


def _pool_weights(gen, D: int, hd: int):
    import torch

    dev = DEV
    w1 = torch.randn((D, hd), generator=gen, device=dev) / math.sqrt(D)
    b1 = torch.randn((hd,), generator=gen, device=dev) * 0.02
    w2 = torch.randn((hd,), generator=gen, device=dev) / math.sqrt(hd)
    return w1, b1, w2


def _tower_weights(gen, D: int, Q: int):
    import torch
    from fedrec_tpu_torch.ops import UserTowerWeights

    dev = DEV
    lim = math.sqrt(6.0 / (2 * D))  # xavier-uniform bound of a (D, D) kernel

    def uni(shape):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * lim

    def small(shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.02

    return UserTowerWeights(
        uni((D, D)), small((D,)), uni((D, D)), small((D,)), uni((D, D)), small((D,)),
        torch.randn((D, Q), generator=gen, device=dev) / math.sqrt(D), small((Q,)),
        torch.randn((Q,), generator=gen, device=dev) / math.sqrt(Q),
    )


def _mask(gen, n: int, L: int, kind: str):
    import torch

    if kind == "none":
        return None
    m = (torch.rand((n, L), generator=gen, device=DEV) > 0.3).float()
    m[:, 0] = 1.0
    if kind == "fully_masked_row" and n > 1:
        m[1] = 0.0
    return m.contiguous()


def phase_kernels(state: dict, args) -> dict:
    import torch
    from fedrec_tpu_torch.ops import (
        additive_pool,
        additive_pool_plain,
        fused_history_score,
        fused_history_score_plain,
    )

    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    peaks = state["peaks"]
    checks, failures = [], []

    def record(kernel, shape, dtype, mask_kind, ok, err, tol, extra=""):
        row = {"kernel": kernel, "shape": shape, "dtype": str(dtype).split(".")[-1],
               "mask": mask_kind, "max_abs_err": err, "tol": tol, "ok": ok}
        checks.append(row)
        if not ok:
            failures.append(row)

    # ---- kernel A at (4096, 50, 768), hidden 384
    n, L, D, hd = args.pool_rows, 50, 768, 384
    x32 = torch.randn((n, L, D), generator=gen, device=DEV)
    w1, b1, w2 = _pool_weights(gen, D, hd)
    for kind in ("none", "partial", "fully_masked_row"):
        mask = _mask(gen, n, L, kind)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            got = additive_pool(x, w1, b1, w2, mask)
            want = additive_pool_plain(x, w1, b1, w2, mask)
            torch.cuda.synchronize()
            ok, err, tol = within(got, want, dt)
            if kind == "fully_masked_row":
                ok = ok and bool((got[1] == 0).all())
            record("additive_pool", [n, L, D], dt, kind, ok, err, tol)
    del x32

    # timing at the main path's launch shape: one 2048-row chunk, f32
    n_t = args.chunk
    xt = torch.randn((n_t, L, D), generator=gen, device=DEV)
    a_ms = time_ms(lambda: additive_pool(xt, w1, b1, w2), reps=10)
    a_plain = time_ms(lambda: additive_pool_plain(xt, w1, b1, w2), reps=5)
    a_bf = xt.to(torch.bfloat16)
    a_ms_bf16 = time_ms(lambda: additive_pool(a_bf, w1, b1, w2), reps=10)
    flops, nbytes = pool_cost(n_t, L, D, hd, 4)
    a_bound, a_by = bound(flops, nbytes, peaks["f32"], peaks)
    flops_bf, nbytes_bf = pool_cost(n_t, L, D, hd, 2)
    a_bound_bf16, _ = bound(flops_bf, nbytes_bf, peaks["bf16"], peaks)
    del xt, a_bf
    state["timing"] = {"additive_pool": {
        "shape": [n_t, L, D], "dtype": "float32", "ms": a_ms, "plain_ms": a_plain,
        "bound_ms": a_bound, "bound_by": a_by, "library_ms": None,
        "bf16_ms": a_ms_bf16, "bf16_bound_ms": a_bound_bf16,
    }}

    # ---- kernel B at every serving bucket, H=50, D=400, 20 heads, Q=200
    H, D, Q, nh = 50, 400, 200, 20
    w32 = _tower_weights(gen, D, Q)
    for b in (1, 8, 32, 128):
        x32 = torch.randn((b, H, D), generator=gen, device=DEV)
        c32 = torch.randn((b, 5, D), generator=gen, device=DEV)
        for c in (0, 5):
            for kind in ("none", "fully_masked_row"):
                mask = _mask(gen, b, H, kind if b > 1 else "partial")
                for dt in (torch.float32, torch.bfloat16):
                    x, w = x32.to(dt), w32.to(dt)
                    cand = c32.to(dt) if c else None
                    sk, uk = fused_history_score(x, cand, mask, w, nh)
                    sp, up = fused_history_score_plain(x, cand, mask, w, nh)
                    torch.cuda.synchronize()
                    ok, err, tol = within(uk, up, dt)
                    if c:
                        ok_s, err_s, _ = within(sk, sp, dt)
                        ok, err = ok and ok_s, max(err, err_s)
                    record("fused_history_score", [b, H, D, c], dt, kind, ok, err, tol)
    b_times = {}
    for b in (1, 8, 32, 128):
        x = torch.randn((b, H, D), generator=gen, device=DEV)
        k_ms = time_ms(lambda: fused_history_score(x, None, None, w32, nh), reps=50)
        p_ms = time_ms(lambda: fused_history_score_plain(x, None, None, w32, nh), reps=20)
        flops, nbytes = hist_cost(b, H, D, Q, nh, 0, 4)
        bms, by = bound(flops, nbytes, peaks["f32"], peaks)
        b_times[b] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by}
    state["timing"]["fused_history_score"] = dict(
        b_times[128], shape=[128, H, D, 0], dtype="float32", library_ms=None,
        by_bucket=b_times,
    )
    check(not failures, f"kernel checks failed: {failures}")
    return {"checks": checks, "timing": state["timing"]}


async def _drive_server(service, args, num_news: int, rng) -> dict:
    from fedrec_tpu_torch.serving import start_server

    server = await start_server(service, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port, limit=1 << 20)
    sent, responses, rtt_ms = {}, {}, []
    rid = 0
    try:
        for wave in args.waves:
            t0 = {}
            for _ in range(wave):
                k = int(rng.integers(1, 51))
                hist = rng.integers(1, num_news, size=k).tolist() + [0] * (50 - k)
                sent[rid] = hist
                t0[rid] = time.perf_counter()
                writer.write((json.dumps({"id": rid, "history": hist}) + "\n").encode())
                rid += 1
            await writer.drain()
            for _ in range(wave):
                line = await asyncio.wait_for(reader.readline(), timeout=120)
                resp = json.loads(line)
                responses[resp.get("id")] = resp
                if resp.get("id") in t0:
                    rtt_ms.append((time.perf_counter() - t0[resp["id"]]) * 1e3)
        writer.write(b'{"cmd": "metrics"}\n')
        await writer.drain()
        metrics = json.loads(await asyncio.wait_for(reader.readline(), timeout=60))["metrics"]
    finally:
        writer.close()
        await writer.wait_closed()
        server.close()
        await server.wait_closed()
        await service.stop()
    return {"sent": sent, "responses": responses, "rtt_ms": rtt_ms, "metrics": metrics}


def _plain_recommend(model, table, hist, top_k: int):
    """The served batch again through plain versions only: plain user tower,
    f32 catalog product, pad/history masking, top k+1 (for the score gaps)."""
    import torch
    from fedrec_tpu_torch.ops import fused_history_score_plain

    enc = model.user_encoder
    n = table.shape[0]
    his = table[hist.clamp(0, n - 1)]
    _, user = fused_history_score_plain(his, None, None, enc.fused_weights(his.dtype), enc.num_heads)
    scores = user.float() @ table.float().T
    invalid = torch.zeros_like(scores, dtype=torch.bool)
    invalid[:, 0] = True
    rows = torch.arange(hist.shape[0], device=hist.device)[:, None]
    invalid[rows, hist.clamp(0, n - 1)] = True
    scores = scores.masked_fill(invalid, torch.finfo(torch.float32).min)
    return torch.topk(scores, top_k + 1, dim=1)


def _scorer_breakdown(scorer, user_tower, hist, reps: int) -> dict:
    """Device time by kernel and the device's busy share over ``reps``
    scorer calls (torch.profiler; each call ends in a host read-back)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    scorer(user_tower, hist)[0].cpu()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            scorer(user_tower, hist)[0].cpu()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        dev_us = float(getattr(ev, "self_device_time_total", 0.0))
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us / reps, ev.count / reps))
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    return {
        "wall_ms_per_call_profiled": wall_us / reps / 1e3,
        "device_ms_per_call": busy_us / 1e3,
        "device_busy_share": busy_us * reps / wall_us if wall_us else None,
        "top": [{"kernel": k[:90], "us_per_call": us, "launches_per_call": c}
                for k, us, c in rows[:8]],
    }


def phase_main_path(state: dict, args) -> dict:
    import torch
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.models.attention import dense
    from fedrec_tpu_torch.ops import additive_pool_plain, launch_counts, reset_launch_counts
    from fedrec_tpu_torch.params import init_params
    from fedrec_tpu_torch.serve import build_recommend_fn
    from fedrec_tpu_torch.serving import EmbeddingStore, ServingService
    from fedrec_tpu_torch.train.step import encode_all_news

    cfg = ExperimentConfig().apply_overrides(
        ["model.fuse_hot_path=true", "model.use_pallas=true"]
    )
    mc = cfg.model
    N, L, top_k = args.num_news, cfg.data.max_title_len, 10
    dev = torch.device(DEV)
    model = init_params(NewsRecommender(mc), seed=args.seed).to(dev).eval()
    # seeded frozen-trunk token states, made on the card chunk by chunk
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    tokens = torch.empty((N, L, mc.bert_hidden), device=dev)
    for s in range(0, N, args.chunk):
        tokens[s:s + args.chunk].normal_(generator=gen)
    torch.cuda.synchronize()

    # ---------------- the main path, with every launch count from 0
    reset_launch_counts()
    t0 = time.perf_counter()
    table = encode_all_news(model, tokens, chunk=args.chunk, device=dev)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    store = EmbeddingStore()
    store.publish(table, model.user_encoder, source="synthetic")
    service = ServingService(store, history_len=cfg.data.max_his_len, top_k=top_k, device=dev)
    t0 = time.perf_counter()
    service.warmup()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(args.seed)
    run = asyncio.run(_drive_server(service, args, N, rng))
    torch.cuda.synchronize()
    launches = launch_counts()
    # ---------------- end of the main path

    check(table.shape == (N, mc.news_dim) and bool(torch.isfinite(table).all()),
          f"news table {tuple(table.shape)} not finite/(N, {mc.news_dim})")
    sent, responses = run["sent"], run["responses"]
    check(len(responses) == len(sent) >= 256, f"{len(responses)} responses to {len(sent)} requests")
    bad = []
    for rid, hist in sent.items():
        r = responses.get(rid, {})
        ids, sc = r.get("ids", []), r.get("scores", [])
        clicked = set(hist)
        if ("error" in r or len(ids) != top_k or 0 in ids or clicked & set(ids)
                or any(a < b for a, b in zip(sc, sc[1:])) or r.get("generation") != 0):
            bad.append({"id": rid, "resp": r})
    check(not bad, f"{len(bad)} bad responses, first: {bad[:2]}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} never launched on the main path")

    # ---- the kernel path against the plain versions on the same inputs
    # kernel A: the first chunk of the table again through the plain pool
    th = model.text_head
    with torch.no_grad():
        x0 = tokens[: args.chunk]
        pooled = additive_pool_plain(
            x0, th.pool.att_fc1.weight.t().contiguous(), th.pool.att_fc1.bias,
            th.pool.att_fc2.weight[0].contiguous(),
        )
        plain_vecs = dense(th.fc, pooled, torch.float32)
    err_a = max_err(table[: args.chunk], plain_vecs)
    check(err_a <= F32_ATOL, f"corpus encode vs plain: max err {err_a} > {F32_ATOL}")
    # kernel B: the last full wave's histories, scorer vs plain recompute
    last = sorted(sent)[-128:]
    hist = torch.tensor([sent[i] for i in last], device=dev)
    fn = build_recommend_fn(top_k=top_k, device=dev)
    ids_k, sc_k = fn(model.user_encoder, table, hist)
    sc_p, ids_p = _plain_recommend(model, table, hist, top_k)
    with torch.no_grad():
        his = table[hist]
        w = model.user_encoder.fused_weights(his.dtype)
        from fedrec_tpu_torch.ops import fused_history_score, fused_history_score_plain
        u_k = fused_history_score(his, None, None, w, mc.num_heads)[1]
        u_p = fused_history_score_plain(his, None, None, w, mc.num_heads)[1]
    err_b = max_err(u_k, u_p)
    err_scores = max_err(sc_k, sc_p[:, :top_k])
    check(err_b <= F32_ATOL, f"user vectors vs plain: max err {err_b} > {F32_ATOL}")
    check(err_scores <= F32_ATOL, f"top-k scores vs plain: max err {err_scores} > {F32_ATOL}")
    gaps = (sc_p[:, :-1] - sc_p[:, 1:]).abs()                      # (B, k)
    left = torch.cat([torch.full_like(gaps[:, :1], float("inf")), gaps[:, :-1]], 1)
    decided = (gaps > F32_ATOL) & (left > F32_ATOL)
    served = torch.tensor([responses[i]["ids"] for i in last], device=dev)
    mismatch = int((decided & (ids_k.long() != ids_p[:, :top_k])).sum())
    mismatch_served = int((decided & (served != ids_p[:, :top_k])).sum())
    check(mismatch == 0 and mismatch_served == 0,
          f"top-k ids differ from plain where scores are apart: {mismatch} (scorer), "
          f"{mismatch_served} (served)")
    state["main_errs"] = {"additive_pool": err_a, "fused_history_score": err_b}
    state["launches"] = launches

    # ---- per-bucket scorer time (host clock to results on the host)
    scorer = service._fn_for(store.current())
    bucket_ms = {}
    for b in service.batcher.batch_sizes:
        hb = torch.from_numpy(rng.integers(1, N, size=(b, cfg.data.max_his_len)).astype(np.int32))
        times = []
        for _ in range(args.scorer_reps):
            t0 = time.perf_counter()
            scorer(model.user_encoder, hb)[0].cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        bucket_ms[b] = float(np.median(times))
    sizes = service.batcher.batch_sizes
    breakdown = {
        b: _scorer_breakdown(
            scorer, model.user_encoder,
            torch.from_numpy(rng.integers(1, N, size=(b, cfg.data.max_his_len)).astype(np.int32)),
            reps=args.scorer_reps,
        )
        for b in (sizes[0], sizes[-1])
    }
    lat = np.asarray([r["latency_ms"] for r in responses.values()], np.float64)
    rtt = np.asarray(run["rtt_ms"], np.float64)
    return {
        "config": {"num_news": N, "title_len": L, "bert_hidden": mc.bert_hidden,
                   "news_dim": mc.news_dim, "num_heads": mc.num_heads,
                   "head_dim": mc.head_dim, "query_dim": mc.query_dim,
                   "history": cfg.data.max_his_len, "dtype": mc.dtype,
                   "fuse_hot_path": mc.fuse_hot_path, "use_pallas": mc.use_pallas,
                   "top_k": top_k, "chunk": args.chunk},
        "corpus_encode_ms": encode_ms,
        "warmup_ms": warmup_ms,
        "requests": len(sent),
        "batches_by_size": run["metrics"].get("batches_by_size"),
        "mean_occupancy": run["metrics"].get("mean_occupancy"),
        "scorer_ms_by_bucket": bucket_ms,
        "scorer_device_breakdown": breakdown,
        "server_latency_ms": {"p50": float(np.percentile(lat, 50)),
                              "p99": float(np.percentile(lat, 99))},
        "client_rtt_ms": {"p50": float(np.percentile(rtt, 50)),
                          "p99": float(np.percentile(rtt, 99))},
        "launches": launches,
        "max_abs_err": {"table_vs_plain": err_a, "user_vs_plain": err_b,
                        "topk_scores_vs_plain": err_scores},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def kernels_line(state: dict) -> dict:
    out = []
    for name, meta in KERNEL_META.items():
        t = state["timing"][name]
        out.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": state["launches"][name],
            "max_abs_err": state["main_errs"][name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "dtype": t["dtype"],
        })
    return {"kernels": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ",".join(PHASES))
    p.add_argument("--num-news", type=int, default=65536)
    p.add_argument("--chunk", type=int, default=2048)
    p.add_argument("--pool-rows", type=int, default=4096,
                   help="rows of the additive_pool check against its plain version")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--waves", default="1,1,1,1,8,8,8,32,32,128,128,200",
                   help="requests sent together, wave after wave")
    p.add_argument("--scorer-reps", type=int, default=20)
    args = p.parse_args(argv)
    args.waves = [int(w) for w in args.waves.split(",")]
    phases = [ph for ph in args.phases.split(",") if ph]
    unknown = set(phases) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")
    if "main_path" in phases and "kernels" not in phases:
        p.error("main_path needs the kernels phase (it reports the kernels' times)")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 2
    try:
        import fedrec_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the fedrec_tpu_torch package is not here: {e}", file=sys.stderr)
        return 3

    state: dict = {}
    runners = {
        "device": lambda: phase_device(state),
        "build": lambda: phase_build(state),
        "kernels": lambda: phase_kernels(state, args),
        "main_path": lambda: phase_main_path(state, args),
    }
    for ph in ["device", *[q for q in PHASES[1:] if q in phases]]:
        t0 = time.perf_counter()
        try:
            result = runners[ph]()
        except Exception as e:  # noqa: BLE001 — report the phase, then fail the run
            traceback.print_exc()
            emit({"phase": ph, "ok": False, "error": f"{type(e).__name__}: {e}"[:4000]})
            return 1
        emit({"phase": ph, "ok": True, "seconds": time.perf_counter() - t0, **result})
    if "main_path" in phases:
        emit(kernels_line(state))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
