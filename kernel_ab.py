#!/usr/bin/env python3
"""Time the kernels of one checkout of the port on the card, for A/B runs.

Usage:
  python3 kernel_ab.py [ROOT] [--only text_head|long|pool_flash|bwd|fwd|repeat]
                       [--profile] [--ptxas]
  # ROOT holds fedrec_tpu_torch/ (default: .)

``text_head``: kernels C (``fused_gather_encode``) and D
(``fused_gather_encode_bwd``) at the train path's shape (U = 3,520 ids of a
16,384-row (50, 768) table, Ah = 384, D = 400), f32 and bf16, each with its
largest error against its plain version (D's relative to each gradient's
largest value) and whether a repeat gives the same bits; and a hash of
kernel E's outputs (``fused_history_score_bwd`` at n = 64, H = 50, D = 400,
C = 5), which a change to C and D must leave equal.
``long``: kernel A2 (``additive_pool_long``) at (n, 2048, 400), hidden 200,
for n = 1, 16 and 128, and kernels F1, F2, F3 at the long path's attention
shape (16 x 20 heads, L = 2048, width 20), f32, with a hash of the flash
outputs.
``pool_flash``: kernel A (``additive_pool``) at the corpus encode's chunk
(2048, 50, 768) and the long path's text head (32,848, 50, 768), hidden
384, f32 and bf16; A2 (``additive_pool_long``) at (n, 2048, 400), hidden
200, for n = 16 and 128; F1 (``flash_forward``) at (320, 2048, 20) f32;
each with its largest error against its plain version and whether a repeat
gives the same bits; whether A and A2 agree to the bit at (64, 50, 768);
and a hash of F2's and F3's outputs fed with the plain forward's ``out``
and ``lse`` (so that it compares across trees whose F1 differ).
``bwd``: kernel E (``fused_history_score_bwd``) at the train path's shape
(n = 64, H = 50, D = 400, 20 heads, Q = 200, C = 5) and kernel F3
(``flash_backward_dkv``) at (320, 2048, 20) with a quarter of the keys
masked, f32 and bf16, each with its largest error against its plain
version (relative to each output's largest value; E's key-bias gradient,
whose true value is zero, left out), a hash of its outputs and whether a
repeat gives the same bits; and hashes of F1's and F2's outputs (f32, from the plain forward's
lse) and of C's and D's (f32, U = 3,520 ids of a 4,096-row table), which
must not move.
``fwd``: kernel B (``fused_history_score``) at the serving buckets n = 1, 8,
32, 128 (C = 0) and at the train path's shape (n = 64, C = 5), and kernel
F2 (``flash_backward_dq``) at (320, 2048, 20) and (320, 2048, 32) with a
quarter of the keys masked, f32 and bf16, each with its largest error against its plain version
(F2's relative to its largest value), a hash of its outputs and whether a
repeat gives the same bits; and hashes of E's (f32, the train path's
shape), F1's and F3's (f32, from the plain forward's lse) and C's and D's
outputs, which must not move.
All five by default.
``repeat`` (not in the default): the body of tests/test_torch_gpu.py::
test_flash_attention_module_layout_and_gradients 200 times in one process,
each run after the widths-(128, 20) case of
test_flash_kernels_with_unequal_widths, with the number of distinct output
hashes of the kernel route and of the CPU route.
``--profile``: also the device time of each CUDA kernel that C and D (and,
with ``pool_flash``, A, A2 and F1; with ``bwd``, E; with ``fwd``, B and F2)
launch
(``torch.profiler``), per call.
``--ptxas``: also build ``fused_gather_encode.cu`` (``text_head``),
``additive_pool.cu`` and ``flash_attention.cu`` (``pool_flash``),
``fused_history_score_bwd.cu`` and ``flash_attention.cu`` (``bwd``), or
``fused_history_score.cu`` and ``flash_attention.cu`` (``fwd``), with
``-Xptxas -v`` into ``ROOT/build/kernel_ab/`` and report each kernel's
registers, spills and shared memory, and the ``HMMA`` (tensor-core)
instructions ``cuobjdump -sass`` finds in it.

Times are CUDA-event means. Prints one JSON line (equal hashes: equal
results). To compare two checkouts on one card, run it for both on the same
machine, in turns (a, b, b, a). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path


def time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(fn, reps: int = 5) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = float(getattr(ev, "self_device_time_total", 0.0))
        if us > 0:
            name = ev.key.replace("void ", "").replace("(anonymous namespace)::", "")
            name = re.sub(r"\(.*", "", name)
            out[name] = out.get(name, 0.0) + us / reps / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _template_args(mangled: str) -> list[str]:
    """The template arguments at the start of ``mangled`` (``I...E``):
    f32, bf16, integers and booleans."""
    out, i = [], 1
    if not mangled.startswith("I"):
        return out
    while i < len(mangled) and mangled[i] != "E":
        ch = mangled[i]
        if ch == "L":  # a literal: L<type><value>E
            j = mangled.index("E", i)
            lit = mangled[i + 1:j]
            out.append({"b1": "true", "b0": "false"}.get(lit, lit[1:]))
            i = j + 1
        elif ch.isdigit():  # a type by name: <length><name>
            k = i
            while mangled[k].isdigit():
                k += 1
            name = mangled[k:k + int(mangled[i:k])]
            out.append("bf16" if "bfloat16" in name else name)
            i = k + int(mangled[i:k])
        else:
            out.append({"f": "f32"}.get(ch, ch))
            i += 1
    return out


def _ptxas(root: str, source: str) -> dict:
    """Registers, spills, shared memory and HMMA count of each kernel in
    ``csrc/<source>``, built here with -Xptxas -v."""
    from fedrec_tpu_torch.ops import _build

    src = Path(root) / "fedrec_tpu_torch" / "ops" / "csrc" / source
    out_dir = Path(root) / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{src.stem}_ptxas.so"
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)],
                         capture_output=True, text=True, check=True).stderr

    def short(mangled: str) -> str:
        """A kernel's name and template arguments from its mangled symbol:
        the first length-prefixed name ending in _kernel."""
        for m in re.finditer(r"\d+", mangled):
            # a length prefix may follow other digits (an anonymous namespace's hash)
            lengths = (int(m.group()[i:]) for i in range(len(m.group())))
            name = next((mangled[m.end():m.end() + n] for n in lengths
                         if mangled[m.end():m.end() + n].endswith("_kernel")), "")
            if name:
                args = _template_args(mangled[m.end() + len(name):])
                return f"{name}<{','.join(args)}>" if args else name
        return mangled

    kernels, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = short(m.group(1))
            while name in kernels:  # two instances with one short name
                name += "'"
            cur = kernels[name] = {"mangled": m.group(1)}
        elif cur is not None:
            for key, pat in (("registers", r"Used (\d+) registers"), ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"), ("static_smem", r"(\d+) bytes smem")):
                hit = re.search(pat, line)
                if hit:
                    cur[key] = int(hit.group(1))
    cuobjdump = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = next((k for k, v in kernels.items() if v.get("mangled") == m.group(1)), None)
        elif fn in kernels and "HMMA" in line:
            kernels[fn]["hmma"] = kernels[fn].get("hmma", 0) + 1
    for k in kernels.values():
        k.setdefault("hmma", 0)
    for k in kernels.values():
        k.pop("mangled")
    return kernels


def _text_head(res: dict, rnd, gen, profile: bool) -> None:
    import torch
    from fedrec_tpu_torch.ops import fused_hot_path as fh

    N, T, Dh, Ah, D, U = 16384, 50, 768, 384, 400, 3520
    table32 = rnd(N, T, Dh)
    real = U - U // 64  # the dedup's static slots, padded with id 0
    ids = torch.sort(torch.randperm(N - 1, generator=gen, device="cuda")[:real] + 1).values
    ids = torch.cat([ids, torch.zeros(U - real, dtype=torch.int64, device="cuda")])
    head32 = fh.TextHeadWeights(rnd(Dh, Ah) / math.sqrt(Dh), rnd(Ah) * 0.02,
                                rnd(Ah) / math.sqrt(Ah), rnd(Dh, D) / math.sqrt(Dh),
                                rnd(D) * 0.02)
    g = rnd(U, D)
    g[real:] = 0.0
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        table, head = table32.to(dt), head32.to(dt)
        res[f"C_ms_{tag}"] = time_ms(lambda: fh.fused_gather_encode(table, ids, head), 10)
        res[f"D_ms_{tag}"] = time_ms(lambda: fh.fused_gather_encode_bwd(table, ids, head, g), 5)
        out = fh.fused_gather_encode(table, ids, head)
        res[f"C_err_{tag}"] = float((out.float() - fh.fused_gather_encode_plain(table, ids, head)
                                     .float()).abs().max())
        res[f"C_repeats_{tag}"] = bool(torch.equal(out, fh.fused_gather_encode(table, ids, head)))
        got = fh.fused_gather_encode_bwd(table, ids, head, g)
        want = fh.fused_gather_encode_bwd_plain(table, ids, head, g)
        res[f"D_rel_err_{tag}"] = _rel_err(got, want)
        again = fh.fused_gather_encode_bwd(table, ids, head, g)
        res[f"D_repeats_{tag}"] = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        if profile:
            res[f"C_kernels_ms_{tag}"] = _profile(lambda: fh.fused_gather_encode(table, ids, head))
            res[f"D_kernels_ms_{tag}"] = _profile(lambda: fh.fused_gather_encode_bwd(table, ids, head, g))
        del table, head, out, got, want, again
    del table32
    # kernel E at the train path's shape: its outputs must not move
    x, cand, w, gs, gu = _tower(rnd, gen)
    dx, dcand, dw = fh.fused_history_score_bwd(x, cand, None, w, gs, gu, 20)
    res["E_outputs_sha256"] = _sha((dx, dcand, *dw))


def _tower(rnd, gen):
    """Kernel E's inputs at the train path's shape (n = 64, H = 50, D = 400,
    20 heads, Q = 200, C = 5): x, cand, UserTowerWeights, g_scores, g_user."""
    import torch
    from fedrec_tpu_torch.ops import fused_hot_path as fh

    n, H, Dm, Q, C = 64, 50, 400, 200, 5
    lim = math.sqrt(6.0 / (2 * Dm))  # xavier-uniform bound of a (D, D) kernel

    def uni(*shape):
        return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) * lim

    w = fh.UserTowerWeights(uni(Dm, Dm), rnd(Dm) * 0.02, uni(Dm, Dm), rnd(Dm) * 0.02,
                            uni(Dm, Dm), rnd(Dm) * 0.02, rnd(Dm, Q) / math.sqrt(Dm),
                            rnd(Q) * 0.02, rnd(Q) / math.sqrt(Q))
    x, cand, gs, gu = rnd(n, H, Dm), rnd(n, C, Dm), rnd(n, C), rnd(n, Dm)
    return x, cand, w, gs, gu


def _sha(tensors) -> str:
    """A hash of the tensors' bytes (f32 or bf16), in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _rel_err(got, want) -> float:
    """Largest |got - want| over outputs, each relative to its largest |want|."""
    return max(float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))
               for a, b in zip(got, want) if b is not None and b.numel())


def _bwd(res: dict, rnd, gen, profile: bool) -> None:
    """Kernels E and F3 (this PR's pair) in f32 and bf16, with the hashes of
    C, D, F1 and F2's outputs, which must not move."""
    import torch
    from fedrec_tpu_torch.ops import attention_kernels as ak
    from fedrec_tpu_torch.ops import fused_hot_path as fh

    x32, cand32, w32, gs, gu = _tower(rnd, gen)
    q32, k32, v32, g32 = (rnd(320, 2048, 20) for _ in range(4))
    keep = torch.rand((320, 2048), generator=gen, device="cuda") > 0.25
    keep[:, 0] = True
    bias = torch.where(keep, 0.0, -1e9)
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x, cand, w = x32.to(dt), cand32.to(dt), w32.to(dt)

        def e_call():
            return fh.fused_history_score_bwd(x, cand, None, w, gs, gu, 20)

        res[f"E_ms_{tag}"] = time_ms(e_call, 20)
        got = e_call()
        want = fh.fused_history_score_bwd_plain(x, cand, None, w, gs, gu, 20)
        flat = lambda o: [o[0], o[1], *(t for f, t in zip(fh.UserTowerWeights._fields, o[2]) if f != "bk")]
        res[f"E_rel_err_{tag}"] = _rel_err(flat(got), flat(want))
        res[f"E_outputs_sha256_{tag}"] = _sha((got[0], got[1], *got[2]))
        again = e_call()
        res[f"E_repeats_{tag}"] = bool(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
                                       and all(torch.equal(a, b) for a, b in zip(got[2], again[2])))
        if profile:
            res[f"E_kernels_ms_{tag}"] = _profile(e_call)
        del got, want, again

        q, k, v, g = (t.to(dt) for t in (q32, k32, v32, g32))
        want_out, lse = ak.flash_forward_plain(q, k, v, bias)
        delta = (g.float() * want_out.float()).sum(-1)

        def f3_call():
            return ak.flash_backward_dkv(q, k, v, bias, g, lse, delta)

        res[f"F3_ms_{tag}"] = time_ms(f3_call, 5)
        got = f3_call()
        want = ak.flash_backward_dkv_plain(q, k, v, bias, g, lse, delta)
        res[f"F3_rel_err_{tag}"] = _rel_err(got, want)
        res[f"F3_outputs_sha256_{tag}"] = _sha(got)
        res[f"F3_repeats_{tag}"] = all(bool(torch.equal(a, b)) for a, b in zip(got, f3_call()))
        if dt == torch.float32:
            res["F2_F1_outputs_sha256"] = _sha((ak.flash_backward_dq(q, k, v, bias, g, lse, delta),
                                                *ak.flash_forward(q, k, v, bias)))
        del q, k, v, g, want_out, lse, delta, got, want
        torch.cuda.empty_cache()
    # kernels C and D at the text head's train-path shape (smaller table): must not move
    N, T, Dh, Ah, D, U = 4096, 50, 768, 384, 400, 3520
    table = rnd(N, T, Dh)
    ids = torch.randint(0, N, (U,), generator=gen, device="cuda")
    head = fh.TextHeadWeights(rnd(Dh, Ah) / math.sqrt(Dh), rnd(Ah) * 0.02,
                              rnd(Ah) / math.sqrt(Ah), rnd(Dh, D) / math.sqrt(Dh), rnd(D) * 0.02)
    res["C_D_outputs_sha256"] = _sha((fh.fused_gather_encode(table, ids, head),
                                      *fh.fused_gather_encode_bwd(table, ids, head, rnd(U, D))))


def _fwd(res: dict, rnd, gen, profile: bool) -> None:
    """Kernels B and F2 (this PR's pair) in f32 and bf16, with the hashes of
    E, F1, F3, C and D's outputs, which must not move."""
    import torch
    from fedrec_tpu_torch.ops import attention_kernels as ak
    from fedrec_tpu_torch.ops import fused_hot_path as fh

    x64, cand64, w32, gs, gu = _tower(rnd, gen)
    dx, dcand, dw = fh.fused_history_score_bwd(x64, cand64, None, w32, gs, gu, 20)
    res["E_outputs_sha256"] = _sha((dx, dcand, *dw))
    del dx, dcand, dw
    xs = {n: rnd(n, 50, 400) for n in (1, 8, 32, 128)}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        w = w32.to(dt)
        # the serving buckets (C = 0), then the train path's shape (n = 64, C = 5)
        for key, x, cand in [*((f"n{n}", xs[n].to(dt), None) for n in (1, 8, 32, 128)),
                             ("n64_C5", x64.to(dt), cand64.to(dt))]:
            def b_call():
                return fh.fused_history_score(x, cand, None, w, 20)

            res[f"B_{key}_ms_{tag}"] = time_ms(b_call, 50)
            got = b_call()
            want = fh.fused_history_score_plain(x, cand, None, w, 20)
            res[f"B_{key}_err_{tag}"] = max(float((a.float() - b.float()).abs().max())
                                            for a, b in zip(got, want) if a is not None)
            res[f"B_{key}_outputs_sha256_{tag}"] = _sha([t for t in got if t is not None])
            again = b_call()
            res[f"B_{key}_repeats_{tag}"] = all(bool(torch.equal(a, b)) for a, b in zip(got, again)
                                                if a is not None)
            if profile and key in ("n1", "n128", "n64_C5"):
                res[f"B_{key}_kernels_ms_{tag}"] = _profile(b_call)

    keep = torch.rand((320, 2048), generator=gen, device="cuda") > 0.25
    keep[:, 0] = True
    bias = torch.where(keep, 0.0, -1e9)
    # the user tower's width 20, then 32 (F2's widest padded width at one block of 64 queries)
    for d, name in ((20, "F2"), (32, "F2_w32")):
        q32, k32, v32, g32 = (rnd(320, 2048, d) for _ in range(4))
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v, g = (t.to(dt) for t in (q32, k32, v32, g32))
            want_out, lse = ak.flash_forward_plain(q, k, v, bias)
            delta = (g.float() * want_out.float()).sum(-1)

            def f2_call():
                return ak.flash_backward_dq(q, k, v, bias, g, lse, delta)

            res[f"{name}_ms_{tag}"] = time_ms(f2_call, 5)
            got = f2_call()
            want = ak.flash_backward_dq_plain(q, k, v, bias, g, lse, delta)
            res[f"{name}_rel_err_{tag}"] = _rel_err([got], [want])
            res[f"{name}_outputs_sha256_{tag}"] = _sha([got])
            res[f"{name}_repeats_{tag}"] = bool(torch.equal(got, f2_call()))
            if d == 20 and dt == torch.float32:
                if profile:
                    res["F2_kernels_ms_f32"] = _profile(f2_call)
                res["F1_outputs_sha256"] = _sha(ak.flash_forward(q, k, v, bias))
                res["F3_outputs_sha256"] = _sha(ak.flash_backward_dkv(q, k, v, bias, g, lse, delta))
            del q, k, v, g, want_out, lse, delta, got, want
            torch.cuda.empty_cache()
        del q32, k32, v32, g32
    # kernels C and D at the text head's train-path shape (smaller table): must not move
    N, T, Dh, Ah, D, U = 4096, 50, 768, 384, 400, 3520
    table = rnd(N, T, Dh)
    ids = torch.randint(0, N, (U,), generator=gen, device="cuda")
    head = fh.TextHeadWeights(rnd(Dh, Ah) / math.sqrt(Dh), rnd(Ah) * 0.02,
                              rnd(Ah) / math.sqrt(Ah), rnd(Dh, D) / math.sqrt(Dh), rnd(D) * 0.02)
    res["C_D_outputs_sha256"] = _sha((fh.fused_gather_encode(table, ids, head),
                                      *fh.fused_gather_encode_bwd(table, ids, head, rnd(U, D))))


def _module_case():
    """The inputs of tests/test_torch_gpu.py::
    test_flash_attention_module_layout_and_gradients (B = 2, L = 77, 4 heads
    of width 20, a key mask), drawn as the test draws them."""
    import numpy as np

    rng = np.random.default_rng(0)
    B, L, h, d = 2, 77, 4, 20
    x = [rng.standard_normal((B, L, h, d)) for _ in range(3)]
    m = (rng.random((B, L)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    g = rng.standard_normal((B, L, h, d))
    return x, m, g


def _wide_case(dtype):
    """test_flash_kernels_with_unequal_widths at (dk, dv) = (128, 20): F1,
    F2, F3 at width 128, which leave non-zero values in shared memory."""
    import numpy as np
    import torch
    from fedrec_tpu_torch.ops import attention_kernels as ak

    rng = np.random.default_rng(0)
    bh, L, dk, dv = 3, 130, 128, 20

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dtype)

    q, k = t(rng.standard_normal((bh, L, dk))), t(rng.standard_normal((bh, L, dk)))
    rng.standard_normal((bh, L, dk))
    keep = rng.random((bh, L)) > 0.3
    keep[:, 0] = True
    bias = torch.from_numpy(np.where(keep, 0.0, -1e9)).to("cuda", torch.float32)
    rng.standard_normal((bh, L, dk))
    v, g = t(rng.standard_normal((bh, L, dv))), t(rng.standard_normal((bh, L, dv)))
    out, lse = ak.flash_forward(q, k, v, bias)
    delta = (g.float() * out.float()).sum(-1)
    ak.flash_backward_dq(q, k, v, bias, g, lse, delta)
    ak.flash_backward_dkv(q, k, v, bias, g, lse, delta)


REPEAT_RUNS = 200


def _repeat(res: dict) -> None:
    """The body of test_flash_attention_module_layout_and_gradients
    REPEAT_RUNS times in one process, each run right after the widths-128 case (f32 and
    bf16), the kernel route's outputs (F1's out; F2 and F3's dq, dk, dv) and
    the CPU route's hashed per run: the number of distinct hashes of each,
    and how far each route is from float64 (f32)."""
    import numpy as np
    import torch
    from fedrec_tpu_torch.ops import flash_attention

    x, m, g = _module_case()
    d = x[0].shape[-1]
    q64, k64, v64 = (np.transpose(a, (0, 2, 1, 3)) for a in x)
    s = np.einsum("bhqd,bhkd->bhqk", q64, k64) / np.sqrt(d) + np.where(m > 0, 0.0, -1e9)[:, None, None, :]
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref64 = np.transpose(np.einsum("bhqk,bhkd->bhqd", p, v64), (0, 2, 1, 3))
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        def t(a, dev):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        hashes = {"gpu_out": set(), "gpu_grads": set(), "cpu_out": set(), "cpu_grads": set()}
        worst_gpu, worst_cpu, fails = 0.0, 0.0, 0
        for _ in range(REPEAT_RUNS):
            _wide_case(torch.float32)
            _wide_case(torch.bfloat16)
            leaves = [t(a, "cuda").requires_grad_() for a in x]
            out = flash_attention(*leaves, t(m, "cuda").float())
            grads = torch.autograd.grad(out, leaves, t(g, "cuda"))
            cpu = [t(a, "cpu").requires_grad_() for a in x]
            ref = flash_attention(*cpu, t(m, "cpu").float())
            ref_grads = torch.autograd.grad(ref, cpu, t(g, "cpu"))
            hashes["gpu_out"].add(_sha([out]))
            hashes["gpu_grads"].add(_sha(grads))
            hashes["cpu_out"].add(_sha([ref]))
            hashes["cpu_grads"].add(_sha(ref_grads))
            go, co = out.detach().double().cpu().numpy(), ref.detach().double().numpy()
            if dtype == torch.float32:
                worst_gpu = max(worst_gpu, float(np.abs(go - ref64).max()))
                worst_cpu = max(worst_cpu, float(np.abs(co - ref64).max()))
                fails += int(not np.allclose(go, co, atol=1e-5, rtol=1e-5))
        res[f"repeat_{tag}"] = {
            "runs": REPEAT_RUNS, **{f"distinct_{k}": len(v) for k, v in hashes.items()},
            **({"gpu_out_vs_f64": worst_gpu, "cpu_out_vs_f64": worst_cpu, "runs_off_the_bar": fails}
               if dtype == torch.float32 else {}),
        }


def _long(res: dict, rnd) -> None:
    import torch
    from fedrec_tpu_torch.ops import attention_kernels as ak

    w1, b1, w2 = rnd(400, 200) / 20, rnd(200) * 0.02, rnd(200) / math.sqrt(200)
    for n in (1, 16, 128):
        x = rnd(n, 2048, 400)
        res[f"A2_ms_n{n}"] = time_ms(lambda: ak.additive_pool_long(x, w1, b1, w2), 20)
        out = ak.additive_pool_long(x, w1, b1, w2)
        res[f"A2_err_n{n}"] = float((out - ak.additive_pool_plain(x, w1, b1, w2)).abs().max())
        res[f"A2_repeats_n{n}"] = bool(torch.equal(out, ak.additive_pool_long(x, w1, b1, w2)))
    q, k, v, g = (rnd(320, 2048, 20) for _ in range(4))
    bias = torch.zeros((320, 2048), device="cuda")
    out, lse = ak.flash_forward(q, k, v, bias)
    delta = (g * out).sum(-1)
    res["F1_ms"] = time_ms(lambda: ak.flash_forward(q, k, v, bias), 5)
    res["F2_ms"] = time_ms(lambda: ak.flash_backward_dq(q, k, v, bias, g, lse, delta), 5)
    res["F3_ms"] = time_ms(lambda: ak.flash_backward_dkv(q, k, v, bias, g, lse, delta), 5)
    res["flash_outputs_sha256"] = _sha((out, lse, ak.flash_backward_dq(q, k, v, bias, g, lse, delta),
                                        *ak.flash_backward_dkv(q, k, v, bias, g, lse, delta)))


def _pool_flash(res: dict, rnd, profile: bool) -> None:
    import torch
    from fedrec_tpu_torch.ops import attention_kernels as ak

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    w1, b1, w2 = rnd(768, 384) / math.sqrt(768), rnd(384) * 0.02, rnd(384) / math.sqrt(384)
    for n, tag in ((2048, "chunk"), (32848, "long")):
        x32 = rnd(n, 50, 768)
        for dt, dtag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = x32 if dt == torch.float32 else x32.to(dt)
            key = f"A_{tag}_{dtag}"
            res[f"{key}_ms"] = time_ms(lambda: ak.additive_pool(x, w1, b1, w2), 10 if n < 10000 else 3)
            out = ak.additive_pool(x, w1, b1, w2)
            res[f"{key}_err"] = err(out, ak.additive_pool_plain(x, w1, b1, w2))
            res[f"{key}_repeats"] = bool(torch.equal(out, ak.additive_pool(x, w1, b1, w2)))
            if profile and dt == torch.float32:
                res[f"{key}_kernels_ms"] = _profile(lambda: ak.additive_pool(x, w1, b1, w2), 3)
            del x, out
        del x32
        torch.cuda.empty_cache()
    x = rnd(64, 50, 768)
    res["A_equals_A2_bitwise"] = bool(torch.equal(ak.additive_pool(x, w1, b1, w2),
                                                  ak.additive_pool_long(x, w1, b1, w2)))
    w1, b1, w2 = rnd(400, 200) / 20, rnd(200) * 0.02, rnd(200) / math.sqrt(200)
    for n in (16, 128):
        x = rnd(n, 2048, 400)
        res[f"A2_n{n}_ms"] = time_ms(lambda: ak.additive_pool_long(x, w1, b1, w2), 20)
        out = ak.additive_pool_long(x, w1, b1, w2)
        res[f"A2_n{n}_err"] = err(out, ak.additive_pool_plain(x, w1, b1, w2))
        res[f"A2_n{n}_repeats"] = bool(torch.equal(out, ak.additive_pool_long(x, w1, b1, w2)))
        if profile and n == 16:
            res["A2_n16_kernels_ms"] = _profile(lambda: ak.additive_pool_long(x, w1, b1, w2))
    q, k, v, g = (rnd(320, 2048, 20) for _ in range(4))
    bias = torch.zeros((320, 2048), device="cuda")
    res["F1_ms"] = time_ms(lambda: ak.flash_forward(q, k, v, bias), 10)
    out, lse = ak.flash_forward(q, k, v, bias)
    want_out, want_lse = ak.flash_forward_plain(q, k, v, bias)
    res["F1_err"] = err(out, want_out)
    res["F1_lse_err"] = err(lse, want_lse)
    again = ak.flash_forward(q, k, v, bias)
    res["F1_repeats"] = bool(torch.equal(out, again[0]) and torch.equal(lse, again[1]))
    if profile:
        res["F1_kernels_ms"] = _profile(lambda: ak.flash_forward(q, k, v, bias))
    # F2 and F3 from the plain forward's out and lse: equal in both trees
    delta = (g * want_out).sum(-1)
    res["F2_F3_outputs_sha256"] = _sha((ak.flash_backward_dq(q, k, v, bias, g, want_lse, delta),
                                        *ak.flash_backward_dkv(q, k, v, bias, g, want_lse, delta)))


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root", nargs="?", default=".")
    p.add_argument("--only", choices=("text_head", "long", "pool_flash", "bwd", "fwd", "repeat"))
    p.add_argument("--profile", action="store_true")
    p.add_argument("--ptxas", action="store_true")
    args = p.parse_args(argv)
    root, only = args.root, args.only
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fedrec_tpu_torch.ops import fused_hot_path

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    res = {"module": fused_hot_path.__file__, "card": torch.cuda.get_device_name(0)}
    if only == "repeat":
        _repeat(res)
    if only in (None, "text_head"):
        _text_head(res, rnd, gen, args.profile)
        if args.ptxas:
            res["ptxas"] = _ptxas(root, "fused_gather_encode.cu")
    if only in (None, "long"):
        _long(res, rnd)
    if only in (None, "pool_flash"):
        _pool_flash(res, rnd, args.profile)
        if args.ptxas:
            res["ptxas_pool_flash"] = {src: _ptxas(root, src)
                                       for src in ("additive_pool.cu", "flash_attention.cu")}
    if only in (None, "bwd"):
        _bwd(res, rnd, gen, args.profile)
        if args.ptxas:
            res["ptxas_bwd"] = {src: _ptxas(root, src)
                                for src in ("fused_history_score_bwd.cu", "flash_attention.cu")}
    if only in (None, "fwd"):
        _fwd(res, rnd, gen, args.profile)
        if args.ptxas:
            res["ptxas_fwd"] = {src: _ptxas(root, src)
                                for src in ("fused_history_score.cu", "flash_attention.cu")}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
