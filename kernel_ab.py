#!/usr/bin/env python3
"""Time the long-history kernels of one checkout of the port on the card.

Usage:
  python3 kernel_ab.py [ROOT]    # ROOT holds fedrec_tpu_torch/ (default: .)

Kernel A2 (``additive_pool_long``) at (n, 2048, 400), hidden 200, for n = 1,
16 and 128, and kernels F1, F2, F3 at the long path's attention shape
(16 x 20 heads, L = 2048, width 20), f32, with CUDA events. Prints one JSON
line: ms per launch, A2's largest error against its plain version and
whether a repeat gives the same bits, and a hash of the flash outputs
(equal hashes: equal results). To compare two checkouts on one card, run
it for both on the same machine, in turns (a, b, b, a). Needs a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import math
import sys


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


def main(argv: list[str]) -> int:
    root = argv[0] if argv else "."
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from fedrec_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    res = {"module": ak.__file__, "card": torch.cuda.get_device_name(0)}
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
    h = hashlib.sha256()
    for t in (out, lse, ak.flash_backward_dq(q, k, v, bias, g, lse, delta),
              *ak.flash_backward_dkv(q, k, v, bias, g, lse, delta)):
        h.update(t.cpu().numpy().tobytes())
    res["flash_outputs_sha256"] = h.hexdigest()[:16]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
