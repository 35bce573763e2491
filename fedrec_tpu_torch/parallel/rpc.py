"""The retry shape of the port's wire clients: a copy of
``fedrec_tpu/parallel/rpc.py``'s ``backoff_delay_s``. The rest of that
module (the resilient RPC of the async worker) is ROADMAP.md's Queue A
item 9."""

from __future__ import annotations

import random


def backoff_delay_s(
    attempt: int,
    base_ms: float = 50.0,
    max_ms: float = 2000.0,
    rng: random.Random | None = None,
) -> float:
    """Full-jitter exponential backoff (AWS-style): a delay drawn from
    ``U(0, min(max_ms, base_ms * 2^attempt))``, in seconds. Jitter matters
    as much as the exponent: a restarted server must not meet every
    client's retry in one synchronized stampede."""
    cap = min(float(max_ms), float(base_ms) * (2.0 ** max(int(attempt), 0)))
    u = rng.uniform(0.0, cap) if rng is not None else random.uniform(0.0, cap)
    return u / 1e3
