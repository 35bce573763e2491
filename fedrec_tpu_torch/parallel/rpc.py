"""The wire clients' failure handling, the port of
``fedrec_tpu/parallel/rpc.py``: retries, deadlines and a circuit breaker in
front of the one-shot JSON-lines exchange (``obs.fleet.request_json_line``,
a single attempt that raises ``OSError`` on any transport failure).

* :func:`backoff_delay_s`: full-jitter exponential backoff,
  ``U(0, min(cap, base * 2^attempt))``. The jitter matters as much as the
  exponent: a restarted authority must not meet every worker's retry in one
  synchronized stampede.
* :class:`RpcPolicy`: the dial and read deadlines (a dead host fails in
  ``connect_timeout_s``, a slow fold gets the whole ``read_timeout_s``), a
  per-op attempt budget (``op_attempts`` overrides ``attempts``) and the
  backoff, built from the ``agg.worker_*`` fields.
* :class:`CircuitBreaker`: after ``threshold`` consecutive transport
  failures the edge opens and calls fail at once (no dial deadline spent)
  until ``reset_s`` has passed; then one half-open probe closes or re-opens
  it.
* :class:`FleetRpc`: one edge's retrying client. Transport failures
  (``OSError``) are retried inside the budget; an application error reply
  (``ValueError``) is not: the peer is alive and answered.
  :meth:`FleetRpc.unreachable_for` is the caller's degrade clock: the async
  worker trains on within ``agg.worker_unreachable_budget_s`` of silence,
  then raises :class:`AuthorityUnreachable` and exits :data:`RC_DEGRADED`.
* :func:`new_push_id`: the idempotency token of one push, reused verbatim on
  every retry, so the authority's ledger folds it at most once.

The edge's counters go to the port's registry: ``wire.retries_total``
(re-attempts after a transport failure), ``wire.circuit_open_total``
(closed to open) and ``wire.circuit_state`` (0 closed, 1 half-open, 2
open), labelled by peer. The module imports no torch.
"""

from __future__ import annotations

import random
import time
import uuid
from dataclasses import dataclass, field

__all__ = [
    "RC_DEGRADED",
    "AuthorityUnreachable",
    "CircuitBreaker",
    "CircuitOpen",
    "FleetRpc",
    "RpcPolicy",
    "backoff_delay_s",
    "new_push_id",
]

# EX_TEMPFAIL, the supervisor's retryable exit code: a worker that runs out
# of its unreachable budget exits with it, to be respawned against the
# restarted authority
RC_DEGRADED = 75


class AuthorityUnreachable(RuntimeError):
    """The wire stayed dead past the caller's budget: training on would
    pile up staleness no commit can fold, so the worker exits
    ``RC_DEGRADED``."""

    returncode = RC_DEGRADED


class CircuitOpen(OSError):
    """A refusal while the edge's breaker is open: an ``OSError``, so every
    retry and degrade path treats it as the transport failure it stands
    for."""


def backoff_delay_s(
    attempt: int,
    base_ms: float = 50.0,
    max_ms: float = 2000.0,
    rng: random.Random | None = None,
) -> float:
    """Full-jitter exponential backoff (AWS-style): a delay drawn from
    ``U(0, min(max_ms, base_ms * 2^attempt))``, in seconds."""
    cap = min(float(max_ms), float(base_ms) * (2.0 ** max(int(attempt), 0)))
    u = rng.uniform(0.0, cap) if rng is not None else random.uniform(0.0, cap)
    return u / 1e3


def new_push_id(worker: str, round_idx: int) -> str:
    """The idempotency token of one contribution push: made once for a
    (worker, round) contribution and reused on every retry, so a duplicated
    delivery can never double the worker's weight."""
    return f"{worker}:{int(round_idx)}:{uuid.uuid4().hex[:12]}"


@dataclass
class RpcPolicy:
    """One edge's failure handling (``agg.worker_*``)."""

    connect_timeout_s: float = 5.0    # the dial's deadline
    read_timeout_s: float = 60.0      # the exchange's socket deadline
    attempts: int = 4                 # attempts an op, by default
    backoff_base_ms: float = 50.0
    backoff_max_ms: float = 2000.0
    # per-op budgets over `attempts` (a poll loop that retries itself
    # runs `global` on one)
    op_attempts: dict = field(default_factory=dict)
    breaker_threshold: int = 5        # consecutive failures before it opens
    breaker_reset_s: float = 10.0     # open -> half-open
    seed: int | None = None           # the jitter stream

    def attempts_for(self, op: str) -> int:
        return max(1, int(self.op_attempts.get(op, self.attempts)))


class CircuitBreaker:
    """Closed, then open after ``threshold`` consecutive failures; open
    refuses at once for ``reset_s``; then one half-open probe goes through
    and its outcome closes or re-opens the circuit."""

    def __init__(self, threshold: int = 5, reset_s: float = 10.0):
        self.threshold = max(int(threshold), 1)
        self.reset_s = float(reset_s)
        self.consec_failures = 0
        self.opens = 0                 # closed -> open transitions
        self._opened_at: float | None = None
        self._probing = False

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._probing or time.monotonic() - self._opened_at >= self.reset_s:
            return "half-open"
        return "open"

    def allow(self) -> bool:
        """Whether a call may go out now. In the half-open window the first
        caller is the probe; the others fail fast until it is answered."""
        if self._opened_at is None:
            return True
        if self._probing:
            return False
        if time.monotonic() - self._opened_at >= self.reset_s:
            self._probing = True
            return True
        return False

    def success(self) -> None:
        self.consec_failures = 0
        self._opened_at = None
        self._probing = False

    def failure(self) -> None:
        self.consec_failures += 1
        was_open = self._opened_at is not None
        if self._probing or (not was_open and self.consec_failures >= self.threshold):
            # a failed probe re-opens with a fresh window; a closed breaker
            # at the threshold opens
            if not was_open:
                self.opens += 1
            self._opened_at = time.monotonic()
            self._probing = False


class FleetRpc:
    """The retrying JSON-lines client of one edge (host:port) over
    ``obs.fleet.request_json_line``, with the policy's backoff, deadlines
    and breaker. One instance a worker, so its counters are the worker's."""

    def __init__(self, host: str, port: int, policy: RpcPolicy | None = None):
        self.host = str(host)
        self.port = int(port)
        self.policy = policy or RpcPolicy()
        self._rng = random.Random(self.policy.seed)
        self.breaker = CircuitBreaker(self.policy.breaker_threshold,
                                      self.policy.breaker_reset_s)
        self._born = time.monotonic()
        self.last_ok: float | None = None   # monotonic time of the last answer
        self.ok = 0
        self.errors = 0
        self.retries = 0
        self.op_errors: dict[str, int] = {}
        self.op_ok: dict[str, int] = {}

    @property
    def peer(self) -> str:
        return f"{self.host}:{self.port}"

    def _m_retry(self, op: str) -> None:
        from fedrec_tpu_torch.obs.registry import get_registry

        get_registry().counter(
            "wire.retries_total",
            "request re-attempts after a transport failure per edge (0 on a healthy wire)",
            labels=("peer", "op"),
        ).inc(peer=self.peer, op=op)

    def _m_breaker(self, opened: bool) -> None:
        from fedrec_tpu_torch.obs.registry import get_registry

        reg = get_registry()
        if opened:
            reg.counter(
                "wire.circuit_open_total",
                "circuit-breaker closed->open transitions per edge",
                labels=("peer",),
            ).inc(peer=self.peer)
        reg.gauge(
            "wire.circuit_state",
            "circuit-breaker state per edge: 0 closed, 1 half-open, 2 open",
            labels=("peer",),
        ).set({"closed": 0.0, "half-open": 1.0, "open": 2.0}[self.breaker.state],
              peer=self.peer)

    def unreachable_for(self) -> float:
        """Seconds since the last answer on this edge (since construction
        when none came yet): the degrade clock."""
        anchor = self.last_ok if self.last_ok is not None else self._born
        return time.monotonic() - anchor

    def call(self, req: dict, op: str | None = None) -> dict:
        """One exchange with retries. Raises ``OSError`` once the attempts
        are spent (at once while the breaker is open) and ``ValueError`` on
        an application error reply, which is never retried."""
        from fedrec_tpu_torch.obs.fleet import request_json_line

        op = op or str(req.get("cmd", "req"))
        budget = self.policy.attempts_for(op)
        last_err: OSError | None = None
        for attempt in range(budget):
            if not self.breaker.allow():
                self.errors += 1
                self.op_errors[op] = self.op_errors.get(op, 0) + 1
                self._m_breaker(opened=False)
                raise CircuitOpen(
                    f"circuit open for {self.peer} (op={op}): "
                    f"{self.breaker.consec_failures} consecutive failures, "
                    f"probing again in <= {self.breaker.reset_s:g}s")
            try:
                resp = request_json_line(
                    self.host, self.port, req, timeout_s=self.policy.read_timeout_s, op=op,
                    connect_timeout_s=self.policy.connect_timeout_s)
            except OSError as e:
                last_err = e
                before = self.breaker.opens
                self.breaker.failure()
                self.errors += 1
                self.op_errors[op] = self.op_errors.get(op, 0) + 1
                self._m_breaker(opened=self.breaker.opens > before)
                if attempt + 1 < budget and self.breaker.state != "open":
                    self.retries += 1
                    self._m_retry(op)
                    time.sleep(backoff_delay_s(attempt, self.policy.backoff_base_ms,
                                               self.policy.backoff_max_ms, self._rng))
                    continue
                raise
            except ValueError:
                # the peer answered: alive for the breaker and the degrade
                # clock, but the error is the caller's
                self.breaker.success()
                self.last_ok = time.monotonic()
                self._m_breaker(opened=False)
                raise
            self.breaker.success()
            self.ok += 1
            self.op_ok[op] = self.op_ok.get(op, 0) + 1
            self.last_ok = time.monotonic()
            self._m_breaker(opened=False)
            return resp
        raise last_err if last_err is not None else OSError(f"no attempt budget for op {op!r}")
