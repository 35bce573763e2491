"""Renyi-DP accountant for the subsampled Gaussian mechanism: a copy of
``fedrec_tpu/privacy/accountant.py``, which imports only ``math`` and numpy
(the port never imports the JAX package). Same functions, same arithmetic,
so ``calibrate_from_config`` gives the same sigma for the same config.

Math (Mironov 2017, "Renyi Differential Privacy"; Mironov-Talwar-Zhang 2019,
"Renyi Differential Privacy of the Sampled Gaussian Mechanism"):

  * Gaussian mechanism with noise multiplier sigma at integer Renyi order
    alpha: RDP(alpha) = alpha / (2 sigma^2).
  * Poisson-subsampled Gaussian with sampling rate q, integer alpha:
      RDP(alpha) <= 1/(alpha-1) * log( sum_{k=0..alpha}
          C(alpha,k) (1-q)^(alpha-k) q^k exp((k^2 - k) / (2 sigma^2)) )
    computed in log space for stability.
  * Composition over T steps adds RDP linearly.
  * Conversion to (epsilon, delta)-DP uses the improved bound
    (Balle et al. 2020 as used by Opacus/TF-privacy):
      eps = rdp - (log(delta) + log(alpha)) / (alpha - 1) + log1p(-1/alpha)
    minimized over orders.

``calibrate_sigma`` binary-searches sigma for a target epsilon — the native
equivalent of Opacus' ``make_private_with_epsilon`` noise calibration
(reference ``client.py:271-281``, with C=2, delta=1e-5, EPOCHS=50 defaults
from ``client.py:220-224``). ``sampling_profile`` reads
``fed.population`` through ``getattr``: the port's config has no
population, so it takes the fixed-world branch.
"""

from __future__ import annotations

import math

import numpy as np

DEFAULT_ORDERS = tuple(range(2, 65)) + (80, 96, 128, 256, 512)


def _log_binom(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def compute_rdp_subsampled_gaussian(
    q: float, sigma: float, steps: int, orders: tuple[int, ...] = DEFAULT_ORDERS
) -> np.ndarray:
    """Total RDP at each integer order after ``steps`` compositions."""
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    if not 0 < q <= 1:
        raise ValueError("sampling rate q must be in (0, 1]")
    rdp = np.zeros(len(orders))
    for i, alpha in enumerate(orders):
        if q == 1.0:
            rdp[i] = alpha / (2 * sigma**2)
        else:
            # log-sum-exp over the binomial expansion
            log_terms = [
                _log_binom(alpha, k)
                + (alpha - k) * math.log1p(-q)
                + (k * math.log(q) if k > 0 else 0.0)
                + (k * k - k) / (2 * sigma**2)
                for k in range(alpha + 1)
            ]
            m = max(log_terms)
            log_sum = m + math.log(sum(math.exp(t - m) for t in log_terms))
            rdp[i] = log_sum / (alpha - 1)
    return rdp * steps


def compute_epsilon(
    q: float,
    sigma: float,
    steps: int,
    delta: float,
    orders: tuple[int, ...] = DEFAULT_ORDERS,
) -> float:
    """(epsilon, delta)-DP guarantee after ``steps`` subsampled-Gaussian steps."""
    if not 0 < delta < 1:
        raise ValueError("delta must be in (0, 1)")
    rdp = compute_rdp_subsampled_gaussian(q, sigma, steps, orders)
    eps = np.array(
        [
            r - (math.log(delta) + math.log(a)) / (a - 1) + math.log1p(-1.0 / a)
            for r, a in zip(rdp, orders)
        ]
    )
    return float(np.min(eps))


def calibrate_sigma(
    target_epsilon: float,
    delta: float,
    sample_rate: float,
    steps: int,
    orders: tuple[int, ...] = DEFAULT_ORDERS,
    sigma_min: float = 1e-2,
    sigma_max: float = 1e4,
    tol: float = 1e-4,
) -> float:
    """Smallest sigma achieving ``epsilon <= target_epsilon`` at ``delta``.

    Native replacement for Opacus' ``get_noise_multiplier`` path inside
    ``make_private_with_epsilon`` (reference ``client.py:271-281``).
    """
    if target_epsilon <= 0:
        raise ValueError("target_epsilon must be positive")
    if compute_epsilon(sample_rate, sigma_max, steps, delta, orders) > target_epsilon:
        raise ValueError("target_epsilon unattainable even at sigma_max")
    lo, hi = sigma_min, sigma_max
    # ensure lo is infeasible (eps too big) so the invariant holds
    if compute_epsilon(sample_rate, lo, steps, delta, orders) <= target_epsilon:
        return lo
    while hi - lo > tol * max(1.0, lo):
        mid = 0.5 * (lo + hi)
        if compute_epsilon(sample_rate, mid, steps, delta, orders) <= target_epsilon:
            hi = mid
        else:
            lo = mid
    return hi


def sampling_profile(cfg, n_train: int) -> tuple[float, int]:
    """The ONE definition of ``(q, steps_per_epoch)`` for the accountant —
    calibration and the spend-side schedule must agree or the budget
    silently diverges.

    Fixed-world (no ``fed.population``): every client trains every round,
    so the only subsampling is the batch draw — ``q = B / per_client``
    with ``per_client = n_train // fed.num_clients``.

    Sampled-world (``fed.population.num_clients`` above the slot count):
    privacy is amplified TWICE — a client's data only enters a round when
    the client is sampled (``q_client = slots / population``, the
    per-round cohort fraction; over-selected spares never exceed the slot
    count so this bounds the participating fraction), and within a
    selected round only a batch of its shard is touched
    (``q_batch = B / shard_size``). The two Poisson subsamplings compose
    multiplicatively: ``q = q_client * q_batch`` — accounting each step at
    the batch-level constant alone would overstate the privacy spend of a
    sampled run by the full cohort fraction. Step counts are per SELECTED
    round: ``shard_size // B`` steps per local epoch.
    """
    n_train = max(int(n_train), 1)
    pop = getattr(cfg.fed, "population", None)
    pop_n = int(getattr(pop, "num_clients", 0) or 0)
    if pop_n > cfg.fed.num_clients:
        if getattr(pop, "sampler", "uniform") != "uniform":
            raise ValueError(
                "privacy amplification-by-subsampling assumes a UNIFORM "
                f"cohort draw; fed.population.sampler={pop.sampler!r} "
                "biases per-client selection probability, so q = slots/"
                "population would understate epsilon for over-selected "
                "clients. Use sampler=uniform when privacy is enabled."
            )
        shard = max(n_train // pop_n, 1)
        q_batch = min(1.0, cfg.data.batch_size / shard)
        q_client = cfg.fed.num_clients / pop_n
        q = min(1.0, q_client * q_batch)
        steps_per_epoch = max(shard // cfg.data.batch_size, 1)
        return q, steps_per_epoch
    per_client = max(n_train // cfg.fed.num_clients, 1)
    q = min(1.0, cfg.data.batch_size / per_client)
    steps_per_epoch = max(per_client // cfg.data.batch_size, 1)
    return q, steps_per_epoch


def round_epsilon_schedule(cfg, n_train: int):
    """``rounds_done -> epsilon`` for the run's actual step cadence.

    The spend side of the accountant: where :func:`calibrate_from_config`
    answers "what sigma meets the budget", this answers "how much of the
    (epsilon, delta) budget has round k consumed" — the number the
    Trainer publishes as the ``privacy.epsilon_spent`` gauge each round
    (docs/OBSERVABILITY.md).  Same ``q`` and steps-per-epoch definitions
    as calibration, so the trajectory's final value is comparable to the
    configured target.  Requires ``cfg.privacy.sigma`` > 0 (calibrated
    or explicit); results are memoized — one accountant evaluation per
    new round, not per metric snapshot.
    """
    sigma = cfg.privacy.sigma
    if sigma <= 0:
        raise ValueError(
            "privacy.sigma not set; calibrate it (calibrate_from_config) "
            "before asking for a spent-epsilon schedule"
        )
    q, steps_per_epoch = sampling_profile(cfg, n_train)
    steps_per_round = steps_per_epoch * cfg.fed.local_epochs
    delta = cfg.privacy.delta
    cache: dict[int, float] = {}

    def spent(rounds_done: int) -> float:
        rounds_done = int(rounds_done)
        if rounds_done <= 0:
            return 0.0
        if rounds_done not in cache:
            cache[rounds_done] = compute_epsilon(
                q, sigma, steps_per_round * rounds_done, delta
            )
        return cache[rounds_done]

    return spent


def calibrate_from_config(cfg, n_train: int) -> float:
    """Sigma for ``cfg.privacy`` given the total training-sample count.

    One shared definition of the sample rate ``q`` and accountant step
    count (:func:`sampling_profile` — population-aware: client sampling
    amplifies ``q`` by the per-round cohort fraction) — the CLI drivers
    and the accuracy loop must agree or their privacy budgets silently
    diverge.
    """
    q, steps_per_epoch = sampling_profile(cfg, n_train)
    return calibrate_sigma(
        cfg.privacy.epsilon,
        cfg.privacy.delta,
        q,
        steps_per_epoch * cfg.privacy.accountant_epochs,
    )
