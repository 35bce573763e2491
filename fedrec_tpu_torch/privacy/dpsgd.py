"""Gradient noise for local DP, the port of ``fedrec_tpu/privacy/dpsgd.py``.

The noise is drawn on the device from the client's own noise generator
(``ClientState.noise_generator``) before any cross-client sync (local-DP
semantics). The JAX step splits the client's key into a dropout key and a
noise key; the port gives noise a generator of its own, so that turning
noise on leaves every dropout mask, and so the user tower's trajectory,
unchanged.

  * ``ldp_news`` — reference behavioural parity: unclipped Gaussian noise
    ``N(0, sigma^2)`` on the news-embedding gradients only (reference
    ``client.py:87-89``); the user tower's gradients pass through untouched.
    Ported.
  * ``dpsgd`` — per-example clip to C, average, then ``N(0, (sigma C /
    B)^2)`` on every trainable gradient. Not ported: ``make_noise_fn``
    refuses it by name (``ROADMAP.md`` Queue A item 6).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fedrec_tpu_torch.config import PrivacyConfig

# a tensor, or a sequence of tensors (one client's gradients of a tower)
Grads = torch.Tensor | Sequence[torch.Tensor]


def add_gaussian_noise(grads: Grads, generator: torch.Generator, std: float) -> Grads:
    """``grads + std * N(0, 1)``, leaf by leaf in order, each draw from
    ``generator`` (on the leaves' device)."""
    if torch.is_tensor(grads):
        noise = torch.randn(grads.shape, generator=generator, device=grads.device,
                            dtype=grads.dtype)
        return grads + std * noise
    return [add_gaussian_noise(g, generator, std) for g in grads]


def make_noise_fn(privacy: PrivacyConfig, batch_size: int) -> Callable | None:
    """The noise hook of the train step, or None when privacy is off.

    Returns ``noise_fn(grads_tuple, generator) -> grads_tuple``: the tuple's
    first element is the user tower's gradients, which ``ldp_news`` leaves
    alone; every later element (the text head's gradients in joint mode, the
    candidate and history vectors' gradients in decoupled mode) gets raw
    ``sigma`` noise. ``sigma <= 0`` raises, as in the JAX package;
    ``dpsgd`` raises ``NotImplementedError``. ``batch_size`` scales the
    dpsgd std (``sigma C / B``) in the JAX package; it is kept for that
    signature.
    """
    if not privacy.enabled:
        return None
    sigma = privacy.sigma
    if sigma <= 0:
        raise ValueError(
            "privacy.sigma not set; calibrate with fedrec_tpu_torch.privacy.calibrate_sigma"
        )
    if privacy.mechanism == "dpsgd":
        raise NotImplementedError(
            "privacy.enabled with privacy.mechanism='dpsgd' (per-example clipping) is not "
            "ported to fedrec_tpu_torch yet (ROADMAP.md's Queue A item 6); "
            "mechanism='ldp_news' is"
        )
    if privacy.mechanism == "ldp_news":

        def noise_fn(grads: tuple, generator: torch.Generator) -> tuple:
            user_g, *news_parts = grads
            return (user_g, *(add_gaussian_noise(g, generator, sigma) for g in news_parts))

        return noise_fn

    raise ValueError(f"unknown privacy mechanism {privacy.mechanism!r}")


def make_ldp_news_noise_fn(sigma: float) -> Callable:
    """Convenience: reference-parity news-grad noise with explicit sigma."""
    cfg = PrivacyConfig(enabled=True, sigma=sigma, mechanism="ldp_news")
    return make_noise_fn(cfg, batch_size=1)
