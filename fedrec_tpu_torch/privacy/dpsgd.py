"""DP-SGD primitives and gradient noise for local DP, the port of
``fedrec_tpu/privacy/dpsgd.py``.

The noise is drawn on the device from the client's own noise generator
(``ClientState.noise_generator``) before any cross-client sync (local-DP
semantics). The JAX step splits the client's key into a dropout key and a
noise key; the port gives noise a generator of its own, so that turning
noise on leaves every dropout mask, and so the user tower's trajectory,
unchanged.

  * ``ldp_news`` — reference behavioural parity: unclipped Gaussian noise
    ``N(0, sigma^2)`` on the news-embedding gradients only (reference
    ``client.py:87-89``); the user tower's gradients pass through untouched.
  * ``dpsgd`` — the honest mechanism: per-example gradients
    (``torch.func.vmap`` of ``torch.func.grad_and_value``), each example's
    global norm clipped to C, averaged, then ``N(0, (sigma C / B)^2)`` on
    every trainable gradient (``per_example_clipped_grads`` and the
    ``dpsgd`` noise hook).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree

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


def per_example_global_norms(per_example_grads: Any) -> torch.Tensor:
    """(B,) global gradient norm per example (f32): the quantity DP-SGD
    clips against, and the one the health sentry's clip-rate is defined
    over. Every leaf has a leading batch axis."""
    leaves = pytree.tree_leaves(per_example_grads)
    return torch.sqrt(sum(x.float().square().reshape(x.shape[0], -1).sum(1) for x in leaves))


def _apply_clip(per_example_grads: Any, norms: torch.Tensor, clip_norm: float) -> Any:
    """The one clip body: scale each example's tree so that its global norm
    is <= clip_norm, given the per-example norms (shared by the standalone
    helper and the DP-SGD estimator)."""
    scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0)  # (B,)
    return pytree.tree_map(
        lambda x: x * scale.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1)), per_example_grads)


def clip_by_global_norm_per_example(per_example_grads: Any, clip_norm: float) -> Any:
    """Scale each example's gradient tree to global norm <= clip_norm; the
    leaves have a leading batch axis."""
    return _apply_clip(per_example_grads, per_example_global_norms(per_example_grads), clip_norm)


def per_example_clipped_grads(
    per_example_loss_fn: Callable[..., torch.Tensor],
    params: Any,
    batch_args: tuple,
    clip_norm: float,
    with_stats: bool = False,
) -> tuple:
    """The mean of the per-example clipped gradients (the DP-SGD estimator).

    ``per_example_loss_fn(params, *example_args) -> scalar`` is mapped
    (``torch.func.vmap`` of ``torch.func.grad_and_value``) over the leading
    axis of every element of ``batch_args``; ``params`` is a tree (dicts,
    lists, tuples) of tensors, shared by every example. Returns
    ``(mean_loss, mean_clipped_grads)`` with the gradients in ``params``'s
    structure; the noise is the caller's (it needs the generator and the B
    divisor).

    ``with_stats=True`` appends ``{"clip_rate", "max_norm"}``: the fraction
    of the batch whose pre-clip norm exceeded C, and the largest pre-clip
    norm (the health sentry's DP surface).
    """
    grad_fn = torch.func.vmap(
        torch.func.grad_and_value(per_example_loss_fn),
        in_dims=(None,) + (0,) * len(batch_args),
    )
    grads, losses = grad_fn(params, *batch_args)
    norms = per_example_global_norms(grads)  # (B,)
    clipped = _apply_clip(grads, norms, clip_norm)
    mean_grads = pytree.tree_map(lambda x: x.mean(0), clipped)
    if not with_stats:
        return losses.mean(), mean_grads
    stats = {
        "clip_rate": (norms > clip_norm).float().mean(),
        "max_norm": norms.max(),
    }
    return losses.mean(), mean_grads, stats


def make_noise_fn(privacy: PrivacyConfig, batch_size: int) -> Callable | None:
    """The noise hook of the train step, or None when privacy is off.

    Returns ``noise_fn(grads_tuple, generator) -> grads_tuple``. For
    ``dpsgd`` every element gets ``N(0, (sigma C / B)^2)`` noise (noise on
    the mean of B clipped per-example gradients), with ``B = batch_size``.
    For ``ldp_news`` the tuple's first element, the user tower's gradients,
    passes through untouched, and every later element (the text head's
    gradients in joint mode, the candidate and history vectors' gradients in
    decoupled mode) gets raw ``sigma`` noise. ``sigma <= 0`` raises, as in
    the JAX package.
    """
    if not privacy.enabled:
        return None
    sigma = privacy.sigma
    if sigma <= 0:
        raise ValueError(
            "privacy.sigma not set; calibrate with fedrec_tpu_torch.privacy.calibrate_sigma"
        )
    if privacy.mechanism == "dpsgd":
        std = sigma * privacy.clip_norm / batch_size

        def noise_fn(grads: tuple, generator: torch.Generator) -> tuple:
            return tuple(add_gaussian_noise(g, generator, std) for g in grads)

        return noise_fn

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
