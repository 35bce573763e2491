"""Corpus encode, the port of ``fedrec_tpu/train/step.py:encode_all_news``.
The training step itself comes with the training slice."""

from __future__ import annotations

import torch

from fedrec_tpu_torch.device import resolve_device, torch_dtype
from fedrec_tpu_torch.models import NewsRecommender


@torch.no_grad()
def encode_all_news(
    model: NewsRecommender,
    token_states: torch.Tensor,
    chunk: int = 2048,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """(N, L, bert_hidden) -> (N, news_dim) news-vector table on ``device``
    (default ``cuda``, which raises without a GPU; ``model`` must live
    there), ``chunk`` rows at a time: that bounds the text head's
    activations, as the JAX ``lax.map`` over chunks does, and lets the token
    states stay in host memory, one chunk crossing to the device at a time.
    With ``model.use_pallas`` each chunk is one launch of kernel A."""
    dev = resolve_device(device)
    n = token_states.shape[0]
    # the text head's last Dense computes in the model dtype, as Flax's does
    dtype = torch_dtype(model.cfg.dtype)
    out = torch.empty((n, model.cfg.news_dim), dtype=dtype, device=dev)
    for start in range(0, n, chunk):
        vecs = model.encode_news(token_states[start:start + chunk].to(dev))
        out[start:start + vecs.shape[0]] = vecs
    return out
