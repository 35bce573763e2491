"""News text head and user encoder, the port of ``fedrec_tpu/models/encoders.py``.

``TextHead`` maps the frozen trunk's (..., L, bert_hidden) token states to a
news vector: additive pooling (kernel A under ``use_pallas``) and a Dense
to ``news_dim``. ``UserEncoder`` maps (..., H, news_dim) clicked-news
vectors to a user vector: dropout, then either the dense chain
(``MultiHeadAttention`` on the route ``attn_impl`` picks, then
``AdditiveAttention``: kernels F1-F3 and A2 for a long history under
``use_pallas``) or, with ``fuse``
(``model.fuse_hot_path``), kernel B (``ops.fused_history_score``, with
kernel E as its backward), which also scores candidates when they are
passed. Both routes hold the same parameters under the same names, so one
checkpoint drives either.
"""

from __future__ import annotations

import torch
from torch import nn

from fedrec_tpu_torch.models.attention import AdditiveAttention, MultiHeadAttention, dense
from fedrec_tpu_torch.ops import UserTowerWeights, fused_history_score


def dropout(
    x: torch.Tensor, rate: float, train: bool, generator: torch.Generator | None = None
) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1 / (1 - rate)``; identity unless training with
    ``rate > 0``. The keep mask comes from ``generator`` (else the global
    stream), so each federated client draws from its own."""
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return apply_dropout_mask(x, keep, rate)


def apply_dropout_mask(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """``dropout``'s arithmetic with a keep mask drawn beforehand (the
    per-example DP-SGD step draws its masks outside the transform)."""
    keep_prob = 1.0 - rate
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class TextHead(nn.Module):
    """(..., L, bert_hidden) token states -> (..., news_dim) news vector."""

    def __init__(
        self,
        news_dim: int = 400,
        bert_hidden: int = 768,
        stable_softmax: bool = True,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
    ):
        super().__init__()
        # reference AdditiveAttention(hidden, hidden // 2), no token mask
        self.pool = AdditiveAttention(
            bert_hidden, bert_hidden // 2, stable_softmax, dtype, use_pallas
        )
        self.fc = nn.Linear(bert_hidden, news_dim)
        self.dtype = dtype

    def forward(
        self, token_states: torch.Tensor, mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        return dense(self.fc, self.pool(token_states, mask), self.dtype)


class UserEncoder(nn.Module):
    """(..., H, news_dim) clicked-news vectors -> (..., news_dim) user vector.

    ``fuse=True`` routes everything after the dropout through kernel B and,
    when ``cand_vecs`` is given, returns ``(user, scores)``. Dropout draws its
    keep mask from ``generator`` when one is given (a client's own stream).
    """

    def __init__(
        self,
        news_dim: int = 400,
        num_heads: int = 20,
        head_dim: int = 20,
        query_dim: int = 200,
        dropout_rate: float = 0.2,
        stable_softmax: bool = True,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        fuse: bool = False,
        attn_impl: str = "auto",
        chunk_threshold: int = 1024,
    ):
        super().__init__()
        self.self_attn = MultiHeadAttention(
            news_dim, num_heads, head_dim, stable_softmax, dtype, use_pallas,
            attn_impl, chunk_threshold,
        )
        self.pool = AdditiveAttention(
            num_heads * head_dim, query_dim, stable_softmax, dtype, use_pallas
        )
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.fused = fuse and stable_softmax
        self._packed: tuple | None = None

    def fused_weights(self, dtype: torch.dtype) -> UserTowerWeights:
        """Kernel B's nine operands in the (in, out) layout and ``dtype``.

        With autograd on and a parameter that wants a gradient (training),
        they are differentiable views of the live parameters, rebuilt on
        every call. Otherwise (serving) they are packed once under
        ``no_grad`` and rebuilt only when a parameter changed (its storage or
        in-place version)."""
        a, p = self.self_attn, self.pool
        params = (
            a.w_q.weight, a.w_q.bias, a.w_k.weight, a.w_k.bias, a.w_v.weight,
            a.w_v.bias, p.att_fc1.weight, p.att_fc1.bias, p.att_fc2.weight,
        )

        def pack():
            return UserTowerWeights(
                a.w_q.weight.t(), a.w_q.bias, a.w_k.weight.t(), a.w_k.bias,
                a.w_v.weight.t(), a.w_v.bias, p.att_fc1.weight.t(),
                p.att_fc1.bias, p.att_fc2.weight[0],
            ).to(dtype)

        if torch.is_grad_enabled() and any(t.requires_grad for t in params):
            return pack()
        key = (dtype, *((t.data_ptr(), t._version) for t in params))
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                self._packed = (key, pack())
        return self._packed[1]

    def forward(
        self,
        clicked_vecs: torch.Tensor,
        mask: torch.Tensor | None = None,
        train: bool = False,
        cand_vecs: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ):
        if cand_vecs is not None and not self.fused:
            raise ValueError(
                "UserEncoder(cand_vecs=...) is the fused-scoring entry; it "
                "requires fuse=True (model.fuse_hot_path) with stable_softmax"
            )
        x = dropout(clicked_vecs, self.dropout_rate, train, generator)
        if self.fused:
            scores, user = fused_history_score(
                x, cand_vecs, mask, self.fused_weights(x.dtype), self.num_heads
            )
            return user if cand_vecs is None else (user, scores)
        x = self.self_attn(x, x, x, mask)
        return self.pool(x, mask)
