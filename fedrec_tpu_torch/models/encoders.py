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
checkpoint drives either. Under a seq world (``seq_group``: the history
holds only this rank's columns) the dense chain takes ``parallel.ring``'s
attention (``seq_impl``) and pool, fusion is off, and the dropout keep mask
is drawn for the whole history and cut to this rank's columns, so the world
draws the masks the unsharded tower would.

The other model families (``model.text_head_arch='cnn'``,
``model.user_tower='gru'``):

* ``CnnTextHead`` (NAML): a SAME-padded width-``kernel`` convolution over
  the token states as one ``(L, kernel * bert_hidden) x (kernel *
  bert_hidden, news_dim)`` product, ReLU, then additive pooling with
  ``news_dim // 2`` hidden units (kernel A under ``use_pallas``). The
  product runs in cuBLAS (TF32 follows ``torch.backends.cuda.matmul``), not
  in cuDNN's convolution.
* ``GRUUserEncoder`` (LSTUR): dropout, a GRU over the click sequence in
  Flax's gate layout, then additive pooling over the hidden states (kernel
  A under ``use_pallas``). The recurrence is plain PyTorch: the input
  projections of every step as one product, then one ``h W_h`` product a
  step, so ``torch.func.vmap`` (per-example DP-SGD) maps it; cuDNN's fused
  RNN has no batching rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedrec_tpu_torch.models.attention import (
    AdditiveAttention,
    MultiHeadAttention,
    dense,
    seq_clone,
)
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


def seq_dropout(x: torch.Tensor, rate: float, train: bool, generator: torch.Generator | None,
                group) -> torch.Tensor:
    """``dropout`` of a (..., L/S, D) history shard of rank r in a seq
    world of S: the keep mask is drawn for the whole (..., L, D) history
    (every rank draws the same, from the same replicated stream) and cut to
    columns ``[r L/S, (r+1) L/S)``."""
    if not train or rate == 0.0:
        return x
    *b, ls, d = x.shape
    keep = torch.rand((*b, ls * group.size, d), generator=generator, device=x.device) < 1.0 - rate
    return apply_dropout_mask(x, keep[..., group.rank * ls:(group.rank + 1) * ls, :], rate)


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
        seq_group=None,
        seq_impl: str = "ring",
    ):
        super().__init__()
        self.self_attn = MultiHeadAttention(
            news_dim, num_heads, head_dim, stable_softmax, dtype, use_pallas,
            attn_impl, chunk_threshold, seq_group, seq_impl,
        )
        self.pool = AdditiveAttention(
            num_heads * head_dim, query_dim, stable_softmax, dtype, use_pallas, seq_group
        )
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.seq_group = seq_group
        # the fused kernel holds the whole history per row: off under a seq world
        self.fused = fuse and stable_softmax and seq_group is None
        self._packed: tuple | None = None

    def seq_parallel(self, group, impl: str = "ring") -> "UserEncoder":
        """A copy sharing this tower's parameters that runs over the seq
        world ``group`` (the JAX step's ``model.clone(seq_axis=...)``)."""
        return seq_clone(self, seq_group=group, fused=False,
                         _modules={**self._modules,
                                   "self_attn": self.self_attn.seq_parallel(group, impl),
                                   "pool": self.pool.seq_parallel(group)})

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
                "requires fuse=True (model.fuse_hot_path) with stable_softmax "
                "and no sequence sharding"
            )
        if self.seq_group is not None:
            x = seq_dropout(clicked_vecs, self.dropout_rate, train, generator, self.seq_group)
        else:
            x = dropout(clicked_vecs, self.dropout_rate, train, generator)
        if self.fused:
            scores, user = fused_history_score(
                x, cand_vecs, mask, self.fused_weights(x.dtype), self.num_heads
            )
            return user if cand_vecs is None else (user, scores)
        x = self.self_attn(x, x, x, mask)
        return self.pool(x, mask)


class CnnTextHead(nn.Module):
    """(..., L, bert_hidden) token states -> (..., news_dim) news vector:
    Flax ``nn.Conv(news_dim, (kernel,), padding="SAME")``, ReLU, additive
    pooling. SAME padding puts ``(kernel - 1) // 2`` zero rows before the
    sequence and ``kernel // 2`` after it (asymmetric for an even kernel).

    ``conv`` is an ``nn.Linear(kernel * bert_hidden, news_dim)`` whose
    weight column ``j * bert_hidden + c`` is tap ``j`` of input channel
    ``c``: the Flax ``(kernel, in, out)`` kernel reshaped to ``(kernel *
    in, out)`` and transposed (``params.from_flax``)."""

    def __init__(
        self,
        news_dim: int = 400,
        bert_hidden: int = 768,
        kernel: int = 3,
        stable_softmax: bool = True,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
    ):
        super().__init__()
        if kernel < 1:
            raise ValueError(f"model.cnn_kernel must be >= 1, got {kernel}")
        self.kernel = kernel
        self.conv = nn.Linear(kernel * bert_hidden, news_dim)
        self.pool = AdditiveAttention(
            news_dim, news_dim // 2, stable_softmax, dtype, use_pallas
        )
        self.dtype = dtype

    def windows(self, token_states: torch.Tensor) -> torch.Tensor:
        """(..., L, H) -> (..., L, kernel * H): each position's SAME-padded
        window, taps in order, in the compute dtype."""
        k = self.kernel
        x = token_states.to(self.dtype)
        x = F.pad(x, (0, 0, (k - 1) // 2, k // 2))
        # (..., L, H, k) -> (..., L, k, H) -> (..., L, k * H)
        win = x.unfold(-2, k, 1).transpose(-1, -2)
        return win.reshape(*win.shape[:-2], -1)

    def forward(
        self, token_states: torch.Tensor, mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        x = torch.relu(dense(self.conv, self.windows(token_states), self.dtype))
        return self.pool(x, mask)


class GRUCell(nn.Module):
    """Flax ``nn.GRUCell``'s parameters: input kernels ``ir``, ``iz``,
    ``in`` with biases, recurrent kernels ``hr`` and ``hz`` without and
    ``hn`` with one. One step is::

        r = sigmoid(W_ir x + b_ir + W_hr h)
        z = sigmoid(W_iz x + b_iz + W_hz h)
        n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
        h' = (1 - z) * n + z * h
    """

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(in_dim, features))
        for name in ("hr", "hz"):
            self.add_module(name, nn.Linear(features, features, bias=False))
        self.add_module("hn", nn.Linear(features, features))
        self.features = features

    def input_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(W, b)`` of the three input projections side by side:
        (3F, in), (3F,), gates in the order r, z, n."""
        lin = [getattr(self, n) for n in ("ir", "iz", "in")]
        return torch.cat([m.weight for m in lin]), torch.cat([m.bias for m in lin])

    def recurrent_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(W, b)`` of the three recurrent projections side by side, the
        bias zero for r and z (Flax's ``hr`` and ``hz`` carry none)."""
        lin = [getattr(self, n) for n in ("hr", "hz", "hn")]
        zeros = torch.zeros(2 * self.features, dtype=self.hn.bias.dtype,
                            device=self.hn.bias.device)
        return torch.cat([m.weight for m in lin]), torch.cat([zeros, self.hn.bias])


def gru_scan(cell: GRUCell, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(N, T, in) -> (N, T, F): the GRU over the time axis from a zero
    carry, as Flax's ``nn.RNN(GRUCell)`` with ``return_carry=False``. The
    products compute in ``dtype`` (Flax's ``Dense(dtype=...)``); the carry
    stays in float32, the parameters' dtype, as Flax's does. Every row runs
    all T steps: JAX's ``seq_lengths`` does not stop the recurrence at a
    row's length or zero its pad outputs, and the pool masks them."""
    w_i, b_i = cell.input_weights()
    w_h, b_h = cell.recurrent_weights()
    w_h, b_h = w_h.to(dtype), b_h.to(dtype)
    # the input projections of all T steps as one product
    xi = F.linear(x.to(dtype), w_i.to(dtype), b_i.to(dtype))
    h = torch.zeros((*x.shape[:-2], cell.features), dtype=torch.promote_types(
        torch.float32, dtype), device=x.device)
    outs = []
    for t in range(x.shape[-2]):
        xr, xz, xn = xi[..., t, :].chunk(3, dim=-1)
        hr, hz, hn = F.linear(h.to(dtype), w_h, b_h).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, dim=-2)


class GRUUserEncoder(nn.Module):
    """(..., H, news_dim) clicked-news vectors -> (..., news_dim) user
    vector: dropout, a GRU over the click sequence (``GRUCell_0``, the Flax
    tree's name), additive pooling over the hidden states with ``mask``
    (``None``, every call site's default, pools every position as the MHA
    tower attends over every position). Has no fused route:
    ``model.fuse_hot_path`` fuses the MHA tower only."""

    def __init__(
        self,
        news_dim: int = 400,
        query_dim: int = 200,
        dropout_rate: float = 0.2,
        stable_softmax: bool = True,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
    ):
        super().__init__()
        self.add_module("GRUCell_0", GRUCell(news_dim, news_dim))
        self.pool = AdditiveAttention(news_dim, query_dim, stable_softmax, dtype, use_pallas)
        self.dropout_rate = dropout_rate
        self.dtype = dtype

    def forward(
        self,
        clicked_vecs: torch.Tensor,
        mask: torch.Tensor | None = None,
        train: bool = False,
        cand_vecs: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ):
        if cand_vecs is not None:
            raise ValueError(
                "GRUUserEncoder has no fused-scoring entry (cand_vecs); "
                "model.fuse_hot_path fuses the MHA user tower only"
            )
        x = dropout(clicked_vecs, self.dropout_rate, train, generator)
        outs = gru_scan(getattr(self, "GRUCell_0"), x, self.dtype)
        return self.pool(outs, mask)
