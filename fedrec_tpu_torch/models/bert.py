"""The DistilBERT trunk and the full text tower, the port of
``fedrec_tpu/models/bert.py``.

``DistilBert`` maps (B, L) token ids and their 0/1 attention mask to
(B, L, dim) token states with the JAX module's arithmetic and order: word +
position embeddings, LayerNorm (eps 1e-12), dropout, then post-LN blocks
whose self-attention divides q by sqrt(head_dim) before QK^T and adds a
``-1e9`` bias on padded keys (an all-padding row, news id 0's, attends
uniformly, as in JAX), and whose FFN uses the exact erf GELU. Submodule
names follow the Flax tree (``word_embeddings``, ``layer_0.attention.q_lin``,
...), so ``params.from_flax`` bridges a JAX trunk by path.

Weights come from a seed (``init_trunk_params``), from a Flax tree
(``params.from_flax``) or from a local HuggingFace checkpoint
(``load_hf_state_dict``: a ``.bin`` through ``torch.load(weights_only=True)``,
a ``.safetensors`` through the short reader below). HF's tensors keep
torch's (out, in) layout, so ``convert_hf_state_dict`` renames and
transposes nothing.

``precompute_token_states`` runs the frozen trunk once over the corpus
(the cached table of the head and table modes); ``TextEncoder`` is the
trunk plus the additive ``TextHead`` for ``text_encoder_mode='finetune'``,
each block recomputed in backward under ``model.trunk_remat``. No kernel
of the JAX package lies inside the trunk: its products and softmax run
outside any Pallas call there, and here through ``torch.matmul``.

Dropout draws from an explicit ``torch.Generator``. Each block draws from
a generator seeded by one draw of the caller's, so the block's recompute
in backward draws the same masks; remat on and off give the same result.
"""

from __future__ import annotations

import json
import math
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fedrec_tpu_torch.device import resolve_device, torch_dtype
from fedrec_tpu_torch.models.attention import dense
from fedrec_tpu_torch.models.encoders import TextHead, dropout


@dataclass(frozen=True)
class DistilBertConfig:
    """Architecture knobs; defaults = ``distilbert-base-uncased``."""

    vocab_size: int = 30522
    max_position_embeddings: int = 512
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072          # FFN inner dim
    dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=...)``: statistics in at least f32, output in
    ``dtype``."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps).to(dtype)


def _block_seed(generator: torch.Generator | None, device: torch.device) -> int:
    """A seed for one block's dropout, drawn from ``generator`` (else the
    default generator of ``device``): the block seeds its own generator with
    it, in the forward and again in a recompute."""
    dev = generator.device if generator is not None else device
    return int(torch.randint(0, 2**62, (), generator=generator, device=dev))


class _SelfAttention(nn.Module):
    """Post-LN transformer self-attention with an output projection
    (DistilBERT's ``out_lin``; the recommender's own ``MultiHeadAttention``
    has none)."""

    def __init__(self, cfg: DistilBertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.q_lin, self.k_lin = nn.Linear(cfg.dim, cfg.dim), nn.Linear(cfg.dim, cfg.dim)
        self.v_lin, self.out_lin = nn.Linear(cfg.dim, cfg.dim), nn.Linear(cfg.dim, cfg.dim)
        self.cfg, self.dtype = cfg, dtype

    def forward(self, x: torch.Tensor, bias: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        b, L, _ = x.shape
        head_dim = c.dim // c.n_heads

        def split(t):
            return t.reshape(b, L, c.n_heads, head_dim)

        q = split(dense(self.q_lin, x, dt)) / math.sqrt(head_dim)
        k = split(dense(self.k_lin, x, dt))
        v = split(dense(self.v_lin, x, dt))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        attn = torch.softmax(scores + bias.to(scores.dtype), dim=-1)
        attn = dropout(attn, c.attention_dropout, train, generator)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, L, c.dim)
        return dense(self.out_lin, ctx, dt)


class _TransformerBlock(nn.Module):
    def __init__(self, cfg: DistilBertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention = _SelfAttention(cfg, dtype)
        self.sa_layer_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.lin1 = nn.Linear(cfg.dim, cfg.hidden_dim)
        self.lin2 = nn.Linear(cfg.hidden_dim, cfg.dim)
        self.output_layer_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.cfg, self.dtype = cfg, dtype

    def forward(self, x: torch.Tensor, bias: torch.Tensor, train: bool = False,
                seed: int | None = None) -> torch.Tensor:
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        dt = self.dtype
        x = _layer_norm(self.sa_layer_norm, x + self.attention(x, bias, train, gen), dt)
        h = F.gelu(dense(self.lin1, x, dt), approximate="none")
        h = dropout(dense(self.lin2, h, dt), self.cfg.dropout, train, gen)
        return _layer_norm(self.output_layer_norm, x + h, dt)


class DistilBert(nn.Module):
    """Token ids + attention mask -> per-token hidden states (B, L, dim).

    ``remat`` recomputes each block in backward (``torch.utils.checkpoint``)
    when gradients are being taken: one block's activations live at a time
    instead of every block's."""

    def __init__(self, cfg: DistilBertConfig = DistilBertConfig(),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.dim)
        self.emb_layer_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", _TransformerBlock(cfg, dtype))
        self.cfg, self.dtype, self.remat = cfg, dtype, remat

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        ids = input_ids.long()
        positions = torch.arange(ids.shape[1], device=ids.device)
        # F.embedding: its backward sums each row's cotangents in a fixed
        # order on the CPU and the GPU (no atomics), so steps repeat to the bit
        x = (F.embedding(ids, self.word_embeddings.weight.to(dt))
             + F.embedding(positions, self.position_embeddings.weight.to(dt)))
        x = _layer_norm(self.emb_layer_norm, x, dt)
        x = dropout(x, c.dropout, train, generator)
        # (b, L) key mask -> additive bias; padded keys get -inf-ish
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).to(dt)
        draws = train and (c.dropout > 0 or c.attention_dropout > 0)
        for i in range(c.n_layers):
            block = getattr(self, f"layer_{i}")
            seed = _block_seed(generator, x.device) if draws else None
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, bias, train, seed, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x, bias, train, seed)
        return x


# --------------------------------------------------------- weight conversion
def convert_hf_state_dict(state_dict: Mapping[str, Any],
                          cfg: DistilBertConfig) -> dict[str, torch.Tensor]:
    """HF torch ``DistilBertModel`` state_dict -> ``DistilBert``'s, f32.

    Accepts tensors or numpy arrays; keys may carry a ``distilbert.`` prefix
    (full-model checkpoints). Linear weights keep torch's (out, in) layout,
    so only the names change."""

    def arr(key: str) -> torch.Tensor:
        for k in (key, f"distilbert.{key}"):
            if k in state_dict:
                return torch.as_tensor(state_dict[k]).detach().to("cpu", torch.float32)
        raise KeyError(f"missing key {key!r} in state_dict")

    out = {"word_embeddings.weight": arr("embeddings.word_embeddings.weight"),
           "position_embeddings.weight": arr("embeddings.position_embeddings.weight"),
           "emb_layer_norm.weight": arr("embeddings.LayerNorm.weight"),
           "emb_layer_norm.bias": arr("embeddings.LayerNorm.bias")}
    for i in range(cfg.n_layers):
        p = f"transformer.layer.{i}"
        for mine, theirs in (("attention.q_lin", "attention.q_lin"),
                             ("attention.k_lin", "attention.k_lin"),
                             ("attention.v_lin", "attention.v_lin"),
                             ("attention.out_lin", "attention.out_lin"),
                             ("sa_layer_norm", "sa_layer_norm"), ("lin1", "ffn.lin1"),
                             ("lin2", "ffn.lin2"), ("output_layer_norm", "output_layer_norm")):
            for part in ("weight", "bias"):
                out[f"layer_{i}.{mine}.{part}"] = arr(f"{p}.{theirs}.{part}")
    return out


# safetensors dtype codes -> numpy dtypes; BF16 travels as its raw uint16
# bits (numpy has no bfloat16) and is viewed as torch.bfloat16
_SAFETENSORS_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
                       "BF16": np.uint16, "I64": np.int64, "I32": np.int32}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file: an 8-byte little-endian
    header length, a JSON header of ``{name: {dtype, shape, data_offsets}}``
    (offsets into the bytes after the header), then the raw little-endian
    tensor bytes. F32, F16, BF16 (and F64, I64, I32) are read."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    base = 8 + n
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {meta['dtype']!r}")
        begin, end = meta["data_offsets"]
        a = np.frombuffer(raw, _SAFETENSORS_DTYPES[meta["dtype"]], (end - begin)
                          // np.dtype(_SAFETENSORS_DTYPES[meta["dtype"]]).itemsize, base + begin)
        t = torch.from_numpy(a.copy().reshape(meta["shape"]))
        out[name] = t.view(torch.bfloat16) if meta["dtype"] == "BF16" else t
    return out


def load_hf_state_dict(path: str | Path,
                       cfg: DistilBertConfig | None = None) -> dict[str, torch.Tensor]:
    """A local HF checkpoint file (``.bin`` or ``.safetensors``), converted
    for ``DistilBert`` (``convert_hf_state_dict``). Reads only local files."""
    cfg = cfg or DistilBertConfig()
    if str(path).endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_hf_state_dict(sd, cfg)


def _trunk_from(params: nn.Module | Mapping[str, Any], cfg: DistilBertConfig) -> DistilBert:
    if isinstance(params, nn.Module):
        return params
    trunk = DistilBert(cfg)
    trunk.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    return trunk


# --------------------------------------------------------- trunk precompute
@torch.inference_mode()
def precompute_token_states(
    params: nn.Module | Mapping[str, Any],
    news_tokens: np.ndarray,
    cfg: DistilBertConfig | None = None,
    chunk: int = 256,
    dtype: str = "float32",
    device: str | torch.device | None = None,
) -> np.ndarray:
    """(N_news, 2, L) artifact -> (N_news, L, dim) frozen-trunk token states,
    a host numpy array (the ``token_states.npy`` the head and table modes
    read).

    ``params`` is a ``DistilBert`` (moved to ``device`` in place) or its
    state dict (``load_hf_state_dict``, ``init_trunk_params``). The trunk
    runs ``chunk`` titles at a time on ``device`` (default ``cuda``, which
    raises without a GPU); each chunk is
    copied out through two pinned host buffers, in turn, into one
    preallocated array (a list of chunks and a concatenate would double an
    array that is 10 GB at MIND-small scale). float32 only: numpy has no
    bfloat16."""
    if dtype != "float32":
        raise ValueError(
            f"precompute_token_states(dtype={dtype!r}) is not supported by "
            "fedrec_tpu_torch: the states are returned as numpy, which has no "
            "bfloat16; precompute in float32"
        )
    cfg = cfg or DistilBertConfig()
    dev = resolve_device(device)
    trunk = _trunk_from(params, cfg).to(dev).eval()
    n, _, L = news_tokens.shape
    vocab = trunk.word_embeddings.num_embeddings
    if n and int(news_tokens[:, 0].max()) >= vocab:
        raise ValueError(f"news_tokens hold ids >= the trunk's vocab_size {vocab}")
    chunk = max(1, min(chunk, n))
    dim = trunk.cfg.dim
    out = np.empty((n, L, dim), np.float32)
    pinned = dev.type == "cuda"
    bufs = [torch.empty((chunk, L, dim), pin_memory=True) for _ in range(2)] if pinned else []
    pending = None  # (event, buffer, start, rows): a copy still in flight

    def drain(p):
        ev, buf, start, rows = p
        ev.synchronize()
        out[start:start + rows] = buf[:rows].numpy()

    for i, start in enumerate(range(0, n, chunk)):
        block = torch.from_numpy(np.ascontiguousarray(news_tokens[start:start + chunk]))
        block = block.to(dev, non_blocking=True)
        states = trunk(block[:, 0], block[:, 1]).float()
        rows = states.shape[0]
        if not pinned:
            out[start:start + rows] = states.numpy()
            continue
        buf = bufs[i % 2]  # drained while chunk i - 1 was in flight
        buf[:rows].copy_(states, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        if pending is not None:
            drain(pending)
        pending = (ev, buf, start, rows)
    if pending is not None:
        drain(pending)
    return out


def init_trunk_params(seed: int = 0, cfg: DistilBertConfig | None = None) -> dict[str, torch.Tensor]:
    """Random trunk parameters (offline smoke and from-scratch runs): Flax's
    default initialisation from a seeded ``torch.Generator``
    (``params.init_params``), as a state dict."""
    from fedrec_tpu_torch.params import init_params

    return init_params(DistilBert(cfg or DistilBertConfig()), seed=seed).state_dict()


def trunk_config_from(model_cfg) -> DistilBertConfig:
    """DistilBertConfig from a ``ModelConfig`` (finetune-mode trunk knobs)."""
    return DistilBertConfig(
        vocab_size=model_cfg.trunk_vocab,
        dim=model_cfg.bert_hidden,
        n_layers=model_cfg.trunk_layers,
        n_heads=model_cfg.trunk_heads,
        hidden_dim=model_cfg.trunk_ffn,
        dropout=model_cfg.trunk_dropout,
        attention_dropout=model_cfg.trunk_dropout,
    )


def make_text_encoder(model_cfg) -> "TextEncoder":
    """Full trainable text tower for ``text_encoder_mode='finetune'``."""
    if getattr(model_cfg, "text_head_arch", "additive") != "additive":
        raise NotImplementedError(
            "text_encoder_mode='finetune' supports only the additive head; "
            "use text_head_arch='cnn' with mode 'head' or 'table'"
        )
    return TextEncoder(
        trunk_cfg=trunk_config_from(model_cfg),
        news_dim=model_cfg.news_dim,
        stable_softmax=model_cfg.stable_softmax,
        dtype=torch_dtype(model_cfg.dtype),
        remat=model_cfg.trunk_remat,
    )


class TextEncoder(nn.Module):
    """Full text tower: DistilBERT trunk + additive-attention head
    (reference ``encoder.py:12-30``: trunk -> AdditiveAttention(768 -> 384)
    -> Linear(768 -> 400)), over batched token ids.

    The head pools densely, with no token mask (the reference passes none,
    ``encoder.py:28``): the JAX package builds it without ``use_pallas``,
    so its finetune head reaches no Pallas kernel either."""

    def __init__(self, trunk_cfg: DistilBertConfig = DistilBertConfig(), news_dim: int = 400,
                 stable_softmax: bool = True, dtype: torch.dtype = torch.float32,
                 remat: bool = True):
        super().__init__()
        self.trunk = DistilBert(trunk_cfg, dtype, remat)
        self.head = TextHead(news_dim=news_dim, bert_hidden=trunk_cfg.dim,
                             stable_softmax=stable_softmax, dtype=dtype)
        self.news_dim = news_dim

    def forward(self, tokens: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(..., 2, L) stacked [ids; mask] -> (..., news_dim)."""
        batch_shape = tokens.shape[:-2]
        flat = tokens.reshape(-1, 2, tokens.shape[-1])
        states = self.trunk(flat[:, 0], flat[:, 1], train, generator)
        return self.head(states).reshape(*batch_shape, self.news_dim)
