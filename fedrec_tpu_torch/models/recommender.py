"""Two-tower news recommender and its loss, the port of
``fedrec_tpu/models/recommender.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedrec_tpu_torch.config import ModelConfig
from fedrec_tpu_torch.device import torch_dtype
from fedrec_tpu_torch.models.attention import seq_clone
from fedrec_tpu_torch.models.bert import make_text_encoder
from fedrec_tpu_torch.models.encoders import CnnTextHead, GRUUserEncoder, TextHead, UserEncoder


def score_candidates(cand_vecs: torch.Tensor, user_vec: torch.Tensor) -> torch.Tensor:
    """Dot-product scoring: (..., C, D) x (..., D) -> (..., C)."""
    return torch.einsum("...cd,...d->...c", cand_vecs, user_vec)


def score_loss(
    scores: torch.Tensor,
    labels: torch.Tensor,
    sigmoid_before_ce: bool = True,
    reduce: bool = True,
) -> torch.Tensor:
    """Cross-entropy over impressions (labels are always slot 0).

    ``sigmoid_before_ce=True`` reproduces the reference's
    ``CrossEntropyLoss()(sigmoid(scores), labels)``. The scores are cast to
    f32 before the sigmoid, as in the JAX package (a bf16 sigmoid would
    re-quantize). ``reduce=False`` returns the per-impression vector.
    """
    logits = scores.float()
    if sigmoid_before_ce:
        logits = torch.sigmoid(logits)
    per_row = F.cross_entropy(logits, labels.long(), reduction="none")
    return per_row.mean() if reduce else per_row


class NewsRecommender(nn.Module):
    """User encoder + news tower; ``encode_news`` and ``encode_user`` are
    exposed separately, as in the JAX module.

    The news tower (``news_tower``, whose parameters are a client's
    ``news_params``) is the text head over cached token states (``TextHead``,
    or ``CnnTextHead`` under ``text_head_arch='cnn'``), or in
    ``text_encoder_mode='finetune'`` the whole ``models.bert.TextEncoder``
    (``text_encoder``: the trunk and its head) over token ids. The user
    tower is ``UserEncoder`` (``user_tower='mha'``) or ``GRUUserEncoder``
    (``'gru'``). Each family's attribute name is shared, as in the Flax
    tree, and its leaves differ, so snapshots are per family. The JAX
    module's refusals stand, with its wording; ``seq_parallel`` is the
    model under a seq world (``fed.seq_shards > 1``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        arch = cfg.text_head_arch
        if arch not in ("additive", "cnn"):
            raise ValueError(f"unknown model.text_head_arch {arch!r}; have 'additive', 'cnn'")
        tower = cfg.user_tower
        if cfg.fuse_hot_path:
            if tower != "mha":
                raise ValueError(
                    "model.fuse_hot_path fuses the MHA user tower; "
                    f"user_tower={tower!r} has no fused kernel — unset one"
                )
            if not cfg.stable_softmax:
                raise ValueError(
                    "model.fuse_hot_path requires stable_softmax=True (the "
                    "fused kernels compute the max-subtracted form; the "
                    "raw-exp parity mode stays on the dense path)"
                )
        if cfg.text_encoder_mode == "finetune":
            # refuses the cnn head, with the JAX package's wording
            self.text_encoder = make_text_encoder(cfg)
        elif arch == "cnn":
            self.text_head = CnnTextHead(
                news_dim=cfg.news_dim,
                bert_hidden=cfg.bert_hidden,
                kernel=cfg.cnn_kernel,
                stable_softmax=cfg.stable_softmax,
                dtype=dtype,
                use_pallas=cfg.use_pallas,
            )
        else:
            self.text_head = TextHead(
                news_dim=cfg.news_dim,
                bert_hidden=cfg.bert_hidden,
                stable_softmax=cfg.stable_softmax,
                dtype=dtype,
                use_pallas=cfg.use_pallas,
            )
        if tower == "gru":
            self.user_encoder = GRUUserEncoder(
                news_dim=cfg.news_dim,
                query_dim=cfg.query_dim,
                dropout_rate=cfg.dropout_rate,
                stable_softmax=cfg.stable_softmax,
                dtype=dtype,
                use_pallas=cfg.use_pallas,
            )
        elif tower == "mha":
            self.user_encoder = UserEncoder(
                news_dim=cfg.news_dim,
                num_heads=cfg.num_heads,
                head_dim=cfg.head_dim,
                query_dim=cfg.query_dim,
                dropout_rate=cfg.dropout_rate,
                stable_softmax=cfg.stable_softmax,
                dtype=dtype,
                use_pallas=cfg.use_pallas,
                fuse=cfg.fuse_hot_path,
                attn_impl=cfg.attn_impl,
                chunk_threshold=cfg.attn_chunk_threshold,
            )
        else:
            raise ValueError(f"unknown model.user_tower {tower!r}; have 'mha', 'gru'")

    def seq_parallel(self, group, impl: str = "ring") -> "NewsRecommender":
        """A copy sharing this model's parameters whose user tower runs over
        the seq world ``group`` (``fed.seq_shards > 1``): the JAX step's
        ``model.clone(seq_axis=...)``, with the JAX module's refusals."""
        if self.cfg.fuse_hot_path:
            raise ValueError(
                "model.fuse_hot_path cannot run under fed.seq_shards>1 "
                "(the fused kernel holds the whole history per row); "
                "use the ring/Ulysses path for sharded histories"
            )
        if self.cfg.user_tower == "gru":
            raise ValueError(
                "model.user_tower='gru' cannot run under fed.seq_shards>1 "
                "(sequence parallelism is attention-specific); use the "
                "'mha' tower for seq-sharded histories"
            )
        return seq_clone(self, _modules={**self._modules,
                                         "user_encoder": self.user_encoder.seq_parallel(group, impl)})

    @property
    def news_tower(self) -> nn.Module:
        """The module holding the news tower's parameters."""
        if self.cfg.text_encoder_mode == "finetune":
            return self.text_encoder
        return self.text_head

    def encode_news(
        self, token_states: torch.Tensor, mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        if self.cfg.text_encoder_mode == "finetune":
            # the serving refresh and encode_all_news read cached states
            raise ValueError(
                "a finetune-mode model encodes token ids, not cached token states: "
                "use train.step.encode_corpus_tokens(model.text_encoder, news_tokens)"
            )
        return self.text_head(token_states, mask)

    def encode_user(
        self,
        his_vecs: torch.Tensor,
        mask: torch.Tensor | None = None,
        train: bool = False,
    ) -> torch.Tensor:
        return self.user_encoder(his_vecs, mask, train)

    def forward(
        self,
        cand_vecs: torch.Tensor,
        his_vecs: torch.Tensor,
        his_mask: torch.Tensor | None = None,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """(..., C, D) candidates + (..., H, D) history -> (..., C) scores;
        ``generator`` feeds the user tower's dropout."""
        if self.cfg.fuse_hot_path:
            # one kernel runs attention + pool + scoring
            _, scores = self.user_encoder(
                his_vecs, his_mask, train, cand_vecs=cand_vecs, generator=generator
            )
            return scores
        user_vec = self.user_encoder(his_vecs, his_mask, train, generator=generator)
        return score_candidates(cand_vecs, user_vec)
