from fedrec_tpu_torch.models.attention import AdditiveAttention, MultiHeadAttention
from fedrec_tpu_torch.models.bert import (
    DistilBert,
    DistilBertConfig,
    TextEncoder,
    convert_hf_state_dict,
    init_trunk_params,
    load_hf_state_dict,
    precompute_token_states,
)
from fedrec_tpu_torch.models.encoders import TextHead, UserEncoder
from fedrec_tpu_torch.models.recommender import NewsRecommender, score_candidates, score_loss

__all__ = [
    "AdditiveAttention",
    "DistilBert",
    "DistilBertConfig",
    "MultiHeadAttention",
    "NewsRecommender",
    "TextEncoder",
    "TextHead",
    "UserEncoder",
    "convert_hf_state_dict",
    "init_trunk_params",
    "load_hf_state_dict",
    "precompute_token_states",
    "score_candidates",
    "score_loss",
]
