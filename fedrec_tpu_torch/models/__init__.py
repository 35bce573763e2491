from fedrec_tpu_torch.models.attention import AdditiveAttention, MultiHeadAttention
from fedrec_tpu_torch.models.encoders import TextHead, UserEncoder
from fedrec_tpu_torch.models.recommender import NewsRecommender, score_candidates, score_loss

__all__ = [
    "AdditiveAttention",
    "MultiHeadAttention",
    "NewsRecommender",
    "TextHead",
    "UserEncoder",
    "score_candidates",
    "score_loss",
]
