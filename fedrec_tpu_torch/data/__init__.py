"""Host-side data for the port: numpy copies of the JAX package's batcher,
negative sampling, prefetcher, artifact loader, synthetic MIND generators,
tokenizers and the MIND and Adressa preprocessing."""

from fedrec_tpu_torch.data.adressa import (
    make_synthetic_adressa_events,
    parse_adressa_events,
    preprocess_adressa,
)
from fedrec_tpu_torch.data.batcher import (
    Batch,
    IndexedSamples,
    TrainBatcher,
    index_samples,
    process_shard_indices,
    shard_indices,
)
from fedrec_tpu_torch.data.mind import (
    MindData,
    load_mind_artifacts,
    make_synthetic_mind,
    make_synthetic_mind_topics,
    token_states_from_tokens,
)
from fedrec_tpu_torch.data.prefetch import Prefetcher, maybe_prefetch
from fedrec_tpu_torch.data.preprocess import (
    build_news_index,
    parse_behaviors_tsv,
    parse_news_tsv,
    preprocess_mind,
    write_artifacts,
)
from fedrec_tpu_torch.data.sampling import newsample, sample_negatives_array
from fedrec_tpu_torch.data.tokenizer import (
    HashingTokenizer,
    WordPieceTokenizer,
    get_tokenizer,
)

__all__ = [
    "Batch",
    "HashingTokenizer",
    "IndexedSamples",
    "MindData",
    "Prefetcher",
    "TrainBatcher",
    "WordPieceTokenizer",
    "build_news_index",
    "get_tokenizer",
    "index_samples",
    "load_mind_artifacts",
    "make_synthetic_adressa_events",
    "make_synthetic_mind",
    "make_synthetic_mind_topics",
    "maybe_prefetch",
    "newsample",
    "parse_adressa_events",
    "parse_behaviors_tsv",
    "parse_news_tsv",
    "preprocess_adressa",
    "preprocess_mind",
    "process_shard_indices",
    "sample_negatives_array",
    "shard_indices",
    "token_states_from_tokens",
    "write_artifacts",
]
