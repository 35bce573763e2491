"""Host-side data for the port: numpy copies of the JAX package's batcher,
negative sampling, prefetcher, artifact loader and synthetic MIND
generators."""

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
)
from fedrec_tpu_torch.data.prefetch import Prefetcher, maybe_prefetch
from fedrec_tpu_torch.data.sampling import newsample, sample_negatives_array

__all__ = [
    "Batch",
    "IndexedSamples",
    "MindData",
    "Prefetcher",
    "TrainBatcher",
    "index_samples",
    "load_mind_artifacts",
    "make_synthetic_mind",
    "make_synthetic_mind_topics",
    "maybe_prefetch",
    "newsample",
    "process_shard_indices",
    "sample_negatives_array",
    "shard_indices",
]
