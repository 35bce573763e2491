"""Host-side data for the port: numpy copies of the JAX package's batcher,
negative sampling, artifact loader and synthetic MIND generators."""

from fedrec_tpu_torch.data.batcher import (
    Batch,
    IndexedSamples,
    TrainBatcher,
    index_samples,
    shard_indices,
)
from fedrec_tpu_torch.data.mind import (
    MindData,
    load_mind_artifacts,
    make_synthetic_mind,
    make_synthetic_mind_topics,
)
from fedrec_tpu_torch.data.sampling import newsample, sample_negatives_array

__all__ = [
    "Batch",
    "IndexedSamples",
    "MindData",
    "TrainBatcher",
    "index_samples",
    "load_mind_artifacts",
    "make_synthetic_mind",
    "make_synthetic_mind_topics",
    "newsample",
    "sample_negatives_array",
    "shard_indices",
]
