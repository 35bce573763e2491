"""Online serving for the port: versioned store, exact retrieval,
micro-batcher and the TCP/JSON-lines service."""

from fedrec_tpu_torch.serving.batcher import Backpressure, MicroBatcher, ServedResult
from fedrec_tpu_torch.serving.retrieval import TwoStageIndex, build_index, build_two_stage_fn
from fedrec_tpu_torch.serving.server import ServingService, serve_forever, start_server
from fedrec_tpu_torch.serving.store import EmbeddingStore, EmptyStoreError, Generation

__all__ = [
    "Backpressure",
    "EmbeddingStore",
    "EmptyStoreError",
    "Generation",
    "MicroBatcher",
    "ServedResult",
    "ServingService",
    "TwoStageIndex",
    "build_index",
    "build_two_stage_fn",
    "serve_forever",
    "start_server",
]
