"""Online serving for the port: versioned store with checkpoint refresh,
exact and k-means two-stage retrieval, micro-batcher, the TCP/JSON-lines
service and its resilient client."""

from fedrec_tpu_torch.serving.batcher import Backpressure, MicroBatcher, ServedResult
from fedrec_tpu_torch.serving.client import ServingClient, ServingClientPool, ServingUnavailable
from fedrec_tpu_torch.serving.retrieval import (
    TwoStageIndex,
    build_index,
    build_two_stage_fn,
    kmeans,
    recall_at_k,
)
from fedrec_tpu_torch.serving.server import ServingService, serve_forever, start_server
from fedrec_tpu_torch.serving.store import (
    EmbeddingStore,
    EmptyStoreError,
    Generation,
    SnapshotFormatError,
    load_checkpoint_params,
    publish_from_checkpoint,
    restore_model,
)

__all__ = [
    "Backpressure",
    "EmbeddingStore",
    "EmptyStoreError",
    "Generation",
    "MicroBatcher",
    "ServedResult",
    "ServingClient",
    "ServingClientPool",
    "ServingService",
    "ServingUnavailable",
    "SnapshotFormatError",
    "TwoStageIndex",
    "build_index",
    "build_two_stage_fn",
    "kmeans",
    "load_checkpoint_params",
    "publish_from_checkpoint",
    "recall_at_k",
    "restore_model",
    "serve_forever",
    "start_server",
]
