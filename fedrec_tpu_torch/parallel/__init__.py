"""The coordinator deployment's world on ``torch.distributed`` (gloo,
``parallel.multihost``) and the wire clients' retry policy
(``parallel.rpc``)."""

from fedrec_tpu_torch.parallel.multihost import (
    CoordinatorRuntime,
    World,
    aggregate_from_hosts,
    broadcast_params,
    broadcast_round_index,
    initialize_distributed,
)
from fedrec_tpu_torch.parallel.rpc import backoff_delay_s

__all__ = ["CoordinatorRuntime", "World", "aggregate_from_hosts", "backoff_delay_s",
           "broadcast_params", "broadcast_round_index", "initialize_distributed"]
