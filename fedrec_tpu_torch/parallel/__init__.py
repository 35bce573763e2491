"""The coordinator deployment's world on ``torch.distributed`` (gloo,
``parallel.multihost``), its elastic membership service
(``parallel.membership``), the wire clients' failure handling
(``parallel.rpc``: backoff, ``FleetRpc``, the circuit breaker) and sequence
parallelism (``parallel.ring``: ring and Ulysses attention, the seq-sharded
pool; ``parallel.mesh``: the seq world's group and batch layout).

The names load on first use, so that the torch-free membership service
(which a coordinator worker joins before it imports torch) and the
torch-free ``rpc`` import without the rest."""

import importlib

_EXPORTS = {
    "REFORM_SIGNAL": "multihost",
    "CoordinatorRuntime": "multihost",
    "World": "multihost",
    "aggregate_from_hosts": "multihost",
    "broadcast_params": "multihost",
    "broadcast_round_index": "multihost",
    "initialize_distributed": "multihost",
    "SeqGroup": "ring",
    "ring_attention": "ring",
    "seq_parallel_pool": "ring",
    "ulysses_attention": "ring",
    "seq_group": "mesh",
    "shard_fed_batch": "mesh",
    "RC_DEGRADED": "rpc",
    "AuthorityUnreachable": "rpc",
    "CircuitBreaker": "rpc",
    "CircuitOpen": "rpc",
    "FleetRpc": "rpc",
    "RpcPolicy": "rpc",
    "backoff_delay_s": "rpc",
    "new_push_id": "rpc",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
