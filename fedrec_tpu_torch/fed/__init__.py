"""Federated aggregation (``fed/strategies.py``, FedOpt included) and the cohort
engine's sampler (``fed/sampling.py``) for the port.

The names load on first use, so that a torch-free submodule (``fed.chaos``'s
``rejoin_holdoff``, read before the coordinator imports torch) imports
without them."""

import importlib

_EXPORTS = {
    "FedStrategy": "strategies",
    "GradAvg": "strategies",
    "Local": "strategies",
    "ParamAvg": "strategies",
    "ServerOptimizer": "strategies",
    "get_strategy": "strategies",
    "participation_mask": "strategies",
    "weighted_param_avg": "strategies",
    "SAMPLER_MODES": "sampling",
    "CohortSampler": "sampling",
    "validate_sampler_mode": "sampling",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
