"""Federated aggregation for the port (``fed/strategies.py``)."""

from fedrec_tpu_torch.fed.strategies import (
    FedStrategy,
    GradAvg,
    Local,
    ParamAvg,
    get_strategy,
    participation_mask,
    weighted_param_avg,
)

__all__ = ["FedStrategy", "GradAvg", "Local", "ParamAvg", "get_strategy", "participation_mask",
           "weighted_param_avg"]
