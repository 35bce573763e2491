"""Federated aggregation (``fed/strategies.py``, FedOpt included) and the cohort
engine's sampler (``fed/sampling.py``) for the port."""

from fedrec_tpu_torch.fed.strategies import (
    FedStrategy,
    GradAvg,
    Local,
    ParamAvg,
    ServerOptimizer,
    get_strategy,
    participation_mask,
    weighted_param_avg,
)

from fedrec_tpu_torch.fed.sampling import SAMPLER_MODES, CohortSampler, validate_sampler_mode

__all__ = ["SAMPLER_MODES", "CohortSampler", "FedStrategy", "GradAvg", "Local", "ParamAvg",
           "ServerOptimizer", "get_strategy", "participation_mask", "validate_sampler_mode",
           "weighted_param_avg"]
