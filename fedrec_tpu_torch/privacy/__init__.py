"""Local DP for the port: the ``ldp_news`` noise hook and a numpy copy of the
Renyi-DP accountant (``fedrec_tpu/privacy``). Per-example DP-SGD is not
ported yet."""

from fedrec_tpu_torch.privacy.accountant import (
    calibrate_from_config,
    calibrate_sigma,
    compute_epsilon,
    compute_rdp_subsampled_gaussian,
    round_epsilon_schedule,
    sampling_profile,
)
from fedrec_tpu_torch.privacy.dpsgd import (
    add_gaussian_noise,
    make_ldp_news_noise_fn,
    make_noise_fn,
)

__all__ = [
    "add_gaussian_noise",
    "calibrate_from_config",
    "calibrate_sigma",
    "compute_epsilon",
    "compute_rdp_subsampled_gaussian",
    "make_ldp_news_noise_fn",
    "make_noise_fn",
    "round_epsilon_schedule",
    "sampling_profile",
]
