"""Local DP for the port (``fedrec_tpu/privacy``): per-example DP-SGD's
clipped-gradient estimator, the ``dpsgd`` and ``ldp_news`` noise hooks and
a numpy copy of the Renyi-DP accountant."""

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
    clip_by_global_norm_per_example,
    make_ldp_news_noise_fn,
    make_noise_fn,
    per_example_clipped_grads,
    per_example_global_norms,
)

__all__ = [
    "add_gaussian_noise",
    "calibrate_from_config",
    "calibrate_sigma",
    "clip_by_global_norm_per_example",
    "compute_epsilon",
    "compute_rdp_subsampled_gaussian",
    "make_ldp_news_noise_fn",
    "make_noise_fn",
    "per_example_clipped_grads",
    "per_example_global_norms",
    "round_epsilon_schedule",
    "sampling_profile",
]
