"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

| Kernel | Wrapper | Source | Replaces (Pallas) |
| --- | --- | --- | --- |
| A | ``additive_pool`` | ``csrc/additive_pool.cu`` | ``fedrec_tpu/ops/attention_kernels.py:_pool_kernel`` |
| B | ``fused_history_score`` | ``csrc/fused_history_score.cu`` | ``fedrec_tpu/ops/fused_hot_path.py:_hist_score_fwd_kernel`` |

A wrapper launches its kernel for CUDA tensors (or raises) and counts the
launch in its ``launches`` attribute; CPU tensors take the plain version and
count nothing. The sources build at first use (``_build``).
"""

from fedrec_tpu_torch.ops.attention_kernels import additive_pool, additive_pool_plain
from fedrec_tpu_torch.ops.fused_hot_path import (
    UserTowerWeights,
    fused_history_score,
    fused_history_score_plain,
    fused_user_vector,
)

KERNELS = {
    "additive_pool": additive_pool,
    "fused_history_score": fused_history_score,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "UserTowerWeights",
    "additive_pool",
    "additive_pool_plain",
    "fused_history_score",
    "fused_history_score_plain",
    "fused_user_vector",
    "launch_counts",
    "reset_launch_counts",
]
