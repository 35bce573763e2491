"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

| Kernel | Wrapper | Source | Replaces (Pallas) |
| --- | --- | --- | --- |
| A | ``additive_pool`` | ``csrc/additive_pool.cu`` | ``fedrec_tpu/ops/attention_kernels.py:_pool_kernel`` |
| B | ``fused_history_score`` | ``csrc/fused_history_score.cu`` | ``fedrec_tpu/ops/fused_hot_path.py:_hist_score_fwd_kernel`` |
| C | ``fused_gather_encode`` | ``csrc/fused_gather_encode.cu`` | ``fedrec_tpu/ops/fused_hot_path.py:_gather_encode_fwd_kernel`` |
| D | ``fused_gather_encode_bwd`` | ``csrc/fused_gather_encode.cu`` | ``fedrec_tpu/ops/fused_hot_path.py:_gather_encode_bwd_kernel`` |
| E | ``fused_history_score_bwd`` | ``csrc/fused_history_score_bwd.cu`` | ``fedrec_tpu/ops/fused_hot_path.py:_hist_score_bwd_kernel`` |

A wrapper launches its kernel for CUDA tensors (or raises) and counts the
launch in its ``launches`` attribute; CPU tensors take the plain version and
count nothing. D and E are the backward of C and B: the forward wrappers run
inside an autograd function that calls them when a gradient is needed. Kernel
A's backward is autograd of its plain version, as the JAX one is a dense
recompute. The sources build at first use (``_build``).
"""

from fedrec_tpu_torch.ops.attention_kernels import additive_pool, additive_pool_plain
from fedrec_tpu_torch.ops.fused_hot_path import (
    TextHeadWeights,
    UserTowerWeights,
    fused_gather_encode,
    fused_gather_encode_bwd,
    fused_gather_encode_bwd_plain,
    fused_gather_encode_plain,
    fused_history_score,
    fused_history_score_bwd,
    fused_history_score_bwd_plain,
    fused_history_score_plain,
    fused_user_vector,
    text_head_weights,
)

KERNELS = {
    "additive_pool": additive_pool,
    "fused_history_score": fused_history_score,
    "fused_gather_encode": fused_gather_encode,
    "fused_gather_encode_bwd": fused_gather_encode_bwd,
    "fused_history_score_bwd": fused_history_score_bwd,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "TextHeadWeights",
    "UserTowerWeights",
    "additive_pool",
    "additive_pool_plain",
    "fused_gather_encode",
    "fused_gather_encode_bwd",
    "fused_gather_encode_bwd_plain",
    "fused_gather_encode_plain",
    "fused_history_score",
    "fused_history_score_bwd",
    "fused_history_score_bwd_plain",
    "fused_history_score_plain",
    "fused_user_vector",
    "launch_counts",
    "reset_launch_counts",
    "text_head_weights",
]
