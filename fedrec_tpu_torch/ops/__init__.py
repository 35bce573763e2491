"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

| Kernel | Wrapper | Source | Replaces (Pallas) |
| --- | --- | --- | --- |
| A | ``additive_pool`` | ``csrc/additive_pool.cu`` | ``fedrec_tpu/ops/attention_kernels.py:_pool_kernel`` |
| A2 | ``additive_pool_long`` | ``csrc/additive_pool.cu`` | ``fedrec_tpu/ops/attention_kernels.py:_pool_kernel`` (rows too long for A) |
| B | ``fused_history_score`` | ``csrc/fused_history_score.cu`` | ``fedrec_tpu/ops/fused_hot_path.py:_hist_score_fwd_kernel`` |
| C | ``fused_gather_encode`` | ``csrc/fused_gather_encode.cu`` | ``fedrec_tpu/ops/fused_hot_path.py:_gather_encode_fwd_kernel`` |
| D | ``fused_gather_encode_bwd`` | ``csrc/fused_gather_encode.cu`` | ``fedrec_tpu/ops/fused_hot_path.py:_gather_encode_bwd_kernel`` |
| E | ``fused_history_score_bwd`` | ``csrc/fused_history_score_bwd.cu`` | ``fedrec_tpu/ops/fused_hot_path.py:_hist_score_bwd_kernel`` |
| F1 | ``flash_forward`` | ``csrc/flash_attention.cu`` | ``fedrec_tpu/ops/attention_kernels.py:_flash_kernel`` |
| F2 | ``flash_backward_dq`` | ``csrc/flash_attention.cu`` | ``fedrec_tpu/ops/attention_kernels.py:_flash_bwd_dq_kernel`` |
| F3 | ``flash_backward_dkv`` | ``csrc/flash_attention.cu`` | ``fedrec_tpu/ops/attention_kernels.py:_flash_bwd_dkv_kernel`` |

A wrapper launches its kernel for CUDA tensors (or raises) and counts the
launch in its ``launches`` attribute; CPU tensors take the plain version and
count nothing. ``additive_pool`` launches A, or A2 where a row is longer
than a block's shared memory would hold, and counts under the kernel it
launched. D, E, F2 and F3
are backward kernels: the forward wrappers (``fused_gather_encode``,
``fused_history_score``, ``flash_attention``) run inside an autograd function
that calls them when a gradient is needed. Kernel A's (and A2's) backward is
the vector-Jacobian product of its plain version, as the JAX one is a dense
recompute. A's and F1-F3's autograd functions carry ``vmap`` rules, so that
``torch.func.vmap(torch.func.grad(...))`` (per-example DP-SGD) folds the
examples into the kernels' rows and launches each kernel once a batch; B-E
have none (``fuse_hot_path`` with DP-SGD is refused, as in JAX).
``chunked_attention`` is a blockwise PyTorch loop, not a kernel (the JAX one
is a ``lax.scan``). The sources build at first use (``_build``).
"""

from fedrec_tpu_torch.ops.attention_kernels import (
    additive_pool,
    additive_pool_long,
    additive_pool_plain,
    flash_attention,
    flash_backward_dkv,
    flash_backward_dkv_plain,
    flash_backward_dq,
    flash_backward_dq_plain,
    flash_backward_plain,
    flash_forward,
    flash_forward_plain,
)
from fedrec_tpu_torch.ops.chunked_attention import chunked_attention
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
    "additive_pool_long": additive_pool_long,
    "flash_forward": flash_forward,
    "flash_backward_dq": flash_backward_dq,
    "flash_backward_dkv": flash_backward_dkv,
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
    "additive_pool_long",
    "additive_pool_plain",
    "chunked_attention",
    "flash_attention",
    "flash_backward_dkv",
    "flash_backward_dkv_plain",
    "flash_backward_dq",
    "flash_backward_dq_plain",
    "flash_backward_plain",
    "flash_forward",
    "flash_forward_plain",
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
