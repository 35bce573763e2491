// Kernel A: additive pooling, out[r] = softmax(tanh(x[r] W1 + b1) w2 + bias[r]) . x[r].
//
// Replaces the Pallas kernel fedrec_tpu/ops/attention_kernels.py:_pool_kernel
// (reached through _pool_forward / additive_pool). The corpus encode runs it
// on every (L=50, D=768) token-state row of the catalog with Hd=384 hidden
// units: 2*L*D*Hd = 29.5 MFLOP against 154 KB read per row in f32, about
// 190 FLOP per byte, so on an H100 it is bound by FP32 operations (no TF32:
// the reference math is full f32), not by the 3.35 TB/s of HBM.
//
// Design: one thread block per row. The row is staged once in shared memory
// as f32 (150 KB at L=50, D=768: needs the >48 KB dynamic shared-memory
// opt-in), so each token value is read from HBM exactly once. Each work item
// is (a tile of TL=25 token rows, one hidden unit j): it keeps TL dot
// products in registers, reads W1[k..k+3, j] from L2 (W1 is 1.2 MB and
// stays L2-resident across blocks; neighbouring lanes read neighbouring j,
// so loads coalesce) and the four x values per token as one broadcast
// float4 from shared memory: 100 FMAs per 25 shared and 4 global loads.
// The per-token logit sums over j are reduced per warp with shuffles and
// then across warps in a fixed order, so the result is deterministic.
// Softmax, the fully-masked-row zeroing and alpha . x finish in the block.
// The fc2 bias is not an input: it shifts every logit equally.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TL = 25;           // token rows per register tile
constexpr float kNegInf = -1e9f; // the JAX wrapper's mask bias

template <typename T>
__global__ void additive_pool_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                                     const float* __restrict__ b1,
                                     const float* __restrict__ w2,
                                     const float* __restrict__ mask, T* __restrict__ out,
                                     int L, int D, int Hd) {
  using namespace fedrec;
  extern __shared__ __align__(16) float smem[];
  const int Lp = (L + TL - 1) / TL * TL;  // token rows padded to the tile
  const int Hpad = (Hd + 31) / 32 * 32;   // hidden units padded to whole warps
  const int jblocks = Hpad / 32;
  float* xs = smem;                       // (Lp, D), rows >= L are zero
  float* red = xs + (size_t)Lp * D;       // (jblocks, Lp) per-warp logit sums
  float* alpha = red + jblocks * Lp;      // (L)
  __shared__ int any_valid;

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const T* xr = x + (size_t)row * L * D;
  for (int i = tid; i < Lp * D; i += blockDim.x) xs[i] = i < L * D ? to_f32(xr[i]) : 0.f;
  __syncthreads();

  // logits: items (tile, j) walk in whole warps, lanes past Hd add zero
  const int items = (Lp / TL) * Hpad;
  for (int w = tid; w < items; w += blockDim.x) {
    const int t0 = (w / Hpad) * TL;
    const int j = w % Hpad;
    float part[TL];
#pragma unroll
    for (int tt = 0; tt < TL; ++tt) part[tt] = 0.f;
    if (j < Hd) {
      float acc[TL];
#pragma unroll
      for (int tt = 0; tt < TL; ++tt) acc[tt] = 0.f;
      for (int k = 0; k < D; k += 4) {
        const float wa = w1[(size_t)k * Hd + j];
        const float wb = w1[(size_t)(k + 1) * Hd + j];
        const float wc = w1[(size_t)(k + 2) * Hd + j];
        const float wd = w1[(size_t)(k + 3) * Hd + j];
#pragma unroll
        for (int tt = 0; tt < TL; ++tt) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[(t0 + tt) * D + k]);
          acc[tt] = fmaf(xv.x, wa, acc[tt]);
          acc[tt] = fmaf(xv.y, wb, acc[tt]);
          acc[tt] = fmaf(xv.z, wc, acc[tt]);
          acc[tt] = fmaf(xv.w, wd, acc[tt]);
        }
      }
      const float bj = b1[j], qj = w2[j];
#pragma unroll
      for (int tt = 0; tt < TL; ++tt) part[tt] = tanhf(acc[tt] + bj) * qj;
    }
#pragma unroll
    for (int tt = 0; tt < TL; ++tt) {
      const float s = warp_sum(part[tt]);
      if (lane == 0) red[(j / 32) * Lp + t0 + tt] = s;
    }
  }
  __syncthreads();

  // masked softmax over the L slots (one warp): a true softmax of
  // logit + bias, bias = -1e9 on masked slots, as the JAX wrapper builds it
  if (tid < 32) {
    float m = -INFINITY;
    int valid = mask == nullptr ? 1 : 0;
    for (int t = lane; t < L; t += 32) {
      float lg = 0.f;
      for (int b = 0; b < jblocks; ++b) lg += red[b * Lp + t];
      if (mask != nullptr) {
        const bool keep = mask[(size_t)row * L + t] > 0.f;
        valid |= keep;
        if (!keep) lg += kNegInf;
      }
      alpha[t] = lg;
      m = fmaxf(m, lg);
    }
    m = warp_max(m);
    float s = 0.f;
    for (int t = lane; t < L; t += 32) {
      const float e = expf(alpha[t] - m);
      alpha[t] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int t = lane; t < L; t += 32) alpha[t] = alpha[t] / s;
    valid = __any_sync(0xffffffffu, valid);
    if (lane == 0) any_valid = valid;
  }
  __syncthreads();

  // pooled = alpha . x; a fully-masked row pools to exactly 0, like the
  // module path's multiply-after-exp normalization
  T* orow = out + (size_t)row * D;
  for (int d = tid; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < L; ++t) acc = fmaf(alpha[t], xs[t * D + d], acc);
    orow[d] = from_f32<T>(any_valid ? acc : 0.f);
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* mask,
           void* out, int n, int L, int D, int Hd, void* stream) {
  const int Lp = (L + TL - 1) / TL * TL;
  const int jblocks = (Hd + 31) / 32;
  const size_t smem = sizeof(float) * ((size_t)Lp * D + (size_t)jblocks * Lp + L);
  cudaError_t err = fedrec::allow_smem(additive_pool_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = jblocks * 32;
  if (threads > 512) threads = 512;
  if (n > 0) {
    additive_pool_kernel<T><<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(mask), static_cast<T*>(out), L, D, Hd);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel asks for at these sizes (bytes); the
// wrapper refuses shapes above the card's per-block limit before launching.
size_t additive_pool_smem_bytes(int L, int D, int Hd) {
  const int Lp = (L + TL - 1) / TL * TL;
  const int jblocks = (Hd + 31) / 32;
  return sizeof(float) * ((size_t)Lp * D + (size_t)jblocks * Lp + L);
}

// x (n, L, D) f32|bf16, w1 (D, Hd) f32, b1 (Hd) f32, w2 (Hd) f32,
// mask (n, L) f32 or null, out (n, D) in x's dtype. dtype: 0 f32, 1 bf16.
// Returns cudaGetLastError() after the launch.
int additive_pool_launch(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* mask, void* out, int n, int L, int D, int Hd,
                         int dtype, void* stream) {
  if (dtype == 0) return launch<float>(x, w1, b1, w2, mask, out, n, L, D, Hd, stream);
  return launch<__nv_bfloat16>(x, w1, b1, w2, mask, out, n, L, D, Hd, stream);
}

}  // extern "C"
