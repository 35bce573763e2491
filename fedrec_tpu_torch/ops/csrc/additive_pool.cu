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
//
// Kernel A2 (additive_pool_long_kernel): the same function for rows that do
// not fit shared memory. Kernel A stages the whole (L, D) row; the
// long-history user tower pools (L=2048, D=400) rows, 3.3 MB each, against
// 227 KB a block. The JAX kernel runs at any L (_pool_forward shrinks its
// row block); A2 streams the row instead. At (16, 2048, 400), hidden 200,
// it is bound by FP32 operations (328 MFLOP per row against 3.3 MB read
// twice), and 16 rows would fill 16 of the 132 SMs, so each row is split
// over S blocks (about four blocks per SM in all). Pass 1: a block stages
// its share of the row one tile of TL tokens at a time, runs kernel A's
// (tile, hidden unit) items on it and writes the tile's logits to a global
// scratch row. The row's last block to finish (an atomic arrival count,
// the threadfence-reduction pattern) runs the masked softmax as A does and
// pass 2: it reads the row again and sums alpha . x in token order. Which
// block finishes last changes nothing: every logit is A's sum in A's
// order, so A2 repeats to the bit, and agrees with A to the bit where both
// fit.
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

// Kernel A2: each row split over S blocks for pass 1; the row's last block
// to finish runs the softmax and pass 2.
template <typename T>
__global__ void __launch_bounds__(512)
additive_pool_long_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                          const float* __restrict__ b1, const float* __restrict__ w2,
                          const float* __restrict__ mask, T* __restrict__ out,
                          float* __restrict__ logits, int* __restrict__ arrived, int L, int D,
                          int Hd, int S, int tiles_per_block) {
  using namespace fedrec;
  extern __shared__ __align__(16) float smem[];
  const int Hpad = (Hd + 31) / 32 * 32;
  const int jblocks = Hpad / 32;
  float* xs = smem;                       // (TL, D) one token tile, rows past L zero
  float* red = xs + (size_t)TL * D;       // (jblocks, TL) per-warp logit sums
  float* alpha = red + jblocks * TL;      // (L) the row's logits, then softmax weights
  __shared__ int any_valid, is_last;

  const int row = blockIdx.x / S, part = blockIdx.x - row * S;
  const int tid = threadIdx.x, lane = tid & 31;
  const T* xr = x + (size_t)row * L * D;
  float* lg_row = logits + (size_t)row * L;

  // pass 1: this block's token tiles -> logits in global scratch
  const int tiles = (L + TL - 1) / TL;
  const int tile_end = min(tiles, (part + 1) * tiles_per_block);
  for (int tile = part * tiles_per_block; tile < tile_end; ++tile) {
    const int t0 = tile * TL, nt = min(TL, L - t0);
    __syncthreads();  // the previous tile's readers are done
    const T* xt = xr + (size_t)t0 * D;
    for (int i = tid; i < TL * D; i += blockDim.x) xs[i] = i < nt * D ? to_f32(xt[i]) : 0.f;
    __syncthreads();
    for (int j = tid; j < Hpad; j += blockDim.x) {  // whole warps: Hpad, blockDim % 32 == 0
      float part_l[TL];
#pragma unroll
      for (int tt = 0; tt < TL; ++tt) part_l[tt] = 0.f;
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
            const float4 xv = *reinterpret_cast<const float4*>(&xs[tt * D + k]);
            acc[tt] = fmaf(xv.x, wa, acc[tt]);
            acc[tt] = fmaf(xv.y, wb, acc[tt]);
            acc[tt] = fmaf(xv.z, wc, acc[tt]);
            acc[tt] = fmaf(xv.w, wd, acc[tt]);
          }
        }
        const float bj = b1[j], qj = w2[j];
#pragma unroll
        for (int tt = 0; tt < TL; ++tt) part_l[tt] = tanhf(acc[tt] + bj) * qj;
      }
#pragma unroll
      for (int tt = 0; tt < TL; ++tt) {
        const float s = warp_sum(part_l[tt]);
        if (lane == 0) red[(j / 32) * TL + tt] = s;
      }
    }
    __syncthreads();
    for (int tt = tid; tt < nt; tt += blockDim.x) {
      float lg = 0.f;
      for (int b = 0; b < jblocks; ++b) lg += red[b * TL + tt];
      lg_row[t0 + tt] = lg;
    }
  }

  // the row's last block to arrive finishes it (the threadfence-reduction
  // pattern): every block's logits are visible once its count is
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(arrived + row, 1);
    is_last = prev == S - 1;
    if (is_last) arrived[row] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;

  // masked softmax over the L logits (one warp), as kernel A
  if (tid < 32) {
    float m = -INFINITY;
    int valid = mask == nullptr ? 1 : 0;
    for (int t = lane; t < L; t += 32) {
      float lg = __ldcg(lg_row + t);  // written by other blocks: skip L1
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

  // pass 2: pooled = alpha . x, the row read again (neighbouring threads
  // read neighbouring d: coalesced), summed in token order
  T* orow = out + (size_t)row * D;
  for (int d = tid; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < L; ++t) acc = fmaf(alpha[t], to_f32(xr[(size_t)t * D + d]), acc);
    orow[d] = from_f32<T>(any_valid ? acc : 0.f);
  }
}

size_t long_smem_bytes(int L, int D, int Hd) {
  const int jblocks = (Hd + 31) / 32;
  return sizeof(float) * ((size_t)TL * D + (size_t)jblocks * TL + L);
}

template <typename T>
int launch_long(const void* x, const void* w1, const void* b1, const void* w2, const void* mask,
                void* out, void* logits, void* arrived, int n, int L, int D, int Hd,
                void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about four blocks per SM over all rows; whole token tiles per block
  const int tiles = (L + TL - 1) / TL;
  int S = (4 * sms + n - 1) / (n > 0 ? n : 1);
  S = S < 1 ? 1 : (S > tiles ? tiles : S);
  const int per_block = (tiles + S - 1) / S;
  S = (tiles + per_block - 1) / per_block;
  const size_t smem = long_smem_bytes(L, D, Hd);
  err = fedrec::allow_smem(additive_pool_long_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (Hd + 31) / 32 * 32;
  if (threads > 512) threads = 512;
  if (n > 0) {
    additive_pool_long_kernel<T><<<n * S, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(mask), static_cast<T*>(out), static_cast<float*>(logits),
        static_cast<int*>(arrived), L, D, Hd, S, per_block);
  }
  return static_cast<int>(cudaGetLastError());
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

// Kernel A2 (rows streamed from HBM): its dynamic shared memory (one tile
// of TL tokens and the row's L logits, bytes).
size_t additive_pool_long_smem_bytes(int L, int D, int Hd) { return long_smem_bytes(L, D, Hd); }

// The arguments of additive_pool_launch, plus scratch: logits (n, L) f32
// and arrived (n) int32, zero on entry (and left zero). Launches kernel A2.
int additive_pool_long_launch(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* mask, void* out, void* logits, void* arrived, int n,
                              int L, int D, int Hd, int dtype, void* stream) {
  if (dtype == 0)
    return launch_long<float>(x, w1, b1, w2, mask, out, logits, arrived, n, L, D, Hd, stream);
  return launch_long<__nv_bfloat16>(x, w1, b1, w2, mask, out, logits, arrived, n, L, D, Hd,
                                    stream);
}

}  // extern "C"
