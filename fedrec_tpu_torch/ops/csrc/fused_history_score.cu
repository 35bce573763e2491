// Kernel B: the fused user tower and scorer, forward.
//
// Replaces the Pallas kernel fedrec_tpu/ops/fused_hot_path.py:_hist_score_fwd_kernel
// with its core _hist_forward_core (reached through _hist_score_forward,
// fused_history_score and fused_user_vector). For each history row
// (H=50 clicked-news vectors of D=400): Q/K/V projections, 20-head masked
// self-attention (divide by sqrt(dh), max over the real slots, mask after
// exp, +1e-8), additive pooling to the user vector, and optional dot scores
// against C candidates.
//
// Bound on an H100: about 60 MFLOP per row against about 160 KB of weights
// (read once per call, then L2-resident) and 80 KB of history per row, so at
// the serving batches (B=1..128) it is bound by FP32 operations: 7.7 GFLOP,
// ~0.115 ms at 67 TFLOP/s, at B=128. Below 132 rows the card has idle SMs,
// and one row's work on one SM (about 0.12 ms at that SM's peak) is the
// floor at any B; this simple version sits well above it (PERF.md).
//
// Design: one thread block per history row; the row never leaves shared
// memory. x (H, D) and the context (H, D) live there in f32 (185 KB at the
// main shape: needs the >48 KB dynamic shared-memory opt-in), plus one
// head's q/k/v (H, dh) and scores (H, H) at a time. The projections work on
// (10-row tile, one output column) items with 10 f32 accumulators, reading
// the history as broadcast float4s from shared memory and the weights from
// L2. Every reduction is in a fixed order (warp shuffles, then warps in
// order), so results are deterministic. Values are kept in f32 but rounded
// through the operand dtype at exactly the JAX kernel's points (q/k/v,
// attention weights, ctx, e, pool weights, user, scores), so bf16 matches
// the JAX kernel, not the dense module. The fc2 bias is not an input.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TR = 10;        // history rows per register tile
constexpr float kEps = 1e-8f; // the module's denominator epsilon

struct Dims {
  int H, D, C, Q, nh, dh, Hp, colpad, Qpad;
};

__host__ __device__ inline Dims make_dims(int H, int D, int C, int Q, int nh) {
  Dims d;
  d.H = H; d.D = D; d.C = C; d.Q = Q; d.nh = nh; d.dh = D / nh;
  d.Hp = (H + TR - 1) / TR * TR;
  d.colpad = (3 * d.dh + 31) / 32 * 32;
  d.Qpad = (Q + 31) / 32 * 32;
  return d;
}

__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return 2 * (size_t)d.Hp * d.D        // xs, ctx
         + 3 * (size_t)d.Hp * d.dh     // one head's q, k, v
         + (size_t)d.Hp * d.H          // one head's scores / weights
         + (size_t)(d.Qpad / 32) * d.Hp  // per-warp pool-logit sums
         + d.Hp + d.H + d.D;           // pool weights, mask, user
}

template <typename T>
__global__ void fused_history_score_kernel(
    const T* __restrict__ x, const T* __restrict__ cand, const float* __restrict__ mask,
    const T* __restrict__ wq, const T* __restrict__ bq, const T* __restrict__ wk,
    const T* __restrict__ bk, const T* __restrict__ wv, const T* __restrict__ bv,
    const T* __restrict__ pw1, const T* __restrict__ pb1, const T* __restrict__ pw2,
    T* __restrict__ scores, T* __restrict__ user, Dims dm) {
  using namespace fedrec;
  extern __shared__ __align__(16) float smem[];
  const int H = dm.H, D = dm.D, dh = dm.dh, Hp = dm.Hp;
  float* xs = smem;                        // (Hp, D)
  float* ctx = xs + (size_t)Hp * D;        // (Hp, D)
  float* qkv = ctx + (size_t)Hp * D;       // 3 x (Hp, dh)
  float* S = qkv + 3 * (size_t)Hp * dh;    // (Hp, H)
  float* red = S + (size_t)Hp * H;         // (Qpad/32, Hp)
  float* alpha = red + (size_t)(dm.Qpad / 32) * Hp;  // (Hp)
  float* mk = alpha + Hp;                  // (H)
  float* us = mk + H;                      // (D)

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const T* xr = x + (size_t)row * H * D;
  for (int i = tid; i < Hp * D; i += blockDim.x) {
    xs[i] = i < H * D ? to_f32(xr[i]) : 0.f;
    ctx[i] = 0.f;
  }
  for (int t = tid; t < H; t += blockDim.x) mk[t] = mask ? mask[(size_t)row * H + t] : 1.f;
  __syncthreads();

  const float scale = sqrtf(static_cast<float>(dh));
  const int ntiles = Hp / TR;
  for (int h = 0; h < dm.nh; ++h) {
    // ---- q/k/v for head h: items (row tile, column of q|k|v)
    for (int w = tid; w < ntiles * dm.colpad; w += blockDim.x) {
      const int c = w % dm.colpad;
      if (c >= 3 * dh) continue;
      const int t0 = (w / dm.colpad) * TR;
      const int m = c / dh, i = c % dh, col = h * dh + i;
      const T* W = m == 0 ? wq : (m == 1 ? wk : wv);
      const T* B = m == 0 ? bq : (m == 1 ? bk : bv);
      float acc[TR];
#pragma unroll
      for (int tt = 0; tt < TR; ++tt) acc[tt] = 0.f;
      for (int k = 0; k < D; k += 4) {
        const float wa = to_f32(W[(size_t)k * D + col]);
        const float wb = to_f32(W[(size_t)(k + 1) * D + col]);
        const float wc = to_f32(W[(size_t)(k + 2) * D + col]);
        const float wd = to_f32(W[(size_t)(k + 3) * D + col]);
#pragma unroll
        for (int tt = 0; tt < TR; ++tt) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[(t0 + tt) * D + k]);
          acc[tt] = fmaf(xv.x, wa, acc[tt]);
          acc[tt] = fmaf(xv.y, wb, acc[tt]);
          acc[tt] = fmaf(xv.z, wc, acc[tt]);
          acc[tt] = fmaf(xv.w, wd, acc[tt]);
        }
      }
      const float b = to_f32(B[col]);
      float* dst = qkv + (size_t)m * Hp * dh;
#pragma unroll
      for (int tt = 0; tt < TR; ++tt) dst[(t0 + tt) * dh + i] = round_to<T>(acc[tt] + b);
    }
    __syncthreads();
    const float* qh = qkv;
    const float* kh = qkv + (size_t)Hp * dh;
    const float* vh = qkv + 2 * (size_t)Hp * dh;

    // ---- scores s[t][u] = q_t . k_u / sqrt(dh)
    for (int w = tid; w < H * H; w += blockDim.x) {
      const int t = w / H, u = w % H;
      float acc = 0.f;
      for (int i = 0; i < dh; ++i) acc = fmaf(qh[t * dh + i], kh[u * dh + i], acc);
      S[t * H + u] = acc / scale;
    }
    __syncthreads();

    // ---- masked softmax per query row (one warp per row)
    for (int t = warp; t < H; t += nwarps) {
      float* s = S + t * H;
      float m = -INFINITY;
      for (int u = lane; u < H; u += 32) m = fmaxf(m, s[u]);
      m = warp_max(m);
      float sum = 0.f;
      for (int u = lane; u < H; u += 32) {
        const float e = expf(s[u] - m) * mk[u];
        s[u] = e;
        sum += e;
      }
      sum = warp_sum(sum) + kEps;
      for (int u = lane; u < H; u += 32) s[u] = round_to<T>(s[u] / sum);
    }
    __syncthreads();

    // ---- ctx[:, head h] = a . v_h
    for (int w = tid; w < H * dh; w += blockDim.x) {
      const int t = w / dh, i = w % dh;
      float acc = 0.f;
      for (int u = 0; u < H; ++u) acc = fmaf(S[t * H + u], vh[u * dh + i], acc);
      ctx[t * D + h * dh + i] = round_to<T>(acc);
    }
    __syncthreads();
  }

  // ---- pool logits lg[t] = sum_j dt(tanh(ctx_t . pw1_j + pb1_j)) * pw2_j
  for (int w = tid; w < ntiles * dm.Qpad; w += blockDim.x) {
    const int t0 = (w / dm.Qpad) * TR;
    const int j = w % dm.Qpad;
    float part[TR];
#pragma unroll
    for (int tt = 0; tt < TR; ++tt) part[tt] = 0.f;
    if (j < dm.Q) {
      float acc[TR];
#pragma unroll
      for (int tt = 0; tt < TR; ++tt) acc[tt] = 0.f;
      for (int k = 0; k < D; k += 4) {
        const float wa = to_f32(pw1[(size_t)k * dm.Q + j]);
        const float wb = to_f32(pw1[(size_t)(k + 1) * dm.Q + j]);
        const float wc = to_f32(pw1[(size_t)(k + 2) * dm.Q + j]);
        const float wd = to_f32(pw1[(size_t)(k + 3) * dm.Q + j]);
#pragma unroll
        for (int tt = 0; tt < TR; ++tt) {
          const float4 cv = *reinterpret_cast<const float4*>(&ctx[(t0 + tt) * D + k]);
          acc[tt] = fmaf(cv.x, wa, acc[tt]);
          acc[tt] = fmaf(cv.y, wb, acc[tt]);
          acc[tt] = fmaf(cv.z, wc, acc[tt]);
          acc[tt] = fmaf(cv.w, wd, acc[tt]);
        }
      }
      const float b = to_f32(pb1[j]), q = to_f32(pw2[j]);
#pragma unroll
      for (int tt = 0; tt < TR; ++tt) part[tt] = round_to<T>(tanhf(acc[tt] + b)) * q;
    }
#pragma unroll
    for (int tt = 0; tt < TR; ++tt) {
      const float s = warp_sum(part[tt]);
      if (lane == 0) red[(j / 32) * Hp + t0 + tt] = s;
    }
  }
  __syncthreads();

  // ---- pool weights: the same masked softmax over the H slots
  if (warp == 0) {
    const int jb = dm.Qpad / 32;
    float m = -INFINITY;
    for (int t = lane; t < H; t += 32) {
      float lg = 0.f;
      for (int b = 0; b < jb; ++b) lg += red[b * Hp + t];
      alpha[t] = lg;
      m = fmaxf(m, lg);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < H; t += 32) {
      const float e = expf(alpha[t] - m) * mk[t];
      alpha[t] = e;
      sum += e;
    }
    sum = warp_sum(sum) + kEps;
    for (int t = lane; t < H; t += 32) alpha[t] = round_to<T>(alpha[t] / sum);
  }
  __syncthreads();

  // ---- user = alpha . ctx, rounded to the operand dtype
  for (int d = tid; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < H; ++t) acc = fmaf(alpha[t], ctx[t * D + d], acc);
    const float u = round_to<T>(acc);
    us[d] = u;
    user[(size_t)row * D + d] = from_f32<T>(u);
  }
  __syncthreads();

  // ---- scores against the candidates (one warp per candidate)
  for (int c = warp; c < dm.C; c += nwarps) {
    const T* cv = cand + ((size_t)row * dm.C + c) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(cv[d]), us[d], acc);
    acc = warp_sum(acc);
    if (lane == 0) scores[(size_t)row * dm.C + c] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* const* p, void* scores, void* user, int n, Dims dm, void* stream) {
  const size_t smem = smem_floats(dm) * sizeof(float);
  cudaError_t err = fedrec::allow_smem(fused_history_score_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (dm.Hp / TR) * dm.colpad;
  if (threads < 128) threads = 128;
  if (threads > 1024) threads = 1024;
  if (n > 0) {
    fused_history_score_kernel<T><<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
        static_cast<const float*>(p[2]), static_cast<const T*>(p[3]),
        static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
        static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
        static_cast<const T*>(p[8]), static_cast<const T*>(p[9]),
        static_cast<const T*>(p[10]), static_cast<const T*>(p[11]),
        static_cast<T*>(scores), static_cast<T*>(user), dm);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

size_t fused_history_score_smem_bytes(int H, int D, int Q, int nh) {
  return smem_floats(make_dims(H, D, 0, Q, nh)) * sizeof(float);
}

// x (n, H, D), cand (n, C, D) or null when C == 0, mask (n, H) f32 or null,
// wq/wk/wv (D, D), bq/bk/bv (D), pw1 (D, Q), pb1 (Q), pw2 (Q), all in the
// operand dtype (0 f32, 1 bf16); scores (n, C) or null, user (n, D) in the
// operand dtype. Returns cudaGetLastError() after the launch.
int fused_history_score_launch(const void* x, const void* cand, const void* mask,
                               const void* wq, const void* bq, const void* wk,
                               const void* bk, const void* wv, const void* bv,
                               const void* pw1, const void* pb1, const void* pw2,
                               void* scores, void* user, int n, int H, int D, int C, int Q,
                               int nh, int dtype, void* stream) {
  const void* p[12] = {x, cand, mask, wq, bq, wk, bk, wv, bv, pw1, pb1, pw2};
  const Dims dm = make_dims(H, D, C, Q, nh);
  if (dtype == 0) return launch<float>(p, scores, user, n, dm, stream);
  return launch<__nv_bfloat16>(p, scores, user, n, dm, stream);
}

}  // extern "C"
