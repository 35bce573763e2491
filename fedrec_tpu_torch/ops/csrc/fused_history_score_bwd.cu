// Kernel E: the fused user tower and scorer, backward.
//
// Replaces the Pallas kernel fedrec_tpu/ops/fused_hot_path.py:
// _hist_score_bwd_kernel (reached through _hist_score_vjp_bwd). Given the
// cotangents of kernel B's outputs, g_scores (n, C) and g_user (n, D), it
// returns dx (n, H, D), dcand (n, C, D) and the nine weight cotangents: dWq,
// dWk, dWv (D, D) and their biases, dpw1 (D, Q), dpb1 and dpw2 (Q). The mask
// gets none. As in the JAX kernel, the backward treats each softmax's
// stabilising max as a constant, runs in f32, and reads the forward's
// rounded q/k/v and ctx but its unrounded attention weights, pool hidden
// e32, pool weights and user vector.
//
// Two stages:
//   1. one block per history row recomputes kernel B's forward with B's
//      rounding points, then walks back: scorer (dcand, du), additive pool
//      (dalpha, dlg, dpre, dctx), each head's attention (da, ds / sqrt(dh),
//      dq, dk, dv) and dx = dQ Wq^T + dK Wk^T + dV Wv^T. dx and dcand are
//      written directly.
//   2. the weight sums, by the deterministic tiled reduction of wgrad.cuh:
//      x^T dQ, x^T dK, x^T dV, ctx^T dpre and the column sums.
//
// Shared memory is the constraint: kernel B already keeps x and ctx, (H, D)
// each in f32 (160 KB at H=50, D=400); x, ctx and dctx together would be
// 240 KB, above the 227 KB a block may have. So one (H, D) region holds x,
// then dctx, then each dY in turn, and a second holds ctx, then dpre, then
// the per-head da, then the dx sum. What a later phase or stage 2 needs goes
// to global scratch that the wrapper allocates: q/k/v (overwritten, head by
// head, with dq/dk/dv), ctx, e32 (overwritten with dpre) and each row's dpw2
// share.
//
// Bound on an H100 (f32, n=64, H=50, D=400, 20 heads, Q=200, C=5): the
// recompute and the backward products are about 3x kernel B's 60 MFLOP per
// row, and stage 2 another 2 n H D (3 D + Q): about 13.8 GFLOP in all, 0.2 ms
// at 67 TFLOP/s, against a few MB of traffic: bound by operations. With 64
// rows on 132 SMs, stage 1 leaves half the card idle; this simple version is
// far above its bound (PERF.md).
#include <stdint.h>

#include "common.cuh"
#include "wgrad.cuh"

namespace {

constexpr int TR = 10;        // history rows per register tile
constexpr float kEps = 1e-8f; // the module's denominator epsilon

struct Dims {
  int H, D, C, Q, nh, dh, Hp, colpad, Qpad, W2;
};

__host__ __device__ inline Dims make_dims(int H, int D, int C, int Q, int nh) {
  Dims d;
  d.H = H; d.D = D; d.C = C; d.Q = Q; d.nh = nh; d.dh = D / nh;
  d.Hp = (H + TR - 1) / TR * TR;
  d.colpad = (3 * d.dh + 31) / 32 * 32;
  d.Qpad = (Q + 31) / 32 * 32;
  d.W2 = D;  // width of the second (H, .) region: ctx, dpre, da, dx
  if (Q > d.W2) d.W2 = Q;
  if (H > d.W2) d.W2 = H;
  return d;
}

__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return (size_t)d.Hp * d.D          // r1: x, dctx, dY
         + (size_t)d.Hp * d.W2       // r2: ctx, dpre, da, dx
         + 3 * (size_t)d.Hp * d.dh   // one head's q, k, v
         + (size_t)d.Hp * d.H        // one head's attention weights
         + (size_t)(d.Qpad / 32) * d.Hp  // per-warp pool-logit sums
         + 3 * (size_t)d.Hp          // alpha, dalpha, dlg
         + d.H + 2 * (size_t)d.D;    // mask, user, du
}

__host__ inline int block_threads(const Dims& d) {
  int t = (d.Hp / TR) * d.colpad;
  if (t < 128) t = 128;
  return t > 1024 ? 1024 : t;
}

struct Scratch {
  float *qkv, *ctx, *ep, *dpw2_rows, *partial;
};

__host__ __device__ inline Scratch carve(float* base, int n, const Dims& d) {
  Scratch s;
  s.qkv = base;                                      // (n, 3, H, D)
  s.ctx = s.qkv + 3 * (size_t)n * d.H * d.D;         // (n, H, D)
  s.ep = s.ctx + (size_t)n * d.H * d.D;              // (n, H, Q): e32, then dpre
  s.dpw2_rows = s.ep + (size_t)n * d.H * d.Q;        // (n, Q)
  s.partial = s.dpw2_rows + (size_t)n * d.Q;
  return s;
}

// Masked exp-normalization of `len` values in place by one warp:
// exp(v - max) * mask / (sum + 1e-8), the max over every slot.
__device__ inline void warp_softmax(float* v, const float* mk, int len, int lane) {
  using namespace fedrec;
  float m = -INFINITY;
  for (int u = lane; u < len; u += 32) m = fmaxf(m, v[u]);
  m = warp_max(m);
  float sum = 0.f;
  for (int u = lane; u < len; u += 32) {
    const float e = expf(v[u] - m) * mk[u];
    v[u] = e;
    sum += e;
  }
  sum = warp_sum(sum) + kEps;
  for (int u = lane; u < len; u += 32) v[u] = v[u] / sum;
}

template <typename T>
__global__ void hist_score_bwd_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ cand, const float* __restrict__ mask,
    const T* __restrict__ wq, const T* __restrict__ bq, const T* __restrict__ wk,
    const T* __restrict__ bk, const T* __restrict__ wv, const T* __restrict__ bv,
    const T* __restrict__ pw1, const T* __restrict__ pb1, const T* __restrict__ pw2,
    const float* __restrict__ gs, const float* __restrict__ gu, T* __restrict__ dx,
    T* __restrict__ dcand, float* __restrict__ scratch, int n, Dims dm) {
  using namespace fedrec;
  extern __shared__ __align__(16) float smem[];
  const int H = dm.H, D = dm.D, Q = dm.Q, dh = dm.dh, Hp = dm.Hp;
  float* r1 = smem;                                  // (Hp, D)
  float* r2 = r1 + (size_t)Hp * D;                   // (Hp, W2)
  float* qkv = r2 + (size_t)Hp * dm.W2;              // 3 x (Hp, dh)
  float* S = qkv + 3 * (size_t)Hp * dh;              // (Hp, H)
  float* red = S + (size_t)Hp * H;                   // (Qpad/32, Hp)
  float* alpha = red + (size_t)(dm.Qpad / 32) * Hp;  // (Hp) unrounded
  float* dalpha = alpha + Hp;                        // (Hp)
  float* dlg = dalpha + Hp;                          // (Hp)
  float* mk = dlg + Hp;                              // (H)
  float* us = mk + H;                                // (D) unrounded user
  float* du = us + D;                                // (D)

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const Scratch sc = carve(scratch, n, dm);
  float* gqkv = sc.qkv + (size_t)row * 3 * H * D;    // this row's (3, H, D)
  float* gctx = sc.ctx + (size_t)row * H * D;
  float* gep = sc.ep + (size_t)row * H * Q;
  const float scale = sqrtf(static_cast<float>(dh));
  const int ntiles = Hp / TR;

  const T* xr = x + (size_t)row * H * D;
  for (int i = tid; i < Hp * D; i += blockDim.x) {
    r1[i] = i < H * D ? to_f32(xr[i]) : 0.f;
    r2[i] = 0.f;  // ctx; rows >= H stay zero
  }
  for (int t = tid; t < H; t += blockDim.x) mk[t] = mask ? mask[(size_t)row * H + t] : 1.f;
  __syncthreads();

  // ================= forward recompute (kernel B's math and rounding)
  for (int h = 0; h < dm.nh; ++h) {
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
          const float4 xv = *reinterpret_cast<const float4*>(&r1[(t0 + tt) * D + k]);
          acc[tt] = fmaf(xv.x, wa, acc[tt]);
          acc[tt] = fmaf(xv.y, wb, acc[tt]);
          acc[tt] = fmaf(xv.z, wc, acc[tt]);
          acc[tt] = fmaf(xv.w, wd, acc[tt]);
        }
      }
      const float b = to_f32(B[col]);
      float* dst = qkv + (size_t)m * Hp * dh;
#pragma unroll
      for (int tt = 0; tt < TR; ++tt) {
        const float v = round_to<T>(acc[tt] + b);
        dst[(t0 + tt) * dh + i] = v;
        if (t0 + tt < H) gqkv[((size_t)m * H + t0 + tt) * D + col] = v;
      }
    }
    __syncthreads();
    const float* qh = qkv;
    const float* kh = qkv + (size_t)Hp * dh;
    const float* vh = qkv + 2 * (size_t)Hp * dh;
    for (int w = tid; w < H * H; w += blockDim.x) {
      const int t = w / H, u = w % H;
      float acc = 0.f;
      for (int i = 0; i < dh; ++i) acc = fmaf(qh[t * dh + i], kh[u * dh + i], acc);
      S[t * H + u] = acc / scale;
    }
    __syncthreads();
    for (int t = warp; t < H; t += nwarps) {
      warp_softmax(S + t * H, mk, H, lane);
      for (int u = lane; u < H; u += 32) S[t * H + u] = round_to<T>(S[t * H + u]);
    }
    __syncthreads();
    for (int w = tid; w < H * dh; w += blockDim.x) {
      const int t = w / dh, i = w % dh;
      float acc = 0.f;
      for (int u = 0; u < H; ++u) acc = fmaf(S[t * H + u], vh[u * dh + i], acc);
      r2[t * D + h * dh + i] = round_to<T>(acc);
    }
    __syncthreads();
  }
  for (int i = tid; i < H * D; i += blockDim.x) gctx[i] = r2[i];

  // pool hidden e32 (to scratch) and logits sum_j dt(e32) pw2_j
  for (int w = tid; w < ntiles * dm.Qpad; w += blockDim.x) {
    const int t0 = (w / dm.Qpad) * TR;
    const int j = w % dm.Qpad;
    float part[TR];
#pragma unroll
    for (int tt = 0; tt < TR; ++tt) part[tt] = 0.f;
    if (j < Q) {
      float acc[TR];
#pragma unroll
      for (int tt = 0; tt < TR; ++tt) acc[tt] = 0.f;
      for (int k = 0; k < D; k += 4) {
        const float wa = to_f32(pw1[(size_t)k * Q + j]);
        const float wb = to_f32(pw1[(size_t)(k + 1) * Q + j]);
        const float wc = to_f32(pw1[(size_t)(k + 2) * Q + j]);
        const float wd = to_f32(pw1[(size_t)(k + 3) * Q + j]);
#pragma unroll
        for (int tt = 0; tt < TR; ++tt) {
          const float4 cv = *reinterpret_cast<const float4*>(&r2[(t0 + tt) * D + k]);
          acc[tt] = fmaf(cv.x, wa, acc[tt]);
          acc[tt] = fmaf(cv.y, wb, acc[tt]);
          acc[tt] = fmaf(cv.z, wc, acc[tt]);
          acc[tt] = fmaf(cv.w, wd, acc[tt]);
        }
      }
      const float b = to_f32(pb1[j]), q = to_f32(pw2[j]);
#pragma unroll
      for (int tt = 0; tt < TR; ++tt) {
        const float e = tanhf(acc[tt] + b);
        if (t0 + tt < H) gep[(size_t)(t0 + tt) * Q + j] = e;
        part[tt] = round_to<T>(e) * q;
      }
    }
#pragma unroll
    for (int tt = 0; tt < TR; ++tt) {
      const float s = warp_sum(part[tt]);
      if (lane == 0) red[(j / 32) * Hp + t0 + tt] = s;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int jb = dm.Qpad / 32;
    for (int t = lane; t < H; t += 32) {
      float lg = 0.f;
      for (int b = 0; b < jb; ++b) lg += red[b * Hp + t];
      alpha[t] = lg;
    }
    __syncwarp();
    warp_softmax(alpha, mk, H, lane);
  }
  __syncthreads();
  // user = dt(alpha) . ctx, kept unrounded for the backward
  for (int d = tid; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < H; ++t) acc = fmaf(round_to<T>(alpha[t]), r2[t * D + d], acc);
    us[d] = acc;
  }
  __syncthreads();

  // ================= scorer and pool backward
  for (int d = tid; d < D; d += blockDim.x) {
    float acc = gu[(size_t)row * D + d];
    for (int c = 0; c < dm.C; ++c) {
      const float g = gs[(size_t)row * dm.C + c];
      acc = fmaf(g, to_f32(cand[((size_t)row * dm.C + c) * D + d]), acc);
      dcand[((size_t)row * dm.C + c) * D + d] = from_f32<T>(g * us[d]);
    }
    du[d] = acc;
  }
  __syncthreads();
  for (int t = warp; t < H; t += nwarps) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(du[d], r2[t * D + d], acc);
    acc = warp_sum(acc);
    if (lane == 0) dalpha[t] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int t = lane; t < H; t += 32) s = fmaf(alpha[t], dalpha[t], s);
    s = warp_sum(s);
    for (int t = lane; t < H; t += 32) dlg[t] = alpha[t] * (dalpha[t] - s);
  }
  __syncthreads();
  // dpre = dlg pw2 (1 - e32^2), to scratch (over e32) and to r2 (over ctx);
  // this row's dpw2 share = dlg . e32
  for (int j = tid; j < Q; j += blockDim.x) {
    const float q = to_f32(pw2[j]);
    float acc = 0.f;
    for (int t = 0; t < Hp; ++t) {
      float dp = 0.f;
      if (t < H) {
        const float e = gep[(size_t)t * Q + j];
        acc = fmaf(dlg[t], e, acc);
        dp = dlg[t] * q * (1.f - e * e);
        gep[(size_t)t * Q + j] = dp;
      }
      r2[t * Q + j] = dp;
    }
    sc.dpw2_rows[(size_t)row * Q + j] = acc;
  }
  __syncthreads();
  // dctx = alpha du + dpre pw1^T into r1 (x is no longer needed)
  for (int w = tid; w < ntiles * D; w += blockDim.x) {
    const int t0 = (w / D) * TR;
    const int d = w % D;
    float acc[TR];
#pragma unroll
    for (int tt = 0; tt < TR; ++tt) acc[tt] = 0.f;
    const T* prow = pw1 + (size_t)d * Q;
    for (int j = 0; j < Q; j += 4) {
      const float pa = to_f32(prow[j]), pb = to_f32(prow[j + 1]);
      const float pc = to_f32(prow[j + 2]), pd = to_f32(prow[j + 3]);
#pragma unroll
      for (int tt = 0; tt < TR; ++tt) {
        const float4 dv = *reinterpret_cast<const float4*>(&r2[(t0 + tt) * Q + j]);
        acc[tt] = fmaf(dv.x, pa, acc[tt]);
        acc[tt] = fmaf(dv.y, pb, acc[tt]);
        acc[tt] = fmaf(dv.z, pc, acc[tt]);
        acc[tt] = fmaf(dv.w, pd, acc[tt]);
      }
    }
#pragma unroll
    for (int tt = 0; tt < TR; ++tt) {
      const int t = t0 + tt;
      r1[t * D + d] = t < H ? fmaf(alpha[t], du[d], acc[tt]) : 0.f;
    }
  }
  __syncthreads();

  // ================= per-head attention backward (r1 = dctx, r2 = da)
  float* da = r2;
  for (int h = 0; h < dm.nh; ++h) {
    for (int w = tid; w < 3 * Hp * dh; w += blockDim.x) {
      const int m = w / (Hp * dh), rest = w % (Hp * dh), t = rest / dh, i = rest % dh;
      qkv[w] = t < H ? gqkv[((size_t)m * H + t) * D + h * dh + i] : 0.f;
    }
    __syncthreads();
    const float* qh = qkv;
    const float* kh = qkv + (size_t)Hp * dh;
    const float* vh = qkv + 2 * (size_t)Hp * dh;
    for (int w = tid; w < H * H; w += blockDim.x) {
      const int t = w / H, u = w % H;
      float s = 0.f, g = 0.f;
      for (int i = 0; i < dh; ++i) {
        s = fmaf(qh[t * dh + i], kh[u * dh + i], s);
        g = fmaf(r1[t * D + h * dh + i], vh[u * dh + i], g);
      }
      S[t * H + u] = s / scale;
      da[t * H + u] = g;
    }
    __syncthreads();
    for (int t = warp; t < H; t += nwarps) {
      float* a = S + t * H;
      warp_softmax(a, mk, H, lane);
      __syncwarp();
      float s = 0.f;
      for (int u = lane; u < H; u += 32) s = fmaf(a[u], da[t * H + u], s);
      s = warp_sum(s);
      for (int u = lane; u < H; u += 32) da[t * H + u] = a[u] * (da[t * H + u] - s) / scale;
    }
    __syncthreads();
    // dq = ds kh, dk = ds^T qh, dv = a^T dctx_h, over this head's q/k/v columns
    for (int w = tid; w < 3 * H * dh; w += blockDim.x) {
      const int m = w / (H * dh), rest = w % (H * dh), t = rest / dh, i = rest % dh;
      float acc = 0.f;
      if (m == 0) {
        for (int u = 0; u < H; ++u) acc = fmaf(da[t * H + u], kh[u * dh + i], acc);
      } else if (m == 1) {
        for (int u = 0; u < H; ++u) acc = fmaf(da[u * H + t], qh[u * dh + i], acc);
      } else {
        for (int u = 0; u < H; ++u) acc = fmaf(S[u * H + t], r1[u * D + h * dh + i], acc);
      }
      gqkv[((size_t)m * H + t) * D + h * dh + i] = acc;
    }
    __syncthreads();
  }

  // ================= dx = dQ Wq^T + dK Wk^T + dV Wv^T (r1 = dY, r2 = sum)
  for (int i = tid; i < Hp * D; i += blockDim.x) r2[i] = 0.f;
  for (int m = 0; m < 3; ++m) {
    const T* W = m == 0 ? wq : (m == 1 ? wk : wv);
    for (int i = tid; i < Hp * D; i += blockDim.x) {
      r1[i] = i < H * D ? gqkv[(size_t)m * H * D + i] : 0.f;
    }
    __syncthreads();
    for (int w = tid; w < ntiles * D; w += blockDim.x) {
      const int t0 = (w / D) * TR;
      const int d = w % D;
      float acc[TR];
#pragma unroll
      for (int tt = 0; tt < TR; ++tt) acc[tt] = 0.f;
      const T* wrow = W + (size_t)d * D;
      for (int k = 0; k < D; k += 4) {
        const float wa = to_f32(wrow[k]), wb = to_f32(wrow[k + 1]);
        const float wc = to_f32(wrow[k + 2]), wd = to_f32(wrow[k + 3]);
#pragma unroll
        for (int tt = 0; tt < TR; ++tt) {
          const float4 yv = *reinterpret_cast<const float4*>(&r1[(t0 + tt) * D + k]);
          acc[tt] = fmaf(yv.x, wa, acc[tt]);
          acc[tt] = fmaf(yv.y, wb, acc[tt]);
          acc[tt] = fmaf(yv.z, wc, acc[tt]);
          acc[tt] = fmaf(yv.w, wd, acc[tt]);
        }
      }
#pragma unroll
      for (int tt = 0; tt < TR; ++tt) r2[(t0 + tt) * D + d] += acc[tt];
    }
    __syncthreads();
  }
  T* dxr = dx + (size_t)row * H * D;
  for (int i = tid; i < H * D; i += blockDim.x) dxr[i] = from_f32<T>(r2[i]);
}

template <typename T>
int launch(const void* const* p, const float* gs, const float* gu, void* dx, void* dcand,
           float* scratch, float* const* grads, int n, Dims dm, void* stream_) {
  using namespace fedrec;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t smem = smem_floats(dm) * sizeof(float);
  cudaError_t err = allow_smem(hist_score_bwd_rows_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    hist_score_bwd_rows_kernel<T><<<n, block_threads(dm), smem, stream>>>(
        static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
        static_cast<const float*>(p[2]), static_cast<const T*>(p[3]),
        static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
        static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
        static_cast<const T*>(p[8]), static_cast<const T*>(p[9]),
        static_cast<const T*>(p[10]), static_cast<const T*>(p[11]), gs, gu,
        static_cast<T*>(dx), static_cast<T*>(dcand), scratch, n, dm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Scratch sc = carve(scratch, n, dm);
  const int R = n * dm.H;
  const RowMap x_rows = rows_contiguous(p[0], dm.D);
  for (int m = 0; m < 3; ++m) {  // dW, db for q, k, v
    const RowMap dy{sc.qkv + (size_t)m * dm.H * dm.D, nullptr, dm.H, 3LL * dm.H * dm.D, dm.D, 0};
    err = wgrad<T>(x_rows, dy, R, dm.D, dm.D, sc.partial, grads[2 * m], grads[2 * m + 1], stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = wgrad<float>(rows_contiguous(sc.ctx, dm.D), rows_contiguous(sc.ep, dm.Q), R, dm.D, dm.Q,
                     sc.partial, grads[6], grads[7], stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = wgrad<float>(rows_contiguous(sc.dpw2_rows, dm.Q), rows_contiguous(sc.dpw2_rows, dm.Q), n,
                     0, dm.Q, sc.partial, nullptr, grads[8], stream);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

size_t fused_history_score_bwd_smem_bytes(int H, int D, int Q, int nh) {
  return smem_floats(make_dims(H, D, 0, Q, nh)) * sizeof(float);
}

size_t fused_history_score_bwd_scratch_floats(int n, int H, int D, int Q, int nh) {
  using namespace fedrec;
  (void)nh;
  size_t part = wgrad_scratch_floats(n * H, D, D);
  const size_t p2 = wgrad_scratch_floats(n * H, D, Q);
  const size_t p3 = wgrad_scratch_floats(n, 0, Q);
  if (p2 > part) part = p2;
  if (p3 > part) part = p3;
  return 4 * (size_t)n * H * D + (size_t)n * H * Q + (size_t)n * Q + part;
}

// x (n, H, D), cand (n, C, D) or null when C == 0, mask (n, H) f32 or null,
// the nine weights as kernel B takes them, all in the operand dtype (0 f32,
// 1 bf16); g_scores (n, C) f32 or null, g_user (n, D) f32; scratch of
// fused_history_score_bwd_scratch_floats floats. Outputs: dx (n, H, D) and
// dcand (n, C, D) in the operand dtype, and f32 dwq, dbq, dwk, dbk, dwv, dbv,
// dpw1, dpb1, dpw2. Returns the first launch error.
int fused_history_score_bwd_launch(const void* x, const void* cand, const void* mask,
                                   const void* wq, const void* bq, const void* wk,
                                   const void* bk, const void* wv, const void* bv,
                                   const void* pw1, const void* pb1, const void* pw2,
                                   const void* g_scores, const void* g_user, void* dx,
                                   void* dcand, void* scratch, void* dwq, void* dbq, void* dwk,
                                   void* dbk, void* dwv, void* dbv, void* dpw1, void* dpb1,
                                   void* dpw2, int n, int H, int D, int C, int Q, int nh,
                                   int dtype, void* stream) {
  const void* p[12] = {x, cand, mask, wq, bq, wk, bk, wv, bv, pw1, pb1, pw2};
  float* grads[9] = {static_cast<float*>(dwq), static_cast<float*>(dbq),
                     static_cast<float*>(dwk), static_cast<float*>(dbk),
                     static_cast<float*>(dwv), static_cast<float*>(dbv),
                     static_cast<float*>(dpw1), static_cast<float*>(dpb1),
                     static_cast<float*>(dpw2)};
  const Dims dm = make_dims(H, D, C, Q, nh);
  const float* gs = static_cast<const float*>(g_scores);
  const float* gu = static_cast<const float*>(g_user);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) return launch<float>(p, gs, gu, dx, dcand, sc, grads, n, dm, stream);
  return launch<__nv_bfloat16>(p, gs, gu, dx, dcand, sc, grads, n, dm, stream);
}

}  // extern "C"
