// Kernels C and D: the fused frozen-table gather + additive text head,
// forward (C) and backward (D).
//
// C replaces the Pallas kernel fedrec_tpu/ops/fused_hot_path.py:
// _gather_encode_fwd_kernel (reached through _gather_encode and
// fused_gather_encode). For each unique news id u of a train step:
//   x     = table[ids[u]]                      (T=50, Dh=768), never copied out
//   e     = dt(tanh(x W1 + b1))                (T, Ah=384)
//   alpha = dt(softmax_eps(e w2))              (T)   exp(l - max) / (sum + 1e-8)
//   out   = dt(dt(alpha . x) fcW + fcb)        (D=400)
// with dt() the operand dtype's rounding at exactly the JAX kernel's points.
// The fc2 bias is not an input: it shifts every logit equally.
//
// D replaces _gather_encode_bwd_kernel (reached through _gather_encode_bwd).
// It returns dW1, db1, dw2, dfcW and dfcb only: the trunk is frozen, so the
// table gets no cotangent. In two stages:
//   1. one block per id re-gathers its row and recomputes e32, alpha and the
//      f32 pooled vector, then walks back: dpooled = g fcW^T, dalpha = dpooled
//      x^T, dlg = alpha (dalpha - sum alpha dalpha), dpre = dlg w2 (1 - e32^2).
//      It writes dpre (U, T, Ah), pooled (U, Dh) and the id's share of dw2
//      (U, Ah) to scratch.
//   2. the deterministic tiled sums of wgrad.cuh: dW1 = sum_u X_u^T dpre_u
//      (X re-gathered by id, never materialized), db1 = sum dpre, dw2 = the
//      column sums of the shares, dfcW = pooled^T g, dfcb = sum g.
// All of it in f32 (the JAX backward uses x32 and the unrounded pooled).
// Padded ids get g = 0 and add exactly zero.
//
// Bound on an H100 (f32): per id, the x W1 product is 2 T Dh Ah = 29.5 MFLOP
// against 154 KB of row, about 190 FLOP per byte: bound by FP32 operations,
// not by HBM. At the main path's U = 3,520 ids, C is 104 GFLOP (1.6 ms at
// 67 TFLOP/s) and D about twice that (its recompute plus the dW1 sum).
//
// Design: one block per id stages the row once in shared memory (150 KB in
// f32: the >48 KB opt-in), the kernel-A item scheme computes the logits (a
// tile of 25 token rows x one hidden unit per work item, 25 f32 accumulators,
// W1 read from L2), and every reduction runs in a fixed order. Out-of-range
// ids are clamped into the table, as JAX's gather clamps them.
#include <stdint.h>

#include "common.cuh"
#include "wgrad.cuh"

namespace {

constexpr int TL = 25;        // token rows per register tile
constexpr float kEps = 1e-8f; // the module's denominator epsilon

struct Dims {
  int N, T, Dh, Ah, D, Lp, Apad;
};

__host__ __device__ inline Dims make_dims(int N, int T, int Dh, int Ah, int D) {
  Dims d;
  d.N = N; d.T = T; d.Dh = Dh; d.Ah = Ah; d.D = D;
  d.Lp = (T + TL - 1) / TL * TL;
  d.Apad = (Ah + 31) / 32 * 32;
  return d;
}

// shared floats: row (Lp, Dh), per-warp logit sums, alpha, and one Dh and one
// D vector (pooled, dpooled / g)
__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return (size_t)d.Lp * d.Dh + (size_t)(d.Apad / 32) * d.Lp + 3 * (size_t)d.Lp + d.Dh + d.D;
}

__host__ inline int block_threads(const Dims& d) {
  int t = d.Apad;
  if (t < 128) t = 128;
  return t > 512 ? 512 : t;
}

// Stage row `id` of the table as f32 (rows >= T are zero), then the pool
// logits lg[t] = sum_j dt(tanh(x_t . W1_j + b1_j)) w2_j into red, per warp.
// With e32 != null, the unrounded tanh values are stored there too (T, Ah).
template <typename T>
__device__ void stage_and_logits(const T* __restrict__ table, int64_t id, const T* __restrict__ w1,
                                 const T* __restrict__ b1, const T* __restrict__ w2,
                                 const Dims& dm, float* xs, float* red, float* __restrict__ e32) {
  using namespace fedrec;
  const int tid = threadIdx.x, lane = tid & 31;
  id = id < 0 ? 0 : (id >= dm.N ? dm.N - 1 : id);
  const T* xr = table + id * dm.T * dm.Dh;
  for (int i = tid; i < dm.Lp * dm.Dh; i += blockDim.x) {
    xs[i] = i < dm.T * dm.Dh ? to_f32(xr[i]) : 0.f;
  }
  __syncthreads();
  const int items = (dm.Lp / TL) * dm.Apad;
  for (int w = tid; w < items; w += blockDim.x) {
    const int t0 = (w / dm.Apad) * TL;
    const int j = w % dm.Apad;
    float part[TL];
#pragma unroll
    for (int tt = 0; tt < TL; ++tt) part[tt] = 0.f;
    if (j < dm.Ah) {
      float acc[TL];
#pragma unroll
      for (int tt = 0; tt < TL; ++tt) acc[tt] = 0.f;
      for (int k = 0; k < dm.Dh; k += 4) {
        const float wa = to_f32(w1[(size_t)k * dm.Ah + j]);
        const float wb = to_f32(w1[(size_t)(k + 1) * dm.Ah + j]);
        const float wc = to_f32(w1[(size_t)(k + 2) * dm.Ah + j]);
        const float wd = to_f32(w1[(size_t)(k + 3) * dm.Ah + j]);
#pragma unroll
        for (int tt = 0; tt < TL; ++tt) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[(t0 + tt) * dm.Dh + k]);
          acc[tt] = fmaf(xv.x, wa, acc[tt]);
          acc[tt] = fmaf(xv.y, wb, acc[tt]);
          acc[tt] = fmaf(xv.z, wc, acc[tt]);
          acc[tt] = fmaf(xv.w, wd, acc[tt]);
        }
      }
      const float bj = to_f32(b1[j]), qj = to_f32(w2[j]);
#pragma unroll
      for (int tt = 0; tt < TL; ++tt) {
        const float e = tanhf(acc[tt] + bj);
        if (e32 != nullptr && t0 + tt < dm.T) e32[(size_t)(t0 + tt) * dm.Ah + j] = e;
        part[tt] = round_to<T>(e) * qj;
      }
    }
#pragma unroll
    for (int tt = 0; tt < TL; ++tt) {
      const float s = warp_sum(part[tt]);
      if (lane == 0) red[(j / 32) * dm.Lp + t0 + tt] = s;
    }
  }
  __syncthreads();
}

// alpha[t] = exp(lg - max) / (sum + 1e-8) over the T slots (no token mask:
// the JAX kernel's _masked_softmax with a mask of ones), in warp 0.
__device__ void pool_softmax(const Dims& dm, const float* red, float* alpha) {
  using namespace fedrec;
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int jb = dm.Apad / 32;
  float m = -INFINITY;
  for (int t = lane; t < dm.T; t += 32) {
    float lg = 0.f;
    for (int b = 0; b < jb; ++b) lg += red[b * dm.Lp + t];
    alpha[t] = lg;
    m = fmaxf(m, lg);
  }
  m = warp_max(m);
  float sum = 0.f;
  for (int t = lane; t < dm.T; t += 32) {
    const float e = expf(alpha[t] - m);
    alpha[t] = e;
    sum += e;
  }
  sum = warp_sum(sum) + kEps;
  for (int t = lane; t < dm.T; t += 32) alpha[t] = alpha[t] / sum;
}

template <typename T>
__global__ void gather_encode_fwd_kernel(const T* __restrict__ table, const int64_t* __restrict__ ids,
                                         const T* __restrict__ w1, const T* __restrict__ b1,
                                         const T* __restrict__ w2, const T* __restrict__ fcw,
                                         const T* __restrict__ fcb, T* __restrict__ out, Dims dm) {
  using namespace fedrec;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                   // (Lp, Dh)
  float* red = xs + (size_t)dm.Lp * dm.Dh;            // (Apad/32, Lp)
  float* alpha = red + (size_t)(dm.Apad / 32) * dm.Lp;  // (Lp)
  float* pooled = alpha + 3 * dm.Lp;                  // (Dh)
  const int u = blockIdx.x, tid = threadIdx.x;

  stage_and_logits<T>(table, ids[u], w1, b1, w2, dm, xs, red, nullptr);
  pool_softmax(dm, red, alpha);
  __syncthreads();
  for (int t = tid; t < dm.T; t += blockDim.x) alpha[t] = round_to<T>(alpha[t]);
  __syncthreads();
  for (int d = tid; d < dm.Dh; d += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < dm.T; ++t) acc = fmaf(alpha[t], xs[t * dm.Dh + d], acc);
    pooled[d] = round_to<T>(acc);
  }
  __syncthreads();
  // out = pooled fcW + fcb: one output column per thread, fcW rows coalesced
  T* orow = out + (size_t)u * dm.D;
  for (int j = tid; j < dm.D; j += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < dm.Dh; ++k) acc = fmaf(pooled[k], to_f32(fcw[(size_t)k * dm.D + j]), acc);
    orow[j] = from_f32<T>(acc + to_f32(fcb[j]));
  }
}

// Stage 1 of D: per id, the cotangents of the pool (see the header comment).
template <typename T>
__global__ void gather_encode_bwd_rows_kernel(
    const T* __restrict__ table, const int64_t* __restrict__ ids, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ fcw,
    const float* __restrict__ g, float* __restrict__ dpre, float* __restrict__ pooled_out,
    float* __restrict__ dw2_rows, Dims dm) {
  using namespace fedrec;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                   // (Lp, Dh)
  float* red = xs + (size_t)dm.Lp * dm.Dh;            // (Apad/32, Lp)
  float* alpha = red + (size_t)(dm.Apad / 32) * dm.Lp;  // (Lp) f32, unrounded
  float* dalpha = alpha + dm.Lp;                      // (Lp)
  float* dlg = dalpha + dm.Lp;                        // (Lp)
  float* dpooled = dlg + dm.Lp;                       // (Dh)
  float* gs = dpooled + dm.Dh;                        // (D)
  const int u = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float* e32 = dpre + (size_t)u * dm.T * dm.Ah;       // e32 first, dpre after

  stage_and_logits<T>(table, ids[u], w1, b1, w2, dm, xs, red, e32);
  pool_softmax(dm, red, alpha);
  for (int j = tid; j < dm.D; j += blockDim.x) gs[j] = g[(size_t)u * dm.D + j];
  __syncthreads();

  // pooled = dt(alpha) . x in f32 (the fc weight's cotangent reads it)
  for (int d = tid; d < dm.Dh; d += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < dm.T; ++t) acc = fmaf(round_to<T>(alpha[t]), xs[t * dm.Dh + d], acc);
    pooled_out[(size_t)u * dm.Dh + d] = acc;
  }
  // dpooled[d] = g . fcW[d, :] (one warp per d, lanes along the row)
  for (int d = warp; d < dm.Dh; d += nwarps) {
    const T* row = fcw + (size_t)d * dm.D;
    float acc = 0.f;
    for (int j = lane; j < dm.D; j += 32) acc = fmaf(gs[j], to_f32(row[j]), acc);
    acc = warp_sum(acc);
    if (lane == 0) dpooled[d] = acc;
  }
  __syncthreads();
  // dalpha[t] = dpooled . x_t
  for (int t = warp; t < dm.T; t += nwarps) {
    float acc = 0.f;
    for (int d = lane; d < dm.Dh; d += 32) acc = fmaf(dpooled[d], xs[t * dm.Dh + d], acc);
    acc = warp_sum(acc);
    if (lane == 0) dalpha[t] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int t = lane; t < dm.T; t += 32) s = fmaf(alpha[t], dalpha[t], s);
    s = warp_sum(s);
    for (int t = lane; t < dm.T; t += 32) dlg[t] = alpha[t] * (dalpha[t] - s);
  }
  __syncthreads();
  // dpre = dlg w2 (1 - e32^2) in place of e32; this id's dw2 share = dlg . e32
  for (int j = tid; j < dm.Ah; j += blockDim.x) {
    const float qj = to_f32(w2[j]);
    float acc = 0.f;
    for (int t = 0; t < dm.T; ++t) {
      const size_t at = (size_t)t * dm.Ah + j;
      const float e = e32[at];
      acc = fmaf(dlg[t], e, acc);
      e32[at] = dlg[t] * qj * (1.f - e * e);
    }
    dw2_rows[(size_t)u * dm.Ah + j] = acc;
  }
}

template <typename T>
int launch_fwd(const void* const* p, void* out, int U, Dims dm, void* stream) {
  const size_t smem = smem_floats(dm) * sizeof(float);
  cudaError_t err = fedrec::allow_smem(gather_encode_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (U > 0) {
    gather_encode_fwd_kernel<T><<<U, block_threads(dm), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p[0]), static_cast<const int64_t*>(p[1]),
        static_cast<const T*>(p[2]), static_cast<const T*>(p[3]), static_cast<const T*>(p[4]),
        static_cast<const T*>(p[5]), static_cast<const T*>(p[6]), static_cast<T*>(out), dm);
  }
  return static_cast<int>(cudaGetLastError());
}

struct Scratch {
  float *dpre, *pooled, *dw2_rows, *partial;
};

__host__ inline Scratch carve(float* base, int U, const Dims& dm) {
  Scratch s;
  s.dpre = base;
  s.pooled = s.dpre + (size_t)U * dm.T * dm.Ah;
  s.dw2_rows = s.pooled + (size_t)U * dm.Dh;
  s.partial = s.dw2_rows + (size_t)U * dm.Ah;
  return s;
}

__host__ inline size_t scratch_floats(int U, const Dims& dm) {
  using namespace fedrec;
  size_t part = wgrad_scratch_floats(U * dm.T, dm.Dh, dm.Ah);
  const size_t p2 = wgrad_scratch_floats(U, 0, dm.Ah);
  const size_t p3 = wgrad_scratch_floats(U, dm.Dh, dm.D);
  if (p2 > part) part = p2;
  if (p3 > part) part = p3;
  return (size_t)U * dm.T * dm.Ah + (size_t)U * dm.Dh + (size_t)U * dm.Ah + part;
}

template <typename T>
int launch_bwd(const void* const* p, const float* g, float* scratch, float* const* grads, int U,
               Dims dm, void* stream_) {
  using namespace fedrec;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t smem = smem_floats(dm) * sizeof(float);
  cudaError_t err = allow_smem(gather_encode_bwd_rows_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Scratch s = carve(scratch, U, dm);
  const int64_t* ids = static_cast<const int64_t*>(p[1]);
  if (U > 0) {
    gather_encode_bwd_rows_kernel<T><<<U, block_threads(dm), smem, stream>>>(
        static_cast<const T*>(p[0]), ids, static_cast<const T*>(p[2]),
        static_cast<const T*>(p[3]), static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
        g, s.dpre, s.pooled, s.dw2_rows, dm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // dW1, db1: rows (u, t) of the table, re-gathered by id, against dpre
  const RowMap x_rows{p[0], ids, dm.T, (long long)dm.T * dm.Dh, dm.Dh, dm.N};
  err = wgrad<T>(x_rows, rows_contiguous(s.dpre, dm.Ah), U * dm.T, dm.Dh, dm.Ah, s.partial,
                 grads[0], grads[1], stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dw2: the column sums of the per-id shares
  err = wgrad<float>(rows_contiguous(s.dw2_rows, dm.Ah), rows_contiguous(s.dw2_rows, dm.Ah), U, 0,
                     dm.Ah, s.partial, nullptr, grads[2], stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dfcW = pooled^T g, dfcb = sum g
  err = wgrad<float>(rows_contiguous(s.pooled, dm.Dh), rows_contiguous(g, dm.D), U, dm.Dh, dm.D,
                     s.partial, grads[3], grads[4], stream);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of C or D asks for (bytes).
size_t fused_gather_encode_smem_bytes(int T, int Dh, int Ah, int D) {
  return smem_floats(make_dims(1, T, Dh, Ah, D)) * sizeof(float);
}

// Floats of f32 scratch D needs for U ids.
size_t fused_gather_encode_bwd_scratch_floats(int U, int T, int Dh, int Ah, int D) {
  return scratch_floats(U, make_dims(1, T, Dh, Ah, D));
}

// C. table (N, T, Dh), ids (U) int64, w1 (Dh, Ah), b1 (Ah), w2 (Ah),
// fcw (Dh, D), fcb (D), all but ids in the operand dtype (0 f32, 1 bf16);
// out (U, D) in the operand dtype. Returns cudaGetLastError().
int fused_gather_encode_launch(const void* table, const void* ids, const void* w1,
                               const void* b1, const void* w2, const void* fcw,
                               const void* fcb, void* out, int U, int N, int T, int Dh,
                               int Ah, int D, int dtype, void* stream) {
  const void* p[7] = {table, ids, w1, b1, w2, fcw, fcb};
  const Dims dm = make_dims(N, T, Dh, Ah, D);
  if (dtype == 0) return launch_fwd<float>(p, out, U, dm, stream);
  return launch_fwd<__nv_bfloat16>(p, out, U, dm, stream);
}

// D. The inputs of C (no fcb) and g (U, D) f32; scratch of
// fused_gather_encode_bwd_scratch_floats floats; f32 outputs dw1 (Dh, Ah),
// db1 (Ah), dw2 (Ah), dfcw (Dh, D), dfcb (D). Returns the first launch error.
int fused_gather_encode_bwd_launch(const void* table, const void* ids, const void* w1,
                                   const void* b1, const void* w2, const void* fcw,
                                   const void* g, void* scratch, void* dw1, void* db1,
                                   void* dw2, void* dfcw, void* dfcb, int U, int N, int T,
                                   int Dh, int Ah, int D, int dtype, void* stream) {
  const void* p[6] = {table, ids, w1, b1, w2, fcw};
  float* grads[5] = {static_cast<float*>(dw1), static_cast<float*>(db1),
                     static_cast<float*>(dw2), static_cast<float*>(dfcw),
                     static_cast<float*>(dfcb)};
  const Dims dm = make_dims(N, T, Dh, Ah, D);
  const float* gf = static_cast<const float*>(g);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) return launch_bwd<float>(p, gf, sc, grads, U, dm, stream);
  return launch_bwd<__nv_bfloat16>(p, gf, sc, grads, U, dm, stream);
}

}  // extern "C"
