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
// table gets no cotangent. All of it in f32 (the JAX backward uses x32 and
// the unrounded pooled). Padded ids get g = 0 and add exactly zero; ids out
// of range are clamped into the table, as JAX's gather clamps them.
//
// Bound on an H100: the two (U T x Dh) . (Dh x Ah) products (C's logits and
// D's recompute, 104 GFLOP each at U = 3,520) and D's dW1 = X^T dpre (104
// GFLOP) are nearly all the work, at ~190 FLOP per byte of table: bound by
// operations. On CUDA cores (67 TFLOP/s f32) that is 1.6 ms for C; on the
// tensor cores with f32 parity (3xTF32, 495 / 3 TFLOP/s) 0.63 ms.
//
// Design. The products run on the tensor cores (mma.sync, mma.cuh):
//   rows   the logits as one GEMM over the R = U T gathered rows: a block
//          owns 64 rows x 192 hidden units (Ah = 384 takes two blocks per
//          row tile, adjacent in the grid so the second reads x from L2),
//          stages x (through the ids, never materialized) and W1 in 32-deep
//          chunks through a 3-stage cp.async ring, and in its epilogue
//          forms tanh(acc + b1), the rounding dt() and the dot with w2; each
//          row's partial logit leaves the block as one f32 (nh x R). D's
//          instance also stores the unrounded tanh e32 (R, Ah).
//   ids    one block per id: the nh partial logits added in order, the
//          softmax, the pool alpha . x (re-reading the id's row), and in D
//          the walk back dalpha, dlg (made to sum to zero over the id's
//          row), dpre = dlg w2 (1 - e32^2) in place of e32, and the id's
//          dw2 share.
//   fc     the projection (U x Dh) . (Dh x D) (C) and dpooled = g fcW^T (D)
//          as one tiled CUDA-core product over all ids (2.2 GFLOP each, in
//          full f32): fcW is read once per 64 ids, not once per id.
//   dW1    wgrad_tc (wgrad.cuh): X^T dpre over the R rows on the tensor
//          cores, X re-gathered by id; db1, dw2, dfcW and dfcb stay on the
//          CUDA-core wgrad.
// Precision: f32 operands take three TF32 passes (split as fragments are
// formed, with cvt.rna's rounding), bf16 ones one bf16 mma (products
// exact, f32 sums, as the JAX kernel's bf16 dot); dW1 on a bf16 table
// takes two (X exact in TF32, dpre split). Each 32-deep chunk is summed in a fresh accumulator and
// promoted with a round-to-nearest add (mma.cuh). mma.sync rather than
// wgmma: wgmma takes TF32 operands K-major only, so the x tile (row-major,
// K = Dh innermost) would serve but W1 and dW1's X^T would need transposed
// staging; mma.sync fragments load from shared memory in either layout. A
// first tensor-core design; wgmma is the next step.
// Every sum has a fixed owner and order: same inputs, same bits.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "wgrad.cuh"

namespace {

using namespace fedrec;

constexpr float kEps = 1e-8f;   // the module's denominator epsilon
constexpr int kRowsM = 64;      // gathered rows per block
constexpr int kRowsN = 192;     // hidden units per block
constexpr int kRowsK = 32;      // depth of a staged chunk
constexpr int kRowsStages = 3;  // cp.async ring
constexpr int kRowsThreads = 256;
constexpr int kWPitch = kRowsN + 8;  // W1 tile row (conflict-free B fragments)
constexpr int kIdThreads = 256;
constexpr int kFcTile = 64, kFcDepth = 16;

struct Dims {
  int N, T, Dh, Ah, D;
};

template <typename T>
__host__ __device__ constexpr int x_pitch() {  // x tile row: conflict-free A fragments
  return std::is_same<T, float>::value ? kRowsK + 4 : kRowsK + 8;
}

template <typename T>
__host__ __device__ constexpr size_t rows_stage_bytes() {
  return ((size_t)kRowsM * x_pitch<T>() + (size_t)kRowsK * kWPitch) * sizeof(T);
}

template <typename T>
__host__ __device__ constexpr size_t rows_smem_bytes() {
  return kRowsStages * rows_stage_bytes<T>();
}

__host__ __device__ inline int halves(const Dims& d) { return (d.Ah + kRowsN - 1) / kRowsN; }

__device__ __forceinline__ long long clamp_id(int64_t id, int n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16); v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16); v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// part[h][r] = sum over this block's hidden units j of dt(tanh(x_r W1_j + b1_j)) w2_j
// for 64 rows r and 192 units (h = blockIdx.x % nh); with E32, e32[r][j] =
// the unrounded tanh too. 8 warps, 2 x 4, each 32 rows x 48 units.
template <typename T, bool E32>
__global__ void __launch_bounds__(kRowsThreads, 1)
    head_rows_kernel(const T* __restrict__ table, const int64_t* __restrict__ ids,
                     const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, Dims dm, int R, float* __restrict__ part,
                     float* __restrict__ e32) {
  extern __shared__ __align__(16) unsigned char rows_smem[];
  __shared__ float red[4][kRowsM];
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int XP = x_pitch<T>();
  constexpr size_t kStage = rows_stage_bytes<T>();
  const int nh = halves(dm);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 48;
  const int row0 = (blockIdx.x / nh) * kRowsM, h = blockIdx.x % nh, n0 = h * kRowsN;
  const int chunks = (dm.Dh + kRowsK - 1) / kRowsK;

  auto x_tile = [&](int st) { return reinterpret_cast<T*>(rows_smem + st * kStage); };
  auto w_tile = [&](int st) {
    return reinterpret_cast<T*>(rows_smem + st * kStage + (size_t)kRowsM * XP * sizeof(T));
  };
  // x: rows xr, xr + 32 at depth xk..xk+3; the row pointers through the ids
  const int xr = tid >> 3, xk = (tid & 7) * 4;
  const T* xsrc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + xr + 32 * i;
    xsrc[i] = r < R ? table + (clamp_id(ids[r / dm.T], dm.N) * dm.T + r % dm.T) * dm.Dh : nullptr;
  }
  auto load = [&](int st, int chunk) {
    const int k0 = chunk * kRowsK;
    T* xs = x_tile(st);
    T* ws = w_tile(st);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool v = xsrc[i] != nullptr && k0 + xk < dm.Dh;
      cp_async4(xs + (xr + 32 * i) * XP + xk, v ? xsrc[i] + k0 + xk : table, v);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {  // 32 x 192 units, 4 a copy
      const int idx = tid + kRowsThreads * i, kk = idx / 48, nq = (idx % 48) * 4;
      const bool v = k0 + kk < dm.Dh && n0 + nq < dm.Ah;
      cp_async4(ws + kk * kWPitch + nq, v ? w1 + (size_t)(k0 + kk) * dm.Ah + n0 + nq : w1, v);
    }
  };

  float acc[48], tot[48];  // [mt 2][nt 6][4]
#pragma unroll
  for (int i = 0; i < 48; ++i) acc[i] = tot[i] = 0.f;

#pragma unroll
  for (int st = 0; st < kRowsStages - 1; ++st) {
    if (st < chunks) load(st, st);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kRowsStages - 2>();
    __syncthreads();
    const int nxt = ch + kRowsStages - 1;
    if (nxt < chunks) load(nxt % kRowsStages, nxt);
    cp_async_commit();
    const T* xs = x_tile(ch % kRowsStages);
    const T* ws = w_tile(ch % kRowsStages);
#pragma unroll
    for (int k = 0; k < kRowsK; k += 8) {
      if constexpr (kF32) {
        Tf32Pair bf[6][2];
#pragma unroll
        for (int nt = 0; nt < 6; ++nt) {
          const int n = wn + nt * 8 + g;
          bf[nt][0] = split_tf32(ws[(k + c) * kWPitch + n]);
          bf[nt][1] = split_tf32(ws[(k + c + 4) * kWPitch + n]);
        }
        Tf32Pair af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* p = xs + (wm + mt * 16 + g) * XP + k + c;
          af[mt][0] = split_tf32(p[0]);
          af[mt][1] = split_tf32(p[8 * XP]);
          af[mt][2] = split_tf32(p[4]);
          af[mt][3] = split_tf32(p[8 * XP + 4]);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 6; ++nt) mma_pass(&acc[(mt * 6 + nt) * 4], af[mt], bf[nt], pass);
      } else {
        uint32_t bf[6];
#pragma unroll
        for (int nt = 0; nt < 6; ++nt) {
          const T* p = ws + (k + 2 * c) * kWPitch + wn + nt * 8 + g;
          bf[nt] = pack_bf16(p[0], p[kWPitch]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const T* p = xs + (wm + mt * 16 + g) * XP + k + 2 * c;
          const uint32_t af[2] = {*reinterpret_cast<const uint32_t*>(p),
                                  *reinterpret_cast<const uint32_t*>(p + 8 * XP)};
#pragma unroll
          for (int nt = 0; nt < 6; ++nt) mma_bf16(&acc[(mt * 6 + nt) * 4], af, bf[nt]);
        }
      }
    }
    promote(tot, acc);
  }
  cp_async_wait<0>();

  // epilogue: accumulator (mt, nt, i) is row wm + mt*16 + g + 8*(i >= 2),
  // unit wn + nt*8 + 2c + (i & 1)
  float lp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
    const int j = n0 + wn + nt * 8 + 2 * c;
    if (j >= dm.Ah) continue;  // Ah divides by 4: j + 1 < Ah too
    const float bj0 = to_f32(b1[j]), bj1 = to_f32(b1[j + 1]);
    const float qj0 = to_f32(w2[j]), qj1 = to_f32(w2[j + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float* f = &tot[(mt * 6 + nt) * 4 + 2 * hr];
        const float e0 = tanhf(f[0] + bj0), e1 = tanhf(f[1] + bj1);
        const int r = row0 + wm + mt * 16 + g + 8 * hr;
        if (E32 && r < R) {
          *reinterpret_cast<float2*>(&e32[(size_t)r * dm.Ah + j]) = make_float2(e0, e1);
        }
        lp[mt][hr] += round_to<T>(e0) * qj0 + round_to<T>(e1) * qj1;
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float v = lp[mt][hr];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (c == 0) red[warp & 3][wm + mt * 16 + g + 8 * hr] = v;
    }
  }
  __syncthreads();
  if (tid < kRowsM && row0 + tid < R) {
    part[(size_t)h * R + row0 + tid] = ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
  }
}

// alpha[t] = exp(lg - max) / (sum + 1e-8) over the id's T slots (no token
// mask: the JAX kernel's _masked_softmax with a mask of ones), lg the sum of
// the nh partial logits in order; in warp 0, unrounded.
__device__ void id_softmax(const float* __restrict__ part, int nh, int R, int r0, int T,
                           float* alpha) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float m = -INFINITY;
  for (int t = lane; t < T; t += 32) {
    float lg = 0.f;
    for (int h = 0; h < nh; ++h) lg += part[(size_t)h * R + r0 + t];
    alpha[t] = lg;
    m = fmaxf(m, lg);
  }
  m = warp_max(m);
  float sum = 0.f;
  for (int t = lane; t < T; t += 32) {
    const float e = expf(alpha[t] - m);
    alpha[t] = e;
    sum += e;
  }
  sum = warp_sum(sum) + kEps;
  for (int t = lane; t < T; t += 32) alpha[t] = alpha[t] / sum;
}

// C, per id: pooled[u] = dt(dt(alpha) . x)
template <typename T>
__global__ void __launch_bounds__(kIdThreads)
    head_pool_kernel(const T* __restrict__ table, const int64_t* __restrict__ ids,
                     const float* __restrict__ part, Dims dm, int R, float* __restrict__ pooled) {
  extern __shared__ float alpha[];  // (T)
  const int u = blockIdx.x;
  id_softmax(part, halves(dm), R, u * dm.T, dm.T, alpha);
  if (threadIdx.x < 32) {
    for (int t = threadIdx.x; t < dm.T; t += 32) alpha[t] = round_to<T>(alpha[t]);
  }
  __syncthreads();
  const T* x = table + clamp_id(ids[u], dm.N) * dm.T * dm.Dh;
  for (int d = threadIdx.x * 4; d < dm.Dh; d += blockDim.x * 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, v[4];
    for (int t = 0; t < dm.T; ++t) {
      load4(x + (size_t)t * dm.Dh + d, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(alpha[t], v[i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) pooled[(size_t)u * dm.Dh + d + i] = round_to<T>(acc[i]);
  }
}

// D, per id: the cotangents of the pool. e32 (T, Ah) in, dpre out in place;
// pooled (f32, for dfcW) and the id's db1 and dw2 shares out.
template <typename T>
__global__ void __launch_bounds__(kIdThreads)
    head_bwd_ids_kernel(const T* __restrict__ table, const int64_t* __restrict__ ids,
                        const T* __restrict__ w2, const float* __restrict__ part,
                        const float* __restrict__ dpooled, float* __restrict__ dpre,
                        float* __restrict__ pooled_out, float* __restrict__ db1_rows,
                        float* __restrict__ dw2_rows, Dims dm, int R) {
  extern __shared__ float sm[];
  float* alpha = sm;             // (T) f32, unrounded
  float* dalpha = sm + dm.T;     // (T)
  float* dlg = sm + 2 * dm.T;    // (T)
  float* red = sm + 3 * dm.T;    // (T, warps): per-warp shares of dalpha
  const int u = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const T* x = table + clamp_id(ids[u], dm.N) * dm.T * dm.Dh;
  const float* dp = dpooled + (size_t)u * dm.Dh;
  float* e32 = dpre + (size_t)u * dm.T * dm.Ah;

  for (int i = tid; i < dm.T * nwarps; i += blockDim.x) red[i] = 0.f;
  id_softmax(part, halves(dm), R, u * dm.T, dm.T, alpha);
  __syncthreads();
  // one pass over the row: pooled = dt(alpha) . x in f32 (the fc weight's
  // cotangent reads it) per column, and dalpha[t] = dpooled . x_t, summed
  // per warp and then over the warps in order
  for (int d0 = 0; d0 < dm.Dh; d0 += blockDim.x * 4) {
    const int d = d0 + tid * 4;
    const bool on = d < dm.Dh;
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, v[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
    if (on) {
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = dp[d + i];
    }
    for (int t = 0; t < dm.T; ++t) {
      if (on) load4(x + (size_t)t * dm.Dh + d, v);
      const float a = round_to<T>(alpha[t]);
      float pt = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i] = fmaf(a, v[i], acc[i]);
        pt = fmaf(q[i], v[i], pt);
      }
      pt = warp_sum(pt);
      if (lane == 0) red[t * nwarps + warp] += pt;
    }
    if (on) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pooled_out[(size_t)u * dm.Dh + d + i] = acc[i];
    }
  }
  __syncthreads();
  for (int t = tid; t < dm.T; t += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[t * nwarps + w];
    dalpha[t] = s;
  }
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int t = lane; t < dm.T; t += 32) s = fmaf(alpha[t], dalpha[t], s);
    s = warp_sum(s);
    float r = 0.f, sa = 0.f;
    for (int t = lane; t < dm.T; t += 32) {
      dlg[t] = alpha[t] * (dalpha[t] - s);
      r += dlg[t];
      sa += alpha[t];
    }
    // the logit cotangents sum to zero, as the exact gradient's do: take
    // their rounded sum out in proportion to alpha (a title's token states
    // share a common part, which would carry it into db1 and dw2)
    r = warp_sum(r);
    sa = warp_sum(sa);
    const float c = sa > 0.f ? r / sa : 0.f;
    for (int t = lane; t < dm.T; t += 32) dlg[t] -= alpha[t] * c;
  }
  __syncthreads();
  // dpre = dlg w2 (1 - e32^2) in place of e32; this id's shares:
  // db1 = sum_t dpre, dw2 = dlg . e32
  for (int j = tid; j < dm.Ah; j += blockDim.x) {
    const float qj = to_f32(w2[j]);
    float acc = 0.f, bsum = 0.f;
    for (int t = 0; t < dm.T; ++t) {
      const size_t at = (size_t)t * dm.Ah + j;
      const float e = e32[at];
      acc = fmaf(dlg[t], e, acc);
      const float d = dlg[t] * qj * (1.f - e * e);
      e32[at] = d;
      bsum += d;
    }
    db1_rows[(size_t)u * dm.Ah + j] = bsum;
    dw2_rows[(size_t)u * dm.Ah + j] = acc;
  }
}

// c (M, N) = from_f32(a (M, K) b (K, N) [+ bias]) on CUDA cores in f32, a
// row-major f32, b(k, n) at b[k * sbk + n * sbn]: 64 x 64 tiles, 16 deep,
// each thread a 4 x 4 block summed over k in order.
template <typename TB, typename TO>
__global__ void __launch_bounds__(256)
    fc_kernel(const float* __restrict__ a, const TB* __restrict__ b, long long sbk, long long sbn,
              const TB* __restrict__ bias, TO* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) float As[kFcDepth][kFcTile + 4];
  __shared__ __align__(16) float Bs[kFcDepth][kFcTile + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kFcTile, n0 = blockIdx.x * kFcTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFcDepth) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + 256 * i;
      {  // a: k fastest (rows are contiguous)
        const int mm = idx / kFcDepth, kk = idx % kFcDepth, m = m0 + mm, k = k0 + kk;
        As[kk][mm] = m < M && k < K ? a[(size_t)m * K + k] : 0.f;
      }
      // b: along whichever of its axes is contiguous
      const int kk = sbn == 1 ? idx / kFcTile : idx % kFcDepth;
      const int nn = sbn == 1 ? idx % kFcTile : idx / kFcDepth;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = k < K && n < N ? to_f32(b[k * sbk + n * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFcDepth; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) c[(size_t)m * N + n] = from_f32<TO>(acc[i][j] + (bias ? to_f32(bias[n]) : 0.f));
    }
  }
}

template <typename TB, typename TO>
cudaError_t launch_fc(const float* a, const TB* b, long long sbk, long long sbn, const TB* bias,
                      TO* c, int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + kFcTile - 1) / kFcTile, (M + kFcTile - 1) / kFcTile);
  fc_kernel<TB, TO><<<grid, 256, 0, stream>>>(a, b, sbk, sbn, bias, c, M, N, K);
  return cudaGetLastError();
}

template <typename T, bool E32>
cudaError_t launch_rows(const T* table, const int64_t* ids, const T* w1, const T* b1,
                        const T* w2, const Dims& dm, int R, float* part, float* e32,
                        cudaStream_t stream) {
  const size_t smem = rows_smem_bytes<T>();
  cudaError_t err = allow_smem(head_rows_kernel<T, E32>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kRowsM - 1) / kRowsM * halves(dm);
  head_rows_kernel<T, E32><<<blocks, kRowsThreads, smem, stream>>>(table, ids, w1, b1, w2, dm, R,
                                                                   part, e32);
  return cudaGetLastError();
}

// scratch regions start on 16-byte boundaries (vector loads and stores)
__host__ __device__ inline size_t up4(size_t n) { return (n + 3) & ~(size_t)3; }

// C's scratch: partial logits (nh, R), pooled (U, Dh)
__host__ inline size_t fwd_scratch_floats(int U, const Dims& dm) {
  return up4((size_t)halves(dm) * U * dm.T) + (size_t)U * dm.Dh;
}

template <typename T>
int launch_fwd(const void* const* p, void* out, float* scratch, int U, Dims dm, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (U == 0) return static_cast<int>(cudaGetLastError());
  const T* table = static_cast<const T*>(p[0]);
  const int64_t* ids = static_cast<const int64_t*>(p[1]);
  const int R = U * dm.T;
  float* part = scratch;
  float* pooled = part + up4((size_t)halves(dm) * R);
  cudaError_t err = launch_rows<T, false>(table, ids, static_cast<const T*>(p[2]),
                                          static_cast<const T*>(p[3]), static_cast<const T*>(p[4]),
                                          dm, R, part, nullptr, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  head_pool_kernel<T><<<U, kIdThreads, dm.T * sizeof(float), stream>>>(table, ids, part, dm, R,
                                                                       pooled);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // out = dt(pooled fcW + fcb)
  return static_cast<int>(launch_fc<T, T>(pooled, static_cast<const T*>(p[5]), dm.D, 1,
                                          static_cast<const T*>(p[6]), static_cast<T*>(out), U,
                                          dm.D, dm.Dh, stream));
}

// D's scratch: e32 / dpre (R, Ah), partial logits (nh, R), dpooled and
// pooled (U, Dh), the per-id db1 and dw2 shares (U, Ah), the sums' partials
struct Scratch {
  float *dpre, *part, *dpooled, *pooled, *db1_rows, *dw2_rows, *partial;
};

// the regions' sizes in floats, in Scratch's order, each rounded up to 4
__host__ inline void bwd_region_floats(int U, const Dims& dm, size_t n[6]) {
  const size_t R = (size_t)U * dm.T;
  n[0] = up4(R * dm.Ah);
  n[1] = up4((size_t)halves(dm) * R);
  n[2] = n[3] = up4((size_t)U * dm.Dh);
  n[4] = n[5] = up4((size_t)U * dm.Ah);
}

__host__ inline Scratch carve(float* base, int U, const Dims& dm) {
  size_t n[6];
  bwd_region_floats(U, dm, n);
  float** regions[6];
  Scratch s;
  regions[0] = &s.dpre; regions[1] = &s.part; regions[2] = &s.dpooled;
  regions[3] = &s.pooled; regions[4] = &s.db1_rows; regions[5] = &s.dw2_rows;
  for (int i = 0; i < 6; ++i) {
    *regions[i] = base;
    base += n[i];
  }
  s.partial = base;
  return s;
}

__host__ inline size_t bwd_scratch_floats(int U, const Dims& dm) {
  const int R = U * dm.T;
  size_t n[6];
  bwd_region_floats(U, dm, n);
  size_t total = 0;
  for (size_t x : n) total += x;
  const size_t sums[3] = {wgrad_tc_scratch_floats(R, dm.Dh, dm.Ah),
                          wgrad_scratch_floats(U, 0, dm.Ah), wgrad_scratch_floats(U, dm.Dh, dm.D)};
  size_t part = 0;
  for (size_t p : sums) part = p > part ? p : part;
  return total + part;
}

template <typename T>
int launch_bwd(const void* const* p, const float* g, float* scratch, float* const* grads, int U,
               Dims dm, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Scratch s = carve(scratch, U, dm);
  const T* table = static_cast<const T*>(p[0]);
  const int64_t* ids = static_cast<const int64_t*>(p[1]);
  const T* w2 = static_cast<const T*>(p[4]);
  const int R = U * dm.T;
  cudaError_t err;
  if (U > 0) {
    // e32 and the logits, recomputed
    err = launch_rows<T, true>(table, ids, static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
                               w2, dm, R, s.part, s.dpre, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    // dpooled = g fcW^T over all ids
    err = launch_fc<T, float>(g, static_cast<const T*>(p[5]), 1, dm.D, nullptr, s.dpooled, U,
                              dm.Dh, dm.D, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    head_bwd_ids_kernel<T><<<U, kIdThreads, (3 + kIdThreads / 32) * dm.T * sizeof(float),
                             stream>>>(
        table, ids, w2, s.part, s.dpooled, s.dpre, s.pooled, s.db1_rows, s.dw2_rows, dm, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // dW1: rows (u, t) of the table, re-gathered by id, against dpre (tensor cores)
  const RowMap x_rows{p[0], ids, dm.T, (long long)dm.T * dm.Dh, dm.Dh, dm.N};
  const RowMap dpre_rows = rows_contiguous(s.dpre, dm.Ah);
  err = wgrad_tc<T>(x_rows, dpre_rows, R, dm.Dh, dm.Ah, s.partial, grads[0], stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // db1 and dw2: the column sums of the per-id shares
  for (int i = 1; i <= 2; ++i) {
    const RowMap rows = rows_contiguous(i == 1 ? s.db1_rows : s.dw2_rows, dm.Ah);
    err = wgrad<float>(rows, rows, U, 0, dm.Ah, s.partial, nullptr, grads[i], stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // dfcW = pooled^T g, dfcb = sum g
  err = wgrad<float>(rows_contiguous(s.pooled, dm.Dh), rows_contiguous(g, dm.D), U, dm.Dh, dm.D,
                     s.partial, grads[3], grads[4], stream);
  return static_cast<int>(err);
}

__global__ void tf32_check_kernel(const float* __restrict__ x, uint32_t* __restrict__ by_ops,
                                  uint32_t* __restrict__ by_cvt, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    by_ops[i] = tf32_rna(x[i]);
    by_cvt[i] = tf32_cvt_rna(x[i]);
  }
}

}  // namespace

extern "C" {

// The kernels' TF32 rounding of x (n floats) into by_ops and the
// cvt.rna.tf32.f32 instruction's into by_cvt, for a test that they agree.
int fused_gather_encode_tf32_check(const void* x, void* by_ops, void* by_cvt, int n, void* stream) {
  if (n > 0) {
    tf32_check_kernel<<<(n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<uint32_t*>(by_ops), static_cast<uint32_t*>(by_cvt), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory the largest block of C or D asks for (bytes): the
// f32 row product's and dW1's cp.async rings.
size_t fused_gather_encode_smem_bytes(int T, int Dh, int Ah, int D) {
  const size_t a = rows_smem_bytes<float>(), b = wgrad_tc_smem_bytes<float>();
  return a > b ? a : b;
}

// Floats of f32 scratch C needs for U ids.
size_t fused_gather_encode_scratch_floats(int U, int T, int Dh, int Ah, int D) {
  return fwd_scratch_floats(U, Dims{1, T, Dh, Ah, D});
}

// Floats of f32 scratch D needs for U ids.
size_t fused_gather_encode_bwd_scratch_floats(int U, int T, int Dh, int Ah, int D) {
  return bwd_scratch_floats(U, Dims{1, T, Dh, Ah, D});
}

// C. table (N, T, Dh), ids (U) int64, w1 (Dh, Ah), b1 (Ah), w2 (Ah),
// fcw (Dh, D), fcb (D), all but ids in the operand dtype (0 f32, 1 bf16);
// out (U, D) in the operand dtype; scratch of
// fused_gather_encode_scratch_floats floats. Dh and Ah divide by 4.
// Returns the first launch error.
int fused_gather_encode_launch(const void* table, const void* ids, const void* w1,
                               const void* b1, const void* w2, const void* fcw,
                               const void* fcb, void* out, void* scratch, int U, int N, int T,
                               int Dh, int Ah, int D, int dtype, void* stream) {
  const void* p[7] = {table, ids, w1, b1, w2, fcw, fcb};
  const Dims dm{N, T, Dh, Ah, D};
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) return launch_fwd<float>(p, out, sc, U, dm, stream);
  return launch_fwd<__nv_bfloat16>(p, out, sc, U, dm, stream);
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
  const Dims dm{N, T, Dh, Ah, D};
  const float* gf = static_cast<const float*>(g);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) return launch_bwd<float>(p, gf, sc, grads, U, dm, stream);
  return launch_bwd<__nv_bfloat16>(p, gf, sc, grads, U, dm, stream);
}

}  // extern "C"
