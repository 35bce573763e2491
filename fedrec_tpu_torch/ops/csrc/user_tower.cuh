// The user tower's forward pieces, shared by kernel B (the forward,
// fused_history_score.cu) and kernel E (the backward, which recomputes the
// forward first, fused_history_score_bwd.cu). The work is split by its
// shape, not by history row, into launches on one stream; each output has
// one owner and one order (no atomics: same inputs, same bits):
//   rows_gemm_kernel: the row products over all R = n H history rows on the
//     tensor cores. A block owns 64 rows x 128 output columns, 8 warps of
//     32 x 32; the A rows and a B tile are staged in 32-deep chunks through
//     a 3-stage cp.async ring. B is read from the weights where they lie, as
//     column pieces (KN) or transposed (NK), so no concatenated or
//     transposed copy is made. The epilogues:
//       kQkv  [q|k|v] = round(x [Wq|Wk|Wv] + b)          K = D,  N = 3D
//       kE32  e32 = tanh(ctx pw1 + pb1) (stored unless out is null) and the
//             pool's logit partials, one per 128-column tile  K = D, N = Q
//       kDctx dctx = alpha du + dpre pw1^T (E)           K = Q,  N = D
//       kDx   dx = [dQ|dK|dV] [Wq|Wk|Wv]^T (E)           K = 3D, N = D
//   attn_head_kernel: one block per (history row, head): the forward
//     (softmax(q k^T / sqrt(dh)) v, its weights and the result rounded, into
//     ctx) or the backward (dq, dk, dv) on CUDA cores, from that head's
//     columns of kQkv's output.
// Precision (mma.cuh): an f32 operand is split into TF32 hi and lo, and a
// product takes a_lo b_hi + a_hi b_lo + a_hi b_hi; an operand exact in TF32
// (a bf16 value, or ctx rounded to bf16) has no low part, so its pass is
// skipped: under bf16 x W and ctx pw1 take one pass (the exact products a
// bf16 mma forms, summed in f32). Each 32-deep chunk sums in a fresh
// accumulator and is promoted with a round-to-nearest add (the tensor cores
// truncate as they accumulate). tests/test_torch_tc_precision.py holds the
// emulation against float64.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace fedrec;

constexpr float kEps = 1e-8f;  // the module's denominator epsilon

struct Dims {
  int H, D, C, Q, nh, dh;
};

__host__ __device__ inline Dims make_dims(int H, int D, int C, int Q, int nh) {
  return Dims{H, D, C, Q, nh, D / nh};
}

// ------------------------------------------------------------ row GEMMs
constexpr int kGM = 64;       // rows per block
constexpr int kGN = 128;      // output columns per block
constexpr int kGK = 32;       // depth of a staged chunk (one promotion)
constexpr int kGStages = 3;   // cp.async ring
constexpr int kGThreads = 256;

enum Epilogue { kQkv, kE32, kDctx, kDx };

template <typename T>
__host__ __device__ constexpr int k_pitch() {  // a row of 32 depth values: conflict-free fragments
  return std::is_same<T, float>::value ? kGK + 4 : kGK + 8;
}

template <typename TB, bool NK>
__host__ __device__ constexpr int b_pitch() {
  return NK ? k_pitch<TB>() : kGN + 8;
}

template <typename TB, bool NK>
__host__ __device__ constexpr int b_rows() {
  return NK ? kGN : kGK;
}

template <typename TA, typename TB, bool NK>
__host__ __device__ constexpr size_t gemm_stage_bytes() {
  return (size_t)kGM * k_pitch<TA>() * sizeof(TA) +
         (size_t)b_rows<TB, NK>() * b_pitch<TB, NK>() * sizeof(TB);
}

template <typename TA, typename TB, bool NK>
__host__ __device__ constexpr size_t gemm_smem() {
  return kGStages * gemm_stage_bytes<TA, TB, NK>();
}

// B (K, N) read from up to three weights: KN, B[k][n] = p[n / piece][k *
// piece + n % piece] (column pieces of (K, piece) matrices); NK, B[k][n] =
// p[k / piece][n * piece + k % piece] (the transpose of (N, piece)
// matrices laid side by side along k).
struct BOperand {
  const void* p[3];
  int piece;
};

struct Epi {
  const void* v0;       // kQkv: bq; kE32: pb1
  const void* v1;       // kQkv: bk; kE32: pw2
  const void* v2;       // kQkv: bv
  float* out;           // kQkv, kE32 (or null: not stored), kDctx: f32 (R, N)
  void* out_t;          // kDx: (R, N) in the operand dtype
  float* part;          // kE32: logit partials (column tiles, R)
  const float* alpha;   // kDctx: (R)
  const float* du;      // kDctx: (R / H, N)
  int H;
};

// out (R, N) = epilogue(A (R, K) B (K, N)); A row-major with row stride K.
// K and N divide by 4 (16-byte copies), and so does `piece`.
template <typename TA, bool A_EXACT, typename TB, bool NK, int EPI>
__global__ void __launch_bounds__(kGThreads, 2)
    rows_gemm_kernel(const TA* __restrict__ a, BOperand b, int R, int K, int N, Epi ep) {
  extern __shared__ __align__(16) unsigned char gsm[];
  __shared__ float red[4][kGM];  // kE32: the four column warps' logit partials
  constexpr bool kBExact = !std::is_same<TB, float>::value;
  constexpr bool kAExact = A_EXACT || !std::is_same<TA, float>::value;
  constexpr int AP = k_pitch<TA>(), BP = b_pitch<TB, NK>();
  constexpr size_t kStage = gemm_stage_bytes<TA, TB, NK>();
  constexpr size_t kATile = (size_t)kGM * AP * sizeof(TA);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int r0 = blockIdx.x * kGM, n0 = blockIdx.y * kGN;
  const int chunks = (K + kGK - 1) / kGK;
  const TB* const bp[3] = {static_cast<const TB*>(b.p[0]), static_cast<const TB*>(b.p[1]),
                           static_cast<const TB*>(b.p[2])};

  auto a_tile = [&](int st) { return reinterpret_cast<TA*>(gsm + st * kStage); };
  auto b_tile = [&](int st) { return reinterpret_cast<TB*>(gsm + st * kStage + kATile); };
  const int xr = tid >> 3, xk = (tid & 7) * 4;  // A: rows xr, xr + 32 at depth xk..xk+3
  auto load = [&](int st, int chunk) {
    const int k0 = chunk * kGK;
    TA* as = a_tile(st);
    TB* bs = b_tile(st);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + xr + 32 * i;
      const bool v = r < R && k0 + xk < K;
      cp_async4(as + (xr + 32 * i) * AP + xk, v ? a + (size_t)r * K + k0 + xk : a, v);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // 32 x 128 values, 4 a copy
      const int idx = tid + kGThreads * i;
      int k, n;
      TB* dst;
      if constexpr (NK) {
        const int nn = idx >> 3, kq = (idx & 7) * 4;
        n = n0 + nn;
        k = k0 + kq;
        dst = bs + nn * BP + kq;
      } else {
        const int kk = idx >> 5, nq = (idx & 31) * 4;
        n = n0 + nq;
        k = k0 + kk;
        dst = bs + kk * BP + nq;
      }
      const bool v = k < K && n < N;
      const TB* src = bp[0];
      if (v) {
        if constexpr (NK) {
          src = bp[k / b.piece] + (size_t)n * b.piece + k % b.piece;
        } else {
          src = bp[n / b.piece] + (size_t)k * b.piece + n % b.piece;
        }
      }
      cp_async4(dst, src, v);
    }
  };

  float acc[32], tot[32];  // [mt 2][nt 4][4], m16n8 accumulator fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = tot[i] = 0.f;

#pragma unroll
  for (int st = 0; st < kGStages - 1; ++st) {
    if (st < chunks) load(st, st);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();
    const int nxt = ch + kGStages - 1;
    if (nxt < chunks) load(nxt % kGStages, nxt);
    cp_async_commit();
    const TA* as = a_tile(ch % kGStages);
    const TB* bs = b_tile(ch % kGStages);
#pragma unroll
    for (int k = 0; k < kGK; k += 8) {
      Tf32Pair bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn + nt * 8 + g;
        if constexpr (NK) {
          bf[nt][0] = tf32_op<kBExact>(bs[n * BP + k + c]);
          bf[nt][1] = tf32_op<kBExact>(bs[n * BP + k + c + 4]);
        } else {
          bf[nt][0] = tf32_op<kBExact>(bs[(k + c) * BP + n]);
          bf[nt][1] = tf32_op<kBExact>(bs[(k + c + 4) * BP + n]);
        }
      }
      Tf32Pair af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const TA* p = as + (wm + mt * 16 + g) * AP + k + c;
        af[mt][0] = tf32_op<kAExact>(p[0]);
        af[mt][1] = tf32_op<kAExact>(p[8 * AP]);
        af[mt][2] = tf32_op<kAExact>(p[4]);
        af[mt][3] = tf32_op<kAExact>(p[8 * AP + 4]);
      }
      // pass 0 a_lo b_hi (A inexact), 1 a_hi b_lo (B inexact), 2 a_hi b_hi
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        if ((pass == 0 && kAExact) || (pass == 1 && kBExact)) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_pass(&acc[(mt * 4 + nt) * 4], af[mt], bf[nt], pass);
      }
    }
    promote(tot, acc);
  }
  cp_async_wait<0>();

  // accumulator (mt, nt, i): row wm + mt*16 + g + 8*(i >= 2), column
  // wn + nt*8 + 2c + (i & 1); N is even, so both columns are in or out
  if constexpr (EPI == kE32) {
    const TB* pb1 = static_cast<const TB*>(ep.v0);
    const TB* pw2 = static_cast<const TB*>(ep.v1);
    float lp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = n0 + wn + nt * 8 + 2 * c;
      if (j >= N) continue;
      const float b0 = to_f32(pb1[j]), b1 = to_f32(pb1[j + 1]);
      const float q0 = to_f32(pw2[j]), q1 = to_f32(pw2[j + 1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + wm + mt * 16 + g + 8 * hr;
          const float* f = &tot[(mt * 4 + nt) * 4 + 2 * hr];
          const float e0 = tanhf(f[0] + b0), e1 = tanhf(f[1] + b1);
          if (r < R && ep.out) *reinterpret_cast<float2*>(&ep.out[(size_t)r * N + j]) = make_float2(e0, e1);
          lp[mt][hr] = fmaf(round_to<TB>(e0), q0, lp[mt][hr]);
          lp[mt][hr] = fmaf(round_to<TB>(e1), q1, lp[mt][hr]);
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
    if (tid < kGM && r0 + tid < R) {
      ep.part[(size_t)blockIdx.y * R + r0 + tid] =
          ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + wm + mt * 16 + g + 8 * hr;
          const int n = n0 + wn + nt * 8 + 2 * c;
          if (r >= R || n >= N) continue;
          const float v0 = tot[(mt * 4 + nt) * 4 + 2 * hr];
          const float v1 = tot[(mt * 4 + nt) * 4 + 2 * hr + 1];
          const size_t o = (size_t)r * N + n;
          if constexpr (EPI == kQkv) {
            const int m = n / b.piece, col = n % b.piece;
            const TB* bias = static_cast<const TB*>(m == 0 ? ep.v0 : (m == 1 ? ep.v1 : ep.v2));
            *reinterpret_cast<float2*>(&ep.out[o]) =
                make_float2(round_to<TB>(v0 + to_f32(bias[col])),
                            round_to<TB>(v1 + to_f32(bias[col + 1])));
          } else if constexpr (EPI == kDctx) {
            const float al = ep.alpha[r];
            const float* du = ep.du + (size_t)(r / ep.H) * N + n;
            *reinterpret_cast<float2*>(&ep.out[o]) = make_float2(al * du[0] + v0, al * du[1] + v1);
          } else {
            TB* out = static_cast<TB*>(ep.out_t) + o;
            out[0] = from_f32<TB>(v0);
            out[1] = from_f32<TB>(v1);
          }
        }
      }
    }
  }
}

template <typename TA, bool A_EXACT, typename TB, bool NK, int EPI>
cudaError_t rows_gemm(const TA* a, BOperand b, int R, int K, int N, const Epi& ep,
                      cudaStream_t stream) {
  constexpr size_t smem = gemm_smem<TA, TB, NK>();
  cudaError_t err = allow_smem(rows_gemm_kernel<TA, A_EXACT, TB, NK, EPI>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kGM - 1) / kGM, (N + kGN - 1) / kGN);
  rows_gemm_kernel<TA, A_EXACT, TB, NK, EPI><<<grid, kGThreads, smem, stream>>>(a, b, R, K, N, ep);
  return cudaGetLastError();
}

// ------------------------------------------------------------ attention
constexpr int kAttThreads = 256;

// Masked exp-normalization of `len` values in place by one warp:
// exp(v - max) * mask / (sum + 1e-8), the max over every slot.
__device__ inline void warp_softmax(float* v, const float* mk, int len, int lane) {
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

// q, k, v (and dctx) of one head in shared memory, rows of dh + 1 floats
// (an odd pitch: the score loops read neighbouring rows without bank
// conflicts), then one (H, H) map (two in the backward) and the mask.
__host__ __device__ inline size_t attn_smem_floats(const Dims& d, bool bwd) {
  const size_t rows = (size_t)d.H * (d.dh + 1);
  return (bwd ? 4 : 3) * rows + (bwd ? 2 : 1) * (size_t)d.H * d.H + d.H;
}

// One (history row, head) a block. Forward: ctx[:, head] = round(softmax(
// q k^T / sqrt(dh)) v) into `out` (R, D). Backward: the softmax recomputed
// (unrounded), da = dctx v^T, ds = a (da - sum(a da)), less a times its
// rounded row sum, over sqrt(dh), then
// dq = ds k, dk = ds^T q, dv = a^T dctx into `out` (R, 3D).
template <typename T, bool BWD>
__global__ void __launch_bounds__(kAttThreads)
    attn_head_kernel(const float* __restrict__ qkv, const float* __restrict__ dctx,
                     const float* __restrict__ mask, float* __restrict__ out, Dims dm) {
  extern __shared__ __align__(16) float asmem[];
  const int H = dm.H, D = dm.D, dh = dm.dh, P = dh + 1;
  const int row = blockIdx.x / dm.nh, h = blockIdx.x % dm.nh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float* qs = asmem;
  float* ks = qs + H * P;
  float* vs = ks + H * P;
  float* gs = vs + H * P;                 // backward: dctx
  float* S = BWD ? gs + H * P : gs;       // (H, H) attention weights
  float* da = S + H * H;                  // backward: (H, H)
  float* mk = BWD ? da + H * H : da;      // (H)
  const float scale = sqrtf(static_cast<float>(dh));

  const size_t row0 = (size_t)row * H;
  for (int i = tid; i < H * dh; i += blockDim.x) {
    const int t = i / dh, j = i - t * dh;
    const float* src = qkv + (row0 + t) * 3 * D + h * dh + j;
    qs[t * P + j] = src[0];
    ks[t * P + j] = src[D];
    vs[t * P + j] = src[2 * D];
    if constexpr (BWD) gs[t * P + j] = dctx[(row0 + t) * D + h * dh + j];
  }
  for (int t = tid; t < H; t += blockDim.x) mk[t] = mask ? mask[row0 + t] : 1.f;
  __syncthreads();
  for (int w = tid; w < H * H; w += blockDim.x) {
    const int t = w / H, u = w - t * H;
    float s = 0.f, g = 0.f;
    for (int i = 0; i < dh; ++i) {
      s = fmaf(qs[t * P + i], ks[u * P + i], s);
      if constexpr (BWD) g = fmaf(gs[t * P + i], vs[u * P + i], g);
    }
    S[w] = s / scale;
    if constexpr (BWD) da[w] = g;
  }
  __syncthreads();
  for (int t = warp; t < H; t += nwarps) {
    float* a = S + t * H;
    warp_softmax(a, mk, H, lane);
    __syncwarp();
    if constexpr (BWD) {
      float s = 0.f;
      for (int u = lane; u < H; u += 32) s = fmaf(a[u], da[t * H + u], s);
      s = warp_sum(s);
      float r = 0.f, sa = 0.f;
      for (int u = lane; u < H; u += 32) {
        da[t * H + u] = a[u] * (da[t * H + u] - s);
        r += da[t * H + u];
        sa += a[u];
      }
      // the row's score cotangents sum to zero, as in pool_bwd_kernel
      r = warp_sum(r);
      sa = warp_sum(sa);
      const float c = sa > 0.f ? r / sa : 0.f;
      for (int u = lane; u < H; u += 32) da[t * H + u] = (da[t * H + u] - a[u] * c) / scale;
    } else {
      for (int u = lane; u < H; u += 32) a[u] = round_to<T>(a[u]);
    }
  }
  __syncthreads();
  if constexpr (BWD) {
    for (int w = tid; w < 3 * H * dh; w += blockDim.x) {
      const int m = w / (H * dh), rest = w - m * H * dh, t = rest / dh, i = rest - t * dh;
      float acc = 0.f;
      if (m == 0) {
        for (int u = 0; u < H; ++u) acc = fmaf(da[t * H + u], ks[u * P + i], acc);
      } else if (m == 1) {
        for (int u = 0; u < H; ++u) acc = fmaf(da[u * H + t], qs[u * P + i], acc);
      } else {
        for (int u = 0; u < H; ++u) acc = fmaf(S[u * H + t], gs[u * P + i], acc);
      }
      out[(row0 + t) * 3 * D + m * D + h * dh + i] = acc;
    }
  } else {
    for (int w = tid; w < H * dh; w += blockDim.x) {
      const int t = w / dh, i = w - t * dh;
      float acc = 0.f;
      for (int u = 0; u < H; ++u) acc = fmaf(S[t * H + u], vs[u * P + i], acc);
      out[(row0 + t) * D + h * dh + i] = round_to<T>(acc);
    }
  }
}

constexpr int kPoolThreads = 256;  // the per-row pool blocks of B and E

__host__ __device__ inline int e32_tiles(int Q) { return (Q + kGN - 1) / kGN; }

}  // namespace
