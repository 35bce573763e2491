// Deterministic weight-gradient sums for the backward kernels (D and E):
//
//   C (M, N) = sum_r A[r, :]^T B[r, :]      and      bias (N) = sum_r B[r, :]
//
// over R rows, the stage 2 of every two-stage backward here. The Pallas
// kernels add these products into constant-index output blocks across a
// sequential grid; on Hopper blocks run in no order, so float atomics would
// make every training step's sums differ run to run. Instead each block owns
// one 128 x 128 tile of C (the bias is an extra row of C whose A column is all
// ones) and walks its share of the rows in a fixed order; the R rows are cut
// into S contiguous splits so that enough blocks fill the card, each split
// writes a partial tile to scratch, and a second kernel adds the S partials
// in order. Same inputs, same bits.
//
// Rows are addressed through a RowMap, so A can be read straight from where
// it lives: a gathered token-state row (ids), a history block, or one slot of
// a packed scratch tensor, without copying it into an (R, M) matrix first.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace fedrec {

// row r lives at base + (ids ? ids[r / per] : r / per) * group + (r % per) * ld
struct RowMap {
  const void* base;
  const int64_t* ids;
  int per;
  long long group;
  int ld;
  int clamp_n;  // with ids: clamp each id into [0, clamp_n) (JAX's gather)
};

__host__ inline RowMap rows_contiguous(const void* base, int ld) {
  return RowMap{base, nullptr, 1, ld, 0, 0};
}

template <typename T>
__device__ __forceinline__ const T* row_ptr(const RowMap& m, int r) {
  long long g = r / m.per;
  if (m.ids != nullptr) {
    g = m.ids[g];
    g = g < 0 ? 0 : (g >= m.clamp_n ? m.clamp_n - 1 : g);
  }
  return static_cast<const T*>(m.base) + g * m.group + (long long)(r % m.per) * m.ld;
}

constexpr int kWgTile = 128;  // output tile, both sides
constexpr int kWgChunk = 16;  // rows staged per step
constexpr int kWgThreads = 256;

// partial[s] (M + 1, N) = rows [s*per_split, ...) of A^T B, row M = column
// sums. 16 x 16 threads, each summing an 8 x 8 block of the tile (rows
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise with tx), so one
// shared-memory read feeds four products.
template <typename TA>
__global__ void __launch_bounds__(kWgThreads) wgrad_partial_kernel(RowMap a, RowMap b, int R,
                                                                   int M, int N, int per_split,
                                                                   float* __restrict__ partial) {
  __shared__ __align__(16) float As[kWgChunk][kWgTile];
  __shared__ __align__(16) float Bs[kWgChunk][kWgTile];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kWgTile, m0 = blockIdx.y * kWgTile, s = blockIdx.z;
  const int r_begin = s * per_split;
  const int r_end = min(R, r_begin + per_split);
  // staging: each thread loads 4 neighbouring columns of rows k and k + 8
  const int c0 = (tid & 31) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kWgChunk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = (tid >> 5) + 8 * h, r = r0 + k;
      float av[4] = {0.f, 0.f, 0.f, 0.f}, bv[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < r_end) {
        const TA* arow = row_ptr<TA>(a, r);
        const float* brow = row_ptr<float>(b, r);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + c0 + j, n = n0 + c0 + j;
          av[j] = m < M ? to_f32(arow[m]) : (m == M ? 1.f : 0.f);  // row M: the bias
          bv[j] = n < N ? brow[n] : 0.f;
        }
      }
      *reinterpret_cast<float4*>(&As[k][c0]) = make_float4(av[0], av[1], av[2], av[3]);
      *reinterpret_cast<float4*>(&Bs[k][c0]) = make_float4(bv[0], bv[1], bv[2], bv[3]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWgChunk; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = partial + (size_t)s * (M + 1) * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m > M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// C and bias = the S partials added in split order
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, int S, int M, int N,
                                    float* __restrict__ c, float* __restrict__ bias) {
  const size_t total = (size_t)(M + 1) * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += partial[(size_t)s * total + i];
    const size_t m = i / N;
    if (m < (size_t)M) c[i] = v;
    else if (bias != nullptr) bias[i - (size_t)M * N] = v;
  }
}

// Splits for R rows: enough blocks for two waves over 132 SMs, at least 64
// rows a split, at most 32 splits.
__host__ inline int wgrad_splits(int R, int M, int N) {
  const int tiles = ((N + kWgTile - 1) / kWgTile) * ((M + 1 + kWgTile - 1) / kWgTile);
  int s = (264 + tiles - 1) / tiles;
  const int most = (R + 63) / 64;
  if (s > most) s = most;
  if (s > 32) s = 32;
  return s < 1 ? 1 : s;
}

// Floats of scratch wgrad() needs for these sizes.
__host__ inline size_t wgrad_scratch_floats(int R, int M, int N) {
  return (size_t)wgrad_splits(R, M, N) * (M + 1) * N;
}

// c (M, N) = A^T B and bias (N) = column sums of B (bias may be null; M may
// be 0 for a column sum alone). Launches on `stream`; returns the first
// launch error.
template <typename TA>
__host__ inline cudaError_t wgrad(RowMap a, RowMap b, int R, int M, int N, float* scratch,
                                  float* c, float* bias, cudaStream_t stream) {
  const int S = wgrad_splits(R, M, N);
  const int per_split = ((R + S - 1) / S + kWgChunk - 1) / kWgChunk * kWgChunk;
  dim3 grid((N + kWgTile - 1) / kWgTile, (M + 1 + kWgTile - 1) / kWgTile, S);
  if (R > 0) {
    wgrad_partial_kernel<TA><<<grid, kWgThreads, 0, stream>>>(a, b, R, M, N, per_split, scratch);
  } else {
    cudaMemsetAsync(scratch, 0, sizeof(float) * (size_t)S * (M + 1) * N, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)(M + 1) * N;
  int blocks = (int)((total + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  wgrad_reduce_kernel<<<blocks, 256, 0, stream>>>(scratch, S, M, N, c, bias);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad_tc: the same deterministic scheme (output tiles x S contiguous row
// splits, partials to scratch, a second kernel adding them in split order)
// with the inner product on the tensor cores, for the sums too large for
// CUDA cores (kernel D's dW1 = X^T dpre, 104 GFLOP at the train path's
// shape). No bias row: callers take column sums from wgrad() with M = 0.
//
// Precision (see mma.cuh): B (f32) is split into TF32 hi and lo; an f32 A
// is split too and each product takes three passes, a bf16 A is exact in
// TF32 and takes two (a b_lo + a b_hi). Every staged chunk of kTcRows rows
// is summed in a fresh accumulator and promoted into the f32 total.
//
// mma.sync, not wgmma: the A operand here is X^T, read column-wise from row
// tiles of the gathered table, and wgmma takes TF32 operands K-major only;
// mma.sync fragments are loaded element by element from shared memory in
// either layout, and the split happens as they are formed.
constexpr int kTcTile = 128;   // output tile, both sides
constexpr int kTcRows = 32;    // rows staged per step (one promotion)
constexpr int kTcStages = 3;   // cp.async ring
constexpr int kTcThreads = 256;
constexpr int kTcPitch = kTcTile + 8;  // conflict-free fragment reads

template <typename TA>
__host__ __device__ constexpr size_t wgrad_tc_stage_bytes() {
  return (size_t)kTcRows * kTcPitch * (sizeof(TA) + sizeof(float));
}

template <typename TA>
__host__ __device__ constexpr size_t wgrad_tc_smem_bytes() {
  return kTcStages * wgrad_tc_stage_bytes<TA>();
}

// partial[s] (M, N) = rows [s*per_split, ...) of A^T B. 8 warps, 2 x 4, each
// owning a 64 x 32 block of the 128 x 128 tile (4 x 4 m16n8 fragments).
// M and N divide by 4 (16-byte row copies).
template <typename TA>
__global__ void __launch_bounds__(kTcThreads, 1)
    wgrad_tc_partial_kernel(RowMap a, RowMap b, int R, int M, int N, int per_split,
                            float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  constexpr bool kF32 = std::is_same<TA, float>::value;
  constexpr size_t kStage = wgrad_tc_stage_bytes<TA>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * kTcTile, m0 = blockIdx.y * kTcTile, s = blockIdx.z;
  const int r_begin = s * per_split;
  const int r_end = min(R, r_begin + per_split);
  const int chunks = r_end > r_begin ? (r_end - r_begin + kTcRows - 1) / kTcRows : 0;

  auto a_tile = [&](int st) { return reinterpret_cast<TA*>(tc_smem + st * kStage); };
  auto b_tile = [&](int st) {
    return reinterpret_cast<float*>(tc_smem + st * kStage + (size_t)kTcRows * kTcPitch * sizeof(TA));
  };
  // each thread copies columns col..col+3 of rows k, k + 8, k + 16, k + 24
  const int col = (tid & 31) * 4, krow = tid >> 5;
  auto load = [&](int st, int chunk) {
    TA* as = a_tile(st);
    float* bs = b_tile(st);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = krow + 8 * i, r = r_begin + chunk * kTcRows + k;
      const bool in = r < r_end;
      const bool va = in && m0 + col < M, vb = in && n0 + col < N;
      const TA* asrc = va ? row_ptr<TA>(a, r) + m0 + col : static_cast<const TA*>(a.base);
      const float* bsrc = vb ? row_ptr<float>(b, r) + n0 + col : static_cast<const float*>(b.base);
      cp_async4(as + k * kTcPitch + col, asrc, va);
      cp_async4(bs + k * kTcPitch + col, bsrc, vb);
    }
  };

  float acc[64], tot[64];  // [mt][nt][4], m16n8 accumulator fragments
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;

#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < chunks) load(st, st);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();
    const int nxt = ch + kTcStages - 1;
    if (nxt < chunks) load(nxt % kTcStages, nxt);
    cp_async_commit();
    const TA* as = a_tile(ch % kTcStages);
    const float* bs = b_tile(ch % kTcStages);
#pragma unroll
    for (int k = 0; k < kTcRows; k += 8) {
      Tf32Pair bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn + nt * 8 + g;
        bf[nt][0] = split_tf32(bs[(k + c) * kTcPitch + n]);
        bf[nt][1] = split_tf32(bs[(k + c + 4) * kTcPitch + n]);
      }
      // A (m, k) = X[k][m]: fragment rows m, m + 8; columns k + c, k + c + 4
      Tf32Pair af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int m = wm + mt * 16 + g;
        const TA* p0 = as + (k + c) * kTcPitch + m;
        const TA* p1 = as + (k + c + 4) * kTcPitch + m;
        const TA v[4] = {p0[0], p0[8], p1[0], p1[8]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kF32) {
            af[mt][i] = split_tf32(v[i]);
          } else {
            af[mt][i] = {bf16_tf32(v[i]), 0u};  // exact in TF32: no low part
          }
        }
      }
      // f32 A: three passes; bf16 A: a b_lo and a b_hi
#pragma unroll
      for (int pass = kF32 ? 0 : 1; pass < 3; ++pass)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_pass(&acc[(mt * 4 + nt) * 4], af[mt], bf[nt], pass);
    }
    promote(tot, acc);
  }
  cp_async_wait<0>();

  float* out = partial + (size_t)s * M * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int m = m0 + wm + mt * 16 + g, n = n0 + wn + nt * 8 + 2 * c;
      const float* f = &tot[(mt * 4 + nt) * 4];
      if (n < N) {
        if (m < M) *reinterpret_cast<float2*>(&out[(size_t)m * N + n]) = make_float2(f[0], f[1]);
        if (m + 8 < M)
          *reinterpret_cast<float2*>(&out[(size_t)(m + 8) * N + n]) = make_float2(f[2], f[3]);
      }
    }
  }
}

// c = the S partials added in split order
__global__ void wgrad_tc_reduce_kernel(const float* __restrict__ partial, int S, size_t total,
                                       float* __restrict__ c) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += partial[(size_t)s * total + i];
    c[i] = v;
  }
}

// Splits for R rows: about three waves of one block per SM over 132 SMs, at
// least 512 rows a split, at most 64 splits.
__host__ inline int wgrad_tc_splits(int R, int M, int N) {
  const int tiles = ((N + kTcTile - 1) / kTcTile) * ((M + kTcTile - 1) / kTcTile);
  int s = (3 * 132 + tiles - 1) / tiles;
  const int most = (R + 511) / 512;
  if (s > most) s = most;
  if (s > 64) s = 64;
  return s < 1 ? 1 : s;
}

__host__ inline size_t wgrad_tc_scratch_floats(int R, int M, int N) {
  return (size_t)wgrad_tc_splits(R, M, N) * M * N;
}

// c (M, N) = A^T B on the tensor cores; M and N divide by 4. Launches on
// `stream`; returns the first launch error.
template <typename TA>
__host__ inline cudaError_t wgrad_tc(RowMap a, RowMap b, int R, int M, int N, float* scratch,
                                     float* c, cudaStream_t stream) {
  const int S = wgrad_tc_splits(R, M, N);
  const int per_split = ((R + S - 1) / S + kTcRows - 1) / kTcRows * kTcRows;
  const size_t smem = wgrad_tc_smem_bytes<TA>();
  cudaError_t err = allow_smem(wgrad_tc_partial_kernel<TA>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTcTile - 1) / kTcTile, (M + kTcTile - 1) / kTcTile, S);
  wgrad_tc_partial_kernel<TA><<<grid, kTcThreads, smem, stream>>>(a, b, R, M, N, per_split, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)M * N;
  int blocks = (int)((total + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  wgrad_tc_reduce_kernel<<<blocks, 256, 0, stream>>>(scratch, S, total, c);
  return cudaGetLastError();
}

}  // namespace fedrec
