// Kernels F1, F2, F3: flash attention, forward and its blocked backward.
//
// Replaces the Pallas kernels of fedrec_tpu/ops/attention_kernels.py:
//   F1 flash_fwd_kernel     <- _flash_kernel         (via _flash_forward)
//   F2 flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel  (via _flash_bwd)
//   F3 flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel (via _flash_bwd)
// on (BH, L, d) operands with a per-key f32 bias (BH, Lk): the mask's -1e9.
//
// What bounds them: the long-history user tower has 20 heads of width 20.
// Per (query, key) pair F1 does 2*(dk + dv) operations, F2 2*(2*dk + dv)
// and F3 2*(2*dk + 2*dv), against a few bytes per row of q/k/v: at L = 2048
// every kernel is bound by operations, hundreds per byte. The tensor cores
// take f32 only as TF32, which keeps about 3 decimal digits, so the products
// run on the CUDA cores in full f32 (bf16 operands are widened to f32).
//
// Design: a block owns one tile of output rows and
// walks the other axis in order, one thread per output row.
//   F1, F2: one block per (bh, 64-query tile); K/V/bias tiles of 64 keys are
//           staged in shared memory as f32 and read by every thread as
//           broadcast float4s; each thread keeps its q (and do) row and its
//           accumulator in registers. F1 runs the online softmax over
//           16-key register sub-tiles (one max and one correction per
//           sub-tile).
//   F3:     one block per (bh, 64-key tile), walking 64-query tiles of
//           q / do / lse / delta staged in shared memory; each thread keeps
//           its k and v rows and the dk, dv, dbias accumulators.
// Each output has one owner that sums in a fixed order: no atomics, so the
// results repeat to the bit. The score of a pair is computed by the same
// helper in all three kernels (the products of the same operands summed in
// the same order), so F2 and F3 rebuild exactly F1's scores.
//
// Numerics follow the JAX kernels: the running max starts at -1e9 (not
// -inf) and the sum is floored at 1e-30, so a fully-masked row attends
// uniformly, as there (the wrapper then zeroes it); p is rounded to the
// operand dtype before P.V (F1) and before dv (F3), ds before dq (F2) and
// dk (F3); dbias sums the unrounded f32 ds. JAX pads keys to its block with
// bias -1e9; here the tail of the last tile is skipped instead.
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace fedrec;

constexpr int BQ = 64;            // query rows of an F1/F2 block and of an F3 query tile
constexpr int BK = 64;            // key rows of an F3 block and of an F1/F2 key tile
constexpr int SUB = 16;           // keys per register sub-tile of F1's online softmax
constexpr float kNegInit = -1e9f; // JAX's running-max start (and the mask bias)

__host__ __device__ inline int pad4(int d) { return (d + 3) & ~3; }

// Rows [0, rows) of a row-major (rows, d) block in global memory into a
// shared tile with row stride pad4(d), as f32; the padding columns are 0 so
// that float4 dot products over them add exact zeros.
template <typename T>
__device__ void stage_rows(float* dst, const T* __restrict__ src, int rows, int d) {
  const int dp = pad4(d);
  for (int i = threadIdx.x; i < rows * dp; i += blockDim.x) {
    const int r = i / dp, c = i - r * dp;
    dst[i] = c < d ? to_f32(src[(size_t)r * d + c]) : 0.f;
  }
}

// A (d,) row into registers as f32, zero past d. EXACT: d == 4 * D4.
template <int D4, bool EXACT, typename T>
__device__ __forceinline__ void load_row(float (&r)[4 * D4], const T* __restrict__ src, int d) {
#pragma unroll
  for (int i = 0; i < 4 * D4; ++i) r[i] = (EXACT || i < d) ? to_f32(src[i]) : 0.f;
}

// sum_i a[i] * row[i], left to right, over n4 float4s of a shared row.
template <int D4, bool EXACT>
__device__ __forceinline__ float dot_row(const float (&a)[4 * D4], const float* row, int n4) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D4; ++i) {
    if (EXACT || i < n4) {
      const float4 b = r4[i];
      s = fmaf(a[4 * i], b.x, s);
      s = fmaf(a[4 * i + 1], b.y, s);
      s = fmaf(a[4 * i + 2], b.z, s);
      s = fmaf(a[4 * i + 3], b.w, s);
    }
  }
  return s;
}

// acc[i] += p * row[i] over n4 float4s of a shared row.
template <int D4, bool EXACT>
__device__ __forceinline__ void axpy_row(float (&acc)[4 * D4], float p, const float* row, int n4) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < D4; ++i) {
    if (EXACT || i < n4) {
      const float4 b = r4[i];
      acc[4 * i] = fmaf(p, b.x, acc[4 * i]);
      acc[4 * i + 1] = fmaf(p, b.y, acc[4 * i + 1]);
      acc[4 * i + 2] = fmaf(p, b.z, acc[4 * i + 2]);
      acc[4 * i + 3] = fmaf(p, b.w, acc[4 * i + 3]);
    }
  }
}

// ------------------------------------------------------------------- F1
template <typename T, int D4, bool EXACT>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse,
                 int Lq, int Lk, int dk, int dv, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dkp = pad4(dk), dvp = pad4(dv), dk4 = dkp / 4, dv4 = dvp / 4;
  float* ks = smem;              // (BK, dkp)
  float* vs = ks + BK * dkp;     // (BK, dvp)
  float* bs = vs + BK * dvp;     // (BK)
  const int nqt = (Lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, row = (blockIdx.x - bh * nqt) * BQ + threadIdx.x;
  const bool live = row < Lq;

  float qr[4 * D4], acc[4 * D4];
  load_row<D4, EXACT>(qr, q + ((size_t)bh * Lq + (live ? row : 0)) * dk, dk);
#pragma unroll
  for (int i = 0; i < 4 * D4; ++i) acc[i] = 0.f;
  float m = kNegInit, l = 0.f;
  const T* kb = k + (size_t)bh * Lk * dk;
  const T* vb = v + (size_t)bh * Lk * dv;
  const float* bb = bias + (size_t)bh * Lk;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    const int nk = min(BK, Lk - k0);
    __syncthreads();  // the previous tile's readers are done
    stage_rows(ks, kb + (size_t)k0 * dk, nk, dk);
    stage_rows(vs, vb + (size_t)k0 * dv, nk, dv);
    for (int i = threadIdx.x; i < nk; i += blockDim.x) bs[i] = bb[k0 + i];
    __syncthreads();
    for (int j0 = 0; j0 < nk; j0 += SUB) {
      float s[SUB];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        s[jj] = -INFINITY;
        if (j < nk) {
          s[jj] = fmaf(dot_row<D4, EXACT>(qr, ks + j * dkp, dk4), scale, bs[j]);
          mx = fmaxf(mx, s[jj]);
        }
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int i = 0; i < 4 * D4; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        if (j < nk) {
          const float p = expf(s[jj] - mx);
          l += p;
          axpy_row<D4, EXACT>(acc, round_to<T>(p), vs + j * dvp, dv4);
        }
      }
      m = mx;
    }
  }
  if (live) {
    const float ls = fmaxf(l, 1e-30f);
    T* orow = out + ((size_t)bh * Lq + row) * dv;
#pragma unroll
    for (int i = 0; i < 4 * D4; ++i)
      if (EXACT || i < dv) orow[i] = from_f32<T>(acc[i] / ls);
    lse[(size_t)bh * Lq + row] = m + logf(ls);
  }
}

// ------------------------------------------------------------------- F2
template <typename T, int D4, bool EXACT>
__global__ void __launch_bounds__(BQ)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Lq, int Lk, int dk, int dv, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dkp = pad4(dk), dvp = pad4(dv), dk4 = dkp / 4, dv4 = dvp / 4;
  float* ks = smem;
  float* vs = ks + BK * dkp;
  float* bs = vs + BK * dvp;
  const int nqt = (Lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, row = (blockIdx.x - bh * nqt) * BQ + threadIdx.x;
  const bool live = row < Lq;
  const size_t r = (size_t)bh * Lq + (live ? row : 0);

  float qr[4 * D4], dor[4 * D4], acc[4 * D4];
  load_row<D4, EXACT>(qr, q + r * dk, dk);
  load_row<D4, EXACT>(dor, dout + r * dv, dv);
#pragma unroll
  for (int i = 0; i < 4 * D4; ++i) acc[i] = 0.f;
  const float lse_r = lse[r], delta_r = delta[r];
  const T* kb = k + (size_t)bh * Lk * dk;
  const T* vb = v + (size_t)bh * Lk * dv;
  const float* bb = bias + (size_t)bh * Lk;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    const int nk = min(BK, Lk - k0);
    __syncthreads();
    stage_rows(ks, kb + (size_t)k0 * dk, nk, dk);
    stage_rows(vs, vb + (size_t)k0 * dv, nk, dv);
    for (int i = threadIdx.x; i < nk; i += blockDim.x) bs[i] = bb[k0 + i];
    __syncthreads();
    // unrolled so that several keys' dot chains interleave; each sum keeps
    // its order, so the results do not change
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float s = fmaf(dot_row<D4, EXACT>(qr, ks + j * dkp, dk4), scale, bs[j]);
      const float p = expf(s - lse_r);
      const float dp = dot_row<D4, EXACT>(dor, vs + j * dvp, dv4);
      const float ds = p * (dp - delta_r);
      axpy_row<D4, EXACT>(acc, round_to<T>(ds), ks + j * dkp, dk4);
    }
  }
  if (live) {
    T* out = dq + r * dk;
#pragma unroll
    for (int i = 0; i < 4 * D4; ++i)
      if (EXACT || i < dk) out[i] = from_f32<T>(acc[i] * scale);
  }
}

// ------------------------------------------------------------------- F3
template <typename T, int D4, bool EXACT>
__global__ void __launch_bounds__(BK)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk_out, T* __restrict__ dv_out, float* __restrict__ dbias,
                     int Lq, int Lk, int dk, int dv, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dkp = pad4(dk), dvp = pad4(dv), dk4 = dkp / 4, dv4 = dvp / 4;
  float* qs = smem;               // (BQ, dkp)
  float* dos = qs + BQ * dkp;     // (BQ, dvp)
  float* lss = dos + BQ * dvp;    // (BQ)
  float* dls = lss + BQ;          // (BQ)
  const int nkt = (Lk + BK - 1) / BK;
  const int bh = blockIdx.x / nkt, key = (blockIdx.x - bh * nkt) * BK + threadIdx.x;
  const bool live = key < Lk;
  const size_t c = (size_t)bh * Lk + (live ? key : 0);

  float kr[4 * D4], vr[4 * D4], dka[4 * D4], dva[4 * D4];
  load_row<D4, EXACT>(kr, k + c * dk, dk);
  load_row<D4, EXACT>(vr, v + c * dv, dv);
#pragma unroll
  for (int i = 0; i < 4 * D4; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  const float b = bias[c];
  float db = 0.f;
  const T* qb = q + (size_t)bh * Lq * dk;
  const T* gb = dout + (size_t)bh * Lq * dv;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    const int nq = min(BQ, Lq - q0);
    __syncthreads();
    stage_rows(qs, qb + (size_t)q0 * dk, nq, dk);
    stage_rows(dos, gb + (size_t)q0 * dv, nq, dv);
    for (int i = threadIdx.x; i < nq; i += blockDim.x) {
      lss[i] = lse[(size_t)bh * Lq + q0 + i];
      dls[i] = delta[(size_t)bh * Lq + q0 + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < nq; ++i) {
      const float s = fmaf(dot_row<D4, EXACT>(kr, qs + i * dkp, dk4), scale, b);
      const float p = expf(s - lss[i]);
      axpy_row<D4, EXACT>(dva, round_to<T>(p), dos + i * dvp, dv4);
      const float dp = dot_row<D4, EXACT>(vr, dos + i * dvp, dv4);
      const float ds = p * (dp - dls[i]);
      db += ds;
      axpy_row<D4, EXACT>(dka, round_to<T>(ds), qs + i * dkp, dk4);
    }
  }
  if (live) {
    T* ko = dk_out + c * dk;
    T* vo = dv_out + c * dv;
#pragma unroll
    for (int i = 0; i < 4 * D4; ++i) {
      if (EXACT || i < dk) ko[i] = from_f32<T>(dka[i] * scale);
      if (EXACT || i < dv) vo[i] = from_f32<T>(dva[i]);
    }
    dbias[c] = db;
  }
}

// ---------------------------------------------------------------- launch
size_t smem_rows(int which, int dk, int dv) {
  // F1 and F2 stage K, V and bias tiles; F3 stages q, do, lse and delta
  if (which == 2) return sizeof(float) * ((size_t)BQ * (pad4(dk) + pad4(dv)) + 2 * BQ);
  return sizeof(float) * ((size_t)BK * (pad4(dk) + pad4(dv)) + BK);
}

struct Args {
  const void *q, *k, *v, *bias, *dout, *lse, *delta;
  void *o0, *o1, *o2;  // F1: out, lse; F2: dq; F3: dk, dv, dbias
  int bh, lq, lk, dk, dv;
  float scale;
};

template <typename T, int D4, bool EXACT>
int launch(int which, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_rows(which, a.dk, a.dv);
  cudaError_t err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* bias = static_cast<const float*>(a.bias);
  if (which == 0) {
    err = allow_smem(flash_fwd_kernel<T, D4, EXACT>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = a.bh * ((a.lq + BQ - 1) / BQ);
    if (grid > 0)
      flash_fwd_kernel<T, D4, EXACT><<<grid, BQ, smem, stream>>>(
          q, k, v, bias, static_cast<T*>(a.o0), static_cast<float*>(a.o1), a.lq, a.lk, a.dk,
          a.dv, a.scale);
  } else if (which == 1) {
    err = allow_smem(flash_bwd_dq_kernel<T, D4, EXACT>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = a.bh * ((a.lq + BQ - 1) / BQ);
    if (grid > 0)
      flash_bwd_dq_kernel<T, D4, EXACT><<<grid, BQ, smem, stream>>>(
          q, k, v, bias, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta), static_cast<T*>(a.o0), a.lq, a.lk, a.dk, a.dv,
          a.scale);
  } else {
    err = allow_smem(flash_bwd_dkv_kernel<T, D4, EXACT>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = a.bh * ((a.lk + BK - 1) / BK);
    if (grid > 0)
      flash_bwd_dkv_kernel<T, D4, EXACT><<<grid, BK, smem, stream>>>(
          q, k, v, bias, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta), static_cast<T*>(a.o0), static_cast<T*>(a.o1),
          static_cast<float*>(a.o2), a.lq, a.lk, a.dk, a.dv, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Width buckets: the user tower's 20 exactly (no bounds tests in the
// unrolled loops), else the next of 32 / 64 / 128 with runtime bounds.
template <typename T>
int dispatch(int which, const Args& a, cudaStream_t stream) {
  const int d = a.dk > a.dv ? a.dk : a.dv;
  if (a.dk == 20 && a.dv == 20) return launch<T, 5, true>(which, a, stream);
  if (d <= 32) return launch<T, 8, false>(which, a, stream);
  if (d <= 64) return launch<T, 16, false>(which, a, stream);
  return launch<T, 32, false>(which, a, stream);
}

int run(int which, const Args& a, int dtype, void* stream) {
  if (a.dk < 1 || a.dv < 1 || a.dk > 128 || a.dv > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(which, a, s) : dispatch<__nv_bfloat16>(which, a, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory of kernel `which` (0 F1, 1 F2, 2 F3) at these
// widths (bytes); the wrapper refuses widths above the card's limit.
size_t flash_smem_bytes(int which, int dk, int dv) { return smem_rows(which, dk, dv); }

// q (bh, lq, dk), k (bh, lk, dk), v (bh, lk, dv) in one dtype (0 f32, 1
// bf16), bias (bh, lk) f32 -> out (bh, lq, dv) in that dtype, lse (bh, lq)
// f32. Returns cudaGetLastError() after the launch.
int flash_fwd_launch(const void* q, const void* k, const void* v, const void* bias, void* out,
                     void* lse, int bh, int lq, int lk, int dk, int dv, float scale, int dtype,
                     void* stream) {
  Args a{q, k, v, bias, nullptr, nullptr, nullptr, out, lse, nullptr, bh, lq, lk, dk, dv, scale};
  return run(0, a, dtype, stream);
}

// dout (bh, lq, dv), lse and delta = rowsum(dout * out) (bh, lq) f32 ->
// dq (bh, lq, dk).
int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* bias,
                        const void* dout, const void* lse, const void* delta, void* dq, int bh,
                        int lq, int lk, int dk, int dv, float scale, int dtype, void* stream) {
  Args a{q, k, v, bias, dout, lse, delta, dq, nullptr, nullptr, bh, lq, lk, dk, dv, scale};
  return run(1, a, dtype, stream);
}

// -> dk (bh, lk, dk), dv (bh, lk, dv) in the operand dtype, dbias (bh, lk) f32.
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* bias,
                         const void* dout, const void* lse, const void* delta, void* dk_out,
                         void* dv_out, void* dbias, int bh, int lq, int lk, int dk, int dv,
                         float scale, int dtype, void* stream) {
  Args a{q, k, v, bias, dout, lse, delta, dk_out, dv_out, dbias, bh, lq, lk, dk, dv, scale};
  return run(2, a, dtype, stream);
}

}  // extern "C"
