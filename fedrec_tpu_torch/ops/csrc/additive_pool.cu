// Kernels A and A2: additive pooling,
//   out[r] = softmax(tanh(x[r] W1 + b1) w2 + bias[r]) . x[r],
// bias = -1e9 on masked slots; a row with no valid slot pools to exactly 0.
//
// Replaces the Pallas kernel fedrec_tpu/ops/attention_kernels.py:_pool_kernel
// (reached through _pool_forward / additive_pool). The corpus encode runs it
// on every (L=50, D=768) token-state row of the catalog with Hd=384 hidden
// units, the long path's unfused text head on 32,848 such rows a client
// step, and the long-history user tower on (L=2048, D=400) rows with
// Hd=200. Nearly all the work is the product x W1 over the R = n L token
// rows (2 D Hd FLOP a token row against D x 4 bytes read: ~190 FLOP per
// byte at D=768), so it is bound by operations. On CUDA cores in f32 that
// is 67 TFLOP/s; on the tensor cores with f32 parity (3xTF32) 165.
//
// Design: two passes.
//   logits  pool_logits_kernel: one tensor-core GEMM over the R contiguous
//           token rows (kernel C's row kernel with the rows addressed
//           directly rather than through ids). A block owns 64 rows x a
//           tile of 32 NT hidden units (NT = 6: Hd=384 in two tiles; NT =
//           7: Hd=200 in one 224-wide tile, where 192 would waste most of a
//           second one), stages x and W1 in 32-deep chunks through a
//           3-stage cp.async ring (the tail chunk at D=400 is zero-filled),
//           and in its epilogue forms tanh(acc + b1) . w2 per row: one f32
//           partial logit per (row, hidden tile) leaves the block.
//   rows    pool_rows_kernel: per row, the partial logits added in tile
//           order, the mask bias, the true softmax (max-subtracted, divided
//           by the sum), then alpha . x re-reading the row: kParts token
//           partial sums per column (token t goes to partial t % kParts, in
//           token order), added in partial order; a fully-masked row is
//           zeroed. Kernel A runs it with a block per row (all columns);
//           kernel A2, for rows the wrapper deems too long for A, splits
//           each row's columns over blocks of kLongCols so that a few long
//           rows still fill the card. Each column's sums are the same
//           operations in the same order either way, and the logits pass is
//           shared, so A and A2 agree to the bit.
// Precision: the JAX kernel widens x and W1 to f32 before its dots. An f32
// x takes three TF32 passes (lo hi, hi lo, hi hi; mma.cuh); a bf16 x is
// exact in TF32 but W1 is not, so it takes two (x W1_lo, x W1_hi). Each
// 32-deep chunk sums in a fresh accumulator and is promoted with a
// round-to-nearest add (the tensor cores truncate as they accumulate).
// tests/test_torch_tc_precision.py holds the emulation against float64.
// The fc2 bias is not an input: it shifts every logit equally. Every sum
// has one owner and one order, without atomics: same inputs, same bits.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace fedrec;

constexpr float kNegInf = -1e9f;  // the JAX wrapper's mask bias
constexpr int kM = 64;            // token rows per logits block
constexpr int kK = 32;            // depth of a staged chunk
constexpr int kStages = 3;        // cp.async ring
constexpr int kThreads = 256;     // 8 warps: 2 (rows) x 4 (hidden units)
constexpr int kParts = 8;         // token partial sums per column in the pool pass
constexpr int kPoolThreads = 256;
constexpr int kRowCols = 1024;    // A: columns per pool block (one block covers D <= 1024)
constexpr int kLongCols = 32;     // A2: columns per pool block

template <int NT>
__host__ __device__ constexpr int tile_n() {  // hidden units per logits block
  return 32 * NT;
}

template <int NT>
__host__ __device__ constexpr int w_pitch() {  // W1 tile row: conflict-free B fragments
  return tile_n<NT>() + 8;
}

template <typename T>
__host__ __device__ constexpr int x_pitch() {  // x tile row: conflict-free A fragments
  return std::is_same<T, float>::value ? kK + 4 : kK + 8;
}

template <typename T, int NT>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)kM * x_pitch<T>() * sizeof(T) + (size_t)kK * w_pitch<NT>() * sizeof(float);
}

template <typename T, int NT>
__host__ __device__ constexpr size_t logits_smem() {
  return kStages * stage_bytes<T, NT>();
}

// The hidden tile: 32 NT units, NT 6 or 7, whichever needs fewer n-tile
// steps per warp over all tiles (Hd=384: 2 x 6 against 2 x 7; Hd=200: 1 x 7
// against 2 x 6).
int pick_nt(int Hd) {
  const int c6 = (Hd + tile_n<6>() - 1) / tile_n<6>() * 6;
  const int c7 = (Hd + tile_n<7>() - 1) / tile_n<7>() * 7;
  return c7 < c6 ? 7 : 6;
}

int logit_tiles(int Hd) {
  const int tn = 32 * pick_nt(Hd);
  return (Hd + tn - 1) / tn;
}

int pool_cols(int D, bool is_long) {
  const int cap = is_long ? kLongCols : kRowCols;
  return D < cap ? D : cap;
}

size_t pool_smem(int L, int cols) {
  return sizeof(float) * (((size_t)L + 3) / 4 * 4 + (size_t)kParts * cols);
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

// part[h][r] = sum over this block's hidden units j of tanh(x_r W1_j + b1_j) w2_j
// for 64 rows r and 32 NT units (h = blockIdx.x % nh). 8 warps, 2 x 4,
// each 32 rows x 8 NT units.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    pool_logits_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2, int R, int D,
                       int Hd, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[4][kM];
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int XP = x_pitch<T>(), WP = w_pitch<NT>(), TN = tile_n<NT>();
  constexpr int kFirstPass = kF32 ? 0 : 1;  // a bf16 x has no low part
  constexpr size_t kStage = stage_bytes<T, NT>();
  const int nh = (Hd + TN - 1) / TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * (8 * NT);
  const int row0 = (blockIdx.x / nh) * kM, h = blockIdx.x % nh, n0 = h * TN;
  const int chunks = (D + kK - 1) / kK;
  const bool w_vec = (Hd & 3) == 0;  // W1 rows 16-byte aligned: copy 4 units at once

  auto x_tile = [&](int st) { return reinterpret_cast<T*>(smem + st * kStage); };
  auto w_tile = [&](int st) {
    return reinterpret_cast<float*>(smem + st * kStage + (size_t)kM * XP * sizeof(T));
  };
  // x: rows xr, xr + 32 at depth xk..xk+3
  const int xr = tid >> 3, xk = (tid & 7) * 4;
  const T* xsrc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + xr + 32 * i;
    xsrc[i] = r < R ? x + (size_t)r * D : nullptr;
  }
  auto load = [&](int st, int chunk) {
    const int k0 = chunk * kK;
    T* xs = x_tile(st);
    float* ws = w_tile(st);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool v = xsrc[i] != nullptr && k0 + xk < D;
      cp_async4(xs + (xr + 32 * i) * XP + xk, v ? xsrc[i] + k0 + xk : x, v);
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {  // 32 x TN units, 4 a copy
      const int idx = tid + kThreads * i, kk = idx / (8 * NT), nq = (idx % (8 * NT)) * 4;
      const int kg = k0 + kk, ng = n0 + nq;
      float* dst = ws + kk * WP + nq;
      if (w_vec) {
        const bool v = kg < D && ng < Hd;
        cp_async4(dst, v ? w1 + (size_t)kg * Hd + ng : w1, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool v = kg < D && ng + e < Hd;
          cp_async1(dst + e, v ? w1 + (size_t)kg * Hd + ng + e : w1, v);
        }
      }
    }
  };

  float acc[8 * NT], tot[8 * NT];  // [mt 2][nt NT][4]
#pragma unroll
  for (int i = 0; i < 8 * NT; ++i) acc[i] = tot[i] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < chunks) load(st, st);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = ch + kStages - 1;
    if (nxt < chunks) load(nxt % kStages, nxt);
    cp_async_commit();
    const T* xs = x_tile(ch % kStages);
    const float* ws = w_tile(ch % kStages);
#pragma unroll
    for (int k = 0; k < kK; k += 8) {
      Tf32Pair bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn + nt * 8 + g;
        bf[nt][0] = split_tf32(ws[(k + c) * WP + n]);
        bf[nt][1] = split_tf32(ws[(k + c + 4) * WP + n]);
      }
      Tf32Pair af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const T* p = xs + (wm + mt * 16 + g) * XP + k + c;
        if constexpr (kF32) {
          af[mt][0] = split_tf32(p[0]);
          af[mt][1] = split_tf32(p[8 * XP]);
          af[mt][2] = split_tf32(p[4]);
          af[mt][3] = split_tf32(p[8 * XP + 4]);
        } else {
          af[mt][0] = {bf16_tf32(p[0]), 0u};
          af[mt][1] = {bf16_tf32(p[8 * XP]), 0u};
          af[mt][2] = {bf16_tf32(p[4]), 0u};
          af[mt][3] = {bf16_tf32(p[8 * XP + 4]), 0u};
        }
      }
#pragma unroll
      for (int pass = kFirstPass; pass < 3; ++pass)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_pass(&acc[(mt * NT + nt) * 4], af[mt], bf[nt], pass);
    }
    promote(tot, acc);
  }
  cp_async_wait<0>();

  // epilogue: accumulator (mt, nt, i) is row wm + mt*16 + g + 8*(i >= 2),
  // unit wn + nt*8 + 2c + (i & 1)
  float lp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int j = n0 + wn + nt * 8 + 2 * c;
    if (j >= Hd) continue;
    const bool two = j + 1 < Hd;
    const float bj0 = b1[j], qj0 = w2[j];
    const float bj1 = two ? b1[j + 1] : 0.f, qj1 = two ? w2[j + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float* f = &tot[(mt * NT + nt) * 4 + 2 * hr];
        lp[mt][hr] = fmaf(tanhf(f[0] + bj0), qj0, lp[mt][hr]);
        if (two) lp[mt][hr] = fmaf(tanhf(f[1] + bj1), qj1, lp[mt][hr]);
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
  if (tid < kM && row0 + tid < R) {
    part[(size_t)h * R + row0 + tid] = ((red[0][tid] + red[1][tid]) + red[2][tid]) + red[3][tid];
  }
}

// out[row, c0 + ..) for one row and `cols` columns (blockIdx.y picks them).
// kLong only names A2's instance apart from A's in a profile: the two run
// the same operations on every column.
template <typename T, bool kLong>
__global__ void __launch_bounds__(kPoolThreads)
    pool_rows_kernel(const T* __restrict__ x, const float* __restrict__ part, int nh,
                     const float* __restrict__ mask, T* __restrict__ out, int R, int L, int D,
                     int cols) {
  extern __shared__ __align__(16) float psm[];
  float* alpha = psm;                          // (L) logits, then softmax weights
  float* sums = psm + ((size_t)L + 3) / 4 * 4;  // (kParts, cols) token partial sums
  __shared__ float stat;
  const int row = blockIdx.x, c0 = blockIdx.y * cols;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t base = (size_t)row * L;

  // logits: the partials in tile order, then the mask bias
  int valid = mask == nullptr;
  for (int t = tid; t < L; t += blockDim.x) {
    float lg = 0.f;
    for (int hh = 0; hh < nh; ++hh) lg += part[(size_t)hh * R + base + t];
    if (mask != nullptr) {
      const bool keep = mask[base + t] > 0.f;
      valid |= keep;
      if (!keep) lg += kNegInf;
    }
    alpha[t] = lg;
  }
  valid = __syncthreads_or(valid);
  // the true softmax; max and sum in warp 0, lane-strided then by shuffles,
  // whatever the block's size
  if (tid < 32) {
    float m = -INFINITY;
    for (int t = lane; t < L; t += 32) m = fmaxf(m, alpha[t]);
    m = warp_max(m);
    if (lane == 0) stat = m;
  }
  __syncthreads();
  const float m = stat;
  for (int t = tid; t < L; t += blockDim.x) alpha[t] = expf(alpha[t] - m);
  __syncthreads();
  if (tid < 32) {
    float s = 0.f;
    for (int t = lane; t < L; t += 32) s += alpha[t];
    s = warp_sum(s);
    if (lane == 0) stat = s;
  }
  __syncthreads();
  const float s = stat;
  for (int t = tid; t < L; t += blockDim.x) alpha[t] = alpha[t] / s;
  __syncthreads();

  // pooled = alpha . x: item (column quad q, partial p) sums tokens
  // p, p + kParts, ... in order; neighbouring threads read neighbouring quads
  const int nq = cols / 4;
  for (int it = tid; it < nq * kParts; it += blockDim.x) {
    const int q = it % nq, p = it / nq;
    const int col = c0 + 4 * q;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (col < D) {
      const T* xp = x + (base + p) * D + col;
#pragma unroll 4
      for (int t = p; t < L; t += kParts) {
        float v[4];
        load4(xp, v);
        xp += (size_t)kParts * D;
        const float a = alpha[t];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = fmaf(a, v[i], acc[i]);
      }
    }
    *reinterpret_cast<float4*>(&sums[p * cols + 4 * q]) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __syncthreads();
  T* orow = out + (size_t)row * D;
  for (int cc = tid; cc < cols; cc += blockDim.x) {
    const int col = c0 + cc;
    if (col >= D) continue;
    float o = sums[cc];
#pragma unroll
    for (int p = 1; p < kParts; ++p) o += sums[p * cols + cc];
    // a fully-masked row pools to exactly 0, like the module path's
    // multiply-after-exp normalization
    orow[col] = from_f32<T>(valid ? o : 0.f);
  }
}

template <typename T, int NT>
cudaError_t launch_logits(const T* x, const float* w1, const float* b1, const float* w2, int R,
                          int D, int Hd, float* part, cudaStream_t stream) {
  constexpr size_t smem = logits_smem<T, NT>();
  cudaError_t err = allow_smem(pool_logits_kernel<T, NT>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((R + kM - 1) / kM) * ((Hd + tile_n<NT>() - 1) / tile_n<NT>());
  if (blocks > 0)
    pool_logits_kernel<T, NT><<<(unsigned)blocks, kThreads, smem, stream>>>(x, w1, b1, w2, R, D,
                                                                            Hd, part);
  return cudaGetLastError();
}

template <typename T, bool kLong>
cudaError_t launch_rows(const T* x, const float* part, int nh, const float* mask, T* out, int n,
                        int L, int D, cudaStream_t stream) {
  const int cols = pool_cols(D, kLong);
  const size_t smem = pool_smem(L, cols);
  cudaError_t err = allow_smem(pool_rows_kernel<T, kLong>, smem);
  if (err != cudaSuccess) return err;
  int threads = (cols / 4 * kParts + 31) / 32 * 32;
  threads = threads > kPoolThreads ? kPoolThreads : (threads < 32 ? 32 : threads);
  const dim3 grid(n, (D + cols - 1) / cols);
  if (n > 0 && D > 0)
    pool_rows_kernel<T, kLong><<<grid, threads, smem, stream>>>(x, part, nh, mask, out, n * L, L,
                                                                 D, cols);
  return cudaGetLastError();
}

template <typename T>
int run(const void* xv, const void* w1v, const void* b1v, const void* w2v, const void* maskv,
        void* outv, void* logits, int n, int L, int D, int Hd, bool is_long, void* stream) {
  const T* x = static_cast<const T*>(xv);
  const float* w1 = static_cast<const float*>(w1v);
  const float* b1 = static_cast<const float*>(b1v);
  const float* w2 = static_cast<const float*>(w2v);
  float* part = static_cast<float*>(logits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = n * L;
  cudaError_t err = pick_nt(Hd) == 7 ? launch_logits<T, 7>(x, w1, b1, w2, R, D, Hd, part, s)
                                     : launch_logits<T, 6>(x, w1, b1, w2, R, D, Hd, part, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* mask = static_cast<const float*>(maskv);
  T* out = static_cast<T*>(outv);
  const int nh = logit_tiles(Hd);
  err = is_long ? launch_rows<T, true>(x, part, nh, mask, out, n, L, D, s)
                : launch_rows<T, false>(x, part, nh, mask, out, n, L, D, s);
  return static_cast<int>(err);
}

size_t launch_smem(int L, int D, int Hd, bool is_long) {
  const size_t lg = pick_nt(Hd) == 7 ? logits_smem<float, 7>() : logits_smem<float, 6>();
  const size_t rows = pool_smem(L, pool_cols(D, is_long));
  return lg > rows ? lg : rows;
}

}  // namespace

extern "C" {

// The bytes a whole (L, D) row, its hidden-unit sums and its logits would
// take in shared memory as f32: the wrapper's criterion between kernel A
// (rows up to the card's per-block limit) and kernel A2 (longer rows). No
// kernel stages a whole row; the criterion is kept so that each counter
// counts the rows it always counted.
size_t additive_pool_smem_bytes(int L, int D, int Hd) {
  const int Lp = (L + 24) / 25 * 25;
  const int jblocks = (Hd + 31) / 32;
  return sizeof(float) * ((size_t)Lp * D + (size_t)jblocks * Lp + L);
}

// The largest dynamic shared memory kernel A2's two passes ask for (bytes);
// the wrapper refuses rows above the card's limit.
size_t additive_pool_long_smem_bytes(int L, int D, int Hd) { return launch_smem(L, D, Hd, true); }

// Hidden-unit tiles of the logits pass: the scratch holds this many f32
// partial logits per token row.
int additive_pool_logit_tiles(int Hd) { return logit_tiles(Hd); }

// Hidden units per tile of the logits pass (32 x NT; NT names the kernel's
// instance, pool_logits_kernel<T, NT>).
int additive_pool_hidden_tile(int Hd) { return 32 * pick_nt(Hd); }

// x (n, L, D) f32|bf16, w1 (D, Hd) f32, b1 (Hd) f32, w2 (Hd) f32,
// mask (n, L) f32 or null, out (n, D) in x's dtype; logits: scratch of
// additive_pool_logit_tiles(Hd) x n x L f32. dtype: 0 f32, 1 bf16. Kernel A:
// the logits pass, then the pool pass a block per row. Returns
// cudaGetLastError() after the launches.
int additive_pool_launch(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* mask, void* out, void* logits, int n, int L, int D, int Hd,
                         int dtype, void* stream) {
  if (dtype == 0) return run<float>(x, w1, b1, w2, mask, out, logits, n, L, D, Hd, false, stream);
  return run<__nv_bfloat16>(x, w1, b1, w2, mask, out, logits, n, L, D, Hd, false, stream);
}

// Kernel A2: the arguments of additive_pool_launch; the same logits pass,
// then the pool pass with each row's columns split over blocks.
int additive_pool_long_launch(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* mask, void* out, void* logits, int n, int L, int D,
                              int Hd, int dtype, void* stream) {
  if (dtype == 0) return run<float>(x, w1, b1, w2, mask, out, logits, n, L, D, Hd, true, stream);
  return run<__nv_bfloat16>(x, w1, b1, w2, mask, out, logits, n, L, D, Hd, true, stream);
}

}  // extern "C"
