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
// every kernel is bound by operations, hundreds per byte.
//
// F1: an FA2-style forward on the tensor cores (mma.sync, mma.cuh). A block
// of 4 warps owns a query tile, each warp one or two m-tiles of 16 query
// rows (two for f32 at width 20, where the registers allow: each K and V
// fragment a warp loads and splits then serves 32 rows); K, V and the key
// bias stream through shared memory in 64-key tiles (a cp.async double
// buffer). Per tile a warp forms S = Q K^T (f32: m16n8k8 TF32 with K's
// width padded to 8, 24 at d = 20; bf16: m16n8k16 with it padded to 16),
// runs the online softmax on the accumulator fragments (a row's max and sum
// over its quad by shuffles), and forms P V on the tensor cores: the S
// fragment is already P's operand fragment (bf16: m16n8k16's A layout; f32:
// with the 8 keys of a step permuted, key 2c and 2c+1 as columns c and
// c+4, and V read in that order). Each tile's P V sums in a fresh
// accumulator and is added to the f32 output after the rescale.
// Precision: f32 operands take three TF32 passes (lo hi, hi lo, hi hi: about
// 2^-21 relative per product), P split like any other operand; bf16 ones
// one bf16 mma with f32 sums, P rounded to bf16 as the JAX kernel's
// p.astype(v.dtype). tests/test_torch_tc_precision.py holds the emulation
// against float64.
//
// F2 and F3: FA2's backward on the tensor cores in two kernels, F2 the dq
// half with queries as the m-dimension and F3 the dk/dv half with keys as
// the m-dimension (described at the kernels); both TF32 m16n8k8 at every
// width (three passes for f32, one for bf16 values, exact in TF32), with
// F1's fragment forms and pass order, so in f32 the scores they rebuild are
// F1's to the bit.
// Each output has one owner that sums in a fixed order: no atomics, so the
// results repeat to the bit.
//
// Numerics follow the JAX kernels: the running max starts at -1e9 (not
// -inf) and the sum is floored at 1e-30, so a fully-masked row attends
// uniformly, as there (the wrapper then zeroes it); l sums the unrounded p;
// p is rounded to the operand dtype before P.V (F1) and before dv (F3), ds
// before dq (F2) and dk (F3); dbias sums the unrounded f32 ds. JAX pads
// keys to its block with bias -1e9; here the keys past the end of the last
// tile get bias -inf and the queries past it lse +inf in F2 and F3 (p = 0
// exactly).
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace fedrec;

constexpr int BQ = 64;            // query rows of an F2 block and of an F3 query tile
constexpr int BK = 64;            // key rows of an F3 block and of an F1/F2 key tile
constexpr int kF1Warps = 4;       // F1: warps a block
constexpr int kF1Threads = 32 * kF1Warps;
constexpr float kNegInit = -1e9f; // JAX's running-max start (and the mask bias)

// ------------------------------------------------------------------- F1
// Shared-memory row pitches (elements) that keep the fragment loads free of
// bank conflicts: Q and K rows (Q K^T's operands), V rows (P V's B operand).
template <typename T>
__host__ __device__ constexpr int f1_kpitch(int dk) {
  return std::is_same<T, float>::value ? dk + 4 : dk + 8;
}

__host__ __device__ constexpr int f1_vpitch(int dv) { return dv + 4; }

// m-tiles of 16 query rows a warp: two where the registers allow, so that
// each K and V fragment a warp loads and splits serves 32 rows
template <typename T, int DK>
__host__ __device__ constexpr int f1_mtiles() {
  return std::is_same<T, float>::value && DK <= 24 ? 2 : 1;
}

template <typename T, int DK>
__host__ __device__ constexpr int f1_rows() {  // F1's query tile
  return kF1Warps * 16 * f1_mtiles<T, DK>();
}

// Q tile, two stages of K and V tiles (T), two stages of key bias (f32).
template <typename T, int DK, int DV>
__host__ __device__ constexpr size_t f1_smem() {
  return sizeof(T) * ((size_t)f1_rows<T, DK>() * f1_kpitch<T>(DK) +
                      2 * (size_t)BK * (f1_kpitch<T>(DK) + f1_vpitch(DV))) +
         2 * BK * sizeof(float);
}

// Rows [0, rows) x columns [0, d) of a row-major (., d) block into a
// (ROWS, W) shared tile of row pitch `pitch`, zeros elsewhere: cp.async
// where rows are whole 4-element groups (vec), else plain loads and stores.
template <typename T, int ROWS, int W>
__device__ __forceinline__ void f1_stage(T* dst, int pitch, const T* __restrict__ src, int rows,
                                         int d, bool vec) {
  if (vec) {
    constexpr int Q4 = W / 4;
    for (int i = threadIdx.x; i < ROWS * Q4; i += blockDim.x) {
      const int r = i / Q4, c4 = (i - r * Q4) * 4;
      const bool ok = r < rows && c4 < d;
      cp_async4(dst + r * pitch + c4, ok ? src + (size_t)r * d + c4 : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * W; i += blockDim.x) {
      const int r = i / W, cc = i - r * W;
      dst[r * pitch + cc] = (r < rows && cc < d) ? src[(size_t)r * d + cc] : from_f32<T>(0.f);
    }
  }
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A-operand fragment of rows row, row + 8 at depth k of a shared tile:
// m16n8k8 TF32 (k = step * 8 + c, split hi/lo) or m16n8k16 bf16 (k = step *
// 16 + 2c).
__device__ __forceinline__ void a_frag(const float* t, int pitch, int row, int k, Tf32Pair* a) {
  const float* p = t + row * pitch + k;
  a[0] = split_tf32(p[0]);
  a[1] = split_tf32(p[8 * pitch]);
  a[2] = split_tf32(p[4]);
  a[3] = split_tf32(p[8 * pitch + 4]);
}

__device__ __forceinline__ void a_frag(const __nv_bfloat16* t, int pitch, int row, int k,
                                       uint32_t* a) {
  const __nv_bfloat16* p = t + row * pitch + k;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * pitch);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * pitch + 8);
}

// B-operand fragment of K^T: key n of a (key, dim) shared tile at depth k
// (the same k as a_frag's).
__device__ __forceinline__ void b_frag(const float* t, int pitch, int n, int k, Tf32Pair* b) {
  b[0] = split_tf32(t[n * pitch + k]);
  b[1] = split_tf32(t[n * pitch + k + 4]);
}

__device__ __forceinline__ void b_frag(const __nv_bfloat16* t, int pitch, int n, int k,
                                       uint32_t* b) {
  b[0] = ld_u32(t + n * pitch + k);
  b[1] = ld_u32(t + n * pitch + k + 8);
}

// One (bh, query tile) a block, MT m-tiles of 16 query rows a warp. DK:
// the width of Q K^T padded to the mma depth (8 f32, 16 bf16); DV: the
// output width padded to 8. Thread (g, c) of a warp holds rows g and g + 8
// of each m-tile: S fragment (nt, i) is key nt*8 + 2c + (i & 1) of row
// g + 8*(i >= 2), and output fragment (nv, i) column nv*8 + 2c + (i & 1) of
// the same rows.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kF1Threads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse,
                 int Lq, int Lk, int dk, int dv, float scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int KP = f1_kpitch<T>(DK), VP = f1_vpitch(DV);
  constexpr int MT = f1_mtiles<T, DK>(), ROWS = f1_rows<T, DK>();
  constexpr int KSTEP = kF32 ? 8 : 16;
  constexpr int KS = DK / KSTEP;          // mma steps of Q K^T
  constexpr int NV = DV / 8;              // output n-tiles
  constexpr int kChunk = 32 / KSTEP;      // steps per promoted 32-deep chunk
  constexpr bool kQReg = !kF32 || KS <= 4;  // Q's fragments held in registers
  constexpr bool kPromote = KS > kChunk || !kQReg;  // S past one chunk: sc, promoted
  using Frag = std::conditional_t<kF32, Tf32Pair, uint32_t>;
  extern __shared__ __align__(16) unsigned char f1_smem_raw[];
  T* qs = reinterpret_cast<T*>(f1_smem_raw);
  float* bias_s = reinterpret_cast<float*>(qs + ROWS * KP + 2 * BK * (KP + VP));
  auto kt = [&](int st) { return qs + ROWS * KP + st * BK * (KP + VP); };
  auto vt = [&](int st) { return qs + ROWS * KP + st * BK * (KP + VP) + BK * KP; };

  const int nqt = (Lq + ROWS - 1) / ROWS;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3, wq = warp * 16 * MT;
  const int kc = kF32 ? c : 2 * c;  // a thread's depth offset in a fragment
  const T* kb = k + (size_t)bh * Lk * dk;
  const T* vb = v + (size_t)bh * Lk * dv;
  const float* bb = bias + (size_t)bh * Lk;
  const bool vec = (dk & 3) == 0 && (dv & 3) == 0;
  const int tiles = (Lk + BK - 1) / BK;

  auto stage_kv = [&](int st, int t) {
    const int k0 = t * BK, nk = min(BK, Lk - k0);
    f1_stage<T, BK, DK>(kt(st), KP, kb + (size_t)k0 * dk, nk, dk, vec);
    f1_stage<T, BK, DV>(vt(st), VP, vb + (size_t)k0 * dv, nk, dv, vec);
    float* bs = bias_s + st * BK;
    for (int i = tid; i < BK; i += kF1Threads) {
      if (i < nk) {
        cp_async1(bs + i, bb + k0 + i, true);
      } else {
        bs[i] = -INFINITY;  // past the last key: p = 0 exactly
      }
    }
  };

  f1_stage<T, ROWS, DK>(qs, KP, q + ((size_t)bh * Lq + q0) * dk, min(ROWS, Lq - q0), dk, vec);
  if (tiles > 0) stage_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  Frag qf[kQReg ? MT : 1][kQReg ? KS : 1][4];
  if constexpr (kQReg) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) a_frag(qs, KP, wq + mt * 16 + g, ks * KSTEP + kc, qf[mt][ks]);
  }

  float m[MT][2], l[MT][2], o[MT][NV][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInit;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) o[mt][nv][0] = o[mt][nv][1] = o[mt][nv][2] = o[mt][nv][3] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    if (t > 0) {
      cp_async_wait<0>();  // tile t landed
      __syncthreads();     // and every warp is done with tile t - 1
    }
    if (t + 1 < tiles) stage_kv((t + 1) & 1, t + 1);
    cp_async_commit();
    const T* ks_t = kt(t & 1);
    const T* vs_t = vt(t & 1);
    const float* bs = bias_s + (t & 1) * BK;

    // S = Q K^T over this tile's 64 keys, each K fragment serving every
    // m-tile; past 32 deep, each 32-deep chunk sums in sc and is promoted
    float s[MT][8][4], sc[kPromote ? MT : 1][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][nt][i] = 0.f;
    if constexpr (kPromote) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[0][nt][i] = 0.f;
    }
    auto qk_mma = [&](float (&acc)[8][4], const Frag* qa, const Frag (&kf)[8][2]) {
      if constexpr (kF32) {
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mma_pass(acc[nt], qa, kf[nt], pass);
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_bf16_k16(acc[nt], qa, kf[nt]);
      }
    };
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      Frag kf[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) b_frag(ks_t, KP, nt * 8 + g, ks * KSTEP + kc, kf[nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (!kPromote) {
          qk_mma(s[mt], qf[mt][ks], kf);
        } else if constexpr (kQReg) {
          qk_mma(sc[mt], qf[mt][ks], kf);
        } else {
          Frag qa[4];
          a_frag(qs, KP, wq + mt * 16 + g, ks * KSTEP + kc, qa);
          qk_mma(sc[mt], qa, kf);
        }
      }
      if constexpr (kPromote) {
        if ((ks + 1) % kChunk == 0 || ks + 1 == KS) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) promote(s[mt][nt], sc[mt][nt]);
        }
      }
    }

    // scores, then the online softmax on the fragments: a row's max and sum
    // over the quad that holds it
    float pv[MT][NV][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[mt][nt][i] = fmaf(s[mt][nt][i], scale, bs[nt * 8 + 2 * c + (i & 1)]);
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][nt][0], s[mt][nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][nt][2], s[mt][nt][3]));
      }
      float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = expf(m[mt][r] - mx[r]);
        m[mt][r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = expf(s[mt][nt][i] - mx[i >> 1]);
          ls[i >> 1] += p;               // l sums the unrounded p
          s[mt][nt][i] = round_to<T>(p); // P V takes p in the operand dtype
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
        ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
        l[mt][r] = fmaf(l[mt][r], corr[r], ls[r]);
      }
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        o[mt][nv][0] *= corr[0];
        o[mt][nv][1] *= corr[0];
        o[mt][nv][2] *= corr[1];
        o[mt][nv][3] *= corr[1];
        pv[mt][nv][0] = pv[mt][nv][1] = pv[mt][nv][2] = pv[mt][nv][3] = 0.f;
      }
    }

    // P V in a fresh accumulator, each V fragment serving every m-tile,
    // then added to the rescaled output
    if constexpr (kF32) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {  // 8 keys a step; key 2c, 2c+1 as columns c, c+4
        Tf32Pair pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = split_tf32(s[mt][kk][0]);
          pa[mt][1] = split_tf32(s[mt][kk][2]);
          pa[mt][2] = split_tf32(s[mt][kk][1]);
          pa[mt][3] = split_tf32(s[mt][kk][3]);
        }
        const float* vr = vs_t + (kk * 8 + 2 * c) * VP + g;
#pragma unroll
        for (int nv0 = 0; nv0 < NV; nv0 += 4) {  // 4 n-tiles at a time: bounded registers
          Tf32Pair vf[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (nv0 + j < NV) {
              vf[j][0] = split_tf32(vr[(nv0 + j) * 8]);
              vf[j][1] = split_tf32(vr[(nv0 + j) * 8 + VP]);
            }
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (nv0 + j < NV) mma_pass(pv[mt][nv0 + j], pa[mt], vf[j], pass);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step: S n-tiles 2kk, 2kk+1 are P's fragment
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack_bf16(__float2bfloat16(s[mt][2 * kk][0]), __float2bfloat16(s[mt][2 * kk][1]));
          pa[mt][1] = pack_bf16(__float2bfloat16(s[mt][2 * kk][2]), __float2bfloat16(s[mt][2 * kk][3]));
          pa[mt][2] =
              pack_bf16(__float2bfloat16(s[mt][2 * kk + 1][0]), __float2bfloat16(s[mt][2 * kk + 1][1]));
          pa[mt][3] =
              pack_bf16(__float2bfloat16(s[mt][2 * kk + 1][2]), __float2bfloat16(s[mt][2 * kk + 1][3]));
        }
        const T* vr = vs_t + (kk * 16 + 2 * c) * VP + g;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv) {
          const T* p = vr + nv * 8;
          const uint32_t vf[2] = {pack_bf16(p[0], p[VP]), pack_bf16(p[8 * VP], p[9 * VP])};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16_k16(pv[mt][nv], pa[mt], vf);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[mt][nv][i] += pv[mt][nv][i];
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wq + mt * 16 + g + 8 * r;
      if (row >= Lq) continue;
      const float lsafe = fmaxf(l[mt][r], 1e-30f);
      T* orow = out + ((size_t)bh * Lq + row) * dv;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nv * 8 + 2 * c + e;
          if (col < dv) orow[col] = from_f32<T>(o[mt][nv][2 * r + e] / lsafe);
        }
      }
      if (c == 0) lse[(size_t)bh * Lq + row] = m[mt][r] + logf(lsafe);
    }
  }
}

// ------------------------------------------------------------------- F3
// FA2's dk/dv half on the tensor cores, keys as the m-dimension so that F1's
// fragment forms carry over. A block of 4 warps owns a 64-key tile, each
// warp one m-tile of 16 keys (its K and V fragments held in registers at
// widths <= 32); it walks 64-query tiles of Q, dO, lse and delta staged
// through a cp.async double buffer. Per query tile a warp forms
//   S^T  = K Q^T                         (16 keys x 64 queries, depth dk)
//   P^T  = exp(scale S^T + bias - lse)   on the accumulator fragment
//   dV  += P^T dO                        (P^T's fragment is the A operand
//                                          with F1's query permutation)
//   dP^T = V dO^T                        (depth dv)
//   dS^T = P^T (dP^T - delta);  dbias += sum over the queries of dS^T
//   dK  += dS^T Q
// and at the end dK *= scale. The operands are TF32 (m16n8k8) at every
// width: f32 values split into hi and lo (three passes: lo hi, hi lo, hi hi;
// P^T and dS^T split like any operand), bf16 values exact (one pass, the
// exact products a bf16 mma forms). p is rounded to the operand dtype before
// dV and ds before dK; dbias sums the unrounded f32 ds of a row over its
// quad and n-tiles in a fixed order. dV's and dK's sums take a fresh
// accumulator for every 32 queries, promoted with a round-to-nearest add;
// S^T and dP^T likewise for every 32 of depth past the first.
constexpr int kF3Warps = 4;  // one 16-key m-tile each
constexpr int kF3Threads = 32 * kF3Warps;

__host__ __device__ constexpr int f3_pitch(int w) {  // conflict-free reads by row and by column
  return w + 4;
}

// the K and V tiles, two stages of Q and dO tiles (T), two of lse and delta
template <typename T, int W>
__host__ __device__ constexpr size_t f3_smem() {
  return sizeof(T) * (size_t)f3_pitch(W) * (2 * BK + 4 * BQ) + 4 * BQ * sizeof(float);
}

// A fragment of rows row, row + 8 at depth k of a (., P) tile
template <typename T, int P>
__device__ __forceinline__ void f3_afrag(const T* t, int row, int k, Tf32Pair* a) {
  const T* p = t + row * P + k;
  a[0] = tf32_op(p[0]);
  a[1] = tf32_op(p[8 * P]);
  a[2] = tf32_op(p[4]);
  a[3] = tf32_op(p[8 * P + 4]);
}

// acc (16 rows x 64 columns) = A B^T over depth W: A's rows from registers
// (REG: af) or rows row, row + 8 of the tile at; B the 64 rows of bt. Thread
// (g, c) holds column nt*8 + 2c + (i & 1) of row g + 8*(i >= 2) in acc[nt][i].
// Past 32 deep, each 32 of depth sums in a fresh accumulator; STEP: each 8
// (F2's dP, which cancels against delta, so its truncation error counts
// relative to dS).
template <typename T, int W, bool REG, bool STEP = false>
__device__ __forceinline__ void f3_scores(float (&acc)[8][4], Tf32Pair (&af)[REG ? W / 8 : 1][4],
                                          const T* at, const T* bt, int row, int g, int c) {
  constexpr int P = f3_pitch(W), NS = W / 8;
  constexpr int kFirst = std::is_same<T, float>::value ? 0 : 2;
  constexpr int kChunk = STEP ? 1 : 4;  // steps of 8 a fresh accumulator sums
  constexpr bool kPromote = NS > kChunk;
  float ch[kPromote ? 8 : 1][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[nt][i] = 0.f;
      if constexpr (kPromote) ch[nt][i] = 0.f;
    }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    Tf32Pair a[4];
    if constexpr (REG) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = af[s][i];
    } else {
      f3_afrag<T, P>(at, row, s * 8 + c, a);
    }
    Tf32Pair b[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const T* p = bt + (nt * 8 + g) * P + s * 8 + c;
      b[nt][0] = tf32_op(p[0]);
      b[nt][1] = tf32_op(p[4]);
    }
#pragma unroll
    for (int pass = kFirst; pass < 3; ++pass)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma_pass(kPromote ? ch[nt] : acc[nt], a, b[nt], pass);
    if constexpr (kPromote) {
      if ((s + 1) % kChunk == 0 || s + 1 == NS) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) promote(acc[nt], ch[nt]);
      }
    }
  }
}

// tot (16 rows x W) += round(x) B: x (16 rows x 64 queries) in acc form,
// B the (64 queries, P) tile bt. Query 2c and 2c + 1 of each 8-query step
// are A columns c and c + 4, so x's fragment is the A operand as it stands
// and B's rows are read in that order (F1's permutation). Every 32 queries
// sum in a fresh accumulator, promoted into tot.
template <typename T, int W>
__device__ __forceinline__ void f3_accumulate(float (&tot)[W / 8][4], float (&x)[8][4],
                                              const T* bt, int g, int c) {
  constexpr int P = f3_pitch(W), NS = W / 8;
  constexpr bool kBf16 = !std::is_same<T, float>::value;  // rounded x: exact in TF32
  constexpr int kFirst = kBf16 ? 2 : 0;
  float ch[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n) ch[n][0] = ch[n][1] = ch[n][2] = ch[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const Tf32Pair a[4] = {
        tf32_op<kBf16>(round_to<T>(x[kk][0])), tf32_op<kBf16>(round_to<T>(x[kk][2])),
        tf32_op<kBf16>(round_to<T>(x[kk][1])), tf32_op<kBf16>(round_to<T>(x[kk][3]))};
    const T* br = bt + (kk * 8 + 2 * c) * P + g;
#pragma unroll
    for (int n0 = 0; n0 < NS; n0 += 4) {  // 4 n-tiles at a time: bounded registers
      Tf32Pair b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j < NS) {
          b[j][0] = tf32_op(br[(n0 + j) * 8]);
          b[j][1] = tf32_op(br[(n0 + j) * 8 + P]);
        }
      }
#pragma unroll
      for (int pass = kFirst; pass < 3; ++pass)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + j < NS) mma_pass(ch[n0 + j], a, b[j], pass);
    }
    if (kk % 4 == 3) {
#pragma unroll
      for (int n = 0; n < NS; ++n) promote(tot[n], ch[n]);
    }
  }
}

// One (bh, 64-key tile) a block; W: the padded width of both dk and dv.
template <typename T, int W>
__global__ void __launch_bounds__(kF3Threads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk_out, T* __restrict__ dv_out, float* __restrict__ dbias,
                     int Lq, int Lk, int dk, int dv, float scale) {
  constexpr int P = f3_pitch(W), NS = W / 8;
  constexpr bool kReg = W <= 32;  // K and V fragments held in registers
  extern __shared__ __align__(16) unsigned char f3_smem_raw[];
  T* ks = reinterpret_cast<T*>(f3_smem_raw);  // (BK, P)
  T* vs = ks + BK * P;                         // (BK, P)
  auto qt = [&](int st) { return vs + BK * P + st * 2 * BQ * P; };
  auto gt = [&](int st) { return vs + BK * P + st * 2 * BQ * P + BQ * P; };
  float* stats = reinterpret_cast<float*>(vs + BK * P + 4 * BQ * P);  // [stage][lse | delta]

  const int nkt = (Lk + BK - 1) / BK;
  const int bh = blockIdx.x / nkt, k0 = (blockIdx.x - bh * nkt) * BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3, wk = warp * 16;
  const T* qb = q + (size_t)bh * Lq * dk;
  const T* gb = dout + (size_t)bh * Lq * dv;
  const float* lb = lse + (size_t)bh * Lq;
  const float* eb = delta + (size_t)bh * Lq;
  const bool vec = (dk & 3) == 0 && (dv & 3) == 0;
  const int tiles = (Lq + BQ - 1) / BQ;

  auto stage_q = [&](int st, int t) {
    const int q0 = t * BQ, nq = min(BQ, Lq - q0);
    f1_stage<T, BQ, W>(qt(st), P, qb + (size_t)q0 * dk, nq, dk, vec);
    f1_stage<T, BQ, W>(gt(st), P, gb + (size_t)q0 * dv, nq, dv, vec);
    float* ls = stats + st * 2 * BQ;
    for (int i = tid; i < BQ; i += kF3Threads) {
      if (i < nq) {
        cp_async1(ls + i, lb + q0 + i, true);
        cp_async1(ls + BQ + i, eb + q0 + i, true);
      } else {  // past the last query: p = 0 exactly
        ls[i] = INFINITY;
        ls[BQ + i] = 0.f;
      }
    }
  };

  const int nk = min(BK, Lk - k0);
  f1_stage<T, BK, W>(ks, P, k + ((size_t)bh * Lk + k0) * dk, nk, dk, vec);
  f1_stage<T, BK, W>(vs, P, v + ((size_t)bh * Lk + k0) * dv, nk, dv, vec);
  if (tiles > 0) stage_q(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this thread's keys wk + g and wk + g + 8: their bias, -inf past the end
  float kb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wk + g + 8 * r;
    kb[r] = key < Lk ? bias[(size_t)bh * Lk + key] : -INFINITY;
  }
  Tf32Pair kf[kReg ? NS : 1][4], vf[kReg ? NS : 1][4];
  if constexpr (kReg) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      f3_afrag<T, P>(ks, wk + g, s * 8 + c, kf[s]);
      f3_afrag<T, P>(vs, wk + g, s * 8 + c, vf[s]);
    }
  }

  float dka[NS][4], dva[NS][4], dbr[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t > 0) {
      cp_async_wait<0>();  // tile t landed
      __syncthreads();     // and every warp is done with tile t - 1
    }
    if (t + 1 < tiles) stage_q((t + 1) & 1, t + 1);
    cp_async_commit();
    const T* qs = qt(t & 1);
    const T* gs = gt(t & 1);
    const float* ls = stats + (t & 1) * 2 * BQ;
    const float* es = ls + BQ;

    float p[8][4], ds[8][4];
    f3_scores<T, W, kReg>(p, kf, ks, qs, wk + g, g, c);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[nt][i] = expf(fmaf(p[nt][i], scale, kb[i >> 1]) - ls[nt * 8 + 2 * c + (i & 1)]);
    f3_accumulate<T, W>(dva, p, gs, g, c);

    f3_scores<T, W, kReg>(ds, vf, vs, gs, wk + g, g, c);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ds[nt][i] = p[nt][i] * (ds[nt][i] - es[nt * 8 + 2 * c + (i & 1)]);
        part[i >> 1] += ds[nt][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
      part[r] += __shfl_xor_sync(0xffffffffu, part[r], 2);
      dbr[r] += part[r];
    }
    f3_accumulate<T, W>(dka, ds, qs, g, c);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wk + g + 8 * r;
    if (key >= Lk) continue;
    const size_t row = (size_t)bh * Lk + key;
    T* ko = dk_out + row * dk;
    T* vo = dv_out + row * dv;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * c + e;
        if (col < dk) ko[col] = from_f32<T>(dka[n][2 * r + e] * scale);
        if (col < dv) vo[col] = from_f32<T>(dva[n][2 * r + e]);
      }
    }
    if (c == 0) dbias[row] = dbr[r];
  }
}

// ------------------------------------------------------------------- F2
// FA2's dq half on the tensor cores: the mirror of F3, with queries as the
// m-dimension as in F1. A block of 4 warps owns a 64-query tile, each warp
// one m-tile of 16 queries (its Q and dO fragments, split, held in
// registers in bf16 at widths <= 32, else re-read from shared memory at
// each key tile; its rows' lse and delta in registers); K, V and the key
// bias stream through shared memory in 64-key tiles (F1's cp.async double
// buffer, bias -inf past the last key). Per key tile a warp forms
//   S  = Q K^T                           (16 queries x 64 keys, depth dk)
//   P  = exp(scale S + bias - lse)       on the accumulator fragment
//   dP = dO V^T                          (depth dv)
//   dS = P (dP - delta)
//   dQ += round(dS) K                    (dS's fragment is the A operand with
//                                          F1's key permutation, K's rows
//                                          read in that order)
// with F3's helpers, and at the end dQ *= scale. dP sums each 8 of its
// depth in a fresh accumulator (it cancels against delta, so its error
// counts against dS, not dP); S sums as F1's does. K is read by rows (S's B
// operand) and by columns (dQ's): f3_pitch keeps both conflict-free. One
// m-tile a warp, not F1's two: S, dP and the Q and dO fragments of a second
// would not fit in the registers. Queries past the end get lse +inf (p = 0
// exactly) and are neither read past the arrays nor stored.
constexpr int kF2Warps = 4;  // one 16-query m-tile each
constexpr int kF2Threads = 32 * kF2Warps;

// the Q and dO tiles, two stages of K and V tiles (T) and of key bias (f32)
template <typename T, int W>
__host__ __device__ constexpr size_t f2_smem() {
  return sizeof(T) * (size_t)f3_pitch(W) * (2 * BQ + 4 * BK) + 2 * BK * sizeof(float);
}

// Which shape each fragment path serves (kernel_ab.py --only fwd, PERF.md):
// bf16 fragments (one pass, no lo half) are held in registers at widths
// <= 32, faster than re-reading them; f32's split pairs take twice the
// registers and are re-read, which at width 32 avoids spills and at the
// user tower's width lets F2 run three blocks an SM (a cap of 168
// registers for ptxas), faster than two blocks with them held.
template <typename T, int W>
__host__ __device__ constexpr bool f2_three_blocks() {
  return std::is_same<T, float>::value && W == 24;
}

// One (bh, 64-query tile) a block; W: the padded width of both dk and dv.
template <typename T, int W>
__global__ void __launch_bounds__(kF2Threads, f2_three_blocks<T, W>() ? 3 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Lq, int Lk, int dk, int dv, float scale) {
  constexpr int P = f3_pitch(W), NS = W / 8;
  constexpr bool kReg = !std::is_same<T, float>::value && W <= 32;  // Q, dO fragments held
  extern __shared__ __align__(16) unsigned char f2_smem_raw[];
  T* qs = reinterpret_cast<T*>(f2_smem_raw);  // (BQ, P)
  T* gs = qs + BQ * P;                         // (BQ, P)
  auto kt = [&](int st) { return gs + BQ * P + st * 2 * BK * P; };
  auto vt = [&](int st) { return gs + BQ * P + st * 2 * BK * P + BK * P; };
  float* bias_s = reinterpret_cast<float*>(gs + BQ * P + 4 * BK * P);  // [stage][BK]

  const int nqt = (Lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt, q0 = (blockIdx.x - bh * nqt) * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3, wq = warp * 16;
  const T* kb = k + (size_t)bh * Lk * dk;
  const T* vb = v + (size_t)bh * Lk * dv;
  const float* bb = bias + (size_t)bh * Lk;
  const bool vec = (dk & 3) == 0 && (dv & 3) == 0;
  const int tiles = (Lk + BK - 1) / BK;

  auto stage_kv = [&](int st, int t) {
    const int k0 = t * BK, nk = min(BK, Lk - k0);
    f1_stage<T, BK, W>(kt(st), P, kb + (size_t)k0 * dk, nk, dk, vec);
    f1_stage<T, BK, W>(vt(st), P, vb + (size_t)k0 * dv, nk, dv, vec);
    float* bs = bias_s + st * BK;
    for (int i = tid; i < BK; i += kF2Threads) {
      if (i < nk) {
        cp_async1(bs + i, bb + k0 + i, true);
      } else {
        bs[i] = -INFINITY;  // past the last key: p = 0 exactly
      }
    }
  };

  const int nq = min(BQ, Lq - q0);
  f1_stage<T, BQ, W>(qs, P, q + ((size_t)bh * Lq + q0) * dk, nq, dk, vec);
  f1_stage<T, BQ, W>(gs, P, dout + ((size_t)bh * Lq + q0) * dv, nq, dv, vec);
  if (tiles > 0) stage_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this thread's queries q0 + wq + g and + 8: lse +inf past the end
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wq + g + 8 * r;
    lr[r] = row < Lq ? lse[(size_t)bh * Lq + row] : INFINITY;
    dr[r] = row < Lq ? delta[(size_t)bh * Lq + row] : 0.f;
  }
  Tf32Pair qf[kReg ? NS : 1][4], gf[kReg ? NS : 1][4];
  if constexpr (kReg) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      f3_afrag<T, P>(qs, wq + g, s * 8 + c, qf[s]);
      f3_afrag<T, P>(gs, wq + g, s * 8 + c, gf[s]);
    }
  }

  float dqa[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t > 0) {
      cp_async_wait<0>();  // tile t landed
      __syncthreads();     // and every warp is done with tile t - 1
    }
    if (t + 1 < tiles) stage_kv((t + 1) & 1, t + 1);
    cp_async_commit();
    const T* ks_t = kt(t & 1);
    const T* vs_t = vt(t & 1);
    const float* bs = bias_s + (t & 1) * BK;

    float p[8][4], ds[8][4];
    f3_scores<T, W, kReg>(p, qf, qs, ks_t, wq + g, g, c);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[nt][i] = expf(fmaf(p[nt][i], scale, bs[nt * 8 + 2 * c + (i & 1)]) - lr[i >> 1]);
    f3_scores<T, W, kReg, true>(ds, gf, gs, vs_t, wq + g, g, c);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[nt][i] = p[nt][i] * (ds[nt][i] - dr[i >> 1]);
    f3_accumulate<T, W>(dqa, ds, ks_t, g, c);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wq + g + 8 * r;
    if (row >= Lq) continue;
    T* qo = dq + ((size_t)bh * Lq + row) * dk;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * c + e;
        if (col < dk) qo[col] = from_f32<T>(dqa[n][2 * r + e] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------- launch
// F1's padded widths (f32 form): the user tower's 20 exactly (24, the next
// multiple of the TF32 mma depth; bf16 pads the contraction to 32), else
// the next of 32 / 64 / 128 for both.
int f1_width(int dk, int dv) {
  if (dk == 20 && dv == 20) return 24;
  const int d = dk > dv ? dk : dv;
  return d <= 32 ? 32 : (d <= 64 ? 64 : 128);
}

// F1 stages Q once and double-buffers K, V and bias tiles; F2 stages Q and
// dO once and double-buffers K, V and bias tiles; F3 holds its K and V tiles
// and double-buffers Q, dO, lse and delta (the f32 forms are the larger)
template <int W>
size_t smem_at(int which) {
  return which == 0 ? f1_smem<float, W, W>() : which == 1 ? f2_smem<float, W>() : f3_smem<float, W>();
}

size_t smem_rows(int which, int dk, int dv) {
  switch (f1_width(dk, dv)) {
    case 24: return smem_at<24>(which);
    case 32: return smem_at<32>(which);
    case 64: return smem_at<64>(which);
    default: return smem_at<128>(which);
  }
}

struct Args {
  const void *q, *k, *v, *bias, *dout, *lse, *delta;
  void *o0, *o1, *o2;  // F1: out, lse; F2: dq; F3: dk, dv, dbias
  int bh, lq, lk, dk, dv;
  float scale;
};

template <typename T, int DK, int DV>
int launch_f1(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = f1_smem<T, DK, DV>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DK, DV>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows = f1_rows<T, DK>();
  const int grid = a.bh * ((a.lq + rows - 1) / rows);
  if (grid > 0)
    flash_fwd_kernel<T, DK, DV><<<grid, kF1Threads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.bias), static_cast<T*>(a.o0), static_cast<float*>(a.o1), a.lq,
        a.lk, a.dk, a.dv, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_f1(const Args& a, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  switch (f1_width(a.dk, a.dv)) {
    case 24: return launch_f1<T, kF32 ? 24 : 32, 24>(a, stream);
    case 32: return launch_f1<T, 32, 32>(a, stream);
    case 64: return launch_f1<T, 64, 64>(a, stream);
    default: return launch_f1<T, 128, 128>(a, stream);
  }
}

template <typename T, int W>
int launch_f2(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = f2_smem<T, W>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, W>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.bh * ((a.lq + BQ - 1) / BQ);
  if (grid > 0)
    flash_bwd_dq_kernel<T, W><<<grid, kF2Threads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.bias), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.o0), a.lq, a.lk, a.dk, a.dv, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// F2's widths are F1's: 24 for the user tower's 20, else 32 / 64 / 128
template <typename T>
int dispatch_f2(const Args& a, cudaStream_t stream) {
  switch (f1_width(a.dk, a.dv)) {
    case 24: return launch_f2<T, 24>(a, stream);
    case 32: return launch_f2<T, 32>(a, stream);
    case 64: return launch_f2<T, 64>(a, stream);
    default: return launch_f2<T, 128>(a, stream);
  }
}

template <typename T, int W>
int launch_f3(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = f3_smem<T, W>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, W>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.bh * ((a.lk + BK - 1) / BK);
  if (grid > 0)
    flash_bwd_dkv_kernel<T, W><<<grid, kF3Threads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.bias), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.o0), static_cast<T*>(a.o1), static_cast<float*>(a.o2), a.lq, a.lk,
        a.dk, a.dv, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// F3's widths are F1's: 24 for the user tower's 20, else 32 / 64 / 128
template <typename T>
int dispatch_f3(const Args& a, cudaStream_t stream) {
  switch (f1_width(a.dk, a.dv)) {
    case 24: return launch_f3<T, 24>(a, stream);
    case 32: return launch_f3<T, 32>(a, stream);
    case 64: return launch_f3<T, 64>(a, stream);
    default: return launch_f3<T, 128>(a, stream);
  }
}

int run(int which, const Args& a, int dtype, void* stream) {
  if (a.dk < 1 || a.dv < 1 || a.dk > 128 || a.dv > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = dtype == 0;
  if (which == 0) return f32 ? dispatch_f1<float>(a, s) : dispatch_f1<__nv_bfloat16>(a, s);
  if (which == 1) return f32 ? dispatch_f2<float>(a, s) : dispatch_f2<__nv_bfloat16>(a, s);
  return f32 ? dispatch_f3<float>(a, s) : dispatch_f3<__nv_bfloat16>(a, s);
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
