// Kernel E: the fused user tower and scorer, backward.
//
// Replaces the Pallas kernel fedrec_tpu/ops/fused_hot_path.py:
// _hist_score_bwd_kernel (reached through _hist_score_vjp_bwd). Given the
// cotangents of kernel B's outputs, g_scores (n, C) and g_user (n, D), it
// returns dx (n, H, D), dcand (n, C, D) and the nine weight cotangents: dWq,
// dWk, dWv (D, D) and their biases, dpw1 (D, Q), dpb1 and dpw2 (Q). The mask
// gets none. As in the JAX kernel, the backward treats each softmax's
// stabilising max as a constant and runs in f32; unlike it, each softmax's
// logit cotangents are made to sum to zero over their row, as the exact
// gradient's do (autograd's path through the max does the same in the plain
// version), so that where the softmax's inputs share a large common part the
// weight gradients that cancel keep their precision. It reads the forward's
// rounded q/k/v and ctx but its unrounded attention weights, pool hidden
// e32, pool weights and user vector. The masked softmax is
// exp(v - max) * mask / (sum + 1e-8).
//
// What bounds it on an H100 (f32, n=64, H=50, D=400, 20 heads, Q=200, C=5):
// about 11.7 GFLOP of products against a few MB of traffic, so operations.
// Nearly all of it is four row products over the R = n H history rows and
// two weight sums over the same rows; the attention is 50 x 50 per head.
//
// Design: the work is split by its shape, not by history row, into launches
// on one stream (each output has one owner and one order, no atomics: same
// inputs, same bits):
//   (a) rows_gemm_kernel (user_tower.cuh), the row products on the tensor
//       cores, over all n H rows: q|k|v and e32 (the forward recomputed, as
//       kernel B forms them), dctx and dx;
//   (b) attn_head_kernel (user_tower.cuh), one block per (history row,
//       head): the forward (rounded ctx) and the backward (the softmax
//       recomputed, unrounded; dq, dk, dv) on CUDA cores. n nh blocks (1,280
//       on the train path) fill the card;
//   (c) pool_bwd_kernel, one block per history row: the pool's softmax from
//       the logits (a), the user vector, the scorer (dcand, du) and the pool
//       backward (dalpha, dlg made to sum to zero, dpre over e32, this row's
//       dpw2 share);
//   (d) the weight sums by wgrad.cuh: x^T [dQ|dK|dV] and ctx^T dpre on the
//       tensor cores (wgrad_tc), the column sums on CUDA cores (wgrad).
// Order: (a) q|k|v -> (b) forward -> (a) e32 -> (c) -> (a) dctx -> (b)
// backward -> (a) dx -> (d).
//
// Precision: user_tower.cuh's. Under bf16 x W and ctx pw1 take one TF32
// pass, dpre pw1^T and dY W^T two (the f32 cotangents split against exact
// bf16 weights).
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "user_tower.cuh"
#include "wgrad.cuh"

namespace {

using namespace fedrec;

// ------------------------------------------------------------- (c) pool
__host__ __device__ inline size_t pool_smem_floats(const Dims& d) {
  return 4 * (size_t)d.H + 2 * (size_t)d.D;
}

// One history row a block: logits (the column tiles' partials in order),
// alpha = the masked softmax (unrounded), user = round(alpha) . ctx, the
// scorer's dcand = g_scores user and du = g_user + g_scores cand, then
// dalpha = du . ctx, dlg = alpha (dalpha - alpha . dalpha) less alpha times
// its rounded sum over the row, dpre = dlg pw2
// (1 - e32^2) over e32, this row's dpw2 share dlg . e32, and alpha and du
// to scratch for the dctx epilogue.
template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
    pool_bwd_kernel(const T* __restrict__ cand, const float* __restrict__ mask,
                    const T* __restrict__ pw2, const float* __restrict__ gs,
                    const float* __restrict__ gu, const float* __restrict__ ctx,
                    const float* __restrict__ part, int ntiles, float* __restrict__ ep,
                    float* __restrict__ g_alpha, float* __restrict__ g_du,
                    float* __restrict__ dpw2_rows, T* __restrict__ dcand, int n, Dims dm) {
  extern __shared__ __align__(16) float psmem[];
  const int H = dm.H, D = dm.D, Q = dm.Q, C = dm.C;
  float* alpha = psmem;     // (H)
  float* dalpha = alpha + H;
  float* dlg = dalpha + H;
  float* mk = dlg + H;
  float* us = mk + H;       // (D) unrounded user
  float* du = us + D;       // (D)
  const int row = blockIdx.x, R = n * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t row0 = (size_t)row * H;
  const float* cr = ctx + row0 * D;
  float* er = ep + row0 * Q;

  for (int t = tid; t < H; t += blockDim.x) {
    mk[t] = mask ? mask[row0 + t] : 1.f;
    float lg = 0.f;
    for (int i = 0; i < ntiles; ++i) lg += part[(size_t)i * R + row0 + t];
    alpha[t] = lg;
  }
  __syncthreads();
  if (warp == 0) warp_softmax(alpha, mk, H, lane);
  __syncthreads();
  for (int d = tid; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < H; ++t) acc = fmaf(round_to<T>(alpha[t]), cr[(size_t)t * D + d], acc);
    us[d] = acc;
  }
  __syncthreads();
  for (int d = tid; d < D; d += blockDim.x) {
    float acc = gu[(size_t)row * D + d];
    for (int k = 0; k < C; ++k) {
      const float g = gs[(size_t)row * C + k];
      acc = fmaf(g, to_f32(cand[((size_t)row * C + k) * D + d]), acc);
      dcand[((size_t)row * C + k) * D + d] = from_f32<T>(g * us[d]);
    }
    du[d] = acc;
    g_du[(size_t)row * D + d] = acc;
  }
  __syncthreads();
  for (int t = warp; t < H; t += nwarps) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(du[d], cr[(size_t)t * D + d], acc);
    acc = warp_sum(acc);
    if (lane == 0) dalpha[t] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int t = lane; t < H; t += 32) s = fmaf(alpha[t], dalpha[t], s);
    s = warp_sum(s);
    float r = 0.f, sa = 0.f;
    for (int t = lane; t < H; t += 32) {
      dlg[t] = alpha[t] * (dalpha[t] - s);
      r += dlg[t];
      sa += alpha[t];
      g_alpha[row0 + t] = alpha[t];
    }
    // the logits' cotangents sum to zero (the softmax is shift-invariant;
    // autograd's path through the max makes it so): take their rounded sum
    // out in proportion to alpha, else it meets the pool hidden's common
    // part in dpw1, dpb1 and dpw2, whose true values cancel
    r = warp_sum(r);
    sa = warp_sum(sa);
    const float c = sa > 0.f ? r / sa : 0.f;
    for (int t = lane; t < H; t += 32) dlg[t] -= alpha[t] * c;
  }
  __syncthreads();
  for (int j = tid; j < Q; j += blockDim.x) {
    const float q = to_f32(pw2[j]);
    float acc = 0.f;
    for (int t = 0; t < H; ++t) {
      const float e = er[(size_t)t * Q + j];
      acc = fmaf(dlg[t], e, acc);
      er[(size_t)t * Q + j] = dlg[t] * q * (1.f - e * e);
    }
    dpw2_rows[(size_t)row * Q + j] = acc;
  }
}

// ---------------------------------------------------------- scratch, launch
__host__ __device__ inline size_t al4(size_t f) { return (f + 3) / 4 * 4; }

struct Scratch {
  float *qkv, *ctx, *ep, *dctx, *dqkv, *part, *alpha, *du, *dpw2_rows, *partial;
};

// Region sizes in floats, each rounded up to 4 (16-byte aligned rows for
// cp.async and float2 stores), in carve()'s order.
__host__ __device__ inline void region_floats(int n, const Dims& d, size_t (&f)[9]) {
  const size_t R = (size_t)n * d.H;
  f[0] = al4(3 * R * d.D);            // qkv: (R, 3D) rounded q|k|v
  f[1] = al4(R * d.D);                // ctx: (R, D) rounded
  f[2] = al4(R * d.Q);                // ep: (R, Q) e32, then dpre
  f[3] = al4(R * d.D);                // dctx: (R, D)
  f[4] = al4(3 * R * d.D);            // dqkv: (R, 3D)
  f[5] = al4(e32_tiles(d.Q) * R);     // part: (Q tiles, R) logit partials
  f[6] = al4(R);                      // alpha: (R)
  f[7] = al4((size_t)n * d.D);        // du: (n, D)
  f[8] = al4((size_t)n * d.Q);        // dpw2_rows: (n, Q)
}

__host__ __device__ inline Scratch carve(float* base, int n, const Dims& d) {
  size_t f[9];
  region_floats(n, d, f);
  float* r[10];
  r[0] = base;
  for (int i = 0; i < 9; ++i) r[i + 1] = r[i] + f[i];
  return Scratch{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9]};
}

__host__ inline size_t partial_floats(int n, const Dims& d) {
  const int R = n * d.H;
  const size_t sizes[5] = {wgrad_tc_scratch_floats(R, d.D, d.D), wgrad_tc_scratch_floats(R, d.D, d.Q),
                           wgrad_scratch_floats(R, 0, d.D), wgrad_scratch_floats(R, 0, d.Q),
                           wgrad_scratch_floats(n, 0, d.Q)};
  size_t m = 0;
  for (size_t s : sizes) m = s > m ? s : m;
  return m;
}

template <typename T>
int launch(const void* const* p, const float* gs, const float* gu, void* dx, void* dcand,
           float* scratch, float* const* grads, int n, Dims dm, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  constexpr bool kBf16 = !std::is_same<T, float>::value;  // ctx rounded to bf16: exact in TF32
  const int R = n * dm.H, D = dm.D, Q = dm.Q;
  const T* x = static_cast<const T*>(p[0]);
  const float* mask = static_cast<const float*>(p[2]);
  const Scratch sc = carve(scratch, n, dm);
  const BOperand wqkv{{p[3], p[5], p[7]}, D};
  const BOperand wpool{{p[9], nullptr, nullptr}, Q};
  cudaError_t err;
#define RETURN_IF(e)                                  \
  do {                                                \
    err = (e);                                        \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)
  if (n > 0) {
    Epi e{};
    e.v0 = p[4];
    e.v1 = p[6];
    e.v2 = p[8];
    e.out = sc.qkv;
    RETURN_IF((rows_gemm<T, kBf16, T, false, kQkv>(x, wqkv, R, D, 3 * D, e, stream)));

    const size_t fwd_smem = attn_smem_floats(dm, false) * sizeof(float);
    const size_t bwd_smem = attn_smem_floats(dm, true) * sizeof(float);
    RETURN_IF(allow_smem(attn_head_kernel<T, false>, fwd_smem));
    attn_head_kernel<T, false><<<n * dm.nh, kAttThreads, fwd_smem, stream>>>(sc.qkv, nullptr, mask,
                                                                            sc.ctx, dm);
    RETURN_IF(cudaGetLastError());

    e = Epi{};
    e.v0 = p[10];
    e.v1 = p[11];
    e.out = sc.ep;
    e.part = sc.part;
    RETURN_IF((rows_gemm<float, kBf16, T, false, kE32>(sc.ctx, wpool, R, D, Q, e, stream)));

    const size_t pool_smem = pool_smem_floats(dm) * sizeof(float);
    RETURN_IF(allow_smem(pool_bwd_kernel<T>, pool_smem));
    pool_bwd_kernel<T><<<n, kPoolThreads, pool_smem, stream>>>(
        static_cast<const T*>(p[1]), mask, static_cast<const T*>(p[11]), gs, gu, sc.ctx, sc.part,
        e32_tiles(Q), sc.ep, sc.alpha, sc.du, sc.dpw2_rows, static_cast<T*>(dcand), n, dm);
    RETURN_IF(cudaGetLastError());

    e = Epi{};
    e.out = sc.dctx;
    e.alpha = sc.alpha;
    e.du = sc.du;
    e.H = dm.H;
    RETURN_IF((rows_gemm<float, false, T, true, kDctx>(sc.ep, wpool, R, Q, D, e, stream)));

    RETURN_IF(allow_smem(attn_head_kernel<T, true>, bwd_smem));
    attn_head_kernel<T, true><<<n * dm.nh, kAttThreads, bwd_smem, stream>>>(sc.qkv, sc.dctx, mask,
                                                                           sc.dqkv, dm);
    RETURN_IF(cudaGetLastError());

    e = Epi{};
    e.out_t = dx;
    RETURN_IF((rows_gemm<float, false, T, true, kDx>(sc.dqkv, wqkv, R, 3 * D, D, e, stream)));
  }
  // (d) the weight sums; with n = 0 they are zeros
  const RowMap x_rows = rows_contiguous(x, D);
  for (int m = 0; m < 3; ++m) {
    const RowMap dy = rows_contiguous(sc.dqkv + (size_t)m * D, 3 * D);
    RETURN_IF(wgrad_tc<T>(x_rows, dy, R, D, D, sc.partial, grads[2 * m], stream));
    RETURN_IF(wgrad<float>(dy, dy, R, 0, D, sc.partial, nullptr, grads[2 * m + 1], stream));
  }
  const RowMap dpre = rows_contiguous(sc.ep, Q);
  RETURN_IF(wgrad_tc<float>(rows_contiguous(sc.ctx, D), dpre, R, D, Q, sc.partial, grads[6], stream));
  RETURN_IF(wgrad<float>(dpre, dpre, R, 0, Q, sc.partial, nullptr, grads[7], stream));
  const RowMap share = rows_contiguous(sc.dpw2_rows, Q);
  RETURN_IF(wgrad<float>(share, share, n, 0, Q, sc.partial, nullptr, grads[8], stream));
#undef RETURN_IF
  return 0;
}

}  // namespace

extern "C" {

// The largest dynamic shared memory one block of E asks for at these sizes
// (bytes): the row products' ring (fixed), an attention block, a pool block.
size_t fused_history_score_bwd_smem_bytes(int H, int D, int Q, int nh) {
  const Dims d = make_dims(H, D, 0, Q, nh);
  size_t m = gemm_smem<float, float, true>();
  const size_t a = attn_smem_floats(d, true) * sizeof(float);
  const size_t p = pool_smem_floats(d) * sizeof(float);
  if (a > m) m = a;
  if (p > m) m = p;
  return m;
}

size_t fused_history_score_bwd_scratch_floats(int n, int H, int D, int Q, int nh) {
  const Dims d = make_dims(H, D, 0, Q, nh);
  size_t f[9];
  region_floats(n, d, f);
  size_t total = partial_floats(n, d);
  for (size_t v : f) total += v;
  return total;
}

// x (n, H, D), cand (n, C, D) or null when C == 0, mask (n, H) f32 or null,
// the nine weights as kernel B takes them, all in the operand dtype (0 f32,
// 1 bf16); g_scores (n, C) f32 or null, g_user (n, D) f32; scratch of
// fused_history_score_bwd_scratch_floats floats. Outputs: dx (n, H, D) and
// dcand (n, C, D) in the operand dtype, and f32 dwq, dbq, dwk, dbk, dwv, dbv,
// dpw1, dpb1, dpw2. D and Q divide by 4. Returns the first launch error.
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
