// Kernel B: the fused user tower and scorer, forward.
//
// Replaces the Pallas kernel fedrec_tpu/ops/fused_hot_path.py:_hist_score_fwd_kernel
// with its core _hist_forward_core (reached through _hist_score_forward,
// fused_history_score and fused_user_vector). For each history row
// (H=50 clicked-news vectors of D=400): Q/K/V projections, 20-head masked
// self-attention (divide by sqrt(dh), max over every slot, mask after exp,
// +1e-8), additive pooling to the user vector, and optional dot scores
// against C candidates.
//
// Bound on an H100: about 60 MFLOP per row, nearly all of it the row
// products x [Wq|Wk|Wv] and ctx pw1, against about 2.2 MB of weights (f32)
// read once and 80 KB of history per row: bound by bytes at n = 1 and by
// operations from n = 8 up, the train path's n = 64 included.
//
// Design: kernel E's forward half (user_tower.cuh), split by shape into four
// launches on one stream instead of one block per history row:
//   1. rows_gemm_kernel (kQkv): [q|k|v] = round(x [Wq|Wk|Wv] + b) over all
//      R = n H rows on the tensor cores, into scratch;
//   2. attn_head_kernel<T, false>: one block per (row, head), the rounded
//      attention weights and ctx into scratch;
//   3. rows_gemm_kernel (kE32): e = tanh(ctx pw1 + pb1) on the tensor cores;
//      only its epilogue's pool-logit partials, sum_j round(e_j) pw2_j per
//      128-column tile, are stored;
//   4. pool_fwd_kernel: one block per row, the pool's masked softmax from the
//      partials (added in tile order), the user vector and the scores.
// Each output has one owner and one order (no atomics): same inputs, same
// bits. Values are rounded through the operand dtype at exactly the JAX
// kernel's points (q/k/v, attention weights, ctx, e, pool weights, user,
// scores), so bf16 matches the JAX kernel, not the dense module. The fc2
// bias is not an input.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "user_tower.cuh"

namespace {

using namespace fedrec;

__host__ __device__ inline size_t pool_fwd_smem_floats(const Dims& d) {
  return 2 * (size_t)d.H + d.D;
}

// One history row a block: the logits (the column tiles' partials in
// order), alpha = round(the masked softmax), user = round(alpha . ctx), and
// scores = round(cand . user), one warp per candidate.
template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
    pool_fwd_kernel(const T* __restrict__ cand, const float* __restrict__ mask,
                    const float* __restrict__ ctx, const float* __restrict__ part, int ntiles,
                    T* __restrict__ scores, T* __restrict__ user, int n, Dims dm) {
  extern __shared__ __align__(16) float fsmem[];
  const int H = dm.H, D = dm.D, C = dm.C;
  float* alpha = fsmem;  // (H)
  float* mk = alpha + H; // (H)
  float* us = mk + H;    // (D) rounded user
  const int row = blockIdx.x, R = n * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t row0 = (size_t)row * H;
  const float* cr = ctx + row0 * D;

  for (int t = tid; t < H; t += blockDim.x) {
    mk[t] = mask ? mask[row0 + t] : 1.f;
    float lg = 0.f;
    for (int i = 0; i < ntiles; ++i) lg += part[(size_t)i * R + row0 + t];
    alpha[t] = lg;
  }
  __syncthreads();
  if (warp == 0) {
    warp_softmax(alpha, mk, H, lane);
    __syncwarp();
    for (int t = lane; t < H; t += 32) alpha[t] = round_to<T>(alpha[t]);
  }
  __syncthreads();
  for (int d = tid; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < H; ++t) acc = fmaf(alpha[t], cr[(size_t)t * D + d], acc);
    const float u = round_to<T>(acc);
    us[d] = u;
    user[(size_t)row * D + d] = from_f32<T>(u);
  }
  __syncthreads();
  for (int k = warp; k < C; k += nwarps) {
    const T* cv = cand + ((size_t)row * C + k) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(cv[d]), us[d], acc);
    acc = warp_sum(acc);
    if (lane == 0) scores[(size_t)row * C + k] = from_f32<T>(acc);
  }
}

// Scratch regions in floats, each rounded up to 4 (16-byte aligned rows for
// cp.async and float2 stores): qkv (R, 3D), ctx (R, D), logit partials
// (Q tiles, R).
__host__ __device__ inline size_t al4(size_t f) { return (f + 3) / 4 * 4; }

__host__ inline void fwd_regions(int n, const Dims& d, size_t (&f)[3]) {
  const size_t R = (size_t)n * d.H;
  f[0] = al4(3 * R * d.D);
  f[1] = al4(R * d.D);
  f[2] = al4(e32_tiles(d.Q) * R);
}

template <typename T>
int launch(const void* const* p, void* scores, void* user, float* scratch, int n, Dims dm,
           void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  constexpr bool kBf16 = !std::is_same<T, float>::value;  // x, W, ctx exact in TF32
  const int R = n * dm.H, D = dm.D, Q = dm.Q;
  const float* mask = static_cast<const float*>(p[2]);
  size_t f[3];
  fwd_regions(n, dm, f);
  float* qkv = scratch;
  float* ctx = qkv + f[0];
  float* part = ctx + f[1];
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
#define RETURN_IF(e)                                      \
  do {                                                    \
    err = (e);                                            \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)
  Epi e{};
  e.v0 = p[4];
  e.v1 = p[6];
  e.v2 = p[8];
  e.out = qkv;
  RETURN_IF((rows_gemm<T, kBf16, T, false, kQkv>(static_cast<const T*>(p[0]),
                                                 BOperand{{p[3], p[5], p[7]}, D}, R, D, 3 * D, e,
                                                 stream)));

  const size_t attn_smem = attn_smem_floats(dm, false) * sizeof(float);
  RETURN_IF(allow_smem(attn_head_kernel<T, false>, attn_smem));
  attn_head_kernel<T, false><<<n * dm.nh, kAttThreads, attn_smem, stream>>>(qkv, nullptr, mask,
                                                                           ctx, dm);
  RETURN_IF(cudaGetLastError());

  e = Epi{};
  e.v0 = p[10];
  e.v1 = p[11];
  e.part = part;  // e itself is not stored
  RETURN_IF((rows_gemm<float, kBf16, T, false, kE32>(ctx, BOperand{{p[9], nullptr, nullptr}, Q},
                                                     R, D, Q, e, stream)));

  const size_t pool_smem = pool_fwd_smem_floats(dm) * sizeof(float);
  RETURN_IF(allow_smem(pool_fwd_kernel<T>, pool_smem));
  pool_fwd_kernel<T><<<n, kPoolThreads, pool_smem, stream>>>(
      static_cast<const T*>(p[1]), mask, ctx, part, e32_tiles(Q), static_cast<T*>(scores),
      static_cast<T*>(user), n, dm);
#undef RETURN_IF
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest dynamic shared memory one of B's blocks asks for at these
// sizes (bytes): the row products' ring (fixed), an attention block, a pool
// block.
size_t fused_history_score_smem_bytes(int H, int D, int Q, int nh) {
  const Dims d = make_dims(H, D, 0, Q, nh);
  size_t m = gemm_smem<float, float, false>();
  const size_t a = attn_smem_floats(d, false) * sizeof(float);
  const size_t p = pool_fwd_smem_floats(d) * sizeof(float);
  if (a > m) m = a;
  if (p > m) m = p;
  return m;
}

// Floats of the scratch fused_history_score_launch takes: q|k|v and ctx of
// every history row, and the pool's logit partials.
size_t fused_history_score_scratch_floats(int n, int H, int D, int Q, int nh) {
  size_t f[3];
  fwd_regions(n, make_dims(H, D, 0, Q, nh), f);
  return f[0] + f[1] + f[2];
}

// x (n, H, D), cand (n, C, D) or null when C == 0, mask (n, H) f32 or null,
// wq/wk/wv (D, D), bq/bk/bv (D), pw1 (D, Q), pb1 (Q), pw2 (Q), all in the
// operand dtype (0 f32, 1 bf16); scores (n, C) or null, user (n, D) in the
// operand dtype; scratch of fused_history_score_scratch_floats floats. D
// and Q divide by 4, and x and the weight matrices start on a 4-element
// boundary (cp.async). Returns the first launch error.
int fused_history_score_launch(const void* x, const void* cand, const void* mask,
                               const void* wq, const void* bq, const void* wk,
                               const void* bk, const void* wv, const void* bv,
                               const void* pw1, const void* pb1, const void* pw2,
                               void* scores, void* user, void* scratch, int n, int H, int D,
                               int C, int Q, int nh, int dtype, void* stream) {
  const void* p[12] = {x, cand, mask, wq, bq, wk, bk, wv, bv, pw1, pb1, pw2};
  const Dims dm = make_dims(H, D, C, Q, nh);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) return launch<float>(p, scores, user, sc, n, dm, stream);
  return launch<__nv_bfloat16>(p, scores, user, sc, n, dm, stream);
}

}  // extern "C"
