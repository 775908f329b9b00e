// SynergAI Eq. 2-4 scoring kernels for Hopper (sm_90a): v1 and fused v2.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/scheduler_score.py:_score_kernel    (scheduler_score, v1)
//   repro/kernels/scheduler_score.py:_score_v2_kernel (scheduler_score_v2)
// and computes their function, not their block structure.
//
// Design.  One warp per job row, eight rows per 256-thread block; the 32
// lanes stride the worker axis W, so each warp reads and writes its row in
// 128-byte coalesced runs.  Rows are independent: no state carries between
// blocks, so the Pallas row padding (bj) goes away and the ragged last block
// is masked by `row < J`.  Each lane keeps running (value, index) minima
// and any-flags over its cells, and one xor-shuffle butterfly per quantity
// finishes the row; lane 0 writes the per-row outputs.
//
// Bound.  Bytes, not operations: a cell costs one division or a few
// multiplies and compares.  v1 reads qps, pre (8 B/cell) and writes est f32
// and acc i8 (5 B/cell); v2 reads t, pre, dec (12 B/cell) and writes t_eff
// f32 and acc i8 (5 B/cell); the per-row vectors are O(J).  The least time
// is those bytes over the card's HBM rate.  Each input is read once and each
// output written once, with no scratch in device memory.
//
// Bit parity with the reference (f32, jnp semantics):
//  * every rounding step is an IEEE round-to-nearest intrinsic
//    (__fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn), which the compiler never
//    contracts into an FMA or replaces by an approximate division; the build
//    also passes --fmad=false and no --use_fast_math;
//  * v2's TPOT estimate is (dec * pen) / dtok, left to right as in JAX;
//    dec = inf with dtok = inf gives NaN, and NaN compares false, so such a
//    cell fails the TPOT gate exactly as it does in JAX;
//  * argmin follows jnp.argmin: NaN sorts first, ties go to the lowest
//    index; min and minimum propagate NaN like jnp.min / jnp.minimum;
//  * v1 writes est = BIG (3e38) on infeasible cells and keeps them in the
//    row minimum, so an all-infeasible row gets urg = rem - 3e38 and
//    best = -1, as the reference does.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

// (av, ai) comes before (bv, bi) in jnp.argmin's order.
__device__ __forceinline__ bool argmin_before(float av, int ai, float bv,
                                              int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an || bn) return an && (!bn || ai < bi);
  return av < bv || (av == bv && ai < bi);
}

// jnp.minimum: NaN propagates.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (argmin_before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_nan_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
score_v1_kernel(const float* __restrict__ qps, const float* __restrict__ pre,
                const float* __restrict__ queries,
                const float* __restrict__ t_rem, float* __restrict__ est,
                int32_t* __restrict__ best, float* __restrict__ urg,
                int8_t* __restrict__ acc, int J, int W) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= J) return;  // uniform across the warp
  const float q = queries[row];
  const float rem = t_rem[row];
  const size_t base = static_cast<size_t>(row) * W;

  bool any_acc = false, any_feas = false;
  float min_v = CUDART_INF_F;   // argmin over est
  int min_i = 0x7fffffff;
  float pick_v = CUDART_INF_F;  // argmin over est masked to acceptable cells
  int pick_i = 0x7fffffff;
  for (int w = lane; w < W; w += 32) {
    const float s = qps[base + w];
    const bool f = s > 0.0f;
    const float e = f ? __fadd_rn(pre[base + w], __fdiv_rn(q, s)) : kBig;
    const bool a = f && rem >= e;
    est[base + w] = e;
    acc[base + w] = static_cast<int8_t>(a);
    any_acc |= a;
    any_feas |= f;
    if (argmin_before(e, w, min_v, min_i)) {
      min_v = e;
      min_i = w;
    }
    const float m = a ? e : kBig;
    if (argmin_before(m, w, pick_v, pick_i)) {
      pick_v = m;
      pick_i = w;
    }
  }
  any_acc = __any_sync(kFull, any_acc);
  any_feas = __any_sync(kFull, any_feas);
  warp_argmin(min_v, min_i);
  warp_argmin(pick_v, pick_i);
  if (lane == 0) {
    best[row] = any_feas ? (any_acc ? pick_i : min_i) : -1;
    urg[row] = __fsub_rn(rem, min_v);
  }
}

__global__ void __launch_bounds__(kThreads)
score_v2_kernel(const float* __restrict__ t_solo,
                const float* __restrict__ prefill,
                const float* __restrict__ decode,
                const float* __restrict__ t_rem, const float* __restrict__ pen,
                const int32_t* __restrict__ phase,
                const int32_t* __restrict__ has_ttft,
                const int32_t* __restrict__ has_tpot,
                const float* __restrict__ ttft_rem,
                const float* __restrict__ tpot_qos,
                const float* __restrict__ dtok, float* __restrict__ t_eff,
                int8_t* __restrict__ acc, float* __restrict__ urg,
                int8_t* __restrict__ doom, int J, int W) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= J) return;  // uniform across the warp
  const float rem = t_rem[row];
  const int ph = phase[row];
  const bool ttft_gate = has_ttft[row] != 0 && ph != 2;
  const bool tpot_gate = has_tpot[row] != 0 && ph != 1;
  const float tr = ttft_rem[row];
  const float tq = tpot_qos[row];
  const float dt = dtok[row];
  const size_t base = static_cast<size_t>(row) * W;

  bool any_acc = false;
  float min_t = CUDART_INF_F;    // min over the solo estimate
  float min_pre = CUDART_INF_F;  // min over the penalized prefill prefix
  for (int w = lane; w < W; w += 32) {
    const float p = pen[w];
    const float t = t_solo[base + w];
    const float pr = prefill[base + w];
    const float dc = decode[base + w];
    const float te = __fmul_rn(ph == 1 ? pr : (ph == 2 ? dc : t), p);
    const float ttft_est = __fmul_rn(pr, p);
    const float tpot_est = __fdiv_rn(__fmul_rn(dc, p), dt);
    const bool a = rem >= te && (!ttft_gate || ttft_est <= tr) &&
                   (!tpot_gate || tpot_est <= tq);
    t_eff[base + w] = te;
    acc[base + w] = static_cast<int8_t>(a);
    any_acc |= a;
    min_t = nan_min(min_t, t);
    min_pre = nan_min(min_pre, ttft_est);
  }
  any_acc = __any_sync(kFull, any_acc);
  min_t = warp_nan_min(min_t);
  min_pre = warp_nan_min(min_pre);
  if (lane == 0) {
    float u = __fsub_rn(rem, min_t);
    if (has_ttft[row] != 0 && ph != 2) u = nan_min(u, __fsub_rn(tr, min_pre));
    urg[row] = u;
    doom[row] = static_cast<int8_t>(!any_acc);
  }
}

inline unsigned blocks_for(int J) {
  return static_cast<unsigned>((J + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors; `stream` is the caller's CUDA stream.  Each function
// launches asynchronously and returns cudaGetLastError() (0 on success).

extern "C" int synergai_score_v1(const float* qps, const float* pre,
                                 const float* queries, const float* t_rem,
                                 float* est, int32_t* best, float* urg,
                                 int8_t* acc, int J, int W,
                                 cudaStream_t stream) {
  if (J <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  score_v1_kernel<<<blocks_for(J), kThreads, 0, stream>>>(
      qps, pre, queries, t_rem, est, best, urg, acc, J, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int synergai_score_v2(
    const float* t_solo, const float* prefill, const float* decode,
    const float* t_rem, const float* pen, const int32_t* phase,
    const int32_t* has_ttft, const int32_t* has_tpot, const float* ttft_rem,
    const float* tpot_qos, const float* dtok, float* t_eff, int8_t* acc,
    float* urg, int8_t* doom, int J, int W, cudaStream_t stream) {
  if (J <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  score_v2_kernel<<<blocks_for(J), kThreads, 0, stream>>>(
      t_solo, prefill, decode, t_rem, pen, phase, has_ttft, has_tpot,
      ttft_rem, tpot_qos, dtok, t_eff, acc, urg, doom, J, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* synergai_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
