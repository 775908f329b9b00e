// SynergAI's device-resident tick for Hopper (sm_90a): the fused
// gather + score kernel and the greedy placement walk.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/scheduler_score.py:_tick_kernel   (scheduler_tick)
// together with the XLA work around it in scheduler_tick: the row gather by
// slot before the pallas_call, the energy term and the admission/padding
// masks after it, and the fori_loop greedy walk.  The lexsort between the
// two kernels stays in PyTorch (it is XLA's in the reference too).
//
// tick_score_kernel.  One warp per job row, eight rows per 256-thread block,
// as score_v2_kernel in scheduler_score.cu.  Each warp reads its row's slot
// (slot -1 is padding, clipped to row 0 as jnp.clip does) and walks the
// gathered pool rows twice: the first pass reduces acceptability, the two
// urgency minima and the best doomed cost (min over feasible t_eff + wait);
// the second recomputes t_eff and writes ranked = where(elig, cost, inf).
// The second pass reads rows the first pass has just brought into L1/L2.
//
// greedy_place_kernel.  One block walks the urgency order, as the
// reference's fori_loop does.  The open mask lives in shared memory and
// n_open in a shared word; per job the block runs one (value, index) argmin
// over the job's ranked row masked by the open mask (one warp butterfly,
// then one across warps), and thread 0 places the job if the winner is
// finite.  The walk stops once n_open is 0 or at the first padded row in
// the order (padding sorts last and never places), which gives the same
// assign as walking every row.
//
// Bound.  Bytes.  The score kernel must read the gathered t, pre, dec rows
// (12 B/cell, 16 B with energy) and write ranked (4 B/cell), plus O(J + W)
// vectors and the [K, W] admission masks.  The walk must read one ranked row
// per step it takes; it is latency bound in practice: each step is a
// dependent load of order[i], then of the row, then two block barriers.
//
// Bit parity with the reference (f32, jnp semantics), as in
// scheduler_score.cu: every rounding step is an IEEE round-to-nearest
// intrinsic and the build passes --fmad=false, so 1.5f * best and
// cost + ene * escale each round as two separate operations; argmin orders
// NaN first and breaks ties at the lowest index; min propagates NaN.  A NaN
// in a row wins the argmin and places nothing, as jnp.argmin makes it do.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kMaxWalkThreads = 1024;
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
tick_score_kernel(const float* __restrict__ pool_t,
                  const float* __restrict__ pool_pre,
                  const float* __restrict__ pool_dec,
                  const float* __restrict__ pool_ene,
                  const int32_t* __restrict__ slots,
                  const float* __restrict__ t_rem,
                  const float* __restrict__ ttft_rem,
                  const float* __restrict__ tpot_qos,
                  const float* __restrict__ dtok,
                  const int32_t* __restrict__ has_ttft,
                  const int32_t* __restrict__ has_tpot,
                  const int32_t* __restrict__ phase,
                  const int32_t* __restrict__ ekey,
                  const uint8_t* __restrict__ emask,
                  const float* __restrict__ pen,
                  const float* __restrict__ busy_wait,
                  const float* __restrict__ escale,
                  float* __restrict__ ranked, float* __restrict__ urg,
                  int8_t* __restrict__ doom, int Jp, int cap, int Wp, int K,
                  int use_energy) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= Jp) return;  // uniform across the warp
  const int slot = slots[row];
  const bool jvalid = slot >= 0;
  const int src = min(max(slot, 0), cap - 1);
  const float rem = t_rem[row];
  const int ph = phase[row];
  const bool ttft_gate = has_ttft[row] != 0 && ph != 2;
  const bool tpot_gate = has_tpot[row] != 0 && ph != 1;
  const float tr = ttft_rem[row];
  const float tq = tpot_qos[row];
  const float dt = dtok[row];
  const int key = min(max(ekey[row], 0), K - 1);
  const size_t in_base = static_cast<size_t>(src) * Wp;
  const float* t = pool_t + in_base;
  const float* pre = pool_pre + in_base;
  const float* dec = pool_dec + in_base;
  const uint8_t* em = emask + static_cast<size_t>(key) * Wp;

  // pass 1: the v2 row reductions and the best doomed completion cost
  bool any_acc = false;
  float min_t = CUDART_INF_F;    // min over the solo estimate
  float min_pre = CUDART_INF_F;  // min over the penalized prefill prefix
  float best = CUDART_INF_F;     // min over feasible t_eff + busy wait
  for (int w = lane; w < Wp; w += 32) {
    const float p = pen[w];
    const float tv = t[w];
    const float pr = pre[w];
    const float dc = dec[w];
    const float te = __fmul_rn(ph == 1 ? pr : (ph == 2 ? dc : tv), p);
    const float ttft_est = __fmul_rn(pr, p);
    const float tpot_est = __fdiv_rn(__fmul_rn(dc, p), dt);
    any_acc |= rem >= te && (!ttft_gate || ttft_est <= tr) &&
               (!tpot_gate || tpot_est <= tq);
    min_t = nan_min(min_t, tv);
    min_pre = nan_min(min_pre, ttft_est);
    best = nan_min(best, isfinite(te) ? __fadd_rn(te, busy_wait[w])
                                      : CUDART_INF_F);
  }
  any_acc = __any_sync(kFull, any_acc);
  min_t = warp_nan_min(min_t);
  min_pre = warp_nan_min(min_pre);
  best = warp_nan_min(best);
  const bool doomed = !any_acc;
  const float limit = __fmul_rn(1.5f, best);

  // pass 2: ranking cost, eligibility, energy term, masks
  const size_t out_base = static_cast<size_t>(row) * Wp;
  const float* ene = pool_ene + in_base;
  for (int w = lane; w < Wp; w += 32) {
    const float p = pen[w];
    const float pr = pre[w];
    const float dc = dec[w];
    const float te = __fmul_rn(ph == 1 ? pr : (ph == 2 ? dc : t[w]), p);
    float cost;
    bool elig;
    if (doomed) {
      cost = __fadd_rn(te, busy_wait[w]);
      elig = isfinite(te) && te <= limit;
    } else {
      cost = te;
      elig = rem >= te && (!ttft_gate || __fmul_rn(pr, p) <= tr) &&
             (!tpot_gate || __fdiv_rn(__fmul_rn(dc, p), dt) <= tq);
    }
    if (use_energy) cost = __fadd_rn(cost, __fmul_rn(ene[w], escale[w]));
    elig = elig && em[w] != 0 && jvalid;
    ranked[out_base + w] = elig ? cost : CUDART_INF_F;
  }
  if (lane == 0) {
    float u = __fsub_rn(rem, min_t);
    if (ttft_gate) u = nan_min(u, __fsub_rn(tr, min_pre));
    urg[row] = u;
    doom[row] = static_cast<int8_t>(doomed);
  }
}

__global__ void __launch_bounds__(kMaxWalkThreads)
greedy_place_kernel(const float* __restrict__ ranked,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ slots,
                    const uint8_t* __restrict__ open0,
                    int32_t* __restrict__ assign, int Jp, int Wp) {
  extern __shared__ uint8_t open_slot[];  // [Wp]
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_open;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  int count = 0;
  for (int w = tid; w < Wp; w += blockDim.x) {
    const uint8_t o = open0[w] != 0;
    open_slot[w] = o;
    count += o;
  }
  for (int j = tid; j < Jp; j += blockDim.x) assign[j] = -1;
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_xor_sync(kFull, count, off);
  if (lane == 0) red_i[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < n_warps; ++k) n += red_i[k];
    s_open = n;
  }
  __syncthreads();

  for (int i = 0; i < Jp; ++i) {
    const int n_open = s_open;
    const int ji = order[i];
    if (n_open == 0 || slots[ji] < 0) break;  // uniform across the block
    const float* row = ranked + static_cast<size_t>(ji) * Wp;
    float v = CUDART_INF_F;
    int idx = 0x7fffffff;
    for (int w = tid; w < Wp; w += blockDim.x) {
      const float c = open_slot[w] ? row[w] : CUDART_INF_F;
      if (argmin_before(c, w, v, idx)) {
        v = c;
        idx = w;
      }
    }
    warp_argmin(v, idx);
    if (lane == 0) {
      red_v[warp] = v;
      red_i[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < n_warps ? red_v[lane] : CUDART_INF_F;
      idx = lane < n_warps ? red_i[lane] : 0x7fffffff;
      warp_argmin(v, idx);
      if (lane == 0 && isfinite(v)) {
        assign[ji] = idx;
        open_slot[idx] = 0;
        s_open = n_open - 1;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors; `stream` is the caller's CUDA stream.  Each function
// launches asynchronously and returns cudaGetLastError() (0 on success).

extern "C" int synergai_tick_score(
    const float* pool_t, const float* pool_pre, const float* pool_dec,
    const float* pool_ene, const int32_t* slots, const float* t_rem,
    const float* ttft_rem, const float* tpot_qos, const float* dtok,
    const int32_t* has_ttft, const int32_t* has_tpot, const int32_t* phase,
    const int32_t* ekey, const uint8_t* emask, const float* pen,
    const float* busy_wait, const float* escale, float* ranked, float* urg,
    int8_t* doom, int Jp, int cap, int Wp, int K, int use_energy,
    cudaStream_t stream) {
  if (Jp <= 0 || cap <= 0 || Wp <= 0 || K <= 0 || (use_energy && !pool_ene))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((Jp + kRowsPerBlock - 1) / kRowsPerBlock);
  tick_score_kernel<<<blocks, kThreads, 0, stream>>>(
      pool_t, pool_pre, pool_dec, use_energy ? pool_ene : pool_t, slots,
      t_rem, ttft_rem, tpot_qos, dtok, has_ttft, has_tpot, phase, ekey,
      emask, pen, busy_wait, escale, ranked, urg, doom, Jp, cap, Wp, K,
      use_energy);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int synergai_greedy_place(const float* ranked,
                                     const int32_t* order,
                                     const int32_t* slots,
                                     const uint8_t* open0, int32_t* assign,
                                     int Jp, int Wp, cudaStream_t stream) {
  if (Jp <= 0 || Wp <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(Wp);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        greedy_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int lanes = (Wp + 31) / 32 * 32;
  const int threads = lanes < kMaxWalkThreads ? lanes : kMaxWalkThreads;
  greedy_place_kernel<<<1, threads, smem, stream>>>(ranked, order, slots,
                                                    open0, assign, Jp, Wp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* synergai_tick_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
