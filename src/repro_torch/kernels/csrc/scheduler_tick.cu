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
// greedy_place_kernel.  One warp walks the urgency order, as the
// reference's fori_loop does.  Walker thread x of T owns workers x + T b and
// keeps their open bits in registers (two 32-bit words; above 64 workers a
// walker, in words of a global scratch that it alone reads and writes);
// n_open is a register.  Nothing the walk reads depends on the walk but the open bits,
// so 8 loader warps stage the next chunk of 32 steps (each step's job,
// whether it is padding, and up to 512 workers its ranked row as order keys)
// into shared memory while the walkers walk the current chunk; the block
// meets once a chunk.  A walker that loaded a row itself would wait on it:
// loads issued steps ahead, into registers or a cp.async ring, were measured
// to cost as much as a load in the step.  A step is a scan of the walker's
// open workers, two redux.sync minima over the warp (the order key, then the
// least index holding it) and a bit clear, the same on every lane.  The key
// maps a float to an unsigned integer in jnp.argmin's order: NaN first,
// -0.0 equal to 0.0.  T is 32 up to 256 workers (8 a walker) and 64 up to
// 512; wider rows are read from global memory in the step by 4 workers a
// walker (the loaders prefetch them into L2), up to 512 walkers, then more
// workers a walker: any width.  Above one warp each step
// exchanges the warps' minima through shared memory (double-buffered by
// step parity) at one named barrier.  The walk stops once n_open is 0 or at
// the first padded row in the order (padding sorts last and never places),
// which gives the same assign as walking every row.
//
// Bound.  Bytes.  The score kernel must read the gathered t, pre, dec rows
// (12 B/cell, 16 B with energy) and write ranked (4 B/cell), plus O(J + W)
// vectors and the [K, W] admission masks.  The walk must read one ranked row
// per step it takes.  It is latency bound: a serial walk's floor is steps x
// one warp reduction (two redux.sync, ~0.1 us with the step's other work).
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
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWalkers = 512;
constexpr int kRegisterBits = 64;  // open bits a walker keeps in registers
constexpr int kLoaders = 256;      // threads that stage the next chunk
constexpr int kChunk = 32;         // steps a chunk
constexpr int kBatch = 8;          // loads a loader keeps in flight
constexpr int kStagedWorkers = 512;  // rows staged up to this width
constexpr int kStagedPerWalker = 8;  // workers a walker, rows staged
constexpr int kDirectPerWalker = 4;  // workers a walker, rows read directly
constexpr int kStageBytes =          // two chunks of rows and a row of walkers
    4 * (2 * kChunk * kStagedWorkers + kMaxWalkers);

// jnp.minimum: NaN propagates.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
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

// jnp.argmin's order as unsigned keys: NaN first (0), then -inf ... +inf,
// -0.0 equal to 0.0; a lane with no open worker offers kNoWorker.
constexpr uint32_t kNoWorker = 0xffffffffu;
constexpr uint32_t kNegInfKey = 0x007fffffu;  // order_key(-inf)
constexpr uint32_t kPosInfKey = 0xff800000u;  // order_key(+inf)
__device__ __forceinline__ uint32_t order_key(float v) {
  if (isnan(v)) return 0u;
  const uint32_t bits = __float_as_uint(v == 0.f ? 0.f : v);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// Walker threads [0, T) walk; loader threads [T, blockDim.x) stage the
// order, validity and (if `staged`) the ranked rows as order keys of the
// next chunk of steps into shared memory meanwhile.  Without `staged` the
// walkers read the rows from global memory in the step.  With `open_ext`
// (more than kRegisterBits workers a walker, never staged) walker x keeps
// its open bits in open_ext[word * T + x] instead of open_lo and open_hi.
__global__ void __launch_bounds__(kMaxWalkers + kLoaders)
greedy_place_kernel(const float* __restrict__ ranked,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ slots,
                    const uint8_t* __restrict__ open0,
                    int32_t* __restrict__ assign,
                    uint32_t* __restrict__ open_ext, int Jp, int Wp, int T,
                    int staged) {
  extern __shared__ uint32_t stage[];  // [2][kChunk][Wp] order keys, + T
  __shared__ int s_ord[2][kChunk];
  __shared__ int s_ok[2][kChunk];
  __shared__ uint32_t red_k[2][32];
  __shared__ uint32_t red_i[2][32];
  __shared__ int red_n[32];
  __shared__ int s_stop;
  const int tid = threadIdx.x;
  const bool walker = tid < T;
  const int log_t = __ffs(T) - 1;        // T: 32 times a power of 2
  const int lane = tid & 31, warp = tid >> 5, n_warps = T >> 5;
  const int nb = (Wp + T - 1) >> log_t;  // workers a walker: tid + T b

  // chunk c's order, validity and rows into buffer c & 1 (loaders)
  auto stage_chunk = [&](int c) {
    const int s0 = c * kChunk, buf = c & 1, lt = tid - T;
    const int L = blockDim.x - T;
    if (s0 >= Jp) return;
    const int n = min(kChunk, Jp - s0);
    if (lt < n) {
      const int ji = order[s0 + lt];
      s_ord[buf][lt] = ji;
      s_ok[buf][lt] = slots[ji] >= 0;
    }
    if (!staged) {  // the walkers read the rows: bring them into L2
      const int lines = (Wp + 31) / 32;  // 128-byte lines a row
      for (int e = lt; e < n * lines; e += L) {
        const int r = e / lines;
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            ranked + static_cast<size_t>(order[s0 + r]) * Wp +
            32 * (e - r * lines)));
      }
      return;
    }
    asm volatile("bar.sync 2, %0;\n" ::"r"(L));  // s_ord among the loaders
    uint32_t* dst = stage + static_cast<size_t>(buf) * kChunk * Wp;
    for (int e0 = lt; e0 < n * Wp; e0 += L * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int x = 0; x < kBatch; ++x) {
        const int e = e0 + x * L;
        if (e < n * Wp) {
          const int r = e / Wp;
          v[x] = ranked[static_cast<size_t>(s_ord[buf][r]) * Wp + (e - r * Wp)];
        }
      }
#pragma unroll
      for (int x = 0; x < kBatch; ++x)
        if (e0 + x * L < n * Wp) dst[e0 + x * L] = order_key(v[x]);
    }
  };

  for (int j = tid; j < Jp; j += blockDim.x) assign[j] = -1;
  if (tid == 0) s_stop = 0;
  // open bits (walkers): b < 32 in lo, the rest in hi, or all in open_ext
  uint32_t open_lo = 0, open_hi = 0;
  int n_open = 0;
  if (walker) {
    if (open_ext)
      for (int q = 0; q < (nb + 31) >> 5; ++q) open_ext[q * T + tid] = 0;
    for (int b = 0; b < nb; ++b) {
      const int w = tid + T * b;
      if (w < Wp && open0[w] != 0) {
        if (open_ext)
          open_ext[(b >> 5) * T + tid] |= 1u << (b & 31);
        else if (b < 32)
          open_lo |= 1u << b;
        else
          open_hi |= 1u << (b - 32);
        ++n_open;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      n_open += __shfl_xor_sync(kFull, n_open, off);
    if (lane == 0) red_n[warp] = n_open;
  } else {
    stage_chunk(0);
  }
  __syncthreads();  // assign is -1, chunk 0 staged, the counts are in
  if (walker) {
    n_open = 0;
    for (int x = 0; x < n_warps; ++x) n_open += red_n[x];
  }

  for (int c = 0; s_stop == 0 && c * kChunk < Jp; ++c) {  // uniform
    if (!walker) {
      stage_chunk(c + 1);
    } else {
      const int s0 = c * kChunk, buf = c & 1, n = min(kChunk, Jp - s0);
      const uint32_t* keys0 =
          stage + static_cast<size_t>(buf) * kChunk * Wp + tid;
      int ji_next = s_ord[buf][0], ok_next = s_ok[buf][0];
      for (int k = 0; k < n; ++k) {
        const int ji = ji_next, ok = ok_next;
        // this thread's least key over its open workers, the lowest index
        // on ties (staged keys are read whether open or not: the buffer is
        // padded by a row of walkers)
        uint32_t key = kNoWorker, b_min = 0;
        if (staged) {
          const uint32_t* keys = keys0 + k * Wp;
#pragma unroll 4
          for (int b = 0; b < nb; ++b) {
            const uint32_t closed =  // 0 if open, all ones if closed
                (((b < 32 ? open_lo : open_hi) >> (b & 31)) & 1u) - 1u;
            const uint32_t kb = keys[b * T] | closed;
            if (kb < key) {
              key = kb;
              b_min = b;
            }
          }
        } else {
          // the index clamped into the row, so that every load is issued
          // at once (a worker past Wp is closed)
          const float* row = ranked + static_cast<size_t>(ji) * Wp;
#pragma unroll 4
          for (int b = 0; b < nb; ++b) {
            const uint32_t word = open_ext ? open_ext[(b >> 5) * T + tid]
                                           : (b < 32 ? open_lo : open_hi);
            const uint32_t closed = ((word >> (b & 31)) & 1u) - 1u;
            const uint32_t kb =
                order_key(row[min(tid + T * b, Wp - 1)]) | closed;
            if (kb < key) {
              key = kb;
              b_min = b;
            }
          }
        }
        uint32_t idx = key == kNoWorker ? kNoWorker : tid + T * b_min;
        if (k + 1 < n) {
          ji_next = s_ord[buf][k + 1];
          ok_next = s_ok[buf][k + 1];
        }
        if (n_open == 0 || !ok) {  // uniform among walkers
          if (tid == 0) s_stop = 1;
          break;
        }
        uint32_t k_min = __reduce_min_sync(kFull, key);
        uint32_t i_min =
            __reduce_min_sync(kFull, key == k_min ? idx : kNoWorker);
        if (n_warps > 1) {  // the same across walker warps, one barrier
          if (lane == 0) {
            red_k[k & 1][warp] = k_min;
            red_i[k & 1][warp] = i_min;
          }
          asm volatile("bar.sync 1, %0;\n" ::"r"(T));
          key = lane < n_warps ? red_k[k & 1][lane] : kNoWorker;
          idx = lane < n_warps ? red_i[k & 1][lane] : kNoWorker;
          k_min = __reduce_min_sync(kFull, key);
          i_min = __reduce_min_sync(kFull, key == k_min ? idx : kNoWorker);
        }
        if (k_min > kNegInfKey && k_min < kPosInfKey) {  // finite: place
          if (tid == 0) assign[ji] = static_cast<int32_t>(i_min);
          if ((i_min & (T - 1)) == static_cast<uint32_t>(tid)) {
            const int b = static_cast<int>(i_min >> log_t);
            if (open_ext)
              open_ext[(b >> 5) * T + tid] &= ~(1u << (b & 31));
            else if (b < 32)
              open_lo &= ~(1u << b);
            else
              open_hi &= ~(1u << (b - 32));
          }
          --n_open;
        }
      }
    }
    __syncthreads();  // chunk c + 1 staged; the walk's stop is seen
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

// Any width: above 512 walkers of 64 workers (32,768) the open bits go to a
// scratch allocated and freed on `stream`.
extern "C" int synergai_greedy_place(const float* ranked,
                                     const int32_t* order,
                                     const int32_t* slots,
                                     const uint8_t* open0, int32_t* assign,
                                     int Jp, int Wp, cudaStream_t stream) {
  if (Jp <= 0 || Wp <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = Wp <= kStagedWorkers;
  const int per = staged ? kStagedPerWalker : kDirectPerWalker;
  int T = 32;  // walkers, a power of 2: lane and word by mask and shift
  while (T * per < Wp && T < kMaxWalkers) T *= 2;
  const size_t smem =
      staged ? sizeof(uint32_t) * (2 * kChunk * static_cast<size_t>(Wp) + T)
             : 0;
  static bool configured = false;  // opt in to > 48 KB of shared memory once
  if (!configured) {
    const cudaError_t rc = cudaFuncSetAttribute(
        greedy_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    configured = true;
  }
  const int nb = (Wp + T - 1) / T;  // workers a walker
  uint32_t* open_ext = nullptr;
  if (nb > kRegisterBits) {
    const size_t words = static_cast<size_t>(T) * ((nb + 31) / 32);
    const cudaError_t rc = cudaMallocAsync(
        reinterpret_cast<void**>(&open_ext), words * sizeof(uint32_t), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  greedy_place_kernel<<<1, T + kLoaders, smem, stream>>>(
      ranked, order, slots, open0, assign, open_ext, Jp, Wp, T, staged);
  const cudaError_t rc = cudaGetLastError();
  if (open_ext) cudaFreeAsync(open_ext, stream);
  return static_cast<int>(rc);
}

extern "C" const char* synergai_tick_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
