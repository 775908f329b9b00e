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
// tick_score_kernel.  One warp per job row.  The warp reads its row's slot
// (slot -1 is padding, clipped to row 0 as jnp.clip does), gathers the
// slot's t, pre, dec (and ene) rows once, reduces acceptability, the two
// urgency minima and the best doomed cost (min over feasible t_eff + wait)
// in a first pass, and writes ranked = where(elig, cost, inf) in a second
// pass from each worker's t_eff and acceptance, kept from the first (in
// registers, or over t and pre in shared memory; the wide design computes
// them again).  Three designs by width:
//   tick_score_kernel_reg<R>   Wp <= 32 R (R = 4, 8): the row in registers,
//     R workers a lane; pen, busy_wait, escale and the admission row (its
//     address needs only ekey) are loaded before the slot arrives, then
//     the gathered rows all at once: two dependent loads a row.  Four rows
//     a block, so the main path's 128 padded rows spread over 32 SMs.
//   tick_score_kernel_smem     rows up to 227 KB: cp.async copies the rows
//     into shared memory (16 bytes a copy where Wp % 4 == 0); the second
//     pass reads 4 workers a lane and writes ranked in 16-byte stores.
//   tick_score_kernel_wide     wider rows: the two passes read global
//     memory (the second from L1/L2).
// The first pass keeps each lane's order (w = lane, lane + 32, ... in
// increasing w) and the xor tree of warp_nan_min: nan_min is not symmetric
// in -0.0/0.0 or in NaN payloads.  The second pass is cell by cell, so its
// lanes may take any workers.

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
// vectors and the [K, W] admission masks.  At the resident main path's 128
// padded rows x 128 workers it is latency bound instead: two dependent
// loads a row, the warp's reductions, the stores; its floor is the card's
// for one launch (chip_smoke.py prints both).  The walk must read one ranked row
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

#include <algorithm>

namespace {

constexpr int kRowsPerBlock = 4;     // job rows a block of tick_score
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kRegisterWorkers = 8;  // workers a lane in registers (Wp 256)
constexpr size_t kSmemRows = 64 * 1024;  // staged rows a block, aimed at
constexpr size_t kSmemMax = 232448;  // a block's shared memory (227 KB)
constexpr unsigned kFull = 0xffffffffu;

// The shared-memory opt-in (cudaFuncSetAttribute) applies to the device
// that is current, so each flag that records it is kept per device.
constexpr int kMaxDevices = 64;

// The current device's index into such flags, or -1 where there is none.
inline int device_slot() {
  int d = 0;
  if (cudaGetDevice(&d) != cudaSuccess || d < 0 || d >= kMaxDevices) {
    cudaGetLastError();  // not left behind for the next launch's check
    return -1;
  }
  return d;
}
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

struct TickArgs {
  const float* pool_t;
  const float* pool_pre;
  const float* pool_dec;
  const float* pool_ene;  // pool_t when energy is off (never read then)
  const int32_t* slots;
  const float* t_rem;
  const float* ttft_rem;
  const float* tpot_qos;
  const float* dtok;
  const int32_t* has_ttft;
  const int32_t* has_tpot;
  const int32_t* phase;
  const int32_t* ekey;
  const uint8_t* emask;
  const float* pen;
  const float* busy_wait;
  const float* escale;
  float* ranked;
  float* urg;
  int8_t* doom;
  int Jp, cap, Wp, K, use_energy;
};

// a job row's scalars
struct Row {
  bool jvalid, ttft_gate, tpot_gate;
  int src, ph, key;
  float rem, tr, tq, dt;
};

__device__ __forceinline__ Row load_row(const TickArgs& a, int row) {
  Row r;
  const int slot = a.slots[row];
  r.jvalid = slot >= 0;
  r.src = min(max(slot, 0), a.cap - 1);
  r.rem = a.t_rem[row];
  r.ph = a.phase[row];
  r.ttft_gate = a.has_ttft[row] != 0 && r.ph != 2;
  r.tpot_gate = a.has_tpot[row] != 0 && r.ph != 1;
  r.tr = a.ttft_rem[row];
  r.tq = a.tpot_qos[row];
  r.dt = a.dtok[row];
  r.key = min(max(a.ekey[row], 0), a.K - 1);
  return r;
}

// the first pass over one worker: the v2 row reductions and the best
// doomed completion cost
struct Folds {
  bool any_acc;
  float min_t;    // min over the solo estimate
  float min_pre;  // min over the penalized prefill prefix
  float best;     // min over feasible t_eff + busy wait
};

__device__ __forceinline__ Folds no_folds() {
  return Folds{false, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
}

// one worker's t_eff (te) and its v2 acceptance; the division only where
// the TPOT gate is open and the rest accepts
__device__ __forceinline__ bool accept(const Row& r, float tv, float pr,
                                      float dc, float p, float& te,
                                      float& ttft_est) {
  te = __fmul_rn(r.ph == 1 ? pr : (r.ph == 2 ? dc : tv), p);
  ttft_est = __fmul_rn(pr, p);
  bool ok = r.rem >= te && (!r.ttft_gate || ttft_est <= r.tr);
  if (ok && r.tpot_gate) ok = __fdiv_rn(__fmul_rn(dc, p), r.dt) <= r.tq;
  return ok;
}

// the first pass over one worker: folds it into the row's reductions and
// returns its acceptance (te set)
__device__ __forceinline__ bool fold(Folds& f, const Row& r, float tv,
                                     float pr, float dc, float p, float bw,
                                     float& te) {
  float ttft_est;
  const bool ok = accept(r, tv, pr, dc, p, te, ttft_est);
  f.any_acc |= ok;
  f.min_t = nan_min(f.min_t, tv);
  f.min_pre = nan_min(f.min_pre, ttft_est);
  f.best = nan_min(f.best, isfinite(te) ? __fadd_rn(te, bw) : CUDART_INF_F);
  return ok;
}

// the warp's reductions; lane 0 writes urg and doom.  Sets doomed and the
// doomed rows' limit (1.5 x best).
__device__ __forceinline__ void finish_row(const TickArgs& a, const Row& r,
                                           int row, int lane, Folds f,
                                           bool& doomed, float& limit) {
  f.any_acc = __any_sync(kFull, f.any_acc);
  f.min_t = warp_nan_min(f.min_t);
  f.min_pre = warp_nan_min(f.min_pre);
  f.best = warp_nan_min(f.best);
  doomed = !f.any_acc;
  limit = __fmul_rn(1.5f, f.best);
  if (lane == 0) {
    float u = __fsub_rn(r.rem, f.min_t);
    if (r.ttft_gate) u = nan_min(u, __fsub_rn(r.tr, f.min_pre));
    a.urg[row] = u;
    a.doom[row] = static_cast<int8_t>(doomed);
  }
}

// the second pass over one worker, from its t_eff and acceptance: its
// ranked cell (the ranking cost where eligible, else inf)
__device__ __forceinline__ float rank_cell(const Row& r, bool doomed,
                                           float limit, bool use_energy,
                                           float te, bool ok, float en,
                                           float bw, float es, uint8_t em) {
  float cost;
  bool elig;
  if (doomed) {
    cost = __fadd_rn(te, bw);
    elig = isfinite(te) && te <= limit;
  } else {
    cost = te;
    elig = ok;
  }
  if (use_energy) cost = __fadd_rn(cost, __fmul_rn(en, es));
  elig = elig && em != 0 && r.jvalid;
  return elig ? cost : CUDART_INF_F;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
tick_score_kernel_reg(const TickArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= a.Jp) return;  // uniform across the warp
  const bool energy = a.use_energy != 0;
  // the loads that need no slot first, then the gathered rows at once
  float p[R], bw[R], es[R], tv[R], pr[R], dc[R], en[R];
  uint8_t em[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int w = lane + 32 * k;
    if (w < a.Wp) {
      p[k] = a.pen[w];
      bw[k] = a.busy_wait[w];
      es[k] = energy ? a.escale[w] : 0.f;
    }
  }
  const Row r = load_row(a, row);
  const uint8_t* emr = a.emask + static_cast<size_t>(r.key) * a.Wp;
  const size_t base = static_cast<size_t>(r.src) * a.Wp;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int w = lane + 32 * k;
    if (w < a.Wp) {
      em[k] = emr[w];
      tv[k] = a.pool_t[base + w];
      pr[k] = a.pool_pre[base + w];
      dc[k] = a.pool_dec[base + w];
      en[k] = energy ? a.pool_ene[base + w] : 0.f;
    }
  }
  Folds f = no_folds();
  float te[R];
  bool ok[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (lane + 32 * k < a.Wp)
      ok[k] = fold(f, r, tv[k], pr[k], dc[k], p[k], bw[k], te[k]);
  bool doomed;
  float limit;
  finish_row(a, r, row, lane, f, doomed, limit);
  float* out = a.ranked + static_cast<size_t>(row) * a.Wp;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int w = lane + 32 * k;
    if (w < a.Wp)
      out[w] = rank_cell(r, doomed, limit, energy, te[k], ok[k], en[k],
                         bw[k], es[k], em[k]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

// One warp a row, blockDim.x / 32 rows a block, each row's t, pre, dec
// (and ene) staged at srow + warp * n_arr * Wp.  `vec`: Wp % 4 == 0 and
// every row base 16-byte aligned (the emask row 4-byte aligned).
__global__ void __launch_bounds__(kThreads)
tick_score_kernel_smem(const TickArgs a, int vec) {
  extern __shared__ __align__(16) float srow[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= a.Jp) return;  // uniform across the warp; no block barrier
  const bool energy = a.use_energy != 0;
  const int Wp = a.Wp, n_arr = energy ? 4 : 3;
  const Row r = load_row(a, row);
  const size_t base = static_cast<size_t>(r.src) * Wp;
  float* st = srow + static_cast<size_t>(warp) * n_arr * Wp;
  for (int i = 0; i < n_arr; ++i) {
    const float* src = (i == 0 ? a.pool_t : i == 1 ? a.pool_pre
                        : i == 2 ? a.pool_dec : a.pool_ene) + base;
    if (vec) {
      for (int c = 4 * lane; c < Wp; c += 128)
        cp_async16(st + i * Wp + c, src + c);
    } else {
      for (int w = lane; w < Wp; w += 32)
        cp_async4(st + i * Wp + w, src + w);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const uint8_t* emr = a.emask + static_cast<size_t>(r.key) * Wp;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();  // every lane's copies are in
  float *t = st, *pre = st + Wp;
  const float *dec = st + 2 * Wp, *ene = st + 3 * Wp;

  // the first pass leaves each worker's t_eff in t and its acceptance in
  // pre (a lane overwrites only what it alone reads)
  Folds f = no_folds();
#pragma unroll 4
  for (int w = lane; w < Wp; w += 32) {
    float te;
    const bool ok =
        fold(f, r, t[w], pre[w], dec[w], a.pen[w], a.busy_wait[w], te);
    t[w] = te;
    pre[w] = ok ? 1.f : 0.f;
  }
  bool doomed;
  float limit;
  finish_row(a, r, row, lane, f, doomed, limit);
  __syncwarp();  // the second pass reads other lanes' workers

  float* out = a.ranked + static_cast<size_t>(row) * Wp;
  if (vec) {
#pragma unroll 2
    for (int w = 4 * lane; w < Wp; w += 128) {
      const float4 te4 = *reinterpret_cast<const float4*>(t + w);
      const float4 ok4 = *reinterpret_cast<const float4*>(pre + w);
      const float4 bw4 = *reinterpret_cast<const float4*>(a.busy_wait + w);
      const uchar4 em4 = *reinterpret_cast<const uchar4*>(emr + w);
      float4 en4 = make_float4(0.f, 0.f, 0.f, 0.f), es4 = en4;
      if (energy) {
        en4 = *reinterpret_cast<const float4*>(ene + w);
        es4 = *reinterpret_cast<const float4*>(a.escale + w);
      }
      float4 o;
      o.x = rank_cell(r, doomed, limit, energy, te4.x, ok4.x != 0.f, en4.x,
                      bw4.x, es4.x, em4.x);
      o.y = rank_cell(r, doomed, limit, energy, te4.y, ok4.y != 0.f, en4.y,
                      bw4.y, es4.y, em4.y);
      o.z = rank_cell(r, doomed, limit, energy, te4.z, ok4.z != 0.f, en4.z,
                      bw4.z, es4.z, em4.z);
      o.w = rank_cell(r, doomed, limit, energy, te4.w, ok4.w != 0.f, en4.w,
                      bw4.w, es4.w, em4.w);
      *reinterpret_cast<float4*>(out + w) = o;
    }
  } else {
    for (int w = lane; w < Wp; w += 32)
      out[w] = rank_cell(r, doomed, limit, energy, t[w], pre[w] != 0.f,
                         energy ? ene[w] : 0.f, a.busy_wait[w],
                         energy ? a.escale[w] : 0.f, emr[w]);
  }
}

// Rows too wide for shared memory: both passes read global memory.
__global__ void __launch_bounds__(kThreads)
tick_score_kernel_wide(const TickArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= a.Jp) return;  // uniform across the warp
  const bool energy = a.use_energy != 0;
  const Row r = load_row(a, row);
  const size_t base = static_cast<size_t>(r.src) * a.Wp;
  const float *t = a.pool_t + base, *pre = a.pool_pre + base,
              *dec = a.pool_dec + base, *ene = a.pool_ene + base;
  Folds f = no_folds();
  for (int w = lane; w < a.Wp; w += 32) {
    float te;
    fold(f, r, t[w], pre[w], dec[w], a.pen[w], a.busy_wait[w], te);
  }
  bool doomed;
  float limit;
  finish_row(a, r, row, lane, f, doomed, limit);
  const uint8_t* emr = a.emask + static_cast<size_t>(r.key) * a.Wp;
  float* out = a.ranked + static_cast<size_t>(row) * a.Wp;
  for (int w = lane; w < a.Wp; w += 32) {
    float te, ttft_est;
    const bool ok = accept(r, t[w], pre[w], dec[w], a.pen[w], te, ttft_est);
    out[w] = rank_cell(r, doomed, limit, energy, te, ok,
                       energy ? ene[w] : 0.f, a.busy_wait[w],
                       energy ? a.escale[w] : 0.f, emr[w]);
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
  const TickArgs a{pool_t, pool_pre, pool_dec, use_energy ? pool_ene : pool_t,
                   slots, t_rem, ttft_rem, tpot_qos, dtok, has_ttft,
                   has_tpot, phase, ekey, emask, pen, busy_wait, escale,
                   ranked, urg, doom, Jp, cap, Wp, K, use_energy ? 1 : 0};
  const unsigned blocks =
      static_cast<unsigned>((Jp + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t row_bytes = sizeof(float) * (use_energy ? 4 : 3) *
                           static_cast<size_t>(Wp);
  if (Wp <= 32 * 4) {
    tick_score_kernel_reg<4><<<blocks, kThreads, 0, stream>>>(a);
  } else if (Wp <= 32 * kRegisterWorkers) {
    tick_score_kernel_reg<kRegisterWorkers>
        <<<blocks, kThreads, 0, stream>>>(a);
  } else if (row_bytes <= kSmemMax) {
    // opt in to > 48 KB of shared memory, once a device
    static bool configured[kMaxDevices] = {};
    const int dev = device_slot();
    if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
    if (!configured[dev]) {
      const cudaError_t rc = cudaFuncSetAttribute(
          tick_score_kernel_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemMax);
      if (rc != cudaSuccess) {
        cudaGetLastError();  // not left behind for the next launch's check
        return static_cast<int>(rc);
      }
      configured[dev] = true;
    }
    auto al = [](const void* q, uintptr_t n) {
      return reinterpret_cast<uintptr_t>(q) % n == 0;
    };
    const bool vec = Wp % 4 == 0 && al(pool_t, 16) && al(pool_pre, 16) &&
                     al(pool_dec, 16) && al(a.pool_ene, 16) && al(pen, 16) &&
                     al(busy_wait, 16) && al(escale, 16) && al(ranked, 16) &&
                     al(emask, 4);
    const int rows = static_cast<int>(std::max<size_t>(
        1, std::min<size_t>(kRowsPerBlock, kSmemRows / row_bytes)));
    tick_score_kernel_smem<<<(Jp + rows - 1) / rows, 32 * rows,
                             rows * row_bytes, stream>>>(a, vec ? 1 : 0);
  } else {
    tick_score_kernel_wide<<<blocks, kThreads, 0, stream>>>(a);
  }
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
  // opt in to > 48 KB of shared memory, once a device
  static bool configured[kMaxDevices] = {};
  const int dev = device_slot();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        greedy_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    configured[dev] = true;
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
