// RWKV6 WKV recurrence for Hopper (sm_90a), carrying the state in and out.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/rwkv_scan.py:_wkv_kernel (rwkv_scan)
// and computes what it, and the step of repro/models/layers.py:rwkv_time_mix,
// compute for each (batch b, head h), with the state S as [hd_k, hd_v] f32:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// Unlike the TPU kernel it starts from a given state (or from zeros), writes
// the end state, and takes any S >= 1 (the TPU wrapper asserts S % chunk == 0
// and starts from zero), so one kernel serves a prompt and a decode step.
//
// Design.  The state of each value column lives in registers for the whole
// sequence, spread over L = kLanes = 4 adjacent lanes of a warp: lane t
// holds the rows i = t, t + L, t + 2L, ... (hd / L of them) of NC = kCols =
// 2 adjacent columns, so each r, k, w value it reads serves two columns.  A
// CTA takes hd / split columns of one (b, h), hd / split / NC * L threads;
// the wrapper (rwkv_scan.column_split) picks split (a power of two, a warp
// a CTA at least) so that B * H * split >= 128 CTAs where the columns allow
// it: one CTA of 128 threads a head at the serving prefill [4, 1024, 32, 64],
// four CTAs of one warp a head at [2, 1000, 8, 64].  The r, k, w rows of the
// next C steps (and v at the CTA's columns) are staged by 4-byte cp.async
// into the other half of a double buffer while the current C steps run, one
// barrier a pass; r, k and w are stored permuted, lane t's rows contiguous
// in a region padded by 16 bytes (no bank conflicts), so that it reads four
// of them with one 16-byte load (bf16 rows in pairs, the lane's half picked
// and widened as it is read).  Four steps are unrolled so that one step's
// tree overlaps the next one's terms.  The TPU kernel's time chunks keep a
// block resident in VMEM; here the state lives in registers and the chunks
// only batch the loads.
//
// Rounding.  Every f32 operation is the plain version's (rwkv_scan_plain),
// in its order, as explicit __fmul_rn / __fadd_rn under --fmad=false:
//   kv = k_i * v_j;  p_i = r_i * (S_ij + u_i * kv);  S_ij = w_i * S_ij + kv;
//   y_j = the sum of p_i over i as a fixed pairwise tree (p_i + p_{i+hd/2},
//         then the same over the hd/2 partial sums, ...);
// and y is rounded once, at its store.  The tree's levels at distances
// hd/2, ..., L pair rows of one lane (i and i + a multiple of L), so a lane
// runs them on its own rows; the last log2(L) levels, at distances L/2, ...,
// 1, pair lanes and run as __shfl_xor_sync, the lower lane adding its own
// sum first as the plain version does (the upper lane's sum has the
// operands swapped, which IEEE addition does not see).  So the kernel
// equals its plain version bit for bit.  That matters beyond the scan: rwkv6
// with random weights amplifies an f32 rounding difference in the scan
// ~1e4-fold over its 24 layers, so two scans that differ only in summation
// order part by ~9 % of max |logit| in bf16 (PERF.md, Findings); bit parity
// is what lets the serving path be held to its plain run at all.
//
// In place (s_out == s_in, a decode step updating its cache): each lane
// reads its entries S[i][j] before the first step and writes the same
// entries after the last; no other thread touches them.
//
// Chunk states (training): with a ckpt buffer, [B, H, ceil(S / 64), hd,
// hd] f32, each lane also writes its entries of the state before steps 0,
// 64, 128, ... (the start state at index 0), the states the backward
// (rwkv_scan_bwd.cu) recomputes each 64-step chunk from.  The write is
// keyed on the step index, not on the staging pass (C steps, not 64).  A
// template flag compiles it out of the serving instances (ckpt null), so y
// and the end state are the same bits either way.
//
// Bound.  Bytes: r, k, v, w read and y written once (5 * B*S*H*hd
// elements), the state read (if given) and written once.  Operations: about
// 6 * hd^2 per step and (b, h), each rounded on its own (no FMA); at the
// serving prefill [4, 1024, 32, 64] that is 3.2e9, ~0.096 ms at 128 FP32
// lanes on each of 132 SMs at 1.98 GHz, twice the byte bound (0.05 ms in
// f32).  The steps of one (b, h) run one after another, so the floor is the
// instructions.  Variants without the tree and the shuffles, or without
// the shared-memory reads, were hardly faster on the H100, so the six
// rounded operations a term set the time.  The chunked-parallel form
// (intra-chunk products on the tensor cores) reorders the sums and is not
// this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;   // lanes sharing a group of value columns
constexpr int kCols = 2;    // value columns a lane holds
constexpr int kUnroll = 4;  // steps unrolled (their trees overlap)
constexpr int kStageUnits = 1024;   // 4-byte units of one staged array
constexpr int kChunk = 64;  // steps between two saved chunk states
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);  // exact: a bf16 is the top half of an f32
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four of a lane's rows from 16 staged bytes: four f32 rows, or four bf16
// pairs of which `sel` (a __byte_perm selector) picks the lane's half.
__device__ __forceinline__ float4 rows4(const uint32_t* p, float*,
                                        unsigned) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  return make_float4(__uint_as_float(x.x), __uint_as_float(x.y),
                     __uint_as_float(x.z), __uint_as_float(x.w));
}
__device__ __forceinline__ float4 rows4(const uint32_t* p, __nv_bfloat16*,
                                        unsigned sel) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  return make_float4(__uint_as_float(__byte_perm(x.x, 0, sel)),
                     __uint_as_float(__byte_perm(x.y, 0, sel)),
                     __uint_as_float(__byte_perm(x.z, 0, sel)),
                     __uint_as_float(__byte_perm(x.w, 0, sel)));
}

// One (i, j) term of a step, rounded as the plain version rounds it:
// returns r * (s + u * kv) and sets s = w * s + kv, kv = k * v_j.
__device__ __forceinline__ float wkv_term(float r, float k, float w, float u,
                                          float vj, float& s) {
  const float kv = __fmul_rn(k, vj);
  const float p = __fmul_rn(r, __fadd_rn(s, __fmul_rn(u, kv)));
  s = __fadd_rn(__fmul_rn(w, s), kv);
  return p;
}

// q[i] += q[i + N/2] for i < N/2, then the same over the first N/2: the
// fixed pairwise order of the plain version; sums q[0..N) into q[0].
template <int N>
__device__ __forceinline__ void tree_sum(float* q) {
  if constexpr (N > 1) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) q[i] = __fadd_rn(q[i], q[i + N / 2]);
    tree_sum<N / 2>(q);
  }
}

template <int HD, typename T>
struct Scan {
  static constexpr int L = kLanes, NC = kCols;
  static constexpr int M = HD / L;               // rows a lane holds
  static constexpr int EPU = 4 / int(sizeof(T)); // elements a 4-byte unit
  static constexpr int LG = L / EPU;             // lane regions of a row
  static constexpr int RS = M + 4;               // a region, padded (banks)
  static constexpr int URS = LG * RS;            // units a staged r/k/w row
  static constexpr int UPS = HD / EPU;           // units a row in memory
  static constexpr int C = kStageUnits / URS;    // steps staged per pass
  static constexpr int kMinCols = 32 / L * NC;   // a warp a CTA at least
};

template <int HD, typename T, bool CK>
__global__ void __launch_bounds__(HD / kCols * kLanes)
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, const float* s_in,
                 float* s_out, T* __restrict__ y, float* __restrict__ ckpt,
                 int S, int H, int split, int has_state) {
  using P = Scan<HD, T>;
  constexpr int L = P::L, NC = P::NC, M = P::M, EPU = P::EPU, LG = P::LG;
  constexpr int RS = P::RS, URS = P::URS, UPS = P::UPS, C = P::C;
  __shared__ __align__(16) uint32_t rkw[2][3][C * URS];
  __shared__ __align__(16) uint32_t vst[2][C * UPS];

  const int ncol = HD / split;                  // value columns a CTA
  const int vunits = ncol / EPU;
  const int bh = blockIdx.x / split, part = blockIdx.x % split;
  const int b = bh / H, h = bh % H;
  const int t = threadIdx.x % L, jl = threadIdx.x / L * NC;
  const int j = part * ncol + jl;               // the first of NC columns
  const size_t step = static_cast<size_t>(H) * HD;  // elements per step
  const size_t base = (static_cast<size_t>(b) * S * H + h) * HD;

  // steps [t0, t0 + C) into half `buf`: unit uu of a row goes to lane
  // region uu % LG, place uu / LG
  auto stage = [&](int t0, int buf) {
    const int n = min(C, S - t0);
    for (int e = threadIdx.x; e < n * UPS; e += blockDim.x) {
      const int tt = e / UPS, uu = e % UPS;
      const size_t src = base + static_cast<size_t>(t0 + tt) * step +
                         uu * EPU;
      const int dst = tt * URS + (uu % LG) * RS + uu / LG;
      cp_async4(&rkw[buf][0][dst], r + src);
      cp_async4(&rkw[buf][1][dst], k + src);
      cp_async4(&rkw[buf][2][dst], w + src);
    }
    for (int e = threadIdx.x; e < n * vunits; e += blockDim.x) {
      const int tt = e / vunits, uu = e % vunits;
      cp_async4(&vst[buf][tt * vunits + uu],
                v + base + static_cast<size_t>(t0 + tt) * step +
                    part * ncol + uu * EPU);
    }
    cp_async_commit();
  };
  stage(0, 0);

  // this lane's rows i = t + L * m of S[:, j .. j + NC) and of u
  const size_t sbase = static_cast<size_t>(bh) * HD * HD + j;
  float st[NC][M], ur[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = t + L * m;
    ur[m] = u[h * HD + i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      st[c][m] =
          has_state ? s_in[sbase + static_cast<size_t>(i) * HD + c] : 0.f;
  }
  const unsigned sel = (t & 1) ? 0x3244u : 0x1044u;  // bf16: high or low
  const int region = (t / EPU) * RS;                  // the lane's units

  for (int t0 = 0, buf = 0; t0 < S; t0 += C, buf ^= 1) {
    cp_async_wait_all();  // this pass's rows (this thread's copies)
    __syncthreads();      // ... everyone's; the other half is free
    if (t0 + C < S) stage(t0 + C, buf ^ 1);
    const int n = min(C, S - t0);
    const T* vt = reinterpret_cast<const T*>(vst[buf]) + jl;
#pragma unroll(kUnroll)
    for (int tt = 0; tt < n; ++tt) {
      if constexpr (CK) {
        if (((t0 + tt) & (kChunk - 1)) == 0) {  // the state before the step
          float* ck = ckpt + (static_cast<size_t>(bh) * ((S + kChunk - 1) /
                                                         kChunk) +
                              (t0 + tt) / kChunk) * HD * HD + j;
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int c = 0; c < NC; ++c)
              ck[static_cast<size_t>(t + L * m) * HD + c] = st[c][m];
        }
      }
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vj[c] = load1(vt + tt * ncol + c);
      const uint32_t* rr = rkw[buf][0] + tt * URS + region;
      const uint32_t* kk = rkw[buf][1] + tt * URS + region;
      const uint32_t* ww = rkw[buf][2] + tt * URS + region;
      float p[NC][M];
#pragma unroll
      for (int a = 0; a < M; a += 4) {
        const float4 r4 = rows4(rr + a, static_cast<T*>(nullptr), sel);
        const float4 k4 = rows4(kk + a, static_cast<T*>(nullptr), sel);
        const float4 w4 = rows4(ww + a, static_cast<T*>(nullptr), sel);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          p[c][a] = wkv_term(r4.x, k4.x, w4.x, ur[a], vj[c], st[c][a]);
          p[c][a + 1] =
              wkv_term(r4.y, k4.y, w4.y, ur[a + 1], vj[c], st[c][a + 1]);
          p[c][a + 2] =
              wkv_term(r4.z, k4.z, w4.z, ur[a + 2], vj[c], st[c][a + 2]);
          p[c][a + 3] =
              wkv_term(r4.w, k4.w, w4.w, ur[a + 3], vj[c], st[c][a + 3]);
        }
      }
      float yj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tree_sum<M>(p[c]);  // the levels at distances hd/2 .. L, here
        yj[c] = p[c][0];
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)  // distances L/2 .. 1
#pragma unroll
        for (int c = 0; c < NC; ++c)
          yj[c] = __fadd_rn(yj[c], __shfl_xor_sync(kFull, yj[c], off));
      if (t == 0) {
        T* yt = y + base + static_cast<size_t>(t0 + tt) * step + j;
#pragma unroll
        for (int c = 0; c < NC; ++c) store1(yt + c, yj[c]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      s_out[sbase + static_cast<size_t>(t + L * m) * HD + c] = st[c][m];
}

template <int HD, typename T, bool CK>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s_in, float* s_out, void* y,
           float* ckpt, int B, int S, int H, int split, int has_state,
           cudaStream_t stream) {
  using P = Scan<HD, T>;
  static_assert(P::M % 4 == 0, "a lane reads its rows four at a time");
  if (HD / split < P::kMinCols) return static_cast<int>(cudaErrorInvalidValue);
  rwkv_scan_kernel<HD, T, CK>
      <<<B * H * split, HD / split / P::NC * P::L, 0, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(w), u, s_in, s_out,
          static_cast<T*>(y), ckpt, S, H, split, has_state);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename T>
int launch_ck(const void* r, const void* k, const void* v, const void* w,
              const float* u, const float* s_in, float* s_out, void* y,
              float* ckpt, int B, int S, int H, int split, int has_state,
              cudaStream_t stream) {
  if (ckpt != nullptr)
    return launch<HD, T, true>(r, k, v, w, u, s_in, s_out, y, ckpt, B, S, H,
                               split, has_state, stream);
  return launch<HD, T, false>(r, k, v, w, u, s_in, s_out, y, nullptr, B, S,
                              H, split, has_state, stream);
}

template <typename T>
int dispatch(int hd, const void* r, const void* k, const void* v,
             const void* w, const float* u, const float* s_in, float* s_out,
             void* y, float* ckpt, int B, int S, int H, int split,
             int has_state, cudaStream_t stream) {
  switch (hd) {
#define SYNERGAI_HD(N)                                                    \
  case N:                                                                 \
    return launch_ck<N, T>(r, k, v, w, u, s_in, s_out, y, ckpt, B, S, H,  \
                           split, has_state, stream);
    SYNERGAI_HD(16)
    SYNERGAI_HD(32)
    SYNERGAI_HD(64)
#undef SYNERGAI_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  r, k, v, w, y: [B, S, H, hd],
// contiguous device tensors of one dtype (0 = f32, 1 = bf16), 4-byte
// aligned; u: [H, hd] f32; s_in (read only if has_state) and s_out:
// [B, H, hd, hd] f32, which may be the same buffer; ckpt: null, or
// [B, H, ceil(S / 64), hd, hd] f32 for the chunk states.  split: CTAs per
// (b, h), a power of two with hd / split >= 32 / kLanes * kCols columns (a
// warp a CTA).  Launches one kernel
// asynchronously on `stream`; returns cudaGetLastError().

extern "C" int synergai_rwkv_scan(const void* r, const void* k, const void* v,
                                  const void* w, const float* u,
                                  const float* s_in, float* s_out, void* y,
                                  float* ckpt, int dtype, int B, int S, int H,
                                  int hd, int split, int has_state,
                                  cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || split < 1 || (split & (split - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(hd, r, k, v, w, u, s_in, s_out, y, ckpt, B, S, H,
                           split, has_state, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, r, k, v, w, u, s_in, s_out, y, ckpt,
                                   B, S, H, split, has_state, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The lanes that share a column group (rwkv_scan.LANES), the columns a
// lane holds (rwkv_scan.COLS) and the steps between chunk states
// (rwkv_scan.CHUNK).
extern "C" int synergai_rwkv_lanes() { return kLanes; }
extern "C" int synergai_rwkv_cols() { return kCols; }
extern "C" int synergai_rwkv_chunk() { return kChunk; }

extern "C" const char* synergai_rwkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
