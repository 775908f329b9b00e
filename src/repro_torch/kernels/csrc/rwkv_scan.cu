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
// Design (that of the upstream wkv6 CUDA kernel).  One CTA per (b, h) and
// one thread per value column j, which holds S[:, j] (hd f32) in registers
// for the whole sequence: the state never leaves the SM between steps.  The
// r, k, w rows (read by every thread, as shared-memory broadcasts) and the v
// rows of C steps at a time are staged in shared memory, widened to f32 on
// load; each thread then walks the C steps with no barrier.  The TPU
// kernel's time chunks keep a block resident in VMEM; here the state lives
// in registers and the chunks only batch the loads.
//
// Rounding.  Every f32 operation is the plain version's (rwkv_scan_plain),
// in its order, as explicit __fmul_rn / __fadd_rn under --fmad=false:
//   kv = k_i * v_j;  p_i = r_i * (S_ij + u_i * kv);  S_ij = w_i * S_ij + kv;
//   y_j = the sum of p_i over i as a fixed pairwise tree (p_i + p_{i+hd/2},
//         then the same over the hd/2 partial sums, ...);
// and y is rounded once, at its store.  So the kernel equals its plain
// version bit for bit.  That matters beyond the scan: rwkv6 with random
// weights amplifies an f32 rounding difference in the scan ~1e4-fold over
// its 24 layers, so two scans that differ only in summation order part by
// ~9 % of max |logit| in bf16 (PERF.md, Findings); bit parity is what lets the
// serving path be held to its plain run at all.  The tree also shortens the
// step's dependent chain to log2(hd) adds.
//
// In place (s_out == s_in, a decode step updating its cache): thread j reads
// its column S[:, j] before the first step and writes the same column after
// the last; no other thread touches it.
//
// Bound, and why this design misses it.  Bytes: r, k, v, w read and y written
// once (5 * B*S*H*hd elements), the state read (if given) and written once;
// operations: about 6 * hd^2 per step and (b, h).  At the serving prefill
// [B, S, H, hd] = [4, 1024, 32, 64] in f32 both are ~0.05 ms.  This kernel is
// bound by its sequential chain instead: B*H = 128 CTAs of hd = 64 threads
// on 132 SMs, two warps an SM (most warp schedulers idle), each walking S steps
// one after another, ~7 * hd dependent-in-part operations a thread a step.
// The chunked-parallel form (intra-chunk products on the tensor cores, the
// state carried between chunks) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStageFloats = 2048;  // floats of one staged array (C * HD)

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);  // exact: a bf16 is the top half of an f32
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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
__global__ void __launch_bounds__(HD)
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, const float* s_in,
                 float* s_out, T* __restrict__ y, int S, int H,
                 int has_state) {
  constexpr int C = kStageFloats / HD;  // steps staged per pass
  constexpr int HALF = HD / 2;
  __shared__ __align__(16) float rs[C * HD];
  __shared__ __align__(16) float ks[C * HD];
  __shared__ __align__(16) float ws[C * HD];
  __shared__ __align__(16) float vs[C * HD];
  __shared__ __align__(16) float us[HD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const size_t sbase = static_cast<size_t>(bh) * HD * HD + j;

  float st[HD];  // S[:, j]
#pragma unroll
  for (int i = 0; i < HD; ++i)
    st[i] = has_state ? s_in[sbase + static_cast<size_t>(i) * HD] : 0.f;
  us[j] = u[h * HD + j];

  const size_t step = static_cast<size_t>(H) * HD;  // elements per time step
  const size_t base = (static_cast<size_t>(b) * S * H + h) * HD + j;
  for (int t0 = 0; t0 < S; t0 += C) {
    const int n = min(C, S - t0);
    __syncthreads();  // the previous pass has read its rows (and us is set)
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = base + static_cast<size_t>(t0 + tt) * step;
      rs[tt * HD + j] = load1(r + off);
      ks[tt * HD + j] = load1(k + off);
      ws[tt * HD + j] = load1(w + off);
      vs[tt * HD + j] = load1(v + off);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt * HD + j];
      const float* rt = rs + tt * HD;
      const float* kt = ks + tt * HD;
      const float* wt = ws + tt * HD;
      float q[HALF];  // the first level of the tree: p_i + p_{i + HALF}
#pragma unroll
      for (int i = 0; i < HALF; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + i);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + i);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + i);
        const float4 u4 = *reinterpret_cast<const float4*>(us + i);
        const float4 r4h = *reinterpret_cast<const float4*>(rt + i + HALF);
        const float4 k4h = *reinterpret_cast<const float4*>(kt + i + HALF);
        const float4 w4h = *reinterpret_cast<const float4*>(wt + i + HALF);
        const float4 u4h = *reinterpret_cast<const float4*>(us + i + HALF);
        q[i] = __fadd_rn(wkv_term(r4.x, k4.x, w4.x, u4.x, vj, st[i]),
                         wkv_term(r4h.x, k4h.x, w4h.x, u4h.x, vj,
                                  st[i + HALF]));
        q[i + 1] = __fadd_rn(wkv_term(r4.y, k4.y, w4.y, u4.y, vj, st[i + 1]),
                             wkv_term(r4h.y, k4h.y, w4h.y, u4h.y, vj,
                                      st[i + HALF + 1]));
        q[i + 2] = __fadd_rn(wkv_term(r4.z, k4.z, w4.z, u4.z, vj, st[i + 2]),
                             wkv_term(r4h.z, k4h.z, w4h.z, u4h.z, vj,
                                      st[i + HALF + 2]));
        q[i + 3] = __fadd_rn(wkv_term(r4.w, k4.w, w4.w, u4.w, vj, st[i + 3]),
                             wkv_term(r4h.w, k4h.w, w4h.w, u4h.w, vj,
                                      st[i + HALF + 3]));
      }
      tree_sum<HALF>(q);
      store1(y + base + static_cast<size_t>(t0 + tt) * step, q[0]);
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i)
    s_out[sbase + static_cast<size_t>(i) * HD] = st[i];
}

template <typename T>
int dispatch(int hd, const void* r, const void* k, const void* v,
             const void* w, const float* u, const float* s_in, float* s_out,
             void* y, int B, int S, int H, int has_state,
             cudaStream_t stream) {
  switch (hd) {
#define SYNERGAI_HD(N)                                                      \
  case N:                                                                   \
    rwkv_scan_kernel<N, T><<<B * H, N, 0, stream>>>(                        \
        static_cast<const T*>(r), static_cast<const T*>(k),                 \
        static_cast<const T*>(v), static_cast<const T*>(w), u, s_in, s_out, \
        static_cast<T*>(y), S, H, has_state);                               \
    return static_cast<int>(cudaGetLastError());
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
// contiguous device tensors of one dtype (0 = f32, 1 = bf16); u: [H, hd] f32;
// s_in (read only if has_state) and s_out: [B, H, hd, hd] f32, which may be
// the same buffer.  Launches one kernel asynchronously on `stream`; returns
// cudaGetLastError().

extern "C" int synergai_rwkv_scan(const void* r, const void* k, const void* v,
                                  const void* w, const float* u,
                                  const float* s_in, float* s_out, void* y,
                                  int dtype, int B, int S, int H, int hd,
                                  int has_state, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(hd, r, k, v, w, u, s_in, s_out, y, B, S, H,
                           has_state, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, r, k, v, w, u, s_in, s_out, y, B, S,
                                   H, has_state, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* synergai_rwkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
