// Backward of prefill (flash) attention for Hopper (sm_90a): GQA, causal,
// sliding-window and non-causal masks, f32 or bf16 in and out, f32 inside.
//
// Replaces no Pallas kernel: the JAX package has no backward kernel, and its
// training takes jax.value_and_grad through the XLA-path attention
// (repro/models/common.py: naive_attention, chunked_flash_attention under
// jax.checkpoint).  This computes that gradient for the forward of
// flash_attention.cu, from the forward's output and log-sum-exp:
//   s  = (q . k) * scale, masked (causal | window | past Sk) -> P = 0
//   P  = exp(s - lse)                    the forward's softmax, recomputed
//   D  = rowsum(dO o O)                  per (b, h, query)
//   dP = dO . V^T,  dS = P o (dP - D)
//   dV = sum_q P^T dO,  dK = scale sum_q dS^T Q,  dQ = scale dS K
// where the sums over q run over the G query heads that share a kv head
// (head h uses kv head h / G).  Three kernels, launched in order on one
// stream by synergai_flash_attention_bwd:
//   flash_attention_bwd_dot_kernel   D, one warp a (b, query, head) row;
//   flash_attention_bwd_dkdv_kernel  one CTA per (b, kv head, 32-key block):
//     K and V staged once, dK and dV kept in registers while the CTA walks
//     the G heads and every query block that sees one of its keys, written
//     once at the end;
//   flash_attention_bwd_dq_kernel    one CTA per (b, head, 32-query block):
//     Q, dO, lse and D staged once, dQ in registers over the key blocks.
// No atomics: each output element is summed by one thread in a fixed order,
// so two calls give the same bits.
//
// Inside, everything is f32 FMAs on tiles widened to f32 in shared memory
// ([32][hd + 4]; the pad keeps the float4 row reads of 8 threads on 8
// different bank groups).  256 threads as a 16 x 16 grid (ty, tx): in a
// score tile thread (ty, tx) holds rows 2ty, 2ty + 1 and keys tx, tx + 16
// of S and dP; P and dS go through shared memory; in the accumulation it
// holds two keys (dK, dV) or two rows (dQ) and head dims tx + 16c.  A row
// that sees no key is not a case: the wrapper refuses it (under a window,
// Sq - Sk >= window).
//
// Bound.  Operations: 10 * hd flops per visible (query head, key) pair (S,
// dP, dV, dK, dQ; the dq kernel recomputes S and dP, 14 * hd done) at the
// card's dense peak for the input type, 989 TFLOP/s bf16 (tensor cores) or
// 67 TFLOP/s f32.  This first kernel does not use the tensor cores and runs
// at a fraction of the f32 FMA rate: it is right and simple; wgmma and TMA
// tiles for bf16 are the next step (ROADMAP).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 32;      // query positions a tile
constexpr int kKeys = 32;      // keys a tile
constexpr int kMaxSmem = 232448;  // sm_90 opt-in limit per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// four consecutive elements, widened to f32 (16-byte aligned for f32,
// 8-byte for bf16: hd % 4 == 0 and 16-byte aligned tensors)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

// Rows [first, first + ROWS) of a tensor whose row p starts at
// base + p * stride, widened into shared memory [ROWS][HD + 4]; rows at or
// past `limit` are zeros.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* base, size_t stride,
                                      int first, int limit) {
  constexpr int LD = HD + 4;
  for (int e = threadIdx.x * 4; e < ROWS * HD; e += kThreads * 4) {
    const int r = e / HD, d = e % HD, pos = first + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < limit) x = load4(base + static_cast<size_t>(pos) * stride + d);
    *reinterpret_cast<float4*>(dst + r * LD + d) = x;
  }
}

// lse and D of query positions [q0, q0 + kRows) into shared memory (0 past
// Sq, where P is 0 anyway)
__device__ __forceinline__ void stage_rows(float* Ls, float* Ds,
                                           const float* lse, const float* dsum,
                                           int q0, int Sq) {
  const int r = threadIdx.x;
  if (r < kRows) {
    const bool ok = q0 + r < Sq;
    Ls[r] = ok ? lse[q0 + r] : 0.f;
    Ds[r] = ok ? dsum[q0 + r] : 0.f;
  }
}

// P and dS of one (query tile, key tile): queries [q0, q0 + kRows) of one
// head (Qs, dOs, Ls, Ds), keys [k0, k0 + kKeys) of its kv head (Ks, Vs);
// written to Ps and dSs [kRows][kKeys + 1].
template <int HD>
__device__ __forceinline__ void score_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* Ls, const float* Ds, float* Ps, float* dSs, int q0, int k0,
    int Sq, int Sk, int causal, int use_window, int window, float scale) {
  constexpr int LD = HD + 4, PS = kKeys + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 ka = lds4(Ks + tx * LD + d);
    const float4 kb = lds4(Ks + (tx + 16) * LD + d);
    const float4 va = lds4(Vs + tx * LD + d);
    const float4 vb = lds4(Vs + (tx + 16) * LD + d);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 qv = lds4(Qs + (2 * ty + i) * LD + d);
      const float4 ov = lds4(dOs + (2 * ty + i) * LD + d);
      s[i][0] = dot4(qv, ka, s[i][0]);
      s[i][1] = dot4(qv, kb, s[i][1]);
      dp[i][0] = dot4(ov, va, dp[i][0]);
      dp[i][1] = dot4(ov, vb, dp[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * ty + i, qp = q0 + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j, key = k0 + c;
      const bool visible = qp < Sq && key < Sk && !(causal && key > qp) &&
                           !(use_window && qp - key >= window);
      const float p =
          visible ? expf(__fsub_rn(__fmul_rn(s[i][j], scale), Ls[r])) : 0.f;
      Ps[r * PS + c] = p;
      dSs[r * PS + c] = __fmul_rn(p, __fsub_rn(dp[i][j], Ds[r]));
    }
  }
}

template <int HD>
constexpr int smem_bytes() {
  return 4 * (2 * kKeys * (HD + 4) + 2 * kRows * (HD + 4) +
              2 * kRows * (kKeys + 1) + 2 * kRows);
}

// D[b, h, q] = sum_d dO[b, q, h, d] * O[b, q, h, d], one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dot_kernel(const T* __restrict__ o,
                               const T* __restrict__ dout,
                               float* __restrict__ dsum, long long rows,
                               int Sq, int H, int hd) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = o + row * hd;
  const T* g = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = __fmaf_rn(to_f32(a[d]), to_f32(g[d]), acc);
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  if (lane == 0) {
    const long long per_b = static_cast<long long>(Sq) * H;
    const long long b = row / per_b, rem = row % per_b;
    const int qp = static_cast<int>(rem / H), h = static_cast<int>(rem % H);
    dsum[(b * H + h) * Sq + qp] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Sk, int H, int K, int causal, int use_window, int window,
    float scale) {
  constexpr int LD = HD + 4, PS = kKeys + 1, NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kKeys][LD]
  float* Vs = Ks + kKeys * LD;                  // [kKeys][LD]
  float* Qs = Vs + kKeys * LD;                  // [kRows][LD]
  float* dOs = Qs + kRows * LD;                 // [kRows][LD]
  float* Ps = dOs + kRows * LD;                 // [kRows][PS]
  float* dSs = Ps + kRows * PS;                 // [kRows][PS]
  float* Ls = dSs + kRows * PS;                 // [kRows]
  float* Ds = Ls + kRows;                       // [kRows]

  const int G = H / K;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int k0 = blockIdx.x * kKeys;
  const int k_last = min(k0 + kKeys, Sk) - 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t kv_stride = static_cast<size_t>(K) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_off = (static_cast<size_t>(b) * Sk * K + kh) * HD;
  stage<T, HD, kKeys>(Ks, k + kv_off, kv_stride, k0, Sk);
  stage<T, HD, kKeys>(Vs, v + kv_off, kv_stride, k0, Sk);

  // the query tiles that see a key of this block: causal, from position
  // k0 on; windowed, up to k_last + window - 1
  long long q_begin = causal ? k0 : 0, q_end = Sq;
  if (use_window)
    q_end = min(q_end, static_cast<long long>(k_last) + window);
  const int qt_begin = static_cast<int>(q_begin / kRows);
  const int qt_end =
      q_end > q_begin ? static_cast<int>((q_end + kRows - 1) / kRows) : 0;

  float dk_acc[2][NC], dv_acc[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * HD;
    const size_t row_off = (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();  // the last tile's readers are done (K, V staged)
      stage<T, HD, kRows>(Qs, q + q_off, q_stride, q0, Sq);
      stage<T, HD, kRows>(dOs, dout + q_off, q_stride, q0, Sq);
      stage_rows(Ls, Ds, lse + row_off, dsum + row_off, q0, Sq);
      __syncthreads();
      score_tile<HD>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, Sq, Sk,
                     causal, use_window, window, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys 2ty, 2ty + 1, dims tx + 16c
#pragma unroll 2
      for (int r = 0; r < kRows; ++r) {
        const float p0 = Ps[r * PS + 2 * ty], p1 = Ps[r * PS + 2 * ty + 1];
        const float s0 = dSs[r * PS + 2 * ty], s1 = dSs[r * PS + 2 * ty + 1];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ov = dOs[r * LD + tx + 16 * c];
          const float qv = Qs[r * LD + tx + 16 * c];
          dv_acc[0][c] = __fmaf_rn(p0, ov, dv_acc[0][c]);
          dv_acc[1][c] = __fmaf_rn(p1, ov, dv_acc[1][c]);
          dk_acc[0][c] = __fmaf_rn(s0, qv, dk_acc[0][c]);
          dk_acc[1][c] = __fmaf_rn(s1, qv, dk_acc[1][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 2 * ty + i;
    if (key >= Sk) continue;
    const size_t off =
        ((static_cast<size_t>(b) * Sk + key) * K + kh) * HD + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(dk + off + 16 * c, __fmul_rn(dk_acc[i][c], scale));
      store(dv + off + 16 * c, dv_acc[i][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, T* __restrict__ dq, int Sq, int Sk, int H,
    int K, int causal, int use_window, int window, float scale) {
  constexpr int LD = HD + 4, PS = kKeys + 1, NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kKeys][LD]
  float* Vs = Ks + kKeys * LD;                  // [kKeys][LD]
  float* Qs = Vs + kKeys * LD;                  // [kRows][LD]
  float* dOs = Qs + kRows * LD;                 // [kRows][LD]
  float* Ps = dOs + kRows * LD;                 // [kRows][PS]
  float* dSs = Ps + kRows * PS;                 // [kRows][PS]
  float* Ls = dSs + kRows * PS;                 // [kRows]
  float* Ds = Ls + kRows;                       // [kRows]

  const int G = H / K;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const int q0 = blockIdx.x * kRows;
  const int q_last = min(q0 + kRows, Sq) - 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t kv_stride = static_cast<size_t>(K) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_off = (static_cast<size_t>(b) * Sk * K + kh) * HD;
  const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * HD;
  const size_t row_off = (static_cast<size_t>(b) * H + h) * Sq;
  stage<T, HD, kRows>(Qs, q + q_off, q_stride, q0, Sq);
  stage<T, HD, kRows>(dOs, dout + q_off, q_stride, q0, Sq);
  stage_rows(Ls, Ds, lse + row_off, dsum + row_off, q0, Sq);

  // the key tiles this query block sees
  int kt_end = (Sk + kKeys - 1) / kKeys;
  if (causal) kt_end = min(kt_end, q_last / kKeys + 1);
  int kt_begin = 0;
  if (use_window)
    kt_begin = static_cast<int>(
        max(0LL, (static_cast<long long>(q0) - window + 1) / kKeys));

  float dq_acc[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the last tile's readers are done (Q, dO staged)
    stage<T, HD, kKeys>(Ks, k + kv_off, kv_stride, k0, Sk);
    stage<T, HD, kKeys>(Vs, v + kv_off, kv_stride, k0, Sk);
    __syncthreads();
    score_tile<HD>(Qs, dOs, Ks, Vs, Ls, Ds, Ps, dSs, q0, k0, Sq, Sk, causal,
                   use_window, window, scale);
    __syncthreads();
    // dQ += dS K: rows 2ty, 2ty + 1, dims tx + 16c
#pragma unroll 2
    for (int j = 0; j < kKeys; ++j) {
      const float s0 = dSs[(2 * ty) * PS + j];
      const float s1 = dSs[(2 * ty + 1) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = Ks[j * LD + tx + 16 * c];
        dq_acc[0][c] = __fmaf_rn(s0, kv, dq_acc[0][c]);
        dq_acc[1][c] = __fmaf_rn(s1, kv, dq_acc[1][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + 2 * ty + i;
    if (qp >= Sq) continue;
    const size_t off = ((static_cast<size_t>(b) * Sq + qp) * H + h) * HD + tx;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(dq + off + 16 * c, __fmul_rn(dq_acc[i][c], scale));
  }
}

// ---------------------------------------------------------------------------
// launch

struct Kernels {
  const void* dot;
  const void* dkdv;
  const void* dq;
  int smem;
};

template <typename T, int HD>
Kernels kernels_of() {
  return {reinterpret_cast<const void*>(flash_attention_bwd_dot_kernel<T>),
          reinterpret_cast<const void*>(flash_attention_bwd_dkdv_kernel<T, HD>),
          reinterpret_cast<const void*>(flash_attention_bwd_dq_kernel<T, HD>),
          smem_bytes<HD>()};
}

template <typename T>
bool kernels_for(int hd, Kernels* c) {
  switch (hd) {
    case 16: *c = kernels_of<T, 16>(); return true;
    case 32: *c = kernels_of<T, 32>(); return true;
    case 64: *c = kernels_of<T, 64>(); return true;
    case 80: *c = kernels_of<T, 80>(); return true;
    case 128: *c = kernels_of<T, 128>(); return true;
    case 256: *c = kernels_of<T, 256>(); return true;
    default: return false;
  }
}

int slot_of(int hd) {
  return hd == 16 ? 0 : hd == 32 ? 1 : hd == 64 ? 2 : hd == 80 ? 3
       : hd == 128 ? 4 : 5;
}

}  // namespace

// Plain C interface, loaded with ctypes.  q, o, dout, dq: [B, Sq, H, hd];
// k, v, dk, dv: [B, Sk, K, hd]; contiguous device tensors of one dtype
// (0 = f32, 1 = bf16), 16-byte aligned.  lse: [B, H, Sq] f32, the
// forward's log-sum-exp (natural log); dsum: [B, H, Sq] f32 scratch for D.
// `window` is used when use_window is 1; every query row must see a key.
// Launches the three kernels asynchronously on `stream`; returns
// cudaGetLastError().

extern "C" int synergai_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, float* dsum, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int H, int K, int hd,
    int causal, int use_window, int window, float scale,
    cudaStream_t stream) {
  Kernels c;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool found = dtype == 1 ? kernels_for<__nv_bfloat16>(hd, &c)
                                : kernels_for<float>(hd, &c);
  if (!found) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured[2][6] = {};  // > 48 KB of shared memory, once each
  const int slot = slot_of(hd);
  if (!configured[dtype][slot]) {
    const void* big[] = {c.dkdv, c.dq};
    for (const void* fn : big) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    configured[dtype][slot] = true;
  }
  long long rows = static_cast<long long>(B) * Sq * H;
  const long long dot_blocks = (rows * 32 + kThreads - 1) / kThreads;
  const long long key_tiles = (Sk + kKeys - 1) / kKeys;
  const long long query_tiles = (Sq + kRows - 1) / kRows;
  if (dot_blocks > 0x7fffffffLL || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);

  void* dot_args[] = {&o, &dout, &dsum, &rows, &Sq, &H, &hd};
  cudaLaunchKernel(c.dot, dim3(static_cast<unsigned>(dot_blocks)), kThreads,
                   dot_args, 0, stream);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  void* dkdv_args[] = {&q, &k, &v, &dout, &lse, &dsum, &dk, &dv, &Sq, &Sk,
                       &H, &K, &causal, &use_window, &window, &scale};
  cudaLaunchKernel(c.dkdv,
                   dim3(static_cast<unsigned>(key_tiles),
                        static_cast<unsigned>(B * K)),
                   kThreads, dkdv_args, c.smem, stream);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  void* dq_args[] = {&q, &k, &v, &dout, &lse, &dsum, &dq, &Sq, &Sk, &H, &K,
                     &causal, &use_window, &window, &scale};
  cudaLaunchKernel(c.dq,
                   dim3(static_cast<unsigned>(query_tiles),
                        static_cast<unsigned>(B * H)),
                   kThreads, dq_args, c.smem, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* synergai_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
