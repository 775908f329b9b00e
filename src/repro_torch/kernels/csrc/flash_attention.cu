// Prefill (flash) attention for Hopper (sm_90a): GQA, causal and sliding
// window masks, online softmax in f32, f32 or bf16 in and out.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention.py:_flash_kernel (flash_attention)
// and computes its function, not its block structure:
//   s      = (q . k) * (1 / sqrt(hd))              f32, after the dot product
//   masked = causal & k_pos > q_pos  |  window & q_pos - k_pos >= window
//   s      = -1e30 where masked                    (as in the JAX package)
//   (m, l, acc) online softmax over key tiles; out = acc / max(l, 1e-30)
// Head h of q uses kv head h / G (G = H / K), the order of
// q.reshape(B, Sq, K, G, hd).
//
// Design.  The grid is (row tiles, B * K).  For one (b, kv head) the G query
// heads of every query position form Sq * G rows, position-major; a CTA
// takes 64 consecutive rows (G * bq rows with bq = 64 / G when G divides 64)
// and keeps them in shared memory as f32.  It streams 32-key K/V tiles
// through shared memory (widened to f32 on the way in), and its 256 threads
// form a 16 x 16 grid: thread (ty, tx) owns rows 4ty..4ty+3, keys tx and
// tx + 16 of the tile, and head dims tx + 16c of the accumulator.  Scores,
// the running (m, l) and the accumulator stay in registers; the
// probabilities go through shared memory once for the P.V product.  Products
// are plain f32 FMAs (no tensor cores): a first version that is right.
//
// Any Sq, Sk: the tails are masked.  A key past Sk scores -inf and adds
// exactly nothing.  Tiles that every row of the CTA masks are skipped: under
// causal masking key 0 is visible to every row, and under a window every row
// sees its own position, so once a visible key has set m a wholly masked
// tile would add exp(-1e30 - m) = 0.  (The window skip is used only when
// every row's own position is a key, i.e. q_pos < Sk.)
//
// Bound.  Operations: 4 * hd flops per visible (query head, key) pair; bytes
// are q, k, v read and o written once.  At the serving shape the flops
// dominate by two orders of magnitude, so the least time is the flops over
// the card's dense bf16 tensor-core peak (f32 peak for f32 inputs), which
// this FMA kernel cannot reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows per CTA
constexpr int kKeys = 32;      // keys per K/V tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kMask = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // sm_90 opt-in limit per block

// Four consecutive elements widened to f32 (16-byte / 8-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

template <int HD>
constexpr int smem_bytes() {
  return 4 * (kRows * (HD + 4) + kKeys * (HD + 4) + kKeys * HD +
              kRows * (kKeys + 1));
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int H, int K, int causal, int use_window,
                       int window, float scale) {
  constexpr int QS = HD + 4;       // padded row stride of the Q and K tiles
  constexpr int PS = kKeys + 1;    // padded row stride of the P tile
  constexpr int NC = HD / 16;      // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kRows][QS]
  float* Ks = Qs + kRows * QS;                  // [kKeys][QS]
  float* Vs = Ks + kKeys * QS;                  // [kKeys][HD]
  float* Ps = Vs + kKeys * HD;                  // [kRows][PS]

  const int G = H / K;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = Sq * G;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int e = tid * 4; e < kRows * HD; e += kThreads * 4) {
    const int r = e / HD, d = e % HD, row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) {
      const int qp = row / G, g = row % G;
      x = load4(q + ((static_cast<size_t>(b) * Sq + qp) * H + kh * G + g) *
                        HD + d);
    }
    *reinterpret_cast<float4*>(Qs + r * QS + d) = x;
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = (row0 + ty * 4 + i) / G;

  // the key tiles this CTA needs
  const int qp_lo = row0 / G;
  const int qp_hi = (min(row0 + kRows, n_rows) - 1) / G;
  int kt_end = (Sk + kKeys - 1) / kKeys;
  if (causal) kt_end = min(kt_end, qp_hi / kKeys + 1);
  int kt_begin = 0;
  if (causal && use_window && qp_hi < Sk)
    kt_begin = max(0, (qp_lo - window + 1) / kKeys);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the last tile's readers are done (and Q is staged)
    for (int e = tid * 4; e < kKeys * HD; e += kThreads * 4) {
      const int j = e / HD, d = e % HD, key = k0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < Sk) {
        const size_t off =
            ((static_cast<size_t>(b) * Sk + key) * K + kh) * HD + d;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      *reinterpret_cast<float4*>(Ks + j * QS + d) = kx;
      *reinterpret_cast<float4*>(Vs + j * HD + d) = vx;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 k0v = *reinterpret_cast<const float4*>(Ks + tx * QS + d);
      const float4 k1v =
          *reinterpret_cast<const float4*>(Ks + (tx + 16) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * QS + d);
        s[i][0] = dot4(qv, k0v, s[i][0]);
        s[i][1] = dot4(qv, k1v, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + tx + 16 * j;
        float x = __fmul_rn(s[i][j], scale);
        if (key >= Sk)
          x = -CUDART_INF_F;
        else if ((causal && key > qpos[i]) ||
                 (use_window && qpos[i] - key >= window))
          x = kMask;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      const float corr = expf(m[i] - m_new);
      float sum = p0 + p1;
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l[i] = __fmaf_rn(l[i], corr, sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      Ps[(ty * 4 + i) * PS + tx] = p0;
      Ps[(ty * 4 + i) * PS + tx + 16] = p1;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[j * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = __fmaf_rn(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= n_rows) continue;
    const int g = row % G;
    T* out = o + ((static_cast<size_t>(b) * Sq + qpos[i]) * H + kh * G + g) *
                     HD;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store1(out + tx + 16 * c, __fdiv_rn(acc[i][c], denom));
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int K, int causal, int use_window,
           int window, float scale, cudaStream_t stream) {
  static bool configured = false;  // opt in to > 48 KB of shared memory once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<HD, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int G = H / K;
  const long long row_tiles =
      (static_cast<long long>(Sq) * G + kRows - 1) / kRows;
  if (row_tiles > 0x7fffffffLL || static_cast<long long>(B) * K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>(B * K));
  flash_attention_kernel<HD, T><<<grid, kThreads, smem_bytes<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, K, causal,
      use_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Sk, int H, int K, int causal, int use_window,
             int window, float scale, cudaStream_t stream) {
  switch (hd) {
#define SYNERGAI_HD(N)                                                      \
  case N:                                                                   \
    return launch<N, T>(q, k, v, o, B, Sq, Sk, H, K, causal, use_window,    \
                        window, scale, stream);
    SYNERGAI_HD(16)
    SYNERGAI_HD(32)
    SYNERGAI_HD(64)
    SYNERGAI_HD(80)
    SYNERGAI_HD(128)
    SYNERGAI_HD(256)
#undef SYNERGAI_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  q: [B, Sq, H, hd], k, v:
// [B, Sk, K, hd], o: [B, Sq, H, hd], contiguous device tensors of one dtype
// (0 = f32, 1 = bf16), 16-byte aligned.  `window` is used when use_window
// is 1.  Launches asynchronously on `stream`; returns cudaGetLastError().

extern "C" int synergai_flash_attention(const void* q, const void* k,
                                        const void* v, void* o, int dtype,
                                        int B, int Sq, int Sk, int H, int K,
                                        int hd, int causal, int use_window,
                                        int window, float scale,
                                        cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, B, Sq, Sk, H, K, causal,
                           use_window, window, scale, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, H, K, causal,
                                   use_window, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* synergai_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
