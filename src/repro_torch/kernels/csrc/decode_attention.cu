// Decode attention for Hopper (sm_90a): one query token per head against
// the KV cache, split-K flash-decoding, f32 or bf16 in and out.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/decode_attention.py:_decode_kernel (decode_attention)
// and computes its function, not its block structure: for each (b, kv head)
// the G = H / K query heads kh*G .. kh*G+G-1 score every cache position,
//   s = (q . k) * (1 / sqrt(hd)) in f32, -1e30 at positions >= k_valid,
// and the output is softmax(s) . v with f32 accumulation.
//
// Design.  The TPU kernel walks the cache in order on one core.  Here B * K
// CTAs alone (32 at the serving shape) would leave most of the 132 SMs idle,
// so the cache is cut into splits of `chunk` keys and the grid is
// (splits, B * K):
//   * decode_attention_split_kernel stages its split's keys and values and
//     the G query rows in shared memory (widened to f32), scores every
//     (row, key) pair, takes the split's max m and sum l of exp(s - m), and
//     writes the partial (m, l, acc = sum exp(s - m) v) in f32;
//   * decode_attention_combine_kernel, one CTA per (b, head), merges the
//     partials: M = max m, L = sum l exp(m - M),
//     out = sum acc exp(m - M) / max(L, 1e-30), in the input dtype.
// Only splits that start below kv_end = min(k_valid, S) are launched, so a
// split past k_valid adds nothing and is never combined.  Keys at or past
// k_valid would score -1e30 and, next to a visible key, add exp(-1e30 - m)
// = 0, so leaving them out is exact.  (With k_valid <= 0 every key is
// masked; then kv_end = S and all score -1e30, as in the reference.)
//
// Bound.  Bytes: the K and V rows of the kv_end visible positions are read
// once (2 * B * kv_end * K * hd elements); q and o are small.  A decode step
// does 4 * hd flops per (head, position), about 1 flop per byte in bf16,
// far below the card's ~295 flops per byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCombineThreads = 128;
constexpr float kMask = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // sm_90 opt-in limit per block

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

int split_smem_bytes(int hd, int G, int chunk) {
  return 4 * (chunk * (hd + 4) + chunk * hd + G * (hd + 4) +
              G * (chunk + 1));
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v, float* __restrict__ pm,
                              float* __restrict__ pl,
                              float* __restrict__ pacc, int B, int S, int H,
                              int K, int k_valid, int kv_end, int chunk,
                              float scale) {
  constexpr int KS = HD + 4;  // padded row stride of the K and Q tiles
  const int G = H / K;
  const int SS = chunk + 1;   // padded row stride of the score tile
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [chunk][KS]
  float* Vs = Ks + chunk * KS;                  // [chunk][HD]
  float* Qs = Vs + chunk * HD;                  // [G][KS]
  float* Ss = Qs + G * KS;                      // [G][SS]

  const int split = blockIdx.x;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int k0 = split * chunk;
  const int n = min(chunk, kv_end - k0);  // keys of this split, >= 1
  const int tid = threadIdx.x;

  for (int e = tid * 4; e < G * HD; e += kThreads * 4) {
    const int g = e / HD, d = e % HD;
    *reinterpret_cast<float4*>(Qs + g * KS + d) =
        load4(q + (static_cast<size_t>(b) * H + kh * G + g) * HD + d);
  }
  for (int e = tid * 4; e < chunk * HD; e += kThreads * 4) {
    const int j = e / HD, d = e % HD;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (j < n) {
      const size_t off =
          ((static_cast<size_t>(b) * S + k0 + j) * K + kh) * HD + d;
      kx = load4(k + off);
      vx = load4(v + off);
    }
    *reinterpret_cast<float4*>(Ks + j * KS + d) = kx;
    *reinterpret_cast<float4*>(Vs + j * HD + d) = vx;
  }
  __syncthreads();

  for (int p = tid; p < G * chunk; p += kThreads) {
    const int g = p / chunk, j = p % chunk;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(Qs + g * KS + d);
      const float4 ka = *reinterpret_cast<const float4*>(Ks + j * KS + d);
      s = __fmaf_rn(qa.x, ka.x, s);
      s = __fmaf_rn(qa.y, ka.y, s);
      s = __fmaf_rn(qa.z, ka.z, s);
      s = __fmaf_rn(qa.w, ka.w, s);
    }
    float x = __fmul_rn(s, scale);
    if (j >= n)
      x = -CUDART_INF_F;
    else if (k0 + j >= k_valid)
      x = kMask;
    Ss[g * SS + j] = x;
  }
  __syncthreads();

  // one warp per query row: the split's max and sum of exp(s - max)
  const int warp = tid >> 5, lane = tid & 31;
  const size_t BH = static_cast<size_t>(B) * H;
  for (int g = warp; g < G; g += kThreads / 32) {
    float mx = -CUDART_INF_F;
    for (int j = lane; j < chunk; j += 32) mx = fmaxf(mx, Ss[g * SS + j]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float sum = 0.f;
    for (int j = lane; j < chunk; j += 32) {
      const float p = expf(Ss[g * SS + j] - mx);
      Ss[g * SS + j] = p;
      sum += p;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) {
      const size_t row = split * BH + static_cast<size_t>(b) * H + kh * G + g;
      pm[row] = mx;
      pl[row] = sum;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    float a = 0.f;
    for (int j = 0; j < n; ++j)
      a = __fmaf_rn(Ss[g * SS + j], Vs[j * HD + d], a);
    pacc[(split * BH + static_cast<size_t>(b) * H + kh * G + g) * HD + d] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_attention_combine_kernel(const float* __restrict__ pm,
                                const float* __restrict__ pl,
                                const float* __restrict__ pacc,
                                T* __restrict__ o, int n_split, int BH,
                                int hd) {
  const int row = blockIdx.x;
  float M = -CUDART_INF_F;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, pm[s * BH + row]);
  float L = 0.f;
  for (int s = 0; s < n_split; ++s)
    L = __fmaf_rn(pl[s * BH + row], expf(pm[s * BH + row] - M), L);
  const float denom = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a = __fmaf_rn(pacc[(static_cast<size_t>(s) * BH + row) * hd + d],
                    expf(pm[s * BH + row] - M), a);
    store1(o + static_cast<size_t>(row) * hd + d, __fdiv_rn(a, denom));
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* pm,
           float* pl, float* pacc, int B, int S, int H, int K, int k_valid,
           int kv_end, int chunk, float scale, cudaStream_t stream) {
  static bool configured = false;  // opt in to > 48 KB of shared memory once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_split_kernel<HD, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int smem = split_smem_bytes(HD, H / K, chunk);
  const int n_split = (kv_end + chunk - 1) / chunk;
  if (smem > kMaxSmem || static_cast<long long>(B) * K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  decode_attention_split_kernel<HD, T>
      <<<dim3(n_split, B * K), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), pm, pl, pacc, B, S, H, K, k_valid, kv_end,
          chunk, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_attention_combine_kernel<T><<<B * H, kCombineThreads, 0, stream>>>(
      pm, pl, pacc, static_cast<T*>(o), n_split, B * H, HD);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             float* pm, float* pl, float* pacc, int B, int S, int H, int K,
             int k_valid, int kv_end, int chunk, float scale,
             cudaStream_t stream) {
  switch (hd) {
#define SYNERGAI_HD(N)                                                      \
  case N:                                                                   \
    return launch<N, T>(q, k, v, o, pm, pl, pacc, B, S, H, K, k_valid,      \
                        kv_end, chunk, scale, stream);
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

// Plain C interface, loaded with ctypes.  q, o: [B, 1, H, hd]; k, v:
// [B, S, K, hd]; contiguous device tensors of one dtype (0 = f32,
// 1 = bf16), 16-byte aligned.  pm, pl: [n_split, B * H] and pacc:
// [n_split, B * H, hd] f32 scratch, n_split = ceil(kv_end / chunk), where
// kv_end = min(k_valid, S) for k_valid >= 1 and S otherwise.  Launches both
// kernels asynchronously on `stream`; returns cudaGetLastError().

extern "C" int synergai_decode_attention(const void* q, const void* k,
                                         const void* v, void* o, float* pm,
                                         float* pl, float* pacc, int dtype,
                                         int B, int S, int H, int K, int hd,
                                         int k_valid, int kv_end, int chunk,
                                         float scale, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || chunk <= 0 ||
      kv_end <= 0 || kv_end > S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, pm, pl, pacc, B, S, H, K, k_valid,
                           kv_end, chunk, scale, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, pm, pl, pacc, B, S, H, K,
                                   k_valid, kv_end, chunk, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* synergai_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
