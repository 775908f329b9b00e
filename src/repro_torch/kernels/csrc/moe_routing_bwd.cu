// The MoE router's backward for Hopper (sm_90a): the gradient of the gates
// that csrc/moe_routing.cu returns with respect to x and the router W.
//
// The JAX package has no Pallas kernel for it: its training differentiates
// repro/models/layers.py:_route_grouped with jax.value_and_grad
// (repro/training/train_step.py:40).  The mask is a one-hot of integer
// picks and carries no gradient; the gates carry the router's gradient into
// moe_ffn's combine weights.  For each token t, in f32, with probs, the
// mask and den = max(sum_e mask probs, 1e-9) as the forward forms them and
// dg = the gates' cotangent:
//   c1        = sum_e dg[e] gates[e]                  (expert order)
//   dprobs[e] = mask[e] ? (dg[e] - c1) / den : 0
//   c2        = sum_e dprobs[e] probs[e]              (expert order)
//   dlogits[e] = probs[e] (dprobs[e] - c2)
//   dx[t][d]  = sum_e dlogits[e] W[d][e]              (expert order, cast
//                                                      once to x's dtype)
//   dW[d][e]  = sum_t x[t][d] dlogits[t][e]           (token order, below)
// den never clamps: the first pick's probability is at least 1/E.  A pick
// whose probability underflowed to 0 has dprobs != 0 and dlogits = 0, since
// probs multiplies the whole term.
//
// Three kernels, no atomics, every sum in a fixed order, so two calls give
// the same bits and moe_routing_bwd_plain (kernels/moe_routing.py), which
// does the same f32 roundings in the same order, gives them too:
//   moe_routing_bwd_token_kernel: 16 tokens a CTA.  It recomputes the
//     logits in the forward kernel's order (lane l of a warp sums the chain
//     d = l, l + 32, ... in increasing d, each product rounded, then the
//     xor-shuffle tree over the 32 chains), so probs and the top-k picks are
//     the forward's bit for bit; a warp then routes its 2 tokens as
//     route_token does and forms dlogits (kept in shared memory and written
//     to a [T, E] f32 scratch); last, thread i owns rows d = i, i + 256, ...
//     of dx for the CTA's 16 tokens, W staged 256 rows x 16 experts at a
//     time.
//   moe_routing_bwd_dw_kernel: thread (d, 4 experts) sums x[t][d]
//     dlogits[t][e] over the tokens of one chunk of kChunk in increasing t
//     (tiles of 32 tokens staged in shared memory), into dW where there is
//     one chunk, else into partial[chunk][d][e].
//   moe_routing_bwd_merge_kernel: dW = the chunks' partials added in chunk
//     order, from 0.  (0 + p is p: a sum that starts at +0.0 is never -0.0.)
//
// Bound.  Bytes: x read, W read, dg read, dx written, dW written; operations
// 3 x 2 T D E (the logits again, dx, dW), f32 without fused multiply-adds
// (bit parity rules them out, as in the forward).  At phi3.5-moe's training
// shape [T, D, E] = [8192, 4096, 16] with bf16 x that is 134 MB and 3.2
// GFLOP; at deepseek-v2's [2048, 5120, 160] it is 10 GFLOP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 256;
constexpr int kPer = kMaxE / 32;   // experts per lane in routing
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;      // every kernel's CTA: 8 warps

// the token kernel
constexpr int kTokPerWarp = 2;
constexpr int kTok = (kThreads / 32) * kTokPerWarp;  // tokens a CTA
constexpr int kET = 16;            // experts a logits tile
constexpr int kDT = 128;           // rows of W and x a logits tile
constexpr int kWStride = kET + 4;  // padded row of a staged W tile
constexpr int kXT = kThreads;      // rows of W a dx tile (one a thread)
constexpr int kXStride = kET + 1;  // padded row of a dx tile
constexpr int kStageFloats =
    kDT * kWStride + kTok * kDT > kXT * kXStride ? kDT * kWStride + kTok * kDT
                                                 : kXT * kXStride;

// the dW kernels
constexpr int kChunk = 512;        // tokens a chunk (a partial of dW)
constexpr int kWD = 64;            // rows d a CTA
constexpr int kWE = 16;            // experts a CTA, 4 a thread
constexpr int kWT = 32;            // tokens a staged tile

__device__ __forceinline__ float load1(float v) { return v; }
__device__ __forceinline__ float load1(__nv_bfloat16 v) {
  return __bfloat162float(v);  // exact: a bf16 is the top half of an f32
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // rounded once, to nearest even
}

// the sum of row[0, E) in index order, from 0 (loads batched 8 at a time);
// the forward's sum_in_order
__device__ __forceinline__ float sum_in_order(const float* row, int E) {
  float s = 0.f;
  for (int e0 = 0; e0 < E; e0 += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = e0 + j < E ? row[e0 + j] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (e0 + j < E) s = __fadd_rn(s, v[j]);
  }
  return s;
}

// One warp: the logits of a token in row[0, E) (overwritten with its
// dlogits, which are also written to out[0, E)), its gates' cotangent dg.
// The routing is the forward's route_token, step for step.
__device__ void token_backward(float* row, const float* __restrict__ dg,
                               float* __restrict__ out, int E, int top_k,
                               int lane) {
  float pr[kPer];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = lane + 32 * i;
    pr[i] = e < E ? row[e] : -INFINITY;
    m = fmaxf(m, pr[i]);
  }
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = lane + 32 * i;
    if (e < E) row[e] = expf(__fsub_rn(pr[i], m));
  }
  __syncwarp();
  const float s = sum_in_order(row, E);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = lane + 32 * i;
    pr[i] = e < E ? __fdiv_rn(row[e], s) : -INFINITY;
  }
  unsigned picked = 0;  // bit i: expert lane + 32 i
  for (int r = 0; r < top_k; ++r) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + 32 * i;
      if (e < E && !((picked >> i) & 1u) && pr[i] > bv) {
        bv = pr[i];
        bi = e;
      }
    }
#pragma unroll
    for (int off = 16; off >= 1; off /= 2) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if ((bi & 31) == lane) picked |= 1u << (bi >> 5);
  }
  // each value below is written to row, then summed in expert order by
  // every lane; a __syncwarp on each side of a write
  auto sum_of = [&](const float* v) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + 32 * i;
      if (e < E) row[e] = v[i];
    }
    __syncwarp();
    return sum_in_order(row, E);
  };
  float t[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) t[i] = (picked >> i) & 1u ? pr[i] : 0.f;
  const float den = fmaxf(sum_of(t), 1e-9f);
  float dgv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = lane + 32 * i;
    dgv[i] = e < E ? dg[e] : 0.f;
    // the gate, as the forward divides it
    const float g = __fdiv_rn((picked >> i) & 1u ? pr[i] : 0.f, den);
    t[i] = __fmul_rn(dgv[i], g);
  }
  const float c1 = sum_of(t);
  float dp[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    dp[i] = (picked >> i) & 1u ? __fdiv_rn(__fsub_rn(dgv[i], c1), den) : 0.f;
    t[i] = __fmul_rn(dp[i], pr[i]);
  }
  const float c2 = sum_of(t);
#pragma unroll
  for (int i = 0; i < kPer; ++i) t[i] = __fmul_rn(pr[i], __fsub_rn(dp[i], c2));
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = lane + 32 * i;
    if (e < E) {
      row[e] = t[i];
      out[e] = t[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_routing_bwd_token_kernel(const T* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ dg,
                             T* __restrict__ dx, float* __restrict__ dlogits,
                             int n_tok, int D, int E, int top_k) {
  __shared__ __align__(16) float stage[kStageFloats];
  __shared__ float rows[kTok * kMaxE];  // [kTok][E]: logits, then dlogits
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tok0 = blockIdx.x * kTok;

  // 1. the logits, in the forward's order
  float* sw = stage;                   // W[d0 + r][e0 + c] at r kWStride + c
  float* sx = stage + kDT * kWStride;  // x[tok0 + t][d0 + r] at t kDT + r
  float acc[kTokPerWarp][kET];
  for (int e0 = 0; e0 < E; e0 += kET) {
#pragma unroll
    for (int tk = 0; tk < kTokPerWarp; ++tk)
#pragma unroll
      for (int c = 0; c < kET; ++c) acc[tk][c] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDT) {
      __syncthreads();  // the previous tile is summed
      for (int i = threadIdx.x; i < kDT * kET; i += kThreads) {
        const int r = i / kET, c = i % kET, d = d0 + r, e = e0 + c;
        sw[r * kWStride + c] =
            d < D && e < E ? w[static_cast<size_t>(d) * E + e] : 0.f;
      }
      for (int i = threadIdx.x; i < kTok * kDT; i += kThreads) {
        const int tk = i / kDT, r = i % kDT, t = tok0 + tk, d = d0 + r;
        sx[i] = t < n_tok && d < D
                    ? load1(x[static_cast<size_t>(t) * D + d])
                    : 0.f;  // a zero product leaves a chain as it is
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kDT / 32; ++j) {
        const int r = lane + 32 * j;
        float wv[kET], xv[kTokPerWarp];
#pragma unroll
        for (int c = 0; c < kET; c += 4) {
          const float4 q =
              *reinterpret_cast<const float4*>(sw + r * kWStride + c);
          wv[c] = q.x;
          wv[c + 1] = q.y;
          wv[c + 2] = q.z;
          wv[c + 3] = q.w;
        }
#pragma unroll
        for (int tk = 0; tk < kTokPerWarp; ++tk)
          xv[tk] = sx[(warp * kTokPerWarp + tk) * kDT + r];
#pragma unroll
        for (int tk = 0; tk < kTokPerWarp; ++tk)
#pragma unroll
          for (int c = 0; c < kET; ++c)
            acc[tk][c] = __fadd_rn(acc[tk][c], __fmul_rn(xv[tk], wv[c]));
      }
    }
#pragma unroll
    for (int tk = 0; tk < kTokPerWarp; ++tk) {
#pragma unroll
      for (int c = 0; c < kET; ++c) {
        float v = acc[tk][c];
#pragma unroll
        for (int off = 16; off >= 1; off /= 2)
          v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
        if (lane == c && e0 + c < E)
          rows[(warp * kTokPerWarp + tk) * E + e0 + c] = v;
      }
    }
  }
  __syncwarp();  // a warp's rows are written and read by that warp only

  // 2. route each token and form its dlogits (zeros for absent tokens)
  for (int tk = 0; tk < kTokPerWarp; ++tk) {
    const int tl = warp * kTokPerWarp + tk, t = tok0 + tl;
    float* row = rows + tl * E;
    if (t < n_tok) {
      token_backward(row, dg + static_cast<size_t>(t) * E,
                     dlogits + static_cast<size_t>(t) * E, E, top_k, lane);
    } else {
      for (int e = lane; e < E; e += 32) row[e] = 0.f;
    }
  }

  // 3. dx[t][d] = sum_e dlogits[t][e] W[d][e] in expert order: thread i
  // owns row d0 + i of each block of kXT rows, W staged kET experts at a time
  float* sx3 = stage;  // W[d0 + r][e0 + c] at r kXStride + c
  for (int d0 = 0; d0 < D; d0 += kXT) {
    float a[kTok];
#pragma unroll
    for (int tk = 0; tk < kTok; ++tk) a[tk] = 0.f;
    for (int e0 = 0; e0 < E; e0 += kET) {
      __syncthreads();  // rows are final; the previous tile is summed
      for (int i = threadIdx.x; i < kXT * kET; i += kThreads) {
        const int r = i / kET, c = i % kET, d = d0 + r, e = e0 + c;
        sx3[r * kXStride + c] =
            d < D && e < E ? w[static_cast<size_t>(d) * E + e] : 0.f;
      }
      __syncthreads();
      const int ne = min(kET, E - e0);
#pragma unroll
      for (int c = 0; c < kET; ++c) {
        if (c < ne) {  // uniform over the CTA
          const float wv = sx3[threadIdx.x * kXStride + c];
#pragma unroll
          for (int tk = 0; tk < kTok; ++tk)
            a[tk] = __fadd_rn(a[tk], __fmul_rn(rows[tk * E + e0 + c], wv));
        }
      }
    }
    const int d = d0 + threadIdx.x;
    if (d < D) {
#pragma unroll
      for (int tk = 0; tk < kTok; ++tk)
        if (tok0 + tk < n_tok)
          store1(dx + static_cast<size_t>(tok0 + tk) * D + d, a[tk]);
    }
  }
}

// dW over one chunk of tokens: grid (D / kWD, E / kWE, chunks), rounded up
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_routing_bwd_dw_kernel(const T* __restrict__ x,
                          const float* __restrict__ dlogits,
                          float* __restrict__ out, int n_tok, int D, int E) {
  __shared__ float sx[kWT * kWD];                  // x[t0 + j][d0 + r]
  __shared__ __align__(16) float sd[kWT * kWE];    // dlogits[t0 + j][e0 + c]
  const int d0 = blockIdx.x * kWD, e0 = blockIdx.y * kWE;
  const int t_begin = blockIdx.z * kChunk;
  const int t_end = min(n_tok, t_begin + kChunk);
  const int r = threadIdx.x / (kWE / 4), q = 4 * (threadIdx.x % (kWE / 4));
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = t_begin; t0 < t_end; t0 += kWT) {
    __syncthreads();  // the previous tile is summed
    for (int i = threadIdx.x; i < kWT * kWD; i += kThreads) {
      const int j = i / kWD, c = i % kWD, t = t0 + j, d = d0 + c;
      sx[i] = t < t_end && d < D ? load1(x[static_cast<size_t>(t) * D + d])
                                 : 0.f;  // zero products change no sum
    }
    for (int i = threadIdx.x; i < kWT * kWE; i += kThreads) {
      const int j = i / kWE, c = i % kWE, t = t0 + j, e = e0 + c;
      sd[i] = t < t_end && e < E ? dlogits[static_cast<size_t>(t) * E + e]
                                 : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kWT; ++j) {
      const float xv = sx[j * kWD + r];
      const float4 g = *reinterpret_cast<const float4*>(sd + j * kWE + q);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(xv, g.x));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(xv, g.y));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(xv, g.z));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(xv, g.w));
    }
  }
  const int d = d0 + r;
  if (d >= D) return;
  float* o = out + static_cast<size_t>(blockIdx.z) * D * E +
             static_cast<size_t>(d) * E;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e0 + q + k < E) o[e0 + q + k] = acc[k];
}

// dW = the chunks' partials added in chunk order, from 0
__global__ void __launch_bounds__(kThreads)
moe_routing_bwd_merge_kernel(const float* __restrict__ partial,
                             float* __restrict__ dw, int n_chunks,
                             size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s = __fadd_rn(s, partial[c * n + i]);
  dw[i] = s;
}

template <typename T>
int route_bwd(const void* x, const float* w, const float* dg, void* dx,
              float* dw, float* dlogits, float* partial, int n_tok, int D,
              int E, int top_k, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  moe_routing_bwd_token_kernel<T><<<(n_tok + kTok - 1) / kTok, kThreads, 0,
                                    stream>>>(
      xt, w, dg, static_cast<T*>(dx), dlogits, n_tok, D, E, top_k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || D == 0) return static_cast<int>(err);
  const int n_chunks = (n_tok + kChunk - 1) / kChunk;
  const dim3 grid((D + kWD - 1) / kWD, (E + kWE - 1) / kWE, n_chunks);
  moe_routing_bwd_dw_kernel<T><<<grid, kThreads, 0, stream>>>(
      xt, dlogits, n_chunks == 1 ? dw : partial, n_tok, D, E);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(D) * E;
  moe_routing_bwd_merge_kernel<<<static_cast<unsigned>((n + kThreads - 1) /
                                                       kThreads),
                                 kThreads, 0, stream>>>(partial, dw, n_chunks,
                                                        n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [T, D] (dtype 0: f32, 1: bf16), w [D, E] f32, dg [T, E] f32 -> dx [T, D]
// in x's dtype, dw [D, E] f32; dlogits [T, E] f32 and, where T > kChunk,
// partial [ceil(T / kChunk), D, E] f32 are scratch.  Launches on ``stream``
// and returns a CUDA error code.
extern "C" int synergai_moe_routing_bwd(const void* x, const float* w,
                                        const float* dg, void* dx, float* dw,
                                        float* dlogits, float* partial,
                                        int dtype, int T, int D, int E,
                                        int top_k, cudaStream_t stream) {
  if (T <= 0 || D < 0 || E < 1 || E > kMaxE || top_k < 1 || top_k > E ||
      (T > kChunk && D > 0 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return route_bwd<float>(x, w, dg, dx, dw, dlogits, partial, T, D, E,
                            top_k, stream);
  if (dtype == 1)
    return route_bwd<__nv_bfloat16>(x, w, dg, dx, dw, dlogits, partial, T, D,
                                    E, top_k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int synergai_moe_routing_bwd_chunk() { return kChunk; }

extern "C" const char* synergai_moe_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
