// MoE top-k routing for Hopper (sm_90a): router logits, softmax, top-k
// mask and renormalized gates in one kernel.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/moe_routing.py:_routing_kernel (moe_routing)
// with the top-k semantics of repro/models/layers.py:_route_grouped, which is
// what the model runs.  For each token t, in f32:
//   logits[e] = sum_d x[t][d] * W[d][e]
//   p[e]      = expf(logits[e] - max_e logits),  probs[e] = p[e] / sum_e p[e]
//   k rounds of a first-index argmax over probs, the pick set to -1 (so a
//   probability that underflowed to 0 is picked too, as lax.top_k picks it;
//   the Pallas kernel skips probabilities <= 0)
//   sel[e]    = probs[e] at the k picks, else 0
//   gates[e]  = sel[e] / max(sum_e sel[e], 1e-9),  mask[e] = 1 at the picks
// Unlike the TPU kernel it takes any T (a ragged tail is masked, where the
// Pallas wrapper asserts T % bt == 0), any D, E <= 256 and 1 <= k <= E, and
// it returns the mask as well as the gates: the dispatch of moe_ffn needs
// the mask, and gates > 0 is not the mask where a probability underflowed.
//
// Design (simple first).  A CTA of 8 warps owns 16 tokens, 2 per warp.
// Phase 1, the logits: for each tile of 16 experts, the CTA stages W in
// tiles of 256 rows in shared memory (rows padded to 20 floats, so the four
// float4 reads of a row are free of bank conflicts); lane l of a warp sums
// the products for d = l, l + 32, l + 64, ... in increasing d, one
// accumulator per (token, expert); the 32 lane partials are then summed by
// an xor-shuffle tree (offsets 16, 8, 4, 2, 1), and the logits go to shared
// memory.  Phase 2, per token, one warp: the max by shuffles, expf, the
// softmax sum in expert-index order, the divides, k shuffle argmax rounds
// (ties to the lower index), the sum of the selected probabilities in
// expert-index order, and the gates and mask written out.
//
// Rounding.  Every f32 operation is one of moe_routing_plain's, in its
// order, as explicit __fmul_rn / __fadd_rn / __fdiv_rn under --fmad=false,
// with expf (not __expf) as torch.exp computes it on the card; so the
// kernel and its plain version give the same gates and mask bit for bit.
// That matters: an expert's capacity slots are a cumsum over the tokens of
// a group, so one routing flip moves every later token of the group, and
// the random-weight models of this repository amplify such differences
// over their layers (PERF.md, Findings).
//
// Bound.  Bytes: x read once (T*D of its dtype), W (D*E f32), gates and
// mask written (2*T*E f32); operations 2*T*D*E.  At the phi3.5-moe prefill
// [T, D, E] = [4096, 4096, 16] with bf16 x that is 34.4 MB, 0.0103 ms at
// 3.35 TB/s, against 0.54 GFLOP, 0.008 ms at the f32 peak (67 TFLOP/s;
// --fmad=false issues the multiply and the add apart, which doubles that
// floor).  This design misses it: on an H100 (700 W) it takes 0.142 ms at
// that shape, 7 % of the bound, with 16 accumulators per token and lane,
// each product a separate multiply and add, W re-read from shared memory
// per token pair.  A decode step [4, 4096, 16] is one CTA that stages W's
// 16 tiles one after another: 0.079 ms, latency-bound (PERF.md).  More
// CTAs for few tokens, tensor cores, TMA and a fused dispatch are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTokPerWarp = 2;
constexpr int kTok = kWarps * kTokPerWarp;  // tokens per CTA
constexpr int kET = 16;                     // experts per tile
constexpr int kDT = 256;                    // rows of W per staged tile
constexpr int kWStride = kET + 4;           // padded row of a staged tile
constexpr int kMaxE = 256;
constexpr int kPer = kMaxE / 32;            // experts per lane in phase 2
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);  // exact: a bf16 is the top half of an f32
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_routing_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ gates, float* __restrict__ mask,
                   int n_tok, int D, int E, int top_k) {
  __shared__ __align__(16) float ws[kDT * kWStride];
  __shared__ float rows[kTok][kMaxE];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tok0 = blockIdx.x * kTok + warp * kTokPerWarp;

  // phase 1: the logits, one expert tile at a time
  for (int e0 = 0; e0 < E; e0 += kET) {
    float acc[kTokPerWarp][kET];
#pragma unroll
    for (int tk = 0; tk < kTokPerWarp; ++tk)
#pragma unroll
      for (int e = 0; e < kET; ++e) acc[tk][e] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kDT) {
      __syncthreads();  // every warp is done with the previous tile
      for (int i = threadIdx.x; i < kDT * kET; i += kThreads) {
        const int r = i / kET, c = i % kET;
        const int d = d0 + r, e = e0 + c;
        ws[r * kWStride + c] =
            (d < D && e < E) ? w[static_cast<size_t>(d) * E + e] : 0.f;
      }
      __syncthreads();
      const int n = min(kDT, D - d0);
      for (int dl = lane; dl < n; dl += 32) {
        float wv[kET];
#pragma unroll
        for (int c = 0; c < kET; c += 4) {
          const float4 q =
              *reinterpret_cast<const float4*>(ws + dl * kWStride + c);
          wv[c] = q.x;
          wv[c + 1] = q.y;
          wv[c + 2] = q.z;
          wv[c + 3] = q.w;
        }
#pragma unroll
        for (int tk = 0; tk < kTokPerWarp; ++tk) {
          const int t = tok0 + tk;
          if (t < n_tok) {
            const float xv = load1(x + static_cast<size_t>(t) * D + d0 + dl);
#pragma unroll
            for (int e = 0; e < kET; ++e)
              acc[tk][e] = __fadd_rn(acc[tk][e], __fmul_rn(xv, wv[e]));
          }
        }
      }
    }
    // the 32 lane partials: a fixed pairwise tree, the same in every lane
#pragma unroll
    for (int tk = 0; tk < kTokPerWarp; ++tk) {
#pragma unroll
      for (int e = 0; e < kET; ++e) {
        float v = acc[tk][e];
#pragma unroll
        for (int off = 16; off >= 1; off /= 2)
          v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
        if (lane == e && e0 + e < E) rows[warp * kTokPerWarp + tk][e0 + e] = v;
      }
    }
  }
  __syncwarp();  // a warp's rows are written and read by that warp only

  // phase 2: softmax, top-k, gates and mask, one token at a time
  for (int tk = 0; tk < kTokPerWarp; ++tk) {
    const int t = tok0 + tk;
    if (t >= n_tok) break;
    float* row = rows[warp * kTokPerWarp + tk];
    float v[kPer];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + 32 * i;
      v[i] = e < E ? row[e] : -INFINITY;
      m = fmaxf(m, v[i]);
    }
#pragma unroll
    for (int off = 16; off >= 1; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + 32 * i;
      if (e < E) row[e] = expf(__fsub_rn(v[i], m));
    }
    __syncwarp();
    float s = 0.f;  // in expert-index order, in every lane alike
    for (int e = 0; e < E; ++e) s = __fadd_rn(s, row[e]);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + 32 * i;
      v[i] = e < E ? __fdiv_rn(row[e], s) : -INFINITY;
    }
    unsigned picked = 0;  // bit i: expert lane + 32 i
    for (int r = 0; r < top_k; ++r) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = lane + 32 * i;
        if (e < E && !((picked >> i) & 1u) && v[i] > bv) {
          bv = v[i];
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
    __syncwarp();  // every lane has read the p row before it is overwritten
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + 32 * i;
      if (e < E) row[e] = ((picked >> i) & 1u) ? v[i] : 0.f;
    }
    __syncwarp();
    float s2 = 0.f;  // the selected probabilities, in expert-index order
    for (int e = 0; e < E; ++e) s2 = __fadd_rn(s2, row[e]);
    const float den = fmaxf(s2, 1e-9f);
    float* g = gates + static_cast<size_t>(t) * E;
    float* mk = mask + static_cast<size_t>(t) * E;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + 32 * i;
      if (e < E) {
        const bool on = (picked >> i) & 1u;
        g[e] = __fdiv_rn(on ? v[i] : 0.f, den);
        mk[e] = on ? 1.f : 0.f;
      }
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  x: [T, D] contiguous device
// tensor (dtype 0 = f32, 1 = bf16); w: [D, E] f32; gates, mask: [T, E] f32.
// Launches one kernel asynchronously on `stream`; returns
// cudaGetLastError().

extern "C" int synergai_moe_routing(const void* x, const float* w,
                                    float* gates, float* mask, int dtype,
                                    int T, int D, int E, int top_k,
                                    cudaStream_t stream) {
  if (T <= 0 || D < 0 || E < 1 || E > kMaxE || top_k < 1 || top_k > E)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (T + kTok - 1) / kTok;
  if (dtype == 0)
    moe_routing_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), w, gates, mask, T, D, E, top_k);
  else if (dtype == 1)
    moe_routing_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), w, gates, mask, T, D, E,
        top_k);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* synergai_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
