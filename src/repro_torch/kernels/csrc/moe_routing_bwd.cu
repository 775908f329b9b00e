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
//   moe_routing_bwd_token_kernel: 32 tokens a CTA where E <= 16, else 16.
//     It recomputes the logits in the forward kernel's order (lane l of a
//     warp sums the chain d = l, l + 32, ... in increasing d, each product
//     rounded, then the xor-shuffle tree over the 32 chains), so probs and
//     the top-k picks are the forward's bit for bit: as the forward's
//     prefill design, lane l owns chain l of 4 tokens x 16 experts, W and x
//     tiles of 256 rows staged by cp.async into a ring of 3 (two in flight
//     while one is summed, one barrier a tile), the next row's loads issued
//     before this row's adds.  Where E > 16 the warps split into two
//     halves, each taking 16 experts of a 32-expert tile, so that a CTA of
//     16 tokens keeps 4 tokens a lane (at deepseek-v2's T = 2,048, 128
//     CTAs).  A warp then routes its tokens as route_token does and forms
//     dlogits (kept in shared memory, rows padded to a multiple of 4, and
//     written to a [T, E] f32 scratch); last, thread i owns rows d = i, i +
//     256, ... of dx for the CTA's tokens, reading its row of W four experts
//     at a time (16-byte loads, the next four in flight) and the tokens'
//     dlogits as float4s.
//   moe_routing_bwd_dw_kernel: a CTA owns 256 rows d x 16 experts of one
//     chunk of kChunk tokens, thread (4 rows, 4 experts) summing x[t][d]
//     dlogits[t][e] in increasing t (tiles of 32 tokens staged by cp.async
//     into a ring of 3), into dW where there is one chunk, else into
//     partial[chunk][d][e].
//   moe_routing_bwd_merge_kernel: dW = the chunks' partials added in chunk
//     order, from 0.  (0 + p is p: a sum that starts at +0.0 is never -0.0.)
//
// Bound.  Bytes: x read, W read, dg read, dx written, dW written; operations
// 3 x 2 T D E (the logits again, dx, dW), f32 without fused multiply-adds
// (bit parity rules them out, as in the forward).  At phi3.5-moe's training
// shape [T, D, E] = [8192, 4096, 16] with bf16 x that is 134 MB and 3.2
// GFLOP; at deepseek-v2's [2048, 5120, 160] it is 10 GFLOP.  The first
// design staged every tile with plain loads between two barriers and read
// one dlogit from shared memory a product (PERF.md, PR 27: 9-13x its bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 256;
constexpr int kPer = kMaxE / 32;   // experts per lane in routing
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;  // every kernel's CTA
constexpr int kStages = 3;         // tiles in a ring

// the token kernel
constexpr int kTokPerLane = 4;     // tokens a lane sums a chain for
constexpr int kEL = 16;            // experts a lane sums a chain for
constexpr int kDT = 256;           // rows of W and x a logits tile

// the dW kernels
constexpr int kChunk = 512;        // tokens a chunk (a partial of dW)
constexpr int kWD = 256;           // rows d a CTA, 4 a thread
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
// four adjacent elements, widened to f32
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x;
  out[1] = q.y;
  out[2] = q.z;
  out[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(q.x << 16);
  out[1] = __uint_as_float(q.x & 0xffff0000u);
  out[2] = __uint_as_float(q.y << 16);
  out[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N commit groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ---------------------------------------------------------------------------
// the token kernel: EG expert groups of 16 a tile (1 where E <= 16, else 2)

template <typename T, int EG>
struct Tok {
  static constexpr int TQ = kWarps / EG;       // token quads a CTA
  static constexpr int TOK = TQ * kTokPerLane; // tokens a CTA
  static constexpr int ET = kEL * EG;          // experts a tile
  static constexpr int WS = ET + 4;            // a staged W row, padded
  struct Stage {
    float w[kDT * WS];  // W[d0 + r][e0 + c] at r * WS + c
    T x[TOK * kDT];     // x[tok0 + t][d0 + r] at t * kDT + r
  };
  // shared bytes: the ring and the rows of logits / dlogits [TOK][Ep]
  static size_t smem(int E) {
    return kStages * sizeof(Stage) + static_cast<size_t>(TOK) *
                                         ((E + 3) / 4 * 4) * sizeof(float);
  }
};

// Stage tile (e0, d0): W rows d0 .. d0 + kDT of experts e0 .. e0 + ET, and
// the CTA's x rows over the same d; zeros past D, E and n_tok (a zero x
// times a zero w adds +0.0, which leaves a chain's sum as it is: a sum
// that starts at +0.0 is never -0.0).
template <typename T, int EG>
__device__ void stage_logits(typename Tok<T, EG>::Stage& s,
                             const T* __restrict__ x,
                             const float* __restrict__ w, int tok0,
                             int n_tok, int D, int E, int e0, int d0,
                             bool wvec, bool xvec) {
  using C = Tok<T, EG>;
  constexpr int kXVec = 16 / sizeof(T);  // x elements a 16-byte copy
  for (int i = threadIdx.x; i < kDT * (C::ET / 4); i += kThreads) {
    const int r = i / (C::ET / 4), c = 4 * (i % (C::ET / 4));
    const int d = d0 + r, e = e0 + c;
    float* dst = s.w + r * C::WS + c;
    if (wvec && d < D && e + 3 < E) {
      cp_async16(dst, w + static_cast<size_t>(d) * E + e);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = (d < D && e + j < E) ? w[static_cast<size_t>(d) * E + e + j]
                                      : 0.f;
    }
  }
  for (int i = threadIdx.x; i < C::TOK * (kDT / kXVec); i += kThreads) {
    const int t = i / (kDT / kXVec), c = kXVec * (i % (kDT / kXVec));
    const int tok = tok0 + t, d = d0 + c;
    T* dst = s.x + t * kDT + c;
    const T* src = x + static_cast<size_t>(tok) * D + d;
    if (xvec && tok < n_tok && d + kXVec - 1 < D) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int j = 0; j < kXVec; ++j)
        dst[j] = (tok < n_tok && d + j < D) ? src[j] : T(0.f);
    }
  }
}

template <typename T, int EG>
__global__ void __launch_bounds__(kThreads, 1)
moe_routing_bwd_token_kernel(const T* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ dg,
                             T* __restrict__ dx, float* __restrict__ dlogits,
                             int n_tok, int D, int E, int top_k, int wvec,
                             int xvec) {
  using C = Tok<T, EG>;
  constexpr int TOK = C::TOK;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* stage = reinterpret_cast<typename C::Stage*>(smem);
  const int Ep = (E + 3) / 4 * 4;                 // a row's stride
  float* rows = reinterpret_cast<float*>(stage + kStages);  // [TOK][Ep]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tq = warp % C::TQ, eg = warp / C::TQ;  // token quad, experts
  const int tok0 = blockIdx.x * TOK;

  // 1. the logits, in the forward's order.  D = 0 takes one tile of
  // zeros: every logit is 0, as in the plain version
  const int n_dt = max(1, (D + kDT - 1) / kDT), n_et = (E + C::ET - 1) / C::ET;
  const int n_tiles = n_dt * n_et;  // tile c: expert tile c / n_dt
  float acc[kTokPerLane][kEL];
#pragma unroll
  for (int tk = 0; tk < kTokPerLane; ++tk)
#pragma unroll
    for (int e = 0; e < kEL; ++e) acc[tk][e] = 0.f;
  auto stage_tile = [&](int c) {  // one commit group a tile, empty past
    if (c < n_tiles)
      stage_logits<T, EG>(stage[c % kStages], x, w, tok0, n_tok, D, E,
                          C::ET * (c / n_dt), kDT * (c % n_dt), wvec != 0,
                          xvec != 0);
    cp_async_commit();
  };
  for (int c = 0; c < kStages - 1; ++c) stage_tile(c);
  for (int c = 0; c < n_tiles; ++c) {
    cp_async_wait<kStages - 2>();  // tile c is in
    __syncthreads();       // ... for every thread; tile c - 1 is summed
    stage_tile(c + kStages - 1);  // into tile c - 1's buffer
    const typename C::Stage& s = stage[c % kStages];
    const T* xw = s.x + tq * kTokPerLane * kDT;
    const float* ww = s.w + eg * kEL;
    // row r = lane + 32 i of the tile; the next row's W and x are loaded
    // into registers while this one is summed
    float wv[2][kEL], xv[2][kTokPerLane];
    auto load_row = [&](int i, float* wr, float* xr) {
      const int r = lane + 32 * i;
#pragma unroll
      for (int e = 0; e < kEL; e += 4) load4(ww + r * C::WS + e, wr + e);
#pragma unroll
      for (int tk = 0; tk < kTokPerLane; ++tk)
        xr[tk] = load1(xw[tk * kDT + r]);
    };
    load_row(0, wv[0], xv[0]);
#pragma unroll
    for (int i = 0; i < kDT / 32; ++i) {
      if (i + 1 < kDT / 32) load_row(i + 1, wv[(i + 1) & 1], xv[(i + 1) & 1]);
#pragma unroll
      for (int tk = 0; tk < kTokPerLane; ++tk)
#pragma unroll
        for (int e = 0; e < kEL; ++e)
          acc[tk][e] = __fadd_rn(acc[tk][e],
                                 __fmul_rn(xv[i & 1][tk], wv[i & 1][e]));
    }
    if ((c + 1) % n_dt == 0) {  // the expert tile's chains are summed
      const int e0 = C::ET * (c / n_dt) + kEL * eg;
#pragma unroll
      for (int tk = 0; tk < kTokPerLane; ++tk) {
#pragma unroll
        for (int e = 0; e < kEL; ++e) {
          float v = acc[tk][e];
#pragma unroll
          for (int off = 16; off >= 1; off /= 2)
            v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
          if (lane == e && e0 + e < E)
            rows[(tq * kTokPerLane + tk) * Ep + e0 + e] = v;
          acc[tk][e] = 0.f;
        }
      }
    }
  }
  __syncthreads();  // every expert of every token's row is written

  // 2. route each token and form its dlogits (zeros for absent tokens)
  for (int tl = warp; tl < TOK; tl += kWarps) {
    const int t = tok0 + tl;
    float* row = rows + tl * Ep;
    if (t < n_tok) {
      token_backward(row, dg + static_cast<size_t>(t) * E,
                     dlogits + static_cast<size_t>(t) * E, E, top_k, lane);
    } else {
      for (int e = lane; e < E; e += 32) row[e] = 0.f;
    }
  }
  __syncthreads();  // the dlogits rows are final

  // 3. dx[t][d] = sum_e dlogits[t][e] W[d][e] in expert order: thread i
  // owns row d0 + i of each block of kThreads rows, reading its W row four
  // experts at a time (the next four in flight) and each token's dlogits
  // as a float4
  const int n_valid = min(TOK, n_tok - tok0);
  for (int d0 = 0; d0 < D; d0 += kThreads) {
    const int d = d0 + threadIdx.x;
    if (d >= D) break;
    const float* wr = w + static_cast<size_t>(d) * E;
    float a[TOK];
#pragma unroll
    for (int tk = 0; tk < TOK; ++tk) a[tk] = 0.f;
    int e = 0;
    if (wvec) {
      float4 wn = __ldg(reinterpret_cast<const float4*>(wr));
      for (; e + 4 <= E; e += 4) {
        const float4 wc = wn;
        if (e + 8 <= E) wn = __ldg(reinterpret_cast<const float4*>(wr + e + 4));
#pragma unroll
        for (int tk = 0; tk < TOK; ++tk) {
          const float4 dl = *reinterpret_cast<const float4*>(rows + tk * Ep +
                                                            e);
          a[tk] = __fadd_rn(a[tk], __fmul_rn(dl.x, wc.x));
          a[tk] = __fadd_rn(a[tk], __fmul_rn(dl.y, wc.y));
          a[tk] = __fadd_rn(a[tk], __fmul_rn(dl.z, wc.z));
          a[tk] = __fadd_rn(a[tk], __fmul_rn(dl.w, wc.w));
        }
      }
    }
    for (; e < E; ++e) {
      const float wv = wr[e];
#pragma unroll
      for (int tk = 0; tk < TOK; ++tk)
        a[tk] = __fadd_rn(a[tk], __fmul_rn(rows[tk * Ep + e], wv));
    }
#pragma unroll
    for (int tk = 0; tk < TOK; ++tk)
      if (tk < n_valid)
        store1(dx + static_cast<size_t>(tok0 + tk) * D + d, a[tk]);
  }
}

// ---------------------------------------------------------------------------
// dW over one chunk of tokens: grid (D / kWD, E / kWE, chunks), rounded up

template <typename T>
struct DwStage {
  T x[kWT * kWD];      // x[t0 + j][d0 + c] at j * kWD + c
  float g[kWT * kWE];  // dlogits[t0 + j][e0 + c] at j * kWE + c
};

// Stage the tokens t0 .. t0 + kWT of the chunk (zeros from t_end on, and
// past D and E: zero products change no sum)
template <typename T>
__device__ void stage_dw(DwStage<T>& s, const T* __restrict__ x,
                         const float* __restrict__ dlogits, int t0,
                         int t_end, int d0, int e0, int D, int E, bool xvec,
                         bool gvec) {
  constexpr int kXVec = 16 / sizeof(T);
  for (int i = threadIdx.x; i < kWT * (kWD / kXVec); i += kThreads) {
    const int j = i / (kWD / kXVec), c = kXVec * (i % (kWD / kXVec));
    const int t = t0 + j, d = d0 + c;
    T* dst = s.x + j * kWD + c;
    const T* src = x + static_cast<size_t>(t) * D + d;
    if (xvec && t < t_end && d + kXVec - 1 < D) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int q = 0; q < kXVec; ++q)
        dst[q] = (t < t_end && d + q < D) ? src[q] : T(0.f);
    }
  }
  for (int i = threadIdx.x; i < kWT * (kWE / 4); i += kThreads) {
    const int j = i / (kWE / 4), c = 4 * (i % (kWE / 4));
    const int t = t0 + j, e = e0 + c;
    float* dst = s.g + j * kWE + c;
    const float* src = dlogits + static_cast<size_t>(t) * E + e;
    if (gvec && t < t_end && e + 3 < E) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[q] = (t < t_end && e + q < E) ? src[q] : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_routing_bwd_dw_kernel(const T* __restrict__ x,
                          const float* __restrict__ dlogits,
                          float* __restrict__ out, int n_tok, int D, int E,
                          int xvec, int gvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* stage = reinterpret_cast<DwStage<T>*>(smem);
  const int d0 = blockIdx.x * kWD, e0 = blockIdx.y * kWE;
  const int t_begin = blockIdx.z * kChunk;
  const int t_end = min(n_tok, t_begin + kChunk);
  const int n_tiles = (t_end - t_begin + kWT - 1) / kWT;
  const int r = 4 * (threadIdx.x / (kWE / 4));  // rows r .. r + 3
  const int q = 4 * (threadIdx.x % (kWE / 4));  // experts q .. q + 3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  auto stage_tile = [&](int c) {  // one commit group a tile, empty past
    if (c < n_tiles)
      stage_dw(stage[c % kStages], x, dlogits, t_begin + c * kWT, t_end, d0,
               e0, D, E, xvec != 0, gvec != 0);
    cp_async_commit();
  };
  for (int c = 0; c < kStages - 1; ++c) stage_tile(c);
  for (int c = 0; c < n_tiles; ++c) {
    cp_async_wait<kStages - 2>();  // tile c is in
    __syncthreads();       // ... for every thread; tile c - 1 is summed
    stage_tile(c + kStages - 1);  // into tile c - 1's buffer
    const DwStage<T>& s = stage[c % kStages];
#pragma unroll 8
    for (int j = 0; j < kWT; ++j) {
      float xv[4], gv[4];
      load4(s.x + j * kWD + r, xv);
      load4(s.g + j * kWE + q, gv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[i][k] = __fadd_rn(acc[i][k], __fmul_rn(xv[i], gv[k]));
    }
  }
  float* o = out + static_cast<size_t>(blockIdx.z) * D * E;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + r + i;
    if (d >= D) break;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e0 + q + k < E)
        o[static_cast<size_t>(d) * E + e0 + q + k] = acc[i][k];
  }
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

// opt a kernel in to `bytes` of dynamic shared memory (once a kernel)
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc != cudaSuccess) {
    cudaGetLastError();  // not left behind for the next launch's check
    return rc;
  }
  done = true;
  return cudaSuccess;
}

template <typename T, int EG>
cudaError_t launch_token(const T* x, const float* w, const float* dg, T* dx,
                         float* dlogits, int n_tok, int D, int E, int top_k,
                         bool wvec, bool xvec, cudaStream_t stream) {
  using C = Tok<T, EG>;
  static bool configured = false;
  const cudaError_t rc = allow_smem(moe_routing_bwd_token_kernel<T, EG>,
                                    C::smem(kMaxE), configured);
  if (rc != cudaSuccess) return rc;
  moe_routing_bwd_token_kernel<T, EG>
      <<<(n_tok + C::TOK - 1) / C::TOK, kThreads, C::smem(E), stream>>>(
          x, w, dg, dx, dlogits, n_tok, D, E, top_k, wvec ? 1 : 0,
          xvec ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
int route_bwd(const void* x, const float* w, const float* dg, void* dx,
              float* dw, float* dlogits, float* partial, int n_tok, int D,
              int E, int top_k, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  // 16-byte copies need 16-byte aligned rows: of W (E % 4 == 0), of x
  // (D a multiple of a copy's elements) and of dlogits (E % 4 == 0)
  const bool wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && E % 4 == 0;
  const bool xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    D % static_cast<int>(16 / sizeof(T)) == 0;
  const bool gvec = reinterpret_cast<uintptr_t>(dlogits) % 16 == 0 &&
                    E % 4 == 0;
  cudaError_t err =
      E <= kEL ? launch_token<T, 1>(xt, w, dg, static_cast<T*>(dx), dlogits,
                                    n_tok, D, E, top_k, wvec, xvec, stream)
               : launch_token<T, 2>(xt, w, dg, static_cast<T*>(dx), dlogits,
                                    n_tok, D, E, top_k, wvec, xvec, stream);
  if (err != cudaSuccess || D == 0) return static_cast<int>(err);
  static bool dw_configured = false;
  err = allow_smem(moe_routing_bwd_dw_kernel<T>,
                   kStages * sizeof(DwStage<T>), dw_configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (n_tok + kChunk - 1) / kChunk;
  const dim3 grid((D + kWD - 1) / kWD, (E + kWE - 1) / kWE, n_chunks);
  moe_routing_bwd_dw_kernel<T><<<grid, kThreads,
                                 kStages * sizeof(DwStage<T>), stream>>>(
      xt, dlogits, n_chunks == 1 ? dw : partial, n_tok, D, E, xvec ? 1 : 0,
      gvec ? 1 : 0);
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
