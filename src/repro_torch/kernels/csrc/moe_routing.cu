// MoE top-k routing for Hopper (sm_90a): router logits, softmax, top-k
// mask and renormalized gates in one kernel launch.
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
// Rounding, the contract both designs keep.  The logit (t, e) is 32 lane
// chains, chain l the sequential sum over d = l, l + 32, ... in increasing d
// (each product rounded, then added: __fmul_rn, __fadd_rn under
// --fmad=false), then a fixed pairwise tree over the chains (l with l + 16,
// then the same over the halves).  The softmax and gate sums run in expert
// order, with expf (not __expf) as torch.exp computes it on the card.  So
// the kernel and moe_routing_plain give the same gates and mask bit for bit.
// That matters: an expert's capacity slots are a cumsum over the tokens of
// a group, so one routing flip moves every later token of the group, and
// the random-weight models of this repository amplify such differences
// over their layers (PERF.md, Findings).  Work may move between threads and
// CTAs by whole chains; no chain is ever split over d.
//
// Two designs, picked by T: below kDecodeBelow (1,280) the decode design,
// from it the prefill design, where their times at [T, 4096, 16, 2] cross
// (chip_smoke.py phase 2f times both on each side; PERF.md).
//
// Decode (few tokens, moe_routing_kernel_decode).  A cluster of 8 CTAs owns
// up to 8 tokens; CTA r of the cluster owns chains 4r .. 4r + 3 of every
// (token, expert), so it reads the 4 rows d = 32 g + 4 r + (0..3) of every
// group g of 32 rows: 1/8 of W and of x, in 16-byte (W) and 8- or 16-byte
// (x) cp.async copies.  Its slice is cut into chunks that a ring of 4
// keeps in flight, a chunk's buffer refilled once it is summed (the whole
// 40 KB slice at once at the phi3.5 decode shape).  A thread owns an item
// (chain, expert, token pair; 8 items where E > 32) and steps its two
// chains 8 groups at a time, the loads before the adds; absent tokens
// and the groups past D are zeros, so the step has no branch.  The
// partials go to the CTA's shared memory; after cluster.sync(), CTA r
// gathers token r's 32 chains of each expert from the 8 CTAs through
// distributed shared memory, sums them by the tree and routes the token.
//
// Prefill (many tokens, moe_routing_kernel_prefill).  A CTA of 8 warps owns
// 32 tokens; lane l of a warp owns chain l of 4 tokens x 16 experts (64
// accumulators), so each W row read from shared memory (4 float4 loads)
// feeds 128 products, the next row's loads issued before this row's adds.
// x and W tiles of 256 rows are staged by cp.async (16-byte copies where
// aligned) into a ring of 3, two tiles in flight while one is summed, one
// barrier a tile.  E > 16 takes its expert tiles one after another, x's
// tiles staged again for each (from L2): keeping a token block's x for all
// of D would halve the tokens a CTA holds and double the CTAs that read
// all of W.  The 32 chains are summed by an xor-shuffle tree; one warp
// routes a token.
//
// Bound.  Bytes: x read once (T*D of its dtype), W (D*E f32), gates and
// mask written (2*T*E f32); operations 2*T*D*E.  At the phi3.5-moe prefill
// [T, D, E] = [4096, 4096, 16] with bf16 x that is 34.4 MB, 0.0103 ms at
// 3.35 TB/s.  Bit parity forces a separate multiply and add, so 2*T*D*E
// FP32 instructions at 132 SMs x 128 lanes a clock: ~0.016 ms at 1.98 GHz,
// the floor the prefill design is held to.
// A decode step [4, 4096, 16] moves 0.26 MB (0.00009 ms); its floor is the
// card's for one launch, which chip_smoke.py prints beside it.  What is
// left above that floor is latency: the copies in flight, 128 dependent
// steps of each chain, two cluster barriers and one warp's routing.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxE = 256;
constexpr int kPer = kMaxE / 32;            // experts per lane in routing
constexpr unsigned kFull = 0xffffffffu;

// the switch-over: T below it runs the decode design, from it the prefill
constexpr int kDecodeBelow = 1280;

// prefill design
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTokPerWarp = 4;
constexpr int kTok = kWarps * kTokPerWarp;  // tokens per CTA
constexpr int kET = 16;                     // experts per tile
constexpr int kDT = 256;                    // rows of W and x per tile
constexpr int kWStride = kET + 4;           // padded row of a staged W tile
constexpr int kStages = 3;                  // tiles in the prefill's ring

// decode design
constexpr int kCluster = 8;                 // CTAs a cluster
constexpr int kGroupTok = 8;                // tokens a cluster (one a CTA)
constexpr int kChains = 32 / kCluster;      // chains a CTA: 4 rows a group
constexpr int kDecMaxThreads = 512;
constexpr int kTokPerItem = 2;              // tokens a thread sums a chain for
// a thread's items: (chain, expert, token pair), up to 4 x 256 x 4 / 512
constexpr int kDecMaxItems =
    kChains * kMaxE * (kGroupTok / kTokPerItem) / kDecMaxThreads;
constexpr int kGroupUnroll = 8;             // groups a step of a chain
constexpr int kDecStages = 4;               // chunks in the decode's ring
constexpr int kDecStageBytes = 32 * 1024;   // a chunk of W and x rows, at most
constexpr int kSmemMax = 232448;            // a block's shared memory (227 KB)

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

__device__ __forceinline__ float load1(float v) { return v; }
__device__ __forceinline__ float load1(__nv_bfloat16 v) {
  return __bfloat162float(v);  // exact: a bf16 is the top half of an f32
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N commit groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the sum of row[0, E) in index order, from 0 (loads batched 8 at a time)
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

// One warp routes one token whose logits are row[0, E) in shared memory
// (overwritten): softmax, top-k, gates and mask.
__device__ void route_token(float* row, int E, int top_k, float* g,
                            float* mk, int lane) {
  float v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = -INFINITY;
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (32 * i >= E) break;  // uniform: the experts end
    const int e = lane + 32 * i;
    v[i] = e < E ? row[e] : -INFINITY;
    m = fmaxf(m, v[i]);
  }
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (32 * i >= E) break;  // uniform: the experts end
    const int e = lane + 32 * i;
    if (e < E) row[e] = expf(__fsub_rn(v[i], m));
  }
  __syncwarp();
  const float s = sum_in_order(row, E);  // in every lane alike
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (32 * i >= E) break;  // uniform: the experts end
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
    if (32 * i >= E) break;  // uniform: the experts end
    const int e = lane + 32 * i;
    if (e < E) row[e] = ((picked >> i) & 1u) ? v[i] : 0.f;
  }
  __syncwarp();
  // the selected probabilities, in expert-index order
  const float den = fmaxf(sum_in_order(row, E), 1e-9f);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (32 * i >= E) break;  // uniform: the experts end
    const int e = lane + 32 * i;
    if (e < E) {
      const bool on = (picked >> i) & 1u;
      g[e] = __fdiv_rn(on ? v[i] : 0.f, den);
      mk[e] = on ? 1.f : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// prefill: 32 tokens a CTA, 4 tokens x 16 experts a warp lane

template <typename T>
struct PrefillStage {
  float w[kDT * kWStride];  // W[d0 + r][e0 + c] at r * kWStride + c
  T x[kTok * kDT];          // x[tok0 + t][d0 + r] at t * kDT + r
};

// Stage tile (e0, d0): W rows d0 .. d0 + kDT of experts e0 .. e0 + 16, and
// the CTA's x rows over the same d; zeros past D, E and n_tok (a zero x
// times a zero w adds +0.0, which leaves a chain's sum as it is: a sum
// that starts at +0.0 is never -0.0).
template <typename T>
__device__ void stage_prefill(PrefillStage<T>& s, const T* __restrict__ x,
                              const float* __restrict__ w, int tok0,
                              int n_tok, int D, int E, int e0, int d0,
                              bool vec) {
  constexpr int kXVec = 16 / sizeof(T);  // x elements a 16-byte copy
  for (int i = threadIdx.x; i < kDT * (kET / 4); i += kThreads) {
    const int r = i / (kET / 4), c = 4 * (i % (kET / 4));
    const int d = d0 + r, e = e0 + c;
    float* dst = s.w + r * kWStride + c;
    if (vec && d < D && e + 3 < E) {
      cp_async16(dst, w + static_cast<size_t>(d) * E + e);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = (d < D && e + j < E) ? w[static_cast<size_t>(d) * E + e + j]
                                      : 0.f;
    }
  }
  for (int i = threadIdx.x; i < kTok * (kDT / kXVec); i += kThreads) {
    const int t = i / (kDT / kXVec), c = kXVec * (i % (kDT / kXVec));
    const int tok = tok0 + t, d = d0 + c;
    T* dst = s.x + t * kDT + c;
    const T* src = x + static_cast<size_t>(tok) * D + d;
    if (vec && tok < n_tok && d + kXVec - 1 < D) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int j = 0; j < kXVec; ++j)
        dst[j] = (tok < n_tok && d + j < D) ? src[j] : T(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
moe_routing_kernel_prefill(const T* __restrict__ x,
                           const float* __restrict__ w,
                           float* __restrict__ gates,
                           float* __restrict__ mask, int n_tok, int D, int E,
                           int top_k, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  PrefillStage<T>* stage = reinterpret_cast<PrefillStage<T>*>(smem);
  float* rows = reinterpret_cast<float*>(stage + kStages);  // [kTok][E]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tok0 = blockIdx.x * kTok;
  // D = 0 takes one tile of zeros: every logit is 0, as in the plain version
  const int n_dt = max(1, (D + kDT - 1) / kDT), n_et = (E + kET - 1) / kET;
  const int n_tiles = n_dt * n_et;  // tile c: expert tile c / n_dt

  float acc[kTokPerWarp][kET];
#pragma unroll
  for (int tk = 0; tk < kTokPerWarp; ++tk)
#pragma unroll
    for (int e = 0; e < kET; ++e) acc[tk][e] = 0.f;

  auto stage_tile = [&](int c) {  // one commit group a tile, empty past
    if (c < n_tiles)
      stage_prefill(stage[c % kStages], x, w, tok0, n_tok, D, E,
                    kET * (c / n_dt), kDT * (c % n_dt), vec != 0);
    cp_async_commit();
  };
  for (int c = 0; c < kStages - 1; ++c) stage_tile(c);
  for (int c = 0; c < n_tiles; ++c) {
    cp_async_wait<kStages - 2>();  // tile c is in
    __syncthreads();       // ... for every thread; tile c - 1 is summed
    stage_tile(c + kStages - 1);  // into tile c - 1's buffer
    const PrefillStage<T>& s = stage[c % kStages];
    const T* xw = s.x + warp * kTokPerWarp * kDT;
    // row r = lane + 32 i of the tile; the next row's W and x are loaded
    // into registers while this one is summed
    float wv[2][kET], xv[2][kTokPerWarp];
    auto load_row = [&](int i, float* wr, float* xr) {
      const int r = lane + 32 * i;
#pragma unroll
      for (int e = 0; e < kET; e += 4) {
        const float4 q =
            *reinterpret_cast<const float4*>(s.w + r * kWStride + e);
        wr[e] = q.x;
        wr[e + 1] = q.y;
        wr[e + 2] = q.z;
        wr[e + 3] = q.w;
      }
#pragma unroll
      for (int tk = 0; tk < kTokPerWarp; ++tk) xr[tk] = load1(xw[tk * kDT + r]);
    };
    load_row(0, wv[0], xv[0]);
#pragma unroll
    for (int i = 0; i < kDT / 32; ++i) {
      if (i + 1 < kDT / 32) load_row(i + 1, wv[(i + 1) & 1], xv[(i + 1) & 1]);
#pragma unroll
      for (int tk = 0; tk < kTokPerWarp; ++tk)
#pragma unroll
        for (int e = 0; e < kET; ++e)
          acc[tk][e] = __fadd_rn(acc[tk][e],
                                 __fmul_rn(xv[i & 1][tk], wv[i & 1][e]));
    }
    if ((c + 1) % n_dt == 0) {  // the expert tile's chains are summed
      const int e0 = kET * (c / n_dt);
#pragma unroll
      for (int tk = 0; tk < kTokPerWarp; ++tk) {
#pragma unroll
        for (int e = 0; e < kET; ++e) {
          float v = acc[tk][e];
#pragma unroll
          for (int off = 16; off >= 1; off /= 2)
            v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
          if (lane == e && e0 + e < E)
            rows[(warp * kTokPerWarp + tk) * E + e0 + e] = v;
          acc[tk][e] = 0.f;
        }
      }
    }
  }
  __syncwarp();  // a warp's rows are written and read by that warp only

  for (int tk = 0; tk < kTokPerWarp; ++tk) {
    const int t = tok0 + warp * kTokPerWarp + tk;
    if (t >= n_tok) break;
    route_token(rows + (warp * kTokPerWarp + tk) * E, E, top_k,
                gates + static_cast<size_t>(t) * E,
                mask + static_cast<size_t>(t) * E, lane);
  }
}

// ---------------------------------------------------------------------------
// decode: a cluster of 8 CTAs for up to 8 tokens, chains split over the CTAs

// one level of the chains' tree: chain i with chain i + half
template <int half>
__device__ __forceinline__ void tree_level(float* v) {
#pragma unroll
  for (int i = 0; i < half; ++i) v[i] = __fadd_rn(v[i], v[i + half]);
}

// Stage the chunk of groups [g0, g0 + n_groups), padded with zeros to a
// multiple of kGroupUnroll groups: for each group, this CTA's 4 W rows (4E
// f32, contiguous, 16-byte aligned when W is) to ws, and each of the
// cluster's kGroupTok token slots' 4 x values to xs[(g kGroupTok + t) 4];
// zeros past D and in the slots of absent tokens.  A zero x times a zero w
// adds +0.0, which leaves a chain's sum as it is (a sum that starts at +0.0
// is never -0.0), so the chain loop needs no guard.
template <typename T>
__device__ void stage_decode(float* ws, T* xs, const T* __restrict__ x,
                             const float* __restrict__ w, int tok0, int ntg,
                             int D, int E, int rank, int g0, int n_groups,
                             bool vec, int nt) {
  const int n_pad = (n_groups + kGroupUnroll - 1) / kGroupUnroll *
                    kGroupUnroll;
  // copy i = g E + c (E a group), stepped by nt without a division
  const int dg = nt / E, dc = nt % E;
  for (int g = threadIdx.x / E, c = threadIdx.x % E; g < n_pad;
       g += dg, c += dc) {
    if (c >= E) {
      c -= E;
      if (++g >= n_pad) break;
    }
    const int d_row = 32 * (g0 + g) + kChains * rank;  // first of 4 rows
    float* dst = ws + g * 4 * E + 4 * c;
    const size_t off = static_cast<size_t>(d_row) * E + 4 * c;
    if (vec && g < n_groups && d_row + 3 < D) {
      cp_async16(dst, w + off);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d_row + (4 * c + j) / E;
        dst[j] = g < n_groups && d < D ? w[off + j] : 0.f;
      }
    }
  }
  for (int i = threadIdx.x; i < n_pad * kGroupTok; i += nt) {
    const int g = i / kGroupTok, t = i % kGroupTok;
    const int d = 32 * (g0 + g) + kChains * rank;
    T* dst = xs + i * 4;
    const T* src = x + static_cast<size_t>(tok0 + t) * D + d;
    const bool real = g < n_groups && t < ntg;
    if (vec && real && d + 3 < D) {
      if (sizeof(T) == 4)
        cp_async16(dst, src);
      else
        cp_async8(dst, src);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = real && d + j < D ? src[j] : T(0.f);
    }
  }
}

// ITEMS: items a thread, 1 where one each covers them (E <= 32), else
// kDecMaxItems
template <typename T, int ITEMS>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kDecMaxThreads, 1)
moe_routing_kernel_decode(const T* __restrict__ x,
                          const float* __restrict__ w,
                          float* __restrict__ gates,
                          float* __restrict__ mask, int n_tok, int D, int E,
                          int top_k, int vec, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nt = blockDim.x;
  const int tok0 = (blockIdx.x / kCluster) * kGroupTok;
  const int ntg = min(kGroupTok, n_tok - tok0);
  const int n_g = (D + 31) / 32;
  const int n_chunks = (n_g + chunk - 1) / chunk;
  const size_t ws_bytes = static_cast<size_t>(chunk) * 4 * E * 4;
  const size_t xs_bytes = static_cast<size_t>(chunk) * kGroupTok * 4 *
                          sizeof(T);
  const size_t buf_bytes = (ws_bytes + xs_bytes + 15) / 16 * 16;
  float* part = reinterpret_cast<float*>(smem + kDecStages * buf_bytes);
  float* logits = part + kGroupTok * E * 4;  // [E]
  auto ws_of = [&](int b) {
    return reinterpret_cast<float*>(smem + b * buf_bytes);
  };
  auto xs_of = [&](int b) {
    return reinterpret_cast<T*>(smem + b * buf_bytes + ws_bytes);
  };

  // the thread's items j = tid + k nt: pair p = j % (4E) = q E + e (chain
  // 4 rank + q, expert e) and token pair j / (4E); an item whose tokens
  // are absent is skipped (uniform across a warp when 4E % 32 == 0)
  const int n_pairs = kChains * E;
  int p[ITEMS], q[ITEMS], tp[ITEMS];
  bool on[ITEMS];
  float acc[ITEMS][kTokPerItem];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = threadIdx.x + k * nt;
    p[k] = j % n_pairs;
    q[k] = p[k] / E;
    tp[k] = kTokPerItem * (j / n_pairs);
    on[k] = tp[k] < ntg;  // j < n_pairs * kGroupTok / kTokPerItem as well
#pragma unroll
    for (int t = 0; t < kTokPerItem; ++t) acc[k][t] = 0.f;
  }
  auto stage_chunk = [&](int c) {  // one commit group a chunk, empty past
    if (c < n_chunks)
      stage_decode(ws_of(c % kDecStages), xs_of(c % kDecStages), x, w,
                   tok0, ntg,
                   D, E, rank, c * chunk, min(chunk, n_g - c * chunk),
                   vec != 0, nt);
    cp_async_commit();
  };
  // every chunk of the ring in flight at once; a chunk's buffer is staged
  // again once every thread has summed it
#pragma unroll 1
  for (int c = 0; c < kDecStages; ++c) stage_chunk(c);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kDecStages - 1>();
    __syncthreads();  // chunk c is in, for every thread
    const float* ws = ws_of(c % kDecStages);
    const T* xs = xs_of(c % kDecStages);
    const int cg_n = min(chunk, n_g - c * chunk);  // padded by stage_decode
    // kGroupUnroll groups a step, their loads issued before the adds
    for (int g0 = 0; g0 < cg_n; g0 += kGroupUnroll) {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (on[k]) {
          float wv[kGroupUnroll], xv[kGroupUnroll][kTokPerItem];
#pragma unroll
          for (int u = 0; u < kGroupUnroll; ++u) {
            wv[u] = ws[(g0 + u) * 4 * E + p[k]];
#pragma unroll
            for (int t = 0; t < kTokPerItem; ++t)
              xv[u][t] = load1(
                  xs[((g0 + u) * kGroupTok + tp[k] + t) * 4 + q[k]]);
          }
#pragma unroll
          for (int u = 0; u < kGroupUnroll; ++u)
#pragma unroll
            for (int t = 0; t < kTokPerItem; ++t)
              acc[k][t] = __fadd_rn(acc[k][t], __fmul_rn(xv[u][t], wv[u]));
        }
      }
    }
    __syncthreads();  // chunk c is summed: its buffer takes chunk c + 4
    stage_chunk(c + kDecStages);
  }
  // the partials: part[(t E + e) 4 + q], chain 4 rank + q
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (on[k]) {
      const int e = p[k] - q[k] * E;
#pragma unroll
      for (int t = 0; t < kTokPerItem; ++t)
        if (tp[k] + t < ntg) part[((tp[k] + t) * E + e) * 4 + q[k]] = acc[k][t];
    }
  }
  cluster.sync();  // every CTA's partials are in

  // CTA r sums token r's 32 chains of each expert by the tree
  const bool routes = rank < ntg;
  if (routes) {
    for (int e = threadIdx.x; e < E; e += nt) {
      float v[32];
#pragma unroll
      for (int s = 0; s < kCluster; ++s) {
        const float4 q = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, s) + (rank * E + e) * 4);
        v[kChains * s] = q.x;
        v[kChains * s + 1] = q.y;
        v[kChains * s + 2] = q.z;
        v[kChains * s + 3] = q.w;
      }
      tree_level<16>(v);
      tree_level<8>(v);
      tree_level<4>(v);
      tree_level<2>(v);
      tree_level<1>(v);
      logits[e] = v[0];
    }
  }
  cluster.sync();  // no CTA leaves while another reads its partials
  if (routes && threadIdx.x < 32) {
    const size_t t = static_cast<size_t>(tok0 + rank);
    route_token(logits, E, top_k, gates + t * E, mask + t * E, threadIdx.x);
  }
}

template <typename T, int ITEMS>
int launch_decode_items(const T* x, const float* w, float* gates,
                        float* mask, int n_tok, int D, int E, int top_k,
                        bool vec, int chunk, size_t smem, int threads,
                        cudaStream_t stream) {
  // opt in to > 48 KB of shared memory, once a device
  static bool configured[kMaxDevices] = {};
  const int dev = device_slot();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        moe_routing_kernel_decode<T, ITEMS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (rc != cudaSuccess) {
      cudaGetLastError();  // not left behind for the next launch's check
      return static_cast<int>(rc);
    }
    configured[dev] = true;
  }
  const int clusters = (n_tok + kGroupTok - 1) / kGroupTok;
  moe_routing_kernel_decode<T, ITEMS>
      <<<clusters * kCluster, threads, smem, stream>>>(
          x, w, gates, mask, n_tok, D, E, top_k, vec ? 1 : 0, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_decode(const T* x, const float* w, float* gates, float* mask,
                  int n_tok, int D, int E, int top_k, bool vec,
                  cudaStream_t stream) {
  const int n_g = (D + 31) / 32;
  const size_t group_bytes = 4 * E * 4 + kGroupTok * 4 * sizeof(T);
  // a chunk: a quarter of the slice (the ring holds all of it), or what
  // kDecStageBytes holds, in whole steps of kGroupUnroll groups
  const size_t fit = kDecStageBytes / group_bytes / kGroupUnroll;
  const int chunk = kGroupUnroll * static_cast<int>(std::max<size_t>(
      1, std::min<size_t>((n_g + kDecStages * kGroupUnroll - 1) /
                              (kDecStages * kGroupUnroll), fit)));
  const size_t buf_bytes =
      (static_cast<size_t>(chunk) * group_bytes + 15) / 16 * 16;
  const size_t smem = kDecStages * buf_bytes + (kGroupTok * 4 + 1) * E * 4;
  const int items = kChains * E * (kGroupTok / kTokPerItem);
  const int threads =
      std::min(kDecMaxThreads, std::max(64, (items + 31) / 32 * 32));
  if (items <= threads)
    return launch_decode_items<T, 1>(x, w, gates, mask, n_tok, D, E, top_k,
                                     vec, chunk, smem, threads, stream);
  return launch_decode_items<T, kDecMaxItems>(
      x, w, gates, mask, n_tok, D, E, top_k, vec, chunk, smem, threads,
      stream);
}

template <typename T>
int launch_prefill(const T* x, const float* w, float* gates, float* mask,
                   int n_tok, int D, int E, int top_k, bool vec,
                   cudaStream_t stream) {
  const size_t smem = kStages * sizeof(PrefillStage<T>) + kTok * E * 4;
  static bool configured[kMaxDevices] = {};  // once a device
  const int dev = device_slot();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        moe_routing_kernel_prefill<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStages * sizeof(PrefillStage<T>) + kTok * kMaxE * 4);
    if (rc != cudaSuccess) {
      cudaGetLastError();  // not left behind for the next launch's check
      return static_cast<int>(rc);
    }
    configured[dev] = true;
  }
  const int blocks = (n_tok + kTok - 1) / kTok;
  moe_routing_kernel_prefill<T><<<blocks, kThreads, smem, stream>>>(
      x, w, gates, mask, n_tok, D, E, top_k, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int route(const void* x, const float* w, float* gates, float* mask, int T_,
          int D, int E, int top_k, int design, cudaStream_t stream) {
  const int xvec = 16 / static_cast<int>(sizeof(T));
  // 16-byte copies need 16-byte aligned rows: of W (E % 4 == 0 for the
  // prefill's tiles; a decode group's 4 rows always are) and of x
  const bool w_al = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool x_al = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  if (design == 0)
    return launch_decode<T>(xt, w, gates, mask, T_, D, E, top_k,
                            w_al && x_al && D % 4 == 0, stream);
  return launch_prefill<T>(xt, w, gates, mask, T_, D, E, top_k,
                           w_al && x_al && E % 4 == 0 && D % xvec == 0,
                           stream);
}

}  // namespace

// Plain C interface, loaded with ctypes.  x: [T, D] contiguous device
// tensor (dtype 0 = f32, 1 = bf16); w: [D, E] f32; gates, mask: [T, E] f32.
// `design`: 0 the decode design, 1 the prefill design, -1 the one for T
// (decode below synergai_moe_routing_switch()).  Launches one kernel
// asynchronously on `stream`; returns cudaGetLastError().

extern "C" int synergai_moe_routing_design(const void* x, const float* w,
                                           float* gates, float* mask,
                                           int dtype, int T, int D, int E,
                                           int top_k, int design,
                                           cudaStream_t stream) {
  if (T <= 0 || D < 0 || E < 1 || E > kMaxE || top_k < 1 || top_k > E ||
      design < -1 || design > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (design == -1) design = T < kDecodeBelow ? 0 : 1;
  if (dtype == 0)
    return route<float>(x, w, gates, mask, T, D, E, top_k, design, stream);
  if (dtype == 1)
    return route<__nv_bfloat16>(x, w, gates, mask, T, D, E, top_k, design,
                                stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int synergai_moe_routing(const void* x, const float* w,
                                    float* gates, float* mask, int dtype,
                                    int T, int D, int E, int top_k,
                                    cudaStream_t stream) {
  return synergai_moe_routing_design(x, w, gates, mask, dtype, T, D, E,
                                     top_k, -1, stream);
}

extern "C" int synergai_moe_routing_switch() { return kDecodeBelow; }

extern "C" const char* synergai_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
