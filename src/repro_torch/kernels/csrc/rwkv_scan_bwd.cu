// RWKV6 WKV recurrence, backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains RWKV6 by differentiating
// the XLA scan of repro/models/layers.py:rwkv_time_mix (its step under
// repro/models/common.py:chunked_time_scan) with jax.value_and_grad.  This
// kernel is the state part of that gradient.  For one (batch b, head h),
// with S_{t-1} the state before step t (rwkv_scan.cu's recurrence
// S_t = diag(w_t) S_{t-1} + k_t v_t^T), G_t the gradient of the loss with
// respect to S_t (G at the last step: the end state's cotangent, zeros in
// training) and dy_t the cotangent of y_t:
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i][j]      (+ u-term, outside)
//   dk_t[i] = sum_j G_t[i][j] v_t[j]           (+ u-term, outside)
//   dv_t[j] = sum_i G_t[i][j] k_t[i]           (+ u-term, outside)
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   G_{t-1}[i][j] = w_t[i] G_t[i][j] + r_t[i] dy_t[j]
//   d state_0 = G_{-1}.
// The terms without the state (du and the u-terms of dr, dk and dv) are
// PyTorch ops around the kernel (rwkv_scan.RwkvScanFn), shared with the
// plain path.
//
// What bounds it.  Timed on the H100 with parts compiled out (PERF.md, PR
// 30), the first design (one CTA a (b, h); each 64-step chunk's states
// recomputed into a device-memory scratch, then read back in reverse)
// spent ~2.2 of its 5.2 ms at [2, 4096, 32, 64] writing that scratch (hd^2
// f32 a step and head, 64 MB a chunk across the card: more than the 50 MB
// L2) and ~0.9 reading it back; its per-step barrier cost nothing
// measurable; the rest was the step-back's instructions on 64 of 132 SMs,
// one warp on each scheduler, so that every dependent latency showed.
//
// Design.  Entries S[i][j] and G[i][j] of different columns j evolve
// independently, so a head's value columns are split over SPLIT CTAs, a
// thread-block cluster (the wrapper, rwkv_scan.bwd_split, picks the least
// power of two that gives 128 CTAs: 2, 4 or 8 at hd 64).  In a CTA, lane t
// of a column group of L = hd / 2 lanes holds rows i = t and t + L of 4
// adjacent columns (hd 64: a warp 4 columns, 16 warps a head, 8 a CTA at
// the training shape), so a lane's G and state are 8 registers each and
// two warps share each scheduler.  The states stay on chip or in L2: a
// first pass over the chunk keeps the state before every kSteps-th step
// (each thread its own entries, 8 MB at the training shape, in a scratch
// that L2 holds), and the chunk is then walked back one group of kSteps
// steps at a time: the group's states recomputed into registers from the
// one kept (the same operations on the same bits as the forward's), then
// its steps taken back in straight-line code, G in registers.  A group's
// sums over j leave each warp as per-warp partials in shared memory (3
// buffers); the cluster sums them across its warps and CTAs through
// distributed shared memory and writes dr, dk and dw after the next
// group's steps back, behind one cluster barrier a group (arrive after a
// group's partials, wait before their sums), so the barrier's latency
// hides behind that work; each group's global stores (dv, the sums) come
// after its arrive, so that the arrive's release waits for none of them.
// The chunk's r, k, w (all rows, each lane's rows together) and v, dy (the
// CTA's columns) are staged by cp.async, k, w and v first (the first pass
// needs only them); the steps past a ragged end are staged as w = 1,
// r = -0, dy = +0, which leave G as it is, so every group runs the same
// code.
//
// Rounding.  Every f32 operation is one __fmul_rn or __fadd_rn under
// --fmad=false, with no atomics, in the order of rwkv_scan_bwd_plain:
//   products: dy_j S_ij, G_ij v_j, G_ij S_ij, G_ij k_i, each rounded once;
//   G_ij <- w_i G_ij + r_i dy_j (two products, then their sum);
//   S_ij <- w_i S_ij + k_i v_j (the recompute, as the forward rounds it);
//   sums over j (dr, dk, dw): a pairwise tree over adjacent columns (j with
//     j ^ 1, then pairs of pairs, ...): a thread's 4 columns, then (hd 16
//     and 32) the column groups of a warp by __shfl_xor_sync as a
//     reduce-scatter (each level hands half of the rows to the partner
//     lane), then the warps of the head, CTA by CTA in column order, as
//     one adjacent tree.  A CTA's columns are a contiguous, aligned block
//     of a power-of-two width, so every partial is a subtree of the plain
//     version's tree;
//   sums over i (dv): the forward's tree (i with i + hd/2, then the same
//     over the halves): the level at distance hd/2 in a lane, the rest as
//     __shfl_xor_sync (a reduce-scatter over the lane's columns, then an
//     all-reduce).
// IEEE addition is commutative, so which lane of a pair adds does not show.
// So the kernel equals its plain version bit for bit whatever the split,
// and two calls agree bit for bit: rwkv6 with random weights amplifies an
// f32 rounding difference in the scan ~1e4-fold over its 24 layers
// (rwkv_scan.cu).
//
// Bound.  Operations a step and (b, h): the recomputed state (3 hd^2),
// the four products (4 hd^2), the G update (3 hd^2) and the four sums
// (~4 hd^2): ~14 hd^2 f32 operations, none fused.  At the training shape
// [2, 4096, 32, 64] that is 1.5e10, 0.22 ms at the card's 67 TFLOP/s f32
// rate (which counts an FMA as two; ~0.45 ms at 128 unfused operations a
// clock on each of 132 SMs at 1.98 GHz).  This design recomputes each
// group's states a second time (~3 hd^2 more a step) to keep them on chip.
// Bytes: r, k, v, w, dy read and dr, dk, dv, dw written once (9 x 67 MB),
// the chunk states read once (67 MB): ~0.67 GB, 0.2 ms at 3.35 TB/s.  What
// is left above that (PERF.md, PR 30): the cross-lane sums (shuffles and
// the cluster's merge) and the latency of each step's dependent chain.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;    // steps between two saved states (rwkv_scan.cu)
constexpr int kSteps = 8;     // steps a group: its states in registers
constexpr int kMaxWarps = 8;  // warps a CTA at most
constexpr int kMaxSplit = 8;  // CTAs a cluster at most (the portable size)
constexpr int kBufs = 3;      // partial buffers: a group's stay one group
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

// The lane layout by head dim: L lanes a column group, each lane rows
// i = t + L m (m < M = hd / L = 2) of NC = 4 adjacent columns.
template <int HD>
struct Layout {
  static constexpr int L = HD / 2, NC = 4;
};

// warps a head (the leaves of its sums over j), and the splits the kernel
// takes: from the one that keeps a CTA within kMaxWarps warps up to a warp
// a CTA or kMaxSplit
template <int HD>
constexpr int leaves() {
  return HD / (32 / Layout<HD>::L * Layout<HD>::NC);
}
template <int HD>
constexpr int min_split() {
  return leaves<HD>() > kMaxWarps ? leaves<HD>() / kMaxWarps : 1;
}
template <int HD>
constexpr int max_split() {
  return leaves<HD>() < kMaxSplit ? leaves<HD>() : kMaxSplit;
}

template <int HD, int SPLIT>
struct Bwd {
  static constexpr int L = Layout<HD>::L, NC = Layout<HD>::NC;
  static constexpr int M = HD / L;      // rows a lane holds
  static constexpr int E = M * NC;      // entries a lane holds
  static constexpr int G = 32 / L;      // column groups a warp
  static constexpr int WC = G * NC;     // columns a warp
  static constexpr int NL = leaves<HD>();     // warps a head
  static constexpr int COLS = HD / SPLIT;     // columns a CTA
  static constexpr int NW = COLS / WC;        // warps a CTA
  static constexpr int NT = NW * 32;          // threads a CTA
  static constexpr int NB = kChunk / kSteps;  // kept states a chunk
  // the rows a lane keeps after the warp's reduce-scatter (at least one)
  static constexpr int K = M / G > 0 ? M / G : 1;
  // lanes whose bits mark copies after the reduce-scatter's all-reduce
  static constexpr int DUP = L * M >= 32 ? 0 : 32 - L * M;
  // the sums over j a thread finishes in a group's merge
  static constexpr int OUT = kSteps * 3 * HD / (SPLIT * NT);
  static_assert(E % 4 == 0 && L <= 32 && L / NC >= 1 && NW >= 1 &&
                    NW <= kMaxWarps && OUT * SPLIT * NT == kSteps * 3 * HD,
                "the lane layout");
  // shared floats: the partials [kBufs][kSteps][3][NW][HD], the staged r,
  // k, w [kChunk][HD] and v, dy [kChunk][COLS]
  static constexpr int PART = kSteps * 3 * NW * HD;  // one buffer
  static constexpr int SMEM =
      4 * (kBufs * PART + 3 * kChunk * HD + 2 * kChunk * COLS);
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the cluster's barrier in two halves: arrive (releasing this thread's
// shared-memory writes) and wait (acquiring everyone's)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// q[i] += q[i + N/2] for i < N/2, then the same over the first N/2 (the
// forward's tree): sums q[0..N) into q[0].
template <int N>
__device__ __forceinline__ void tree_sum(float* q) {
  if constexpr (N > 1) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) q[i] = __fadd_rn(q[i], q[i + N / 2]);
    tree_sum<N / 2>(q);
  }
}

// the adjacent tree over q[0..N): q[i] with q[i + 1], then the pairs' sums
// the same way, ...; sums into q[0]
template <int N>
__device__ __forceinline__ void adjacent_sum(float* q) {
#pragma unroll
  for (int s = 1; s < N; s *= 2)
#pragma unroll
    for (int i = 0; i + s < N; i += 2 * s) q[i] = __fadd_rn(q[i], q[i + s]);
}

// One level of the warp's sums over column groups, at lane distance OFF
// (column groups g and g ^ (OFF / L)), for the three row arrays a, b, c of
// N values (rows base .. base + N): with N >= 2 the lane whose OFF bit is
// set keeps the upper half (and moves base), the other the lower, each
// adding the partner's half of the same rows; with N == 1 both add.  Then
// the next level, up to distance 16.
template <int N, int OFF>
__device__ __forceinline__ void scatter(float* a, float* b, float* c,
                                        int lane, int& base) {
  if constexpr (OFF < 32) {
    if constexpr (N >= 2) {
      const bool up = lane & OFF;
#pragma unroll
      for (int q = 0; q < N / 2; ++q) {
        const float sa = up ? a[q] : a[q + N / 2];
        const float sb = up ? b[q] : b[q + N / 2];
        const float sc = up ? c[q] : c[q + N / 2];
        const float ka = up ? a[q + N / 2] : a[q];
        const float kb = up ? b[q + N / 2] : b[q];
        const float kc = up ? c[q + N / 2] : c[q];
        a[q] = __fadd_rn(ka, __shfl_xor_sync(kFull, sa, OFF));
        b[q] = __fadd_rn(kb, __shfl_xor_sync(kFull, sb, OFF));
        c[q] = __fadd_rn(kc, __shfl_xor_sync(kFull, sc, OFF));
      }
      if (up) base += N / 2;
      scatter<N / 2, OFF * 2>(a, b, c, lane, base);
    } else {
      a[0] = __fadd_rn(a[0], __shfl_xor_sync(kFull, a[0], OFF));
      b[0] = __fadd_rn(b[0], __shfl_xor_sync(kFull, b[0], OFF));
      c[0] = __fadd_rn(c[0], __shfl_xor_sync(kFull, c[0], OFF));
      scatter<1, OFF * 2>(a, b, c, lane, base);
    }
  }
}

// The lanes' levels of the sums over i, at lane distances OFF, OFF / 2,
// ..., 1, for the N column sums d[0..N) (columns base .. base + N): a
// reduce-scatter while N >= 2 (the lane whose OFF bit is set keeps the
// upper half), then an all-reduce of the one column left.
template <int N, int OFF>
__device__ __forceinline__ void dv_levels(float* d, int lane, int& base) {
  if constexpr (OFF >= 1) {
    if constexpr (N >= 2) {
      const bool up = lane & OFF;
#pragma unroll
      for (int q = 0; q < N / 2; ++q) {
        const float send = up ? d[q] : d[q + N / 2];
        const float keep = up ? d[q + N / 2] : d[q];
        d[q] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, OFF));
      }
      if (up) base += N / 2;
      dv_levels<N / 2, OFF / 2>(d, lane, base);
    } else {
      d[0] = __fadd_rn(d[0], __shfl_xor_sync(kFull, d[0], OFF));
      dv_levels<1, OFF / 2>(d, lane, base);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_n(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    out[0] = q.x;
    out[1] = q.y;
  } else {
    out[0] = *p;
  }
}

template <int HD, int SPLIT>
__global__ void __launch_bounds__(Bwd<HD, SPLIT>::NT, 1)
rwkv_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ ckpt,
                     const float* __restrict__ dy,
                     const float* __restrict__ ds_end,
                     float* __restrict__ dr, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dw,
                     float* __restrict__ ds0, float4* __restrict__ kept,
                     int S, int H) {
  using P = Bwd<HD, SPLIT>;
  constexpr int L = P::L, NC = P::NC, M = P::M, E = P::E, WC = P::WC;
  constexpr int NL = P::NL, COLS = P::COLS, NW = P::NW, NT = P::NT;
  constexpr int K = P::K;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / SPLIT, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane % L;                        // row lane
  const int jl = warp * WC + (lane / L) * NC;    // first column, in the CTA
  const int j = rank * COLS + jl;                // ... in the head
  float* const part = smem;                      // [kBufs][kSteps][3][NW][HD]
  float* const sr = part + kBufs * P::PART;      // [kChunk][HD], each lane's
  float* const sk = sr + kChunk * HD;            // rows together
  float* const sw = sk + kChunk * HD;
  float* const sv = sw + kChunk * HD;            // [kChunk][COLS]
  float* const sdy = sv + kChunk * COLS;
  // this thread's kept states, [NB][E / 4] float4s NT apart
  kept += static_cast<size_t>(blockIdx.x) * P::NB * (E / 4) * NT + tid;

  const size_t step = static_cast<size_t>(H) * HD;  // elements per step
  const size_t base = (static_cast<size_t>(b) * S * H + h) * HD;
  const size_t sbase = static_cast<size_t>(bh) * HD * HD + j;
  const int nck = (S + kChunk - 1) / kChunk;

  float G[NC][M];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      G[c][m] = ds_end ? ds_end[sbase + static_cast<size_t>(t + L * m) * HD +
                                c]
                       : 0.f;

  // a staged row x of r, k or w goes to place (x % L) M + x / L
  auto stage_rows = [&](float* dst, const float* src, int t0, int n) {
    for (int e = tid; e < n * HD; e += NT) {
      const int tt = e / HD, x = e % HD;
      cp_async4(dst + tt * HD + (x % L) * M + x / L,
                src + base + static_cast<size_t>(t0 + tt) * step + x);
    }
  };
  auto stage_cols = [&](float* dst, const float* src, int t0, int n) {
    for (int e = tid; e < n * COLS; e += NT) {
      const int tt = e / COLS, x = e % COLS;
      cp_async4(dst + e, src + base + static_cast<size_t>(t0 + tt) * step +
                             rank * COLS + x);
    }
  };
  // the state before step x + 1 of the chunk from the one before step x
  auto advance = [&](const float (&s)[NC][M], float (&out)[NC][M], int x) {
    float kr[M], wr[M], vj[NC];
    load_n<M>(sk + x * HD + t * M, kr);
    load_n<M>(sw + x * HD + t * M, wr);
    load_n<NC>(sv + x * COLS + jl, vj);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int m = 0; m < M; ++m)
        out[c][m] = __fadd_rn(__fmul_rn(wr[m], s[c][m]),
                              __fmul_rn(kr[m], vj[c]));
  };
  auto keep = [&](int q, const float (&s)[NC][M]) {
#pragma unroll
    for (int e = 0; e < E; e += 4)
      kept[(q * (E / 4) + e / 4) * NT] =
          make_float4(s[e / M][e % M], s[(e + 1) / M][(e + 1) % M],
                      s[(e + 2) / M][(e + 2) % M], s[(e + 3) / M][(e + 3) % M]);
  };
  auto fetch = [&](int q, float (&s)[NC][M]) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 x = kept[(q * (E / 4) + e / 4) * NT];
      s[e / M][e % M] = x.x;
      s[(e + 1) / M][(e + 1) % M] = x.y;
      s[(e + 2) / M][(e + 2) % M] = x.z;
      s[(e + 3) / M][(e + 3) % M] = x.w;
    }
  };

  // The cluster's sums over j of a group of g_n steps (partial buffer pb):
  // output o = (step, kind, i), i fastest, OUT a thread; its NL leaves are
  // the head's warps in column order, NW from each CTA rank, summed by the
  // adjacent tree into sum[u].  Every load is issued before the first add.
  auto merge_sum = [&](const float* pb, int g_n, float (&sum)[P::OUT]) {
    float x[P::OUT][NL];
#pragma unroll
    for (int u = 0; u < P::OUT; ++u) {
      const int o = (u * SPLIT + rank) * NT + tid;
      const int i = o % HD, row = o / HD;      // row: (step, kind)
      if (o < g_n * 3 * HD) {
#pragma unroll
        for (int rk = 0; rk < SPLIT; ++rk) {
          const float* src = cluster.map_shared_rank(pb, rk) +
                             row * NW * HD + i;
#pragma unroll
          for (int q = 0; q < NW; ++q) x[u][rk * NW + q] = src[q * HD];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < P::OUT; ++u) {
      adjacent_sum<NL>(x[u]);
      sum[u] = x[u][0];
    }
  };
  // ... and their stores into dr, dk, dw, the group's first step g_t0
  auto merge_store = [&](const float (&sum)[P::OUT], int g_t0, int g_n) {
#pragma unroll
    for (int u = 0; u < P::OUT; ++u) {
      const int o = (u * SPLIT + rank) * NT + tid;
      if (o < g_n * 3 * HD) {
        const int i = o % HD, kind = (o / HD) % 3, tt = o / (3 * HD);
        (kind == 0 ? dr : kind == 1 ? dk : dw)[base +
            static_cast<size_t>(g_t0 + tt) * step + i] = sum[u];
      }
    }
  };

  // One group's steps back, its sums over j to the partials pb and this
  // lane's dv (column j + cb) to dvs; the kept state before the group in
  // st[0].  Straight-line code: the steps past the end of a ragged last
  // group are staged so that they leave G as it is (w = 1, r = -0, dy =
  // +0: 1 G + -0 is G, signed zeros too), and their outputs are not stored.
  auto step_back = [&](float (&st)[kSteps][NC][M], float* pb, int g0,
                       float (&dvs)[kSteps], int& cb) {
#pragma unroll
    for (int tt = 0; tt + 1 < kSteps; ++tt)
      advance(st[tt], st[tt + 1], g0 + tt);
#pragma unroll
    for (int tt = kSteps - 1; tt >= 0; --tt) {
      const int x = g0 + tt;
      float kr[M], rr[M], wr[M], vj[NC], dyj[NC];
      load_n<M>(sk + x * HD + t * M, kr);
      load_n<M>(sr + x * HD + t * M, rr);
      load_n<M>(sw + x * HD + t * M, wr);
      load_n<NC>(sv + x * COLS + jl, vj);
      load_n<NC>(sdy + x * COLS + jl, dyj);
      // dv: the sum over i, the forward's tree
      float dvj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float p[M];
#pragma unroll
        for (int m = 0; m < M; ++m) p[m] = __fmul_rn(G[c][m], kr[m]);
        tree_sum<M>(p);
        dvj[c] = p[0];
      }
      cb = 0;
      dv_levels<NC, L / 2>(dvj, lane, cb);
      dvs[tt] = dvj[0];
      // dr, dk, dw: the thread's columns
      float xr[M], xk[M], xw[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float pr[NC], pk[NC], pw[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          pr[c] = __fmul_rn(dyj[c], st[tt][c][m]);
          pk[c] = __fmul_rn(G[c][m], vj[c]);
          pw[c] = __fmul_rn(G[c][m], st[tt][c][m]);
        }
        adjacent_sum<NC>(pr);
        adjacent_sum<NC>(pk);
        adjacent_sum<NC>(pw);
        xr[m] = pr[0];
        xk[m] = pk[0];
        xw[m] = pw[0];
      }
      // G_{t-1} = w G_t + r dy
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          G[c][m] = __fadd_rn(__fmul_rn(wr[m], G[c][m]),
                              __fmul_rn(rr[m], dyj[c]));
      // the column groups of the warp; the warp's partials
      int mb = 0;
      scatter<M, L>(xr, xk, xw, lane, mb);
      if ((lane & P::DUP) == 0) {  // lanes that hold distinct rows
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int i = t + L * (mb + q);
          pb[((tt * 3 + 0) * NW + warp) * HD + i] = xr[q];
          pb[((tt * 3 + 1) * NW + warp) * HD + i] = xk[q];
          pb[((tt * 3 + 2) * NW + warp) * HD + i] = xw[q];
        }
      }
    }
  };

  // Partial buffer n % kBufs takes the n-th group.  A group's sums wait
  // for the cluster's barrier after the next group's steps back, so the
  // barrier's latency hides behind them; a buffer is written again two
  // groups later, after the barrier that follows its sums in every CTA.
  // The global stores come after each arrive, so that its release has no
  // store to wait for.
  int ng = 0, p_t0 = 0, p_n = 0;
  for (int ch = nck - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk, n = min(kChunk, S - t0);
    const int ngroups = (n + kSteps - 1) / kSteps;
    __syncthreads();  // the last chunk's staged rows are read
    stage_rows(sk, k, t0, n);
    stage_rows(sw, w, t0, n);
    stage_cols(sv, v, t0, n);
    cp_async_commit();
    stage_rows(sr, r, t0, n);
    stage_cols(sdy, dy, t0, n);
    cp_async_commit();
    for (int e = tid; e < (ngroups * kSteps - n) * HD; e += NT) {
      sw[n * HD + e] = 1.f;  // the steps past a ragged end leave G as it is
      sr[n * HD + e] = -0.f;
      if (e < (ngroups * kSteps - n) * COLS) sdy[n * COLS + e] = 0.f;
    }
    cp_async_wait<1>();  // k, w, v
    __syncthreads();

    // the first pass: the state before steps 0, kSteps, ... of the chunk,
    // from the one the forward saved, kept (each thread its own entries)
    {
      float s[2][NC][M];
      const float* ck = ckpt + static_cast<size_t>(bh * nck + ch) * HD * HD;
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          s[0][c][m] = ck[static_cast<size_t>(t + L * m) * HD + j + c];
      for (int q = 0; q < ngroups; ++q) {
        keep(q, s[0]);
        if (q + 1 == ngroups) break;
#pragma unroll
        for (int tt = 0; tt < kSteps; tt += 2) {
          advance(s[0], s[1], q * kSteps + tt);
          advance(s[1], s[0], q * kSteps + tt + 1);
        }
      }
    }
    cp_async_wait<0>();  // r, dy
    __syncthreads();

    // the groups, last first
    for (int q = ngroups - 1; q >= 0; --q, ++ng) {
      const int g0 = q * kSteps, gn = min(kSteps, n - g0);
      float st[kSteps][NC][M];  // the state before each step of the group
      fetch(q, st[0]);
      float dvs[kSteps], sum[P::OUT];
      int cb;
      step_back(st, part + (ng % kBufs) * P::PART, g0, dvs, cb);
      if (ng > 0) {  // the previous group's sums, once every CTA wrote them
        cluster_wait();
        merge_sum(part + ((ng - 1) % kBufs) * P::PART, p_n, sum);
      }
      cluster_arrive();
      if (t % (L / NC) == 0) {  // the lanes that hold a column's dv
#pragma unroll
        for (int tt = 0; tt < kSteps; ++tt)
          if (tt < gn)
            dv[base + static_cast<size_t>(t0 + g0 + tt) * step + j + cb] =
                dvs[tt];
      }
      if (ng > 0) merge_store(sum, p_t0, p_n);
      p_t0 = t0 + g0;
      p_n = gn;
    }
  }
  float sum[P::OUT];
  cluster_wait();
  merge_sum(part + ((ng - 1) % kBufs) * P::PART, p_n, sum);
  cluster_arrive();  // no CTA leaves while another reads its partials
  merge_store(sum, p_t0, p_n);
  cluster_wait();
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ds0[sbase + static_cast<size_t>(t + L * m) * HD + c] = G[c][m];
}

template <int HD, int SPLIT>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* ckpt, const float* dy, const float* ds_end, float* dr,
           float* dk, float* dv, float* dw, float* ds0, float* scratch, int B,
           int S, int H, cudaStream_t stream) {
  using P = Bwd<HD, SPLIT>;
  // opt in to > 48 KB of shared memory, once a device
  static bool configured[kMaxDevices] = {};
  const int dev = device_slot();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        rwkv_scan_bwd_kernel<HD, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (rc != cudaSuccess) {
      cudaGetLastError();  // not left behind for the next launch's check
      return static_cast<int>(rc);
    }
    configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * H * SPLIT));
  cfg.blockDim = dim3(P::NT);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, rwkv_scan_bwd_kernel<HD, SPLIT>, r, k, v, w, ckpt, dy, ds_end, dr,
      dk, dv, dw, ds0, reinterpret_cast<float4*>(scratch), S, H);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  r, k, v, w, dy and the outputs
// dr, dk, dv, dw: [B, S, H, hd] contiguous f32 device tensors; ckpt:
// [B, H, ceil(S / 64), hd, hd] f32 (rwkv_scan.cu's chunk states); ds_end
// (null: zeros) and ds0: [B, H, hd, hd] f32; scratch: B * H * 8 * hd * hd
// f32, 16-byte aligned (the kept states).  split: CTAs (a cluster) per
// (b, h), a power of two from synergai_rwkv_bwd_min_split(hd) to
// synergai_rwkv_bwd_max_split(hd).  dr, dk and dv are the state terms
// only.  Launches one kernel asynchronously on `stream`; returns the CUDA
// error code.
extern "C" int synergai_rwkv_scan_bwd(const float* r, const float* k,
                                      const float* v, const float* w,
                                      const float* ckpt, const float* dy,
                                      const float* ds_end, float* dr,
                                      float* dk, float* dv, float* dw,
                                      float* ds0, float* scratch, int B,
                                      int S, int H, int hd, int split,
                                      cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define SYNERGAI_CASE(N, SP)                                               \
  if (hd == N && split == SP)                                              \
    return launch<N, SP>(r, k, v, w, ckpt, dy, ds_end, dr, dk, dv, dw, ds0, \
                         scratch, B, S, H, stream);
  SYNERGAI_CASE(16, 1)
  SYNERGAI_CASE(32, 1)
  SYNERGAI_CASE(32, 2)
  SYNERGAI_CASE(32, 4)
  SYNERGAI_CASE(64, 2)
  SYNERGAI_CASE(64, 4)
  SYNERGAI_CASE(64, 8)
#undef SYNERGAI_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The steps between two saved states (rwkv_scan.CHUNK), the steps of a
// group (rwkv_scan.BWD_STEPS), and by head dim the lane layout
// (rwkv_scan.BWD_LAYOUT: lanes a column group, columns a lane) and the
// splits the kernel takes; -1 for a head dim it does not take.
extern "C" int synergai_rwkv_bwd_chunk() { return kChunk; }
extern "C" int synergai_rwkv_bwd_steps() { return kSteps; }

#define SYNERGAI_BWD_QUERY(NAME, EXPR)       \
  extern "C" int NAME(int hd) {              \
    switch (hd) {                            \
      case 16: {                             \
        constexpr int N = 16;                \
        return EXPR;                         \
      }                                      \
      case 32: {                             \
        constexpr int N = 32;                \
        return EXPR;                         \
      }                                      \
      case 64: {                             \
        constexpr int N = 64;                \
        return EXPR;                         \
      }                                      \
      default:                               \
        return -1;                           \
    }                                        \
  }
SYNERGAI_BWD_QUERY(synergai_rwkv_bwd_lanes, Layout<N>::L)
SYNERGAI_BWD_QUERY(synergai_rwkv_bwd_cols, Layout<N>::NC)
SYNERGAI_BWD_QUERY(synergai_rwkv_bwd_min_split, min_split<N>())
SYNERGAI_BWD_QUERY(synergai_rwkv_bwd_max_split, max_split<N>())
#undef SYNERGAI_BWD_QUERY

extern "C" const char* synergai_rwkv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
