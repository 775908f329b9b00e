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
// Design.  One CTA a (b, h), in the forward kernel's layout: lane t of a
// group of kLanes = 4 holds the rows i = t, t + 4, ... (M = hd / 4) of
// kCols = 2 adjacent value columns, 2 hd threads in all.  The forward kernel
// saved the state before every 64th step (ckpt).  The chunks are walked in
// reverse: a chunk's r, k, w, v and dy are staged in shared memory, its
// states recomputed from ckpt (the forward's roundings) into a scratch
// buffer in device memory (64 x hd^2 f32 a (b, h); each thread reads back
// only what it wrote, coalesced), then the chunk is stepped backwards, G in
// registers, the next step's state loaded while this one computes.
//
// Rounding.  Every f32 operation is one __fmul_rn or __fadd_rn under
// --fmad=false, with no atomics, in the order of rwkv_scan_bwd_plain:
//   products: dy_j S_ij, G_ij v_j, G_ij S_ij, G_ij k_i, each rounded once;
//   G_ij <- w_i G_ij + r_i dy_j (two products, then their sum);
//   sums over j (dr, dk, dw): a pairwise tree over adjacent pairs (j with
//     j ^ 1, then pairs of pairs, ...): the pair a thread holds first, then
//     the column groups of a warp by __shfl_xor_sync as a reduce-scatter
//     (each level hands half of the rows to the partner lane, so a lane
//     ends with M / 8 rows), then the warps' sums through shared memory in
//     the same adjacent order;
//   sums over i (dv): the forward's tree (i with i + hd/2, then the same
//     over the halves): the levels at distances hd/2 .. 4 in a lane, the
//     last two as __shfl_xor_sync.
// IEEE addition is commutative, so which lane of a pair adds does not show.
// So the kernel equals its plain version bit for bit, and two calls agree
// bit for bit: rwkv6 with random weights amplifies an f32 rounding
// difference in the scan ~1e4-fold over its 24 layers (rwkv_scan.cu).
//
// Bound.  Operations a step and (b, h): the recomputed state (3 hd^2),
// the four products (4 hd^2), the G update (3 hd^2) and the four sums
// (~4 hd^2): ~14 hd^2 f32 operations, none fused.  At the training shape
// [2, 4096, 32, 64] that is 1.5e10, 0.22 ms at the card's 67 TFLOP/s f32
// rate (which counts an FMA as two; ~0.45 ms at 128 unfused operations a
// clock on each of 132 SMs at 1.98 GHz).  Bytes: r, k, v, w, dy read and dr,
// dk, dv, dw written once (9 x 67 MB), the chunk states read once (67 MB):
// ~0.67 GB, 0.2 ms at 3.35 TB/s.  The steps of one (b, h) run one after
// another and 64 CTAs leave half the SMs idle at that shape, so the chain
// of dependent operations a step sets the time; the scratch round trip
// (128 KB a step across the card) stays mostly in the 50 MB L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;   // lanes sharing a group of value columns
constexpr int kCols = 2;    // value columns a lane holds
constexpr int kChunk = 64;  // steps between two saved states (rwkv_scan.cu)
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Bwd {
  static constexpr int L = kLanes, NC = kCols;
  static constexpr int M = HD / L;        // rows a lane holds
  static constexpr int E = NC * M;        // state entries a thread holds
  static constexpr int NT = HD / NC * L;  // threads a CTA
  static constexpr int W = NT / 32;       // warps a CTA
  static constexpr int G = 32 / L;        // column groups a warp
  // the rows a lane keeps after the warp's reduce-scatter (at least one)
  static constexpr int K = M / G > 0 ? M / G : 1;
  static constexpr int SMEM = 5 * kChunk * HD * 4;  // staged bytes
};

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

// One level of the warp's sums over column groups, at lane distance OFF
// (column groups g and g ^ (OFF / kLanes)), for the three row arrays a, b,
// c of N values (rows base .. base + N): with N >= 2 the lane whose OFF
// bit is set keeps the upper half (and moves base), the other the lower,
// each adding the partner's half of the same rows; with N == 1 both add.
// Then the next level.
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

// The sum of W warps' partials p[0], p[stride], ... in the adjacent order.
template <int W>
__device__ __forceinline__ float warp_tree(const float* p, int stride) {
  if constexpr (W == 1) {
    return p[0];
  } else {
    return __fadd_rn(warp_tree<W / 2>(p, stride),
                     warp_tree<W / 2>(p + W / 2 * stride, stride));
  }
}

template <int HD>
__global__ void __launch_bounds__(HD / kCols * kLanes, 1)
rwkv_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ ckpt,
                     const float* __restrict__ dy,
                     const float* __restrict__ ds_end,
                     float* __restrict__ dr, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dw,
                     float* __restrict__ ds0, float* __restrict__ scratch,
                     int S, int H) {
  using P = Bwd<HD>;
  constexpr int L = P::L, NC = P::NC, M = P::M, E = P::E, NT = P::NT;
  constexpr int W = P::W, K = P::K;
  extern __shared__ float stage[];  // [5][kChunk][HD]: r, k, w, v, dy
  __shared__ float red[2][3][W][HD];
  float* const sr = stage;
  float* const sk = stage + kChunk * HD;
  float* const sw = stage + 2 * kChunk * HD;
  float* const sv = stage + 3 * kChunk * HD;
  float* const sdy = stage + 4 * kChunk * HD;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane % L;                      // row lane
  const int j = (tid / L) * NC;                // the first of NC columns
  const size_t step = static_cast<size_t>(H) * HD;  // elements per step
  const size_t base = (static_cast<size_t>(b) * S * H + h) * HD;
  const size_t sbase = static_cast<size_t>(bh) * HD * HD + j;
  const int nck = (S + kChunk - 1) / kChunk;
  float* const scr = scratch + static_cast<size_t>(bh) * kChunk * E * NT + tid;

  float G[NC][M];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      G[c][m] = ds_end ? ds_end[sbase + static_cast<size_t>(t + L * m) * HD +
                                c]
                       : 0.f;

  int buf = 0;
  for (int ch = nck - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk, n = min(kChunk, S - t0);
    __syncthreads();  // the last chunk's staged rows are read
    for (int e = tid; e < n * HD; e += NT) {
      const int tt = e / HD, x = e % HD;
      const size_t src = base + static_cast<size_t>(t0 + tt) * step + x;
      sr[e] = r[src];
      sk[e] = k[src];
      sw[e] = w[src];
      sv[e] = v[src];
      sdy[e] = dy[src];
    }
    __syncthreads();

    // the chunk's states, from the one the forward saved, into scratch
    {
      float st[NC][M];
      const float* ck = ckpt + static_cast<size_t>(bh * nck + ch) * HD * HD;
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          st[c][m] = ck[static_cast<size_t>(t + L * m) * HD + j + c];
      for (int tt = 0; tt < n; ++tt) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int m = 0; m < M; ++m)
            scr[static_cast<size_t>(tt * E + c * M + m) * NT] = st[c][m];
        if (tt + 1 < n) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float vj = sv[tt * HD + j + c];
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const int i = t + L * m;
              const float kv = __fmul_rn(sk[tt * HD + i], vj);
              st[c][m] = __fadd_rn(__fmul_rn(sw[tt * HD + i], st[c][m]), kv);
            }
          }
        }
      }
    }

    // backwards through the chunk
    float s[NC][M], sn[NC][M];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int m = 0; m < M; ++m)
        s[c][m] = scr[static_cast<size_t>((n - 1) * E + c * M + m) * NT];
    for (int tt = n - 1; tt >= 0; --tt) {
      if (tt > 0) {  // the next step's state, while this one computes
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int m = 0; m < M; ++m)
            sn[c][m] = scr[static_cast<size_t>((tt - 1) * E + c * M + m) *
                           NT];
      }
      const float* rt = sr + tt * HD;
      const float* kt = sk + tt * HD;
      const float* wt = sw + tt * HD;
      float vj[NC], dyj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        vj[c] = sv[tt * HD + j + c];
        dyj[c] = sdy[tt * HD + j + c];
      }
      // dv: sum over i, the forward's tree
      float dvj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float p[M];
#pragma unroll
        for (int m = 0; m < M; ++m) p[m] = __fmul_rn(G[c][m], kt[t + L * m]);
        tree_sum<M>(p);
        dvj[c] = p[0];
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          dvj[c] = __fadd_rn(dvj[c], __shfl_xor_sync(kFull, dvj[c], off));
      // dr, dk, dw: the pair of columns this thread holds
      float xr[M], xk[M], xw[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        xr[m] = __fadd_rn(__fmul_rn(dyj[0], s[0][m]),
                          __fmul_rn(dyj[1], s[1][m]));
        xk[m] = __fadd_rn(__fmul_rn(G[0][m], vj[0]),
                          __fmul_rn(G[1][m], vj[1]));
        xw[m] = __fadd_rn(__fmul_rn(G[0][m], s[0][m]),
                          __fmul_rn(G[1][m], s[1][m]));
      }
      // G_{t-1} = w G_t + r dy
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = t + L * m;
        const float wi = wt[i], ri = rt[i];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          G[c][m] = __fadd_rn(__fmul_rn(wi, G[c][m]), __fmul_rn(ri, dyj[c]));
      }
      // the column groups of the warp, then the warps
      int mb = 0;
      scatter<M, L>(xr, xk, xw, lane, mb);
      if (M >= P::G || (lane & 16) == 0) {  // lanes that hold distinct rows
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int i = t + L * (mb + q);
          red[buf][0][warp][i] = xr[q];
          red[buf][1][warp][i] = xk[q];
          red[buf][2][warp][i] = xw[q];
        }
      }
      const size_t at = base + static_cast<size_t>(t0 + tt) * step;
      if (t == 0) {
#pragma unroll
        for (int c = 0; c < NC; ++c) dv[at + j + c] = dvj[c];
      }
      __syncthreads();
      for (int e = tid; e < 3 * HD; e += NT) {
        const int kind = e / HD, i = e % HD;
        const float sum = warp_tree<W>(&red[buf][kind][0][i], HD);
        (kind == 0 ? dr : kind == 1 ? dk : dw)[at + i] = sum;
      }
      buf ^= 1;
      if (tt > 0) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int m = 0; m < M; ++m) s[c][m] = sn[c][m];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ds0[sbase + static_cast<size_t>(t + L * m) * HD + c] = G[c][m];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* ckpt, const float* dy, const float* ds_end, float* dr,
           float* dk, float* dv, float* dw, float* ds0, float* scratch, int B,
           int S, int H, cudaStream_t stream) {
  using P = Bwd<HD>;
  static_assert(P::M % 4 == 0 && P::W >= 1, "the lane layout");
  cudaError_t err = cudaFuncSetAttribute(
      rwkv_scan_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv_scan_bwd_kernel<HD><<<B * H, P::NT, P::SMEM, stream>>>(
      r, k, v, w, ckpt, dy, ds_end, dr, dk, dv, dw, ds0, scratch, S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  r, k, v, w, dy and the outputs
// dr, dk, dv, dw: [B, S, H, hd] contiguous f32 device tensors; ckpt:
// [B, H, ceil(S / 64), hd, hd] f32 (rwkv_scan.cu's chunk states); ds_end
// (null: zeros) and ds0: [B, H, hd, hd] f32; scratch: B * H * 64 * hd * hd
// f32.  dr, dk and dv are the state terms only.  Launches one kernel
// asynchronously on `stream`; returns cudaGetLastError().
extern "C" int synergai_rwkv_scan_bwd(const float* r, const float* k,
                                      const float* v, const float* w,
                                      const float* ckpt, const float* dy,
                                      const float* ds_end, float* dr,
                                      float* dk, float* dv, float* dw,
                                      float* ds0, float* scratch, int B,
                                      int S, int H, int hd,
                                      cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
#define SYNERGAI_HD(N)                                                      \
  case N:                                                                   \
    return launch<N>(r, k, v, w, ckpt, dy, ds_end, dr, dk, dv, dw, ds0,     \
                     scratch, B, S, H, stream);
    SYNERGAI_HD(16)
    SYNERGAI_HD(32)
    SYNERGAI_HD(64)
#undef SYNERGAI_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The steps between two saved states (rwkv_scan.CHUNK).
extern "C" int synergai_rwkv_bwd_chunk() { return kChunk; }

extern "C" const char* synergai_rwkv_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
