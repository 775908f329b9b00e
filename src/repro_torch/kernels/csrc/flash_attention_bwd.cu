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
// (head h uses kv head h / G).  FlashAttention-2's backward, made
// deterministic by recomputing: three kernels, launched in order on one
// stream by synergai_flash_attention_bwd, the last two picked by dtype (no
// fallback from one design to the other):
//   flash_attention_bwd_dot_kernel   D, one warp a (b, query, head) row;
//   a dK/dV kernel, one CTA per (b, kv head, key block): K and V staged
//     once, dK and dV kept in registers while the CTA walks the G heads and
//     every query tile that sees one of its keys, written once at the end;
//   a dQ kernel, one CTA per (b, head, query block): Q, dO, lse and D
//     staged once, dQ in registers over the key tiles.
// No atomics and no split of a sum across CTAs: each output element is
// summed by one thread in a fixed order (over g, then query tiles, then
// k-steps), so two calls give the same bits.  A row that sees no key is
// not a case: the wrapper refuses it (under a window, Sq - Sk >= window).
//
// bf16: flash_attention_bwd_{dkdv,dq}_kernel_mma, tensor cores through
// mma.sync.aligned.m16n8k16 (bf16 operands, f32 accumulators).
//   dkdv: 64 keys a CTA, 16 a warp.  K and V are staged once in bf16 with
//   rows padded by 16 bytes (the ldmatrix reads of 8 rows hit 8 bank
//   groups); query tiles (Q, dO, lse, D; 64 rows, 32 at hd >= 128 for
//   registers) stream through a two-stage cp.async ring, the next tile's
//   loads in flight while this tile's mma run, one barrier a tile.  A warp
//   computes the transposed tiles S^T = K Q^T and dP^T = V dO^T (K and V
//   the A operands by ldmatrix; Q and dO the B operands by ldmatrix, since
//   [q][d] is B's column-major layout), then in registers
//   P^T = exp2(S^T scale log2(e) - lse log2(e)) and dS^T = P^T o (dP^T - D),
//   then dV += P^T dO and dK += dS^T Q: the accumulator's fragment layout
//   is the A operand's, so P^T and dS^T never leave registers (dO and Q
//   the B operands by ldmatrix.trans).  At hd 256 a warp's dK and dV for
//   16 keys would be 256 f32 registers a thread, so 8 warps share the 64
//   keys two to a key group, each holding half of the head dims of dK and
//   dV; both warps of a pair recompute the pair's S^T and dP^T.
//   dq: 64 query rows a CTA, 16 a warp; Q and dO held as A fragments in
//   registers at hd <= 128 (read by ldmatrix at each k-step at hd 256); K
//   and V tiles (64 keys, 32 at hd 128, 16 at hd 256) through the cp.async
//   ring; S
//   and dP recomputed, dQ += dS K with K the B operand by ldmatrix.trans.
//   Both skip tiles that the mask hides from a warp entirely and mask per
//   element only on tiles that cross a boundary (a key past Sk, a row past
//   Sq, the causal diagonal, the window's edge), where P = 0 exactly.  The
//   heaviest CTAs are launched first: the (b, head) index is blockIdx.x and
//   the block index blockIdx.y, in launch order the low key blocks of dkdv
//   and the high query blocks of dq (under a causal mask they see the most
//   tiles), so the last wave holds the lightest CTAs.
//   Precision.  S and dP are exact products of bf16 inputs summed in f32.
//   P (for dV) and dS (for dK and dQ) are f32 and must be rounded to bf16
//   for the tensor cores; one bf16 operand errs by up to 2^-9 of each
//   element, and at S = 1,024-2,048 one bf16 P or dS came to two thirds
//   of the bf16 bound (2^-7 of max |plain|, one ulp of the largest
//   element) after the final rounding in the CPU rehearsal
//   (tests/test_torch_flash_bwd_precision.py), so both are split as the
//   forward splits P: x_hi = bf16(x), x_lo = bf16(x - x_hi) (the
//   difference is exact in f32), two mma against the same B fragment; the
//   error left is <= 2^-18 |x|, ~3e-6 of max |plain| in the rehearsal, so
//   kernel and plain version differ by at most one bf16 ulp of an element.
//   exp2 is ex2.approx (relative error ~2^-22, results below 2^-126
//   flushed to 0).
//   Tiles.  At hd 128, 64-row query tiles in dkdv or 64-key tiles in dq
//   measured slower on the H100 (two CTAs an SM either way), and capping
//   registers for three CTAs an SM spilled and ran slower still.
//
// f32: flash_attention_bwd_{dkdv,dq}_kernel, f32 FMAs on tiles widened to
// f32 in shared memory: a TF32 product keeps ~3 decimal digits and cannot
// hold the f32 bound (1e-4 of max |plain|).  [32][hd + 4] tiles (the pad
// keeps the float4 row reads of 8 threads on 8 different bank groups), 32
// keys a dkdv CTA and 32 queries a dq CTA, 256 threads as a 16 x 16 grid
// (ty, tx): in a score tile thread (ty, tx) holds rows 2ty, 2ty + 1 and keys
// tx, tx + 16 of S and dP; P and dS go through shared memory; in the
// accumulation it holds two keys (dK, dV) or two rows (dQ) and head dims
// tx + 16c.
//
// Bound.  Operations: 10 * hd flops per visible (query head, key) pair (S,
// dP, dV, dK, dQ) at the card's dense peak for the input type, 989 TFLOP/s
// bf16 (tensor cores) or 67 TFLOP/s f32: 0.695 ms bf16 at qwen3-4b's
// training shape [2, 4096, 32, 8, 128] causal.  Bytes are two orders of
// magnitude below.  The bf16 design executes 20 * hd a pair on the tensor
// cores (S and dP twice, once in each kernel; P.dO, dS.Q and dS.K split
// hi + lo; 24 * hd at hd 256, where each warp pair computes its S^T and
// dP^T twice), 1.39 ms at the peak.  What still holds it back: mma.sync in
// place of Hopper's wgmma (which alone reaches the peak, with its B operand
// read from shared memory by the tensor cores), ldmatrix and cp.async in
// place of TMA (every warp reads its B fragments through the register
// file, ~0.4 ldmatrix.x4 per mma), and no warp specialisation, so a tile's
// loads overlap only the previous tile's mma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// f32: plain FMAs (and the D pre-pass, both dtypes)

constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 32;      // query positions a tile
constexpr int kKeys = 32;      // keys a tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// four consecutive f32 elements (16-byte aligned: hd % 4 == 0 and 16-byte
// aligned tensors)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
// bf16: tensor cores

constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct BwdShape {
  static constexpr int kLds = HD + 8;  // padded row, bf16 elements
  // dkdv: 64 keys, 16 a key group; at hd 256 two warps a key group, each
  // with half of the head dims of dK and dV
  static constexpr int kKeys = 64;
  static constexpr int kSplit = HD == 256 ? 2 : 1;
  static constexpr int kWarps = 4 * kSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kQRows = HD >= 128 ? 32 : 64;  // a query tile
  static constexpr int kDkdvSmem =
      2 * (2 * kKeys * kLds + 2 * 2 * kQRows * kLds) + 4 * 2 * 2 * kQRows;
  // dq: 64 query rows, 16 a warp; at hd 256 the warp's dQ alone is 128
  // registers a thread, so its key tiles are 16 wide (32 spilled)
  static constexpr int kRows = 64;
  static constexpr int kDqThreads = 128;
  static constexpr int kKeyTile = HD == 256 ? 16 : HD >= 128 ? 32 : 64;
  static constexpr bool kQInRegs = HD <= 128;
  static constexpr int kDqSmem =
      2 * (2 * kRows * kLds + 2 * 2 * kKeyTile * kLds);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared, zero-filled when `valid` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b for one 16 x 8 x 16 tile: bf16 in, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as bf16 hi + lo words: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(__fsub_rn(x, hf.x),
                                       __fsub_rn(y, hf.y)));
}

// two 16 x 8 accumulator tiles (n-tiles 2j, 2j + 1) as the hi and lo A
// operands of one 16 x 16 product: the accumulator's fragment layout is
// the A operand's
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ldmatrix addressing: lane l gives row l % 8 of matrix l / 8.  A operands
// ([m][k] rows) and B operands by .trans ([k][n] rows): matrices (rows
// 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15);
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
// B operands from [n][k] rows: (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7),
// (8-15, 8-15), the b0 and b1 of two n-tiles
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_col(int lane) {
  return ((lane >> 3) & 1) * 8;
}

template <int HD>
__global__ void __launch_bounds__(BwdShape<HD>::kThreads)
flash_attention_bwd_dkdv_kernel_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, int K, int causal,
    int use_window, int window, float scale, float scale_log2) {
  using S = BwdShape<HD>;
  constexpr int LDS = S::kLds, QT = S::kQRows, BK = S::kKeys;
  constexpr int KS = HD / 16, NQ = QT / 8, DW = HD / S::kSplit, ND = DW / 8;
  constexpr int CH = HD / 8;  // 16-byte chunks in a row
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem4);  // [BK][LDS]
  __nv_bfloat16* Vs = Ks + BK * LDS;                             // [BK][LDS]
  __nv_bfloat16* QDs = Vs + BK * LDS;  // [stage][Q, dO][QT][LDS]
  float* LDs = reinterpret_cast<float*>(QDs + 2 * 2 * QT * LDS);
  // [stage][lse, D][QT]

  const int G = H / K;
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int k0 = blockIdx.y * BK;
  const int k_last = min(k0 + BK, Sk) - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kr = (warp & 3) * 16;  // this warp's 16 keys in the block
  const int kw0 = k0 + kr;
  const int d0 = (warp >> 2) * DW;  // and its head dims of dK and dV
  const int ar = a_row(lane), ac = a_col(lane);
  const int br = b_row(lane), bc = b_col(lane);

  for (int e = tid; e < BK * CH; e += S::kThreads) {
    const int j = e / CH, c = e % CH, key = k0 + j;
    const bool ok = key < Sk;
    const size_t off =
        ((static_cast<size_t>(b) * Sk + (ok ? key : 0)) * K + kh) * HD +
        c * 8;
    cp_async16(Ks + j * LDS + c * 8, k + off, ok);
    cp_async16(Vs + j * LDS + c * 8, v + off, ok);
  }

  // the query tiles that see a key of this block: causal, from position
  // k0 on; windowed, up to k_last + window - 1; for each of the G heads
  long long q_begin = causal ? k0 : 0, q_end = Sq;
  if (use_window)
    q_end = min(q_end, static_cast<long long>(k_last) + window);
  const int qt_begin = static_cast<int>(q_begin / QT);
  const int nq =
      q_end > q_begin ? static_cast<int>((q_end + QT - 1) / QT) - qt_begin : 0;
  const int n_tiles = G * nq;

  auto load_tile = [&](int i, int buf) {
    const int gi = i / nq, q0 = (qt_begin + i - gi * nq) * QT;
    const int h = kh * G + gi;
    __nv_bfloat16* Qs = QDs + buf * 2 * QT * LDS;
    __nv_bfloat16* dOs = Qs + QT * LDS;
    float* Ls = LDs + buf * 2 * QT;
    for (int e = tid; e < QT * CH; e += S::kThreads) {
      const int r = e / CH, c = e % CH, qp = q0 + r;
      const bool ok = qp < Sq;
      const size_t off =
          ((static_cast<size_t>(b) * Sq + (ok ? qp : 0)) * H + h) * HD +
          c * 8;
      cp_async16(Qs + r * LDS + c * 8, q + off, ok);
      cp_async16(dOs + r * LDS + c * 8, dout + off, ok);
    }
    if (tid < QT) {
      const int qp = q0 + tid;
      const bool ok = qp < Sq;
      const size_t off =
          (static_cast<size_t>(b) * H + h) * Sq + (ok ? qp : 0);
      cp_async4(Ls + tid, lse + off, ok);
      cp_async4(Ls + QT + tid, dsum + off, ok);
    }
  };
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    cp_async_wait_all();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (i + 1 < n_tiles) load_tile(i + 1, buf ^ 1);
    cp_async_commit();
    const int q0 = (qt_begin + i % nq) * QT;
    if (kw0 >= Sk || (causal && kw0 > q0 + QT - 1) ||
        (use_window && q0 - (kw0 + 15) >= window))
      continue;  // warp-uniform: the mask hides this tile from its keys
    const __nv_bfloat16* Qs = QDs + buf * 2 * QT * LDS;
    const __nv_bfloat16* dOs = Qs + QT * LDS;
    const float* Ls = LDs + buf * 2 * QT;
    const float* Ds = Ls + QT;

    // S^T = K Q^T, dP^T = V dO^T: 16 keys x QT queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      ldmatrix_x4(ak, Ks + (kr + ar) * LDS + kk * 16 + ac);
      ldmatrix_x4(av, Vs + (kr + ar) * LDS + kk * 16 + ac);
#pragma unroll
      for (int nn = 0; nn < QT / 16; ++nn) {
        uint32_t bq[4], bo[4];
        ldmatrix_x4(bq, Qs + (nn * 16 + br) * LDS + kk * 16 + bc);
        ldmatrix_x4(bo, dOs + (nn * 16 + br) * LDS + kk * 16 + bc);
        mma_bf16(s[2 * nn], ak, bq[0], bq[1]);
        mma_bf16(s[2 * nn + 1], ak, bq[2], bq[3]);
        mma_bf16(dp[2 * nn], av, bo[0], bo[1]);
        mma_bf16(dp[2 * nn + 1], av, bo[2], bo[3]);
      }
    }

    // P^T and dS^T in place; masks only on tiles that cross a boundary
    const bool edge = kw0 + 16 > Sk || q0 + QT > Sq ||
                      (causal && kw0 + 15 > q0) ||
                      (use_window && q0 + QT - 1 - kw0 >= window);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(Ls + c);
      const float2 dd = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = __fmul_rn((e & 1) ? l2.y : l2.x, kLog2e);
        float p = fast_exp2(__fsub_rn(__fmul_rn(s[n][e], scale_log2), lse2));
        if (edge) {
          const int key = kw0 + g + 8 * (e >> 1), qp = q0 + c + (e & 1);
          if (key >= Sk || qp >= Sq || (causal && key > qp) ||
              (use_window && qp - key >= window))
            p = 0.f;
        }
        s[n][e] = p;
        dp[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], (e & 1) ? dd.y : dd.x));
      }
    }

    // dV += P^T dO, dK += dS^T Q, each operand split hi + lo
#pragma unroll
    for (int j = 0; j < QT / 16; ++j) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split_a(s[2 * j], s[2 * j + 1], ph, pl);
      split_a(dp[2 * j], dp[2 * j + 1], sh, sl);
#pragma unroll
      for (int dd = 0; dd < DW / 16; ++dd) {
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, dOs + (j * 16 + ar) * LDS + d0 + dd * 16 + ac);
        ldmatrix_x4_trans(bq, Qs + (j * 16 + ar) * LDS + d0 + dd * 16 + ac);
        mma_bf16(dva[2 * dd], ph, bo[0], bo[1]);
        mma_bf16(dva[2 * dd + 1], ph, bo[2], bo[3]);
        mma_bf16(dva[2 * dd], pl, bo[0], bo[1]);
        mma_bf16(dva[2 * dd + 1], pl, bo[2], bo[3]);
        mma_bf16(dka[2 * dd], sh, bq[0], bq[1]);
        mma_bf16(dka[2 * dd + 1], sh, bq[2], bq[3]);
        mma_bf16(dka[2 * dd], sl, bq[0], bq[1]);
        mma_bf16(dka[2 * dd + 1], sl, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait_all();  // the last (empty) group, before the CTA exits

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    if (key >= Sk) continue;
    const size_t off =
        ((static_cast<size_t>(b) * Sk + key) * K + kh) * HD + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(__fmul_rn(dka[n][2 * r], scale),
                                __fmul_rn(dka[n][2 * r + 1], scale));
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(BwdShape<HD>::kDqThreads)
flash_attention_bwd_dq_kernel_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, int Sq,
    int Sk, int H, int K, int causal, int use_window, int window, float scale,
    float scale_log2) {
  using S = BwdShape<HD>;
  constexpr int LDS = S::kLds, BC = S::kKeyTile, ROWS = S::kRows;
  constexpr int KS = HD / 16, NT = BC / 8, CH = HD / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [ROWS][LDS]
  __nv_bfloat16* dOs = Qs + ROWS * LDS;                          // [ROWS][LDS]
  __nv_bfloat16* KVs = dOs + ROWS * LDS;  // [stage][K, V][BC][LDS]

  const int G = H / K;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / G;
  // the last query blocks first: under a causal mask they see most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int q_last = min(q0 + ROWS, Sq) - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ar = a_row(lane), ac = a_col(lane);
  const int br = b_row(lane), bc = b_col(lane);

  for (int e = tid; e < ROWS * CH; e += S::kDqThreads) {
    const int r = e / CH, c = e % CH, qp = q0 + r;
    const bool ok = qp < Sq;
    const size_t off =
        ((static_cast<size_t>(b) * Sq + (ok ? qp : 0)) * H + h) * HD + c * 8;
    cp_async16(Qs + r * LDS + c * 8, q + off, ok);
    cp_async16(dOs + r * LDS + c * 8, dout + off, ok);
  }

  // the key tiles this query block sees
  int kt_end = (Sk + BC - 1) / BC;
  if (causal) kt_end = min(kt_end, q_last / BC + 1);
  int kt_begin = 0;
  if (use_window)
    kt_begin = static_cast<int>(
        max(0LL, (static_cast<long long>(q0) - window + 1) / BC));

  const size_t kv_base = static_cast<size_t>(b) * Sk;
  auto load_kv = [&](int kt, int buf) {
    __nv_bfloat16* Kt = KVs + buf * 2 * BC * LDS;
    __nv_bfloat16* Vt = Kt + BC * LDS;
    for (int e = tid; e < BC * CH; e += S::kDqThreads) {
      const int j = e / CH, c = e % CH, key = kt * BC + j;
      const bool ok = key < Sk;
      const size_t off = ((kv_base + (ok ? key : 0)) * K + kh) * HD + c * 8;
      cp_async16(Kt + j * LDS + c * 8, k + off, ok);
      cp_async16(Vt + j * LDS + c * 8, v + off, ok);
    }
  };
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();

  // this thread's two rows: g and g + 8 of the warp's 16
  const int wrow = q0 + warp * 16;
  float lse2[2], dsv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = wrow + g + 8 * r;
    const size_t off = (static_cast<size_t>(b) * H + h) * Sq + qp;
    lse2[r] = qp < Sq ? __fmul_rn(lse[off], kLog2e) : 0.f;
    dsv[r] = qp < Sq ? dsum[off] : 0.f;
  }

  uint32_t qf[S::kQInRegs ? KS : 1][4], of[S::kQInRegs ? KS : 1][4];
  float dqa[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < kt_end) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    if constexpr (S::kQInRegs) {
      if (kt == kt_begin) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldmatrix_x4(qf[kk], Qs + (warp * 16 + ar) * LDS + kk * 16 + ac);
          ldmatrix_x4(of[kk], dOs + (warp * 16 + ar) * LDS + kk * 16 + ac);
        }
      }
    }
    const int k0 = kt * BC;
    if (wrow >= Sq || (causal && k0 > wrow + 15) ||
        (use_window && wrow - (k0 + BC - 1) >= window))
      continue;  // warp-uniform: the mask hides this tile from its rows
    const __nv_bfloat16* Kt = KVs + buf * 2 * BC * LDS;
    const __nv_bfloat16* Vt = Kt + BC * LDS;

    // S = Q K^T, dP = dO V^T: 16 rows x BC keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], ao[4];
      if constexpr (S::kQInRegs) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          a[x] = qf[kk][x];
          ao[x] = of[kk][x];
        }
      } else {
        ldmatrix_x4(a, Qs + (warp * 16 + ar) * LDS + kk * 16 + ac);
        ldmatrix_x4(ao, dOs + (warp * 16 + ar) * LDS + kk * 16 + ac);
      }
#pragma unroll
      for (int nn = 0; nn < BC / 16; ++nn) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, Kt + (nn * 16 + br) * LDS + kk * 16 + bc);
        ldmatrix_x4(bv, Vt + (nn * 16 + br) * LDS + kk * 16 + bc);
        mma_bf16(s[2 * nn], a, bk[0], bk[1]);
        mma_bf16(s[2 * nn + 1], a, bk[2], bk[3]);
        mma_bf16(dp[2 * nn], ao, bv[0], bv[1]);
        mma_bf16(dp[2 * nn + 1], ao, bv[2], bv[3]);
      }
    }

    // P and dS in place of dP; masks only on tiles that cross a boundary
    const bool edge = k0 + BC > Sk || wrow + 16 > Sq ||
                      (causal && k0 + BC - 1 > wrow) ||
                      (use_window && wrow + 15 - k0 >= window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p =
            fast_exp2(__fsub_rn(__fmul_rn(s[n][e], scale_log2), lse2[r]));
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1), qp = wrow + g + 8 * r;
          if (key >= Sk || qp >= Sq || (causal && key > qp) ||
              (use_window && qp - key >= window))
            p = 0.f;
        }
        dp[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], dsv[r]));
      }
    }

    // dQ += dS K, dS split hi + lo
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t sh[4], sl[4];
      split_a(dp[2 * kk], dp[2 * kk + 1], sh, sl);
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, Kt + (kk * 16 + ar) * LDS + dd * 16 + ac);
        mma_bf16(dqa[2 * dd], sh, bk[0], bk[1]);
        mma_bf16(dqa[2 * dd + 1], sh, bk[2], bk[3]);
        mma_bf16(dqa[2 * dd], sl, bk[0], bk[1]);
        mma_bf16(dqa[2 * dd + 1], sl, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait_all();  // the last (empty) group, before the CTA exits

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = wrow + g + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* out =
        dq + ((static_cast<size_t>(b) * Sq + qp) * H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(__fmul_rn(dqa[n][2 * r], scale),
                                __fmul_rn(dqa[n][2 * r + 1], scale));
  }
}

// ---------------------------------------------------------------------------
// launch

// The kernels of (dtype, HD) with their launch shapes.
struct Kernels {
  const void* dot;
  const void* dkdv;
  const void* dq;
  int dkdv_keys, dkdv_threads, dkdv_smem;  // keys a dkdv CTA
  int dq_rows, dq_threads, dq_smem;        // query rows a dq CTA
  bool mma;
};

template <int HD>
Kernels kernels_of(int dtype) {
  if (dtype == 1) {
    using S = BwdShape<HD>;
    return {reinterpret_cast<const void*>(
                flash_attention_bwd_dot_kernel<__nv_bfloat16>),
            reinterpret_cast<const void*>(
                flash_attention_bwd_dkdv_kernel_mma<HD>),
            reinterpret_cast<const void*>(
                flash_attention_bwd_dq_kernel_mma<HD>),
            S::kKeys, S::kThreads, S::kDkdvSmem,
            S::kRows, S::kDqThreads, S::kDqSmem, true};
  }
  return {reinterpret_cast<const void*>(flash_attention_bwd_dot_kernel<float>),
          reinterpret_cast<const void*>(
              flash_attention_bwd_dkdv_kernel<float, HD>),
          reinterpret_cast<const void*>(
              flash_attention_bwd_dq_kernel<float, HD>),
          kKeys, kThreads, smem_bytes<HD>(),
          kRows, kThreads, smem_bytes<HD>(), false};
}

bool kernels_for(int dtype, int hd, Kernels* c) {
  if (dtype != 0 && dtype != 1) return false;
  switch (hd) {
    case 16: *c = kernels_of<16>(dtype); return true;
    case 32: *c = kernels_of<32>(dtype); return true;
    case 64: *c = kernels_of<64>(dtype); return true;
    case 80: *c = kernels_of<80>(dtype); return true;
    case 128: *c = kernels_of<128>(dtype); return true;
    case 256: *c = kernels_of<256>(dtype); return true;
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
// (0 = f32: flash_attention_bwd_{dkdv,dq}_kernel, 1 = bf16:
// flash_attention_bwd_{dkdv,dq}_kernel_mma), 16-byte aligned.  lse:
// [B, H, Sq] f32, the forward's log-sum-exp (natural log); dsum: [B, H, Sq]
// f32 scratch for D.  `window` is used when use_window is 1; every query
// row must see a key.  Launches the three kernels asynchronously on
// `stream`; returns cudaGetLastError().

extern "C" int synergai_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, float* dsum, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int H, int K, int hd,
    int causal, int use_window, int window, float scale,
    cudaStream_t stream) {
  Kernels c;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0 ||
      !kernels_for(dtype, hd, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  // > 48 KB of shared memory, once for each kernel
  static bool configured[2][6] = {};
  const int slot = slot_of(hd);
  if (!configured[dtype][slot]) {
    const void* fns[] = {c.dkdv, c.dq};
    const int smem[] = {c.dkdv_smem, c.dq_smem};
    for (int i = 0; i < 2; ++i) {
      const cudaError_t e = cudaFuncSetAttribute(
          fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[i]);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    configured[dtype][slot] = true;
  }
  long long rows = static_cast<long long>(B) * Sq * H;
  const long long dot_blocks = (rows * 32 + kThreads - 1) / kThreads;
  const long long key_blocks = (Sk + c.dkdv_keys - 1) / c.dkdv_keys;
  const long long query_blocks = (Sq + c.dq_rows - 1) / c.dq_rows;
  if (dot_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // f32: (block, b x head) grids as the first kernels had them; bf16:
  // (b x head, block), so that in launch order every (b, head)'s heaviest
  // block comes before any lighter one
  dim3 dkdv_grid, dq_grid;
  if (c.mma) {
    if (key_blocks > 65535 || query_blocks > 65535 ||
        static_cast<long long>(B) * H > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    dkdv_grid = dim3(static_cast<unsigned>(B * K),
                     static_cast<unsigned>(key_blocks));
    dq_grid = dim3(static_cast<unsigned>(B * H),
                   static_cast<unsigned>(query_blocks));
  } else {
    if (static_cast<long long>(B) * H > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    dkdv_grid = dim3(static_cast<unsigned>(key_blocks),
                     static_cast<unsigned>(B * K));
    dq_grid = dim3(static_cast<unsigned>(query_blocks),
                   static_cast<unsigned>(B * H));
  }
  // the mma kernels work in the log2 domain: scale * log2(e), rounded once
  float scale_log2 = scale * 1.4426950408889634f;

  void* dot_args[] = {&o, &dout, &dsum, &rows, &Sq, &H, &hd};
  cudaLaunchKernel(c.dot, dim3(static_cast<unsigned>(dot_blocks)), kThreads,
                   dot_args, 0, stream);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // the f32 kernels take every argument but the last (scale_log2)
  void* dkdv_args[] = {&q, &k, &v, &dout, &lse, &dsum, &dk, &dv, &Sq, &Sk,
                       &H, &K, &causal, &use_window, &window, &scale,
                       &scale_log2};
  cudaLaunchKernel(c.dkdv, dkdv_grid, c.dkdv_threads, dkdv_args,
                   c.dkdv_smem, stream);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  void* dq_args[] = {&q, &k, &v, &dout, &lse, &dsum, &dq, &Sq, &Sk, &H, &K,
                     &causal, &use_window, &window, &scale, &scale_log2};
  cudaLaunchKernel(c.dq, dq_grid, c.dq_threads, dq_args, c.dq_smem, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* synergai_flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
