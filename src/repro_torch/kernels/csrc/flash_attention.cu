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
// q.reshape(B, Sq, K, G, hd).  For one (b, kv head) the G query heads of
// every query position form Sq * G rows, position-major, so a CTA's rows
// share every K/V tile whatever G is (Hymba's G = 5 included).
//
// Two kernels, chosen by dtype in synergai_flash_attention (no fallback
// from one to the other):
//
// flash_attention_kernel_mma (bf16, the serving path).  Tensor cores
// through mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulator).  Each warp
// owns 16 rows and their (m, l, O) in registers; a CTA is 4 warps and 64
// rows.  At hd 128 that is ~210 registers a thread, so two CTAs share an
// SM and one's barrier overlaps the other's work (8 warps and 128 rows, one
// CTA an SM, measured slower; a 16 x 256 f32 O alone is 128 registers a
// thread).  Q is staged once in shared memory (and held as A fragments in
// registers at hd <= 128); K and V
// stay bf16 in a two-stage shared-memory ring filled by cp.async, the next
// tile's loads in flight while this tile's mma run, one barrier a tile.
// Rows are padded by 16 bytes, so the ldmatrix reads of 8 rows hit 8
// different 16-byte bank groups at every head dim.  Key tiles are 64 wide
// (32 at hd 256, for registers).  Dynamic shared memory is
// 2 (hd + 8)(64 + 4 keys) bytes: Q and two K and V stages, 87,040 at hd 128.
//   S = Q K^T: A from Q (ldmatrix), B from K rows (ldmatrix, K is [key][d],
//   which is B's column-major layout).  The products of bf16 inputs are
//   exact in f32; only the order of the f32 sums differs from the plain
//   version.  Scores are scaled into the log2 domain and exponentiated with
//   ex2.approx (relative error ~2^-22, results below 2^-126 flushed to 0);
//   masks and the -inf of keys past Sk are applied only on tiles that cross
//   a boundary, and O is rescaled only when a row's running max moved.
//   O += P V: the S accumulator's fragment layout is the A operand's, so P
//   never leaves registers.  One bf16 P would err by up to 2^-9 of each
//   probability, more than the bf16 bound's atol of 1e-5 where an output is
//   near zero, so P is split: P_hi = bf16(P), P_lo = bf16(P - P_hi) (the
//   difference is exact in f32), two mma against the same V fragment
//   (ldmatrix.trans); the error left is <= 2^-18 |P|.  l sums the f32 P.
//   Tiles that every row of the CTA masks are skipped (below), and so is a
//   tile wholly above a warp's causal diagonal for that warp.
//
// flash_attention_kernel_fma (f32).  Plain f32 FMAs: a TF32 product keeps
// ~3 decimal digits and cannot hold the f32 bound (2e-5).  64 rows a CTA as
// f32 in shared memory, 32-key K/V tiles widened to f32, 256 threads as a
// 16 x 16 grid (thread (ty, tx): rows 4ty..4ty+3, keys tx and tx + 16, head
// dims tx + 16c of the accumulator), P through shared memory once.
//
// Both: any Sq, Sk (the tails are masked; a key past Sk scores -inf and adds
// exactly nothing).  Under causal masking key 0 is visible to every row, and
// under a window every row sees its own position, so once a visible key has
// set m a wholly masked tile would add exp(-1e30 - m) = 0 and is skipped.
// (The window skip is used only when every row's own position is a key,
// i.e. q_pos < Sk.)
//
// Both write each row's log-sum-exp of the scaled, masked scores, in
// natural-log units, to `lse` [B, H, Sq] f32 when the pointer is not null
// (training: the backward, flash_attention_bwd.cu, recomputes
// P = exp(s - lse) from it); serving passes null.  Whether they write it is
// a template flag (LSE), so the serving instances are the kernels without
// it.  The mma kernel's running max is in the log2 domain, so its lse is
// m ln 2 + ln l.
//
// Bound.  Operations: 4 * hd flops per visible (query head, key) pair at
// the card's dense bf16 tensor-core peak, 989 TFLOP/s (67 TFLOP/s f32
// outside the tensor cores): 34.4 GFLOP, 0.0348 ms at the serving shape
// [4, 1024, 32, 8, 128] causal.  The split P.V does 6 * hd flops a pair on
// the tensor cores, 0.052 ms at the peak.  Bytes (q, k, v read and o written
// once) are two orders of magnitude below.  mma.sync reaches well under the
// wgmma peak, so this design aims at a few times the bound; wgmma with TMA
// (64-row warpgroup tiles, descriptors, swizzled shared memory) is the next
// step towards it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kMask = -1.0e30f;
constexpr float kLn2 = 0.693147180559945309f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // sm_90 opt-in limit per block

// ---------------------------------------------------------------------------
// bf16: tensor cores

template <int HD>
struct MmaShape {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;      // query rows per CTA
  static constexpr int kKeys = HD <= 128 ? 64 : 32;  // keys per K/V tile
  static constexpr int kLds = HD + 8;            // padded row, bf16 elements
  static constexpr bool kQInRegs = HD <= 128;
  static constexpr int kSmem = 2 * (kRows * kLds + 2 * 2 * kKeys * kLds);
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

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(kFull, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(kFull, x, 2));
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(MmaShape<HD>::kThreads)
flash_attention_kernel_mma(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Sk, int H,
                           int K, int causal, int use_window, int window,
                           float scale_log2) {
  using S = MmaShape<HD>;
  constexpr int LDS = S::kLds, BC = S::kKeys, KS = HD / 16, NT = BC / 8;
  constexpr int CH = HD / 8;  // 16-byte chunks in a row
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [rows][LDS]
  __nv_bfloat16* KVs = Qs + S::kRows * LDS;  // [stage][K, V][BC][LDS]

  const int G = H / K;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int row0 = blockIdx.x * S::kRows;
  const int n_rows = Sq * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // ldmatrix addressing: lane l gives row l % 8 of matrix l / 8
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // Q and V^T
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8;        // K
  const int k_col = ((lane >> 3) & 1) * 8;

  for (int e = tid; e < S::kRows * CH; e += S::kThreads) {
    const int r = e / CH, c = e % CH, row = row0 + r;
    const bool ok = row < n_rows;
    const int qp = ok ? row / G : 0, hq = ok ? kh * G + row % G : 0;
    cp_async16(Qs + r * LDS + c * 8,
               q + ((static_cast<size_t>(b) * Sq + qp) * H + hq) * HD + c * 8,
               ok);
  }

  const int qp_lo = row0 / G;
  const int qp_hi = (min(row0 + S::kRows, n_rows) - 1) / G;
  int kt_end = (Sk + BC - 1) / BC;
  if (causal) kt_end = min(kt_end, qp_hi / BC + 1);
  int kt_begin = 0;
  if (causal && use_window && qp_hi < Sk)
    kt_begin = max(0, (qp_lo - window + 1) / BC);

  auto load_kv = [&](int kt, int stage) {
    __nv_bfloat16* Ks = KVs + stage * 2 * BC * LDS;
    __nv_bfloat16* Vs = Ks + BC * LDS;
    for (int e = tid; e < BC * CH; e += S::kThreads) {
      const int j = e / CH, c = e % CH, key = kt * BC + j;
      const bool ok = key < Sk;
      const size_t off =
          ((static_cast<size_t>(b) * Sk + (ok ? key : 0)) * K + kh) * HD +
          c * 8;
      cp_async16(Ks + j * LDS + c * 8, k + off, ok);
      cp_async16(Vs + j * LDS + c * 8, v + off, ok);
    }
  };
  load_kv(kt_begin, 0);
  cp_async_commit();

  // this thread's two rows: g and g + 8 of the warp's 16
  const int wrow = row0 + warp * 16;
  const int qpos[2] = {(wrow + g) / G, (wrow + g + 8) / G};
  const int wqp_hi = (min(wrow + 16, n_rows) - 1) / G;

  uint32_t qf[S::kQInRegs ? KS : 1][4];
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < kt_end) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    if constexpr (S::kQInRegs) {
      if (kt == kt_begin) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldmatrix_x4(qf[kk], Qs + (warp * 16 + a_row) * LDS + kk * 16 +
                                  a_col);
      }
    }
    const int k0 = kt * BC;
    if (wrow >= n_rows || (causal && k0 > wqp_hi)) continue;  // warp-uniform
    const __nv_bfloat16* Ks = KVs + stage * 2 * BC * LDS;
    const __nv_bfloat16* Vs = Ks + BC * LDS;

    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (S::kQInRegs) {
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] = qf[kk][x];
      } else {
        ldmatrix_x4(a, Qs + (warp * 16 + a_row) * LDS + kk * 16 + a_col);
      }
#pragma unroll
      for (int nn = 0; nn < BC / 16; ++nn) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Ks + (nn * 16 + k_row) * LDS + kk * 16 + k_col);
        mma_bf16(s[2 * nn], a, bk[0], bk[1]);
        mma_bf16(s[2 * nn + 1], a, bk[2], bk[3]);
      }
    }

    // scale into the log2 domain, mask on boundary tiles, online softmax
    const bool edge = k0 + BC > Sk || (causal && k0 + BC - 1 > qp_lo) ||
                      (use_window && qp_hi - k0 >= window);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[n][e], scale_log2);
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1), qp = qpos[e >> 1];
          if (key >= Sk)
            x = -CUDART_INF_F;
          else if ((causal && key > qp) || (use_window && qp - key >= window))
            x = kMask;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = fast_exp2(__fsub_rn(m[r], m_new));
      m[r] = m_new;
      l[r] = __fmul_rn(l[r], corr[r]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(__fsub_rn(s[n][e], m[e >> 1]));
        s[n][e] = p;
        l[e >> 1] = __fadd_rn(l[e >> 1], p);
      }
    }
    if (corr[0] != 1.f || corr[1] != 1.f) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] = __fmul_rn(acc[n][0], corr[0]);
        acc[n][1] = __fmul_rn(acc[n][1], corr[0]);
        acc[n][2] = __fmul_rn(acc[n][2], corr[1]);
        acc[n][3] = __fmul_rn(acc[n][3], corr[1]);
      }
    }

    // O += P_hi V + P_lo V, P from the S registers
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vs + (kk * 16 + a_row) * LDS + dd * 16 + a_col);
        mma_bf16(acc[2 * dd], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * dd + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * dd], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * dd + 1], pl, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();  // the last (empty) group, before the CTA exits

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);
    const int row = wrow + g + 8 * r;
    if (row >= n_rows) continue;
    if (LSE && t == 0)
      lse[(static_cast<size_t>(b) * H + kh * G + row % G) * Sq + qpos[r]] =
          __fadd_rn(__fmul_rn(m[r], kLn2), logf(denom));
    __nv_bfloat16* out =
        o + ((static_cast<size_t>(b) * Sq + qpos[r]) * H + kh * G + row % G) *
                HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
          __floats2bfloat162_rn(__fdiv_rn(acc[n][2 * r], denom),
                                __fdiv_rn(acc[n][2 * r + 1], denom));
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMAs

constexpr int kFmaRows = 64;      // query rows per CTA
constexpr int kFmaKeys = 32;      // keys per K/V tile
constexpr int kFmaThreads = 256;  // 16 x 16

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

template <int HD>
constexpr int fma_smem_bytes() {
  return 4 * (kFmaRows * (HD + 4) + kFmaKeys * (HD + 4) + kFmaKeys * HD +
              kFmaRows * (kFmaKeys + 1));
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(kFmaThreads)
flash_attention_kernel_fma(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Sk, int H,
                           int K, int causal, int use_window, int window,
                           float scale) {
  constexpr int QS = HD + 4;        // padded row stride of the Q and K tiles
  constexpr int PS = kFmaKeys + 1;  // padded row stride of the P tile
  constexpr int NC = HD / 16;       // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kFmaRows][QS]
  float* Ks = Qs + kFmaRows * QS;               // [kFmaKeys][QS]
  float* Vs = Ks + kFmaKeys * QS;               // [kFmaKeys][HD]
  float* Ps = Vs + kFmaKeys * HD;               // [kFmaRows][PS]

  const int G = H / K;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int row0 = blockIdx.x * kFmaRows;
  const int n_rows = Sq * G;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int e = tid * 4; e < kFmaRows * HD; e += kFmaThreads * 4) {
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
  const int qp_hi = (min(row0 + kFmaRows, n_rows) - 1) / G;
  int kt_end = (Sk + kFmaKeys - 1) / kFmaKeys;
  if (causal) kt_end = min(kt_end, qp_hi / kFmaKeys + 1);
  int kt_begin = 0;
  if (causal && use_window && qp_hi < Sk)
    kt_begin = max(0, (qp_lo - window + 1) / kFmaKeys);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kFmaKeys;
    __syncthreads();  // the last tile's readers are done (and Q is staged)
    for (int e = tid * 4; e < kFmaKeys * HD; e += kFmaThreads * 4) {
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
    for (int j = 0; j < kFmaKeys; ++j) {
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
    float* out = o + ((static_cast<size_t>(b) * Sq + qpos[i]) * H + kh * G +
                      g) * HD;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      out[tx + 16 * c] = __fdiv_rn(acc[i][c], denom);
    if (LSE && tx == 0)
      lse[(static_cast<size_t>(b) * H + kh * G + g) * Sq + qpos[i]] =
          __fadd_rn(m[i], logf(denom));
  }
}

// ---------------------------------------------------------------------------
// launch

// The kernel of (dtype, HD) with its launch shape.
struct Config {
  const void* fn;
  int threads, rows, smem;
};

template <int HD, bool LSE>
Config config(int dtype) {
  using S = MmaShape<HD>;
  if (dtype == 1)
    return {reinterpret_cast<const void*>(flash_attention_kernel_mma<HD, LSE>),
            S::kThreads, S::kRows, S::kSmem};
  return {reinterpret_cast<const void*>(flash_attention_kernel_fma<HD, LSE>),
          kFmaThreads, kFmaRows, fma_smem_bytes<HD>()};
}

template <int HD>
Config config(int dtype, bool lse) {
  return lse ? config<HD, true>(dtype) : config<HD, false>(dtype);
}

bool config_of(int dtype, int hd, bool lse, Config* c) {
  if (dtype != 0 && dtype != 1) return false;
  switch (hd) {
    case 16: *c = config<16>(dtype, lse); return true;
    case 32: *c = config<32>(dtype, lse); return true;
    case 64: *c = config<64>(dtype, lse); return true;
    case 80: *c = config<80>(dtype, lse); return true;
    case 128: *c = config<128>(dtype, lse); return true;
    case 256: *c = config<256>(dtype, lse); return true;
    default: return false;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  q: [B, Sq, H, hd], k, v:
// [B, Sk, K, hd], o: [B, Sq, H, hd], contiguous device tensors of one dtype
// (0 = f32: flash_attention_kernel_fma, 1 = bf16:
// flash_attention_kernel_mma), 16-byte aligned; lse: [B, H, Sq] f32, or
// null for no log-sum-exp.  `window` is used when use_window is 1.
// Launches asynchronously on `stream`; returns cudaGetLastError().

extern "C" int synergai_flash_attention(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int dtype,
                                        int B, int Sq, int Sk, int H, int K,
                                        int hd, int causal, int use_window,
                                        int window, float scale,
                                        cudaStream_t stream) {
  Config c;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || K <= 0 || H % K != 0 ||
      !config_of(dtype, hd, lse != nullptr, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  // > 48 KB of shared memory, once for each kernel
  static bool configured[2][2][6] = {};
  const int slot = hd == 16 ? 0 : hd == 32 ? 1 : hd == 64 ? 2
                 : hd == 80 ? 3 : hd == 128 ? 4 : 5;
  bool& done = configured[dtype][lse != nullptr][slot];
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  const int G = H / K;
  const long long row_tiles =
      (static_cast<long long>(Sq) * G + c.rows - 1) / c.rows;
  if (row_tiles > 0x7fffffffLL || static_cast<long long>(B) * K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>(B * K));
  // the bf16 kernel works in the log2 domain: scale * log2(e), rounded once
  float scale_arg = dtype == 1 ? scale * 1.4426950408889634f : scale;
  void* args[] = {&q,      &k,          &v,      &o,         &lse,
                  &Sq,     &Sk,         &H,      &K,         &causal,
                  &use_window, &window, &scale_arg};
  cudaLaunchKernel(c.fn, grid, c.threads, args, c.smem, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* synergai_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
