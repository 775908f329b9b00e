// Decode attention for Hopper (sm_90a): one query token per head against
// the KV cache, split-K flash-decoding in one launch, f32 or bf16 in and out.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/decode_attention.py:_decode_kernel (decode_attention)
// and computes its function, not its block structure: for each (b, kv head)
// the G = H / K query heads kh*G .. kh*G+G-1 score every cache position,
//   s = (q . k) * (1 / sqrt(hd)) in f32, -1e30 at positions >= k_valid,
// and the output is softmax(s) . v with f32 accumulation.
//
// Bound.  Bytes: the K and V rows of the kv_end = min(k_valid, S) visible
// positions are read once (2 * B * kv_end * K * hd elements); q and o are
// small.  A decode step does 4 * hd flops per (head, position), about 1 flop
// per byte in bf16, far below the card's ~295 flops per byte, so CUDA cores
// do the arithmetic and the design is about keeping bytes in flight.
//
// Design.  The TPU kernel walks the cache in order on one core.  Here the
// grid is (n_split, B * K * row blocks): the wrapper's plan_splits cuts the
// kv_end visible positions into n_split splits of whole 32-key tiles (about
// two CTAs an SM), and a row block holds up to RB = 4 (G <= 4) or 8 query
// rows of one kv head.  Only positions below kv_end are read: a key at or
// past k_valid would score -1e30 and, next to a visible key, add
// exp(-1e30 - m) = 0, so leaving it out is exact.  (With k_valid <= 0 every
// key is masked; then kv_end = S and all score -1e30, as in the reference.)
//
//   * A CTA (4 warps) streams its split's K and V tiles through a ring of
//     2-4 shared-memory stages filled by 16-byte cp.async, in the input
//     dtype (widened to f32 as they are read), the next tiles in flight
//     while one is scored: one barrier a tile.
//   * Lane l of each warp holds elements 4l .. 4l+3 (+128 per chunk) of the
//     RB query rows in registers.  A warp scores 32 / RB keys of the tile at
//     once: 32 partial dot products a lane, summed over the warp by a
//     transposing butterfly (31 shuffles) that leaves lane l the score of
//     row l / KW, key l % KW.  Each warp keeps a running (max m, sum l,
//     acc = sum exp(s - m) v) for its rows over the tiles it scores (online
//     softmax); the four warps are merged in warp order at the end.
//   * The combine is the last-CTA pattern of CUTLASS's split-K semaphore:
//     every CTA writes its f32 partial (m, l, acc), and thread 0 takes a
//     ticket on the (b, kv head, row block) counter with one acq_rel atomic
//     (after a barrier, so the release covers the CTA's writes).  The CTA
//     that draws the last ticket stages every split's partial in shared
//     memory with one round of cp.async, merges them in split order
//     (M = max m, L = sum l exp(m - M), out = sum acc exp(m - M) /
//     max(L, 1e-30)), writes the output in q's dtype and resets the counter
//     to 0.  The sums run in split order whichever CTA finishes last, so the
//     result is the same on every call.  With one split the CTA writes the
//     output itself.  plan_splits keeps the staged partials within 96 KB.
//
// With a non-null lse (the instances with LSE = true) the kernel also writes
// each query row's log-sum-exp of the scaled, masked scores, M + log L in
// f32, where it holds M and L (the single CTA, or the last CTA's merge), and
// writes the output in f32, unrounded: a merge of several such outputs (the
// sharded flash-decode) then rounds once.  Rounded to bf16 it is bit-equal
// to the bf16 instance's output.  With every key masked (k_valid <= 0) the
// lse is about -1e30 + log S.
//
// The counters are a small int32 buffer the wrapper keeps per device and
// stream, zero between calls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                // keys a ring stage holds
constexpr int kRingBudget = 96 * 1024;   // bytes: 2-4 stages
constexpr float kMask = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // sm_90 opt-in limit per block
constexpr int kMaxDevices = 64;   // the opt-ins are kept per device

template <int HD, typename T, int RB>
struct Cfg {
  static constexpr int kKW = 32 / RB;            // keys a warp scores at once
  static constexpr int kCH = (HD + 127) / 128;   // 4-element chunks a lane
  static constexpr int kTileElems = kTile * HD;  // one K (or V) tile
  static constexpr int kStageBytes = 2 * kTileElems * int(sizeof(T));
  static constexpr int kStages =
      kRingBudget / kStageBytes > 4
          ? 4
          : (kRingBudget / kStageBytes < 2 ? 2 : kRingBudget / kStageBytes);
  static constexpr int kRing = kStages * kStageBytes;
  // the warps' (m, l, acc) in the idle ring at the end
  static constexpr int kMerge = 4 * kWarps * RB * (HD + 2);
};

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v[0..N) on every lane of a warp, N = 32 at the top: after it, v[0] of lane
// l is the warp's sum of v[l].  Each step keeps the half of v that the
// lane's bit N/2 selects and adds the partner lane's copy of that half.
template <int N>
__device__ __forceinline__ void transpose_sum(float* v, int lane) {
  if constexpr (N > 1) {
    constexpr int H = N / 2;
    const bool up = lane & H;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, H));
    }
    transpose_sum<H>(v, lane);
  }
}

// the output's type: f32 in the instances that write the lse
template <typename T, bool LSE>
using Out = std::conditional_t<LSE, float, T>;

template <int HD, typename T, int RB, bool LSE>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, Out<T, LSE>* __restrict__ o,
                        float* __restrict__ lse, float* __restrict__ part,
                        int* __restrict__ counters, int B, int S, int H,
                        int K, int k_valid, int kv_end, int n_split,
                        float scale) {
  using C = Cfg<HD, T, RB>;
  constexpr int KW = C::kKW, CH = C::kCH, NST = C::kStages;
  constexpr int VEC = 16 / int(sizeof(T));  // elements of a 16-byte copy
  constexpr int CPR = HD / VEC;             // 16-byte copies a row
  constexpr int REC = HD + 4;               // a partial: m, l, -, -, acc
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);    // [NST][K, V][kTile][HD]
  __shared__ __align__(16) float ps[kWarps][32];  // a warp's probabilities
  __shared__ float as[kWarps][RB];          // a warp's rescale factors
  __shared__ int is_last;

  const int G = H / K;
  const int n_rb = (G + RB - 1) / RB;
  const int split = blockIdx.x;
  const int bk = blockIdx.y / n_rb, rb = blockIdx.y % n_rb;
  const int b = bk / K, kh = bk % K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t BH = static_cast<size_t>(B) * H;

  // this split's tiles: [t0, t0 + nt) of ceil(kv_end / kTile), nt >= 1
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  const int t0 = static_cast<int>(static_cast<long long>(split) * n_tiles /
                                  n_split);
  const int nt = static_cast<int>(static_cast<long long>(split + 1) *
                                  n_tiles / n_split) - t0;

  auto issue = [&](int i) {  // tile t0 + i into stage i % NST
    T* Ks = ring + (i % NST) * 2 * C::kTileElems;
    T* Vs = Ks + C::kTileElems;
    const int key0 = (t0 + i) * kTile;
    for (int e = tid; e < kTile * CPR; e += kThreads) {
      const int j = e / CPR, c = (e % CPR) * VEC;
      const bool ok = key0 + j < kv_end;
      const size_t off =
          ((static_cast<size_t>(b) * S + (ok ? key0 + j : 0)) * K + kh) *
              HD + c;
      cp_async16(Ks + j * HD + c, k + off, ok);
      cp_async16(Vs + j * HD + c, v + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < nt) issue(i);
    cp_async_commit();
  }

  // the row block's query rows, lane l's elements 4l .. 4l+3 of each chunk
  float qr[RB][CH][4];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int g = rb * RB + r;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int d = 4 * lane + 128 * c;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < G && d < HD)
        x = load4(q + (static_cast<size_t>(b) * H + kh * G + g) * HD + d);
      qr[r][c][0] = x.x;
      qr[r][c][1] = x.y;
      qr[r][c][2] = x.z;
      qr[r][c][3] = x.w;
    }
  }

  float acc[RB][CH][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.f;
  float m_run = -CUDART_INF_F;  // the running max of row lane / KW
  float l_run = 0.f;            // this lane's share of that row's sum

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<NST - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();           // ... everyone's; stage (i - 1) % NST is free
    if (i + NST - 1 < nt) issue(i + NST - 1);
    cp_async_commit();
    const T* Ks = ring + (i % NST) * 2 * C::kTileElems;
    const T* Vs = Ks + C::kTileElems;
    const int key0 = (t0 + i) * kTile;
    const int n = min(kTile, kv_end - key0);
    for (int kb = warp * KW; kb < n; kb += kWarps * KW) {
      float dots[32];  // dots[r * KW + kk]: row r . key kb + kk, this lane
#pragma unroll
      for (int kk = 0; kk < KW; ++kk) {
        float kx[CH][4];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int d = 4 * lane + 128 * c;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (d < HD) x = load4(Ks + (kb + kk) * HD + d);
          kx[c][0] = x.x;
          kx[c][1] = x.y;
          kx[c][2] = x.z;
          kx[c][3] = x.w;
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < CH; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) s = __fmaf_rn(qr[r][c][e], kx[c][e], s);
          dots[r * KW + kk] = s;
        }
      }
      transpose_sum<32>(dots, lane);
      const int kk = lane % KW;
      float s = __fmul_rn(dots[0], scale);
      if (kb + kk >= n)
        s = -CUDART_INF_F;
      else if (key0 + kb + kk >= k_valid)
        s = kMask;
      float tmax = s;
#pragma unroll
      for (int off = KW / 2; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, off));
      const float m_new = fmaxf(m_run, tmax);
      const float alpha =
          m_new == -CUDART_INF_F ? 1.f : expf(m_run - m_new);
      const float p = s == -CUDART_INF_F ? 0.f : expf(s - m_new);
      l_run = __fadd_rn(__fmul_rn(l_run, alpha), p);
      m_run = m_new;
      ps[warp][lane] = p;
      if (kk == 0) as[warp][lane / KW] = alpha;
      __syncwarp();
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float a = as[warp][r];
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][c][e] = __fmul_rn(acc[r][c][e], a);
      }
      float pr[RB][KW];  // every (row, key) probability of these keys
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int j = 0; j < KW; j += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(&ps[warp][r * KW + j]);
          pr[r][j] = x.x;
          pr[r][j + 1] = x.y;
          pr[r][j + 2] = x.z;
          pr[r][j + 3] = x.w;
        }
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        float vx[CH][4];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int d = 4 * lane + 128 * c;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (d < HD) x = load4(Vs + (kb + j) * HD + d);
          vx[c][0] = x.x;
          vx[c][1] = x.y;
          vx[c][2] = x.z;
          vx[c][3] = x.w;
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float pj = pr[r][j];
#pragma unroll
          for (int c = 0; c < CH; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][c][e] = __fmaf_rn(pj, vx[c][e], acc[r][c][e]);
        }
      }
      __syncwarp();  // ps and as are rewritten by the next keys
    }
  }
  cp_async_wait<0>();  // the trailing (empty) groups
  float l_row = l_run;  // the row's sum over its KW lanes, in a fixed tree
#pragma unroll
  for (int off = KW / 2; off > 0; off >>= 1)
    l_row = __fadd_rn(l_row, __shfl_xor_sync(kFull, l_row, off));
  __syncthreads();  // every warp is done with the ring

  // the warps' (m, l, acc) into the idle ring, merged in warp order
  float* wm = reinterpret_cast<float*>(smem4);  // [kWarps][RB]
  float* wl = wm + kWarps * RB;                 // [kWarps][RB]
  float* wa = wl + kWarps * RB;                 // [kWarps][RB][HD]
  if (lane % KW == 0) {
    wm[warp * RB + lane / KW] = m_run;
    wl[warp * RB + lane / KW] = l_row;
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int d = 4 * lane + 128 * c;
      if (d < HD)
        *reinterpret_cast<float4*>(wa + (warp * RB + r) * HD + d) =
            make_float4(acc[r][c][0], acc[r][c][1], acc[r][c][2],
                        acc[r][c][3]);
    }
  __syncthreads();
  for (int e = tid; e < RB * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, g = rb * RB + r;
    if (g >= G) break;
    float M = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * RB + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * RB + r];
      const float f = mw == -CUDART_INF_F ? 0.f : expf(mw - M);
      L = __fmaf_rn(wl[w * RB + r], f, L);
      A = __fmaf_rn(wa[(w * RB + r) * HD + d], f, A);
    }
    const size_t row = static_cast<size_t>(b) * H + kh * G + g;
    if (n_split == 1) {
      store1(o + row * HD + d, __fdiv_rn(A, fmaxf(L, 1e-30f)));
      if constexpr (LSE) {
        if (d == 0) lse[row] = __fadd_rn(M, logf(L));
      }
    } else {
      float* rec = part + (split * BH + row) * REC;
      rec[4 + d] = A;
      if (d == 0) {
        rec[0] = M;
        rec[1] = L;
      }
    }
  }
  if (n_split == 1) return;

  // the last CTA of this (b, kv head, row block) merges the partials
  __syncthreads();  // the CTA's partial written; thread 0 releases it
  if (tid == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(counters + blockIdx.y) : "memory");
    is_last = old == n_split - 1;
  }
  __syncthreads();
  if (!is_last) return;
  // every split's record of the row block into shared memory at once
  float* recs = reinterpret_cast<float*>(smem4);  // [RB][n_split][REC]
  constexpr int Q = REC / 4;                      // 16-byte pieces a record
  for (int e = tid; e < RB * n_split * Q; e += kThreads) {
    const int rs = e / Q, c = e % Q;
    const int r = rs / n_split, s = rs % n_split;
    const int g = min(rb * RB + r, G - 1);
    cp_async16(recs + rs * REC + 4 * c,
               part + (s * BH + static_cast<size_t>(b) * H + kh * G + g) *
                          REC + 4 * c,
               true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  __shared__ float Mrow[RB], Lrow[RB];
  if (tid < RB) {  // each row's M
    float M = -CUDART_INF_F;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, recs[(tid * n_split + s) * REC]);
    Mrow[tid] = M;
  }
  __syncthreads();
  for (int e = tid; e < RB * n_split; e += kThreads)  // weights exp(m - M)
    recs[e * REC + 2] = expf(recs[e * REC] - Mrow[e / n_split]);
  __syncthreads();
  if (tid < RB) {  // L, in split order
    const float* rr = recs + tid * n_split * REC;
    float L = 0.f;
    for (int s = 0; s < n_split; ++s)
      L = __fmaf_rn(rr[s * REC + 1], rr[s * REC + 2], L);
    Lrow[tid] = fmaxf(L, 1e-30f);
    if constexpr (LSE) {
      if (rb * RB + tid < G)
        lse[static_cast<size_t>(b) * H + kh * G + rb * RB + tid] =
            __fadd_rn(Mrow[tid], logf(L));
    }
  }
  __syncthreads();
  for (int e = tid; e < RB * HD / 4; e += kThreads) {
    const int r = e / (HD / 4), d = (e % (HD / 4)) * 4, g = rb * RB + r;
    if (g >= G) break;
    const float* rr = recs + r * n_split * REC;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_split; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(rr + s * REC + 4 + d);
      const float f = rr[s * REC + 2];
      a.x = __fmaf_rn(x.x, f, a.x);
      a.y = __fmaf_rn(x.y, f, a.y);
      a.z = __fmaf_rn(x.z, f, a.z);
      a.w = __fmaf_rn(x.w, f, a.w);
    }
    Out<T, LSE>* out = o + (static_cast<size_t>(b) * H + kh * G + g) * HD + d;
    store1(out, __fdiv_rn(a.x, Lrow[r]));
    store1(out + 1, __fdiv_rn(a.y, Lrow[r]));
    store1(out + 2, __fdiv_rn(a.z, Lrow[r]));
    store1(out + 3, __fdiv_rn(a.w, Lrow[r]));
  }
  if (tid == 0) counters[blockIdx.y] = 0;  // ready for the next call
}

template <int HD, typename T, int RB, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           float* part, int* counters, int B, int S, int H, int K,
           int k_valid, int kv_end, int n_split, float scale,
           cudaStream_t stream) {
  using C = Cfg<HD, T, RB>;
  const long long rows = static_cast<long long>(B) * K *
                         ((H / K + RB - 1) / RB);
  int smem = C::kRing > C::kMerge ? C::kRing : C::kMerge;
  const int merge = 4 * RB * n_split * (HD + 4);  // the partials, staged
  if (merge > smem) smem = merge;
  if (smem > kMaxSmem || rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the dynamic shared memory opted in to so far, on each device (the
  // attribute is set for the device that is current)
  static int opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > opted[dev]) {
    e = cudaFuncSetAttribute(decode_attention_kernel<HD, T, RB, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = smem;
  }
  decode_attention_kernel<HD, T, RB, LSE>
      <<<dim3(n_split, static_cast<unsigned>(rows)), kThreads, smem,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<Out<T, LSE>*>(o),
                   lse, part, counters, B, S, H, K, k_valid, kv_end, n_split,
                   scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RB>
int launch_rows(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, float* part, int* counters, int B, int S, int H,
                int K, int k_valid, int kv_end, int n_split, float scale,
                cudaStream_t stream) {
  switch (hd) {
#define SYNERGAI_HD(N)                                                       \
  case N:                                                                    \
    return lse != nullptr                                                    \
               ? launch<N, T, RB, true>(q, k, v, o, lse, part, counters, B,  \
                                        S, H, K, k_valid, kv_end, n_split,   \
                                        scale, stream)                       \
               : launch<N, T, RB, false>(q, k, v, o, lse, part, counters, B, \
                                         S, H, K, k_valid, kv_end, n_split,  \
                                         scale, stream);
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

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             float* lse, float* part, int* counters, int B, int S, int H,
             int K, int k_valid, int kv_end, int n_split, float scale,
             cudaStream_t stream) {
  // row blocks of 8 query rows where G = H / K > 4, else of 4
  return H / K > 4
             ? launch_rows<T, 8>(hd, q, k, v, o, lse, part, counters, B, S, H,
                                 K, k_valid, kv_end, n_split, scale, stream)
             : launch_rows<T, 4>(hd, q, k, v, o, lse, part, counters, B, S, H,
                                 K, k_valid, kv_end, n_split, scale, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes.  q: [B, 1, H, hd]; k, v:
// [B, S, K, hd]; contiguous device tensors of one dtype (0 = f32,
// 1 = bf16), 16-byte aligned.  o: [B, 1, H, hd], in that dtype when lse is
// null, else f32; lse: null, or [B, H] f32, each row's log-sum-exp of its
// scaled, masked scores.  kv_end = min(k_valid, S) for k_valid >= 1 and S
// otherwise; n_split in 1 .. ceil(kv_end / 32) (split s takes the 32-key
// tiles [s * n / n_split, (s + 1) * n / n_split) of the n =
// ceil(kv_end / 32)).  part: [n_split, B * H, hd + 4] f32 scratch, one
// partial (m, l, -, -, acc[hd]) a split and head (unused when n_split = 1);
// counters: B * K * ceil(G / RB) int32, zero, left zero (RB = 4 for
// G = H / K <= 4, else 8), not shared with a call in flight on another
// stream.  Launches one kernel asynchronously on `stream`; returns
// cudaGetLastError().

extern "C" int synergai_decode_attention(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         float* part, int* counters,
                                         int dtype, int B, int S, int H,
                                         int K, int hd, int k_valid,
                                         int kv_end, int n_split, float scale,
                                         cudaStream_t stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || kv_end <= 0 ||
      kv_end > S || n_split < 1 || n_split > (kv_end + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, lse, part, counters, B, S, H, K,
                           k_valid, kv_end, n_split, scale, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, lse, part, counters, B, S,
                                   H, K, k_valid, kv_end, n_split, scale,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The keys a ring stage holds, which plan_splits cuts the cache by.
extern "C" int synergai_decode_tile() { return kTile; }

extern "C" const char* synergai_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
