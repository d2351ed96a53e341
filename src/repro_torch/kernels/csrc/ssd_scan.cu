// Mamba2's chunked SSD (state-space duality) scan for Hopper (sm_90a).
//
// Replaces ssd_scan_pallas (_kernel) of src/repro/kernels/ssd_scan/kernel.py.
// For each (batch b, head h) and each chunk of Q steps, with a_cs the
// inclusive cumulative sum of dta over the chunk, a_tot = a_cs[Q-1] and
// h_prev the state the previous chunks left (zero before the first):
//
//   y_diag = ((C B^T) o Lmask) @ xdt,  Lmask[i, j] = exp(a_cs[i] - a_cs[j]), j <= i
//   y_off  = (C h_prev^T) * exp(a_cs)
//   h      = h_prev * exp(a_tot) + xdt^T (B * exp(a_tot - a_cs))
//
// y = y_diag + y_off, and h_final is h after the last chunk.  Shapes: xdt
// (B, L, H, P), dta (B, L, H) fp32, bm/cm (B, L, N), y (B, L, H, P), h_final
// (B, H, P, N); xdt, bm, cm, y and h_final share one type (fp32 or bf16).
// Everything accumulates in fp32 and is rounded once on the way out, as
// the TPU kernel does.  Q is the caller's (any Q >= 1 that divides L).
//
// Design.  The TPU kernel walks the chunks in order, carrying h in VMEM.
// Here the walk is split into the standard chunked-SSD phases, four
// launches behind the one C call, so that only a short elementwise pass is
// sequential and everything else runs chunk-parallel:
//
//   1. ssd_prep, per (b, chunk): a_cs for every head, and C B^T ONCE on the
//      causal triangle of 64 x 64 tiles (B and C have no head axis: all H
//      heads share it).  Writes a_cs (B, H, L) and C B^T (B, NC, Q, Q) to a
//      fp32 workspace.
//   2. ssd_states, per (b, h, chunk, 64 x 64 tile of P x N), in parallel
//      over chunks: the chunk's own state s_c = xdt^T (B * exp(a_tot -
//      a_cs)), to the workspace (B, NC, H, P, N).
//   3. ssd_carry, per (b, h, p, n) element: h_c = h_{c-1} * exp(a_tot_c) +
//      s_c over the NC chunks, overwriting s_c with the state entering
//      chunk c; writes h_final.
//   4. ssd_outputs, per (b, h, chunk, 64-row tile of the chunk, 64-wide
//      tile of P), in parallel: (C h_prev^T) * exp(a_cs) first (skipped
//      for the first chunk, whose h_prev is zero), scaled in registers,
//      then ((C B^T) o Lmask) @ xdt accumulated on top of it over the
//      64 x 32 slabs at or below the diagonal.
//
// At mamba2-1.3b's prefill shape (B 4, L 2048, H 64, P 64, N 128, Q 256) a
// batch-1 call starts 512 blocks in phase 2 and 2048 in phase 4: enough to
// fill 132 SMs at batch 1.
//
// Products on the tensor cores.  Every product is mma.sync m16n8k8 in TF32
// with fp32 accumulation: 128-thread blocks own a 64 x 64 output tile
// (2 x 2 warps of 32 x 32), fed from 32-deep fp32 slabs in shared memory
// whose row strides (36 or 72 floats) keep every fragment load free of
// bank conflicts.  Each thread loads its 16 elements of the next slab into
// registers before the current slab's MMAs (register double buffering), so
// the loads' latency overlaps the tensor-core work.  An fp32 operand x is
// split x = hi + lo (common.cuh's split: hi rounded to TF32, lo exact), and
// a product takes hi*hi + hi*lo + lo*hi ("3xTF32"), about fp32's
// accuracy; a bf16 operand is exact
// in TF32 and is not split.  So in fp32 every product takes three MMAs;
// with bf16 operands C B^T takes one (both exact), and the decayed scores
// @ xdt, the state product (decayed B against xdt) and C h_prev^T take two
// (one fp32 side each).
//
// What bounds each phase (H100 SXM, at the shape above).  Phases 2 and 4
// are bound by operations: their products are 8.6 + 10.7 + 7.5 = 26.8
// GFLOP (the diagonal tiles are whole 64 x 64 squares, not triangles),
// which the TF32 splits make 54 GFLOP of MMA work with bf16 operands and
// 81 in fp32, against the 26.07 GFLOP the algorithm needs.  Within them the
// shared-memory fragment loads (two 32-bit loads per MMA tile and k-step)
// and, in phase 4, one exponential per score element compete with the
// MMAs; C B^T tiles are re-read from L2 by every head and xdt by every row
// tile.  Phase 1 is 0.34 GFLOP of MMA work (1.0 in fp32) and a sequential
// cumulative sum per head.  Phase 3 is bound by bytes: it reads and writes
// the chunk states (67 MB) once, eight chunks' loads in flight together.
// The bound the kernel is held to stays the fp32 count over 67 TFLOP/s
// (0.39 ms); the same count over the TF32 tensor-core rate, 495 TFLOP/s,
// is 0.053 ms, the limit of this design's hardware.
//
// Numerics.  The mask is a select before the exponential is used -- never a
// product with a 0/1 mask -- because above the diagonal a_cs[i] - a_cs[j] is
// large and positive (exp overflows to inf, and inf * 0 is NaN); only
// exponentials of differences are taken, never ratios of exponentials
// (which underflow to 0/0).  exp(a_cs) in y_off may underflow to 0, which
// is the right value.  Ragged edges (Q not a multiple of 64, P below 64, N
// not a multiple of 32) load zeros into the slabs and store nothing.
//
// Plain C interface (loaded with ctypes): launches on the given stream, never
// synchronises, allocates nothing (the caller passes the fp32 workspace of
// ssd_scan_workspace_floats floats), returns the CUDA error code.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;        // four warps, 2 x 2 over a 64 x 64 tile
constexpr int kT = 64;               // output tile rows and columns
constexpr int kK = 32;               // depth of a shared-memory slab
constexpr int kLdK = kK + 4;         // [64][kK] slabs: stride = 4 mod 32 banks
constexpr int kLdT = kT + 8;         // [kK][64] slabs: stride = 8 mod 32 banks
constexpr int kSlab = kT * kLdK > kK * kLdT ? kT * kLdK : kK * kLdT;
constexpr int kCarryThreads = 256;

// acc (the warp's 32 x 32 part of a 64 x 64 tile) += A (64 x kK) B (kK x 64),
// A(m, k) = As[m * AM + k * AK], B(k, n) = Bs[k * BK + n * BN].  kAX / kBX:
// the operand's values are exact in TF32.
template <int AM, int AK, int BK, int BN, bool kAX, bool kBX>
__device__ __forceinline__ void slab_mma(float (&acc)[2][4][4], const float* As,
                                         const float* Bs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp >> 1) * 32, n0 = (warp & 1) * 32;
#pragma unroll
  for (int k0 = 0; k0 < kK; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = m0 + mi * 16 + g;
      // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      split<kAX>(As[r * AM + (k0 + t) * AK], ah[mi][0], al[mi][0]);
      split<kAX>(As[(r + 8) * AM + (k0 + t) * AK], ah[mi][1], al[mi][1]);
      split<kAX>(As[r * AM + (k0 + t + 4) * AK], ah[mi][2], al[mi][2]);
      split<kAX>(As[(r + 8) * AM + (k0 + t + 4) * AK], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + ni * 8 + g;
      // b0 (k = t, n = g), b1 (k = t + 4, n = g)
      split<kBX>(Bs[(k0 + t) * BK + c * BN], bh[ni][0], bl[ni][0]);
      split<kBX>(Bs[(k0 + t + 4) * BK + c * BN], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if constexpr (!kAX) mma_tf32(acc[mi][ni], al[mi], bh[ni]);
        if constexpr (!kBX) mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
        mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
      }
  }
}

// Calls f(m, n, v) for each of the thread's accumulator elements: tile
// row m and column n (c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8,
// 2t + 1) of each 16 x 8 MMA tile).
template <typename F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[2][4][4], F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp >> 1) * 32, n0 = (warp & 1) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(m0 + mi * 16 + g + (e >> 1) * 8, n0 + ni * 8 + 2 * t + (e & 1), acc[mi][ni][e]);
}

struct Shape {
  int64_t b, l, h, p, n, q, nc;
};

// Workspace layout (fp32): a_cs (B, H, L), then C B^T (B, NC, Q, Q), then the
// chunk states (B, NC, H, P, N).
struct Work {
  float* acs;
  float* cb;
  float* st;
};

inline Work carve(float* ws, const Shape& s) {
  Work w;
  w.acs = ws;
  w.cb = w.acs + s.b * s.h * s.l;
  w.st = w.cb + s.b * s.nc * s.q * s.q;
  return w;
}

// Every slab is 64 x kK (or kK x 64) elements: kPer a thread.  Loads of the
// next slab are issued into registers before the current slab's MMAs, so
// their latency overlaps the tensor-core work (register double buffering).
constexpr int kPer = kT * kK / kThreads;
static_assert(kThreads % kK == 0 && kThreads % kT == 0, "slab mappings");

// [64 rows][kK] slab: element k of this thread is row rk(k), column ck.
__device__ __forceinline__ int rk(int k) { return threadIdx.x / kK + k * (kThreads / kK); }
__device__ __forceinline__ int ck() { return threadIdx.x % kK; }
// [kK rows][64] slab: element k of this thread is row rt(k), column ct.
__device__ __forceinline__ int rt(int k) { return threadIdx.x / kT + k * (kThreads / kT); }
__device__ __forceinline__ int ct() { return threadIdx.x % kT; }

// ------------------------------------------------------------- phase 1 --
// Blocks (x = tile pair or cumsum, chunk, batch), flattened into x: the
// first n_pairs blocks of a (b, chunk) compute one 64 x 64 tile of C B^T at
// or below the diagonal, the last one a_cs of every head.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_prep(const float* __restrict__ dta,
                                                     const T* __restrict__ bm,
                                                     const T* __restrict__ cm, Work w, Shape s,
                                                     int n_pairs) {
  constexpr bool kX = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) float As[kSlab];
  __shared__ __align__(16) float Bs[kSlab];
  const int64_t blk = blockIdx.x;
  const int pair = static_cast<int>(blk % (n_pairs + 1));
  const int64_t bc = blk / (n_pairs + 1);  // b * nc + c
  const int64_t b = bc / s.nc, c = bc % s.nc;
  const int64_t row0 = b * s.l + c * s.q;  // the chunk's first step
  const int q = static_cast<int>(s.q);
  if (pair == n_pairs) {
    // a_cs: one thread per head, in step order
    for (int64_t hh = threadIdx.x; hh < s.h; hh += kThreads) {
      const float* src = dta + row0 * s.h + hh;
      float* dst = w.acs + (b * s.h + hh) * s.l + c * s.q;
      float run = 0.f;
#pragma unroll 8
      for (int k = 0; k < q; ++k) {
        run += src[static_cast<int64_t>(k) * s.h];
        dst[k] = run;
      }
    }
    return;
  }
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = pair - it * (it + 1) / 2;
  const int i0 = it * kT, j0 = jt * kT;
  const int n = static_cast<int>(s.n);
  T cv[kPer], bv[kPer];
  auto fetch = [&](int n0) {
    const int nn = n0 + ck();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = rk(k);
      cv[k] = (nn < n && i0 + r < q) ? cm[(row0 + i0 + r) * s.n + nn] : T(0.f);
      bv[k] = (nn < n && j0 + r < q) ? bm[(row0 + j0 + r) * s.n + nn] : T(0.f);
    }
  };
  float acc[2][4][4] = {};
  fetch(0);
  for (int n0 = 0; n0 < n; n0 += kK) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      As[rk(k) * kLdK + ck()] = to_f32(cv[k]);  // C rows i, depth n
      Bs[rk(k) * kLdK + ck()] = to_f32(bv[k]);  // B rows j (the product's columns), depth n
    }
    __syncthreads();
    if (n0 + kK < n) fetch(n0 + kK);
    slab_mma<kLdK, 1, 1, kLdK, kX, kX>(acc, As, Bs);
  }
  float* cb = w.cb + bc * s.q * s.q;
  for_each_acc(acc, [&](int m, int col, float v) {
    if (i0 + m < q && j0 + col < q) cb[static_cast<int64_t>(i0 + m) * q + j0 + col] = v;
  });
}

// ------------------------------------------------------------- phase 2 --
// Blocks (x = b * H * NC + h * NC + chunk, y = tile of P x N): the chunk's
// own state, s_c[p, n] = sum_j xdt[j, p] B[j, n] exp(a_tot - a_cs[j]).
// Dynamic shared memory: the chunk's Q decays exp(a_tot - a_cs[j]).
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_states(const T* __restrict__ xdt,
                                                       const T* __restrict__ bm, Work w,
                                                       Shape s) {
  constexpr bool kX = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) float As[kSlab];
  __shared__ __align__(16) float Bs[kSlab];
  extern __shared__ float decay[];
  const int64_t blk = blockIdx.x;
  const int64_t bh = blk / s.nc, c = blk % s.nc;
  const int64_t b = bh / s.h, hh = bh % s.h;
  const int n_tiles = static_cast<int>(cdiv(s.n, kT));
  const int p0 = static_cast<int>(blockIdx.y / n_tiles) * kT;
  const int n0 = static_cast<int>(blockIdx.y % n_tiles) * kT;
  const int q = static_cast<int>(s.q), p = static_cast<int>(s.p), n = static_cast<int>(s.n);
  const int64_t row0 = b * s.l + c * s.q;
  const float* acs = w.acs + bh * s.l + c * s.q;
  const float a_tot = acs[q - 1];
  for (int j = threadIdx.x; j < q; j += kThreads) decay[j] = expf(a_tot - acs[j]);
  T xv[kPer], bv[kPer];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = j0 + rt(k);
      xv[k] = (j < q && p0 + ct() < p) ? xdt[((row0 + j) * s.h + hh) * s.p + p0 + ct()] : T(0.f);
      bv[k] = (j < q && n0 + ct() < n) ? bm[(row0 + j) * s.n + n0 + ct()] : T(0.f);
    }
  };
  float acc[2][4][4] = {};
  fetch(0);
  for (int j0 = 0; j0 < q; j0 += kK) {
    __syncthreads();  // the decays are written; the last MMAs are done with the slabs
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = j0 + rt(k);
      As[rt(k) * kLdT + ct()] = to_f32(xv[k]);                         // xdt^T: rows p, depth j
      Bs[rt(k) * kLdT + ct()] = j < q ? to_f32(bv[k]) * decay[j] : 0.f;  // decayed B: depth j, columns n
    }
    __syncthreads();
    if (j0 + kK < q) fetch(j0 + kK);
    slab_mma<1, kLdT, kLdT, 1, kX, false>(acc, As, Bs);
  }
  float* st = w.st + ((b * s.nc + c) * s.h + hh) * s.p * s.n;
  for_each_acc(acc, [&](int m, int col, float v) {
    if (p0 + m < p && n0 + col < n) st[static_cast<int64_t>(p0 + m) * n + n0 + col] = v;
  });
}

// ------------------------------------------------------------- phase 3 --
// One thread per (b, h, p, n): the sequential pass over the chunk states,
// kCarryRun chunks at a time so that their loads are in flight together.
constexpr int kCarryRun = 8;

template <typename T>
__global__ void __launch_bounds__(kCarryThreads) ssd_carry(T* __restrict__ h_final, Work w,
                                                           Shape s) {
  const int64_t pn = s.p * s.n;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (e >= s.b * s.h * pn) return;
  const int64_t bh = e / pn, k = e % pn;
  const int64_t b = bh / s.h, hh = bh % s.h;
  const float* __restrict__ acs = w.acs + bh * s.l + s.q - 1;  // a_tot of chunk c at c * q
  float* __restrict__ st = w.st + (b * s.nc * s.h + hh) * pn + k;
  const int64_t stride = s.h * pn;                               // one chunk further
  float hcur = 0.f;
  for (int64_t c0 = 0; c0 < s.nc; c0 += kCarryRun) {
    float sc[kCarryRun], g[kCarryRun];
#pragma unroll
    for (int u = 0; u < kCarryRun; ++u) {
      if (c0 + u < s.nc) {
        sc[u] = st[(c0 + u) * stride];
        g[u] = acs[(c0 + u) * s.q];
      }
    }
#pragma unroll
    for (int u = 0; u < kCarryRun; ++u) {
      if (c0 + u < s.nc) {
        st[(c0 + u) * stride] = hcur;  // the state entering chunk c0 + u
        hcur = hcur * expf(g[u]) + sc[u];
      }
    }
  }
  h_final[e] = from_f32<T>(hcur);
}

// ------------------------------------------------------------- phase 4 --
// Blocks (x = b * H * NC + h * NC + chunk, y = row tile * P tiles + P tile):
// y[i, p] = sum_{j <= i} (C B^T)[i, j] exp(a_cs[i] - a_cs[j]) xdt[j, p]
//         + exp(a_cs[i]) sum_n C[i, n] h_prev[p, n].
// Dynamic shared memory: the chunk's a_cs up to the tile's last row.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3) ssd_outputs(const T* __restrict__ xdt,
                                                        const T* __restrict__ cm,
                                                        T* __restrict__ y, Work w, Shape s) {
  constexpr bool kX = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) float As[kSlab];
  __shared__ __align__(16) float Bs[kSlab];
  extern __shared__ float acs_s[];
  const int64_t blk = blockIdx.x;
  const int64_t bh = blk / s.nc, c = blk % s.nc;
  const int64_t b = bh / s.h, hh = bh % s.h;
  const int p_tiles = static_cast<int>(cdiv(s.p, kT));
  const int it = static_cast<int>(blockIdx.y / p_tiles);
  const int i0 = it * kT, p0 = static_cast<int>(blockIdx.y % p_tiles) * kT;
  const int q = static_cast<int>(s.q), p = static_cast<int>(s.p), n = static_cast<int>(s.n);
  const int64_t row0 = b * s.l + c * s.q;
  const float* __restrict__ cb = w.cb + (b * s.nc + c) * s.q * s.q;
  const int j_end = min(i0 + kT, q);  // rows and columns the tile needs
  for (int j = threadIdx.x; j < j_end; j += kThreads) acs_s[j] = w.acs[bh * s.l + c * s.q + j];

  // y_off = (C h_prev^T) * exp(a_cs) first (h_prev is zero before the first
  // chunk), scaled in registers; y_diag then accumulates on top of it
  float acc[2][4][4] = {};
  const int g = (threadIdx.x & 31) >> 2, m0 = (threadIdx.x >> 6) * 32;  // slab_mma's rows
  if (c > 0) {
    const float* __restrict__ hp = w.st + ((b * s.nc + c) * s.h + hh) * s.p * s.n;
    T cv[kPer];
    float hv[kPer];
    auto fetch_off = [&](int n0) {
      const int nn = n0 + ck();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int r = rk(k);
        cv[k] = (nn < n && i0 + r < q) ? cm[(row0 + i0 + r) * s.n + nn] : T(0.f);
        hv[k] = (nn < n && p0 + r < p) ? hp[static_cast<int64_t>(p0 + r) * n + nn] : 0.f;
      }
    };
    fetch_off(0);
    for (int n0 = 0; n0 < n; n0 += kK) {
      __syncthreads();  // the last MMAs are done with the slabs
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        As[rk(k) * kLdK + ck()] = to_f32(cv[k]);  // C: rows i, depth n
        Bs[rk(k) * kLdK + ck()] = hv[k];          // h_prev: columns p, depth n
      }
      __syncthreads();
      if (n0 + kK < n) fetch_off(n0 + kK);
      slab_mma<kLdK, 1, 1, kLdK, kX, false>(acc, As, Bs);
    }
    __syncthreads();  // a_cs is written
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int i = i0 + m0 + mi * 16 + g + hi * 8;
        const float e = i < q ? expf(acs_s[i]) : 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          acc[mi][ni][2 * hi] *= e;
          acc[mi][ni][2 * hi + 1] *= e;
        }
      }
  }

  // y_diag over the j-slabs at or below the tile's last row.  The thread's
  // slab elements k sit at fixed strides from one base each: score rows
  // i0 + rk(0) + 4k of C B^T, xdt steps rt(0) + 2k.
  float sv[kPer];
  T xv[kPer];
  const float* __restrict__ cb_t = cb + static_cast<int64_t>(i0 + rk(0)) * q + ck();
  const int64_t x_step = s.h * s.p;
  const T* __restrict__ x_t = xdt + ((row0 + rt(0)) * s.h + hh) * s.p + p0 + ct();
  const bool x_col = p0 + ct() < p;
  auto fetch = [&](int j0) {
    const int j = j0 + ck();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = i0 + rk(k);
      sv[k] = (i < q && j <= i) ? cb_t[static_cast<int64_t>(k * (kThreads / kK)) * q + j0]
                                : 0.f;
      const int jx = j0 + rt(k);
      xv[k] = (jx < q && x_col) ? x_t[(j0 + k * (kThreads / kT)) * x_step] : T(0.f);
    }
  };
  fetch(0);
  for (int j0 = 0; j0 < j_end; j0 += kK) {
    __syncthreads();  // a_cs is written; the last MMAs are done with the slabs
    const int j = j0 + ck();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = i0 + rk(k);
      // mask first, then decay: no exponential of the upper triangle is used
      As[rk(k) * kLdK + ck()] = (i < q && j <= i) ? sv[k] * expf(acs_s[i] - acs_s[j]) : 0.f;
      Bs[rt(k) * kLdT + ct()] = to_f32(xv[k]);  // xdt: depth j, columns p
    }
    __syncthreads();
    if (j0 + kK < j_end) fetch(j0 + kK);
    slab_mma<kLdK, 1, kLdT, 1, false, kX>(acc, As, Bs);  // scores: rows i, depth j
  }

  for_each_acc(acc, [&](int m, int col, float v) {
    const int i = i0 + m, pp = p0 + col;
    if (i < q && pp < p) y[((row0 + i) * s.h + hh) * s.p + pp] = from_f32<T>(v);
  });
}

constexpr size_t kMaxSmem = 232448;  // what one block may ask for on sm_90

// Dynamic shared memory of phases 2 and 4 (Q floats), raising the limit
// past the default 48 KB when a long chunk needs it.
template <typename K>
cudaError_t smem_for(K kernel, size_t dyn) {
  const size_t total = dyn + 2 * kSlab * sizeof(float);
  if (total > kMaxSmem) return cudaErrorInvalidValue;
  if (total <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(dyn));
}

template <typename T>
cudaError_t launch(const void* xdt, const float* dta, const void* bm, const void* cm, void* y,
                   void* h_final, float* ws, const Shape& s, cudaStream_t stream) {
  const Work w = carve(ws, s);
  const T* x = static_cast<const T*>(xdt);
  const T* bmat = static_cast<const T*>(bm);
  const T* cmat = static_cast<const T*>(cm);
  const int i_tiles = static_cast<int>(cdiv(s.q, kT));
  const int n_pairs = i_tiles * (i_tiles + 1) / 2;
  const int64_t blocks1 = s.b * s.nc * (n_pairs + 1);
  const int64_t blocks24 = s.b * s.h * s.nc;
  const int64_t tiles2 = cdiv(s.p, kT) * cdiv(s.n, kT);
  const int64_t tiles4 = i_tiles * cdiv(s.p, kT);
  const int64_t blocks3 = cdiv(s.b * s.h * s.p * s.n, kCarryThreads);
  if (blocks1 > 0x7fffffffLL || blocks24 > 0x7fffffffLL || blocks3 > 0x7fffffffLL ||
      tiles2 > 65535 || tiles4 > 65535)
    return cudaErrorInvalidValue;
  const size_t dyn = static_cast<size_t>(s.q) * sizeof(float);
  cudaError_t err = smem_for(ssd_states<T>, dyn);
  if (err == cudaSuccess) err = smem_for(ssd_outputs<T>, dyn);
  if (err != cudaSuccess) return err;
  ssd_prep<T><<<static_cast<unsigned>(blocks1), kThreads, 0, stream>>>(dta, bmat, cmat, w, s,
                                                                        n_pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_states<T><<<dim3(static_cast<unsigned>(blocks24), static_cast<unsigned>(tiles2)),
                  kThreads, dyn, stream>>>(x, bmat, w, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_carry<T><<<static_cast<unsigned>(blocks3), kCarryThreads, 0, stream>>>(
      static_cast<T*>(h_final), w, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_outputs<T><<<dim3(static_cast<unsigned>(blocks24), static_cast<unsigned>(tiles4)),
                   kThreads, dyn, stream>>>(x, cmat, static_cast<T*>(y), w, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 elements of the workspace one call needs: a_cs (b, h, l), C B^T
// (b, l / q, q, q) and the chunk states (b, l / q, h, p, n).
int64_t ssd_scan_workspace_floats(int64_t b, int64_t l, int64_t h, int64_t p, int64_t n,
                                  int64_t q) {
  if (b < 0 || l < 1 || h < 1 || p < 1 || n < 1 || q < 1 || l % q != 0) return -1;
  const int64_t nc = l / q;
  return b * h * l + b * nc * q * q + b * nc * h * p * n;
}

// ssd_scan: xdt (b, l, h, p), bm/cm (b, l, n), y (b, l, h, p), h_final
// (b, h, p, n), all of `dtype` (0 fp32, 1 bf16) and contiguous; dta (b, l, h)
// fp32 contiguous; q >= 1 divides l; ws holds ssd_scan_workspace_floats
// floats.  Returns cudaErrorInvalidValue for a shape beyond the kernel's
// limits (more than 65535 tiles of a chunk or of P x N, or 2^31 blocks).
int ssd_scan_chunked(const void* xdt, const float* dta, const void* bm, const void* cm, void* y,
                     void* h_final, void* ws, int dtype, int64_t b, int64_t l, int64_t h,
                     int64_t p, int64_t n, int64_t q, void* stream) {
  if (b == 0) return cudaSuccess;
  if (b < 0 || l < 1 || h < 1 || p < 1 || n < 1 || q < 1 || l % q != 0) return cudaErrorInvalidValue;
  if (q > 0x7fffffff || p > 0x7fffffff || n > 0x7fffffff) return cudaErrorInvalidValue;
  const Shape s{b, l, h, p, n, q, l / q};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  switch (dtype) {
    case kF32: return launch<float>(xdt, dta, bm, cm, y, h_final, w, s, st);
    case kBF16: return launch<__nv_bfloat16>(xdt, dta, bm, cm, y, h_final, w, s, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
