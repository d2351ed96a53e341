// Fused LoRA matmuls for Hopper (sm_90a): the FLaaS serving read path.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/lora_matmul/kernel.py:
//
//   * batched_lora_matmul_pallas (_batched_kernel): many adapters of
//     heterogeneous rank packed as rank-row segments of two row-major buffers,
//     a_rows (R, K) and b_rows (R, N) (B transposed, so row p of both is one
//     rank-one component); request row i names its tenant t by data:
//
//       y_i = x_i @ W + scale_t * sum_{p in [off_t, off_t + rank_t)} (x_i . a_rows[p]) b_rows[p]
//
//     with t = ids_i, a negative id counted from the end of the tables (as
//     JAX's gather indexes) and then clamped to [0, T - 1];
//
//   * lora_matmul_pallas (_kernel): one adapter, y = x @ W + s * (x @ A^T) @ B^T
//     with A (r, K) and B (N, r): every row's segment is [0, r), one scale.
//
// Both entry points run the same two launches on the given stream:
//
//   1. down: one block per request row i resolves its tenant (id, then the
//      tenant's offset, rank and scale from the tables: a block loads its own
//      indices) and computes u[i][q] = scale * (x_i . a[lo + q]) over its
//      segment, one warp per segment row, lanes striding K in 16-byte
//      vectors.  It reads only the rows inside the segment: rows outside
//      every live segment may hold garbage (NaN, Inf) and never reach the
//      output, and a tenant at rank 0 (the null adapter, an evicted slot)
//      reads none.  Segments are clipped to [0, R), as the TPU kernel's
//      iota mask counts only rows that exist.
//   2. gemm: x @ W on the tensor cores (mma.sync), then an epilogue that adds
//      sum_q u[i][q] * b[lo + q][n] over the row's own segment rows of b in
//      fp32 and rounds once.
//
// The GEMM body.  Tiles of x (BM x 32) and W (32 x BN) go through a ring of
// shared-memory stages filled by cp.async (16 bytes a thread where the row
// length and the pointers allow it, else plain loads with zeros past the
// edge); stage kt + S - 1 is in flight while stage kt's MMAs run, one
// barrier a stage.  Fragments come from shared memory by ldmatrix (x, and W
// in bf16 through its .trans form) or by 32-bit loads (W in fp32), on
// padded rows that keep both free of bank conflicts.
//   * bf16: m16n8k16, bf16 operands, fp32 accumulators; 4 stages.
//   * fp32: TF32 m16n8k8 with each operand split x = hi + lo (common.cuh's
//     split: hi rounded to nearest in two integer operations, lo exact), the
//     product taken as lo*hi + hi*lo + hi*hi ("3xTF32", about fp32's
//     accuracy); 3 stages.  The tensor cores add into their accumulators by
//     truncation, which over K = 4096 drifts past fp32's tolerance (3e-5 of
//     max|y| measured at rank 0), so each stage's products go to fresh
//     registers that are then added to the running sum, rounded.
// Two tile shapes, chosen by M * N: 128 x 128 with 8 warps (64 x 32 each)
// when that gives at least one tile per SM, else 32 x 64 with 4 warps (16 x
// 32 each) so that a small product such as serving's 512 x 512 (128 tiles)
// fills the card.  Tiles walk in groups of 8 row panels, so the blocks in
// flight share their panels of x and W in L2.
//
// The epilogue stages the accumulator tile in shared memory (over the ring)
// and gives each row 16 or 32 lanes of four columns: the row's segment
// bounds were resolved into shared memory while the first stages landed,
// its segment's rows of b stream in with coalesced vector loads (u
// broadcast), and y is written as vectors.
//
// What bounds it.  At M = K = N = 4096 the base product (137 GFLOP) bounds
// it: 0.14 ms at the bf16 tensor-core rate, 0.28 ms at TF32's, 2.05 ms at
// the fp32 SIMT rate.  In fp32 the body issues three TF32 products a
// product, and every warp splits each fragment it loads (the integer and
// add work of the splits competes with the MMAs for issue); in bf16,
// mma.sync on 64 x 32 warp tiles with a barrier every 32 of depth stays
// well below the rate that wgmma with a TMA ring reaches -- the next lever.
// The low-rank terms (the down pass and the epilogue, 2 * cnt * (K + N)
// per row) are SIMT work whose gathered rows of a and b come from L2 once
// per request row (and per column tile for b): with ranks up to 64 they
// are a visible share of a call at 4096^3.  At the serving shape (M = K =
// N = 512, ranks 1-8) the device work is tens of microseconds and the call
// is set by the host: the wrapper passes the tenant ids and tables as they
// are, so one ctypes call and these two launches are the whole of it.  No
// cuBLAS and no library kernel: both products are computed here.
//
// Plain C interface (loaded with ctypes): launches on the given stream, never
// synchronises, allocates nothing (the wrapper allocates y and the scratch u),
// returns the CUDA error code (0 on success).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kDownThreads = 128;  // 4 warps, one segment row each at a time
constexpr int kDownWarps = kDownThreads / 32;
constexpr int kGroup = 8;          // row panels per group of tiles
constexpr int kMaxDevices = 64;

struct Params {
  const void* x;            // (m, k)
  const void* w;            // (k, n)
  const void* a;            // (r, k): a_rows, or A
  const void* b;            // element (p, c) at b[p * b_sp + c * b_sn]
  const int32_t* ids;       // (m,) tenant ids, or null: every segment is [0, r)
  const int32_t* seg_off;   // (t,) tenant row offsets (null without ids)
  const int32_t* seg_rank;  // (t,) tenant ranks
  const float* scale;       // (t,) tenant scales, or one value (ids null)
  int64_t t;
  float* u;                 // (m, u_stride) fp32 scratch
  int64_t u_stride;
  void* y;                  // (m, n)
  int64_t m, k, n, r;
  int64_t b_sp, b_sn;
  bool vec_x, vec_w, vec_a, vec_b, vec_y;  // 16-byte (x, w, a) or row-vector (b, y) access
};

// Row i's tenant (or -1 with no ids) and its segment [lo, hi) of the packed
// rows, clipped to [0, r).
struct Seg {
  int64_t tenant, lo, hi;
};

__device__ __forceinline__ Seg segment(const Params& p, int64_t i) {
  if (p.ids == nullptr) return {-1, 0, p.r};
  int64_t t = p.ids[i];
  if (t < 0) t += p.t;
  t = t < 0 ? 0 : (t >= p.t ? p.t - 1 : t);
  const int64_t o = p.seg_off[t];
  Seg s{t, o < 0 ? 0 : o, o + static_cast<int64_t>(p.seg_rank[t])};
  if (s.hi > p.r) s.hi = p.r;
  if (s.hi < s.lo) s.hi = s.lo;
  return s;
}

// ------------------------------------------------------------------- down --
template <typename T>
__global__ void __launch_bounds__(kDownThreads) down_kernel(Params p) {
  constexpr int V = 16 / sizeof(T);
  const int64_t i = blockIdx.x;
  const Seg sg = segment(p, i);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* __restrict__ x = static_cast<const T*>(p.x) + i * p.k;
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const float s = p.scale[sg.tenant < 0 ? 0 : sg.tenant];
  for (int64_t q = sg.lo + warp; q < sg.hi; q += kDownWarps) {
    const T* __restrict__ ar = a + q * p.k;
    float acc = 0.f;
    if (p.vec_a) {
      for (int64_t c = lane * V; c < p.k; c += 32 * V) {
        float xv[V], av[V];
        load_vec<T, V>(x + c, xv);
        load_vec<T, V>(ar + c, av);
#pragma unroll
        for (int e = 0; e < V; ++e) acc = fmaf(xv[e], av[e], acc);
      }
    } else {
      for (int64_t c = lane; c < p.k; c += 32) acc = fmaf(to_f32(x[c]), to_f32(ar[c]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) p.u[i * p.u_stride + (q - sg.lo)] = s * acc;
  }
}

// -------------------------------------------------------------- gemm body --
template <int BM_, int BN_, int WM_, int WN_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WM = WM_, WN = WN_;          // warps over rows, columns
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int TM = BM / WM, TN = BN / WN;  // a warp's tile
  static constexpr int MI = TM / 16, NI = TN / 8;   // its MMA tiles
  static_assert(MI >= 1 && NI % 2 == 0 && BN % 32 == 0, "tile shape");
};
using Large = Shape<128, 128, 2, 4>;
using Small = Shape<32, 64, 2, 2>;

// Shared-memory layout of one stage for operand type T: x as [BM][LDX], W as
// [BK][LDW].  LDX is 144 bytes (fp32) or 80 (bf16) a row, LDW eight elements
// more than a row of W: ldmatrix's eight 16-byte rows, and the fp32 B loads of
// depths t and t + 4, then fall in distinct banks.
template <typename T, class C>
struct Layout {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes
  static constexpr int BK = 32;                    // depth of a stage
  static constexpr int LDX = BK + V;
  static constexpr int LDW = C::BN + 8;
  static constexpr int STAGES = sizeof(T) == 4 ? 3 : 4;
  static constexpr int XS = C::BM * LDX;            // elements of x a stage
  static constexpr int STAGE = XS + BK * LDW;       // elements a stage
  static constexpr int LDC = C::BN + 8;             // fp32 accumulator tile
  static constexpr size_t RING = size_t(STAGES) * STAGE * sizeof(T);
  static constexpr size_t CTILE = size_t(C::BM) * LDC * sizeof(float);
  static constexpr size_t SMEM = RING > CTILE ? RING : CTILE;
  static_assert((XS * sizeof(T)) % 16 == 0 && (STAGE * sizeof(T)) % 16 == 0, "16-byte stages");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` are read (0 or 16
// here) and the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// Stage of depth k0: x rows [m0, m0 + BM) and W columns [n0, n0 + BN), zeros
// past every edge.
template <typename T, class C>
__device__ __forceinline__ void load_stage(T* xs, T* ws, const Params& p, int64_t m0,
                                           int64_t n0, int64_t k0) {
  using L = Layout<T, C>;
  constexpr int V = L::V;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  if (p.vec_x) {
    constexpr int kRow = L::BK / V;  // 16-byte chunks a row
    static_assert((C::BM * kRow) % C::kThreads == 0, "x chunks");
#pragma unroll
    for (int l = 0; l < C::BM * kRow / C::kThreads; ++l) {
      const int c = tid + l * C::kThreads;
      const int row = c / kRow, col = (c % kRow) * V;
      const int64_t gm = m0 + row, gk = k0 + col;
      const bool ok = gm < p.m && gk < p.k;
      cp_async16(xs + row * L::LDX + col, ok ? x + gm * p.k + gk : x, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < C::BM * L::BK; e += C::kThreads) {
      const int row = e / L::BK, col = e % L::BK;
      const int64_t gm = m0 + row, gk = k0 + col;
      xs[row * L::LDX + col] = (gm < p.m && gk < p.k) ? x[gm * p.k + gk] : T(0.f);
    }
  }
  if (p.vec_w) {
    constexpr int kRow = C::BN / V;
    static_assert((L::BK * kRow) % C::kThreads == 0, "w chunks");
#pragma unroll
    for (int l = 0; l < L::BK * kRow / C::kThreads; ++l) {
      const int c = tid + l * C::kThreads;
      const int row = c / kRow, col = (c % kRow) * V;
      const int64_t gk = k0 + row, gn = n0 + col;
      const bool ok = gk < p.k && gn < p.n;
      cp_async16(ws + row * L::LDW + col, ok ? w + gk * p.n + gn : w, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < L::BK * C::BN; e += C::kThreads) {
      const int row = e / C::BN, col = e % C::BN;
      const int64_t gk = k0 + row, gn = n0 + col;
      ws[row * L::LDW + col] = (gk < p.k && gn < p.n) ? w[gk * p.n + gn] : T(0.f);
    }
  }
}

// acc (the warp's TM x TN) += xs (BM x BK) ws (BK x BN) for one stage.
template <typename T, class C>
__device__ __forceinline__ void mma_stage(float (&acc)[C::MI][C::NI][4], const T* xs,
                                          const T* ws) {
  using L = Layout<T, C>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / C::WN) * C::TM, wn = (warp % C::WN) * C::TN;
  // ldmatrix: lanes 0-15 address rows 0-15 of a 16-row block, lanes 16-31
  // the same rows 16 bytes further along
  const int lr = lane & 15, lc = lane >> 4;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < L::BK; ks += 8) {
      uint32_t ah[C::MI][4], al[C::MI][4], bh[C::NI][2], bl[C::NI][2];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi) {
        // four 8 x 4 fp32 matrices: rows g / g + 8, depths t / t + 4
        uint32_t raw[4];
        ldmatrix_x4(raw, xs + (wm + mi * 16 + lr) * L::LDX + ks + lc * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) split<false>(__uint_as_float(raw[e]), ah[mi][e], al[mi][e]);
      }
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        const float* bp = ws + (ks + t) * L::LDW + wn + ni * 8 + g;
        split<false>(bp[0], bh[ni][0], bl[ni][0]);
        split<false>(bp[4 * L::LDW], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) {
          mma_tf32(acc[mi][ni], al[mi], bh[ni]);
          mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
          mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
        }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < L::BK; ks += 16) {
      uint32_t af[C::MI][4], bf[C::NI][2];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
        ldmatrix_x4(af[mi], xs + (wm + mi * 16 + lr) * L::LDX + ks + lc * 8);
#pragma unroll
      for (int nj = 0; nj < C::NI / 2; ++nj) {
        // depths 0-15 by columns 0-7 and 8-15: b0, b1 of two n tiles
        uint32_t r[4];
        ldmatrix_x4_trans(r, ws + (ks + lr) * L::LDW + wn + nj * 16 + lc * 8);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
  }
}

template <typename T, class C>
__global__ void __launch_bounds__(C::kThreads) gemm_kernel(Params p) {
  using L = Layout<T, C>;
  constexpr int S = L::STAGES;
  constexpr bool kTf32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int64_t seg_lo[C::BM], seg_hi[C::BM];
  T* ring = reinterpret_cast<T*>(smem_raw);

  // grouped tile order: kGroup row panels walk the column panels together
  const int64_t grid_m = cdiv(p.m, C::BM), grid_n = cdiv(p.n, C::BN);
  const int64_t pid = blockIdx.x;
  const int64_t per_group = kGroup * grid_n;
  const int64_t first_m = (pid / per_group) * kGroup;
  const int64_t rows = grid_m - first_m < kGroup ? grid_m - first_m : kGroup;
  const int64_t m0 = (first_m + (pid % per_group) % rows) * C::BM;
  const int64_t n0 = ((pid % per_group) / rows) * C::BN;

  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int64_t n_k = cdiv(p.k, L::BK);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_k) load_stage<T, C>(ring + s * L::STAGE, ring + s * L::STAGE + L::XS, p, m0, n0,
                                  static_cast<int64_t>(s) * L::BK);
    cp_async_commit();
  }
  // the tile's rows resolve their tenants while the first stages land
  for (int r = threadIdx.x; r < C::BM; r += C::kThreads) {
    const Seg sg = m0 + r < p.m ? segment(p, m0 + r) : Seg{-1, 0, 0};
    seg_lo[r] = sg.lo;
    seg_hi[r] = sg.hi;
  }
  for (int64_t kt = 0; kt < n_k; ++kt) {
    cp_async_wait<S - 2>();  // this thread's copies of stage kt have landed
    __syncthreads();         // everyone's have; everyone is done with stage kt - 1
    const int64_t next = kt + S - 1;
    if (next < n_k) {
      T* st = ring + (next % S) * L::STAGE;
      load_stage<T, C>(st, st + L::XS, p, m0, n0, next * L::BK);
    }
    cp_async_commit();
    const T* st = ring + (kt % S) * L::STAGE;
    if constexpr (kTf32) {
      // the tensor cores add into their fp32 accumulators by truncation,
      // which over K = 4096 drifts past fp32's tolerance: each stage's 12
      // products a tile go to fresh registers, added to acc rounded
      float part[C::MI][C::NI][4];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
      mma_stage<T, C>(part, st, st + L::XS);
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
    } else {
      mma_stage<T, C>(acc, st, st + L::XS);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the accumulator tile

  float* cs = reinterpret_cast<float*>(smem_raw);
  {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp / C::WN) * C::TM, wn = (warp % C::WN) * C::TN;
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        float* c = cs + (wm + mi * 16 + g) * L::LDC + wn + ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(c) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<float2*>(c + 8 * L::LDC) = make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
  }
  __syncthreads();

  // epilogue: LPR lanes a row, RPW rows a warp at a time; each row's
  // low-rank term over its segment rows of b, then one rounding
  constexpr int VPL = 4;               // columns a lane
  constexpr int LPR = C::BN / VPL;     // lanes a row
  constexpr int RPW = 32 / LPR;        // rows a warp
  static_assert(LPR * RPW == 32, "lanes of a row");
  const T* __restrict__ b = static_cast<const T*>(p.b);
  T* __restrict__ y = static_cast<T*>(p.y);
  const int lane = threadIdx.x & 31;
  const int cl = lane % LPR;
  const int64_t c0 = n0 + cl * VPL;
  const bool full = c0 + VPL <= p.n;
  for (int r = (threadIdx.x >> 5) * RPW + lane / LPR; r < C::BM; r += C::kThreads / LPR) {
    const int64_t i = m0 + r;
    if (i >= p.m) break;
    float v[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) v[j] = cs[r * L::LDC + cl * VPL + j];
    const int64_t lo = seg_lo[r], hi = seg_hi[r];
    const float* __restrict__ u = p.u + i * p.u_stride;
    if (p.vec_b && full) {
#pragma unroll 4
      for (int64_t q = lo; q < hi; ++q) {
        float bv[VPL];
        load_vec<T, VPL>(b + q * p.b_sp + c0, bv);
        const float uq = u[q - lo];
#pragma unroll
        for (int j = 0; j < VPL; ++j) v[j] = fmaf(uq, bv[j], v[j]);
      }
    } else {
      for (int64_t q = lo; q < hi; ++q) {
        const float uq = u[q - lo];
#pragma unroll
        for (int j = 0; j < VPL; ++j)
          if (c0 + j < p.n) v[j] = fmaf(uq, to_f32(b[q * p.b_sp + (c0 + j) * p.b_sn]), v[j]);
      }
    }
    if (p.vec_y && full) {
      store_vec<T, VPL>(y + i * p.n + c0, v);
    } else {
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        if (c0 + j < p.n) y[i * p.n + c0 + j] = from_f32<T>(v[j]);
    }
  }
}

// The SM count of the current device, read once per device.
int sm_count() {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int* slot = dev < kMaxDevices ? &cache[dev] : nullptr;
  if (slot != nullptr && *slot > 0) return *slot;
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (slot != nullptr) *slot = n;
  return n;
}

template <typename T, class C>
cudaError_t launch_gemm(Params p, cudaStream_t stream) {
  using L = Layout<T, C>;
  constexpr int VPL = 4;  // the epilogue's columns a lane
  const int64_t tiles = cdiv(p.m, C::BM) * cdiv(p.n, C::BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.vec_b = p.b_sn == 1 && p.n % VPL == 0 && aligned(p.b, VPL * sizeof(T));
  p.vec_y = p.n % VPL == 0 && aligned(p.y, VPL * sizeof(T));
  // past 48 KB a block's shared memory needs the attribute, once per device
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (L::SMEM > 48 * 1024 && (dev >= kMaxDevices || !raised[dev])) {
    err = cudaFuncSetAttribute(gemm_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::SMEM));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  gemm_kernel<T, C><<<static_cast<unsigned>(tiles), C::kThreads, L::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int64_t V = 16 / sizeof(T);
  if (p.m > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.vec_x = p.k % V == 0 && aligned(p.x, 16);
  p.vec_a = p.vec_x && aligned(p.a, 16);
  p.vec_w = p.n % V == 0 && aligned(p.w, 16);
  down_kernel<T><<<static_cast<unsigned>(p.m), kDownThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t large_tiles = cdiv(p.m, Large::BM) * cdiv(p.n, Large::BN);
  return large_tiles >= sm_count() ? launch_gemm<T, Large>(p, stream)
                                   : launch_gemm<T, Small>(p, stream);
}

cudaError_t dispatch(const Params& p, int dtype, void* stream) {
  if (p.m <= 0 || p.n <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(p, s);
    case kBF16: return launch<__nv_bfloat16>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// batched_lora_matmul: x (m, k), w (k, n), a_rows (r_total, k), b_rows
// (r_total, n), all of `dtype` and contiguous; ids (m,) int32 tenant ids;
// seg_off, seg_rank (t,) int32 and seg_scale (t,) f32 the tenant tables,
// t >= 1; u an f32 scratch of m * r_total; y (m, n) of dtype.
int lora_matmul_batched(const void* x, const void* w, const void* a_rows, const void* b_rows,
                        const int32_t* ids, const int32_t* seg_off, const int32_t* seg_rank,
                        const float* seg_scale, int64_t t, float* u, void* y, int dtype,
                        int64_t m, int64_t k, int64_t n, int64_t r_total, void* stream) {
  if (t < 1 && m > 0) return cudaErrorInvalidValue;
  const Params p{x, w, a_rows, b_rows, ids, seg_off, seg_rank, seg_scale, t, u,
                 r_total > 0 ? r_total : 1, y, m, k, n, r_total, n, 1,
                 false, false, false, false, false};
  return dispatch(p, dtype, stream);
}

// lora_matmul: x (m, k), w (k, n), a (r, k), b (n, r), all of `dtype` and
// contiguous; scale one f32 on the device; u an f32 scratch of m * r; y (m, n).
int lora_matmul_single(const void* x, const void* w, const void* a, const void* b,
                       const float* scale, float* u, void* y, int dtype, int64_t m, int64_t k,
                       int64_t n, int64_t r, void* stream) {
  const Params p{x, w, a, b, nullptr, nullptr, nullptr, scale, 0, u, r > 0 ? r : 1, y,
                 m, k, n, r, 1, r, false, false, false, false, false};
  return dispatch(p, dtype, stream);
}

}  // extern "C"
