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
// Both entry points run two launches on the given stream and share the GEMM
// body.  The batched path:
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
// The single adapter has one segment [0, r) and one scale for every row, so
// both of its products are tiled GEMMs on the tensor cores, each reading its
// second operand in its own layout (A (r, K) and B (N, r) row-major are the
// column-major operands of x A^T and u B^T: staged [n][depth], ldmatrix
// without .trans in bf16, 32-bit loads in fp32):
//
//   1. down_gemm: u = scale * x A^T (M x r, fp32, rows padded with zeros to
//      a multiple of 32) through the body's cp.async ring, 32 x 64 tiles;
//      at a few hundred rows K is split across blocks into partial u's,
//      which the tail sums;
//   2. gemm with a tail: after the K loop, u B^T runs as r more depth of the
//      same accumulators.  B's rows n0 .. n0 + BN are one contiguous block;
//      it comes in by 16-byte cp.async 32 ranks at a time (scalar loads where
//      B's rows or pointer are not 16-byte aligned), with u's tile beside it,
//      so no element of B is read more than once a tile and none with a
//      stride.  The tail is TF32 with u split hi + lo, and B too in fp32.
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
// The batched path's low-rank terms (the down pass and the epilogue, 2 * cnt
// * (K + N) per row) are SIMT work whose gathered rows of a and b come from
// L2 once per request row (and per column tile for b): with ranks up to 64
// they are a visible share of a call at 4096^3.  The single adapter's are
// 2 * M * r * (K + N) operations on the tensor cores (4.3 GFLOP at 4096^3, r
// = 64: 3% of the base product), plus re-reading x once for the down GEMM.
// At the serving shape (M = K = N = 512, ranks 1-8) the device work is tens
// of microseconds and the call is set by the host: the wrapper passes the
// tenant ids and tables as they are, so one ctypes call and these two
// launches are the whole of it.  No cuBLAS and no library kernel: every
// product is computed here.
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
  const void* b;            // b_rows (r, n), or B (n, r)
  const int32_t* ids;       // (m,) tenant ids (the batched path; null for one adapter)
  const int32_t* seg_off;   // (t,) tenant row offsets
  const int32_t* seg_rank;  // (t,) tenant ranks
  const float* scale;       // (t,) tenant scales, or the one adapter's
  int64_t t;
  float* u;                 // (m, u_stride) fp32 scratch
  int64_t u_stride;
  void* y;                  // (m, n)
  int64_t m, k, n, r;
  bool vec_x, vec_w, vec_a, vec_b, vec_y;  // 16-byte (x, w, a) or row-vector (b, y) access
  int64_t u_parts;          // the single adapter's split of K: partial u's to sum
  int64_t k_part;           // the depth of each split (a multiple of 32)
};

// Row i's tenant and its segment [lo, hi) of the packed rows, clipped to
// [0, r) (the batched path).
struct Seg {
  int64_t tenant, lo, hi;
};

__device__ __forceinline__ Seg segment(const Params& p, int64_t i) {
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
  const float s = p.scale[sg.tenant];
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

// x rows [m0, m0 + BM) at depth k0 into xs ([BM][LDX]), zeros past every edge.
template <typename T, class C>
__device__ __forceinline__ void load_x(T* xs, const Params& p, int64_t m0, int64_t k0) {
  using L = Layout<T, C>;
  constexpr int V = L::V;
  const T* __restrict__ x = static_cast<const T*>(p.x);
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
}

// Stage of depth k0: x rows [m0, m0 + BM) and W columns [n0, n0 + BN), zeros
// past every edge.
template <typename T, class C>
__device__ __forceinline__ void load_stage(T* xs, T* ws, const Params& p, int64_t m0,
                                           int64_t n0, int64_t k0) {
  using L = Layout<T, C>;
  constexpr int V = L::V;
  const T* __restrict__ w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  load_x<T, C>(xs, p, m0, k0);
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

// acc (the warp's TM x TN) += xs (BM x 32, rows LDX apart) times the stage's
// second operand: ws k-major ([32][BN], rows LDW apart: W's own layout) or,
// with kNK, n-major ([BN][32]: column n of the operand is row n of ws, its
// depth contiguous; A (r, K) in the single adapter's down GEMM).
template <typename T, class C, int LDX, int LDW, bool kNK>
__device__ __forceinline__ void mma_stage(float (&acc)[C::MI][C::NI][4], const T* xs,
                                          const T* ws) {
  constexpr int BK = 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / C::WN) * C::TM, wn = (warp % C::WN) * C::TN;
  // ldmatrix: lanes 0-15 address rows 0-15 of a 16-row block, lanes 16-31
  // the same rows 16 bytes further along
  const int lr = lane & 15, lc = lane >> 4;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      uint32_t ah[C::MI][4], al[C::MI][4], bh[C::NI][2], bl[C::NI][2];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi) {
        // four 8 x 4 fp32 matrices: rows g / g + 8, depths t / t + 4
        uint32_t raw[4];
        ldmatrix_x4(raw, xs + (wm + mi * 16 + lr) * LDX + ks + lc * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) split<false>(__uint_as_float(raw[e]), ah[mi][e], al[mi][e]);
      }
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        // b0 (depth t, column g), b1 (depth t + 4)
        const int n = wn + ni * 8 + g;
        const float* bp = kNK ? ws + n * LDW + ks + t : ws + (ks + t) * LDW + n;
        split<false>(bp[0], bh[ni][0], bl[ni][0]);
        split<false>(bp[kNK ? 4 : 4 * LDW], bh[ni][1], bl[ni][1]);
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
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[C::MI][4], bf[C::NI][2];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
        ldmatrix_x4(af[mi], xs + (wm + mi * 16 + lr) * LDX + ks + lc * 8);
#pragma unroll
      for (int nj = 0; nj < C::NI / 2; ++nj) {
        // b0, b1 of two n tiles: k-major, depths 0-15 by columns 0-7 and
        // 8-15 through .trans; n-major, eight columns by depths 0-7 then
        // 8-15, then the next eight columns the same
        uint32_t r[4];
        if constexpr (kNK)
          ldmatrix_x4(r, ws + (wn + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDW + ks +
                             ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4_trans(r, ws + (ks + lr) * LDW + wn + nj * 16 + lc * 8);
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

// ------------------------------------------------- single adapter: operands --
// lora_matmul's two products take their second operand in its own layout:
// A (r, K) and B (N, r) row-major are the column-major K x r and r x N
// operands of x A^T and u B^T.  Each is staged n-major ([n][depth], the
// depth contiguous), which is what mma.sync's column operand wants: ldmatrix
// without .trans in bf16, 32-bit loads in fp32.

// The rank depth u B^T takes a step (u's rows are padded to a multiple of it
// with zeros, so its loads never leave the row).
constexpr int kRankChunk = 32;
// The most parts the single adapter's down GEMM splits K into.
constexpr int kMaxParts = 8;

// ------------------------------------------------ single adapter: u = s x A^T --
// One block a 32-row panel of x by 64 rank rows of A (the small tile shape)
// over one part of K (blockIdx.z; down_parts), the same cp.async ring and
// per-stage rounded fp32 sums as the body; A's rows past r read as zeros, so
// u's padding columns come out 0.
template <typename T>
struct DownLayout {
  static constexpr int LD = Layout<T, Small>::LDX;  // x's and A's rows alike
  static constexpr int STAGES = Layout<T, Small>::STAGES;
  static constexpr int XS = Small::BM * LD;
  static constexpr int STAGE = XS + Small::BN * LD;
  static constexpr size_t SMEM = size_t(STAGES) * STAGE * sizeof(T);
  static_assert(SMEM <= 48 * 1024, "the down ring fits the default shared memory");
};

// A's rank rows [q0, q0 + 64) at depth k0 into as ([64][LD]), zeros past r and K.
template <typename T>
__device__ __forceinline__ void load_a(T* as, const Params& p, int64_t q0, int64_t k0) {
  using L = DownLayout<T>;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int BK = 32;
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const int tid = threadIdx.x;
  if (p.vec_a) {
    constexpr int kRow = BK / V;
    static_assert((Small::BN * kRow) % Small::kThreads == 0, "a chunks");
#pragma unroll
    for (int l = 0; l < Small::BN * kRow / Small::kThreads; ++l) {
      const int c = tid + l * Small::kThreads;
      const int row = c / kRow, col = (c % kRow) * V;
      const int64_t q = q0 + row, gk = k0 + col;
      const bool ok = q < p.r && gk < p.k;
      cp_async16(as + row * L::LD + col, ok ? a + q * p.k + gk : a, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < Small::BN * BK; e += Small::kThreads) {
      const int row = e / BK, col = e % BK;
      const int64_t q = q0 + row, gk = k0 + col;
      as[row * L::LD + col] = (q < p.r && gk < p.k) ? a[q * p.k + gk] : T(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Small::kThreads) down_gemm_kernel(Params p) {
  using L = DownLayout<T>;
  using C = Small;
  constexpr int S = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * C::BM;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * C::BN;
  // split z of K: depths [kb, kb + k_part), its partial u at part z
  const int64_t z = blockIdx.z, kb = z * p.k_part;
  const int64_t k_end = kb + p.k_part < p.k ? kb + p.k_part : p.k;

  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int64_t n_k = cdiv(k_end - kb, 32);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_k) {
      load_x<T, C>(ring + s * L::STAGE, p, m0, kb + s * 32);
      load_a<T>(ring + s * L::STAGE + L::XS, p, q0, kb + s * 32);
    }
    cp_async_commit();
  }
  for (int64_t kt = 0; kt < n_k; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    const int64_t next = kt + S - 1;
    if (next < n_k) {
      T* st = ring + (next % S) * L::STAGE;
      load_x<T, C>(st, p, m0, kb + next * 32);
      load_a<T>(st + L::XS, p, q0, kb + next * 32);
    }
    cp_async_commit();
    const T* st = ring + (kt % S) * L::STAGE;
    if constexpr (std::is_same<T, float>::value) {
      float part[C::MI][C::NI][4];  // the body's per-stage rounded sums
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
      mma_stage<T, C, L::LD, L::LD, true>(part, st, st + L::XS);
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
    } else {
      mma_stage<T, C, L::LD, L::LD, true>(acc, st, st + L::XS);
    }
  }
  cp_async_wait<0>();

  // u = scale * (x A^T), one rounding (a partial sum of it for each split of
  // K); every column below u_stride is written (past r: zeros)
  const float s = p.scale[0];
  float* __restrict__ u = p.u + z * p.m * p.u_stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / C::WN) * C::TM, wn = (warp % C::WN) * C::TN;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      const int64_t i = m0 + wm + mi * 16 + g, q = q0 + wn + ni * 8 + 2 * t;
      if (q >= p.u_stride) continue;
      if (i < p.m)
        *reinterpret_cast<float2*>(u + i * p.u_stride + q) =
            make_float2(s * acc[mi][ni][0], s * acc[mi][ni][1]);
      if (i + 8 < p.m)
        *reinterpret_cast<float2*>(u + (i + 8) * p.u_stride + q) =
            make_float2(s * acc[mi][ni][2], s * acc[mi][ni][3]);
    }
}

// ---------------------------------------------- single adapter: + u B^T --
// After the K loop the low-rank term runs as r more depth of the same
// accumulators: u's rows [m0, m0 + BM) (fp32) and B's rows [n0, n0 + BN) (one
// contiguous run of r a row) come in kRankChunk deep through two buffers over
// the ring, by 16-byte cp.async (B by scalar loads where its rows or its
// pointer are not 16-byte aligned), zeros past every edge; TF32 m16n8k8 with u
// split hi + lo, B too in fp32 (3xTF32) and exact in bf16 (2 products),
// added straight into acc: r / 8 depth steps of truncating adds (24 at r =
// 64) stay near 2^-20 of |y|, where the K loop's hundreds need the rounded
// per-stage sums.
template <typename T, class C>
struct TailLayout {
  static constexpr int RK = kRankChunk;
  static constexpr int LDU = RK + 4;                              // u rows, fp32
  static constexpr int LDB = RK + 16 / static_cast<int>(sizeof(T));  // B rows, T
  static constexpr size_t US = size_t(C::BM) * LDU * sizeof(float);
  static constexpr size_t BUF = US + size_t(C::BN) * LDB * sizeof(T);
  static_assert(US % 16 == 0 && BUF % 16 == 0, "16-byte tail buffers");
  static_assert(2 * BUF <= Layout<T, C>::SMEM, "two tail buffers fit over the ring");
};

template <typename T, class C>
__device__ __forceinline__ void load_tail(unsigned char* buf, const Params& p, int64_t m0,
                                          int64_t n0, int64_t q0) {
  using TL = TailLayout<T, C>;
  float* us = reinterpret_cast<float*>(buf);
  T* bs = reinterpret_cast<T*>(buf + TL::US);
  const int tid = threadIdx.x;
  constexpr int kU = TL::RK / 4;  // 16-byte chunks of a u row (its stride is a multiple of RK)
  for (int c = tid; c < C::BM * kU; c += C::kThreads) {
    const int row = c / kU, col = (c % kU) * 4;
    const int64_t gm = m0 + row;
    const bool ok = gm < p.m;
    const float* src = p.u + gm * p.u_stride + q0 + col;
    if (!std::is_same<C, Small>::value || p.u_parts == 1) {
      cp_async16(us + row * TL::LDU + col, ok ? src : p.u, ok ? 16 : 0);
    } else if constexpr (std::is_same<C, Small>::value) {
      // the down GEMM split K (small products only): its partial u's, all
      // loads in flight, summed in order
      float4 part[kMaxParts];
#pragma unroll
      for (int z = 0; z < kMaxParts; ++z)
        part[z] = ok && z < p.u_parts
                      ? *reinterpret_cast<const float4*>(src + z * p.m * p.u_stride)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 v = part[0];
#pragma unroll
      for (int z = 1; z < kMaxParts; ++z) {
        v.x += part[z].x;
        v.y += part[z].y;
        v.z += part[z].z;
        v.w += part[z].w;
      }
      *reinterpret_cast<float4*>(us + row * TL::LDU + col) = v;
    }
  }
  const T* __restrict__ b = static_cast<const T*>(p.b);
  if (p.vec_b) {
    constexpr int V = 16 / static_cast<int>(sizeof(T)), kB = TL::RK / V;
    for (int c = tid; c < C::BN * kB; c += C::kThreads) {
      const int row = c / kB, col = (c % kB) * V;
      const int64_t gn = n0 + row, q = q0 + col;
      const bool ok = gn < p.n && q < p.r;
      cp_async16(bs + row * TL::LDB + col, ok ? b + gn * p.r + q : b, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < C::BN * TL::RK; e += C::kThreads) {
      const int row = e / TL::RK, col = e % TL::RK;
      const int64_t gn = n0 + row, q = q0 + col;
      bs[row * TL::LDB + col] = (gn < p.n && q < p.r) ? b[gn * p.r + q] : T(0.f);
    }
  }
}

// acc += one buffer's u (BM x RK) B^T (RK x BN).  B's fragments of a depth
// step are loaded once, then u's row tiles one at a time, to keep the tail's
// live registers near the main loop's.
template <typename T, class C>
__device__ __forceinline__ void mma_tail(float (&acc)[C::MI][C::NI][4],
                                         const unsigned char* buf) {
  using TL = TailLayout<T, C>;
  constexpr bool kExactB = !std::is_same<T, float>::value;  // bf16 is exact in TF32
  const float* us = reinterpret_cast<const float*>(buf);
  const T* bs = reinterpret_cast<const T*>(buf + TL::US);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / C::WN) * C::TM, wn = (warp % C::WN) * C::TN;
  const int lr = lane & 15, lc = lane >> 4, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < TL::RK; ks += 8) {
    uint32_t bh[C::NI][2], bl[C::NI][2] = {};
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      const T* bp = bs + (wn + ni * 8 + g) * TL::LDB + ks + t;
      split<kExactB>(to_f32(bp[0]), bh[ni][0], bl[ni][0]);
      split<kExactB>(to_f32(bp[4]), bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
      uint32_t raw[4], ah[4], al[4];
      ldmatrix_x4(raw, us + (wm + mi * 16 + lr) * TL::LDU + ks + lc * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) split<false>(__uint_as_float(raw[e]), ah[e], al[e]);
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        mma_tf32(acc[mi][ni], al, bh[ni]);
        if constexpr (!kExactB) mma_tf32(acc[mi][ni], ah, bl[ni]);
        mma_tf32(acc[mi][ni], ah, bh[ni]);
      }
    }
  }
}

template <typename T, class C, bool kTail>
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
  if constexpr (!kTail) {
    for (int r = threadIdx.x; r < C::BM; r += C::kThreads) {
      const Seg sg = m0 + r < p.m ? segment(p, m0 + r) : Seg{-1, 0, 0};
      seg_lo[r] = sg.lo;
      seg_hi[r] = sg.hi;
    }
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
      mma_stage<T, C, L::LDX, L::LDW, false>(part, st, st + L::XS);
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
    } else {
      mma_stage<T, C, L::LDX, L::LDW, false>(acc, st, st + L::XS);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the tail's buffers, then the accumulator tile

  if constexpr (kTail) {
    using TL = TailLayout<T, C>;
    const int64_t n_r = p.u_stride / TL::RK;  // 0 at rank 0
    if (n_r > 0) load_tail<T, C>(smem_raw, p, m0, n0, 0);
    cp_async_commit();
    for (int64_t c = 0; c < n_r; ++c) {
      if (c + 1 < n_r) {
        load_tail<T, C>(smem_raw + ((c + 1) & 1) * TL::BUF, p, m0, n0, (c + 1) * TL::RK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      mma_tail<T, C>(acc, smem_raw + (c & 1) * TL::BUF);
      __syncthreads();  // everyone is done with this buffer
    }
  }

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
    if constexpr (!kTail) {  // the batched path: the row's own segment rows of b
      const int64_t lo = seg_lo[r], hi = seg_hi[r];
      const float* __restrict__ u = p.u + i * p.u_stride;
      if (p.vec_b && full) {
#pragma unroll 4
        for (int64_t q = lo; q < hi; ++q) {
          float bv[VPL];
          load_vec<T, VPL>(b + q * p.n + c0, bv);
          const float uq = u[q - lo];
#pragma unroll
          for (int j = 0; j < VPL; ++j) v[j] = fmaf(uq, bv[j], v[j]);
        }
      } else {
        for (int64_t q = lo; q < hi; ++q) {
          const float uq = u[q - lo];
#pragma unroll
          for (int j = 0; j < VPL; ++j)
            if (c0 + j < p.n) v[j] = fmaf(uq, to_f32(b[q * p.n + c0 + j]), v[j]);
        }
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

template <typename T, class C, bool kTail>
cudaError_t launch_gemm(Params p, cudaStream_t stream) {
  using L = Layout<T, C>;
  constexpr int VPL = 4;  // the epilogue's columns a lane
  const int64_t tiles = cdiv(p.m, C::BM) * cdiv(p.n, C::BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the batched epilogue reads rows of b as vectors; the tail stages B's
  // rows of r by 16-byte copies
  p.vec_b = kTail ? (p.r * static_cast<int64_t>(sizeof(T))) % 16 == 0 && aligned(p.b, 16)
                  : p.n % VPL == 0 && aligned(p.b, VPL * sizeof(T));
  p.vec_y = p.n % VPL == 0 && aligned(p.y, VPL * sizeof(T));
  // past 48 KB a block's shared memory needs the attribute, once per device
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (L::SMEM > 48 * 1024 && (dev >= kMaxDevices || !raised[dev])) {
    err = cudaFuncSetAttribute(gemm_kernel<T, C, kTail>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::SMEM));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) raised[dev] = true;
  }
  gemm_kernel<T, C, kTail><<<static_cast<unsigned>(tiles), C::kThreads, L::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// The body takes the 128 x 128 tiles where they give every SM one.
bool large_body(int64_t m, int64_t n) {
  return cdiv(m, Large::BM) * cdiv(n, Large::BN) >= sm_count();
}

template <typename T, bool kTail>
cudaError_t launch_body(const Params& p, cudaStream_t stream) {
  return large_body(p.m, p.n) ? launch_gemm<T, Large, kTail>(p, stream)
                              : launch_gemm<T, Small, kTail>(p, stream);
}

// The batched path: the down pass a request row, then the body.
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
  return launch_body<T, false>(p, stream);
}

// The single adapter's split of K for the down GEMM: where its tiles leave
// SMs idle (a few hundred rows) and the body takes the small tiles, K is cut
// into parts of at least 4 stages, each a partial u the tail sums, so that
// more blocks each walk less depth.
int64_t down_parts(int64_t m, int64_t k, int64_t n, int64_t u_stride) {
  const int64_t n_k = cdiv(k, 32);
  const int64_t tiles = cdiv(m, Small::BM) * cdiv(u_stride, Small::BN);
  const int64_t sms = sm_count();
  if (n_k == 0 || tiles == 0 || tiles >= sms || large_body(m, n)) return 1;
  int64_t parts = sms / tiles < n_k / 4 ? sms / tiles : n_k / 4;
  if (parts < 1) parts = 1;
  if (parts > kMaxParts) parts = kMaxParts;
  return cdiv(k, cdiv(n_k, parts) * 32);  // every part non-empty
}

// The single adapter: u = s x A^T on the tensor cores (none at rank 0), then
// the body with u B^T as its tail.
template <typename T>
cudaError_t launch_single(Params p, cudaStream_t stream) {
  constexpr int64_t V = 16 / sizeof(T);
  if (p.m > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.vec_x = p.k % V == 0 && aligned(p.x, 16);
  p.vec_a = p.k % V == 0 && aligned(p.a, 16);
  p.vec_w = p.n % V == 0 && aligned(p.w, 16);
  p.u_parts = 1;
  if (p.r > 0) {
    p.u_parts = down_parts(p.m, p.k, p.n, p.u_stride);
    p.k_part = p.u_parts > 1 ? cdiv(cdiv(p.k, 32), p.u_parts) * 32 : cdiv(p.k, 32) * 32;
    const int64_t grid_x = cdiv(p.m, Small::BM), grid_y = cdiv(p.u_stride, Small::BN);
    if (grid_x > 0x7fffffffLL || grid_y > 65535) return cudaErrorInvalidValue;
    down_gemm_kernel<T><<<dim3(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y),
                               static_cast<unsigned>(p.u_parts)),
                          Small::kThreads, DownLayout<T>::SMEM, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_body<T, true>(p, stream);
}

cudaError_t dispatch(const Params& p, int dtype, bool single, void* stream) {
  if (p.m <= 0 || p.n <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return single ? launch_single<float>(p, s) : launch<float>(p, s);
    case kBF16:
      return single ? launch_single<__nv_bfloat16>(p, s) : launch<__nv_bfloat16>(p, s);
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
                 r_total > 0 ? r_total : 1, y, m, k, n, r_total,
                 false, false, false, false, false};
  return dispatch(p, dtype, false, stream);
}

// lora_matmul: x (m, k), w (k, n), a (r, k), b (n, r), all of `dtype` and
// contiguous (b at any address); scale one f32 on the device; u an f32
// scratch of lora_matmul_single_scratch(m, k, n, r) elements (none at rank 0);
// y (m, n).
int lora_matmul_single(const void* x, const void* w, const void* a, const void* b,
                       const float* scale, float* u, void* y, int dtype, int64_t m, int64_t k,
                       int64_t n, int64_t r, void* stream) {
  if (r < 0) return cudaErrorInvalidValue;
  const Params p{x, w, a, b, nullptr, nullptr, nullptr, scale, 0, u,
                 cdiv(r, kRankChunk) * kRankChunk, y, m, k, n, r,
                 false, false, false, false, false};
  return dispatch(p, dtype, true, stream);
}

// The fp32 elements of lora_matmul_single's scratch on the current device:
// one (m, r rounded up to a multiple of kRankChunk = 32) partial u for each
// split of K the down GEMM makes there.
int64_t lora_matmul_single_scratch(int64_t m, int64_t k, int64_t n, int64_t r) {
  if (m <= 0 || r <= 0) return 0;
  const int64_t u_stride = cdiv(r, kRankChunk) * kRankChunk;
  return down_parts(m, k, n, u_stride) * m * u_stride;
}

}  // extern "C"
