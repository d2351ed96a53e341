// Byzantine-robust grouped aggregation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel packed_robust_pallas (_packed_robust_kernel)
// of src/repro/kernels/rbla_agg/kernel.py: the robust sibling of packed_agg
// over the same owner masks, dequantisation scales and prev rule, in one of
// three modes.  The TPU kernel takes one packed (N, R, D) bucket per (width,
// dtype); here ONE grouped launch takes every pair side of a round where it
// lies, each A by rank row and each B by rank column, each client's upload in
// its own wire dtype (agg_group.cuh; a packed buffer is the one-segment case).
//
//   * clipped: every owned client row, dequantised, is scaled by
//     min(1, clip_norm / max(||row||, 1e-12)) and enters the masked weighted
//     mean sum_n w_n m_nr x_nr / sum_n w_n m_nr.  A client whose w_n * m_nr is
//     0 adds nothing to the row, whatever its values.
//   * trimmed / median: unweighted order statistics over the c owners of each
//     rank row (m_nr > 0).  Unowned slots hold the sentinel 1e30, the client
//     axis is sorted, positions [k, c - k) are averaged with
//     k = min(floor(trim_frac * c) in fp32, (c - 1) / 2); the median averages
//     positions (c - 1) / 2 and c / 2.
//
// Rows no client owns keep prev (or 0 without prev).  Dequantisation comes
// before the clip or the sort.  The output is f32 or bf16 per segment.
//
// What bounds it, and the design.  The least time is bytes / 3.35 TB/s (H100
// SXM): the owned rows of x once, the output once.  The bucket kernel this
// replaces was bound by instructions at (10, 2048, 4096): one column a thread
// in scalar loads, a bitonic network padded to 16 slots at N = 10 (80
// compare-exchanges), and at every compare-exchange a NaN-aware order and a
// branch.  Here:
//
//   * trimmed / median (sort_kernel): each thread takes K consecutive columns
//     (K * NET <= 64 values in registers: K = 4 up to 16 clients), loaded as
//     one vector per client.  The network is Batcher's odd-even merge sort of
//     the next power of two, pruned to the cohort's N for N <= 16 (a
//     comparator whose upper wire is past N never swaps), 32 compare-exchanges
//     at N = 10; 32 and 64 slots (padded with +inf) above that, and
//     selection by counting beyond 64 clients.  A compare-exchange is one
//     fminf and one fmaxf.  NaN and +-inf are handled once per element: a
//     non-finite owned value flags the element, and a flagged element is
//     computed by counting in the NaN-aware total order (NaN above every
//     number), whose sum then has the plain version's NaN or infinity
//     whatever its order.  Unflagged elements sum the selected sorted
//     positions in order, as before: bit-identical whatever the grouping.
//   * clipped (clip_kernel) needs whole-rank-row norms, and in B's layout a
//     rank row is a strided column.  One block takes one rank row of any
//     segment and reads it through L2: pass 1 each owned client's row norm (a
//     block reduction in a fixed order, no atomics) into a clip factor, pass 2
//     the clipped weighted mean.
//
// Plain C interface (loaded with ctypes): launches on the given stream, never
// synchronises, allocates nothing, returns the CUDA error code (0 on success).

#include <math.h>

#include <utility>

#include "agg_group.cuh"

namespace {

enum Mode : int { kClipped = 0, kTrimmed = 1, kMedian = 2 };

constexpr int kClipThreads = 256;
constexpr int kSortThreads = 128;
constexpr float kSentinel = 1e30f;
constexpr int kMaxClients = 2048;

// Block-wide sum of one value per thread in a fixed order; every thread gets
// the total.  s_red holds 33 floats.
__device__ __forceinline__ float block_sum(float v, float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.0f;
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) tot += s_red[i];
    s_red[32] = tot;
  }
  __syncthreads();
  const float tot = s_red[32];
  __syncthreads();
  return tot;
}

// Element f of a client's leaf: a plain fp32 load in an fp32 launch, else in
// the client's dtype.
__device__ __forceinline__ float load_x(const Client& c, bool f32, int64_t f) {
  return f32 ? reinterpret_cast<const float*>(c.x)[f] : load_one(c.x, c.code, f);
}

// Four elements from f (a multiple of 4), as one vector.
__device__ __forceinline__ void load4(const Client& c, bool f32, int64_t f, float (&v)[4]) {
  if (f32) load_k<float, 4>(reinterpret_cast<const float*>(c.x) + f, v);
  else load_any<4>(c.x, c.code, f, v);
}

// ------------------------------------------------------------------ clipped --
// One block per rank row.  Shared: each client's w * m, scale and clip
// factor, plus 33 floats for the block sums.
__global__ void __launch_bounds__(kClipThreads) clip_kernel(const __grid_constant__ Table tab) {
  const View t(tab);
  extern __shared__ float smem[];
  const int n = t.h.n;
  float* s_wm = smem;
  float* s_sc = s_wm + n;
  float* s_clip = s_sc + n;
  float* s_red = s_clip + n;
  const int64_t blk = blockIdx.x;
  const Seg& s = t.segs[find_seg(t.segs, t.h.n_segs, blk)];
  const SegIn& g = s.in;
  const int64_t rr = blk - s.first_tile;
  const RankRow lay = rank_row_layout(g, rr);
  const int oc = out_code(g);
  const bool f32 = t.h.dtype == kF32;        // uniform per launch
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Client c = client(t, g, i);
    s_wm[i] = t.h.weights[i] * t.h.masks[static_cast<int64_t>(i) * t.h.mask_cols + g.mask_off + rr];
    s_sc[i] = c.scale != nullptr ? c.scale[rr] : 1.0f;
  }
  __syncthreads();
  const bool vec = vec_rows(g);               // 4-element vectors along the row
  // pass 1: the clip factor of every client that counts in this row
  for (int i = 0; i < n; ++i) {
    if (s_wm[i] == 0.0f) continue;                      // uniform across the block
    const Client c = client(t, g, i);
    const float sc = s_sc[i];
    float sq = 0.0f;
    if (vec) {
      for (int64_t e = 4 * static_cast<int64_t>(threadIdx.x); e < lay.elems;
           e += 4 * static_cast<int64_t>(blockDim.x)) {
        float xv[4];
        load4(c, f32, lay.first + e, xv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float xn = __fmul_rn(sc, xv[k]);
          sq = __fmaf_rn(xn, xn, sq);
        }
      }
    } else {
      for (int64_t e = threadIdx.x; e < lay.elems; e += blockDim.x) {
        const float xn = __fmul_rn(sc, load_x(c, f32, lay.first + e * lay.step));
        sq = __fmaf_rn(xn, xn, sq);
      }
    }
    sq = block_sum(sq, s_red);
    if (threadIdx.x == 0) {
      const float norm = sqrtf(sq);
      const float safe = norm < 1e-12f ? 1e-12f : norm;   // a NaN norm passes
      const float f = t.h.clip_norm / safe;
      s_clip[i] = f > 1.0f ? 1.0f : f;                     // a NaN factor passes
    }
  }
  __syncthreads();
  float den = 0.0f;
  for (int i = 0; i < n; ++i) den = __fadd_rn(den, s_wm[i]);
  // pass 2: the clipped masked weighted mean
  if (vec) {
    for (int64_t e = 4 * static_cast<int64_t>(threadIdx.x); e < lay.elems;
         e += 4 * static_cast<int64_t>(blockDim.x)) {
      const int64_t f = lay.first + e;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = 0; i < n; ++i) {
        const float wm = s_wm[i];
        if (wm == 0.0f) continue;
        float xv[4];
        load4(client(t, g, i), f32, f, xv);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[k] = __fmaf_rn(wm, __fmul_rn(s_clip[i], __fmul_rn(s_sc[i], xv[k])), acc[k]);
      }
      if (den > 0.0f) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = __fdiv_rn(acc[k], den);
      } else if (g.prev != nullptr) {
        load_any<4>(g.prev, oc, f, acc);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = 0.0f;
      }
      store_any<4>(g.out, oc, f, acc);
    }
    return;
  }
  for (int64_t e = threadIdx.x; e < lay.elems; e += blockDim.x) {
    const int64_t f = lay.first + e * lay.step;
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float wm = s_wm[i];
      if (wm == 0.0f) continue;
      acc = __fmaf_rn(wm, __fmul_rn(s_clip[i], __fmul_rn(s_sc[i], load_x(client(t, g, i), f32, f))),
                      acc);
    }
    float v;
    if (den > 0.0f) v = __fdiv_rn(acc, den);
    else v = g.prev != nullptr ? load_one(g.prev, oc, f) : 0.0f;
    store_one(g.out, oc, f, v);
  }
}

// ------------------------------------------------------- order statistics --
// Positions [k, c - k) (trimmed) or (c-1)/2 and c/2 (median) of the sorted
// owners of a row with c owners, and the divisor.
__device__ __forceinline__ void selection(int c, int mode, float trim_frac, int& lo, int& hi,
                                          float& div) {
  if (mode == kMedian) {
    lo = c >= 1 ? (c - 1) / 2 : 0;
    hi = c / 2;
    div = 1.0f;
    return;
  }
  const int half = c >= 1 ? (c - 1) / 2 : 0;
  int k = static_cast<int>(floorf(trim_frac * static_cast<float>(c)));
  k = k < half ? k : half;
  lo = k;
  hi = c - k;
  const float keep = static_cast<float>(c - 2 * k);
  div = keep > 1.0f ? keep : 1.0f;
}

// The selection weight of sorted position j: 0/1 (trimmed), 0/0.5/1 (median).
__device__ __forceinline__ float select_weight(int j, int mode, int lo, int hi) {
  if (mode == kMedian) return 0.5f * (static_cast<float>(j == lo) + static_cast<float>(j == hi));
  return static_cast<float>(j >= lo && j < hi);
}

// a > b in the total order with NaN above every number
__device__ __forceinline__ bool greater(float a, float b) {
  return a > b || (isnan(a) && !isnan(b));
}

// A rank row's per-client inputs at one element.
struct Owners {
  const View& t;
  const SegIn& g;
  int64_t f;          // flat index of the element
  int64_t rr;         // its rank row
  __device__ __forceinline__ bool owned(int i) const {
    return t.h.masks[static_cast<int64_t>(i) * t.h.mask_cols + g.mask_off + rr] > 0.0f;
  }
  __device__ __forceinline__ float value(int i) const {   // the dequantised value, or the sentinel
    if (!owned(i)) return kSentinel;
    const Client c = client(t, g, i);
    const float sc = c.scale != nullptr ? c.scale[rr] : 1.0f;
    return __fmul_rn(sc, load_one(c.x, c.code, f));
  }
};

// Selection by counting: the sorted position of client i's value is the number
// of values below it in the total order plus the equal ones of lower index.
// The sum runs in client order.
__device__ __noinline__ float count_select(const Owners& o, int n, int mode, int lo, int hi) {
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float vi = o.value(i);
    int pos = 0;
    for (int j = 0; j < n; ++j) {
      const float vj = o.value(j);
      pos += greater(vi, vj) || (j < i && !greater(vj, vi));
    }
    acc = __fmaf_rn(select_weight(pos, mode, lo, hi), vi, acc);
  }
  return acc;
}

__device__ __forceinline__ void cex(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

__host__ __device__ constexpr int next_pow2(int n) { return n <= 1 ? 1 : 2 * next_pow2((n + 1) / 2); }

struct Cex {
  int a, b;
};

// Comparator `idx` of Batcher's odd-even merge sort of next_pow2(n) wires,
// keeping those whose wires are both below n (the others never swap when
// the missing wires hold +inf); past the end {-1, the number of
// comparators}.  Evaluated at compile time only.
__host__ __device__ constexpr Cex batcher(int n, int idx) {
  const int n2 = next_pow2(n);
  int c = 0;
  for (int p = 1; p < n2; p <<= 1) {
    for (int k = p; k >= 1; k >>= 1) {
      for (int j = k % p; j + k < n2; j += 2 * k) {
        for (int i = 0; i < k; ++i) {
          const int a = i + j, b = i + j + k;
          if (b < n && a / (2 * p) == b / (2 * p)) {
            if (c == idx) return {a, b};
            ++c;
          }
        }
      }
    }
  }
  return {-1, c};
}

__host__ __device__ constexpr int batcher_size(int n) { return batcher(n, 1 << 30).b; }

template <int N, int I>
__device__ __forceinline__ void cex_at(float (&v)[N]) {
  constexpr Cex c = batcher(N, I);
  cex(v[c.a], v[c.b]);
}

template <int N, int... I>
__device__ __forceinline__ void apply_net(float (&v)[N], std::integer_sequence<int, I...>) {
  (cex_at<N, I>(v), ...);
}

// The network on N registers, every index a compile-time constant.
template <int N>
__device__ __forceinline__ void sort_net(float (&v)[N]) {
  apply_net<N>(v, std::make_integer_sequence<int, batcher_size(N)>{});
}

// K consecutive elements of segment g at (row, col), NET >= n slots each.
template <int NET, int K>
__device__ __forceinline__ void sort_group(const View& t, const SegIn& g, int64_t row,
                                           int64_t col) {
  const int n = t.h.n, mode = t.h.mode;
  const int64_t f = row * g.width + col;
  const int64_t rr0 = rank_row(g, row, col);
  const bool col_mode = g.col_group != 0;
  const int oc = out_code(g);
  float v[K][NET];
  int c[K];
  bool bad[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    c[k] = 0;
    bad[k] = false;
  }
  const bool f32 = t.h.dtype == kF32;   // uniform per launch: loads without a switch
#pragma unroll
  for (int j = 0; j < NET; ++j) {
    if (j < n) {
      const Client cl = client(t, g, j);
      const float* __restrict__ m = t.h.masks + static_cast<int64_t>(j) * t.h.mask_cols +
                                    g.mask_off + rr0;
      float xv[K];
      if (f32) load_k<float, K>(reinterpret_cast<const float*>(cl.x) + f, xv);
      else load_any<K>(cl.x, cl.code, f, xv);
      // row mode: one mask and scale for the K columns
      const float m0 = m[0];
      const float sc0 = cl.scale != nullptr ? cl.scale[rr0] : 1.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool ck = col_mode && k > 0;
        const float sc = ck ? (cl.scale != nullptr ? cl.scale[rr0 + k] : 1.0f) : sc0;
        const bool own = (ck ? m[k] : m0) > 0.0f;
        const float val = __fmul_rn(sc, xv[k]);
        v[k][j] = own ? val : kSentinel;
        c[k] += own;
        bad[k] |= own && !isfinite(val);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) v[k][j] = INFINITY;
    }
  }
  float out[K];
  bool need_prev = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sort_net<NET>(v[k]);
    int lo, hi;
    float div;
    selection(c[k], mode, t.h.trim_frac, lo, hi, div);
    float acc;
    if (bad[k]) {
      acc = 0.0f;                             // counted below
    } else if (mode == kMedian) {
      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int j = 0; j < NET; ++j) {
        if (j == lo) a = v[k][j];
        if (j == hi) b = v[k][j];
      }
      acc = lo == hi ? a : __fmaf_rn(0.5f, b, __fmul_rn(0.5f, a));
    } else {
      acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NET; ++j) {
        if (j >= lo && j < hi) acc = __fadd_rn(acc, v[k][j]);
      }
    }
    out[k] = __fdiv_rn(acc, div);
    need_prev |= c[k] == 0;
  }
  bool any_bad = false;
#pragma unroll
  for (int k = 0; k < K; ++k) any_bad |= bad[k];
  if (any_bad) {                              // rare: a non-finite owned value
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!bad[k]) continue;
      int lo, hi;
      float div;
      selection(c[k], mode, t.h.trim_frac, lo, hi, div);
      const Owners o{t, g, f + k, rr0 + (col_mode ? k : 0)};
      out[k] = __fdiv_rn(count_select(o, n, mode, lo, hi), div);
    }
  }
  if (need_prev) {
    float pv[K];
    if (g.prev != nullptr) {
      load_any<K>(g.prev, oc, f, pv);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) pv[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (c[k] == 0) out[k] = pv[k];
  }
  store_any<K>(g.out, oc, f, out);
}

// More than 64 clients: selection by counting, one element at a time.
__device__ __forceinline__ void count_one(const View& t, const SegIn& g, int64_t row,
                                          int64_t col) {
  const int n = t.h.n, mode = t.h.mode;
  const int64_t f = row * g.width + col;
  const Owners o{t, g, f, rank_row(g, row, col)};
  int c = 0;
  for (int i = 0; i < n; ++i) c += o.owned(i);
  int lo, hi;
  float div;
  selection(c, mode, t.h.trim_frac, lo, hi, div);
  float v;
  if (c == 0) v = g.prev != nullptr ? load_one(g.prev, out_code(g), f) : 0.0f;
  else v = __fdiv_rn(count_select(o, n, mode, lo, hi), div);
  store_one(g.out, out_code(g), f, v);
}

template <int NET, int K>
__device__ __forceinline__ void sort_elems(const View& t, const SegIn& g, int64_t row,
                                           int64_t col) {
  if constexpr (NET == 0) count_one(t, g, row, col);
  else sort_group<NET, K>(t, g, row, col);
}

// One block's tile: as rbla_agg.cu's mean_tile, in groups of K columns.
template <int NET, int K>
__device__ __forceinline__ void sort_tile(const View& t, const Seg& s, int64_t tile) {
  const SegIn& g = s.in;
  const int tpr = s.tpr;
  const int64_t row = (tile / s.chunks) * (kSortThreads / tpr) + threadIdx.x / tpr;
  if (row >= g.rows) return;
  const int lane = threadIdx.x & (tpr - 1);
  const int chunk = static_cast<int>(tile % s.chunks);
  const int64_t base = row * g.width;
  int64_t head = (K - base % K) % K;
  if (head > g.width) head = g.width;
  const int64_t n_vec = (g.width - head) / K;
  const int64_t tail = head + n_vec * K;
  const int64_t step = static_cast<int64_t>(s.chunks) * tpr;
  for (int64_t v = static_cast<int64_t>(chunk) * tpr + lane; v < n_vec; v += step)
    sort_elems<NET, K>(t, g, row, head + v * K);
  if (K > 1 && chunk == 0) {
    for (int64_t c = lane; c < head; c += tpr) sort_elems<NET, 1>(t, g, row, c);
    for (int64_t c = tail + lane; c < g.width; c += tpr) sort_elems<NET, 1>(t, g, row, c);
  }
}

// columns a thread takes at once: at most 64 values in registers
template <int NET> __host__ __device__ constexpr int cols_of() { return NET == 0 ? 1 : NET <= 16 ? 4 : 64 / NET; }

template <int NET>
__global__ void __launch_bounds__(kSortThreads) sort_kernel(const __grid_constant__ Table tab) {
  const View t(tab);
  const int64_t blk = blockIdx.x;
  const Seg& s = t.segs[find_seg(t.segs, t.h.n_segs, blk)];
  constexpr int K = cols_of<NET>();
  if ((s.in.flags >> 8) & 1) sort_tile<NET, K>(t, s, blk - s.first_tile);
  else sort_tile<NET, 1>(t, s, blk - s.first_tile);
}

// ----------------------------------------------------------------- launch --
struct Launch {
  GroupArgs a;
  Seg* host;              // layout only: fill this device-table image
  const void* dev;        // the device table, or null: inline
  int64_t* tiles;
  cudaStream_t stream;
};

template <int NET>
cudaError_t run(const Launch& l) {
  const GroupArgs& a = l.a;
  const bool clip = a.head.mode == kClipped;
  auto fill = [&](Seg* segs) {
    return clip ? layout_rank_rows(a.segs, a.n_segs, segs)
                : layout_stream(a.segs, a.n_segs, segs, cols_of<NET>(), kSortThreads);
  };
  if (l.host != nullptr) {
    const int64_t total = fill(l.host);
    if (total < 0) return cudaErrorInvalidValue;
    char* p = reinterpret_cast<char*>(l.host + a.n_segs);
    if (a.n_ents > 0) memcpy(p, a.ents, a.n_ents * sizeof(Entry));
    if (a.head.dtype == kMixed) memcpy(p + a.n_ents * sizeof(Entry), a.cdt, a.head.n);
    *l.tiles = total;
    return cudaSuccess;
  }
  Table t;
  t.h = a.head;
  int64_t total;
  if (l.dev != nullptr) {
    const char* d = static_cast<const char*>(l.dev);
    t.h.segs = reinterpret_cast<const Seg*>(d);
    t.h.ents = reinterpret_cast<const Entry*>(d + a.n_segs * sizeof(Seg));
    t.h.cdt = reinterpret_cast<const uint8_t*>(d + a.n_segs * sizeof(Seg) +
                                               a.n_ents * sizeof(Entry));
    total = *l.tiles;
  } else {
    if (!fits_inline(a)) return cudaErrorInvalidValue;
    t.h.segs = nullptr;
    t.h.ents = nullptr;
    t.h.cdt = nullptr;
    total = fill(t.seg);
    if (total < 0) return cudaErrorInvalidValue;
    if (a.n_ents > 0) memcpy(t.ent, a.ents, a.n_ents * sizeof(Entry));
    if (a.head.dtype == kMixed) memcpy(t.cdt, a.cdt, a.head.n);
  }
  if (total == 0) return cudaSuccess;
  if (clip) {
    const size_t smem = (3 * static_cast<size_t>(a.head.n) + 33) * sizeof(float);
    clip_kernel<<<static_cast<unsigned>(total), kClipThreads, smem, l.stream>>>(t);
  } else {
    sort_kernel<NET><<<static_cast<unsigned>(total), kSortThreads, 0, l.stream>>>(t);
  }
  return cudaGetLastError();
}

// The network of a cohort of n: exact up to 16 clients, then 32 and 64 slots,
// then counting.
cudaError_t dispatch(const Launch& l) {
  const int n = l.a.head.n;
  if (l.a.n_segs < 1 || n < 1 || n > kMaxClients) return cudaErrorInvalidValue;
  if (l.a.head.mode < kClipped || l.a.head.mode > kMedian) return cudaErrorInvalidValue;
  if (l.a.head.dtype < kF32 || l.a.head.dtype > kMixed) return cudaErrorInvalidValue;
  if (l.a.head.mode == kClipped) return run<0>(l);
  switch (n) {
    case 1: return run<1>(l);
    case 2: return run<2>(l);
    case 3: return run<3>(l);
    case 4: return run<4>(l);
    case 5: return run<5>(l);
    case 6: return run<6>(l);
    case 7: return run<7>(l);
    case 8: return run<8>(l);
    case 9: return run<9>(l);
    case 10: return run<10>(l);
    case 11: return run<11>(l);
    case 12: return run<12>(l);
    case 13: return run<13>(l);
    case 14: return run<14>(l);
    case 15: return run<15>(l);
    case 16: return run<16>(l);
    default: break;
  }
  if (n <= 32) return run<32>(l);
  if (n <= 64) return run<64>(l);
  return run<0>(l);
}

GroupArgs group_args(const void* segs, int n_segs, const void* ents, int n_ents,
                     const uint8_t* cdt, const float* masks, int64_t mask_cols,
                     const float* weights, int n, int dtype, int mode, float clip_norm,
                     float trim_frac) {
  GroupArgs a{};
  a.segs = static_cast<const SegIn*>(segs);
  a.n_segs = n_segs;
  a.ents = static_cast<const Entry*>(ents);
  a.n_ents = n_ents;
  a.cdt = cdt;
  a.head.masks = masks;
  a.head.mask_cols = mask_cols;
  a.head.weights = weights;
  a.head.n = n;
  a.head.n_segs = n_segs;
  a.head.dtype = dtype;
  a.head.mode = mode;
  a.head.clip_norm = clip_norm;
  a.head.trim_frac = trim_frac;
  return a;
}

}  // namespace

extern "C" {

// packed_robust_group: the segments and entries of one round (the table of
// agg_group.cuh, as rbla_agg.cu's packed_agg_group) in one launch.  mode: 0
// clipped, 1 trimmed, 2 median.  1 <= n <= 2048.  packed_robust_layout and
// packed_robust_group_table are the device-table path.
int packed_robust_group(const void* segs, int n_segs, const void* ents, int n_ents,
                        const uint8_t* cdt, const float* masks, int64_t mask_cols,
                        const float* weights, int n, int dtype, int mode, float clip_norm,
                        float trim_frac, void* stream) {
  const Launch l{group_args(segs, n_segs, ents, n_ents, cdt, masks, mask_cols, weights, n, dtype,
                            mode, clip_norm, trim_frac),
                 nullptr, nullptr, nullptr, static_cast<cudaStream_t>(stream)};
  return dispatch(l);
}

int packed_robust_layout(const void* segs, int n_segs, const void* ents, int n_ents,
                         const uint8_t* cdt, int n, int dtype, int mode, void* table,
                         int64_t* tiles) {
  const Launch l{group_args(segs, n_segs, ents, n_ents, cdt, nullptr, 0, nullptr, n, dtype, mode,
                            0.0f, 0.0f),
                 static_cast<Seg*>(table), nullptr, tiles, nullptr};
  return dispatch(l);
}

int packed_robust_group_table(const void* dev_table, int n_segs, int n_ents, int64_t tiles,
                              const float* masks, int64_t mask_cols, const float* weights, int n,
                              int dtype, int mode, float clip_norm, float trim_frac,
                              void* stream) {
  int64_t t = tiles;
  const Launch l{group_args(nullptr, n_segs, nullptr, n_ents, nullptr, masks, mask_cols, weights,
                            n, dtype, mode, clip_norm, trim_frac),
                 nullptr, dev_table, &t, static_cast<cudaStream_t>(stream)};
  return dispatch(l);
}

}  // extern "C"
