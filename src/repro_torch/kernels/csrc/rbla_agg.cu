// RBLA server-side aggregation kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/rbla_agg/kernel.py
// that the synchronous FL round runs:
//
//   * packed_agg_pallas (_packed_kernel): the masked weighted mean over the
//     clients of one round, sum_n w_n m_nr s_nr x_nr / sum_n w_n m_nr per
//     rank row r, with owner masks m (n, rank rows); rows no client owns keep
//     `prev`; norm_by "weight" divides by the total mass; optional per-row
//     dequantisation scales s on the load; optional norm_restore (rbla_norm's
//     per-row L2 rescale).  The TPU kernel takes one packed (N, R, D) bucket
//     per (width, dtype); here ONE grouped launch takes every pair side of
//     the round where it lies (agg_group.cuh): each A by rank row, each B
//     (fan_out, r) by rank column, each client's upload in its own wire dtype
//     with its int8 scales.  The plan packs, transposes, stacks and casts
//     nothing around the launch.  A packed (N, R, D) buffer is the
//     one-segment case (the `packed_agg` wrapper).
//   * rbla_agg_pallas (_kernel): the same mean with the owner mask derived
//     in-kernel from a rank vector, [r < ranks[n]] (paper Eq. 7), one launch
//     per (N, R, D) leaf; the per-pair path (aggregate_tree_pallas) calls it
//     twice a pair, B through a transposed copy.  Here rbla_agg_group runs
//     the same mean body on the same segment table with the masks taken from
//     an int32 rank matrix (one column a pair), so ONE launch takes every
//     pair side of a per-pair round in its own layout, and the previous
//     global is read in place where no client owns a rank row.
//
// What bounds them: bytes.  Every x element is read once and feeds one FMA,
// so the least time is bytes / 3.35 TB/s (H100 SXM).  At the paper MLP's
// round (10 clients, r_max 64) that is about 1.4 us, and what cost the time
// was host work: three bucket launches (or six per-pair ones), each wrapped
// in packing copies, and the copies back out of B's transposes.  The
// grouped launch leaves one launch a round and no copies.
//
// The mean (stream_kernel): blocks map to (segment, tile); a row is served by
// tpr threads, each moving 16-byte vectors of it (a scalar head and tail where
// the row's flat start is not vector-aligned, scalar throughout where a base
// pointer is not 16-byte aligned).  The clients are summed in order with the
// same fp32 operations as the bucket kernel it replaces (den = fma(w, m, den),
// acc = fma(w * m, s * x, acc)), so the result does not depend on how the
// cohort's leaves are grouped: a leaf aggregated alone, in a bucket or in a
// round gives the same bits, and rank masks give the bits of the equal float
// masks.  In column mode the VEC elements of a vector are VEC rank rows, each
// with its own masks and scales.  Every client's value is loaded whether it
// owns the element or not, as JAX's (w * m) * x does: a NaN in a rank row a
// client does not own reaches the result.
//
// norm_restore (norm_kernel) needs whole-rank-row norms, and in B's layout a
// rank row is a strided column.  One block takes one rank row of any segment,
// reads it through L2, and reduces in a fixed order (no atomics): pass 1 the
// mean with each client's masked row norm (per-thread partials in shared
// memory, as the bucket kernel kept them) and the output row's norm, pass 2
// the mean again, rescaled.  Two runs give the same bits.  Its shared memory
// holds 128 + 4 floats a client: up to about 440 clients, as before.
//
// A donated round writes its output into the previous global's own storage
// (a segment's out pointer equal to its prev pointer).  Every path here is
// safe under that alias, so no pointer carries __restrict__ (the helpers in
// common.cuh take one pointer each): stream_kernel's thread that reads prev
// at (out code, f) is the one that writes the output there, after the read,
// and no other thread touches f (each element is one thread's, head and tail
// included; in column mode a vector's K elements are K rank rows of one
// memory row, read and written together).  norm_kernel's block owns a whole
// rank row: pass 1 reads prev and writes nothing, and in pass 2 each thread
// reads prev at e and writes the output at e, for its own e only.
//
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, never synchronises, allocates nothing, and returns the CUDA
// error code of the launch (0 on success).

#include "agg_group.cuh"

namespace {

constexpr int kStreamThreads = 256;
constexpr int kNormThreads = 128;
constexpr int kByWeight = 1, kNormRestore = 2;   // bits of Head::mode

struct MixedIn {};   // the client dtype of a kMixed launch: each client's own

// elements per 16-byte vector of x (4 for a mixed launch: 16 bytes of fp32)
template <typename Tin> __host__ __device__ constexpr int vec_of() {
  return std::is_same<Tin, MixedIn>::value ? 4 : static_cast<int>(16 / sizeof(Tin));
}

// K elements of client n's row at flat index f.
template <typename Tin, int K>
__device__ __forceinline__ void load_client(const Client& c, int64_t f, float (&v)[K]) {
  if constexpr (std::is_same<Tin, MixedIn>::value) {
    load_any<K>(c.x, c.code, f, v);
  } else {
    load_k<Tin, K>(reinterpret_cast<const Tin*>(c.x) + f, v);
  }
}

// Where a launch's owner masks come from: the head's (n, mask_cols) float
// matrix (packed_agg_group), or its int32 rank matrix (rbla_agg_group, paper
// Eq. 7: client n owns rank row rr iff rr < ranks[n, mask_off]).  m holds the
// masks of rank rows rr .. rr + M - 1 for client n.
struct FloatMasks {
  template <int M>
  __device__ __forceinline__ static void load(const Head& h, const SegIn& g, int n, int64_t rr,
                                              float (&m)[M]) {
    const float* __restrict__ p = h.masks + static_cast<int64_t>(n) * h.mask_cols + g.mask_off + rr;
#pragma unroll
    for (int k = 0; k < M; ++k) m[k] = p[k];
  }
};

struct RankMasks {
  template <int M>
  __device__ __forceinline__ static void load(const Head& h, const SegIn& g, int n, int64_t rr,
                                              float (&m)[M]) {
    const int64_t r = h.ranks[static_cast<int64_t>(n) * h.mask_cols + g.mask_off];
#pragma unroll
    for (int k = 0; k < M; ++k) m[k] = rr + k < r ? 1.0f : 0.0f;
  }
};

// The mean of K consecutive elements of segment s at (row, col).  The
// previous global is kept where the owners' weight mass is not positive
// (float masks: the plan's rule, as JAX's packed kernel), or where no client
// owns the rank row whatever its weight (rank masks: the per-pair rule,
// JAX's _retain_prev: r >= max(participant ranks)); a rank row some client owns
// at weight 0 alone is 0 there, as JAX's rbla_agg kernel gives it.
template <typename Tin, typename Mask, int K, bool COL>
__device__ __forceinline__ void mean_group(const View& t, const SegIn& g, int64_t row, int64_t col,
                                           bool by_weight) {
  constexpr bool kByRank = std::is_same<Mask, RankMasks>::value;
  constexpr int M = COL ? K : 1;
  const int64_t f = row * g.width + col;
  const int64_t rr = rank_row(g, row, col);
  float acc[K], den[M];
  bool own[M];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    den[k] = 0.0f;
    own[k] = false;
  }
  float wtot = 0.0f;
#pragma unroll 4
  for (int n = 0; n < t.h.n; ++n) {
    const Client c = client(t, g, n);
    const float w = t.h.weights[n];
    float m[M];
    Mask::template load<M>(t.h, g, n, rr, m);
    float xv[K];
    load_client<Tin, K>(c, f, xv);   // every client's value, owned or not: 0 * NaN is NaN
    wtot = __fadd_rn(wtot, w);
    if constexpr (COL) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float sc = c.scale != nullptr ? c.scale[rr + k] : 1.0f;
        den[k] = __fmaf_rn(w, m[k], den[k]);
        acc[k] = __fmaf_rn(__fmul_rn(w, m[k]), __fmul_rn(sc, xv[k]), acc[k]);
      }
    } else {
      const float sc = c.scale != nullptr ? c.scale[rr] : 1.0f;
      const float wm = __fmul_rn(w, m[0]);
      den[0] = __fmaf_rn(w, m[0], den[0]);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = __fmaf_rn(wm, __fmul_rn(sc, xv[k]), acc[k]);
    }
    if constexpr (kByRank) {
#pragma unroll
      for (int k = 0; k < M; ++k) own[k] |= m[k] > 0.0f;
    }
  }
  const int oc = out_code(g);
  bool keep[M], need_prev = false;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    keep[k] = kByRank ? !own[k] : !(den[k] > 0.0f);
    need_prev |= keep[k];
  }
  float pv[K];
  if (!by_weight && need_prev && g.prev != nullptr) {
    load_any<K>(g.prev, oc, f, pv);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) pv[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float d = den[COL ? k : 0];
    acc[k] = by_weight     ? __fdiv_rn(acc[k], wtot)
             : d > 0.0f    ? __fdiv_rn(acc[k], d)
             : keep[COL ? k : 0] ? pv[k]
                                 : 0.0f;
  }
  store_any<K>(g.out, oc, f, acc);
}

// One block's tile of segment s: rows row_tile * (threads / tpr) + tid / tpr,
// their vectors v = chunk * tpr + lane, stepping chunks * tpr.
template <typename Tin, typename Mask, int VEC, bool COL>
__device__ __forceinline__ void mean_tile(const View& t, const Seg& s, int64_t tile,
                                          bool by_weight) {
  const SegIn& g = s.in;
  const int tpr = s.tpr;
  const int64_t row = (tile / s.chunks) * (kStreamThreads / tpr) + threadIdx.x / tpr;
  if (row >= g.rows) return;
  const int lane = threadIdx.x & (tpr - 1);
  const int chunk = static_cast<int>(tile % s.chunks);
  const int64_t base = row * g.width;
  int64_t head = (VEC - base % VEC) % VEC;   // elements before the first aligned vector
  if (head > g.width) head = g.width;
  const int64_t n_vec = (g.width - head) / VEC;
  const int64_t tail = head + n_vec * VEC;
  const int64_t step = static_cast<int64_t>(s.chunks) * tpr;
  for (int64_t v = static_cast<int64_t>(chunk) * tpr + lane; v < n_vec; v += step)
    mean_group<Tin, Mask, VEC, COL>(t, g, row, head + v * VEC, by_weight);
  if (VEC > 1 && chunk == 0) {
    for (int64_t c = lane; c < head; c += tpr)
      mean_group<Tin, Mask, 1, COL>(t, g, row, c, by_weight);
    for (int64_t c = tail + lane; c < g.width; c += tpr)
      mean_group<Tin, Mask, 1, COL>(t, g, row, c, by_weight);
  }
}

template <typename Tin, typename Mask>
__global__ void __launch_bounds__(kStreamThreads) stream_kernel(const __grid_constant__ Table tab) {
  const View t(tab);
  const int64_t blk = blockIdx.x;
  const Seg& s = t.segs[find_seg(t.segs, t.h.n_segs, blk)];
  const int64_t tile = blk - s.first_tile;
  const bool by_weight = (t.h.mode & kByWeight) != 0;
  constexpr int V = vec_of<Tin>();
  const bool vec = (s.in.flags >> 8) & 1;
  if (s.in.col_group != 0) {
    if (vec) mean_tile<Tin, Mask, V, true>(t, s, tile, by_weight);
    else mean_tile<Tin, Mask, 1, true>(t, s, tile, by_weight);
  } else {
    if (vec) mean_tile<Tin, Mask, V, false>(t, s, tile, by_weight);
    else mean_tile<Tin, Mask, 1, false>(t, s, tile, by_weight);
  }
}

// Block-wide sum of one value per thread, in a fixed order; every thread
// gets the total.  s_red holds 33 floats.
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
  __syncthreads();   // s_red is reused by the next call
  return tot;
}

// One block per rank row: the masked mean with rbla_norm's norm restoration.
// Shared: each client's weight, mask, scale and masked row norm, 33 floats
// for the block sums, and each thread's partial squared norm per client.
template <typename Tin>
__global__ void __launch_bounds__(kNormThreads) norm_kernel(const __grid_constant__ Table tab) {
  const View t(tab);
  extern __shared__ float smem[];
  const int n = t.h.n, tid = threadIdx.x;
  float* s_w = smem;
  float* s_m = s_w + n;
  float* s_sc = s_m + n;
  float* s_rn = s_sc + n;
  float* s_red = s_rn + n;
  float* s_part = s_red + 33;                 // n * blockDim partials
  const int64_t blk = blockIdx.x;
  const Seg& s = t.segs[find_seg(t.segs, t.h.n_segs, blk)];
  const SegIn& g = s.in;
  const int64_t rr = blk - s.first_tile;
  const RankRow lay = rank_row_layout(g, rr);
  const bool by_weight = (t.h.mode & kByWeight) != 0;
  const int oc = out_code(g);
  for (int i = tid; i < n; i += blockDim.x) {
    const Client c = client(t, g, i);
    s_w[i] = t.h.weights[i];
    s_m[i] = t.h.masks[static_cast<int64_t>(i) * t.h.mask_cols + g.mask_off + rr];
    s_sc[i] = c.scale != nullptr ? c.scale[rr] : 1.0f;
  }
  for (int i = 0; i < n; ++i) s_part[i * blockDim.x + tid] = 0.0f;
  __syncthreads();
  float den = 0.0f, wtot = 0.0f;
  for (int i = 0; i < n; ++i) {
    den = __fmaf_rn(s_w[i], s_m[i], den);
    wtot = __fadd_rn(wtot, s_w[i]);
  }
  // the unscaled mean of element e (prev where no client owns the row);
  // with `norms`, each client's masked square joins the thread's partials
  auto mean = [&](int64_t e, bool norms) {
    const int64_t f = lay.first + e * lay.step;
    float acc = 0.0f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      float xv[1];
      load_client<Tin, 1>(client(t, g, i), f, xv);
      const float xn = __fmul_rn(s_sc[i], xv[0]);
      if (norms) {
        const float xm = __fmul_rn(s_m[i], xn);
        s_part[i * blockDim.x + tid] = __fmaf_rn(xm, xm, s_part[i * blockDim.x + tid]);
      }
      acc = __fmaf_rn(__fmul_rn(s_w[i], s_m[i]), xn, acc);
    }
    if (by_weight) return __fdiv_rn(acc, wtot);
    if (den > 0.0f) return __fdiv_rn(acc, den);
    return g.prev != nullptr ? load_one(g.prev, oc, f) : 0.0f;
  };
  // the unscaled mean of the 4 elements from e (a row-mode vector)
  auto mean4 = [&](int64_t e, bool norms, float (&acc)[4]) {
    const int64_t f = lay.first + e;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      float xv[4];
      load_client<Tin, 4>(client(t, g, i), f, xv);
      const float wm = __fmul_rn(s_w[i], s_m[i]);
      float sq = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xn = __fmul_rn(s_sc[i], xv[k]);
        const float xm = __fmul_rn(s_m[i], xn);
        sq = __fmaf_rn(xm, xm, sq);
        acc[k] = __fmaf_rn(wm, xn, acc[k]);
      }
      if (norms) s_part[i * blockDim.x + tid] += sq;
    }
    if (!by_weight && !(den > 0.0f) && g.prev != nullptr) {
      load_any<4>(g.prev, oc, f, acc);
      return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[k] = by_weight ? __fdiv_rn(acc[k], wtot) : den > 0.0f ? __fdiv_rn(acc[k], den) : 0.0f;
  };
  const bool vec = vec_rows(g);
  // pass 1: every client's masked row norm and the output row's norm
  float out_sq = 0.0f;
  if (vec) {
    for (int64_t e = 4 * static_cast<int64_t>(tid); e < lay.elems;
         e += 4 * static_cast<int64_t>(blockDim.x)) {
      float v[4];
      mean4(e, true, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) out_sq = __fmaf_rn(v[k], v[k], out_sq);
    }
  } else {
    for (int64_t e = tid; e < lay.elems; e += blockDim.x) {
      const float v = mean(e, true);
      out_sq = __fmaf_rn(v, v, out_sq);
    }
  }
  out_sq = block_sum(out_sq, s_red);          // also orders the partials
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  for (int i = warp; i < n; i += n_warps) {   // fixed order: lanes, then a tree
    float v = 0.0f;
    for (int j = lane; j < static_cast<int>(blockDim.x); j += 32) v += s_part[i * blockDim.x + j];
    v = warp_sum(v);
    if (lane == 0) s_rn[i] = sqrtf(v);
  }
  __syncthreads();
  float tnum = 0.0f, town = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float own = s_m[i] > 0.0f ? s_w[i] : 0.0f;
    tnum = __fmaf_rn(own, s_rn[i], tnum);
    town = __fadd_rn(town, own);
  }
  const float target = tnum / (town + 1e-12f);
  const float agg = sqrtf(out_sq);
  const float scale = agg > 1e-12f ? target / (agg + 1e-12f) : 1.0f;
  // pass 2: the rescaled row
  if (vec) {
    for (int64_t e = 4 * static_cast<int64_t>(tid); e < lay.elems;
         e += 4 * static_cast<int64_t>(blockDim.x)) {
      float v[4];
      mean4(e, false, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(v[k], scale);
      store_any<4>(g.out, oc, lay.first + e, v);
    }
    return;
  }
  for (int64_t e = tid; e < lay.elems; e += blockDim.x)
    store_one(g.out, oc, lay.first + e * lay.step, __fmul_rn(mean(e, false), scale));
}

struct Launch {
  GroupArgs a;
  Seg* host;              // layout only: fill this device-table image
  const void* dev;        // the device table, or null: inline
  int64_t* tiles;         // layout: out; device-table launch: in
  cudaStream_t stream;
};

int64_t fill(const GroupArgs& a, Seg* segs, int vec) {
  return (a.head.mode & kNormRestore) != 0 ? layout_rank_rows(a.segs, a.n_segs, segs)
                                           : layout_stream(a.segs, a.n_segs, segs, vec,
                                                           kStreamThreads);
}

template <typename Tin, typename Mask>
cudaError_t run(const Launch& l) {
  const GroupArgs& a = l.a;
  constexpr int V = vec_of<Tin>();
  if (l.host != nullptr) {   // layout only: the wrapper copies it to the card
    const int64_t total = fill(a, l.host, V);
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
    total = fill(a, t.seg, V);
    if (total < 0) return cudaErrorInvalidValue;
    if (a.n_ents > 0) memcpy(t.ent, a.ents, a.n_ents * sizeof(Entry));
    if (a.head.dtype == kMixed) memcpy(t.cdt, a.cdt, a.head.n);
  }
  if (total == 0) return cudaSuccess;
  if constexpr (std::is_same<Mask, FloatMasks>::value) {
    if ((a.head.mode & kNormRestore) != 0) {
      const size_t smem = ((4 + kNormThreads) * static_cast<size_t>(a.head.n) + 33) * sizeof(float);
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            norm_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return e;
      }
      norm_kernel<Tin><<<static_cast<unsigned>(total), kNormThreads, smem, l.stream>>>(t);
      return cudaGetLastError();
    }
  }
  stream_kernel<Tin, Mask><<<static_cast<unsigned>(total), kStreamThreads, 0, l.stream>>>(t);
  return cudaGetLastError();
}

// A launch with rank masks takes the mean modes only (no norm_restore).
template <typename Mask>
cudaError_t dispatch(const Launch& l) {
  if (l.a.n_segs < 1 || l.a.head.n < 1) return cudaErrorInvalidValue;
  if (std::is_same<Mask, RankMasks>::value && (l.a.head.mode & kNormRestore) != 0)
    return cudaErrorInvalidValue;
  switch (l.a.head.dtype) {
    case kF32: return run<float, Mask>(l);
    case kBF16: return run<__nv_bfloat16, Mask>(l);
    case kI8: return run<int8_t, Mask>(l);
    case kMixed: return run<MixedIn, Mask>(l);
    default: return cudaErrorInvalidValue;
  }
}

GroupArgs group_args(const void* segs, int n_segs, const void* ents, int n_ents,
                     const uint8_t* cdt, const float* masks, const int32_t* ranks,
                     int64_t mask_cols, const float* weights, int n, int dtype, int mode) {
  GroupArgs a{};
  a.segs = static_cast<const SegIn*>(segs);
  a.n_segs = n_segs;
  a.ents = static_cast<const Entry*>(ents);
  a.n_ents = n_ents;
  a.cdt = cdt;
  a.head.masks = masks;
  a.head.ranks = ranks;
  a.head.mask_cols = mask_cols;
  a.head.weights = weights;
  a.head.n = n;
  a.head.n_segs = n_segs;
  a.head.dtype = dtype;
  a.head.mode = mode;
  return a;
}

}  // namespace

extern "C" {

// packed_agg_group: n_segs segments (SegIn, twelve 8-byte words each) and
// n_ents per-client entries (Entry, two words) of one round, in one launch.
// masks (n, mask_cols) f32; weights (n,) f32; dtype the clients' dtype code
// (0 f32, 1 bf16, 2 int8) or 3 with cdt holding each client's; mode bit 0
// norm_by "weight", bit 1 norm_restore.  The table must fit inline
// (agg_group_fits_inline); otherwise packed_agg_layout writes its device image
// into host memory (agg_group_table_bytes) with the number of blocks, and
// packed_agg_group_table launches from the device copy.
int packed_agg_group(const void* segs, int n_segs, const void* ents, int n_ents,
                     const uint8_t* cdt, const float* masks, int64_t mask_cols,
                     const float* weights, int n, int dtype, int mode, void* stream) {
  const Launch l{group_args(segs, n_segs, ents, n_ents, cdt, masks, nullptr, mask_cols, weights,
                            n, dtype, mode),
                 nullptr, nullptr, nullptr, static_cast<cudaStream_t>(stream)};
  return dispatch<FloatMasks>(l);
}

int packed_agg_layout(const void* segs, int n_segs, const void* ents, int n_ents,
                      const uint8_t* cdt, int n, int dtype, int mode, void* table,
                      int64_t* tiles) {
  const Launch l{group_args(segs, n_segs, ents, n_ents, cdt, nullptr, nullptr, 0, nullptr, n,
                            dtype, mode),
                 static_cast<Seg*>(table), nullptr, tiles, nullptr};
  return dispatch<FloatMasks>(l);
}

int packed_agg_group_table(const void* dev_table, int n_segs, int n_ents, int64_t tiles,
                           const float* masks, int64_t mask_cols, const float* weights, int n,
                           int dtype, int mode, void* stream) {
  int64_t t = tiles;
  const Launch l{group_args(nullptr, n_segs, nullptr, n_ents, nullptr, masks, nullptr, mask_cols,
                            weights, n, dtype, mode),
                 nullptr, dev_table, &t, static_cast<cudaStream_t>(stream)};
  return dispatch<FloatMasks>(l);
}

// rbla_agg_group: the same segments and table, with the owner masks taken
// from ranks (n, rank_cols) int32: client c owns rank row rr of a segment iff
// rr < ranks[c, mask_off] (paper Eq. 7); rank rows no client owns keep the
// segment's prev (mode bit 0: norm_by "weight", which keeps none).
int rbla_agg_group(const void* segs, int n_segs, const void* ents, int n_ents, const uint8_t* cdt,
                   const int32_t* ranks, int64_t rank_cols, const float* weights, int n, int dtype,
                   int mode, void* stream) {
  const Launch l{group_args(segs, n_segs, ents, n_ents, cdt, nullptr, ranks, rank_cols, weights,
                            n, dtype, mode),
                 nullptr, nullptr, nullptr, static_cast<cudaStream_t>(stream)};
  return dispatch<RankMasks>(l);
}

int rbla_agg_layout(const void* segs, int n_segs, const void* ents, int n_ents,
                    const uint8_t* cdt, int n, int dtype, int mode, void* table, int64_t* tiles) {
  const Launch l{group_args(segs, n_segs, ents, n_ents, cdt, nullptr, nullptr, 0, nullptr, n,
                            dtype, mode),
                 static_cast<Seg*>(table), nullptr, tiles, nullptr};
  return dispatch<RankMasks>(l);
}

int rbla_agg_group_table(const void* dev_table, int n_segs, int n_ents, int64_t tiles,
                         const int32_t* ranks, int64_t rank_cols, const float* weights, int n,
                         int dtype, int mode, void* stream) {
  int64_t t = tiles;
  const Launch l{group_args(nullptr, n_segs, nullptr, n_ents, nullptr, nullptr, ranks, rank_cols,
                            weights, n, dtype, mode),
                 nullptr, dev_table, &t, static_cast<cudaStream_t>(stream)};
  return dispatch<RankMasks>(l);
}

}  // extern "C"
