// FLoRA stacking kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/rbla_agg/kernel.py:
//
//   * packed_stack_pallas (_packed_stack_kernel): the flora plan's fused
//     stacking over a packed (N, R_in, D) bucket -- a list of
//     (client, src_row, dst_row, rows, scale_idx) copies plus copies out of
//     the previous global, each row scaled by scales[scale_idx]; rows that no
//     copy touches are zero (flora_stack_rows below).
//   * flora_stack_pallas (_stack_kernel): the single-pair form -- contributor
//     i's first segs[i] rows, scaled by scales[i], at a running offset; the
//     per-pair path (aggregate_tree_pallas) calls it twice a pair on
//     contributor stacks gathered, cast, padded, transposed and concatenated
//     around it (flora_stack_group below).
//
// What bounds both: a pure placement, so bandwidth.  The least time is bytes
// / 3.35 TB/s (H100 SXM) with bytes = the copied source rows read once + the
// output written once; the only arithmetic is one fp32 multiply per element.
// Values are multiplied in fp32 and rounded to the output type (f32 or bf16)
// once, which is what an fp32 cast, an fp32 stack and a cast back give (bf16
// -> fp32 is exact).
//
// flora_stack_rows streams each output row once from a per-output-row table
// of int32 triples (source, source row, scale index), where the source is a
// client index, -1 for the previous global, or -2 for a zero row, built on
// the host in the copy order of the TPU kernel (x copies first, then prev
// copies), so where two copies overlap the later one wins.  One block row per
// output row, each thread VEC consecutive columns with 16-byte accesses when
// the width and the pointers allow it; a zero row is written in the same
// pass.
//
// flora_stack_group takes every pair side of a per-pair flora round in ONE
// launch, each read and written in its own layout: an output segment is one
// pair side at its final storage rank `cap` and dtype -- A (*lead, cap,
// fan_in) by rank row, B (*lead, fan_out, cap) by rank column -- and its
// sources are the stacked cohort leaf where it lies (base pointer, client
// stride, its dtype) and the previous global's leading rank rows.  A
// segment's contributors (prev first, then the live clients by index, each
// with its live rank) ride in the launch's table; a block puts their prefix
// offsets and scales in shared memory and finds the contributor of an output
// rank row by a binary search there, so no per-row table is built or
// uploaded for a new cohort.  Each layer of `lead` is stacked on its own with
// the same contributors.  Rank rows at or beyond the stacked total are
// written as zeros in the same pass.  Scales: 1 (A rows pass verbatim), given
// per contributor, or flora's B-column scales m_k / (sum m + eps) * r_total /
// r_k computed in the block from the device weights (a client's mass its
// weight, prev's prev_weight times the mean weight), summed in order, so the
// round needs no other kernel.  In row mode a row comes from one contributor
// and moves in 4-element vectors where the row width and pointers allow; in
// column mode an output row is contiguous along the rank axis and each
// contributor's run is a contiguous read of its B row: 4-element vectors
// where the run and the source allow, scalars at the run edges.
#include <string.h>

#include "common.cuh"

namespace {

enum Source : int { kPrev = -1, kZero = -2 };

constexpr int kThreads = 256;

// Grid: x = output rows, y = column chunks.  table[3*row + {0,1,2}] = source
// (client, kPrev or kZero), source row, scale index.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) stack_kernel(
    const T* __restrict__ x, const T* __restrict__ prev, const float* __restrict__ scales,
    const int* __restrict__ table, T* __restrict__ out, int64_t r_in, int64_t width) {
  const int64_t row = blockIdx.x;
  const int src = table[3 * row];
  const int64_t src_row = table[3 * row + 1];
  const T* from = nullptr;
  float sc = 0.0f;
  if (src != kZero) {
    from = (src == kPrev ? prev + src_row * width
                         : x + (static_cast<int64_t>(src) * r_in + src_row) * width);
    sc = scales[table[3 * row + 2]];
  }
  T* to = out + row * width;
  const int64_t step = static_cast<int64_t>(gridDim.y) * blockDim.x * VEC;
  for (int64_t c = (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
       c < width; c += step) {
    float v[VEC];
    if (from != nullptr) {
      load_vec<T, VEC>(from + c, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] *= sc;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = 0.0f;
    }
    store_vec<T, VEC>(to + c, v);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* prev, const float* scales, const int* table,
                   void* out, int64_t r_in, int64_t out_rows, int64_t width,
                   cudaStream_t stream) {
  // narrow rows get a narrow block: one warp per 32 column groups, <= 256 threads
  const int64_t groups = (width + VEC - 1) / VEC;
  const int threads =
      static_cast<int>(groups >= kThreads ? kThreads : ((groups + 31) / 32) * 32);
  int64_t chunks = (groups + threads - 1) / threads;
  if (chunks > 65535) chunks = 65535;
  stack_kernel<T, VEC><<<dim3(static_cast<unsigned>(out_rows), static_cast<unsigned>(chunks)),
                         threads, 0, stream>>>(static_cast<const T*>(x),
                                               static_cast<const T*>(prev), scales, table,
                                               static_cast<T*>(out), r_in, width);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_vec(const void* x, const void* prev, const float* scales, const int* table,
                         void* out, int64_t r_in, int64_t out_rows, int64_t width,
                         cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec_ok = width % V == 0 && aligned(x, 16) && aligned(prev, 16) && aligned(out, 16);
  return vec_ok ? launch<T, V>(x, prev, scales, table, out, r_in, out_rows, width, stream)
                : launch<T, 1>(x, prev, scales, table, out, r_in, out_rows, width, stream);
}

// ------------------------------------------------------- flora_stack_group --
constexpr int kGroupThreads = 256;
constexpr int kInlineStackSegs = 16;
constexpr int kInlineContribs = 256;
enum ScaleMode : int { kUnit = 0, kGiven = 1, kMass = 2 };

// One output pair side as the wrapper writes it: twelve 8-byte words.
struct StackSegIn {
  const void* x;          // the stacked cohort leaf: client 0's
  int64_t x_stride;       // elements from one client's leaf to the next
  const void* prev;       // the previous global's leaf, or null
  void* out;              // the output leaf
  const float* scales;    // kGiven: one scale per contributor
  int64_t layers;         // prod(lead)
  int64_t width;          // row mode: fan_in; column mode: fan_out
  int64_t r_in;           // the clients' storage rank
  int64_t r_prev;         // prev's storage rank
  int64_t cap;            // the output's storage rank
  int64_t contrib;        // first contributor in the table | count << 32
  int64_t flags;          // col | vec << 1 | x vec << 2 | prev vec << 3 | x dtype << 8
                          // | prev dtype << 12 | out dtype << 16 | scale mode << 20
};
static_assert(sizeof(StackSegIn) == 96, "the wrapper writes twelve 8-byte words");

struct StackSeg {
  StackSegIn in;
  int64_t first_tile;     // blocks of the segments before it
  int32_t tpr;            // threads per memory row
  int32_t chunks;         // column chunks per row tile
};

// A contributor: a client of the cohort (its index) or the previous global
// (-1), and its leading rank rows.
struct Contrib {
  int32_t src;
  int32_t rows;
};

struct StackHead {
  const float* weights;       // (n,) client weights (kMass)
  const StackSeg* segs;       // the device table, or null: the inline arrays
  const Contrib* contribs;
  int32_t n;                  // clients
  int32_t n_segs;
  int32_t max_contrib;        // the most contributors of one segment
  float prev_weight;          // kMass: prev's mass over the mean client weight
  float eps;                  // kMass: added to the summed mass
};

struct StackTable {
  StackHead h;
  StackSeg seg[kInlineStackSegs];
  Contrib c[kInlineContribs];
};
static_assert(sizeof(StackTable) < 4096, "the inline table stays in the classic parameter space");

__host__ __device__ __forceinline__ bool seg_col(const StackSegIn& g) { return g.flags & 1; }
__host__ __device__ __forceinline__ int64_t seg_rows(const StackSegIn& g) {
  return seg_col(g) ? g.layers * g.width : g.layers * g.cap;
}
__host__ __device__ __forceinline__ int64_t seg_len(const StackSegIn& g) {
  return seg_col(g) ? g.cap : g.width;
}
__host__ __device__ __forceinline__ int seg_contribs(const StackSegIn& g) {
  return static_cast<int>(g.contrib >> 32);
}

// The contributor of stacked rank row o < total: the last whose offset is at
// or below it (an empty contributor shares its successor's offset).
__device__ __forceinline__ int find_contrib(const int32_t* off, int nc, int64_t o) {
  int lo = 0, hi = nc - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= o) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Where contributor k's rank row j of memory row `row` lies: its pointer,
// dtype code and flat index (row mode: row = layer; column mode: row = the
// output's memory row, layer * fan_out + f).
struct SrcRow {
  const void* p;
  int code;
  int64_t f;
  bool vec;
};

__device__ __forceinline__ SrcRow source(const StackSegIn& g, int src, int64_t row, int64_t j) {
  const bool col = seg_col(g);
  if (src < 0) {
    const int64_t f = col ? row * g.r_prev + j : (row * g.r_prev + j) * g.width;
    return {g.prev, static_cast<int>((g.flags >> 12) & 0xf), f, ((g.flags >> 3) & 1) != 0};
  }
  const int64_t f = static_cast<int64_t>(src) * g.x_stride +
                    (col ? row * g.r_in + j : (row * g.r_in + j) * g.width);
  return {g.x, static_cast<int>((g.flags >> 8) & 0xf), f, ((g.flags >> 2) & 1) != 0};
}

// One memory row of segment g: this thread's vectors from `first`, stepping
// `step` (row mode: the row is one contributor's, or zero; column mode: each
// element its rank column's contributor, or zero).
__device__ __forceinline__ void stack_row(const StackSegIn& g, const int32_t* s_off,
                                          const int32_t* s_src, const float* s_sc, int nc,
                                          int64_t row, int64_t first, int64_t step) {
  const int64_t total = s_off[nc];
  const int oc = static_cast<int>((g.flags >> 16) & 0xf);
  const bool vec = ((g.flags >> 1) & 1) != 0;
  const int64_t len = seg_len(g);
  const int64_t obase = row * len;

  if (!seg_col(g)) {          // row mode: the row is one contributor's, or zero
    const int64_t layer = row / g.cap, o = row % g.cap;
    SrcRow src{nullptr, 0, 0, false};
    float sc = 0.0f;
    if (o < total) {
      const int k = find_contrib(s_off, nc, o);
      src = source(g, s_src[k], layer, o - s_off[k]);
      sc = s_sc[k];
    }
    if (vec) {
      for (int64_t v = first; v < len / 4; v += step) {
        float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (src.p != nullptr) {
          load_any<4>(src.p, src.code, src.f + 4 * v, t);
#pragma unroll
          for (int e = 0; e < 4; ++e) t[e] = __fmul_rn(sc, t[e]);
        }
        store_any<4>(g.out, oc, obase + 4 * v, t);
      }
    } else {
      for (int64_t c = first; c < len; c += step)
        store_one(g.out, oc, obase + c,
                  src.p != nullptr ? __fmul_rn(sc, load_one(src.p, src.code, src.f + c)) : 0.0f);
    }
    return;
  }
  // column mode: element o of the output row is contributor k's rank column
  // o - off[k] of the same memory row, or zero at and beyond the total
  auto value = [&](int64_t o) -> float {
    if (o >= total) return 0.0f;
    const int k = find_contrib(s_off, nc, o);
    const SrcRow src = source(g, s_src[k], row, o - s_off[k]);
    return __fmul_rn(s_sc[k], load_one(src.p, src.code, src.f));
  };
  if (vec) {
    for (int64_t v = first; v < len / 4; v += step) {
      const int64_t o = 4 * v;
      float t[4];
      const int k = o < total ? find_contrib(s_off, nc, o) : nc;
      if (k < nc && o + 3 < s_off[k + 1]) {     // the run of one contributor
        const SrcRow src = source(g, s_src[k], row, o - s_off[k]);
        if (src.vec && src.f % 4 == 0) {
          load_any<4>(src.p, src.code, src.f, t);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) t[e] = load_one(src.p, src.code, src.f + e);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) t[e] = __fmul_rn(s_sc[k], t[e]);
      } else {                                  // a run edge, or zeros
#pragma unroll
        for (int e = 0; e < 4; ++e) t[e] = value(o + e);
      }
      store_any<4>(g.out, oc, obase + o, t);
    }
  } else {
    for (int64_t o = first; o < len; o += step) store_one(g.out, oc, obase + o, value(o));
  }
}

__global__ void __launch_bounds__(kGroupThreads) stack_group_kernel(
    const __grid_constant__ StackTable tab) {
  extern __shared__ int32_t s_int[];
  const StackHead& h = tab.h;
  const StackSeg* segs = h.segs != nullptr ? h.segs : tab.seg;
  const Contrib* cons = h.segs != nullptr ? h.contribs : tab.c;
  const int64_t blk = blockIdx.x;
  int lo = 0, hi = h.n_segs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (segs[mid].first_tile <= blk) lo = mid;
    else hi = mid - 1;
  }
  const StackSeg& s = segs[lo];
  const StackSegIn& g = s.in;
  const int c0 = static_cast<int>(g.contrib & 0xffffffffLL), nc = seg_contribs(g);
  int32_t* s_off = s_int;                                   // nc + 1 offsets
  int32_t* s_src = s_off + nc + 1;                          // nc sources
  float* s_sc = reinterpret_cast<float*>(s_src + nc);       // nc scales
  __shared__ float s_den, s_mean;
  const int mode = static_cast<int>((g.flags >> 20) & 0xf);
  for (int k = threadIdx.x; k < nc; k += blockDim.x) {
    s_src[k] = cons[c0 + k].src;
    s_off[k + 1] = cons[c0 + k].rows;
  }
  __syncthreads();
  if (threadIdx.x == 0) {   // the sums in order, as the plain twin takes them
    int32_t off = 0;
    bool has_prev = false;
    float msum = 0.0f;
    s_off[0] = 0;
    for (int k = 0; k < nc; ++k) {
      off += s_off[k + 1];
      s_off[k + 1] = off;
      has_prev |= s_src[k] < 0;
    }
    if (mode == kMass) {
      float mean = 0.0f;
      if (has_prev) {
        float wsum = 0.0f;
        for (int i = 0; i < h.n; ++i) wsum = __fadd_rn(wsum, h.weights[i]);
        mean = __fdiv_rn(wsum, static_cast<float>(h.n));
      }
      for (int k = 0; k < nc; ++k)
        msum = __fadd_rn(msum, s_src[k] < 0 ? __fmul_rn(h.prev_weight, mean)
                                            : h.weights[s_src[k]]);
      s_mean = mean;
    }
    s_den = __fadd_rn(msum, h.eps);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nc; k += blockDim.x) {
    if (mode == kMass) {
      const float m = s_src[k] < 0 ? __fmul_rn(h.prev_weight, s_mean) : h.weights[s_src[k]];
      s_sc[k] = __fmul_rn(__fdiv_rn(m, s_den),
                          __fdiv_rn(static_cast<float>(s_off[nc]),
                                    static_cast<float>(s_off[k + 1] - s_off[k])));
    } else {
      s_sc[k] = mode == kGiven ? g.scales[k] : 1.0f;
    }
  }
  __syncthreads();
  const int64_t tile = blk - s.first_tile;
  const int tpr = s.tpr;
  const int64_t row = (tile / s.chunks) * (kGroupThreads / tpr) + threadIdx.x / tpr;
  if (row >= seg_rows(g)) return;
  stack_row(g, s_off, s_src, s_sc, nc, row,
            static_cast<int64_t>(tile % s.chunks) * tpr + (threadIdx.x & (tpr - 1)),
            static_cast<int64_t>(s.chunks) * tpr);
}

// Geometry of a grouped stack: each memory row served by tpr threads (a power
// of two sized to the row's vectors), kGroupThreads / tpr rows a block, each
// thread up to 4 vectors of its row per chunk.  Returns the number of blocks,
// or -1 for a table the kernel does not take.
int64_t stack_layout(const StackSegIn* in, int n_segs, int n_contrib, StackSeg* segs) {
  int64_t total = 0;
  for (int i = 0; i < n_segs; ++i) {
    const StackSegIn& g = in[i];
    if (g.layers < 0 || g.width < 0 || g.cap < 0 || g.cap > 0x7fffffffLL) return -1;
    const int64_t first = g.contrib & 0xffffffffLL;
    if (seg_contribs(g) < 0 || first + seg_contribs(g) > n_contrib) return -1;
    StackSeg& s = segs[i];
    s.in = g;
    s.first_tile = total;
    const int vec = (g.flags >> 1) & 1 ? 4 : 1;
    const int64_t groups = (seg_len(g) + vec - 1) / vec;
    int tpr = 1;
    while (tpr < kGroupThreads && tpr < groups) tpr <<= 1;
    s.tpr = tpr;
    int64_t chunks = (groups + 4LL * tpr - 1) / (4LL * tpr);
    if (chunks < 1) chunks = 1;
    if (chunks > 0x7fffffffLL) return -1;
    s.chunks = static_cast<int32_t>(chunks);
    const int64_t rows_per_block = kGroupThreads / tpr;
    if (seg_rows(g) > 0 && seg_len(g) > 0)
      total += (seg_rows(g) + rows_per_block - 1) / rows_per_block * chunks;
    if (total > 0x7fffffffLL) return -1;
  }
  return total;
}

int max_contrib(const StackSegIn* in, int n_segs) {
  int m = 0;
  for (int i = 0; i < n_segs; ++i) m = seg_contribs(in[i]) > m ? seg_contribs(in[i]) : m;
  return m;
}

// Launch over a filled table (inline, or pointing at its device copy).
cudaError_t launch_group(StackTable& t, int64_t tiles, cudaStream_t stream) {
  if (tiles == 0) return cudaSuccess;
  const size_t smem = (3 * static_cast<size_t>(t.h.max_contrib) + 1) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stack_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  stack_group_kernel<<<static_cast<unsigned>(tiles), kGroupThreads, smem, stream>>>(t);
  return cudaGetLastError();
}

StackHead stack_head(const float* weights, int n, int n_segs, int max_c, float prev_weight,
                     float eps) {
  StackHead h{};
  h.weights = weights;
  h.n = n;
  h.n_segs = n_segs;
  h.max_contrib = max_c;
  h.prev_weight = prev_weight;
  h.eps = eps;
  return h;
}

}  // namespace

extern "C" {

// stack_rows: x (n, r_in, width) of dtype; prev (r_prev, width) of dtype or
// null; scales (s,) f32; table (out_rows, 3) int32; out (out_rows, width) of
// dtype.  The wrapper has checked every table entry against n, r_in, r_prev
// and s.
int flora_stack_rows(const void* x, int dtype, const void* prev, const float* scales,
                     const int* table, void* out, int64_t r_in, int64_t out_rows, int64_t width,
                     void* stream) {
  if (out_rows <= 0 || width <= 0) return cudaSuccess;
  if (out_rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_vec<float>(x, prev, scales, table, out, r_in, out_rows, width, s);
    case kBF16:
      return dispatch_vec<__nv_bfloat16>(x, prev, scales, table, out, r_in, out_rows, width, s);
    default: return cudaErrorInvalidValue;
  }
}

// flora_stack_group: n_segs output segments (StackSegIn, twelve 8-byte
// words each) and n_contrib contributors (Contrib, two int32 each) of one
// round, in one launch.  weights (n,) f32 (read by segments whose scale mode
// is kMass), prev_weight and eps the mass knobs.  The table must fit inline
// (flora_stack_fits_inline); otherwise flora_stack_layout writes its device
// image into host memory (flora_stack_table_bytes) with the number of
// blocks, and flora_stack_group_table launches from the device copy.
int flora_stack_fits_inline(int n_segs, int n_contrib) {
  return n_segs <= kInlineStackSegs && n_contrib <= kInlineContribs ? 1 : 0;
}

int64_t flora_stack_table_bytes(int n_segs, int n_contrib) {
  return static_cast<int64_t>(n_segs * sizeof(StackSeg) + n_contrib * sizeof(Contrib));
}

int flora_stack_group(const void* segs, int n_segs, const void* contribs, int n_contrib,
                      const float* weights, int n, float prev_weight, float eps, void* stream) {
  if (n_segs < 1 || n_segs > kInlineStackSegs || n_contrib < 0 || n_contrib > kInlineContribs)
    return cudaErrorInvalidValue;
  const StackSegIn* in = static_cast<const StackSegIn*>(segs);
  StackTable t;
  t.h = stack_head(weights, n, n_segs, max_contrib(in, n_segs), prev_weight, eps);
  const int64_t tiles = stack_layout(in, n_segs, n_contrib, t.seg);
  if (tiles < 0) return cudaErrorInvalidValue;
  if (n_contrib > 0) memcpy(t.c, contribs, n_contrib * sizeof(Contrib));
  return launch_group(t, tiles, static_cast<cudaStream_t>(stream));
}

int flora_stack_layout(const void* segs, int n_segs, const void* contribs, int n_contrib,
                       void* table, int64_t* tiles) {
  if (n_segs < 1 || n_contrib < 0) return cudaErrorInvalidValue;
  StackSeg* out = static_cast<StackSeg*>(table);
  const int64_t total = stack_layout(static_cast<const StackSegIn*>(segs), n_segs, n_contrib, out);
  if (total < 0) return cudaErrorInvalidValue;
  if (n_contrib > 0) memcpy(out + n_segs, contribs, n_contrib * sizeof(Contrib));
  *tiles = total;
  return cudaSuccess;
}

int flora_stack_group_table(const void* dev_table, int n_segs, int n_contrib, int max_c,
                            int64_t tiles, const float* weights, int n, float prev_weight,
                            float eps, void* stream) {
  StackTable t;
  t.h = stack_head(weights, n, n_segs, max_c, prev_weight, eps);
  t.h.segs = static_cast<const StackSeg*>(dev_table);
  t.h.contribs = reinterpret_cast<const Contrib*>(static_cast<const StackSeg*>(dev_table) + n_segs);
  return launch_group(t, tiles, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
