// The async server's per-update fold for Hopper (sm_90a), grouped:
//
//   out[e] = y[e] + alpha(e) * (x[e] - y[e])
//
// over every segment of one fold in ONE launch.  Replaces axpy_fold_pallas
// (_axpy_kernel) of src/repro/kernels/rbla_agg/kernel.py.  A segment is one
// leaf of the server state (a LoRA pair's A or B, a base trainable): y the
// live state, x the arriving update, out a new tensor of y's shape, all
// three contiguous.  Its rate alpha is one value for every element (the
// scalar server mix of fedavg/zeropad and the base trainables), one fp32
// rate per rank row (RBLA's running per-rank-row mean: rows the client does
// not own have rate 0), or the same per-rank-row rates read along the LAST
// axis ("column mode"): a LoRA B leaf (..., fan_out, r) keeps its rank axis
// last, and folds in place of a transposed copy.
//
// What bounds it: bandwidth, and at the async server's sizes the host.  Each
// element of y and x is read once and feeds three flops, so the least time
// is bytes / 3.35 TB/s (H100 SXM) with bytes = sum over segments of
// n * (sizeof(y) + sizeof(x) + sizeof(out)) + 4 per rate.  An MLP fold moves
// about 1.2 MB (0.4 us of HBM time) and used to cost six wrapper calls of
// host work each; one grouped launch per fold leaves one.  The table of
// segments travels in the kernel's parameter space (__grid_constant__, up
// to kInlineSegs segments) or, beyond that, as a device array the wrapper
// copied there asynchronously on the launch stream; nothing synchronises.
//
// Layout of the work: every segment is `rows` memory rows of `width`
// contiguous elements (column mode: the rows are the (lead, fan_out) index
// pairs and the width the rank axis).  A block of 256 threads covers
// 256 / tpr rows of one segment and one chunk of their columns, each row
// served by tpr threads (a power of two sized to the width, so the narrow
// rows of the paper MLP -- widths 10 and 1 -- do not idle a block); blocks
// map to (segment, tile) through the table's prefix of tile counts.  Each
// thread moves 16-byte vectors of its row.  Ragged widths need no padding:
// a row whose flat start is not vector-aligned gets a scalar head, then
// vectors, then a scalar tail; a segment whose base pointers are not
// 16-byte aligned takes the scalar path throughout.  The arithmetic is
// three separately rounded fp32 operations, exactly as the plain PyTorch
// version computes it, so the two agree bit for bit; there is no alpha == 0
// branch: 0 * (x - y) adds nothing to y, and a NaN in x reaches the output
// in kernel and plain version alike.  The result is written in the output
// type (y's, or fp32 when the caller rounds it to bf16 stochastically
// afterwards).  One launch takes one (y, x, out) type triple; the wrapper
// makes one launch per triple present in a fold.
//
// Plain C interface (loaded with ctypes): launches on the given stream, never
// synchronises, allocates nothing, returns the CUDA error code (0 on success).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInlineSegs = 32;   // a table this long rides in the parameter space

// rate modes of a segment
enum Mode : int32_t { kValue = 0, kFirst = 1, kRow = 2, kCol = 3 };

// One segment as the wrapper writes it: eight 8-byte words.
struct SegIn {
  const void* y;
  const void* x;
  void* out;
  const float* alpha;  // kFirst: alpha[0]; kRow: alpha[row]; kCol: see col_group
  int64_t rows;        // memory rows
  int64_t width;       // contiguous elements per memory row
  int64_t col_group;   // kCol: memory rows per lead index; the rate of (row,
                       // col) is alpha[(row / col_group) * width + col]
  float alpha_value;   // kValue: the rate of every element
  int32_t mode;
};
static_assert(sizeof(SegIn) == 64, "the wrapper writes eight 8-byte words");

// A segment with its launch geometry (filled here, on the host).
struct Seg {
  SegIn in;
  int64_t first_tile;  // blocks of the segments before it
  int32_t tpr;         // threads per row
  int32_t chunks;      // column chunks per row tile
  int32_t vec;         // 1: 16-byte accesses
  int32_t pad;
};

struct Table {
  int32_t n;
  int32_t pad;
  Seg seg[kInlineSegs];
};

template <typename Ty, typename Tx, typename To>
__device__ __forceinline__ To fold_one(const Ty* __restrict__ y, const Tx* __restrict__ x,
                                       float a, int64_t i) {
  const float yv = to_f32(y[i]);
  return from_f32<To>(__fadd_rn(yv, __fmul_rn(a, __fsub_rn(to_f32(x[i]), yv))));
}

// One block's tile of segment s: rows row_tile * (256 / tpr) + threadIdx.x /
// tpr, their vectors v = chunk * tpr + lane, stepping chunks * tpr.
template <typename Ty, typename Tx, typename To, int VEC>
__device__ __forceinline__ void fold_tile(const Seg& s, int64_t tile) {
  const SegIn& g = s.in;
  const int tpr = s.tpr;
  const int64_t row = (tile / s.chunks) * (kThreads / tpr) + threadIdx.x / tpr;
  if (row >= g.rows) return;
  const int lane = threadIdx.x & (tpr - 1);
  const int chunk = static_cast<int>(tile % s.chunks);
  const Ty* __restrict__ y = static_cast<const Ty*>(g.y);
  const Tx* __restrict__ x = static_cast<const Tx*>(g.x);
  To* __restrict__ out = static_cast<To*>(g.out);
  const int64_t width = g.width;
  const int64_t base = row * width;
  float a = g.alpha_value;
  const float* __restrict__ acol = nullptr;  // kCol: this row's run of rates
  if (g.mode == kFirst) a = g.alpha[0];
  else if (g.mode == kRow) a = g.alpha[row];
  else if (g.mode == kCol) acol = g.alpha + (row / g.col_group) * width;
  // elements before the row's first vector-aligned flat index
  int64_t head = (VEC - base % VEC) % VEC;
  if (head > width) head = width;
  const int64_t n_vec = (width - head) / VEC;
  const int64_t tail = head + n_vec * VEC;
  const int64_t step = static_cast<int64_t>(s.chunks) * tpr;
  for (int64_t v = static_cast<int64_t>(chunk) * tpr + lane; v < n_vec; v += step) {
    const int64_t col = head + v * VEC;
    float yv[VEC], xv[VEC], ov[VEC];
    load_vec<Ty, VEC>(y + base + col, yv);
    load_vec<Tx, VEC>(x + base + col, xv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float ak = acol != nullptr ? acol[col + k] : a;
      ov[k] = __fadd_rn(yv[k], __fmul_rn(ak, __fsub_rn(xv[k], yv[k])));
    }
    store_vec<To, VEC>(out + base + col, ov);
  }
  if (chunk == 0) {
    for (int64_t c = lane; c < head; c += tpr)
      out[base + c] = fold_one<Ty, Tx, To>(y, x, acol != nullptr ? acol[c] : a, base + c);
    for (int64_t c = tail + lane; c < width; c += tpr)
      out[base + c] = fold_one<Ty, Tx, To>(y, x, acol != nullptr ? acol[c] : a, base + c);
  }
}

// The segment that owns block `blk`: the last one whose first tile is at or
// below it (segments without tiles share their successor's first tile).
__device__ __forceinline__ int find_seg(const Seg* segs, int n, int64_t blk) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (segs[mid].first_tile <= blk) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

template <typename Ty, typename Tx, typename To, int VEC>
__device__ __forceinline__ void fold_block(const Seg* segs, int n) {
  const int64_t blk = blockIdx.x;
  const Seg& s = segs[find_seg(segs, n, blk)];
  if (s.vec) fold_tile<Ty, Tx, To, VEC>(s, blk - s.first_tile);
  else fold_tile<Ty, Tx, To, 1>(s, blk - s.first_tile);
}

template <typename Ty, typename Tx, typename To, int VEC>
__global__ void __launch_bounds__(kThreads) axpy_group_inline(const __grid_constant__ Table t) {
  fold_block<Ty, Tx, To, VEC>(t.seg, t.n);
}

template <typename Ty, typename Tx, typename To, int VEC>
__global__ void __launch_bounds__(kThreads) axpy_group_table(const Seg* __restrict__ segs,
                                                             int n) {
  fold_block<Ty, Tx, To, VEC>(segs, n);
}

template <typename Ty, typename Tx, typename To>
constexpr int vec_width() {
  constexpr size_t w = sizeof(Ty) > sizeof(Tx) ? (sizeof(Ty) > sizeof(To) ? sizeof(Ty) : sizeof(To))
                                               : (sizeof(Tx) > sizeof(To) ? sizeof(Tx) : sizeof(To));
  return static_cast<int>(16 / w);
}

// Fill each segment's geometry; returns the total number of blocks, or -1
// for a segment the kernel does not take.
template <typename Ty, typename Tx, typename To>
int64_t layout(const SegIn* in, int n, Seg* segs) {
  constexpr int V = vec_width<Ty, Tx, To>();
  int64_t total = 0;
  for (int i = 0; i < n; ++i) {
    const SegIn& g = in[i];
    if (g.rows < 0 || g.width < 0 || g.mode < kValue || g.mode > kCol) return -1;
    if (g.mode != kValue && g.alpha == nullptr) return -1;
    if (g.mode == kCol && (g.col_group <= 0 || g.rows % g.col_group != 0)) return -1;
    Seg& s = segs[i];
    s.in = g;
    s.first_tile = total;
    // 16-byte accesses of the widest operand: VEC elements of every operand
    // at once, each base pointer aligned to its own VEC-element access
    s.vec = aligned(g.y, V * sizeof(Ty)) && aligned(g.x, V * sizeof(Tx)) &&
            aligned(g.out, V * sizeof(To));
    s.pad = 0;
    const int64_t groups = (g.width + (s.vec ? V : 1) - 1) / (s.vec ? V : 1);
    int tpr = 1;
    while (tpr < kThreads && tpr < groups) tpr <<= 1;
    s.tpr = tpr;
    // each thread moves up to 4 vectors of a row per chunk
    int64_t chunks = (groups + 4LL * tpr - 1) / (4LL * tpr);
    if (chunks < 1) chunks = 1;
    if (chunks > 0x7fffffffLL) return -1;
    s.chunks = static_cast<int32_t>(chunks);
    const int64_t rows_per_block = kThreads / tpr;
    if (g.rows > 0 && g.width > 0) total += (g.rows + rows_per_block - 1) / rows_per_block * chunks;
    if (total > 0x7fffffffLL) return -1;
  }
  return total;
}

struct Launch {
  const SegIn* in;
  int n;
  Seg* table;        // host table to fill (the device-table path), or null
  const Seg* dev;    // the device table, or null: the inline path
  int64_t* tiles;    // out: the blocks the launch needs (device-table path)
  cudaStream_t stream;
};

template <typename Ty, typename Tx, typename To>
cudaError_t run(const Launch& a) {
  constexpr int V = vec_width<Ty, Tx, To>();
  if (a.table != nullptr) {  // layout only: the wrapper copies it to the card
    const int64_t total = layout<Ty, Tx, To>(a.in, a.n, a.table);
    if (total < 0) return cudaErrorInvalidValue;
    *a.tiles = total;
    return cudaSuccess;
  }
  if (a.dev != nullptr) {
    if (*a.tiles == 0) return cudaSuccess;
    axpy_group_table<Ty, Tx, To, V>
        <<<static_cast<unsigned>(*a.tiles), kThreads, 0, a.stream>>>(a.dev, a.n);
    return cudaGetLastError();
  }
  if (a.n > kInlineSegs) return cudaErrorInvalidValue;
  Table t;
  t.n = a.n;
  t.pad = 0;
  const int64_t total = layout<Ty, Tx, To>(a.in, a.n, t.seg);
  if (total < 0) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  axpy_group_inline<Ty, Tx, To, V><<<static_cast<unsigned>(total), kThreads, 0, a.stream>>>(t);
  return cudaGetLastError();
}

template <typename Ty, typename Tx>
cudaError_t dispatch_out(const Launch& a, int out_dtype) {
  switch (out_dtype) {
    case kF32: return run<Ty, Tx, float>(a);
    case kBF16: return run<Ty, Tx, __nv_bfloat16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Ty>
cudaError_t dispatch_x(const Launch& a, int x_dtype, int out_dtype) {
  switch (x_dtype) {
    case kF32: return dispatch_out<Ty, float>(a, out_dtype);
    case kBF16: return dispatch_out<Ty, __nv_bfloat16>(a, out_dtype);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Launch& a, int y_dtype, int x_dtype, int out_dtype) {
  if (a.n < 1) return cudaErrorInvalidValue;
  switch (y_dtype) {
    case kF32: return dispatch_x<float>(a, x_dtype, out_dtype);
    case kBF16: return dispatch_x<__nv_bfloat16>(a, x_dtype, out_dtype);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Segments one launch carries in its parameter space, and the bytes of one
// entry of a device table.
int axpy_fold_inline_segs() { return kInlineSegs; }
int axpy_fold_table_bytes() { return static_cast<int>(sizeof(Seg)); }

// axpy_fold_group: n <= axpy_fold_inline_segs() segments (SegIn, eight
// 8-byte words each) whose y, x and out share the types y_dtype, x_dtype
// and out_dtype (0 fp32, 1 bf16), folded in one launch.
int axpy_fold_group(const void* segs, int n, int y_dtype, int x_dtype, int out_dtype,
                    void* stream) {
  const Launch a{static_cast<const SegIn*>(segs), n, nullptr, nullptr, nullptr,
                 static_cast<cudaStream_t>(stream)};
  return dispatch(a, y_dtype, x_dtype, out_dtype);
}

// The device-table path, in two steps.  axpy_fold_layout writes n entries of
// axpy_fold_table_bytes() each into `table` (host memory) and the number of
// blocks into *tiles; the caller copies the table to the card on the launch
// stream and calls axpy_fold_group_table with the device copy.
int axpy_fold_layout(const void* segs, int n, int y_dtype, int x_dtype, int out_dtype,
                     void* table, int64_t* tiles) {
  const Launch a{static_cast<const SegIn*>(segs), n, static_cast<Seg*>(table), nullptr, tiles,
                 nullptr};
  return dispatch(a, y_dtype, x_dtype, out_dtype);
}

int axpy_fold_group_table(const void* dev_table, int n, int64_t tiles, int y_dtype,
                          int x_dtype, int out_dtype, void* stream) {
  int64_t t = tiles;
  const Launch a{nullptr, n, nullptr, static_cast<const Seg*>(dev_table), &t,
                 static_cast<cudaStream_t>(stream)};
  return dispatch(a, y_dtype, x_dtype, out_dtype);
}

}  // extern "C"
