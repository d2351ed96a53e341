// The segment table of the grouped aggregation kernels (csrc/rbla_agg.cu's
// packed_agg, csrc/packed_robust.cu's packed_robust): one launch takes every
// pair side of a cohort in the leaf's own layout.
//
// A segment is one leaf of the cohort, `rows` memory rows of `width`
// contiguous elements.  Row mode (a LoRA A leaf (*lead, r, fan_in)): a memory
// row is a rank row.  Column mode (a B leaf (*lead, fan_out, r)): the rank
// axis is the contiguous one, and element (row, col) belongs to rank row
// (row / col_group) * width + col, with col_group = fan_out.  Rank row rr of
// a segment is column mask_off + rr of the launch's owner-mask matrix
// (n, mask_cols) and row rr of each client's dequantisation scales.  A launch
// may take its owner masks from an int32 rank matrix (n, mask_cols) instead
// (rbla_agg.cu's rbla_agg_group, paper Eq. 7): client c owns rank row rr of a
// segment iff rr < ranks[c, mask_off], so a pair's ranks are one column.
//
// Each client's data is found either by a base pointer and a client stride (a
// stacked cohort, or a packed (N, R, D) buffer), or through the segment's run
// of n per-client entries (an encoded cohort: each upload in its own tensor
// and wire dtype, int8 with its scale leaf).  One launch reads one client
// dtype (the launch's `dtype`), or each client's own (kMixed: the launch's
// per-client codes).  The previous global and the output lie in the leaf's
// layout in the segment's output dtype.
//
// The table rides in the kernel's parameter space (under 4 KB, the classic
// limit, so a launch uploads little) up to kInlineSegs segments, kInlineEntries
// entries and kInlineClients per-client codes; a larger table is copied to the
// card by the wrapper (one async copy from pinned memory on the launch stream)
// and the launch points at it.  Blocks map to (segment, tile) through the
// table's prefix of tile counts.

#pragma once

#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kInlineSegs = 16;
constexpr int kInlineEntries = 96;
constexpr int kInlineClients = 256;
constexpr int kMixed = 3;             // dtype code: each client's own

// One segment as the wrapper writes it: twelve 8-byte words.
struct SegIn {
  const void* x;          // stacked: client 0's leaf
  int64_t x_stride;       // stacked: elements from one client's leaf to the next
  const float* scale;     // stacked: per-(client, rank row) scales, or null
  int64_t scale_stride;   // stacked: scale elements from one client to the next
  const void* prev;       // the previous global (leaf layout, out dtype), or null
  void* out;              // the result (leaf layout, out dtype)
  int64_t rows;           // memory rows
  int64_t width;          // contiguous elements per memory row
  int64_t col_group;      // 0: row mode; else column mode, fan_out
  int64_t mask_off;       // the segment's first column of the owner masks
  int64_t entry;          // -1: stacked; else its first per-client entry
  int64_t flags;          // out dtype | vec << 8 (vec: 16-byte accesses allowed)
};
static_assert(sizeof(SegIn) == 96, "the wrapper writes twelve 8-byte words");

// A segment with its launch geometry (filled on the host).
struct Seg {
  SegIn in;
  int64_t first_tile;     // blocks of the segments before it
  int32_t tpr;            // threads per memory row (stream kernels)
  int32_t chunks;         // column chunks per row tile (stream kernels)
};

// One client's data in one segment (an encoded cohort).
struct Entry {
  const void* x;
  const float* scale;     // int8: (rank rows,) scales; else null
};

struct Head {
  const float* masks;     // (n, mask_cols) owner masks, or null: ranks
  const int32_t* ranks;   // (n, mask_cols) ranks, or null: masks
  int64_t mask_cols;
  const float* weights;   // (n,)
  const Seg* segs;        // the device table, or null: the inline arrays
  const Entry* ents;
  const uint8_t* cdt;
  int32_t n;              // clients
  int32_t n_segs;
  int32_t dtype;          // the clients' dtype code, or kMixed
  int32_t mode;           // the kernel's mode word
  float clip_norm;
  float trim_frac;
};

struct Table {
  Head h;
  Seg seg[kInlineSegs];
  Entry ent[kInlineEntries];
  uint8_t cdt[kInlineClients];
};
static_assert(sizeof(Table) < 4096, "the inline table stays in the classic parameter space");

// The table a block reads: the device copy where there is one.
struct View {
  const Head& h;
  const Seg* segs;
  const Entry* ents;
  const uint8_t* cdt;
  __device__ __forceinline__ explicit View(const Table& t)
      : h(t.h), segs(t.h.segs != nullptr ? t.h.segs : t.seg),
        ents(t.h.segs != nullptr ? t.h.ents : t.ent),
        cdt(t.h.segs != nullptr ? t.h.cdt : t.cdt) {}
};

__device__ __forceinline__ int out_code(const SegIn& g) { return static_cast<int>(g.flags & 0xff); }

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

// Client `n`'s data and scales in segment `g`, and its dtype code.
struct Client {
  const char* x;
  const float* scale;
  int code;
};

__device__ __forceinline__ Client client(const View& t, const SegIn& g, int n) {
  const int code = t.h.dtype == kMixed ? static_cast<int>(t.cdt[n]) : t.h.dtype;
  if (g.entry < 0) {
    return {static_cast<const char*>(g.x) + static_cast<int64_t>(n) * g.x_stride * esize(code),
            g.scale != nullptr ? g.scale + static_cast<int64_t>(n) * g.scale_stride : nullptr,
            code};
  }
  const Entry& e = t.ents[g.entry + n];
  return {static_cast<const char*>(e.x), e.scale, code};
}

// The rank row of element (row, col) and of its K - 1 neighbours along the
// row: rr + k in column mode, rr for all in row mode.
__device__ __forceinline__ int64_t rank_row(const SegIn& g, int64_t row, int64_t col) {
  return g.col_group != 0 ? (row / g.col_group) * g.width + col : row;
}

// Rank rows of a segment, and the memory layout of rank row rr: its e-th
// element lies at flat index first + e * step, e < elems.
__host__ __device__ __forceinline__ int64_t rank_rows(const SegIn& g) {
  return g.col_group != 0 ? (g.rows / g.col_group) * g.width : g.rows;
}

struct RankRow {
  int64_t first, step, elems;
};

// Whether a rank-row block may move its row in 4-element vectors: a row-mode
// segment whose pointers allow 16-byte accesses and whose rows start on a
// vector (width a multiple of 4).
__device__ __forceinline__ bool vec_rows(const SegIn& g) {
  return g.col_group == 0 && ((g.flags >> 8) & 1) && g.width % 4 == 0;
}

__device__ __forceinline__ RankRow rank_row_layout(const SegIn& g, int64_t rr) {
  if (g.col_group == 0) return {rr * g.width, 1, g.width};
  const int64_t lead = rr / g.width, j = rr % g.width;
  return {lead * g.col_group * g.width + j, g.width, g.col_group};
}

// ---------------------------------------------------------------- host side --
// Geometry of a stream launch: each memory row served by tpr threads (a power
// of two sized to the row's vectors, so narrow rows do not idle a block),
// threads / tpr rows a block, each thread up to 4 vectors of its row per
// chunk.  Returns the number of blocks, or -1 for a segment the kernels do
// not take.
inline int64_t layout_stream(const SegIn* in, int n, Seg* segs, int vec_elems, int threads) {
  int64_t total = 0;
  for (int i = 0; i < n; ++i) {
    const SegIn& g = in[i];
    if (g.rows < 0 || g.width < 0 || g.col_group < 0) return -1;
    if (g.col_group != 0 && g.rows % g.col_group != 0) return -1;
    Seg& s = segs[i];
    s.in = g;
    s.first_tile = total;
    const int vec = (g.flags >> 8) & 1 ? vec_elems : 1;
    const int64_t groups = (g.width + vec - 1) / vec;
    int tpr = 1;
    while (tpr < threads && tpr < groups) tpr <<= 1;
    s.tpr = tpr;
    int64_t chunks = (groups + 4LL * tpr - 1) / (4LL * tpr);
    if (chunks < 1) chunks = 1;
    if (chunks > 0x7fffffffLL) return -1;
    s.chunks = static_cast<int32_t>(chunks);
    const int64_t rows_per_block = threads / tpr;
    if (g.rows > 0 && g.width > 0) total += (g.rows + rows_per_block - 1) / rows_per_block * chunks;
    if (total > 0x7fffffffLL) return -1;
  }
  return total;
}

// Geometry of a rank-row launch: one block per rank row.
inline int64_t layout_rank_rows(const SegIn* in, int n, Seg* segs) {
  int64_t total = 0;
  for (int i = 0; i < n; ++i) {
    const SegIn& g = in[i];
    if (g.rows < 0 || g.width < 0 || g.col_group < 0) return -1;
    if (g.col_group != 0 && g.rows % g.col_group != 0) return -1;
    Seg& s = segs[i];
    s.in = g;
    s.first_tile = total;
    s.tpr = 0;
    s.chunks = 0;
    if (g.rows > 0 && g.width > 0) total += rank_rows(g);
    if (total > 0x7fffffffLL) return -1;
  }
  return total;
}

// A launch as the wrapper describes it.
struct GroupArgs {
  const SegIn* segs;
  int n_segs;
  const Entry* ents;
  int n_ents;
  const uint8_t* cdt;     // kMixed: n per-client codes
  Head head;              // masks, weights, n, dtype, mode, knobs
};

// Whether the table fits the inline arrays.
inline bool fits_inline(const GroupArgs& a) {
  return a.n_segs <= kInlineSegs && a.n_ents <= kInlineEntries &&
         (a.head.dtype != kMixed || a.head.n <= kInlineClients);
}

// Bytes of a device table: the segments, the entries, the per-client codes.
inline size_t table_bytes(int n_segs, int n_ents, int n_codes) {
  return n_segs * sizeof(Seg) + n_ents * sizeof(Entry) + static_cast<size_t>(n_codes);
}

}  // namespace

// Every grouped library answers these: whether a table fits the parameter
// space, and the bytes of a device table (segments, entries, per-client codes).
extern "C" int agg_group_fits_inline(int n_segs, int n_ents, int n, int dtype) {
  GroupArgs a{};
  a.n_segs = n_segs;
  a.n_ents = n_ents;
  a.head.n = n;
  a.head.dtype = dtype;
  return fits_inline(a) ? 1 : 0;
}

extern "C" int64_t agg_group_table_bytes(int n_segs, int n_ents, int n_codes) {
  return static_cast<int64_t>(table_bytes(n_segs, n_ents, n_codes));
}
