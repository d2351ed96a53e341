// Byzantine-robust packed aggregation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel packed_robust_pallas (_packed_robust_kernel)
// of src/repro/kernels/rbla_agg/kernel.py: the robust sibling of packed_agg,
// one launch per packed (N, R, D) bucket with owner masks (N, R), in one of
// three modes.
//
//   * clipped: every owned client row, dequantised, is scaled by
//     min(1, clip_norm / max(||row||, 1e-12)) and enters the masked weighted
//     mean sum_n w_n m_nr x_nr / sum_n w_n m_nr.  A client whose w_n * m_nr is
//     0 adds nothing to the row, whatever its values.
//   * trimmed / median: unweighted order statistics over the c owners of each
//     row (m_nr > 0).  Unowned slots hold the sentinel 1e30, the client axis
//     is sorted, positions [k, c - k) are averaged with
//     k = min(floor(trim_frac * c) in fp32, (c - 1) / 2); the median averages
//     positions (c - 1) / 2 and c / 2.
//
// Rows no client owns keep prev (or 0 without prev).  Per-row dequantisation
// scales (N, R) apply on the load, before the clip or the sort.  The output is
// f32 or bf16 (prev is given in the output type).
//
// NaN: the sort orders the client axis by a total order in which NaN is
// larger than every number (as torch.sort does), and every slot c < N enters
// the final sum with its 0/1 (or 0.5) selection weight, so a NaN among a row's
// owned values makes that output NaN, as the plain version's masked sum does.
// fminf/fmaxf, which drop NaN, are not used: the clip factor is computed with
// comparisons that let a NaN norm through.
//
// What bounds it: bandwidth.  Each owned x element is read once and feeds one
// FMA (clipped) or one slot of a sort; the least time is bytes / 3.35 TB/s
// (H100 SXM), bytes = the owned rows of x + masks, weights, scales + the prev
// rows of unowned output rows + the output written once.  The sort network
// costs (log2 N)(log2 N + 1)/4 * N compare-exchanges per element, 672 at
// N = 64, far below the card's fp32 rate at the bytes it moves.  The design:
//
//   * clipped needs whole-row norms before the mean.  One block takes one row:
//     pass 1 reduces each owned client's squared row norm (block reduction,
//     16-byte loads where width and alignment allow) into a clip factor in
//     shared memory; pass 2 streams the row again for the clipped weighted
//     mean (the second read of a row mostly hits L2).
//   * trimmed / median: each thread takes one column of a row, loads the N
//     values into registers and sorts them with a bitonic network unrolled at
//     compile time for N <= 8, 16, 32, 64 (slots beyond N hold NaN, which
//     sorts last and is never selected).  Larger cohorts (N <= 2048) take a
//     selection by counting: each value's position in the sorted order is the
//     number of values below it (ties broken by client index), which needs no
//     per-thread array and reads the N values again from L1/L2.  The wrapper
//     refuses N > 2048 with an error; nothing falls back.
//
// Plain C interface (loaded with ctypes): launches on the given stream, never
// synchronises, allocates nothing, returns the CUDA error code (0 on success).

#include <math.h>

#include "common.cuh"

namespace {

enum Mode : int { kClipped = 0, kTrimmed = 1, kMedian = 2 };

constexpr int kClipThreads = 256;
constexpr int kSortThreads = 128;
constexpr float kSentinel = 1e30f;
constexpr int kMaxClients = 2048;

// ------------------------------------------------------------------ clipped --
// One block per row.  Shared: weights, masks, scales and clip factors of the
// row's N clients, plus 32 warp partials.
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kClipThreads) clip_kernel(
    const Tin* __restrict__ x, const float* __restrict__ masks, const float* __restrict__ weights,
    const Tout* __restrict__ prev, const float* __restrict__ scales, Tout* __restrict__ out,
    int64_t n_clients, int64_t n_rows, int64_t width, float clip_norm) {
  extern __shared__ float smem[];
  float* s_wm = smem;                       // w_n * m_nr
  float* s_sc = s_wm + n_clients;           // dequantisation scale
  float* s_clip = s_sc + n_clients;         // clip factor
  float* s_red = s_clip + n_clients;        // 32 warp partials
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int64_t n = tid; n < n_clients; n += blockDim.x) {
    s_wm[n] = weights[n] * masks[n * n_rows + row];
    s_sc[n] = scales != nullptr ? scales[n * n_rows + row] : 1.0f;
  }
  __syncthreads();

  // pass 1: the clip factor of every client that counts in this row
  for (int64_t n = 0; n < n_clients; ++n) {
    if (s_wm[n] == 0.0f) continue;                     // uniform across the block
    const Tin* xr = x + (n * n_rows + row) * width;
    const float sc = s_sc[n];
    float sq = 0.0f;
    for (int64_t c = static_cast<int64_t>(tid) * VEC; c < width;
         c += static_cast<int64_t>(blockDim.x) * VEC) {
      float xv[VEC];
      load_vec<Tin, VEC>(xr + c, xv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xn = sc * xv[k];
        sq += xn * xn;
      }
    }
    sq = warp_sum(sq);
    if (lane == 0) s_red[warp] = sq;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.0f;
      for (int i = 0; i < n_warps; ++i) tot += s_red[i];
      const float norm = sqrtf(tot);
      const float safe = norm < 1e-12f ? 1e-12f : norm;   // a NaN norm passes
      const float f = clip_norm / safe;
      s_clip[n] = f > 1.0f ? 1.0f : f;                     // a NaN factor passes
    }
    __syncthreads();
  }

  float den = 0.0f;
  for (int64_t n = 0; n < n_clients; ++n) den += s_wm[n];
  // pass 2: the clipped masked weighted mean
  for (int64_t c = static_cast<int64_t>(tid) * VEC; c < width;
       c += static_cast<int64_t>(blockDim.x) * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int64_t n = 0; n < n_clients; ++n) {
      const float wm = s_wm[n];
      if (wm == 0.0f) continue;
      const float f = s_clip[n], sc = s_sc[n];
      float xv[VEC];
      load_vec<Tin, VEC>(x + (n * n_rows + row) * width + c, xv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += wm * (f * (sc * xv[k]));
    }
    if (den > 0.0f) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = acc[k] / den;
    } else if (prev != nullptr) {
      load_vec<Tout, VEC>(prev + row * width + c, acc);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    }
    store_vec<Tout, VEC>(out + row * width + c, acc);
  }
}

// ------------------------------------------------------- order statistics --
// a > b in the total order with NaN above every number
__device__ __forceinline__ bool greater(float a, float b) {
  return a > b || (isnan(a) && !isnan(b));
}

__device__ __forceinline__ void order(float& a, float& b) {
  if (greater(a, b)) {
    const float t = a;
    a = b;
    b = t;
  }
}

// Positions [k, c - k) (trimmed) or (c-1)/2 and c/2 (median) of the sorted
// owners; the selection weight of sorted position j.
__device__ __forceinline__ float select_weight(int j, int mode, int lo, int hi) {
  if (mode == kMedian) return 0.5f * (static_cast<float>(j == lo) + static_cast<float>(j == hi));
  return static_cast<float>(j >= lo && j < hi);
}

// (lo, hi) of select_weight and the divisor for a row with c owners
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

// Row parameters in shared memory: owned flag and scale of each client; c.
__device__ __forceinline__ int load_owner_params(int64_t n_clients, int64_t n_rows, int64_t row,
                                                 const float* __restrict__ masks,
                                                 const float* __restrict__ scales, float* s_own,
                                                 float* s_sc) {
  for (int64_t n = threadIdx.x; n < n_clients; n += blockDim.x) {
    s_own[n] = masks[n * n_rows + row] > 0.0f ? 1.0f : 0.0f;
    s_sc[n] = scales != nullptr ? scales[n * n_rows + row] : 1.0f;
  }
  __syncthreads();
  int c = 0;
  for (int64_t n = 0; n < n_clients; ++n) c += s_own[n] != 0.0f;
  return c;
}

template <typename Tout>
__device__ __forceinline__ void store_one(Tout* __restrict__ out, const Tout* __restrict__ prev,
                                          int64_t at, int c, float v) {
  if (c == 0) v = prev != nullptr ? to_f32(prev[at]) : 0.0f;
  out[at] = from_f32<Tout>(v);
}

// N <= MAXN: the values in registers, a bitonic network unrolled at compile
// time.  Grid: x = rows, y = column chunks; one thread per column.
template <typename Tin, typename Tout, int MAXN>
__global__ void __launch_bounds__(kSortThreads) sort_kernel(
    const Tin* __restrict__ x, const float* __restrict__ masks, const Tout* __restrict__ prev,
    const float* __restrict__ scales, Tout* __restrict__ out, int64_t n_clients, int64_t n_rows,
    int64_t width, int mode, float trim_frac) {
  extern __shared__ float smem[];
  float* s_own = smem;
  float* s_sc = s_own + n_clients;
  const int64_t row = blockIdx.x;
  const int c = load_owner_params(n_clients, n_rows, row, masks, scales, s_own, s_sc);
  int lo, hi;
  float div;
  selection(c, mode, trim_frac, lo, hi, div);
  const int n = static_cast<int>(n_clients);
  const int64_t step = static_cast<int64_t>(gridDim.y) * blockDim.x;
  for (int64_t col = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x; col < width;
       col += step) {
    float v[MAXN];
#pragma unroll
    for (int j = 0; j < MAXN; ++j) {
      if (j < n) {
        v[j] = s_own[j] != 0.0f
                   ? s_sc[j] * to_f32(x[(static_cast<int64_t>(j) * n_rows + row) * width + col])
                   : kSentinel;
      } else {
        v[j] = __int_as_float(0x7fc00000);   // NaN: sorts after every slot < N
      }
    }
#pragma unroll
    for (int size = 2; size <= MAXN; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
        for (int i = 0; i < MAXN; ++i) {
          const int j = i ^ stride;
          if (j > i) {
            if ((i & size) == 0) {
              order(v[i], v[j]);
            } else {
              order(v[j], v[i]);
            }
          }
        }
      }
    }
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXN; ++j) {
      if (j < n) acc += select_weight(j, mode, lo, hi) * v[j];
    }
    store_one<Tout>(out, prev, row * width + col, c, acc / div);
  }
}

// N > 64: selection by counting.  The sorted position of client i's value is
// the number of values below it plus the equal ones of lower index.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kSortThreads) count_kernel(
    const Tin* __restrict__ x, const float* __restrict__ masks, const Tout* __restrict__ prev,
    const float* __restrict__ scales, Tout* __restrict__ out, int64_t n_clients, int64_t n_rows,
    int64_t width, int mode, float trim_frac) {
  extern __shared__ float smem[];
  float* s_own = smem;
  float* s_sc = s_own + n_clients;
  const int64_t row = blockIdx.x;
  const int c = load_owner_params(n_clients, n_rows, row, masks, scales, s_own, s_sc);
  int lo, hi;
  float div;
  selection(c, mode, trim_frac, lo, hi, div);
  const int64_t step = static_cast<int64_t>(gridDim.y) * blockDim.x;
  for (int64_t col = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x; col < width;
       col += step) {
    auto value = [&](int64_t j) {
      return s_own[j] != 0.0f ? s_sc[j] * to_f32(x[(j * n_rows + row) * width + col])
                              : kSentinel;
    };
    float acc = 0.0f;
    for (int64_t i = 0; i < n_clients; ++i) {
      const float vi = value(i);
      int pos = 0;
      for (int64_t j = 0; j < n_clients; ++j) {
        const float vj = value(j);
        pos += greater(vi, vj) || (j < i && !greater(vj, vi));
      }
      acc += select_weight(pos, mode, lo, hi) * vi;
    }
    store_one<Tout>(out, prev, row * width + col, c, acc / div);
  }
}

// ----------------------------------------------------------------- launch --
struct Args {
  const void* x;
  const float* masks;
  const float* weights;
  const void* prev;
  const float* scales;
  void* out;
  int64_t n, r, d;
  int mode;
  float clip_norm, trim_frac;
  cudaStream_t stream;
};

template <typename Tin, typename Tout, int VEC>
cudaError_t launch_clip(const Args& a) {
  const size_t smem = (3 * a.n + 32) * sizeof(float);
  clip_kernel<Tin, Tout, VEC><<<dim3(static_cast<unsigned>(a.r)), kClipThreads, smem, a.stream>>>(
      static_cast<const Tin*>(a.x), a.masks, a.weights, static_cast<const Tout*>(a.prev),
      a.scales, static_cast<Tout*>(a.out), a.n, a.r, a.d, a.clip_norm);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, int MAXN>
cudaError_t launch_sort(const Args& a) {
  const int threads =
      static_cast<int>(a.d >= kSortThreads ? kSortThreads : ((a.d + 31) / 32) * 32);
  int64_t chunks = (a.d + threads - 1) / threads;
  if (chunks > 65535) chunks = 65535;
  const size_t smem = 2 * a.n * sizeof(float);
  const dim3 grid(static_cast<unsigned>(a.r), static_cast<unsigned>(chunks));
  const Tin* x = static_cast<const Tin*>(a.x);
  const Tout* prev = static_cast<const Tout*>(a.prev);
  Tout* out = static_cast<Tout*>(a.out);
  if constexpr (MAXN > 0) {
    sort_kernel<Tin, Tout, MAXN><<<grid, threads, smem, a.stream>>>(
        x, a.masks, prev, a.scales, out, a.n, a.r, a.d, a.mode, a.trim_frac);
  } else {
    count_kernel<Tin, Tout><<<grid, threads, smem, a.stream>>>(
        x, a.masks, prev, a.scales, out, a.n, a.r, a.d, a.mode, a.trim_frac);
  }
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t dispatch_mode(const Args& a) {
  if (a.mode == kClipped) {
    constexpr int V = 16 / sizeof(Tin);
    const bool vec_ok = a.d % V == 0 && aligned(a.x, 16) && aligned(a.out, V * sizeof(Tout)) &&
                        aligned(a.prev, V * sizeof(Tout));
    return vec_ok ? launch_clip<Tin, Tout, V>(a) : launch_clip<Tin, Tout, 1>(a);
  }
  if (a.mode != kTrimmed && a.mode != kMedian) return cudaErrorInvalidValue;
  if (a.n <= 8) return launch_sort<Tin, Tout, 8>(a);
  if (a.n <= 16) return launch_sort<Tin, Tout, 16>(a);
  if (a.n <= 32) return launch_sort<Tin, Tout, 32>(a);
  if (a.n <= 64) return launch_sort<Tin, Tout, 64>(a);
  return launch_sort<Tin, Tout, 0>(a);
}

template <typename Tin>
cudaError_t dispatch_out(const Args& a, int out_dtype) {
  switch (out_dtype) {
    case kF32: return dispatch_mode<Tin, float>(a);
    case kBF16: return dispatch_mode<Tin, __nv_bfloat16>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// packed_robust: x (n, r, d) of x_dtype; masks (n, r) f32; weights (n,) f32;
// prev (r, d) of out_dtype or null; scales (n, r) f32 or null; out (r, d) of
// out_dtype.  mode: 0 clipped, 1 trimmed, 2 median.  1 <= n <= 2048.
int robust_packed_agg(const void* x, int x_dtype, const float* masks, const float* weights,
                      const void* prev, const float* scales, void* out, int out_dtype, int64_t n,
                      int64_t r, int64_t d, int mode, float clip_norm, float trim_frac,
                      void* stream) {
  if (r <= 0 || d <= 0) return cudaSuccess;
  if (n < 1 || n > kMaxClients || r > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Args a{x, masks, weights, prev, scales, out, n, r, d, mode, clip_norm, trim_frac,
               static_cast<cudaStream_t>(stream)};
  switch (x_dtype) {
    case kF32: return dispatch_out<float>(a, out_dtype);
    case kBF16: return dispatch_out<__nv_bfloat16>(a, out_dtype);
    case kI8: return dispatch_out<int8_t>(a, out_dtype);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
