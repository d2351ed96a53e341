// RBLA server-side aggregation kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/rbla_agg/kernel.py
// that the synchronous FL round runs:
//
//   * packed_agg_pallas (_packed_kernel): masked weighted mean over the client
//     axis of a packed (N, R, D) bucket with per-row owner masks (N, R); rows
//     no client owns keep `prev`; norm_by "weight" divides by the total mass;
//     optional per-row dequantisation scales (N, R) on load; optional
//     norm_restore (rbla_norm's per-row L2 rescale).
//   * rbla_agg_pallas (_kernel): the same mean with the owner mask derived
//     in-kernel from a rank vector, [r < ranks[n]] (paper Eq. 7).  The mask is
//     never materialised.
//
// What bounds them: both are bandwidth-bound.  Every x element is read once
// and feeds one FMA, so the least time is bytes / 3.35 TB/s (H100 SXM), with
// bytes = N*R*D*sizeof(x) + R*D*sizeof(out) (+ the prev rows a mask-normalised
// round falls back to).  The design therefore only tries to stream x once at
// full width: each thread owns VEC consecutive columns of one row (16-byte
// loads when the width and the pointers allow it, scalar loads otherwise), walks
// the short client loop with an fp32 accumulator, and the block's weights and
// mask column sit in shared memory.  norm_restore needs whole-row reductions,
// so it runs one block per row in two passes: pass 1 writes the unscaled row to
// fp32 scratch while it accumulates each client's squared row norm in shared
// memory, pass 2 rescales.  Ragged widths (10, 200, 784 in the paper MLP) need
// no padding: the column loop is bounded by D.
//
// Plain C interface (loaded with ctypes).  Every entry point launches on the
// given stream, never synchronises, allocates nothing, and returns the CUDA
// error code of the launch (0 on success).

#include "common.cuh"

namespace {

constexpr int kMeanThreads = 256;
constexpr int kNormThreads = 128;

// Shared prologue: per-client effective weight w_n * m_{n,r} and dequant scale
// for this block's row.  The mask comes either from the (N, R) owner-mask
// matrix or, when `ranks` is given, from [r < ranks[n]].
__device__ __forceinline__ void load_row_params(
    int64_t n_clients, int64_t n_rows, int64_t row, const float* __restrict__ masks,
    const int* __restrict__ ranks, const float* __restrict__ weights,
    const float* __restrict__ scales, float* s_w, float* s_m, float* s_sc) {
  for (int64_t n = threadIdx.x; n < n_clients; n += blockDim.x) {
    s_w[n] = weights[n];
    s_m[n] = ranks != nullptr ? (row < ranks[n] ? 1.0f : 0.0f) : masks[n * n_rows + row];
    s_sc[n] = scales != nullptr ? scales[n * n_rows + row] : 1.0f;
  }
  __syncthreads();
}

// One output element group from its accumulator, the denominators and prev.
template <typename Tout, int VEC>
__device__ __forceinline__ void finish(float (&acc)[VEC], float den, float wtot,
                                       bool by_weight, const Tout* __restrict__ prev_p) {
  if (by_weight) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = acc[k] / wtot;
  } else if (den > 0.0f) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = acc[k] / den;
  } else if (prev_p != nullptr) {
    load_vec<Tout, VEC>(prev_p, acc);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  }
}

// Grid: x = rows, y = column chunks.  Each thread owns VEC consecutive columns.
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kMeanThreads) mean_kernel(
    const Tin* __restrict__ x, const float* __restrict__ masks, const int* __restrict__ ranks,
    const float* __restrict__ weights, const Tout* __restrict__ prev,
    const float* __restrict__ scales, Tout* __restrict__ out, int64_t n_clients, int64_t n_rows,
    int64_t width, int by_weight) {
  extern __shared__ float smem[];
  float* s_w = smem;
  float* s_m = s_w + n_clients;
  float* s_sc = s_m + n_clients;
  const int64_t row = blockIdx.x;
  load_row_params(n_clients, n_rows, row, masks, ranks, weights, scales, s_w, s_m, s_sc);

  float den = 0.0f, wtot = 0.0f;
  for (int64_t n = 0; n < n_clients; ++n) {
    den += s_w[n] * s_m[n];
    wtot += s_w[n];
  }
  const int64_t step = static_cast<int64_t>(gridDim.y) * blockDim.x * VEC;
  for (int64_t c = (static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x) * VEC;
       c < width; c += step) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int64_t n = 0; n < n_clients; ++n) {
      const float wm = s_w[n] * s_m[n];
      const float sc = s_sc[n];
      float xv[VEC];
      load_vec<Tin, VEC>(x + (n * n_rows + row) * width + c, xv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += wm * (sc * xv[k]);
    }
    finish<Tout, VEC>(acc, den, wtot, by_weight != 0,
                      prev != nullptr ? prev + row * width + c : nullptr);
    store_vec<Tout, VEC>(out + row * width + c, acc);
  }
}

// One block per row.  Pass 1: the masked mean into fp32 scratch, plus each
// client's squared row norm (thread-private partials in shared memory) and the
// output's squared row norm.  Then the per-row rescale of _packed_kernel's
// norm_restore; pass 2 writes the rescaled row in the output type.
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kNormThreads) norm_kernel(
    const Tin* __restrict__ x, const float* __restrict__ masks, const float* __restrict__ weights,
    const Tout* __restrict__ prev, const float* __restrict__ scales, Tout* __restrict__ out,
    float* __restrict__ scratch, int64_t n_clients, int64_t n_rows, int64_t width,
    int by_weight) {
  extern __shared__ float smem[];
  float* s_w = smem;
  float* s_m = s_w + n_clients;
  float* s_sc = s_m + n_clients;
  float* s_rn = s_sc + n_clients;            // per-client row norm
  float* s_red = s_rn + n_clients;           // 32 warp partials + 1 result
  float* s_part = s_red + 33;                // n_clients * blockDim partials
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  load_row_params(n_clients, n_rows, row, masks, nullptr, weights, scales, s_w, s_m, s_sc);
  for (int64_t n = 0; n < n_clients; ++n) s_part[n * blockDim.x + tid] = 0.0f;

  float den = 0.0f, wtot = 0.0f;
  for (int64_t n = 0; n < n_clients; ++n) {
    den += s_w[n] * s_m[n];
    wtot += s_w[n];
  }
  float out_sq = 0.0f;
  for (int64_t c = static_cast<int64_t>(tid) * VEC; c < width;
       c += static_cast<int64_t>(blockDim.x) * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int64_t n = 0; n < n_clients; ++n) {
      const float m = s_m[n];
      const float wm = s_w[n] * m;
      const float sc = s_sc[n];
      float xv[VEC];
      load_vec<Tin, VEC>(x + (n * n_rows + row) * width + c, xv);
      float sq = 0.0f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xn = sc * xv[k];
        acc[k] += wm * xn;
        const float xm = m * xn;
        sq += xm * xm;
      }
      s_part[n * blockDim.x + tid] += sq;
    }
    finish<Tout, VEC>(acc, den, wtot, by_weight != 0,
                      prev != nullptr ? prev + row * width + c : nullptr);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out_sq += acc[k] * acc[k];
    store_vec<float, VEC>(scratch + row * width + c, acc);
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  for (int64_t n = warp; n < n_clients; n += n_warps) {
    float s = 0.0f;
    for (int t = lane; t < static_cast<int>(blockDim.x); t += 32) s += s_part[n * blockDim.x + t];
    s = warp_sum(s);
    if (lane == 0) s_rn[n] = sqrtf(s);
  }
  out_sq = warp_sum(out_sq);
  if (lane == 0) s_red[warp] = out_sq;
  __syncthreads();
  if (tid == 0) {
    float agg_sq = 0.0f;
    for (int i = 0; i < n_warps; ++i) agg_sq += s_red[i];
    float tnum = 0.0f, town = 0.0f;
    for (int64_t n = 0; n < n_clients; ++n) {
      const float own = s_m[n] > 0.0f ? s_w[n] : 0.0f;
      tnum += own * s_rn[n];
      town += own;
    }
    const float target = tnum / (town + 1e-12f);
    const float agg = sqrtf(agg_sq);
    s_red[32] = agg > 1e-12f ? target / (agg + 1e-12f) : 1.0f;
  }
  __syncthreads();
  const float scale = s_red[32];
  for (int64_t c = static_cast<int64_t>(tid) * VEC; c < width;
       c += static_cast<int64_t>(blockDim.x) * VEC) {
    float v[VEC];
    load_vec<float, VEC>(scratch + row * width + c, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] *= scale;
    store_vec<Tout, VEC>(out + row * width + c, v);
  }
}

size_t elem_size(int dtype) { return dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 1; }

struct Args {
  const void* x;
  const float* masks;
  const int* ranks;
  const float* weights;
  const void* prev;
  const float* scales;
  void* out;
  float* scratch;
  int64_t n, r, d;
  int by_weight, norm_restore;
  cudaStream_t stream;
};

template <typename Tin, typename Tout, int VEC>
cudaError_t launch(const Args& a) {
  const Tin* x = static_cast<const Tin*>(a.x);
  const Tout* prev = static_cast<const Tout*>(a.prev);
  Tout* out = static_cast<Tout*>(a.out);
  if (a.norm_restore) {
    const size_t smem = (4 * a.n + 33 + a.n * kNormThreads) * sizeof(float);
    auto kern = norm_kernel<Tin, Tout, VEC>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kern<<<dim3(static_cast<unsigned>(a.r)), kNormThreads, smem, a.stream>>>(
        x, a.masks, a.weights, prev, a.scales, out, a.scratch, a.n, a.r, a.d, a.by_weight);
    return cudaGetLastError();
  }
  // narrow rows get a narrow block: one warp per 32 column groups, <= 256 threads
  const int64_t groups = (a.d + VEC - 1) / VEC;
  const int threads = static_cast<int>(
      groups >= kMeanThreads ? kMeanThreads : ((groups + 31) / 32) * 32);
  int64_t chunks = (groups + threads - 1) / threads;
  if (chunks > 65535) chunks = 65535;
  const size_t smem = 3 * a.n * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  mean_kernel<Tin, Tout, VEC>
      <<<dim3(static_cast<unsigned>(a.r), static_cast<unsigned>(chunks)), threads, smem,
         a.stream>>>(x, a.masks, a.ranks, a.weights, prev, a.scales, out, a.n, a.r, a.d,
                     a.by_weight);
  return cudaGetLastError();
}

// 16-byte loads of x need the width to be a multiple of the vector and every
// pointer the kernel vectorises over to be aligned to its access size;
// otherwise the scalar instantiation runs (same arithmetic).
template <typename Tin, typename Tout>
cudaError_t dispatch_vec(const Args& a) {
  constexpr int V = 16 / sizeof(Tin);
  const bool vec_ok = a.d % V == 0 && aligned(a.x, 16) && aligned(a.out, V * sizeof(Tout)) &&
                      aligned(a.prev, V * sizeof(Tout)) && aligned(a.scratch, V * sizeof(float));
  return vec_ok ? launch<Tin, Tout, V>(a) : launch<Tin, Tout, 1>(a);
}

template <typename Tin>
cudaError_t dispatch_out(const Args& a, int out_dtype) {
  switch (out_dtype) {
    case kF32: return dispatch_vec<Tin, float>(a);
    case kBF16: return dispatch_vec<Tin, __nv_bfloat16>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Args& a, int x_dtype, int out_dtype) {
  if (a.r <= 0 || a.d <= 0) return cudaSuccess;
  if (a.r > 0x7fffffffLL) return cudaErrorInvalidValue;
  switch (x_dtype) {
    case kF32: return dispatch_out<float>(a, out_dtype);
    case kBF16: return dispatch_out<__nv_bfloat16>(a, out_dtype);
    case kI8: return dispatch_out<int8_t>(a, out_dtype);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// packed_agg: x (n, r, d) of x_dtype; masks (n, r) f32; weights (n,) f32;
// prev (r, d) of out_dtype or null; scales (n, r) f32 or null; out (r, d) of
// out_dtype.  norm_restore needs scratch: (r, d) f32, which may be `out` when
// out_dtype is f32.
int rbla_packed_agg(const void* x, int x_dtype, const float* masks, const float* weights,
                    const void* prev, const float* scales, void* out, int out_dtype,
                    float* scratch, int64_t n, int64_t r, int64_t d, int by_weight,
                    int norm_restore, void* stream) {
  if (norm_restore && scratch == nullptr) return cudaErrorInvalidValue;
  const Args a{x, masks, nullptr, weights, prev, scales, out, scratch, n, r, d,
               by_weight, norm_restore, static_cast<cudaStream_t>(stream)};
  return dispatch(a, x_dtype, out_dtype);
}

// rbla_agg: x (n, r, d) of dtype; ranks (n,) int32; weights (n,) f32; out
// (r, d) of dtype.
int rbla_rank_agg(const void* x, int dtype, const int* ranks, const float* weights, void* out,
                  int64_t n, int64_t r, int64_t d, int by_weight, void* stream) {
  const Args a{x, nullptr, ranks, weights, nullptr, nullptr, out, nullptr, n, r, d,
               by_weight, 0, static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype, dtype);
}

}  // extern "C"
