// Fused LoRA matmuls for Hopper (sm_90a): the FLaaS serving read path.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/lora_matmul/kernel.py:
//
//   * batched_lora_matmul_pallas (_batched_kernel): many adapters of
//     heterogeneous rank packed as rank-row segments of two row-major buffers,
//     a_rows (R, K) and b_rows (R, N) (B transposed, so row p of both is one
//     rank-one component); request row i selects its own segment by data:
//
//       y_i = x_i @ W + scale_i * sum_{p in [off_i, off_i + cnt_i)} (x_i . a_rows[p]) b_rows[p]
//
//   * lora_matmul_pallas (_kernel): one adapter, y = x @ W + s * (x @ A^T) @ B^T
//     with A (r, K) and B (N, r): every row's segment is [0, r), one scale.
//
// Both entry points run the same two passes on the given stream:
//
//   1. down: one block per request row i computes its segment's dot products
//      u[i][q] = scale_i * (x_i . a[lo_i + q]) for q < hi_i - lo_i into an fp32
//      scratch (M, u_stride), one warp per segment row, lanes striding K.  It
//      reads only the rows inside the segment: rows outside every live segment
//      may hold garbage (NaN, Inf) and never reach the output, and a request
//      with cnt = 0 (the null adapter, an evicted slot) reads none.
//   2. gemm: a shared-memory tiled fp32 GEMM for x @ W (64 x 64 output tile per
//      256-thread block, 4 x 4 per thread, K in steps of 16) whose epilogue adds
//      sum_q u[i][q] * b[lo_i + q][n], again reading only segment rows of b.
//
// The TPU kernel carried x @ a_rows^T for all R rows in scratch across its
// sequential K grid axis and masked it at the end; blocks here run in no
// order, so the per-row down-projection is its own pass (the guide's "second
// pass"), computed once per request row instead of once per output tile.
// Segments are clipped to [0, R): the TPU kernel's iota mask counts only rows
// that exist.
//
// Arithmetic: fp32 FMA throughout, no TF32 and no tensor cores; bf16 operands
// are widened on load and the output is rounded once (round to nearest even).
//
// What bounds it: at the serving shapes (M = K = N = 512, 1024 packed rows)
// neither bytes (about 3 MB, 1 us at 3.35 TB/s) nor fp32 operations (0.27
// GFLOP, 4 us at 67 TFLOP/s) is near the launch and latency cost; at M = K =
// N = 4096 the base product's 137 GFLOP bound it, and this SIMT GEMM reaches
// a fraction of the fp32 peak (wgmma, TMA and bf16 tensor cores are later
// work).  No cuBLAS and no library kernel: both products are computed here.
//
// Plain C interface (loaded with ctypes): launches on the given stream, never
// synchronises, allocates nothing (the wrapper allocates y and the scratch u),
// returns the CUDA error code (0 on success).

#include "common.cuh"

namespace {

constexpr int kBM = 64;           // output rows per GEMM block
constexpr int kBN = 64;           // output columns per GEMM block
constexpr int kBK = 16;           // K step of the shared-memory tiles
constexpr int kGemmThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kDownThreads = 128; // 4 warps, one segment row each at a time
constexpr int kDownWarps = kDownThreads / 32;

struct Params {
  const void* x;          // (m, k)
  const void* w;          // (k, n)
  const void* a;          // (r, k): a_rows, or A
  const void* b;          // element (p, c) at b[p * b_sp + c * b_sn]
  const int32_t* off;     // (m,) segment offsets, or null: every segment is [0, r)
  const int32_t* cnt;     // (m,) segment lengths (null with off)
  const float* scale;     // (m,) per row, or one value (scale_stride 0)
  int64_t scale_stride;
  float* u;               // (m, u_stride) fp32 scratch
  int64_t u_stride;
  void* y;                // (m, n)
  int64_t m, k, n, r;
  int64_t b_sp, b_sn;
};

// Row i's segment [lo, hi) of the packed rows, clipped to [0, r).
__device__ __forceinline__ void segment(const Params& p, int64_t i, int64_t& lo, int64_t& hi) {
  if (p.off == nullptr) {
    lo = 0;
    hi = p.r;
    return;
  }
  const int64_t o = p.off[i];
  lo = o < 0 ? 0 : o;
  hi = o + static_cast<int64_t>(p.cnt[i]);
  if (hi > p.r) hi = p.r;
  if (hi < lo) hi = lo;
}

template <typename T>
__global__ void __launch_bounds__(kDownThreads) down_kernel(Params p) {
  const int64_t i = blockIdx.x;
  int64_t lo, hi;
  segment(p, i, lo, hi);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* __restrict__ x = static_cast<const T*>(p.x) + i * p.k;
  const T* __restrict__ a = static_cast<const T*>(p.a);
  const float s = p.scale[p.scale_stride * i];
  for (int64_t q = lo + warp; q < hi; q += kDownWarps) {
    const T* __restrict__ ar = a + q * p.k;
    float acc = 0.f;
    for (int64_t c = lane; c < p.k; c += 32) acc = fmaf(to_f32(x[c]), to_f32(ar[c]), acc);
    acc = warp_sum(acc);
    if (lane == 0) p.u[i * p.u_stride + (q - lo)] = s * acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(Params p) {
  // x tile stored transposed (k-major) so the inner loop reads a thread's
  // four rows as broadcasts; +1 column breaks the store's bank pattern
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w = static_cast<const T*>(p.w);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int64_t k0 = 0; k0 < p.k; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kGemmThreads; ++l) {
      const int idx = tid + kGemmThreads * l;
      const int row = idx / kBK, col = idx % kBK;
      const int64_t gi = m0 + row, gk = k0 + col;
      xs[col][row] = (gi < p.m && gk < p.k) ? to_f32(x[gi * p.k + gk]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kGemmThreads; ++l) {
      const int idx = tid + kGemmThreads * l;
      const int row = idx / kBN, col = idx % kBN;
      const int64_t gk = k0 + row, gn = n0 + col;
      ws[row][col] = (gk < p.k && gn < p.n) ? to_f32(w[gk * p.n + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = ws[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv[r], wv[c], acc[r][c]);
    }
    __syncthreads();
  }

  // epilogue: the row's low-rank term over its segment rows of b, then store
  const T* __restrict__ b = static_cast<const T*>(p.b);
  T* __restrict__ y = static_cast<T*>(p.y);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t i = m0 + ty + 16 * r;
    if (i >= p.m) continue;
    int64_t lo, hi;
    segment(p, i, lo, hi);
    const float* __restrict__ u = p.u + i * p.u_stride;
    for (int64_t q = lo; q < hi; ++q) {
      const float uq = u[q - lo];
      const T* __restrict__ br = b + q * p.b_sp;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t n = n0 + tx + 16 * c;
        if (n < p.n) acc[r][c] = fmaf(uq, to_f32(br[n * p.b_sn]), acc[r][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t n = n0 + tx + 16 * c;
      if (n < p.n) y[i * p.n + n] = from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int64_t grid_n = (p.n + kBN - 1) / kBN;
  const int64_t grid_m = (p.m + kBM - 1) / kBM;
  if (p.m > 0x7fffffffLL || grid_n > 0x7fffffffLL || grid_m > 65535) return cudaErrorInvalidValue;
  down_kernel<T><<<static_cast<unsigned>(p.m), kDownThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemm_kernel<T><<<dim3(static_cast<unsigned>(grid_n), static_cast<unsigned>(grid_m)),
                   kGemmThreads, 0, stream>>>(p);
  return cudaGetLastError();
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
// (r_total, n), all of `dtype` and contiguous; off, cnt (m,) int32 and scale
// (m,) f32 per request row; u an f32 scratch of m * r_total; y (m, n) of dtype.
int lora_matmul_batched(const void* x, const void* w, const void* a_rows, const void* b_rows,
                        const int32_t* off, const int32_t* cnt, const float* scale, float* u,
                        void* y, int dtype, int64_t m, int64_t k, int64_t n, int64_t r_total,
                        void* stream) {
  const Params p{x, w, a_rows, b_rows, off, cnt, scale, 1, u, r_total > 0 ? r_total : 1, y,
                 m, k, n, r_total, n, 1};
  return dispatch(p, dtype, stream);
}

// lora_matmul: x (m, k), w (k, n), a (r, k), b (n, r), all of `dtype` and
// contiguous; scale one f32 on the device; u an f32 scratch of m * r; y (m, n).
int lora_matmul_single(const void* x, const void* w, const void* a, const void* b,
                       const float* scale, float* u, void* y, int dtype, int64_t m, int64_t k,
                       int64_t n, int64_t r, void* stream) {
  const Params p{x, w, a, b, nullptr, nullptr, scale, 0, u, r > 0 ? r : 1, y,
                 m, k, n, r, 1, r};
  return dispatch(p, dtype, stream);
}

}  // extern "C"
