// FLoRA stacking kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/rbla_agg/kernel.py:
//
//   * packed_stack_pallas (_packed_stack_kernel): the flora plan's fused
//     stacking over a packed (N, R_in, D) bucket -- a list of
//     (client, src_row, dst_row, rows, scale_idx) copies plus copies out of
//     the previous global, each row scaled by scales[scale_idx]; rows that no
//     copy touches are zero.
//   * flora_stack_pallas (_stack_kernel): the single-pair form -- contributor
//     i's first segs[i] rows, scaled by scales[i], at a running offset.
//
// The TPU kernels unroll a static copy list at trace time, so every cohort
// compiles anew.  Here the copy list is runtime data: the wrapper turns it
// into a per-output-row table of int32 triples (source, source row, scale
// index), where the source is a client index, -1 for the previous global, or
// -2 for a zero row.  The table is built on the host in the copy order of the
// TPU kernel (x copies first, then prev copies), so where two copies overlap
// the later one wins, as there.  One compiled kernel serves every cohort.
//
// What bounds it: a pure placement, so bandwidth.  The least time is bytes /
// 3.35 TB/s (H100 SXM) with bytes = the copied source rows read once + the
// table + the output written once; the only arithmetic is one fp32 multiply
// per element.  The design streams each output row once: one block row per
// output row (the table entry is read once per block and the branch is
// uniform across the block), each thread owns VEC consecutive columns with
// 16-byte loads and stores when the width and the pointers allow it (scalar
// otherwise), and a zero row is written in the same pass -- there is no
// separate memset.  Ragged widths need no padding: the column loop is bounded
// by D.  Values are multiplied in fp32 and rounded to the element type (f32
// or bf16) once.
//
// Plain C interface (loaded with ctypes): launches on the given stream, never
// synchronises, allocates nothing, returns the CUDA error code (0 on success).

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

}  // extern "C"
