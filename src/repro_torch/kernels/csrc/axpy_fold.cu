// The async server's per-update fold for Hopper (sm_90a):
//
//   out[r, c] = y[r, c] + alpha[r] * (x[r, c] - y[r, c])
//
// Replaces axpy_fold_pallas (_axpy_kernel) of
// src/repro/kernels/rbla_agg/kernel.py.  y is the live server state, x the
// arriving update, both packed with the rank-row axis leading; alpha is one
// fp32 mixing rate per row (RBLA's running per-rank-row mean: rows the client
// does not own have alpha 0) or one rate for every row (the scalar server
// mix of fedavg/zeropad and the base trainables).
//
// What bounds it: bandwidth.  Each element of y and x is read once and feeds
// three flops, so the least time is bytes / 3.35 TB/s (H100 SXM) with bytes =
// R*D*(sizeof(y) + sizeof(x) + sizeof(out)) + 4*R for the rates.  The design
// only tries to stream both operands once at full width: a block holds
// 256 / tpr rows, each row served by tpr threads (a power of two sized to the
// width, so the narrow rows of the paper MLP -- widths 10 and 1 -- do not
// idle a whole block), and each thread reads its row's rate once and moves
// 16-byte vectors of that row.  Ragged widths need no padding: a row whose
// flat start is not vector-aligned gets a scalar head, then vectors, then a
// scalar tail.  The arithmetic is three separately rounded fp32 operations,
// exactly as the plain PyTorch version computes it, so the two agree bit for
// bit; there is no alpha == 0 branch: 0 * (x - y) adds nothing to y, and a
// NaN in x reaches the output in kernel and plain version alike.  The result
// is written in the output type (y's, or fp32 when the caller rounds it to
// bf16 stochastically afterwards).
//
// Plain C interface (loaded with ctypes): launches on the given stream, never
// synchronises, allocates nothing, returns the CUDA error code (0 on success).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename Ty, typename Tx, typename To>
__device__ __forceinline__ To fold_one(const Ty* __restrict__ y, const Tx* __restrict__ x,
                                       float a, int64_t i) {
  const float yv = to_f32(y[i]);
  return from_f32<To>(__fadd_rn(yv, __fmul_rn(a, __fsub_rn(to_f32(x[i]), yv))));
}

// Grid: x = blocks of 256 / tpr rows, y = chunks of a row's vectors.
template <typename Ty, typename Tx, typename To, int VEC>
__global__ void __launch_bounds__(kThreads) axpy_kernel(
    const Ty* __restrict__ y, const Tx* __restrict__ x, const float* __restrict__ alpha,
    int64_t alpha_len, float alpha_value, To* __restrict__ out, int64_t n_rows, int64_t width,
    int tpr) {
  const int lane = threadIdx.x & (tpr - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / tpr) + threadIdx.x / tpr;
  if (row >= n_rows) return;
  const float a = alpha == nullptr ? alpha_value : alpha[alpha_len == 1 ? 0 : row];
  const int64_t base = row * width;
  // elements before the row's first vector-aligned flat index
  int64_t head = (VEC - base % VEC) % VEC;
  if (head > width) head = width;
  const int64_t n_vec = (width - head) / VEC;
  const int64_t tail = head + n_vec * VEC;
  const int64_t step = static_cast<int64_t>(gridDim.y) * tpr;
  for (int64_t v = static_cast<int64_t>(blockIdx.y) * tpr + lane; v < n_vec; v += step) {
    const int64_t c = base + head + v * VEC;
    float yv[VEC], xv[VEC], ov[VEC];
    load_vec<Ty, VEC>(y + c, yv);
    load_vec<Tx, VEC>(x + c, xv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) ov[k] = __fadd_rn(yv[k], __fmul_rn(a, __fsub_rn(xv[k], yv[k])));
    store_vec<To, VEC>(out + c, ov);
  }
  if (blockIdx.y == 0) {
    for (int64_t c = lane; c < head; c += tpr) out[base + c] = fold_one<Ty, Tx, To>(y, x, a, base + c);
    for (int64_t c = tail + lane; c < width; c += tpr)
      out[base + c] = fold_one<Ty, Tx, To>(y, x, a, base + c);
  }
}

struct Args {
  const void* y;
  const void* x;
  const float* alpha;
  int64_t alpha_len;
  float alpha_value;
  void* out;
  int64_t r, d;
  cudaStream_t stream;
};

template <typename Ty, typename Tx, typename To, int VEC>
cudaError_t launch(const Args& a) {
  // threads per row: the smallest power of two covering the row's vectors,
  // at most the whole block; each thread then moves up to 4 vectors per row
  const int64_t groups = (a.d + VEC - 1) / VEC;
  int tpr = 1;
  while (tpr < kThreads && tpr < groups) tpr <<= 1;
  const int64_t rows_per_block = kThreads / tpr;
  const int64_t blocks = (a.r + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int64_t chunks = (groups + 4LL * tpr - 1) / (4LL * tpr);
  if (chunks < 1) chunks = 1;
  if (chunks > 65535) chunks = 65535;
  axpy_kernel<Ty, Tx, To, VEC>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks)), kThreads, 0,
         a.stream>>>(static_cast<const Ty*>(a.y), static_cast<const Tx*>(a.x), a.alpha,
                     a.alpha_len, a.alpha_value, static_cast<To*>(a.out), a.r, a.d, tpr);
  return cudaGetLastError();
}

// 16-byte accesses of the widest operand: VEC elements of every operand at
// once, each base pointer aligned to its own VEC-element access; otherwise
// the scalar instantiation runs (same arithmetic).
template <typename Ty, typename Tx, typename To>
cudaError_t dispatch_vec(const Args& a) {
  constexpr size_t kWidest =
      sizeof(Ty) > sizeof(Tx) ? (sizeof(Ty) > sizeof(To) ? sizeof(Ty) : sizeof(To))
                              : (sizeof(Tx) > sizeof(To) ? sizeof(Tx) : sizeof(To));
  constexpr int V = static_cast<int>(16 / kWidest);
  const bool vec_ok = aligned(a.y, V * sizeof(Ty)) && aligned(a.x, V * sizeof(Tx)) &&
                      aligned(a.out, V * sizeof(To));
  return vec_ok ? launch<Ty, Tx, To, V>(a) : launch<Ty, Tx, To, 1>(a);
}

template <typename Ty, typename Tx>
cudaError_t dispatch_out(const Args& a, int out_dtype) {
  switch (out_dtype) {
    case kF32: return dispatch_vec<Ty, Tx, float>(a);
    case kBF16: return dispatch_vec<Ty, Tx, __nv_bfloat16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Ty>
cudaError_t dispatch_x(const Args& a, int x_dtype, int out_dtype) {
  switch (x_dtype) {
    case kF32: return dispatch_out<Ty, float>(a, out_dtype);
    case kBF16: return dispatch_out<Ty, __nv_bfloat16>(a, out_dtype);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// axpy_fold: y (r, d) of y_dtype; x (r, d) of x_dtype; alpha null (every row
// takes alpha_value) or an f32 device array of alpha_len = 1 or r entries;
// out (r, d) of out_dtype.  All three matrices are contiguous.
int axpy_fold_rows(const void* y, int y_dtype, const void* x, int x_dtype, const float* alpha,
                   int64_t alpha_len, float alpha_value, void* out, int out_dtype, int64_t r,
                   int64_t d, void* stream) {
  if (r <= 0 || d <= 0) return cudaSuccess;
  if (alpha != nullptr && alpha_len != 1 && alpha_len != r) return cudaErrorInvalidValue;
  const Args a{y, x, alpha, alpha_len, alpha_value, out, r, d, static_cast<cudaStream_t>(stream)};
  switch (y_dtype) {
    case kF32: return dispatch_x<float>(a, x_dtype, out_dtype);
    case kBF16: return dispatch_x<__nv_bfloat16>(a, x_dtype, out_dtype);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
