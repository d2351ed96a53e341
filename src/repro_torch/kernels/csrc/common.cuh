// Helpers shared by the port's kernel sources (every csrc/*.cu).  Each source
// compiles into its own library, so every definition here exists once per
// library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes of the C interfaces (the wrappers' _IN_CODES / _OUT_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// VEC consecutive elements moved as one access (16 bytes for the input type
// when VEC = 16 / sizeof(T)).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  const Vec<T, VEC> t = *reinterpret_cast<const Vec<T, VEC>*>(p);
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = to_f32(t.v[k]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&in)[VEC]) {
  Vec<T, VEC> t;
#pragma unroll
  for (int k = 0; k < VEC; ++k) t.v[k] = from_f32<T>(in[k]);
  *reinterpret_cast<Vec<T, VEC>*>(p) = t;
}

// bytes of one element of a dtype code
__host__ __device__ __forceinline__ int esize(int code) {
  return code == kF32 ? 4 : code == kBF16 ? 2 : 1;
}

// K consecutive elements at p + f, moved in pieces of at most 16 bytes (each
// piece aligned to its size when f is a multiple of K and p to 16 bytes).
template <typename T, int K>
__device__ __forceinline__ void load_k(const T* __restrict__ p, float (&v)[K]) {
  constexpr int P = static_cast<int>(16 / sizeof(T)) < K ? static_cast<int>(16 / sizeof(T)) : K;
#pragma unroll
  for (int i = 0; i < K; i += P) {
    float t[P];
    load_vec<T, P>(p + i, t);
#pragma unroll
    for (int j = 0; j < P; ++j) v[i + j] = t[j];
  }
}

template <typename T, int K>
__device__ __forceinline__ void store_k(T* __restrict__ p, const float (&v)[K]) {
  constexpr int P = static_cast<int>(16 / sizeof(T)) < K ? static_cast<int>(16 / sizeof(T)) : K;
#pragma unroll
  for (int i = 0; i < K; i += P) {
    float t[P];
#pragma unroll
    for (int j = 0; j < P; ++j) t[j] = v[i + j];
    store_vec<T, P>(p + i, t);
  }
}

// Loads and stores in a dtype known only at run time (uniform per block).
template <int K>
__device__ __forceinline__ void load_any(const void* p, int code, int64_t f, float (&v)[K]) {
  switch (code) {
    case kF32: load_k<float, K>(static_cast<const float*>(p) + f, v); break;
    case kBF16: load_k<__nv_bfloat16, K>(static_cast<const __nv_bfloat16*>(p) + f, v); break;
    default: load_k<int8_t, K>(static_cast<const int8_t*>(p) + f, v); break;
  }
}

__device__ __forceinline__ float load_one(const void* p, int code, int64_t f) {
  float v[1];
  load_any<1>(p, code, f, v);
  return v[0];
}

template <int K>
__device__ __forceinline__ void store_any(void* p, int code, int64_t f, const float (&v)[K]) {
  if (code == kF32) store_k<float, K>(static_cast<float*>(p) + f, v);
  else store_k<__nv_bfloat16, K>(static_cast<__nv_bfloat16*>(p) + f, v);
}

__device__ __forceinline__ void store_one(void* p, int code, int64_t f, float v) {
  const float a[1] = {v};
  store_any<1>(p, code, f, a);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// true for a null pointer, so an absent operand never blocks the vector path
inline bool aligned(const void* p, size_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ------------------------------------------------ tensor cores (mma.sync) --
// Fragments of the m16n8 tiles, with g = lane / 4 and t = lane % 4:
//   A (16 x kdepth, row): a0 (g, .), a1 (g + 8, .), a2 and a3 the same rows
//     at the second half of the depth;
//   B (kdepth x 8, col): b0 (., n = g), b1 (second half of the depth, n = g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// TF32 m16n8k8 holds one element of depth t (or t + 4) per register; bf16
// m16n8k16 holds two, depths 2t and 2t + 1 (or + 8), the lower in the low
// half.

// d += a * b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b on one m16n8k16 bf16 tile, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand as TF32 hi (and lo = x - hi, unless the value is exact in TF32,
// as a bf16 value is).  hi is x rounded to nearest, ties away from zero --
// half a TF32 ulp added to the bits, then the low 13 cleared: what cvt.rna
// gives, in two integer operations at the full rate; lo = x - hi is exact in
// fp32, and the tensor core reads it as TF32 by dropping its low 13 bits.
// Products then take lo*hi + hi*lo + hi*hi ("3xTF32"), about fp32's
// accuracy (the dropped lo*lo and lo bits are 2^-20 of a product).
template <bool kExact>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kExact) {
    hi = __float_as_uint(x);  // a bf16 value: its low 16 bits are zero
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

}  // namespace

// Every library answers its launch errors through this one symbol.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
