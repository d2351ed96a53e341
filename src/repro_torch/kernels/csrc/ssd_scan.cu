// Mamba2's chunked SSD (state-space duality) scan for Hopper (sm_90a).
//
// Replaces ssd_scan_pallas (_kernel) of src/repro/kernels/ssd_scan/kernel.py.
// For each (batch b, head h) and each chunk of Q steps in order, with
// a_cs the inclusive cumulative sum of dta over the chunk and h_prev the
// state the previous chunks left (zero before the first):
//
//   y_diag = ((C B^T) o Lmask) @ xdt,  Lmask[i, j] = exp(a_cs[i] - a_cs[j]), j <= i
//   y_off  = (C h_prev^T) * exp(a_cs)
//   h      = h_prev * exp(a_tot) + xdt^T (B * exp(a_tot - a_cs)),  a_tot = a_cs[Q-1]
//
// and writes y = y_diag + y_off, then h_final after the last chunk.  Shapes:
// xdt (B, L, H, P), dta (B, L, H) fp32, bm/cm (B, L, N), y (B, L, H, P),
// h_final (B, H, P, N); xdt, bm, cm, y and h_final share one type (fp32 or
// bf16).  Everything is computed in fp32 and rounded once on the way out, as
// the TPU kernel does.  Q is the caller's (any Q >= 1 that divides L).
//
// What bounds it: operations.  The causal mask leaves Q (Q + 1) / 2 of a
// chunk's Q^2 (i, j) pairs, so per (b, chunk) C B^T takes Q (Q + 1) N, and
// per (b, h, chunk) y_diag Q (Q + 1) P and y_off and the state 2 Q N P each;
// at mamba2-1.3b's prefill (B 4, L 2048, H 64, P 64, N 128, Q 256) that is
// about 26 GFLOP against about 0.3 GB of operands, so the least time is the
// fp32 operations over 67 TFLOP/s (H100 SXM, outside the tensor cores).
//
// Design.  A TPU kernel carries h in VMEM along a sequential grid axis;
// Hopper's blocks run in no order, so one block owns one (b, h, 64-wide tile
// of P) and loops over the chunks itself, with its rows of h (P-tile x N,
// transposed) in shared memory for the whole sequence: y[:, p] needs only
// h[p, :] and xdt[:, p], so P-tiles are independent.  At the shape above
// that is 256 blocks of 256 threads, two per SM in one wave.  A chunk of 256
// rows of B and C does not fit in shared memory next to h, so a chunk is cut
// into 64-row i-tiles (outputs) and, for each, the j-tiles at or below the
// diagonal (inputs); C B^T is built per tile pair from 32-column slabs of C
// and B (so any N works), masked and decayed in registers, and multiplied
// into xdt.  Every product is a 4 x 4 register tile per thread fed by
// float4 reads of shared memory, in fp32 SIMT.  The mask is a select before
// the exponential is used -- never a product with a 0/1 mask -- because
// above the diagonal a_cs[i] - a_cs[j] is large and positive (exp overflows
// to inf, and inf * 0 is NaN); only exponentials of differences are taken,
// never ratios of exponentials (which underflow to 0/0).  exp(a_cs) in y_off
// may underflow to 0, which is the right value.  Ragged edges (Q not a
// multiple of 64, P below 64, N not a multiple of 32) load zeros and store
// nothing.  What the design leaves: C B^T is recomputed for each head and
// P-tile, in whole 64 x 64 tiles on the diagonal (at the shape above the
// kernel does about 49 GFLOP, 1.9 times the work counted, 43% of it C B^T),
// and nothing runs on the tensor cores; hoisting C B^T per (b, chunk) and
// mma/wgmma are the kernel's next steps.
//
// Plain C interface (loaded with ctypes): launches on the given stream, never
// synchronises, allocates nothing, returns the CUDA error code (0 on success).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // a 16 x 16 grid of 4 x 4 register tiles
constexpr int kTI = 64;             // chunk rows per i-tile (outputs)
constexpr int kTJ = 64;             // chunk rows per j-tile (inputs); == kTI
constexpr int kPT = 64;             // head-dim columns per block
constexpr int kNK = 32;             // state columns per slab
constexpr int kTIp = kTI + 4;       // padded rows, still 16-byte aligned
constexpr int kPTp = kPT + 4;
constexpr int kBSlab = kNK * kTIp > kTJ * kNK ? kNK * kTIp : kTJ * kNK;
constexpr size_t kMaxSmem = 232448; // what one block may ask for on sm_90
static_assert(kTI == kTJ, "the diagonal tile pairs assume square tiles");

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// floats of dynamic shared memory, in the order the kernel carves them
inline size_t smem_floats(int q, int n) {
  return static_cast<size_t>(round_up(n, kNK)) * kPTp  // hT
         + kNK * kTIp                                  // cT
         + kBSlab                                      // bT / bs
         + kTJ * kTIp                                  // wT
         + kTJ * kPT                                   // xs
         + round_up(q, 4)                              // acs
         + kThreads / 32;                              // scan partials
}

__device__ __forceinline__ void outer(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acs[k] = dta[0] + ... + dta[k] over the chunk's q steps (dta strided by
// `stride`): each thread sums a run of consecutive steps, then a block scan
// of the runs' totals.  Ends synchronised.
__device__ void chunk_cumsum(const float* __restrict__ dta, int stride, int q, float* acs,
                             float* part) {
  const int tid = threadIdx.x;
  const int per = (q + kThreads - 1) / kThreads;
  const int lo = min(tid * per, q), hi = min(lo + per, q);
  float run = 0.f;
  for (int k = lo; k < hi; ++k) {
    run += dta[static_cast<int64_t>(k) * stride];
    acs[k] = run;
  }
  const int lane = tid & 31, warp = tid >> 5;
  float v = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) part[warp] = v;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      const float t = part[w];
      part[w] = s;
      s += t;
    }
  }
  __syncthreads();
  const float offset = part[warp] + (v - run);
  for (int k = lo; k < hi; ++k) acs[k] += offset;
  __syncthreads();
}

// dst[nn][ii] = m[row0 + ii, n0 + nn] for the slab's kTI rows and kNK
// columns (zero past `rows` rows or past column n).
template <typename T>
__device__ __forceinline__ void load_slab_t(const T* __restrict__ m, int64_t row0, int rows,
                                            int n0, int n, float* dst) {
  for (int e = threadIdx.x; e < kTI * kNK; e += kThreads) {
    const int ii = e / kNK, nn = e % kNK;
    float v = 0.f;
    if (ii < rows && n0 + nn < n) v = to_f32(m[(row0 + ii) * n + n0 + nn]);
    dst[nn * kTIp + ii] = v;
  }
}

// xs[jj][pp] = xdt[row0 + jj, head, p0 + pp] (zero past `rows` or `pw`).
template <typename T>
__device__ __forceinline__ void load_x(const T* __restrict__ xdt, int64_t row0, int rows, int hh,
                                       int hn, int p, int p0, int pw, float* xs) {
  for (int e = threadIdx.x; e < kTJ * kPT; e += kThreads) {
    const int jj = e / kPT, pp = e % kPT;
    float v = 0.f;
    if (jj < rows && pp < pw) v = to_f32(xdt[((row0 + jj) * hn + hh) * p + p0 + pp]);
    xs[e] = v;
  }
}

// Grid: x = P-tiles, y = heads, z = batch.  One block walks every chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_kernel(const T* __restrict__ xdt, const float* __restrict__ dta,
                    const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y,
                    T* __restrict__ h_final, int l, int hn, int p, int n, int q) {
  extern __shared__ __align__(16) float smem[];
  const int n_pad = round_up(n, kNK);
  float* hT = smem;                    // [n_pad][kPTp]: h_prev transposed
  float* cT = hT + n_pad * kPTp;       // [kNK][kTIp]: a slab of C, transposed
  float* bT = cT + kNK * kTIp;         // [kNK][kTIp] B slab, or [kTJ][kNK] decayed B
  float* wT = bT + kBSlab;             // [kTJ][kTIp]: masked, decayed C B^T, transposed
  float* xs = wT + kTJ * kTIp;         // [kTJ][kPT]: a j-tile of xdt
  float* acs = xs + kTJ * kPT;         // [q]: a_cs of the chunk
  float* part = acs + round_up(q, 4);  // [kThreads / 32]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int p0 = blockIdx.x * kPT;
  const int pw = min(kPT, p - p0);
  const int hh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int nc = l / q;
  const int n_it = (q + kTI - 1) / kTI;

  for (int e = tid; e < n_pad * kPTp; e += kThreads) hT[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int64_t row0 = b * l + static_cast<int64_t>(c) * q;  // the chunk's first step
    __syncthreads();  // the last chunk's readers of acs and hT are done
    chunk_cumsum(dta + row0 * hn + hh, hn, q, acs, part);

    for (int it = 0; it < n_it; ++it) {
      const int i0 = it * kTI;
      float acc[4][4] = {};
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTJ;
        float s[4][4] = {};
        for (int n0 = 0; n0 < n; n0 += kNK) {
          load_slab_t(cm, row0 + i0, q - i0, n0, n, cT);
          load_slab_t(bm, row0 + j0, q - j0, n0, n, bT);
          __syncthreads();
#pragma unroll 8
          for (int nn = 0; nn < kNK; ++nn)
            outer(s, ld4(cT + nn * kTIp + ty * 4), ld4(bT + nn * kTIp + tx * 4));
          __syncthreads();
        }
        // mask first, then decay: no exponential of the upper triangle is used
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
#pragma unroll
          for (int s2 = 0; s2 < 4; ++s2) {
            const int j = j0 + tx * 4 + s2;
            float w = 0.f;
            if (i < q && j <= i) w = s[r][s2] * expf(acs[i] - acs[j]);
            wT[(tx * 4 + s2) * kTIp + ty * 4 + r] = w;
          }
        }
        load_x(xdt, row0 + j0, q - j0, hh, hn, p, p0, pw, xs);
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < kTJ; ++jj)
          outer(acc, ld4(wT + jj * kTIp + ty * 4), ld4(xs + jj * kPT + tx * 4));
        __syncthreads();
      }
      // y_off = (C h_prev^T) * exp(a_cs)
      float o[4][4] = {};
      for (int n0 = 0; n0 < n; n0 += kNK) {
        load_slab_t(cm, row0 + i0, q - i0, n0, n, cT);
        __syncthreads();
#pragma unroll 8
        for (int nn = 0; nn < kNK; ++nn)
          outer(o, ld4(cT + nn * kTIp + ty * 4), ld4(hT + (n0 + nn) * kPTp + tx * 4));
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i >= q) continue;
        const float e = expf(acs[i]);
        T* yrow = y + ((row0 + i) * hn + hh) * p + p0;
#pragma unroll
        for (int s2 = 0; s2 < 4; ++s2) {
          const int pp = tx * 4 + s2;
          if (pp < pw) yrow[pp] = from_f32<T>(fmaf(o[r][s2], e, acc[r][s2]));
        }
      }
    }

    // h = h_prev * exp(a_tot) + xdt^T (B * exp(a_tot - a_cs)); each thread
    // owns state column nn of 8 head-dim rows, so no other thread reads or
    // writes its rows of hT until the next chunk
    const float a_tot = acs[q - 1];
    const float g = expf(a_tot);
    const int nn = tid % kNK, pg = (tid / kNK) * 8;
    float* bs = bT;
    for (int n0 = 0; n0 < n; n0 += kNK) {
      float st[8] = {};
      for (int j0 = 0; j0 < q; j0 += kTJ) {
        for (int e = tid; e < kTJ * kNK; e += kThreads) {
          const int jj = e / kNK, cn = e % kNK, j = j0 + jj;
          float v = 0.f;
          if (j < q && n0 + cn < n)
            v = to_f32(bm[(row0 + j) * n + n0 + cn]) * expf(a_tot - acs[j]);
          bs[e] = v;
        }
        load_x(xdt, row0 + j0, q - j0, hh, hn, p, p0, pw, xs);
        __syncthreads();
        const int rows = min(kTJ, q - j0);
        for (int jj = 0; jj < rows; ++jj) {
          const float bv = bs[jj * kNK + nn];
          const float4 x0 = ld4(xs + jj * kPT + pg), x1 = ld4(xs + jj * kPT + pg + 4);
          st[0] = fmaf(x0.x, bv, st[0]);
          st[1] = fmaf(x0.y, bv, st[1]);
          st[2] = fmaf(x0.z, bv, st[2]);
          st[3] = fmaf(x0.w, bv, st[3]);
          st[4] = fmaf(x1.x, bv, st[4]);
          st[5] = fmaf(x1.y, bv, st[5]);
          st[6] = fmaf(x1.z, bv, st[6]);
          st[7] = fmaf(x1.w, bv, st[7]);
        }
        __syncthreads();
      }
      float* hrow = hT + (n0 + nn) * kPTp + pg;
#pragma unroll
      for (int k = 0; k < 8; ++k) hrow[k] = fmaf(hrow[k], g, st[k]);
    }
  }

  __syncthreads();
  for (int e = tid; e < pw * n; e += kThreads) {
    const int pp = e / n, cn = e % n;
    h_final[((b * hn + hh) * p + p0 + pp) * n + cn] = from_f32<T>(hT[cn * kPTp + pp]);
  }
}

struct Args {
  const void* xdt;
  const float* dta;
  const void* bm;
  const void* cm;
  void* y;
  void* h_final;
  int64_t b, l, h, p, n, q;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_floats(static_cast<int>(a.q), static_cast<int>(a.n)) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.p + kPT - 1) / kPT), static_cast<unsigned>(a.h),
                  static_cast<unsigned>(a.b));
  ssd_scan_kernel<T><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.xdt), a.dta, static_cast<const T*>(a.bm),
      static_cast<const T*>(a.cm), static_cast<T*>(a.y), static_cast<T*>(a.h_final),
      static_cast<int>(a.l), static_cast<int>(a.h), static_cast<int>(a.p),
      static_cast<int>(a.n), static_cast<int>(a.q));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ssd_scan: xdt (b, l, h, p), bm/cm (b, l, n), y (b, l, h, p), h_final
// (b, h, p, n), all of `dtype` (0 fp32, 1 bf16) and contiguous; dta (b, l, h)
// fp32 contiguous; q >= 1 divides l.  Returns cudaErrorInvalidValue for a
// shape beyond the kernel's limits: b or h above 65535, or a chunk length and
// state size whose tiles need more shared memory than a block may have.
int ssd_scan_chunked(const void* xdt, const float* dta, const void* bm, const void* cm, void* y,
                     void* h_final, int dtype, int64_t b, int64_t l, int64_t h, int64_t p,
                     int64_t n, int64_t q, void* stream) {
  if (b == 0) return cudaSuccess;
  if (b < 0 || l < 1 || h < 1 || p < 1 || n < 1 || q < 1 || l % q != 0) return cudaErrorInvalidValue;
  if (b > 65535 || h > 65535 || b * l * h * p > 0x7fffffffffffLL) return cudaErrorInvalidValue;
  if (l > 0x7fffffff || n > 0x7fffffff) return cudaErrorInvalidValue;
  const Args a{xdt, dta, bm, cm, y, h_final, b, l, h, p, n, q, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32: return launch<float>(a);
    case kBF16: return launch<__nv_bfloat16>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
