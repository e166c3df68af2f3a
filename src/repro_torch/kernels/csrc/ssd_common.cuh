// Shared pieces of the SSD chunked-scan kernels (ssd_scan.cu forward,
// ssd_scan_bwd.cu backward): type conversions, the strides of the
// tensors, the shared-memory row pitches and the in-chunk prefix sum of
// the log-decay.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssd {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMaxS = 128;     // chunk length
constexpr int kMaxP = 64;      // head dim
constexpr int kMaxN = 128;     // state size
constexpr int kJB = 32;        // key columns per block of the (s, s) matrix
constexpr int kWPitch = kJB + 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like a torch cast
}

// Element strides.  x, y, dy, dx: (b, h, l) of a (B, H, L, P) view, unit
// P; dt, ddt: (b, h, l) of (B, H, L); A, D: (b, h) of (B, H); Bm, Cm:
// (b, l) of (B, L, N), unit N.
struct Strides {
  long long x[3], dt[3], a[2], d[2], bm[2], cm[2], y[3], dx[3], ddt[3];
};

inline Strides strides_from(const long long* v) {
  Strides s;
  long long* dst[] = {s.x, s.dt, s.a, s.d, s.bm, s.cm, s.y, s.dx, s.ddt};
  const int len[] = {3, 3, 2, 2, 2, 2, 3, 3, 3};
  int k = 0;
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < len[i]; ++j) dst[i][j] = v[k++];
  return s;
}

// acum[i] = sum_{k <= i} dts[k] * A over one chunk, by thread 0 in
// sequence: each product rounded to f32 (no FMA contraction), the running
// sum kept in f64 and rounded to f32 at every position, which is how torch
// takes an f32 cumsum on the CPU, so the plain version there gives the
// same bits.  (|a_cum| reaches ~10^3 at the models' decay rates, where an
// ulp of it is ~1e-4 of exp(a_cum[i] - a_cum[j]).)  The caller
// synchronises before reading acum.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float A,
                                             float* acum, int s) {
  if (threadIdx.x != 0) return;
  double run = 0.0;
  for (int i = 0; i < s; ++i) {
    run += (double)__fmul_rn(dts[i], A);
    acum[i] = (float)run;
  }
}

// sum over the 16 lanes of a half-warp (one row of a 16 x 16 thread tile)
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// sum over the block in a fixed order (warp shuffles, then warp 0 over the
// eight warp totals); every thread gets the result.  red: 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

// rows [r0, r0 + n) of a (rows, width) slab with row stride `ld` (unit
// column stride) into dst with row pitch `pitch`, as f32
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long ld,
                                      int n, int width, float* dst,
                                      int pitch) {
  for (int idx = threadIdx.x; idx < n * width; idx += kThreads) {
    const int r = idx / width, c = idx - r * width;
    dst[r * pitch + c] = to_f32(src[r * ld + c]);
  }
}

}  // namespace ssd
