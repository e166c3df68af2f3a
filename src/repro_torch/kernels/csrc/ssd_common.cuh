// Shared pieces of the SSD chunked-scan kernels (ssd_scan.cu forward,
// ssd_scan_bwd.cu backward): type conversions, the strides of the
// tensors, the chunk's staging of dt and its in-chunk prefix sum of the
// log-decay, and the per-row decays.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace ssd {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMaxS = 128;     // chunk length
constexpr int kMaxP = 64;      // head dim
constexpr int kMaxN = 128;     // state size
constexpr int kMaxCluster = 8;  // chunks of a row in one cluster
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

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

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   mma::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Warp 0 starts the copy of the chunk's dt (strided) into dts as its own
// group of asynchronous copies; the caller then starts the tiles' copies.
__device__ __forceinline__ void chunk_dt_start(const float* __restrict__ dtb,
                                               long long ld, float* dts,
                                               int s) {
  if (threadIdx.x >= 32) return;
  for (int i = threadIdx.x; i < s; i += 32) cp_async4(dts + i, dtb + i * ld);
  mma::cp_async_commit();
}

// Warp 0 waits for dt alone (the tiles' group may still be in flight) and
// thread 0 takes its prefix sum into acum; the caller synchronises after.
__device__ __forceinline__ void chunk_dt_sum(float Av, const float* dts,
                                             float* acum, int s) {
  if (threadIdx.x >= 32) return;
  mma::cp_async_wait<1>();
  __syncwarp();
  chunk_cumsum(dts, Av, acum, s);
}

// per row: exp(a_cum), the weight exp(a_sum - a_cum) dt of x in the local
// state, and the chunk's decay exp(a_sum); rows s .. rows - 1 get zeros
__device__ __forceinline__ void chunk_rows(const float* dts, float* acum,
                                           float* ecum, float* wv,
                                           float* decay_s, int s, int rows) {
  const float alast = acum[s - 1];
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const bool in = i < s;
    if (!in) acum[i] = 0.f;
    ecum[i] = in ? expf(acum[i]) : 0.f;
    wv[i] = in ? expf(alast - acum[i]) * dts[i] : 0.f;
  }
  if (threadIdx.x == 0) *decay_s = expf(alast);
}

}  // namespace ssd
