// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan_bhcsp` in
// src/repro/kernels/ssd_scan.py.  Per (batch row b, head h) and chunk of s
// positions, with a = dt * A and a_cum its in-chunk prefix sum:
//
//   y     = (L (.) C B^T) diag(dt) x + (exp(a_cum) (.) C) state^T + D x
//   state = exp(a_cum[-1]) state + sum_j exp(a_cum[-1] - a_cum[j]) dt_j
//           x_j (x) B_j
//
// where L[i, j] = exp(a_cum[i] - a_cum[j]) for i >= j and exp(-1e30) = 0
// above the diagonal (the mask goes before the exp, as on the TPU).  All
// arithmetic is f32; y is written in x's type.  B and C are shared by the
// heads.  The final state is not returned, as on the TPU.
//
// Design.  The TPU grid (B, H, nc) runs its chunk axis in order and
// carries the (P, N) state in VMEM scratch.  Here one block of 256
// threads owns one (b, h) and loops over the chunks itself, the f32 state
// staying in shared memory; the chunk's x, B and C are staged there as f32
// too (rows padded by one float, so column reads are free of bank
// conflicts: 217 KB at s = 128, P = 64, N = 128).  Each thread owns a
// 8 x 4 tile of the chunk's (s, P) output (rows ty + 16 r, columns
// tx + 16 q).  The (s, s) matrix (L (.) C B^T) diag(dt) is built 32 key
// columns at a time into shared memory (rows that the causal mask hides
// from a whole column block are skipped), and multiplied into the tile.
// The state update gives each thread a 4 x 8 tile of the (P, N) state.
// When the caller needs the gradient, the block also writes the state at
// the start of every chunk, (B, H, nc, P, N) f32, for the backward kernel
// (ssd_scan_bwd.cu).  x, dt, y are read and written through (b, h, l)
// strides, so the model's (B, L, H, P) layout is taken without a copy.
//
// Bound on this card: the function needs s^2 N multiply-adds per (b,
// chunk) for C B^T, and s^2 P / 2 + 2 s P N per (b, h, chunk), against
// 2 s P bytes of x and y per (b, h, chunk): in bf16 at the tensor cores'
// rate the bytes bound it, in f32 the operations.  This first version
// runs every product on the CUDA cores in f32 (C B^T recomputed by each
// head), two shared-memory loads per two to four FMAs; tensor cores are
// the known next step.
#include "ssd_common.cuh"

namespace {

using namespace ssd;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const float* __restrict__ D,
                   T* __restrict__ y, float* __restrict__ states, Strides sd,
                   int H, int L, int P, int N, int s) {
  extern __shared__ float smem[];
  const int PP = P + 1, NP = N + 1;
  float* xs = smem;              // (s, P)
  float* bs = xs + s * PP;       // (s, N)
  float* cs = bs + s * NP;       // (s, N)
  float* st = cs + s * NP;       // (P, N) running state
  float* wb = st + P * NP;       // (s, 32) block of the (s, s) matrix
  float* acum = wb + s * kWPitch;
  float* dts = acum + s;
  float* wv = dts + s;           // exp(a_cum[-1] - a_cum) * dt

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nc = L / s;
  const float Av = A[b * sd.a[0] + h * sd.a[1]];
  const float Dv = D[b * sd.d[0] + h * sd.d[1]];
  const T* xb = x + b * sd.x[0] + h * sd.x[1];
  const float* dtb = dt + b * sd.dt[0] + h * sd.dt[1];
  const T* bmb = Bm + b * sd.bm[0];
  const T* cmb = Cm + b * sd.cm[0];
  T* yb = y + b * sd.y[0] + h * sd.y[1];
  float* stb = states ? states + ((long long)b * H + h) * nc * P * N
                      : nullptr;

  // clamped indices: reads past the edge stay in bounds, results there
  // are dropped
  int ic[8], pc[4], pr[4], nk[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) ic[r] = min(ty + 16 * r, s - 1);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pc[q] = min(tx + 16 * q, P - 1);
    pr[q] = min(ty + 16 * q, P - 1);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) nk[k] = min(tx + 16 * k, N - 1);

  for (int idx = tid; idx < P * NP; idx += kThreads) st[idx] = 0.f;
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const long long i0 = (long long)c * s;
    if (stb)
      for (int idx = tid; idx < P * N; idx += kThreads) {
        const int p = idx / N, n = idx - p * N;
        stb[c * (long long)P * N + idx] = st[p * NP + n];
      }
    for (int i = tid; i < s; i += kThreads) dts[i] = dtb[(i0 + i) * sd.dt[2]];
    stage(xb + i0 * sd.x[2], sd.x[2], s, P, xs, PP);
    stage(bmb + i0 * sd.bm[1], sd.bm[1], s, N, bs, NP);
    stage(cmb + i0 * sd.cm[1], sd.cm[1], s, N, cs, NP);
    __syncthreads();
    chunk_cumsum(dts, Av, acum, s);
    __syncthreads();
    const float alast = acum[s - 1];
    for (int i = tid; i < s; i += kThreads)
      wv[i] = expf(alast - acum[i]) * dts[i];

    // the carried state's contribution: exp(a_cum[i]) * C[i] . state[p]
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[8], sv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) cv[r] = cs[ic[r] * NP + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[q] = st[pc[q] * NP + n];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], sv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float e = expf(acum[ic[r]]);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] *= e;
    }

    // the in-chunk term, 32 key columns j at a time
    for (int j0 = 0; j0 < s; j0 += kJB) {
      int jc[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) jc[k] = min(j0 + tx + 16 * k, s - 1);
      float w[8][2];
#pragma unroll
      for (int r = 0; r < 8; ++r) w[r][0] = w[r][1] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float b0 = bs[jc[0] * NP + n], b1 = bs[jc[1] * NP + n];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (16 * r + 15 < j0 || 16 * r >= s) continue;  // all masked
          const float cv = cs[ic[r] * NP + n];
          w[r][0] = fmaf(cv, b0, w[r][0]);
          w[r][1] = fmaf(cv, b1, w[r][1]);
        }
      }
      __syncthreads();  // the previous column block is consumed
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        if (16 * r + 15 < j0 || i >= s) continue;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int j = j0 + tx + 16 * k;
          float v = 0.f;
          if (j < s && i >= j)
            v = w[r][k] * expf(acum[i] - acum[j]) * dts[j];
          wb[i * kWPitch + tx + 16 * k] = v;
        }
      }
      __syncthreads();
      const int jn = min(kJB, s - j0);
      for (int jj = 0; jj < jn; ++jj) {
        float xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = xs[(j0 + jj) * PP + pc[q]];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (16 * r + 15 < j0 || 16 * r >= s) continue;
          const float wr = wb[ic[r] * kWPitch + jj];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wr, xv[q], acc[r][q]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= s) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        if (p < P)
          yb[(i0 + i) * sd.y[2] + p] =
              from_f32<T>(acc[r][q] + Dv * xs[i * PP + p]);
      }
    }

    // state update: rows p = ty + 16 r, columns n = tx + 16 k
    float su[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) su[r][k] = 0.f;
    for (int j = 0; j < s; ++j) {
      const float wj = wv[j];
      float xw[4], bv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) xw[r] = xs[j * PP + pr[r]] * wj;
#pragma unroll
      for (int k = 0; k < 8; ++k) bv[k] = bs[j * NP + nk[k]];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) su[r][k] = fmaf(xw[r], bv[k], su[r][k]);
    }
    // every read of the state above happened before the column blocks'
    // barriers; each element is written by its one owner
    const float elast = expf(alast);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
      if (p >= P) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = tx + 16 * k;
        if (n < N) st[p * NP + n] = st[p * NP + n] * elast + su[r][k];
      }
    }
    __syncthreads();  // before the next chunk's loads
  }
}

template <typename T>
int launch_fwd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* D, void* y, void* states,
               const Strides& sd, int B, int H, int L, int P, int N, int s,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)s * (P + 1) +
                                       2 * (size_t)s * (N + 1) +
                                       (size_t)P * (N + 1) +
                                       (size_t)s * kWPitch + 3 * (size_t)s);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(states), sd, H, L, P, N, s);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (B, H, L, P), Bm/Cm (B, L, N) in one type (bf16 when bf16 != 0,
// else f32); dt (B, H, L), A/D (B, H) f32; all through strides[23] (see
// ssd::Strides; the dx and ddt entries are unused here).  states: NULL, or
// (B, H, L / s, P, N) f32 contiguous for the chunk-start states.
// Requires L % s == 0, s <= 128, P <= 64, N <= 128.
extern "C" int ssd_scan_fwd_launch(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, const void* D, void* y,
                                   void* states, const long long* strides,
                                   int B, int H, int L, int P, int N, int s,
                                   int bf16, void* stream) {
  if (B == 0 || H == 0 || L == 0) return 0;
  const Strides sd = strides_from(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, states, sd,
                                          B, H, L, P, N, s, st)
              : launch_fwd<float>(x, dt, A, Bm, Cm, D, y, states, sd, B, H, L,
                                  P, N, s, st);
}
