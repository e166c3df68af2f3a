// Mamba2 SSD chunked scan, backward, for Hopper (sm_90a).
//
// The gradient of the forward kernel in ssd_scan.cu.  The TPU has no
// backward kernel for `ssd_scan_bhcsp` (src/repro/kernels/ssd_scan.py):
// JAX trains through the plain `ssd_chunked`, which XLA differentiates.
// Here the train step's forward is the kernel, so its gradient is one too.
//
// Per chunk (dropping b and h), with S0 the state at the chunk's start,
// dS1 the gradient reaching the state at its end, g = dy, e_i =
// exp(a_cum[i]), u_j = exp(a_cum[-1] - a_cum[j]) dt_j and
// M[i, j] = (C_i . B_j) exp(a_cum[i] - a_cum[j]) dt_j for i >= j:
//
//   y_i = sum_j M[i, j] x_j + e_i S0 C_i + D x_i
//   S1  = e_last S0 + sum_j u_j x_j (x) B_j
//
// so that
//
//   dx_j   = sum_i M[i, j] g_i + u_j dS1 B_j + D g_j
//   dC_i   = sum_j dM[i, j] L[i, j] dt_j B_j + e_i S0^T g_i
//   dB_j   = sum_i dM[i, j] L[i, j] dt_j C_i + u_j dS1^T x_j
//   dS0    = e_last dS1 + sum_i e_i g_i (x) C_i
//   da_cum, ddt, dA, dD from the same pieces,
//
// with dM[i, j] = g_i . x_j.  Two kernels:
//
// 1. ssd_bwd_state_kernel, one block per (b, h), loops over the chunks in
//    reverse and carries dS (P x N, f32, in registers: a 4 x 8 tile a
//    thread), writing dS1 of every chunk, (B, H, nc, P, N) f32.
// 2. ssd_bwd_chunk_kernel, one block per (b, h, chunk), all in parallel:
//    with S0 (saved by the forward) and dS1 it computes every gradient of
//    its chunk, the (s, s) matrices 32 key columns at a time, as the
//    forward does.  dB and dC come out per head, (B, H, L, N) f32, summed
//    over the heads afterwards by one ordered torch.sum; dA and dD per
//    (b, h, chunk).  A thread owns the same output elements in every
//    phase and accumulates them in place, so there are no atomics: the
//    gradient is the same bits on every run.
//
// Bound on this card: operations (in f32, the train step's type), about
// three times the forward's products (C B^T and g x^T for every column
// block, plus six (s, P, N) products), here on the CUDA cores.
#include "ssd_common.cuh"

namespace {

using namespace ssd;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_state_kernel(const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const T* __restrict__ Cm, const T* __restrict__ dy,
                         float* __restrict__ dsend, Strides sd, int H, int L,
                         int P, int N, int s) {
  extern __shared__ float smem[];
  const int PP = P + 1, NP = N + 1;
  float* gs = smem;          // (s, P) dy
  float* cs = gs + s * PP;   // (s, N)
  float* acum = cs + s * NP;
  float* dts = acum + s;
  float* ev = dts + s;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nc = L / s;
  const float Av = A[b * sd.a[0] + h * sd.a[1]];
  const float* dtb = dt + b * sd.dt[0] + h * sd.dt[1];
  const T* cmb = Cm + b * sd.cm[0];
  const T* dyb = dy + b * sd.y[0] + h * sd.y[1];
  float* out = dsend + ((long long)b * H + h) * nc * P * N;
  int pr[4], nk[8];
#pragma unroll
  for (int r = 0; r < 4; ++r) pr[r] = min(ty + 16 * r, P - 1);
#pragma unroll
  for (int k = 0; k < 8; ++k) nk[k] = min(tx + 16 * k, N - 1);

  float ds[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) ds[r][k] = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    float* o = out + c * (long long)P * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
      if (p >= P) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = tx + 16 * k;
        if (n < N) o[p * N + n] = ds[r][k];
      }
    }
    if (c == 0) break;
    const long long i0 = (long long)c * s;
    for (int i = tid; i < s; i += kThreads) dts[i] = dtb[(i0 + i) * sd.dt[2]];
    stage(dyb + i0 * sd.y[2], sd.y[2], s, P, gs, PP);
    stage(cmb + i0 * sd.cm[1], sd.cm[1], s, N, cs, NP);
    __syncthreads();
    chunk_cumsum(dts, Av, acum, s);
    __syncthreads();
    for (int i = tid; i < s; i += kThreads) ev[i] = expf(acum[i]);
    __syncthreads();
    const float elast = expf(acum[s - 1]);
    float t[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) t[r][k] = 0.f;
    for (int i = 0; i < s; ++i) {
      const float e = ev[i];
      float gv[4], cv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) gv[r] = gs[i * PP + pr[r]] * e;
#pragma unroll
      for (int k = 0; k < 8; ++k) cv[k] = cs[i * NP + nk[k]];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) t[r][k] = fmaf(gv[r], cv[k], t[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) ds[r][k] = elast * ds[r][k] + t[r][k];
    __syncthreads();  // before the next chunk's loads
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         const T* __restrict__ Cm, const float* __restrict__ D,
                         const T* __restrict__ dy,
                         const float* __restrict__ states,
                         const float* __restrict__ dsend, T* __restrict__ dx,
                         float* __restrict__ ddt, float* __restrict__ dbp,
                         float* __restrict__ dcp, float* __restrict__ dap,
                         float* __restrict__ ddp, Strides sd, int H, int L,
                         int P, int N, int s) {
  extern __shared__ float smem[];
  const int PP = P + 1, NP = N + 1;
  const int p2len = max(s * PP, P * NP);
  float* p1 = smem;            // x (phase 1), then dy
  float* p2 = p1 + s * PP;     // dS1, then S0, then x
  float* n1 = p2 + p2len;      // B
  float* n2 = n1 + s * NP;     // C
  float* wb = n2 + s * NP;     // (s, 32) block of an (s, s) matrix
  float* acum = wb + s * kWPitch;
  float* dts = acum + s;
  float* ev = dts + s;         // exp(a_cum)
  float* uv = ev + s;          // exp(a_cum[-1] - a_cum) * dt
  float* dac = uv + s;         // gradient of a_cum
  float* ddts = dac + s;       // direct gradient of dt
  float* du = ddts + s;
  float* colT = du + s;        // (16, 32) column partials
  float* colK = colT + 16 * kJB;
  float* red = colK + 16 * kJB;  // 32

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long i0 = (long long)c * s;
  const long long bhc = ((long long)b * H + h) * nc + c;
  const float Av = A[b * sd.a[0] + h * sd.a[1]];
  const float Dv = D[b * sd.d[0] + h * sd.d[1]];
  const T* xb = x + b * sd.x[0] + h * sd.x[1] + i0 * sd.x[2];
  const float* dtb = dt + b * sd.dt[0] + h * sd.dt[1];
  const T* bmb = Bm + b * sd.bm[0] + i0 * sd.bm[1];
  const T* cmb = Cm + b * sd.cm[0] + i0 * sd.cm[1];
  const T* dyb = dy + b * sd.y[0] + h * sd.y[1] + i0 * sd.y[2];
  T* dxb = dx + b * sd.dx[0] + h * sd.dx[1] + i0 * sd.dx[2];
  float* ddtb = ddt + b * sd.ddt[0] + h * sd.ddt[1];
  const float* S0 = states + bhc * P * N;
  const float* dS1 = dsend + bhc * P * N;
  // per-head partial dB, dC: rows of this chunk
  const long long prow = ((long long)b * H + h) * L + i0;
  float* dbc = dbp + prow * N;
  float* dcc = dcp + prow * N;

  int ic[8], pc[4], nk[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) ic[r] = min(ty + 16 * r, s - 1);
#pragma unroll
  for (int q = 0; q < 4; ++q) pc[q] = min(tx + 16 * q, P - 1);
#pragma unroll
  for (int k = 0; k < 8; ++k) nk[k] = min(tx + 16 * k, N - 1);

  // ---- phase 0: decays --------------------------------------------------
  for (int i = tid; i < s; i += kThreads) dts[i] = dtb[(i0 + i) * sd.dt[2]];
  __syncthreads();
  chunk_cumsum(dts, Av, acum, s);
  __syncthreads();
  const float alast = acum[s - 1];
  for (int i = tid; i < s; i += kThreads) {
    ev[i] = expf(acum[i]);
    uv[i] = expf(alast - acum[i]) * dts[i];
    dac[i] = 0.f;
    ddts[i] = 0.f;
  }

  // ---- phase 1: the end state's terms (x, B, dS1) ------------------------
  stage(xb, sd.x[2], s, P, p1, PP);
  stage(bmb, sd.bm[1], s, N, n1, NP);
  stage(dS1, (long long)N, P, N, p2, NP);
  __syncthreads();
  // dx_j = u_j dS1 B_j (rows j = ty + 16 r, columns p = tx + 16 q)
  float dxa[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) dxa[r][q] = 0.f;
  for (int n = 0; n < N; ++n) {
    float bv[8], sv[4];
#pragma unroll
    for (int r = 0; r < 8; ++r) bv[r] = n1[ic[r] * NP + n];
#pragma unroll
    for (int q = 0; q < 4; ++q) sv[q] = p2[pc[q] * NP + n];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) dxa[r][q] = fmaf(bv[r], sv[q], dxa[r][q]);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float u = uv[ic[r]];
#pragma unroll
    for (int q = 0; q < 4; ++q) dxa[r][q] *= u;
  }
  // (x dS1)[j, n]: dB_j = u_j (x dS1)[j], du_j = (x dS1)[j] . B_j; columns
  // n = tx + 16 k in two halves of four
  float rowacc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) rowacc[r] = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float t[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) t[r][k] = 0.f;
    for (int p = 0; p < P; ++p) {
      float xv[8], sv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) xv[r] = p1[ic[r] * PP + p];
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = p2[p * NP + nk[4 * half + k]];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) t[r][k] = fmaf(xv[r], sv[k], t[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= s) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = tx + 16 * (4 * half + k);
        if (n >= N) continue;
        dbc[i * (long long)N + n] = uv[i] * t[r][k];
        rowacc[r] = fmaf(t[r][k], n1[i * NP + n], rowacc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float v = half_warp_sum(rowacc[r]);
    const int i = ty + 16 * r;
    if (tx == 0 && i < s) du[i] = v;
  }
  __syncthreads();
  if (tid == 0) {
    float last = 0.f;
    for (int j = 0; j < s; ++j) {
      const float duu = du[j] * uv[j];
      dac[j] -= duu;
      last += duu;
      ddts[j] += du[j] * expf(alast - acum[j]);
    }
    dac[s - 1] += last;
  }
  __syncthreads();

  // ---- phase 2: the start state's terms (dy, C, S0) ----------------------
  stage(dyb, sd.y[2], s, P, p1, PP);
  stage(cmb, sd.cm[1], s, N, n2, NP);
  stage(S0, (long long)N, P, N, p2, NP);
  __syncthreads();
  // dC_i = e_i S0^T g_i; da_cum[i] += dC_i . C_i
#pragma unroll
  for (int r = 0; r < 8; ++r) rowacc[r] = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float t[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) t[r][k] = 0.f;
    for (int p = 0; p < P; ++p) {
      float gv[8], sv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) gv[r] = p1[ic[r] * PP + p];
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = p2[p * NP + nk[4 * half + k]];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) t[r][k] = fmaf(gv[r], sv[k], t[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= s) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = tx + 16 * (4 * half + k);
        if (n >= N) continue;
        const float v = ev[i] * t[r][k];
        dcc[i * (long long)N + n] = v;
        rowacc[r] = fmaf(v, n2[i * NP + n], rowacc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float v = half_warp_sum(rowacc[r]);
    const int i = ty + 16 * r;
    if (tx == 0 && i < s) dac[i] += v;
  }
  // dx_j += D g_j
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dxa[r][q] = fmaf(Dv, p1[ic[r] * PP + pc[q]], dxa[r][q]);
  // da_cum[-1] += e_last <dS1, S0>
  float part = 0.f;
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx - p * N;
    part = fmaf(dS1[idx], p2[p * NP + n], part);
  }
  const float dot = block_sum(part, red);
  if (tid == 0) dac[s - 1] += expf(alast) * dot;
  __syncthreads();

  // ---- phase 3: the in-chunk terms (x, dy, B, C) -------------------------
  stage(xb, sd.x[2], s, P, p2, PP);
  __syncthreads();
  part = 0.f;
  for (int idx = tid; idx < s * P; idx += kThreads) {
    const int i = idx / P, p = idx - i * P;
    part = fmaf(p1[i * PP + p], p2[i * PP + p], part);
  }
  const float dD = block_sum(part, red);

#pragma unroll
  for (int jb = 0; jb < kMaxS / kJB; ++jb) {
    const int j0 = jb * kJB;
    if (j0 >= s) break;
    int jc[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) jc[k] = min(j0 + tx + 16 * k, s - 1);
    // C B^T and dM = g x^T on this thread's 8 x 2 entries
    float cb[8][2], dm[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k) cb[r][k] = dm[r][k] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float b0 = n1[jc[0] * NP + n], b1 = n1[jc[1] * NP + n];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (16 * r + 15 < j0 || 16 * r >= s) continue;
        const float cv = n2[ic[r] * NP + n];
        cb[r][0] = fmaf(cv, b0, cb[r][0]);
        cb[r][1] = fmaf(cv, b1, cb[r][1]);
      }
    }
    for (int p = 0; p < P; ++p) {
      const float x0 = p2[jc[0] * PP + p], x1 = p2[jc[1] * PP + p];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (16 * r + 15 < j0 || 16 * r >= s) continue;
        const float gv = p1[ic[r] * PP + p];
        dm[r][0] = fmaf(gv, x0, dm[r][0]);
        dm[r][1] = fmaf(gv, x1, dm[r][1]);
      }
    }
    // M, dCB = dM L dt, and the a_cum / dt gradients of the decays
    float mm[8][2], dcb[8][2], rowT[8], colT_[2] = {0.f, 0.f},
        colK_[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      rowT[r] = 0.f;
      const int i = ty + 16 * r;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = j0 + tx + 16 * k;
        mm[r][k] = dcb[r][k] = 0.f;
        if (16 * r + 15 < j0 || i >= s || j >= s || i < j) continue;
        const float lm = expf(acum[i] - acum[j]);
        const float kk = cb[r][k] * lm;
        const float m = kk * dts[j];
        const float tt = dm[r][k] * m;
        mm[r][k] = m;
        dcb[r][k] = dm[r][k] * lm * dts[j];
        rowT[r] += tt;
        colT_[k] += tt;
        colK_[k] = fmaf(dm[r][k], kk, colK_[k]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float v = half_warp_sum(rowT[r]);
      const int i = ty + 16 * r;
      if (tx == 0 && i < s) dac[i] += v;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      colT[ty * kJB + tx + 16 * k] = colT_[k];
      colK[ty * kJB + tx + 16 * k] = colK_[k];
    }
    __syncthreads();  // also: the previous column block's wb reads are done
    if (tid < kJB && j0 + tid < s) {
      float a = 0.f, kd = 0.f;
      for (int t = 0; t < 16; ++t) {
        a += colT[t * kJB + tid];
        kd += colK[t * kJB + tid];
      }
      dac[j0 + tid] -= a;
      ddts[j0 + tid] += kd;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (16 * r + 15 < j0 || i >= s) continue;
#pragma unroll
      for (int k = 0; k < 2; ++k) wb[i * kWPitch + tx + 16 * k] = mm[r][k];
    }
    __syncthreads();
    // dx_j += sum_i M[i, j] g_i for this block's rows j = j0 + ty + 16 rr,
    // which are rows 2 jb + rr of this thread's dx tile
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      for (int i = j0; i < s; ++i) {
        const float w = wb[i * kWPitch + ty + 16 * rr];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dxa[2 * jb + rr][q] = fmaf(w, p1[i * PP + pc[q]],
                                     dxa[2 * jb + rr][q]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (16 * r + 15 < j0 || i >= s) continue;
#pragma unroll
      for (int k = 0; k < 2; ++k) wb[i * kWPitch + tx + 16 * k] = dcb[r][k];
    }
    __syncthreads();
    // dC_i += sum_j dCB[i, j] B_j (rows i, columns n in two halves)
    const int jn = min(kJB, s - j0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float t[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) t[r][k] = 0.f;
      for (int jj = 0; jj < jn; ++jj) {
        float bv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = n1[(j0 + jj) * NP + nk[4 * half + k]];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (16 * r + 15 < j0 || 16 * r >= s) continue;
          const float w = wb[ic[r] * kWPitch + jj];
#pragma unroll
          for (int k = 0; k < 4; ++k) t[r][k] = fmaf(w, bv[k], t[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        if (16 * r + 15 < j0 || i >= s) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int n = tx + 16 * (4 * half + k);
          if (n < N) dcc[i * (long long)N + n] += t[r][k];
        }
      }
    }
    // dB_j += sum_i dCB[i, j] C_i (rows j = j0 + ty + 16 rr, columns
    // n = tx + 16 k: the entries this thread wrote in phase 1)
    float t2[2][8];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int k = 0; k < 8; ++k) t2[rr][k] = 0.f;
    for (int i = j0; i < s; ++i) {
      float cv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) cv[k] = n2[i * NP + nk[k]];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float w = wb[i * kWPitch + ty + 16 * rr];
#pragma unroll
        for (int k = 0; k < 8; ++k) t2[rr][k] = fmaf(w, cv[k], t2[rr][k]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = j0 + ty + 16 * rr;
      if (j >= s) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = tx + 16 * k;
        if (n < N) dbc[j * (long long)N + n] += t2[rr][k];
      }
    }
  }

  // ---- phase 4: dx, then a_cum -> dt, A ----------------------------------
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    if (i >= s) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = tx + 16 * q;
      if (p < P) dxb[i * sd.dx[2] + p] = from_f32<T>(dxa[r][q]);
    }
  }
  __syncthreads();
  if (tid == 0) {
    // a_cum[i] = sum_{k <= i} dt_k A: da_k = sum_{i >= k} da_cum[i]
    float run = 0.f, dA = 0.f;
    for (int k = s - 1; k >= 0; --k) {
      run += dac[k];
      ddtb[(i0 + k) * sd.ddt[2]] = ddts[k] + run * Av;
      dA = fmaf(run, dts[k], dA);
    }
    dap[bhc] = dA;
    ddp[bhc] = dD;
  }
}

size_t chunk_smem(int P, int N, int s) {
  const size_t sp = (size_t)s * (P + 1), pn = (size_t)P * (N + 1);
  return sizeof(float) * (sp + (sp > pn ? sp : pn) + 2 * (size_t)s * (N + 1) +
                          (size_t)s * kWPitch + 7 * (size_t)s + 32 * kJB + 32);
}

template <typename T>
int launch_bwd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* D, const void* dy,
               const void* states, void* dsend, void* dx, void* ddt,
               void* dbp, void* dcp, void* dap, void* ddp, const Strides& sd,
               int B, int H, int L, int P, int N, int s,
               cudaStream_t stream) {
  const int nc = L / s;
  const size_t smem1 = sizeof(float) * ((size_t)s * (P + 1) +
                                        (size_t)s * (N + 1) + 3 * (size_t)s);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_state_kernel<T><<<dim3(H, B), kThreads, smem1, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Cm), static_cast<const T*>(dy),
      static_cast<float*>(dsend), sd, H, L, P, N, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem2 = chunk_smem(P, N, s);
  e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem2);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk_kernel<T><<<dim3(nc, H, B), kThreads, smem2, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const T*>(dy), static_cast<const float*>(states),
      static_cast<const float*>(dsend), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dbp),
      static_cast<float*>(dcp), static_cast<float*>(dap),
      static_cast<float*>(ddp), sd, H, L, P, N, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Gradients of ssd_scan_fwd_launch.  x, dy, dx (B, H, L, P), Bm/Cm (B, L,
// N) in one type (bf16 when bf16 != 0, else f32); dt, ddt (B, H, L) and
// A/D (B, H) f32; all through strides[23] (ssd::Strides, the y entries
// being dy's).  states: the forward's (B, H, L / s, P, N) f32 chunk-start
// states; dsend: scratch of the same shape.  Outputs, f32 and contiguous:
// dbp, dcp (B, H, L, N) per-head partials of dBm, dCm; dap, ddp (B, H,
// L / s) per-chunk partials of dA, dD.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, const void* D,
                                   const void* dy, const void* states,
                                   void* dsend, void* dx, void* ddt,
                                   void* dbp, void* dcp, void* dap, void* ddp,
                                   const long long* strides, int B, int H,
                                   int L, int P, int N, int s, int bf16,
                                   void* stream) {
  if (B == 0 || H == 0 || L == 0) return 0;
  const Strides sd = strides_from(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(x, dt, A, Bm, Cm, D, dy, states,
                                          dsend, dx, ddt, dbp, dcp, dap, ddp,
                                          sd, B, H, L, P, N, s, st)
              : launch_bwd<float>(x, dt, A, Bm, Cm, D, dy, states, dsend, dx,
                                  ddt, dbp, dcp, dap, ddp, sd, B, H, L, P, N,
                                  s, st);
}
