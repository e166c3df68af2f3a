// Single-token SSD state update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssm_update_kernel` /
// `ssm_state_update_bh` in src/repro/kernels/ssm_update.py: for every
// (batch row b, head h)
//
//   state' = exp(dt * A) * state + (dt * x) (x) B      (P x N, f32)
//   y      = state' . C + D * x                         (P, f32)
//
// with every input cast to f32 first, as the Pallas body does.
//
// Design.  Grid (H, B), one block of 256 threads per (b, h); B and C are
// staged in shared memory as f32.  Each warp owns rows p = warp, warp + 8,
// ...; its 32 lanes stream a row of the state (lane n, n + 32, ...: 128
// contiguous bytes a warp per load), write the updated row and reduce
// state' . C with shuffles.  The state is read through (b, h, p) strides,
// so the state cache's per-layer slice is taken as it lies.
//
// Bound on this card: bytes.  The f32 state is read once and written
// once (2 * 4 * P * N bytes a (b, h)) against 4 flops an element; the
// kernel does nothing but stream it, coalesced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct UpdateStrides {
  long long st_b, st_h, st_p;  // state (B, H, P, N), unit N
  long long x_b, x_h;          // x (B, H, P), unit P
  long long dt_b, dt_h, a_b, a_h, d_b, d_h;  // (B, H) f32
  long long bm_b, cm_b;        // Bm, Cm (B, N), unit N
};

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssm_update_kernel(const float* __restrict__ state,
                      const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ D,
                      float* __restrict__ y, float* __restrict__ out,
                      UpdateStrides s, int H, int P, int N) {
  extern __shared__ float smem[];
  float* bs = smem;      // (N,)
  float* cs = smem + N;  // (N,)
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int n = tid; n < N; n += kThreads) {
    bs[n] = to_f32(Bm[b * s.bm_b + n]);
    cs[n] = to_f32(Cm[b * s.cm_b + n]);
  }
  const float dtv = dt[b * s.dt_b + h * s.dt_h];
  const float av = A[b * s.a_b + h * s.a_h];
  const float dv = D[b * s.d_b + h * s.d_h];
  const float decay = expf(dtv * av);
  __syncthreads();
  const float* st = state + b * s.st_b + h * s.st_h;
  const T* xr = x + b * s.x_b + h * s.x_h;
  const long long bh = (long long)b * H + h;
  for (int p = warp; p < P; p += kThreads / 32) {
    const float xv = to_f32(xr[p]);
    const float u = dtv * xv;
    const float* row = st + p * s.st_p;
    float* orow = out + (bh * P + p) * N;
    float acc = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float v = row[n] * decay + u * bs[n];
      orow[n] = v;
      acc += v * cs[n];
    }
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) y[bh * P + p] = acc + dv * xv;
  }
}

}  // namespace

// state (B, H, P, N) f32 through strides; x (B, H, P) and Bm/Cm (B, N) in
// one type (bf16 when bf16 != 0, else f32); dt/A/D (B, H) f32 through
// strides; outputs y (B, H, P) and out (B, H, P, N) f32, contiguous.
// strides[13]: state (b, h, p), x (b, h), dt (b, h), A (b, h), D (b, h),
// Bm (b), Cm (b).
extern "C" int ssm_state_update_launch(const void* state, const void* x,
                                       const void* dt, const void* A,
                                       const void* Bm, const void* Cm,
                                       const void* D, void* y, void* out,
                                       const long long* strides, int B, int H,
                                       int P, int N, int bf16, void* stream) {
  if (B == 0 || H == 0 || P == 0) return 0;
  UpdateStrides s;
  const long long* v = strides;
  s.st_b = v[0]; s.st_h = v[1]; s.st_p = v[2];
  s.x_b = v[3]; s.x_h = v[4];
  s.dt_b = v[5]; s.dt_h = v[6];
  s.a_b = v[7]; s.a_h = v[8];
  s.d_b = v[9]; s.d_h = v[10];
  s.bm_b = v[11]; s.cm_b = v[12];
  const dim3 grid(H, B);
  const size_t smem = 2 * sizeof(float) * (size_t)N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(state);
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);
  const float* dp = static_cast<const float*>(D);
  float* yp = static_cast<float*>(y);
  float* op = static_cast<float*>(out);
  if (bf16) {
    ssm_update_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        sp, static_cast<const __nv_bfloat16*>(x), dtp, ap,
        static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(Cm), dp, yp, op, s, H, P, N);
  } else {
    ssm_update_kernel<float><<<grid, kThreads, smem, st>>>(
        sp, static_cast<const float*>(x), dtp, ap,
        static_cast<const float*>(Bm), static_cast<const float*>(Cm), dp, yp,
        op, s, H, P, N);
  }
  return (int)cudaGetLastError();
}
