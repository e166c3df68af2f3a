// Flash-attention backward kernels for Hopper (sm_90a).
//
// The JAX package has no Pallas backward for `flash_attention_bhsd`
// (src/repro/kernels/flash_attention.py): JAX trains through XLA's
// attention.  The port's forward is a hand-written kernel with no autograd
// of its own, so its gradient is a kernel too, in the FlashAttention-2
// scheme, as three launches on one stream:
//
//   1. delta = rowsum(dO * O)                 one warp per (b, h, row)
//   2. dK, dV per (b, kv head, 64-key tile)   grid (ceil(S/64), KV, B)
//   3. dQ per (b, h, 64-query tile)           grid (ceil(S/64), H, B)
//
// Both 2 and 3 rebuild P = exp(s * scale - lse) from the forward's f32
// row log-sum-exp, so the scale and the mask are the forward's own, and
// dS = P * (dP - delta) with dP = dO V^T.  Launch 2 sums over the
// G = H / KV query heads of its KV head and over the query tiles the mask
// lets through, so dK and dV need no atomics; launch 3 walks the key tiles
// as the forward does.  Tiles fully outside the causal or window mask are
// skipped in both.  Each thread owns a 4 x 4 micro-tile of the 64 x 64
// score tile and a 4 x ceil(D / 16) slice of its f32 accumulators; tiles
// are staged in shared memory as f32 with rows padded by one float.
//
// Bound on this card: operations.  The least work is five products of
// 2 * D flops per live (query, key) pair (S, dP, dV, dK, dQ), 2.5 times
// the forward; launch 3 recomputes S and dP (seven products in all).  The
// products run on the CUDA cores in f32 in this first version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPp = kBK + 1;  // padded row of a score tile

struct Strides {
  long long b, h, s;
};

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
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           long long ss, int r0, int n,
                                           int S, int D, int Dp,
                                           float* dst) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    dst[r * Dp + d] =
        (r0 + r < S) ? to_f32(src[(long long)(r0 + r) * ss + d]) : 0.f;
  }
}

__device__ __forceinline__ bool allowed(int qi, int kj, int S, int causal,
                                        int window) {
  bool ok = qi < S && kj < S;
  if (causal) ok = ok && kj <= qi;
  if (window > 0) ok = ok && kj > qi - window;
  return ok;
}

// s = Q K^T and dp = dO V^T for the thread's 4 x 4 micro-tile
__device__ __forceinline__ void score_tiles(const float* q_s,
                                            const float* do_s,
                                            const float* k_s,
                                            const float* v_s, int D, int Dp,
                                            int tx, int ty, float s[4][4],
                                            float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float qa[4], da[4], ka[4], va[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = q_s[(ty + 16 * i) * Dp + d];
      da[i] = do_s[(ty + 16 * i) * Dp + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ka[j] = k_s[(tx + 16 * j) * Dp + d];
      va[j] = v_s[(tx + 16 * j) * Dp + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        dp[i][j] = fmaf(da[i], va[j], dp[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O), f32
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, Strides so, Strides sdo, int H, int S, int D,
    long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int s = (int)(row % S);
  const int h = (int)((row / S) % H);
  const long long b = row / ((long long)S * H);
  const T* orow = o + b * so.b + h * so.h + s * so.s;
  const T* drow = dout + b * sdo.b + h * sdo.h + s * sdo.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f32(orow[d]) * to_f32(drow[d]);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK, dV per (b, kv head, key tile)
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int KV, int S,
    int D, int causal, int window, float scale) {
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int Dp = D + 1;

  extern __shared__ float smem[];
  float* k_s = smem;                // kBK x Dp
  float* v_s = k_s + kBK * Dp;      // kBK x Dp
  float* q_s = v_s + kBK * Dp;      // kBQ x Dp
  float* do_s = q_s + kBQ * Dp;     // kBQ x Dp
  float* p_s = do_s + kBQ * Dp;     // kBQ x kPp
  float* ds_s = p_s + kBQ * kPp;    // kBQ x kPp
  float* lse_s = ds_s + kBQ * kPp;  // kBQ
  float* dl_s = lse_s + kBQ;        // kBQ

  stage_rows(k + b * sk.b + kvh * sk.h, sk.s, k0, kBK, S, D, Dp, k_s);
  stage_rows(v + b * sv.b + kvh * sv.h, sv.s, k0, kBK, S, D, Dp, v_s);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // query tiles that may see this key tile: q >= k (causal) and
  // q < k + window (window)
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + kBK - 1 + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* dob = dout + b * sdo.b + h * sdo.h;
    const float* lse_b = lse + ((long long)b * H + h) * S;
    const float* dl_b = delta + ((long long)b * H + h) * S;
    for (int q0 = (q_begin / kBQ) * kBQ; q0 < q_end; q0 += kBQ) {
      __syncthreads();  // the previous query tile is fully consumed
      stage_rows(qb, sq.s, q0, kBQ, S, D, Dp, q_s);
      stage_rows(dob, sdo.s, q0, kBQ, S, D, Dp, do_s);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        lse_s[r] = q0 + r < S ? lse_b[q0 + r] : 0.f;
        dl_s[r] = q0 + r < S ? dl_b[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      score_tiles(q_s, do_s, k_s, v_s, D, Dp, tx, ty, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = allowed(q0 + r, k0 + c, S, causal, window)
                              ? expf(s[i][j] * scale - lse_s[r])
                              : 0.f;
          p_s[r * kPp + c] = p;
          ds_s[r * kPp + c] = p * (dp[i][j] - dl_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's query rows; the
      // thread owns key rows ty + 16 i and columns tx + 16 c
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pa[4], da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = p_s[r * kPp + ty + 16 * i];
          da[i] = ds_s[r * kPp + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = tx + 16 * c;
          const float dov = d < D ? do_s[r * Dp + d] : 0.f;
          const float qv = d < D ? q_s[r * Dp + d] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(pa[i], dov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(da[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * sdk.b + kvh * sdk.h;
  T* dvb = dv + b * sdv.b + kvh * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d >= D) continue;
      dkb[(long long)kj * sdk.s + d] = from_f32<T>(dk_acc[i][c] * scale);
      dvb[(long long)kj * sdv.s + d] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ per (b, h, query tile)
// ---------------------------------------------------------------------------
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
    Strides sdq, int H, int KV, int S, int D, int causal, int window,
    float scale) {
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int Dp = D + 1;

  extern __shared__ float smem[];
  float* q_s = smem;              // kBQ x Dp
  float* do_s = q_s + kBQ * Dp;   // kBQ x Dp
  float* k_s = do_s + kBQ * Dp;   // kBK x Dp
  float* v_s = k_s + kBK * Dp;    // kBK x Dp
  float* ds_s = v_s + kBK * Dp;   // kBQ x kPp

  stage_rows(q + b * sq.b + h * sq.h, sq.s, q0, kBQ, S, D, Dp, q_s);
  stage_rows(dout + b * sdo.b + h * sdo.h, sdo.s, q0, kBQ, S, D, Dp, do_s);
  const float* lse_b = lse + ((long long)b * H + h) * S;
  const float* dl_b = delta + ((long long)b * H + h) * S;
  float lse_r[4], dl_r[4], dq_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    lse_r[i] = qi < S ? lse_b[qi] : 0.f;
    dl_r[i] = qi < S ? dl_b[qi] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;
  }

  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = (k_end + kBK - 1) / kBK;
  for (int t = k_begin / kBK; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();
    stage_rows(kb, sk.s, k0, kBK, S, D, Dp, k_s);
    stage_rows(vb, sv.s, k0, kBK, S, D, Dp, v_s);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles(q_s, do_s, k_s, v_s, D, Dp, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = allowed(q0 + r, k0 + c, S, causal, window)
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.f;
        ds_s[r * kPp + c] = p * (dp[i][j] - dl_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = ds_s[(ty + 16 * i) * kPp + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        const float kv = d < D ? k_s[kk * Dp + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][c] = fmaf(da[i], kv, dq_acc[i][c]);
      }
    }
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dqb[(long long)qi * sdq.s + d] = from_f32<T>(dq_acc[i][c] * scale);
    }
  }
}

size_t dkdv_smem_bytes(int D) {
  return sizeof(float) * ((size_t)(2 * kBK + 2 * kBQ) * (D + 1) +
                          2 * (size_t)kBQ * kPp + 2 * kBQ);
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)(2 * kBQ + 2 * kBK) * (D + 1) + (size_t)kBQ * kPp);
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv,
                   const long long* st, int B, int H, int KV, int S, int D,
                   int causal, int window, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]}, sdq{st[15], st[16], st[17]},
      sdk{st[18], st[19], st[20]}, sdv{st[21], st[22], st[23]};
  const float scale = 1.0f / sqrtf((float)D);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const long long rows = (long long)B * H * S;
  const int warps = kThreads / 32;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps),
                              kThreads, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, so, sdo, H, S, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, NC>;
  const size_t b2 = dkdv_smem_bytes(D);
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)b2);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((S + kBK - 1) / kBK, KV, B), kThreads, b2, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, sv, sdo, sdk, sdv, H, KV, S, D, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, NC>;
  const size_t b3 = dq_smem_bytes(D);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)b3);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, b3, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), sq, sk, sv, sdo, sdq,
      H, KV, S, D, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv,
                     const long long* st, int B, int H, int KV, int S, int D,
                     int causal, int window, cudaStream_t stream) {
  if (D <= 16)
    return launch<T, 1>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H,
                        KV, S, D, causal, window, stream);
  if (D <= 32)
    return launch<T, 2>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H,
                        KV, S, D, causal, window, stream);
  if (D <= 64)
    return launch<T, 4>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H,
                        KV, S, D, causal, window, stream);
  return launch<T, 8>(q, k, v, o, dout, lse, delta, dq, dk, dv, st, B, H, KV,
                      S, D, causal, window, stream);
}

}  // namespace

// q/o/dout/dq (B, H, S, D) and k/v/dk/dv (B, KV, S, D), all of one type,
// views with a unit stride on D and the (b, head, s) element strides in
// `strides` (24 int64: q, k, v, o, dout, dq, dk, dv); lse (B, H, S) f32
// from the forward; delta (B, H, S) f32 scratch.  D <= 128, H % KV == 0.
// Returns the first CUDA error of the three launches, else 0.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int KV, int S, int D,
    int causal, int window, int bf16, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (D < 1 || D > 128 || KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv,
                                   strides, B, H, KV, S, D, causal, window,
                                   st);
  return dispatch<float>(q, k, v, o, dout, l, dl, dq, dk, dv, strides, B, H,
                         KV, S, D, causal, window, st);
}
