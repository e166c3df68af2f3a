// Flash-attention forward kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_bhsd`
// in src/repro/kernels/flash_attention.py: blocked online-softmax
// attention over (B, H, S, D) queries and (B, KV, S, D) keys/values, GQA
// through `kv = h / (H / KV)` (K/V are never replicated), causal and
// sliding-window masks.  Besides the output it writes the f32 row
// log-sum-exp of the scaled scores, (B, H, S), which the backward kernel
// (flash_attention_bwd.cu) needs to rebuild the probabilities.
//
// Design.  Grid (ceil(S / 64), H, B): one block of 256 threads per 64-row
// query tile of one head.  The TPU kernel carries (m, l, acc) across a
// sequential grid axis in VMEM scratch; here one block loops over the K/V
// tiles itself and keeps the running state in registers.  Each thread owns
// a 4 x 4 micro-tile of the 64 x 64 score tile (rows ty + 16 i, columns
// tx + 16 j) and a 4 x ceil(D / 16) slice of the output accumulator, all in
// f32; the Q, K and V tiles are staged in shared memory as f32, rows padded
// by one float so the column reads are free of bank conflicts.  The 16
// threads of a row sit in one half-warp, so the row max and sum are two
// shuffle reductions.  K/V tiles that the causal or window mask hides from
// every row of the query tile are skipped; the TPU kernel visits them and
// masks them, which gives the same result because every row meets its
// diagonal key before it finalises.  Unlike the TPU kernel (which asserts
// S % block == 0), any S is taken: rows and keys past S are zero-filled on
// load and masked.
//
// The mask value is -1e30, not -inf, as on the TPU: a row whose first tile
// is fully masked takes p = exp(0) = 1 there, and the first live tile's
// alpha = exp(-1e30 - m) = 0 wipes that out.  Out-of-range K/V rows are
// loaded as zeros, so that transient contribution is always finite.
//
// Bound on this card: operations.  4 * D flops per live (query, key) pair
// against 2 * D * bytes per element of Q/K/V/O traffic.  This first version
// runs the products on the CUDA cores in f32 (shared-memory bound, about
// two loads per FMA pair); the tensor-core (mma / wgmma) version is the
// known next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each

struct Strides {  // element strides of a (B, heads, S, D) view; D is unit
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
  return __float2bfloat16(x);  // round to nearest even, like a torch cast
}

// reductions over the 16 lanes of a half-warp (one score row)
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [r0, r0 + n) of one head's (S, D) slab into dst (rows of Dp floats);
// rows at or past S are zero
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
  bool ok = kj < S;
  if (causal) ok = ok && kj <= qi;
  if (window > 0) ok = ok && kj > qi - window;
  return ok;
}

template <typename T, int NC>  // NC = ceil(D / 16) output columns a thread
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    Strides sq, Strides sk, Strides sv, Strides so, int H, int KV, int S,
    int D, int causal, int window, float scale) {
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int Dp = D + 1;
  constexpr int kPp = kBK + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                  // kBQ x Dp
  float* k_s = q_s + kBQ * Dp;        // kBK x Dp
  float* v_s = k_s + kBK * Dp;        // kBK x Dp
  float* p_s = v_s + kBK * Dp;        // kBQ x kPp

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  stage_rows(qb, sq.s, q0, kBQ, S, D, Dp, q_s);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // K/V tiles that some row of this query tile may see
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = (k_end + kBK - 1) / kBK;
  for (int t = k_begin / kBK; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is fully consumed
    stage_rows(kb, sk.s, k0, kBK, S, D, Dp, k_s);
    stage_rows(vb, sv.s, k0, kBK, S, D, Dp, v_s);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty + 16 * i) * Dp + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = k_s[(tx + 16 * j) * Dp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        s[i][j] = allowed(qi, kj, S, causal, window) ? s[i][j] * scale
                                                      : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mc));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(ty + 16 * i) * kPp + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V over the tile's keys
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(ty + 16 * i) * kPp + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < D ? v_s[kk * Dp + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) ob[(long long)qi * so.s + d] = from_f32<T>(acc[i][c] / li);
    }
    if (tx == 0) lse[((long long)b * H + h) * S + qi] = m[i] + logf(li);
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (D + 1) + (size_t)kBQ * (kBK + 1));
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const long long* st, int B, int H, int KV,
                   int S, int D, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, NC>;
  const size_t bytes = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, sv, so, H,
      KV, S, D, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, const long long* st, int B, int H, int KV,
                     int S, int D, int causal, int window,
                     cudaStream_t stream) {
  if (D <= 16)
    return launch<T, 1>(q, k, v, o, lse, st, B, H, KV, S, D, causal, window,
                        stream);
  if (D <= 32)
    return launch<T, 2>(q, k, v, o, lse, st, B, H, KV, S, D, causal, window,
                        stream);
  if (D <= 64)
    return launch<T, 4>(q, k, v, o, lse, st, B, H, KV, S, D, causal, window,
                        stream);
  return launch<T, 8>(q, k, v, o, lse, st, B, H, KV, S, D, causal, window,
                      stream);
}

}  // namespace

// q (B, H, S, D), k/v (B, KV, S, D), o like q, all of one type, each a view
// with a unit stride on D and the (b, head, s) element strides given in
// `strides` (12 int64: q, k, v, o); lse (B, H, S) f32 contiguous.
// D <= 128, H % KV == 0.  `bf16` selects bf16 (1) or f32 (0).  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, int B, int H, int KV, int S, int D, int causal,
    int window, int bf16, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (D < 1 || D > 128 || KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, l, strides, B, H, KV, S, D,
                                   causal, window, st);
  return dispatch<float>(q, k, v, o, l, strides, B, H, KV, S, D, causal,
                         window, st);
}
