// Paged-attention decode kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` / `paged_attention_bhd`
// in src/repro/kernels/paged_attention.py.  One query token per sequence
// attends over a (P, page, KV, D) page pool addressed through per-request
// block tables; the G = H / KV query heads of one KV head share each
// staged K/V tile.
//
// Design.  Grid (B, KV): one block per sequence and KV head.  CUDA has no
// scalar prefetch, so the block reads its own block-table row and context
// length.  It walks only the pages below ceil(ctx / page) (the TPU kernel
// visits all nb pages and masks the ones past the context; stopping early
// gives the same result).  Pages are staged a tile at a time (up to
// `pages_per_tile` pages, 64 tokens) in shared memory as f32, with 16-byte
// loads issued in batches so a thread waits on memory once per batch and
// not once per element; the G x tile scores are computed in f32, one warp
// per query row reduces the online-softmax statistics, and a running
// (m, l, acc) carries across tiles.  -1e30 stays the mask (not -inf), a
// fully masked row keeps p = 0, and an empty context (ctx == 0) writes
// zeros, so the trash page 0 never leaks into the result.
//
// Bound on this card: bytes.  Each launch must read ctx * KV * D K and V
// elements per sequence; the 2 * G * D flops per K/V element pair are far
// below the card's ~295 flops/byte balance point.  The (B, KV) grid fills
// only B * KV SMs (32 of 132 at B = 8 on yi-9b) and one block walks its
// whole context, so a long context is latency-bound in one SM; split-K
// over the context (flash-decoding) is the known next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread and array

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

// Shared-memory floats a block needs for a tile of `tile` tokens.
__host__ __device__ inline size_t smem_floats(int G, int D, int tile) {
  return (size_t)tile * (D + 1)   // K tile, rows padded by one float
         + (size_t)tile * D       // V tile
         + 2 * (size_t)G * D      // q rows, accumulator
         + (size_t)G * tile       // scores / probabilities
         + 3 * (size_t)G;         // running max, running sum, rescale
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage tokens [0, nt) of the tile (pages j0.. of sequence b, head kv)
// into k_s (rows padded to Dp) and v_s as f32.
template <typename TKV>
__device__ __forceinline__ void stage_tile(
    const TKV* __restrict__ k_pages, const TKV* __restrict__ v_pages,
    const int* __restrict__ table, int j0, int nt, int page, int KV, int D,
    int kv, float* k_s, float* v_s) {
  constexpr int kVec = 16 / sizeof(TKV);  // elements per 16-byte load
  union Chunk {
    uint4 u;
    TKV e[kVec];
  };
  const int per_row = D / kVec;
  const int n = nt * per_row;
  const int Dp = D + 1;
  for (int c0 = threadIdx.x; c0 < n; c0 += kThreads * kUnroll) {
    Chunk kc[kUnroll], vc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      if (c < n) {
        const int t = c / per_row;
        const int d = (c - t * per_row) * kVec;
        const int pid = table[j0 + t / page];
        const size_t off =
            (((size_t)pid * page + (t % page)) * KV + kv) * D + d;
        kc[u].u = *reinterpret_cast<const uint4*>(k_pages + off);
        vc[u].u = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      if (c < n) {
        const int t = c / per_row;
        const int d = (c - t * per_row) * kVec;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          k_s[t * Dp + d + i] = to_f32(kc[u].e[i]);
          v_s[t * D + d + i] = to_f32(vc[u].e[i]);
        }
      }
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q,          // (B, H, D)
    const TKV* __restrict__ k_pages,   // (P, page, KV, D)
    const TKV* __restrict__ v_pages,   // (P, page, KV, D)
    const int* __restrict__ tables,    // (B, nb)
    const int* __restrict__ lens,      // (B,)
    TQ* __restrict__ out,              // (B, H, D)
    int H, int KV, int D, int page, int nb, int pages_per_tile,
    float scale) {
  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = H / KV;
  const int Dp = D + 1;  // padded K rows: column reads are bank-conflict free
  const int tile = pages_per_tile * page;

  extern __shared__ float smem[];
  float* k_s = smem;                     // tile * Dp
  float* v_s = k_s + (size_t)tile * Dp;  // tile * D
  float* q_s = v_s + (size_t)tile * D;   // G * D
  float* acc = q_s + (size_t)G * D;      // G * D
  float* s_s = acc + (size_t)G * D;      // G * tile
  float* m_s = s_s + (size_t)G * tile;   // G
  float* l_s = m_s + G;                  // G
  float* a_s = l_s + G;                  // G

  const int ctx = lens[b];
  const int n_pages = ctx > 0 ? min((ctx + page - 1) / page, nb) : 0;
  const int* table = tables + (size_t)b * nb;

  // this KV head's query group: heads kv * G .. kv * G + G - 1
  const size_t row0 = ((size_t)b * H + (size_t)kv * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    q_s[e] = to_f32(q[row0 + e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  for (int j0 = 0; j0 < n_pages; j0 += pages_per_tile) {
    const int nt = min(pages_per_tile, n_pages - j0) * page;  // tile tokens
    __syncthreads();  // the previous tile is fully consumed
    stage_tile(k_pages, v_pages, table, j0, nt, page, KV, D, kv, k_s, v_s);
    __syncthreads();
    // scores (G, nt) in f32; positions at or past the context are masked
    for (int e = tid; e < G * nt; e += kThreads) {
      const int g = e / nt;
      const int t = e - g * nt;
      const float* qr = q_s + (size_t)g * D;
      const float* kr = k_s + (size_t)t * Dp;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      s_s[(size_t)g * tile + t] = (j0 * page + t < ctx) ? s : kNegInf;
    }
    __syncthreads();
    // online-softmax statistics, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* sr = s_s + (size_t)g * tile;
      float m_cur = kNegInf;
      for (int t = lane; t < nt; t += 32) m_cur = fmaxf(m_cur, sr[t]);
      m_cur = warp_max(m_cur);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, m_cur);
      // a fully masked row keeps m_new == -1e30, where exp(s - m_new)
      // would be 1: force p = 0 so l stays 0 and the output stays zero
      const bool dead = m_new <= kNegInf * 0.5f;
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = dead ? 0.f : expf(sr[t] - m_new);
        sr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D;
      const int d = e - g * D;
      const float* pr = s_s + (size_t)g * tile;
      float a = acc[e] * a_s[g];
      for (int t = 0; t < nt; ++t) a = fmaf(pr[t], v_s[(size_t)t * D + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * D; e += kThreads) {
    float l = l_s[e / D];
    l = (l == 0.f) ? 1.f : l;  // empty context -> zeros
    out[row0 + e] = from_f32<TQ>(acc[e] / l);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* lens, void* out, int B,
                   int H, int KV, int D, int page, int nb, cudaStream_t st) {
  const int pages_per_tile = page >= 64 ? 1 : 64 / page;
  const int G = H / KV;
  const size_t bytes = smem_floats(G, D, pages_per_tile * page) * sizeof(float);
  auto kernel = paged_attention_kernel<TQ, TKV>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B, KV);
  kernel<<<grid, kThreads, bytes, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), tables, lens, static_cast<TQ*>(out), H, KV,
      D, page, nb, pages_per_tile, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// q (B, H, D) and out in q's type; k/v pages (P, page, KV, D) in the pool's
// type, 16-byte aligned with D a multiple of 8; tables (B, nb) and lens (B,)
// int32.  `q_bf16` / `kv_bf16` select bf16 (1) or f32 (0).  Returns
// cudaGetLastError() after the launch.
extern "C" int paged_attention_bhd_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lens, void* out, int B, int H, int KV,
    int D, int page, int nb, int q_bf16, int kv_bf16, void* stream) {
  if (B == 0) return 0;
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages, t, l,
                                                out, B, H, KV, D, page, nb, st);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, k_pages, v_pages, t, l, out, B, H,
                                        KV, D, page, nb, st);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k_pages, v_pages, t, l, out, B, H,
                                        KV, D, page, nb, st);
  return launch<float, float>(q, k_pages, v_pages, t, l, out, B, H, KV, D,
                              page, nb, st);
}
