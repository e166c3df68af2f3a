// Paged-attention decode kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` / `paged_attention_bhd`
// in src/repro/kernels/paged_attention.py.  One query token per sequence
// attends over a (P, page, KV, D) page pool addressed through per-request
// block tables; the G = H / KV query heads of one KV head share each
// staged K/V tile.
//
// Bound on this card: bytes.  Each launch must read ctx * KV * D K and V
// elements per sequence; the 2 * G * D flops per K/V element pair are far
// below the card's ~295 flops/byte balance point.  A block that walks a
// whole context alone is latency-bound in one SM (a grid of (B, KV) is 32
// blocks at yi-9b's B = 8, with 16 dependent 64-token tiles for a
// 1024-token row).
//
// Design: split-K over the context (flash-decoding), merged inside a
// thread-block cluster.
// - Grid (n_split, KV, B), one cluster of n_split <= 8 blocks per
//   (b, kv head).  The table is cut into tiles of 32 tokens (32 / page
//   pages), dealt round-robin to the splits (split r takes tiles r,
//   r + n_split, ...), so a short context still spreads over several
//   blocks.  n_split comes from the table width nb alone, never from the
//   context lengths, so the launch reads nothing back to the host and
//   stays capturable in a CUDA graph (yi-9b, nb 64: 8 splits, 256 blocks).
//   A block reads its own block-table row and context length and walks
//   only its tiles below ceil(ctx / page) pages (the TPU kernel visits all
//   nb pages and masks the ones past the context; stopping early gives
//   the same result); a split with no tile below the context loads
//   nothing and goes straight to the merge.
// - K and V tiles arrive in their own type by 16-byte cp.async into a
//   2-slot ring, rows padded by 16 bytes (conflict-free reads of one
//   column across rows), so the next tile loads while the current one is
//   multiplied.
// - One warp per query row (min(4, G) warps, each carrying G / warps rows
//   in registers): a lane scores one key against the warp's rows with
//   16-byte loads and f32 fmaf chains, the warp's shuffles give the
//   online-softmax statistics, and P V reads each key's probability from
//   its lane by a shuffle.  A tile costs one block barrier (the ring):
//   at these sizes the time is the latency of each tile's chain of
//   loads, products and reductions, not bytes, and block-wide phases
//   with a barrier between them cost more than the work they share out.
// - The merge: each block keeps its (m, l, acc[G x D]) in its own shared
//   memory; after a cluster barrier the blocks read all n_split partials
//   through distributed shared memory, each merging a share of the G x D
//   outputs in split order (deterministic, and no scratch in device
//   memory, so one launch and no second kernel), then a second barrier
//   keeps every block's shared memory alive until all reads are done.
// -1e30 stays the mask (not -inf), a fully masked row keeps p = 0 and a
// split with no live key weighs 0 in the merge, and an empty context
// (ctx == 0) writes zeros, so the trash page 0 never leaks into the
// result.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 4;     // a block: one warp per query row, up to 4
constexpr int kMaxSplit = 8;     // the portable cluster size
constexpr int kTileTokens = 32;  // one key a lane
constexpr int kStages = 2;       // K/V ring slots

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

// four consecutive elements as f32 (8- or 16-byte loads)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// one 16-byte chunk of a K row as f32
__device__ __forceinline__ void load_chunk(const float* p, float f[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>  // at most N of the latest commit groups still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Row pitch (elements) of a staged K or V tile: D plus one 16-byte chunk,
// so 8 consecutive rows read at one column fall in different bank groups.
template <typename TKV>
__host__ __device__ inline int kv_pitch(int D) {
  return D + 16 / (int)sizeof(TKV);
}

// Bytes of shared memory a block needs: the K/V ring in the pool's type,
// then the f32 q rows and the split's partial (acc, m, l) per query row.
template <typename TKV>
size_t smem_bytes(int G, int D, int tile) {
  return 2 * kStages * (size_t)tile * kv_pitch<TKV>(D) * sizeof(TKV) +
         sizeof(float) * (2 * (size_t)G * D + 2 * G);
}

// cp.async the `np` pages j0 .. of one tile (sequence b's table row,
// head kv) into k_s / v_s, token t at row t.
template <typename TKV>
__device__ __forceinline__ void stage_tile(
    const TKV* __restrict__ k_pages, const TKV* __restrict__ v_pages,
    const int* __restrict__ table, int j0, int np, int page, int KV, int D,
    int kv, TKV* k_s, TKV* v_s) {
  constexpr int kVec = 16 / sizeof(TKV);  // elements per 16-byte copy
  const int per_row = D / kVec;
  const int Dp = kv_pitch<TKV>(D);
  const int n = np * page * per_row;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int t = c / per_row;
    const int d = (c - t * per_row) * kVec;
    const int pid = table[j0 + t / page];
    const size_t off = (((size_t)pid * page + (t % page)) * KV + kv) * D + d;
    cp_async16(k_s + t * Dp + d, k_pages + off);
    cp_async16(v_s + t * Dp + d, v_pages + off);
  }
}

template <typename TQ, typename TKV, int R>
__global__ void __launch_bounds__(32 * kMaxWarps) paged_attention_kernel(
    const TQ* __restrict__ q,          // (B, H, D)
    const TKV* __restrict__ k_pages,   // (P, page, KV, D)
    const TKV* __restrict__ v_pages,   // (P, page, KV, D)
    const int* __restrict__ tables,    // (B, nb)
    const int* __restrict__ lens,      // (B,)
    TQ* __restrict__ out,              // (B, H, D)
    int H, int KV, int D, int page, int nb, int pages_per_tile,
    float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int n_split = (int)cluster.num_blocks();
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_thr = blockDim.x;
  const int n_warps = n_thr >> 5;
  const int G = H / KV;
  const int tile = pages_per_tile * page;
  const int Dp = kv_pitch<TKV>(D);

  extern __shared__ float4 smem4[];
  const size_t slot_n = (size_t)tile * Dp;
  TKV* k_s = reinterpret_cast<TKV*>(smem4);  // kStages slots of tile x Dp
  TKV* v_s = k_s + kStages * slot_n;         // kStages slots of tile x Dp
  float* q_s = reinterpret_cast<float*>(v_s + kStages * slot_n);
  float* acc_s = q_s + (size_t)G * D;        // G x D, the split's partial
  float* m_s = acc_s + (size_t)G * D;        // G
  float* l_s = m_s + G;                      // G

  const int ctx = lens[b];
  const int n_pages = ctx > 0 ? min((ctx + page - 1) / page, nb) : 0;
  const int* table = tables + (size_t)b * nb;
  // this split's tiles: split, split + n_split, ... below the context
  const int live_tiles = (n_pages + pages_per_tile - 1) / pages_per_tile;
  const int n = live_tiles > split ? (live_tiles - split - 1) / n_split + 1
                                   : 0;

  // tile u of this split goes to slot u % kStages; kStages - 1 tiles in
  // flight ahead of the one being multiplied
  auto stage = [&](int u) {
    if (u < n) {
      const int j0 = (split + u * n_split) * pages_per_tile;
      const size_t off = (u % kStages) * slot_n;
      stage_tile(k_pages, v_pages, table, j0,
                 min(pages_per_tile, n_pages - j0), page, KV, D, kv,
                 k_s + off, v_s + off);
    }
    cp_async_commit();
  };
  for (int u = 0; u < kStages - 1; ++u) stage(u);

  // this KV head's query group: heads kv * G .. kv * G + G - 1
  const size_t row0 = ((size_t)b * H + (size_t)kv * G) * D;
  for (int e = tid; e < G * D; e += n_thr) q_s[e] = to_f32(q[row0 + e]);

  // Warp w carries query rows w, w + n_warps, ... (R of them): its scores
  // (one key a lane), softmax statistics and accumulator stay in its
  // registers, so a tile needs one barrier.  Lane l's accumulator columns
  // are 4 (l + 32 c) .. + 3.
  constexpr int kVec = 16 / sizeof(TKV);  // elements per 16-byte chunk
  constexpr int kCols = 2;                // D <= 256
  float m[R], l[R], acc[R][kCols][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][c][i] = 0.f;
  }
  for (int u = 0; u < n; ++u) {
    const int ti = split + u * n_split;
    const int nt = min(pages_per_tile, n_pages - ti * pages_per_tile) * page;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile u is in (q too); tile u - 1 is fully consumed
    stage(u + kStages - 1);
    const TKV* ks = k_s + (u % kStages) * slot_n;
    const TKV* vs = v_s + (u % kStages) * slot_n;
    for (int t0 = 0; t0 < nt; t0 += 32) {  // 32 keys, one a lane
      const int t = t0 + lane;
      const TKV* kr = ks + (size_t)min(t, nt - 1) * Dp;
      float s[R] = {};
      for (int d = 0; d < D; d += kVec) {
        float x[kVec];
        load_chunk(kr + d, x);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float* qr =
              q_s + (size_t)min(warp + r * n_warps, G - 1) * D + d;
#pragma unroll
          for (int i = 0; i < kVec; i += 4) {
            const float4 a = load4(qr + i);
            s[r] = fmaf(a.x, x[i], s[r]);
            s[r] = fmaf(a.y, x[i + 1], s[r]);
            s[r] = fmaf(a.z, x[i + 2], s[r]);
            s[r] = fmaf(a.w, x[i + 3], s[r]);
          }
        }
      }
      const bool live = t < nt && ti * tile + t < ctx;
      float p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float sr = live ? s[r] * scale : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sr));
        // a fully masked row keeps m_new == -1e30, where exp(s - m_new)
        // would be 1: force p = 0 so l stays 0 and the output stays zero
        p[r] = m_new <= kNegInf * 0.5f ? 0.f : expf(sr - m_new);
        const float alpha = expf(m[r] - m_new);
        l[r] = alpha * l[r] + warp_sum(p[r]);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][c][i] *= alpha;
      }
      // acc += P V: key t0 + j's probabilities from lane j
      const int kn = min(32, nt - t0);
#pragma unroll 4
      for (int j = 0; j < kn; ++j) {
        float4 x[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = 4 * (lane + 32 * c);
          x[c] = d < D ? load4(vs + (size_t)(t0 + j) * Dp + d)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[r][c][0] = fmaf(pj, x[c].x, acc[r][c][0]);
            acc[r][c][1] = fmaf(pj, x[c].y, acc[r][c][1]);
            acc[r][c][2] = fmaf(pj, x[c].z, acc[r][c][2]);
            acc[r][c][3] = fmaf(pj, x[c].w, acc[r][c][3]);
          }
        }
      }
    }
  }
  // the split's partial, for the merge
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = warp + r * n_warps;
    if (g >= G) continue;
    if (lane == 0) {
      m_s[g] = m[r];
      l_s[g] = l[r];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = 4 * (lane + 32 * c);
      if (d < D)
        *reinterpret_cast<float4*>(acc_s + (size_t)g * D + d) = make_float4(
            acc[r][c][0], acc[r][c][1], acc[r][c][2], acc[r][c][3]);
    }
  }

  // merge the cluster's partials in split order; block `split` writes
  // every n_split-th group of four outputs
  cluster.sync();
  for (int e = split + tid * n_split; e < G * D / 4; e += n_thr * n_split) {
    const int g = e / (D / 4);
    const int d = 4 * (e - g * (D / 4));
    float mr[kMaxSplit], lr[kMaxSplit];
    float4 ar[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < n_split) {  // every load in flight before the first use
        mr[r] = *cluster.map_shared_rank(m_s + g, r);
        lr[r] = *cluster.map_shared_rank(l_s + g, r);
        ar[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(acc_s + (size_t)g * D + d, r));
      }
    float m = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < n_split) m = fmaxf(m, mr[r]);
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < n_split) {
        const float w = mr[r] <= kNegInf * 0.5f ? 0.f : expf(mr[r] - m);
        l = fmaf(w, lr[r], l);
        o.x = fmaf(w, ar[r].x, o.x);
        o.y = fmaf(w, ar[r].y, o.y);
        o.z = fmaf(w, ar[r].z, o.z);
        o.w = fmaf(w, ar[r].w, o.w);
      }
    l = (l == 0.f) ? 1.f : l;  // empty context -> zeros
    TQ* dst = out + row0 + (size_t)g * D + d;
    dst[0] = from_f32<TQ>(o.x / l);
    dst[1] = from_f32<TQ>(o.y / l);
    dst[2] = from_f32<TQ>(o.z / l);
    dst[3] = from_f32<TQ>(o.w / l);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <typename TQ, typename TKV, int R>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* lens, void* out, int B,
                   int H, int KV, int D, int page, int nb, cudaStream_t st) {
  const int warps = std::min(kMaxWarps, H / KV);
  const int pages_per_tile = page >= kTileTokens ? 1 : kTileTokens / page;
  const int n_tiles = (nb + pages_per_tile - 1) / pages_per_tile;
  const int n_split = std::max(1, std::min(kMaxSplit, n_tiles));
  const size_t bytes = smem_bytes<TKV>(H / KV, D, pages_per_tile * page);
  auto kernel = paged_attention_kernel<TQ, TKV, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, KV, B);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TQ*>(q),
                           static_cast<const TKV*>(k),
                           static_cast<const TKV*>(v), tables, lens,
                           static_cast<TQ*>(out), H, KV, D, page, nb,
                           pages_per_tile, 1.0f / sqrtf((float)D));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// query rows a warp carries: G / min(4, G) rounded up to 1, 2, 4 or 16
template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* tables, const int* lens, void* out, int B,
                     int H, int KV, int D, int page, int nb, cudaStream_t st) {
  const int G = H / KV;
  if (G <= kMaxWarps)
    return launch<TQ, TKV, 1>(q, k, v, tables, lens, out, B, H, KV, D, page,
                              nb, st);
  if (G <= 2 * kMaxWarps)
    return launch<TQ, TKV, 2>(q, k, v, tables, lens, out, B, H, KV, D, page,
                              nb, st);
  if (G <= 4 * kMaxWarps)
    return launch<TQ, TKV, 4>(q, k, v, tables, lens, out, B, H, KV, D, page,
                              nb, st);
  return launch<TQ, TKV, 16>(q, k, v, tables, lens, out, B, H, KV, D, page,
                             nb, st);
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
  if (H % KV || H / KV > 16 * kMaxWarps || D % 8 || D > 256)
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, t, l, out, B, H, KV, D, page, nb, st);
  if (q_bf16)
    return dispatch<__nv_bfloat16, float>(q, k_pages, v_pages, t, l, out, B,
                                          H, KV, D, page, nb, st);
  if (kv_bf16)
    return dispatch<float, __nv_bfloat16>(q, k_pages, v_pages, t, l, out, B,
                                          H, KV, D, page, nb, st);
  return dispatch<float, float>(q, k_pages, v_pages, t, l, out, B, H, KV, D,
                                page, nb, st);
}
