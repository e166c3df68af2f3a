// Flash-attention forward kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_bhsd`
// in src/repro/kernels/flash_attention.py: blocked online-softmax
// attention over (B, H, S, D) queries and (B, KV, S, D) keys/values, GQA
// through `kv = h / (H / KV)` (K/V are never replicated), causal and
// sliding-window masks.  Besides the output it writes the f32 row
// log-sum-exp of the scaled scores, (B, H, S), which the backward kernel
// (flash_attention_bwd.cu) needs to rebuild the probabilities.
//
// One kernel a type:
//   - bf16 (the logprob recompute): `flash_fwd_wgmma_kernel`, products on
//     the tensor cores by warpgroup (wgmma), operands streamed by TMA;
//   - f32 (the train step, TF32 off): `flash_fwd_kernel`, products on the
//     CUDA cores in f32, so its 2e-5 gate holds.
//
// Semantics both keep.  The TPU kernel carries (m, l, acc) across a
// sequential grid axis in VMEM scratch; here one block loops over the K/V
// tiles itself and keeps the running state in registers.  K/V tiles that
// the causal or window mask hides from every row of the query tile are
// skipped; the TPU kernel visits and masks them, which gives the same
// result because every row meets its diagonal key before it finalises.
// Any S is taken (the TPU kernel asserts S % block == 0): rows and keys
// past S are zero-filled on load and masked.  The mask value is -1e30, not
// -inf, as on the TPU: a row whose first tile is fully masked takes
// p = exp(0) = 1 there, and the first live tile's alpha = exp(-1e30 - m)
// = 0 wipes that out; out-of-range K/V rows load as zeros, so that
// transient contribution is always finite.  l == 0 gives a zero row.
//
// What bounds the bf16 kernel on this card.  4 * D flops per live (query,
// key) pair: at yi-9b's recompute (B 16, S 512, H 32 / KV 4, D 128,
// causal) 34.4 GFLOP, 0.035 ms on the tensor cores at 989 TFLOP/s, and
// 0.045 ms of HBM traffic for Q, K, V and O.  On the CUDA cores the same
// products took 2.35 ms, held by shared-memory loads (two a FMA pair).  With
// so little work per query tile, what bounds a tensor-core version is how
// well each SM overlaps one tile's products with another's softmax, and how
// many instructions feed the products.  The design (FlashAttention-3's,
// without its ping-pong between warpgroups):
//   - a block takes a 64-row query tile of one (b, h): one consumer
//     warpgroup (4 warps, 16 rows each) and one producer warp, 160 threads
//     and 81 KB of shared memory at D <= 128, so two independent blocks
//     share an SM (121 KB at D = 160, 161 KB at 256: one);
//   - the producer warp streams Q once and K and V tiles of 64 keys x D
//     through a ring of 2 slots each by TMA (one thread issues each
//     64-column box, zero past S and D, 128-byte swizzle) and mbarriers:
//     "full" when a tile's bytes landed, "empty" when the warpgroup is done
//     with it; no __syncthreads in the loop;
//   - S = Q K^T is wgmma m64n64k16, A and B read from shared
//     memory through matrix descriptors; O += P V is wgmma m64nDk16 with P
//     from registers (the S accumulators rounded to bf16 are the A
//     fragment) and V read transposed from shared memory; O stays in f32
//     registers;
//   - tile t's P V goes out together with tile t + 1's S, and tile t + 1's
//     softmax (exp2 of scores prescaled by log2(e) / sqrt(D), row max and
//     sum over the four lanes of a row by two shuffles, l summed from the f32
//     P, masks as per-row key bounds) runs while that P V is in flight; only
//     the rescale of O waits for it.  Every branch around a product is
//     warp-uniform to the compiler and none is per tile, or ptxas
//     serializes the products;
//   - D is zero-padded to DP, a multiple of 16 (zero columns add nothing to
//     a score, padded output columns are not written); one template
//     instance for each DP up to 256.  TMA fills the columns of the last
//     64-column box past D with zeros and the k-steps of Q K^T stop at DP,
//     so that fill reaches no score.  O holds DP / 2 f32 registers a thread
//     beside S's 32 (80 at stablelm-12b's D = 160, 128 at 256): the one
//     warpgroup keeps all of O, and past DP = 128 P V goes out as two
//     products with the one A fragment of P, N = 128 over V's first two
//     64-column blocks and N = DP - 128 from its third;
//   - query tiles run longest first (causal rows near S first).
// P is rounded to bf16 before P V where the plain version keeps it in f32;
// on the TPU, JAX's default matmul precision fed the MXU bf16 passes too.
// TMA needs the rows of Q, K and V to start 16-byte aligned; the wrapper
// copies a view whose rows do not (D % 8 != 0 among them) into rows padded
// to a multiple of 8 elements.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 256;  // head_dim: wgmma's N (P V) stops at 256

struct Strides {  // element strides of a (B, heads, S, D) view; D is unit
  long long b, h, s;
};

__device__ __forceinline__ bool allowed(int qi, int kj, int S, int causal,
                                        int window) {
  bool ok = kj < S;
  if (causal) ok = ok && kj <= qi;
  if (window > 0) ok = ok && kj > qi - window;
  return ok;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each

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
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           long long ss, int r0, int n,
                                           int S, int D, int Dp,
                                           float* dst) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    dst[r * Dp + d] = (r0 + r < S) ? src[(long long)(r0 + r) * ss + d] : 0.f;
  }
}

// Grid (ceil(S / 64), H, B): one block of 256 threads per 64-row query tile
// of one head.  Each thread owns a 4 x 4 micro-tile of the 64 x 64 score
// tile (rows ty + 16 i, columns tx + 16 j) and a 4 x ceil(D / 16) slice of
// the output accumulator; Q, K and V are staged in shared memory, rows
// padded by one float so the column reads are free of bank conflicts.  The
// 16 threads of a row sit in one half-warp, so the row max and sum are two
// shuffle reductions.  Bound by shared-memory loads (two a FMA pair).
template <int NC>  // NC = ceil(D / 16) output columns a thread
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so,
    int H, int KV, int S, int D, int causal, int window, float scale) {
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

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
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

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) ob[(long long)qi * so.s + d] = acc[i][c] / li;
    }
    if (tx == 0) lse[((long long)b * H + h) * S + qi] = m[i] + logf(li);
  }
}

template <int NC>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, const Strides* st, int B, int H, int KV,
                       int S, int D, int causal, int window,
                       cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<NC>;
  const size_t bytes =
      sizeof(float) *
      ((size_t)(kBQ + 2 * kBK) * (D + 1) + (size_t)kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, st[0], st[1],
      st[2], st[3], H, KV, S, D, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), fed by TMA from a producer warp
// ---------------------------------------------------------------------------
constexpr int kStages = 2;        // K/V tiles in the shared-memory ring
constexpr int kKeys = 64;         // keys a K/V tile
constexpr int kTcBQ = 64;         // query rows a block: one warpgroup
constexpr int kConsumers = 128;   // the warpgroup's threads, 16 rows a warp
constexpr int kProducers = 32;    // one warp
constexpr int kTcThreads = kConsumers + kProducers;
constexpr float kLn2 = 0.6931471805599453f;

template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       Strides so, int H, int KV, int S, int D, int causal,
                       int window, float scale_log2) {
  constexpr int kDB = (DP + 63) / 64;       // 64-column blocks of a row
  constexpr int kSteps = DP / 16;           // k-steps of Q K^T
  constexpr uint32_t kTile = kDB * kKeys * 128;  // one K or V slot

  // [Q (later the output)] [K ring] [V ring] [mbarriers], 1024-aligned
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t s_q = (mma::smem_addr(smem_tc) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + kDB * kTcBQ * 128;
  const uint32_t s_v = s_k + kStages * kTile;
  // full Q, full K[i], full V[i], empty K[i], empty V[i]
  const uint32_t bar_q = s_v + kStages * kTile;
  auto full_k = [&](int i) { return bar_q + 8 * (1 + i); };
  auto full_v = [&](int i) { return bar_q + 8 * (1 + kStages + i); };
  auto empty_k = [&](int i) { return bar_q + 8 * (1 + 2 * kStages + i); };
  auto empty_v = [&](int i) { return bar_q + 8 * (1 + 3 * kStages + i); };

  const int n_qt = (S + kTcBQ - 1) / kTcBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kTcBQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  // warp-uniform as far as the compiler can tell (a broadcast lane): every
  // branch around a wgmma must be, or ptxas serializes the products
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  // the K/V tiles some row of the query tile sees: at least one, as every
  // row sees its own key
  const int k_end = causal ? min(S, q0 + kTcBQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kKeys;
  const int t_end = (k_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    wg::mbar_init(bar_q, 1);  // TMA's one arrival with its bytes
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(full_k(i), 1);
      wg::mbar_init(full_v(i), 1);
      wg::mbar_init(empty_k(i), kConsumers);
      wg::mbar_init(empty_v(i), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: TMA from one thread, 64-column
                    // boxes, zero past S and D
    if (lane == 0) {
      wg::mbar_expect(bar_q, kDB * kTcBQ * 128);
      for (int db = 0; db < kDB; ++db)
        wg::tma_load_4d(s_q + db * kTcBQ * 128, &tm_q, bar_q, 64 * db, q0, h,
                        b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int slot = i % kStages, parity = ((i / kStages) & 1) ^ 1;
        wg::mbar_wait(empty_k(slot), parity);
        wg::mbar_expect(full_k(slot), kTile);
        for (int db = 0; db < kDB; ++db)
          wg::tma_load_4d(s_k + slot * kTile + db * kKeys * 128, &tm_k,
                          full_k(slot), 64 * db, kKeys * t, kvh, b);
        wg::mbar_wait(empty_v(slot), parity);
        wg::mbar_expect(full_v(slot), kTile);
        for (int db = 0; db < kDB; ++db)
          wg::tma_load_4d(s_v + slot * kTile + db * kKeys * 128, &tm_v,
                          full_v(slot), 64 * db, kKeys * t, kvh, b);
      }
    }
    return;
  }

  // the consumer warpgroup: 64 query rows, 16 a warp
  const int g = lane >> 2, t4 = lane & 3;
  const int lr = 16 * warp;  // this warp's first row in the tile
  const int qw = q0 + lr;

  float acc[DP / 2], s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t pf[kKeys / 16][4];  // P of the tile whose P V is next (A fragments)

  // S = Q K^T of tile t into s: issued, not waited for.  k-step kk starts
  // (kk % 4) * 32 bytes into a row of 64-column block kk / 4: descriptors
  // move by those bytes / 16 in their low field.
  const uint64_t dq = wg::desc(s_q, 16, 1024);
  auto issue_s = [&](int slot) {
    const uint64_t dk = wg::desc(s_k + slot * kTile, 16, 1024);
    wg::touch(s);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      wg::ss_k16(s, dq + ((kk >> 2) * (kTcBQ * 8) + (kk & 3) * 2),
                 dk + ((kk >> 2) * (kKeys * 8) + (kk & 3) * 2), kk > 0);
    wg::commit();
  };
  // softmax of tile t's scores in s, up to what needs O: scaled and masked
  // scores become P (f32), the row max moves to mn, the row sums go to rs
  float mn[2], rs[2];
  auto softmax = [&](int t) {
    const int k0 = kKeys * t;
    const bool masked = k0 + kKeys > S || (causal && k0 + kKeys - 1 > qw) ||
                        (window > 0 && k0 <= qw + 15 - window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the row sees keys lo .. hi, as offsets from this lane's first key
      const int qi = qw + g + 8 * r;
      const int kt = k0 + 2 * t4;
      const int lo = (window > 0 ? qi - window + 1 : 0) - kt;
      const int hi = (causal ? min(qi, S - 1) : S - 1) - kt;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * r + e] * scale_log2;
          if (masked && (8 * j + e < lo || 8 * j + e > hi)) x = kNegInf;
          s[4 * j + 2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mn[r] = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * r + e] - mn[r]);
          s[4 * j + 2 * r + e] = p;
          sum += p;  // l from the f32 P
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      rs[r] = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
    }
  };
  // the rest, once no P V is in flight: O rescaled, l and m moved on, and P
  // in bf16 (score chunks 2kk, 2kk + 1 are the A fragment of k-step kk)
  auto finish = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float alpha = exp2f(m[r] - mn[r]);
      l[r] = alpha * l[r] + rs[r];
      m[r] = mn[r];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j + 2 * r] *= alpha;
        acc[4 * j + 2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      pf[kk][0] = mma::pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pf[kk][1] = mma::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pf[kk][2] = mma::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pf[kk][3] = mma::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto issue_pv = [&](int slot) {
    // V is read transposed: kKeys * 128 bytes from one 64-column block to
    // the next, 1024 from 8 keys to the next
    const uint64_t dv = wg::desc(s_v + slot * kTile, kKeys * 128, 1024);
    wg::touch(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {  // 16 keys = 2048 bytes a step
      if constexpr (DP <= 128) {
        wg::rs_k16(acc, pf[kk], dv + kk * 128);
      } else {  // N = 128, then the columns past 128 from V's third block
        wg::rs_k16(*reinterpret_cast<float(*)[64]>(acc), pf[kk],
                   dv + kk * 128);
        wg::rs_k16(*reinterpret_cast<float(*)[DP / 2 - 64]>(acc + 64), pf[kk],
                   dv + kk * 128 + 2 * kKeys * 8);
      }
    }
    wg::commit();
  };

  // Tile t's P V goes out together with tile t + 1's S, tile t + 1's
  // softmax runs while that P V is in flight, and only the O rescale waits
  // for it.  No product sits under a condition the compiler cannot see
  // through, or ptxas serializes them.
  wg::mbar_wait(bar_q, 0);
  wg::mbar_wait(full_k(0), 0);
  wg::fence_async_shared();
  issue_s(0);
  wg::wait<0>();
  wg::touch(s);
  wg::mbar_arrive(empty_k(0));
  softmax(t_begin);
  finish();
  for (int t = t_begin; t < t_end - 1; ++t) {
    const int i = t - t_begin;
    const int slot = i % kStages, parity = (i / kStages) & 1;
    const int nslot = (i + 1) % kStages, nparity = ((i + 1) / kStages) & 1;
    wg::mbar_wait(full_k(nslot), nparity);
    wg::fence_async_shared();
    issue_s(nslot);
    wg::mbar_wait(full_v(slot), parity);
    wg::fence_async_shared();
    issue_pv(slot);
    wg::wait<1>();  // S of t + 1 done, P V of t may still run
    wg::touch(s);
    wg::mbar_arrive(empty_k(nslot));
    softmax(t + 1);
    wg::wait<0>();
    wg::touch(acc);
    wg::touch(pf);
    wg::mbar_arrive(empty_v(slot));
    finish();
  }
  {
    const int i = t_end - 1 - t_begin;
    const int slot = i % kStages;
    wg::mbar_wait(full_v(slot), (i / kStages) & 1);
    wg::fence_async_shared();
    issue_pv(slot);
    wg::wait<0>();
    wg::touch(acc);
    wg::touch(pf);
    wg::mbar_arrive(empty_v(slot));
  }

  // O / l in bf16 into this warp's rows of the Q tile (read by no one any
  // more: each warp's products read only its own rows), then out by rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    const int row = lr + g + 8 * r;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const uint32_t w = mma::pack_bf16(acc[4 * j + 2 * r] * inv,
                                        acc[4 * j + 2 * r + 1] * inv);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       s_q + (j >> 3) * (kTcBQ * 128) + mma::swz(row, j & 7, 8) +
                       4 * t4),
                   "r"(w)
                   : "memory");
    }
    const int qi = qw + g + 8 * r;
    if (t4 == 0 && qi < S)
      lse[((long long)b * H + h) * S + qi] =
          m[r] * kLn2 + logf(l[r] == 0.f ? 1.f : l[r]);
  }
  __syncwarp();
  constexpr int kChunks = DP / 8;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    const int qi = qw + r;
    if (qi >= S || c * 8 >= D) continue;
    const uint32_t at =
        s_q + (c >> 3) * (kTcBQ * 128) + mma::swz(lr + r, c & 7, 8);
    uint32_t w[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(at)
                 : "memory");
    __nv_bfloat16* to = ob + (long long)qi * so.s + c * 8;
    if (c * 8 + 8 <= D && mma::aligned16(to)) {
      *reinterpret_cast<uint4*>(to) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {  // the last chunk of a row of D % 8 != 0, or an unaligned view
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(w);
#pragma unroll
      for (int d = 0; d < 8; ++d)
        if (d < D - c * 8) to[d] = e[d];
    }
  }
}

// A 4-d TMA map of a (B, heads, S, D) bf16 view with 16-byte strides:
// boxes of 64 columns (128 bytes, the swizzle's width) by `rows`, swizzled
// as wgmma reads them; elements past S or D read as zero.
CUresult tensor_map(CUtensorMap* map, const void* base, const Strides& st,
                    int B, int heads, int S, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  // a dimension of one index may carry any stride; give it a whole one
  const long long s = S > 1 ? st.s : (D + 7) / 8 * 8,
                  hs = heads > 1 ? st.h : s * S, bs = B > 1 ? st.b : hs * heads;
  const cuuint64_t strides[3] = {(cuuint64_t)s * 2, (cuuint64_t)hs * 2,
                                 (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, const Strides* st, int B, int H, int KV,
                         int S, int D, int causal, int window,
                         cudaStream_t stream) {
  constexpr int kDB = (DP + 63) / 64;
  CUtensorMap maps[3];
  if (tensor_map(&maps[0], q, st[0], B, H, S, D, kTcBQ) != CUDA_SUCCESS ||
      tensor_map(&maps[1], k, st[1], B, KV, S, D, kKeys) != CUDA_SUCCESS ||
      tensor_map(&maps[2], v, st[2], B, KV, S, D, kKeys) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;  // rows not 16-byte aligned
  auto kernel = flash_fwd_wgmma_kernel<DP>;
  const int bytes =
      1024 + kDB * 128 * (kTcBQ + 2 * kStages * kKeys) + 8 * (1 + 4 * kStages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kTcBQ - 1) / kTcBQ, H, B);
  kernel<<<grid, kTcThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, st[3],
      H, KV, S, D, causal, window, 1.4426950408889634f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// q (B, H, S, D), k/v (B, KV, S, D), o like q, all of one type, each a view
// with a unit stride on D and the (b, head, s) element strides given in
// `strides` (12 int64: q, k, v, o); lse (B, H, S) f32 contiguous.
// D <= 256, H % KV == 0.  `bf16` selects bf16 (1, the tensor-core kernel;
// every row of q, k and v must start 16-byte aligned, or it returns
// cudaErrorInvalidValue) or f32 (0, the CUDA-core kernel).  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, int B, int H, int KV, int S, int D, int causal,
    int window, int bf16, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (D < 1 || D > kMaxD || KV < 1 || H % KV)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const Strides st[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  if (!bf16) {
    if (D <= 16)
      return launch_f32<1>(q, k, v, o, l, st, B, H, KV, S, D, causal, window, s);
    if (D <= 32)
      return launch_f32<2>(q, k, v, o, l, st, B, H, KV, S, D, causal, window, s);
    if (D <= 64)
      return launch_f32<4>(q, k, v, o, l, st, B, H, KV, S, D, causal, window, s);
    if (D <= 128)
      return launch_f32<8>(q, k, v, o, l, st, B, H, KV, S, D, causal, window, s);
    if (D <= 160)
      return launch_f32<10>(q, k, v, o, l, st, B, H, KV, S, D, causal, window,
                            s);
    if (D <= 192)
      return launch_f32<12>(q, k, v, o, l, st, B, H, KV, S, D, causal, window,
                            s);
    return launch_f32<16>(q, k, v, o, l, st, B, H, KV, S, D, causal, window,
                          s);
  }
#define K3_CASE(DP)                                                        \
  case DP / 16:                                                            \
    return launch_wgmma<DP>(q, k, v, o, l, st, B, H, KV, S, D, causal, window, \
                            s);
  switch ((D + 15) / 16) {
    K3_CASE(16)
    K3_CASE(32)
    K3_CASE(48)
    K3_CASE(64)
    K3_CASE(80)
    K3_CASE(96)
    K3_CASE(112)
    K3_CASE(128)
    K3_CASE(144)
    K3_CASE(160)
    K3_CASE(176)
    K3_CASE(192)
    K3_CASE(208)
    K3_CASE(224)
    K3_CASE(240)
    K3_CASE(256)
  }
#undef K3_CASE
  return (int)cudaErrorInvalidValue;
}
