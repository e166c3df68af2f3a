// Grouped (per-expert) matmul and the drop-free MoE decode FFN for Hopper
// (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/moe_gmm.py:
//   - `grouped_matmul` / `_gmm_kernel` (K4): out[e] = buf[e] @ w[e] over
//     (E, C, D) x (E, D, F) with an f32 accumulator.  Here `gmm_kernel`.
//   - `moe_decode_gmm` (K5): token -> expert dispatch into a drop-free
//     (E, C, d) buffer, gate and up products with SiLU gating, the down
//     product, and the gate-weighted combine back to (T, d).  Here four
//     launches: `moe_dispatch_kernel`, `gmm_kernel<gated>` (gate and up in
//     one pass, two accumulators), `gmm_kernel` (down), and
//     `moe_combine_kernel`.
//
// What bounds it on this card.  At decode (T = 8 tokens, top-8 of 40
// experts, d 1536, expert d_ff 512) the work is the expert weights' bytes:
// gate + up + down are 188.7 MB per layer in bf16, 0.056 ms at 3.35 TB/s,
// against 2 * 8 rows * 2 flops per weight element, far below the card's
// ~295 flops/byte balance point.  With per-expert row counts only the
// experts that some token picked are read (about 33 of 40 at T = 8, k =
// 8).  In a 256-token prefill chunk the routed work is 9.7 GFLOP per
// layer (2048 rows x 3 products of 1536 x 512), bound by operations;
// without the counts the 5x larger capacity buffer (40 experts x 256
// rows) would all be multiplied.
//
// What the design does about it.
//   - Each block owns a (BM x 64) output tile of one expert and loops over
//     the depth in 32-deep shared-memory stages, the sums in registers.  A
//     tile whose first row is at or past the expert's row count returns at
//     once, so an expert no token picked is never read, and rows past the
//     count are neither read nor written.  The grid runs the row tiles of
//     one (expert, column tile) next to each other, so their weight tile
//     is read from HBM once and from L2 after.
//   - Tile height: 8 rows (one per row group of threads) when C <= 16, as
//     at decode where C = T = 8 and a 64-row tile would waste 7/8 of its
//     work; 32 rows (4 per thread) above, as in a prefill chunk.
//   - Batch invariance: every output element is one thread's sequence of
//     fmaf over k = 0 .. D-1 (zero-filled past D), whatever the tile
//     height, the capacity C or the row's place in its tile, so a token's
//     result does not depend on the batch it is in.  The combine sums a
//     token's k slots in order j = 0 .. k-1 with explicit round-to-nearest
//     adds and products, and no atomics anywhere.
//   - Rounding points are the TPU kernel's: each product is rounded to the
//     input type (the Pallas call's output type), SiLU(g) is rounded, then
//     SiLU(g) * u is rounded; the combine works in f32 and rounds once.
//   - The weights stream with 16-byte loads when F allows; the products
//     run on the CUDA cores in f32 (tensor cores are later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 64;  // output columns per block
constexpr int kBK = 32;  // depth per shared-memory stage
constexpr int kTN = 4;   // columns per thread
constexpr int kColGroups = kBN / kTN;              // 16
constexpr int kRowGroups = kThreads / kColGroups;  // 8

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

// x rounded to T and back: what a torch op with a T output stores
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// One (BM x kBN) tile of out[e] = a[e] @ w[e] (or, gated, of
// silu(a[e] @ w[e]) * (a[e] @ w_up[e])).  Grid (row tiles, column tiles,
// E).  `rows` (E,) int32 or null: rows at or past rows[e] are neither
// read nor written.  `vec`: F and the weight pointers allow 16-byte loads.
template <typename T, int TM, bool kGated>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ a, const T* __restrict__ w,
           const T* __restrict__ w_up, T* __restrict__ out,
           const int* __restrict__ rows, int C, int D, int F, int vec) {
  constexpr int BM = kRowGroups * TM;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kChunksPerRow = kBN / kVec;
  constexpr int kChunks = kBK * kChunksPerRow;
  __shared__ float As[BM][kBK + 1];  // padded: two rows per warp, no conflict
  __shared__ __align__(16) float Ws[kBK][kBN];
  __shared__ __align__(16) float Us[kGated ? kBK : 1][kGated ? kBN : 4];

  const int e = blockIdx.z;
  const int n_rows = rows ? min(rows[e], C) : C;
  const int row0 = blockIdx.x * BM;
  if (row0 >= n_rows) return;  // uniform over the block
  const int col0 = blockIdx.y * kBN;
  const T* A = a + (size_t)e * C * D;
  const T* W = w + (size_t)e * D * F;
  const T* U = kGated ? w_up + (size_t)e * D * F : nullptr;

  const int tid = threadIdx.x;
  const int rg = tid / kColGroups;
  const int cg = tid % kColGroups;
  float acc[TM][kTN];
  float accu[kGated ? TM : 1][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc[i][j] = 0.f;
      if constexpr (kGated) accu[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < D; k0 += kBK) {
    // a tile: consecutive threads read consecutive k of one row
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int m = i / kBK, kk = i % kBK;
      const int r = row0 + m, k = k0 + kk;
      As[m][kk] = (r < n_rows && k < D) ? to_f32(A[(size_t)r * D + k]) : 0.f;
    }
    // weight tiles: 16-byte chunks along F where possible
    for (int c = tid; c < kChunks; c += kThreads) {
      const int kk = c / kChunksPerRow;
      const int n = (c % kChunksPerRow) * kVec;
      const int k = k0 + kk, col = col0 + n;
      if (vec && k < D && col + kVec <= F) {
        const size_t off = (size_t)k * F + col;
        const uint4 wv = *reinterpret_cast<const uint4*>(W + off);
        const T* wp = reinterpret_cast<const T*>(&wv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) Ws[kk][n + j] = to_f32(wp[j]);
        if constexpr (kGated) {
          const uint4 uv = *reinterpret_cast<const uint4*>(U + off);
          const T* up = reinterpret_cast<const T*>(&uv);
#pragma unroll
          for (int j = 0; j < kVec; ++j) Us[kk][n + j] = to_f32(up[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const bool ok = k < D && col + j < F;
          const size_t off = (size_t)k * F + col + j;
          Ws[kk][n + j] = ok ? to_f32(W[off]) : 0.f;
          if constexpr (kGated) Us[kk][n + j] = ok ? to_f32(U[off]) : 0.f;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[rg * TM + i][kk];
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[kk][cg * kTN]);
      const float wr[kTN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], wr[j], acc[i][j]);
      if constexpr (kGated) {
        const float4 uv =
            *reinterpret_cast<const float4*>(&Us[kk][cg * kTN]);
        const float ur[kTN] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            accu[i][j] = fmaf(av[i], ur[j], accu[i][j]);
      }
    }
    __syncthreads();
  }

  T* O = out + (size_t)e * C * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + rg * TM + i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + cg * kTN + j;
      if (col >= F) continue;
      float v = acc[i][j];
      if constexpr (kGated) {
        // each product rounded to T, silu(g) rounded, then silu(g) * u
        const float g = round_to<T>(v);
        const float u = round_to<T>(accu[i][j]);
        const float s = round_to<T>(g / (1.f + expf(-g)));
        v = s * u;
      }
      O[(size_t)r * F + col] = from_f32<T>(v);
    }
  }
}

constexpr int kDispatchThreads = 256;
constexpr int kDispatchWarps = kDispatchThreads / 32;

// Slots, row counts and the gather, in one launch.  Every block computes
// the slot of every assignment (token-major, stable: an assignment's
// position is the number of earlier assignments to its expert, as the TPU
// kernel's one-hot cumsum gives) a round of 256 assignments at a time,
// then copies x rows for its own `per_block` assignments into buf.
// Shared memory: wcnt[kDispatchWarps][E], base[E], own[per_block] ints.
template <typename T>
__global__ void __launch_bounds__(kDispatchThreads)
moe_dispatch_kernel(const T* __restrict__ x, const int64_t* __restrict__ idx,
                    int* __restrict__ slot, int* __restrict__ counts,
                    T* __restrict__ buf, int n_tok, int k, int d, int E,
                    int C, int per_block, int vec) {
  extern __shared__ int smem[];
  int* wcnt = smem;                        // [warp][E]
  int* base = wcnt + kDispatchWarps * E;   // [E]
  int* own = base + E;                     // [per_block]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = n_tok * k;
  const int first = blockIdx.x * per_block;
  const int last = min(first + per_block, n);
  for (int i = tid; i < E; i += kDispatchThreads) base[i] = 0;
  for (int r0 = 0; r0 < n; r0 += kDispatchThreads) {
    for (int i = tid; i < kDispatchWarps * E; i += kDispatchThreads)
      wcnt[i] = 0;
    __syncthreads();
    const int i = r0 + tid;
    long long ev = i < n ? idx[i] : -1;
    const int e = (ev >= 0 && ev < E) ? (int)ev : -1;  // -1: not routed
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (e >= 0 && lane == __ffs(peers) - 1)
      wcnt[warp * E + e] = __popc(peers);
    __syncthreads();
    for (int t = tid; t < E; t += kDispatchThreads) {
      int run = base[t];
      for (int w = 0; w < kDispatchWarps; ++w) {
        const int c = wcnt[w * E + t];
        wcnt[w * E + t] = run;
        run += c;
      }
      base[t] = run;
    }
    __syncthreads();
    if (i >= first && i < last) {
      int s = -1;
      if (e >= 0) {
        const int pos = wcnt[warp * E + e] + rank;
        s = pos < C ? e * C + pos : -1;  // only a repeated expert overflows
      }
      own[i - first] = s;
      slot[i] = s;
    }
    __syncthreads();
  }
  if (blockIdx.x == 0)
    for (int t = tid; t < E; t += kDispatchThreads) counts[t] = min(base[t], C);
  // gather: x[token] -> buf[slot] for this block's assignments
  const int m = last - first;
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = d / kVec;
    for (int i = tid; i < m * per_row; i += kDispatchThreads) {
      const int a = i / per_row, c = (i % per_row) * kVec;
      const int s = own[a];
      if (s < 0) continue;
      const int tok = (first + a) / k;
      *reinterpret_cast<uint4*>(buf + (size_t)s * d + c) =
          *reinterpret_cast<const uint4*>(x + (size_t)tok * d + c);
    }
  } else {
    for (int i = tid; i < m * d; i += kDispatchThreads) {
      const int a = i / d, c = i % d;
      const int s = own[a];
      if (s < 0) continue;
      buf[(size_t)s * d + c] = x[(size_t)((first + a) / k) * d + c];
    }
  }
}

// y[t] = sum over j = 0..k-1 of T(gate[t, j]) * out[slot[t, j]], in f32
// with explicit round-to-nearest products and adds (no contraction, so
// the plain version's order and roundings), rounded once to T.  Grid
// (T, column blocks).
template <typename T>
__global__ void __launch_bounds__(256)
moe_combine_kernel(const T* __restrict__ out, const int* __restrict__ slot,
                   const float* __restrict__ gate, T* __restrict__ y, int k,
                   int d) {
  const int t = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) {
    const int s = slot[t * k + j];
    if (s < 0) continue;
    const float g = round_to<T>(gate[t * k + j]);
    acc = __fadd_rn(acc, __fmul_rn(g, to_f32(out[(size_t)s * d + c])));
  }
  y[(size_t)t * d + c] = from_f32<T>(acc);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
cudaError_t gmm(const void* a, const void* w, const void* w_up, void* out,
                const int* rows, int E, int C, int D, int F,
                cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec = F % kVec == 0 && aligned16(w) && (!w_up || aligned16(w_up));
  const int tm = C <= 2 * kRowGroups ? 1 : 4;
  const int bm = kRowGroups * tm;
  dim3 grid((C + bm - 1) / bm, (F + kBN - 1) / kBN, E);
  const T* A = static_cast<const T*>(a);
  const T* W = static_cast<const T*>(w);
  const T* U = static_cast<const T*>(w_up);
  T* O = static_cast<T*>(out);
  if (w_up) {
    if (tm == 1)
      gmm_kernel<T, 1, true><<<grid, kThreads, 0, st>>>(A, W, U, O, rows, C,
                                                        D, F, vec);
    else
      gmm_kernel<T, 4, true><<<grid, kThreads, 0, st>>>(A, W, U, O, rows, C,
                                                        D, F, vec);
  } else {
    if (tm == 1)
      gmm_kernel<T, 1, false><<<grid, kThreads, 0, st>>>(A, W, U, O, rows, C,
                                                         D, F, vec);
    else
      gmm_kernel<T, 4, false><<<grid, kThreads, 0, st>>>(A, W, U, O, rows, C,
                                                         D, F, vec);
  }
  return cudaGetLastError();
}

constexpr int kPerBlock = 8;  // assignments each dispatch block gathers

template <typename T>
cudaError_t dispatch(const void* x, const int64_t* idx, int* slot,
                     int* counts, void* buf, int n_tok, int k, int d, int E,
                     int C, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec = d % kVec == 0 && aligned16(x) && aligned16(buf);
  const int n = n_tok * k;
  const size_t bytes = (size_t)(kDispatchWarps * E + E + kPerBlock) * 4;
  auto kernel = moe_dispatch_kernel<T>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(n + kPerBlock - 1) / kPerBlock, kDispatchThreads, bytes, st>>>(
      static_cast<const T*>(x), idx, slot, counts, static_cast<T*>(buf),
      n_tok, k, d, E, C, kPerBlock, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t combine(const void* out, const int* slot, const float* gate,
                    void* y, int n_tok, int k, int d, cudaStream_t st) {
  dim3 grid(n_tok, (d + 255) / 256);
  moe_combine_kernel<T><<<grid, 256, 0, st>>>(
      static_cast<const T*>(out), slot, gate, static_cast<T*>(y), k, d);
  return cudaGetLastError();
}

}  // namespace

// a (E, C, D), w/w_up (E, D, F) and out (E, C, F), contiguous, all of one
// type (`bf16` 1: bfloat16, 0: float32).  w_up null: out = a @ w; else
// out = silu(a @ w) * (a @ w_up) with K5's roundings.  rows (E,) int32 or
// null.  Returns cudaGetLastError() after the launch.
extern "C" int grouped_matmul_launch(const void* a, const void* w,
                                     const void* w_up, void* out,
                                     const void* rows, int E, int C, int D,
                                     int F, int bf16, void* stream) {
  if (E == 0 || C == 0 || F == 0) return 0;
  const int* r = static_cast<const int*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? gmm<__nv_bfloat16>(a, w, w_up, out, r, E, C, D, F, st)
              : gmm<float>(a, w, w_up, out, r, E, C, D, F, st);
}

// x (T, d) contiguous; idx (T, k) int64; slot (T, k) and counts (E,)
// int32 outputs; buf (E * C, d) output, only routed slots written.
extern "C" int moe_dispatch_launch(const void* x, const void* idx, void* slot,
                                   void* counts, void* buf, int n_tok, int k,
                                   int d, int E, int C, int bf16,
                                   void* stream) {
  if (n_tok == 0 || k == 0) return 0;
  const int64_t* ix = static_cast<const int64_t*>(idx);
  int* sl = static_cast<int*>(slot);
  int* ct = static_cast<int*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(x, ix, sl, ct, buf, n_tok, k, d, E, C,
                                        st)
              : dispatch<float>(x, ix, sl, ct, buf, n_tok, k, d, E, C, st);
}

// out (E * C, d) expert outputs; slot (T, k) int32; gate (T, k) f32;
// y (T, d) output in out's type.
extern "C" int moe_combine_launch(const void* out, const void* slot,
                                  const void* gate, void* y, int n_tok, int k,
                                  int d, int bf16, void* stream) {
  if (n_tok == 0 || d == 0) return 0;
  const int* sl = static_cast<const int*>(slot);
  const float* g = static_cast<const float*>(gate);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? combine<__nv_bfloat16>(out, sl, g, y, n_tok, k, d, st)
              : combine<float>(out, sl, g, y, n_tok, k, d, st);
}
