// Grouped (per-expert) matmul and the drop-free MoE decode FFN for Hopper
// (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/moe_gmm.py:
//   - `grouped_matmul` / `_gmm_kernel` (K4): out[e] = buf[e] @ w[e] over
//     (E, C, D) x (E, D, F) with an f32 accumulator.  Here one kernel a
//     type: `gmm_mma_kernel` for bf16 (tensor cores), `gmm_kernel` for f32
//     (CUDA cores, so the 1e-5 f32 gate holds without TF32).
//   - `moe_decode_gmm` (K5): token -> expert dispatch into a drop-free
//     (E, C, d) buffer, gate and up products with SiLU gating, the down
//     product, and the gate-weighted combine back to (T, d).  Here four
//     launches: `moe_dispatch_kernel`, K4 gated (gate and up in one pass,
//     two accumulators), K4 (down), and `moe_combine_kernel`.
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
// What the bf16 design does about it.
//   - Weights on the M side: out[e]^T = w[e]^T buf[e]^T, so 64 weight
//     columns of one expert are the 16-row m-tiles of mma.m16n8k16 (four
//     warps, each its own m-tiles) and the tokens its 8-wide n-tiles: at
//     decode C = 8 fills an n-tile exactly.  A fragments come from the
//     (D, F) row-major weight tile by ldmatrix.trans, B fragments from the
//     (C, D) activations by ldmatrix.
//   - The weight stream is the whole cost at decode, so it is pipelined: a
//     block walks D in 64-deep stages through a ring of 3 shared
//     stages filled by cp.async.cg, 2 of them in flight while
//     one computes (the gated variant stages the gate and up tiles side by
//     side); tiles are XOR-swizzled so ldmatrix is free of bank conflicts.
//   - A block takes all the live rows of its expert, up to 64 (a prefill
//     chunk's 256-row capacity splits into row blocks); n-tiles run over
//     live rows only.  A block whose first row is at or past the expert's
//     row count returns at once, so an expert no token picked is never
//     read, and rows past the count are neither read (zero-filled in
//     shared memory) nor written.
//   - Batch invariance, bitwise: every output element is the f32 sum over
//     k of one mma instruction per 16-deep step, in increasing k order,
//     from zero, whatever C, the live rows or the row's place in its
//     n-tile; there is no split-K and no reduction whose order depends on
//     the batch.  The combine sums a token's k slots in order j = 0 .. k-1
//     with explicit round-to-nearest adds and products, and no atomics
//     anywhere, so a token's result does not depend on the batch it is in.
//   - Rounding points are the TPU kernel's: each product is rounded to the
//     input type (the Pallas call's output type), SiLU(g) is rounded, then
//     SiLU(g) * u is rounded; the combine works in f32 and rounds once.
//   - Ragged shapes (D % 8 or F % 8 != 0, pointers not 16-byte aligned)
//     run in the same kernel, staged element by element with zero fill.
// The f32 kernel keeps a (BM x 64) output tile a block, 32-deep stages and
// one fmaf chain per output element in k order, so it is batch-invariant
// in the same way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

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

template <typename T>
cudaError_t gmm(const void* a, const void* w, const void* w_up, void* out,
                const int* rows, int E, int C, int D, int F,
                cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec =
      F % kVec == 0 && mma::aligned16(w) && (!w_up || mma::aligned16(w_up));
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

constexpr int kMmaThreads = 128;  // four warps
constexpr int kMmaBN = 64;        // weight columns (output features) a block
constexpr int kMmaBK = 64;        // depth a stage
constexpr int kMmaBR = 64;        // rows (tokens) a block, at most
constexpr int kMmaStages = 3;     // shared-memory stages in the ring

// one ring slot: the weight tile (two, gated) and the activation rows a
// block can hold, min(C rounded up to 8, 64), so that a decode launch (C =
// 8) keeps its shared memory to the weights and fits more blocks an SM
__host__ __device__ constexpr uint32_t mma_stage_bytes(bool gated, int C) {
  return (gated ? 2u : 1u) * kMmaBK * kMmaBN * 2u +
         (uint32_t)((C + 7) / 8 * 8 < kMmaBR ? (C + 7) / 8 * 8 : kMmaBR) *
             kMmaBK * 2u;
}

// One (up to 64 rows x kMmaBN columns) tile of out[e] = a[e] @ w[e] (or,
// gated, of silu(a[e] @ w[e]) * (a[e] @ w_up[e])) in bf16 on the tensor
// cores, computed as its transpose: weight columns on mma's M side, rows on
// its N side.  Grid (row blocks, column blocks, E).  `rows` (E,) int32 or
// null: rows at or past rows[e] are neither read nor written.  `vec`: rows
// of a, w, w_up and out start 16-byte aligned (cp.async and 16-byte
// stores); else the same tiles are staged element by element.
template <bool kGated>
__global__ void __launch_bounds__(kMmaThreads)
gmm_mma_kernel(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ w,
               const __nv_bfloat16* __restrict__ w_up,
               __nv_bfloat16* __restrict__ out, const int* __restrict__ rows,
               int C, int D, int F, int vec) {
  constexpr int kNT = kMmaBR / 8;         // n-tiles (8 rows) a block
  constexpr int kWPitch = kMmaBN / 8;     // chunks a weight tile row
  constexpr int kAPitch = kMmaBK / 8;     // chunks an activation tile row
  constexpr uint32_t kWBytes = kMmaBK * kMmaBN * 2;
  constexpr uint32_t kAOff = (kGated ? 2 : 1) * kWBytes;
  const uint32_t stage_bytes = mma_stage_bytes(kGated, C);

  const int e = blockIdx.z;
  const int n_rows = rows ? min(rows[e], C) : C;
  const int row0 = blockIdx.x * kMmaBR;
  if (row0 >= n_rows) return;  // uniform over the block
  const int live = min(n_rows - row0, kMmaBR);
  const int n_tiles = (live + 7) / 8;
  const int col0 = blockIdx.y * kMmaBN;
  const __nv_bfloat16* A = a + ((size_t)e * C + row0) * D;
  const __nv_bfloat16* W = w + (size_t)e * D * F;
  const __nv_bfloat16* U = kGated ? w_up + (size_t)e * D * F : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_k = (D + kMmaBK - 1) / kMmaBK;

  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t s0 = mma::smem_addr(smem_tc);

  // stage kt of the depth into ring slot `slot`: weight rows k0 .. k0 + 63
  // (columns col0 ..), activation rows of the live n-tiles (zero past
  // `live`), zero past D and F
  auto load_stage = [&](int slot, int kt) {
    const uint32_t base = s0 + slot * stage_bytes;
    const int k0 = kt * kMmaBK;
    for (int i = threadIdx.x; i < kMmaBK * kWPitch; i += kMmaThreads) {
      const int r = i / kWPitch, c = i % kWPitch;
      const int d = k0 + r, f = col0 + 8 * c;
      const bool in = d < D && f < F;
      const size_t off = in ? (size_t)d * F + f : 0;
      const uint32_t at = base + mma::swz(r, c, kWPitch);
      mma::stage16(at, W + off, in, F - f, vec);
      if constexpr (kGated) mma::stage16(at + kWBytes, U + off, in, F - f, vec);
    }
    for (int i = threadIdx.x; i < n_tiles * 8 * kAPitch; i += kMmaThreads) {
      const int r = i / kAPitch, c = i % kAPitch;
      const int d = k0 + 8 * c;
      const bool in = r < live && d < D;
      mma::stage16(base + kAOff + mma::swz(r, c, kAPitch),
                   A + (in ? (size_t)r * D + d : 0), in, D - d, vec);
    }
  };

  // each warp one 16-column m-tile
  float acc[kNT][4], accu[kGated ? kNT : 1][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[nt][i] = 0.f;
      if constexpr (kGated) accu[nt][i] = 0.f;
    }

#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < n_k) load_stage(st, st);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    mma::cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // stage kt landed; every warp is done with kt - 1
    const int next = kt + kMmaStages - 1;
    if (next < n_k) load_stage(next % kMmaStages, next);
    mma::cp_async_commit();

    const uint32_t base = s0 + (kt % kMmaStages) * stage_bytes;
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      uint32_t af[4], uf[4];
      const uint32_t at = mma::swz(16 * ks + (lane & 7) + ((lane >> 4) << 3),
                                   2 * warp + ((lane >> 3) & 1), kWPitch);
      mma::ldsm_x4_t(af, base + at);
      if constexpr (kGated) mma::ldsm_x4_t(uf, base + kWBytes + at);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt >= n_tiles) break;  // uniform over the block
        uint32_t b0, b1;
        mma::ldsm_x2(b0, b1, base + kAOff +
                                 mma::swz(8 * nt + (lane & 7),
                                          2 * ks + ((lane >> 3) & 1), kAPitch));
        mma::mma_bf16(acc[nt], af, b0, b1);
        if constexpr (kGated) mma::mma_bf16(accu[nt], uf, b0, b1);
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free: slot 0 holds the output tile

  // C fragments -> a (rows x kMmaBN) bf16 tile, then out by rows
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    if (nt >= n_tiles) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = 16 * warp + g + 8 * (i >> 1);
      const int r = 8 * nt + 2 * t4 + (i & 1);
      float v = acc[nt][i];
      if constexpr (kGated) {
        // each product rounded to bf16, silu(g) rounded, then silu(g) * u
        const float gv = round_to<__nv_bfloat16>(v);
        const float u = round_to<__nv_bfloat16>(accu[nt][i]);
        const float s = round_to<__nv_bfloat16>(gv / (1.f + expf(-gv)));
        v = s * u;
      }
      const __nv_bfloat16 h = __float2bfloat16(v);
      asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(
                       s0 + mma::swz(r, f >> 3, kWPitch) + 2 * (f & 7)),
                   "h"(__bfloat16_as_ushort(h))
                   : "memory");
    }
  }
  __syncthreads();
  __nv_bfloat16* O = out + ((size_t)e * C + row0) * F;
  for (int i = threadIdx.x; i < live * kWPitch; i += kMmaThreads) {
    const int r = i / kWPitch, c = i % kWPitch;
    const int f = col0 + 8 * c;
    if (f >= F) continue;
    uint32_t v[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(s0 + mma::swz(r, c, kWPitch))
                 : "memory");
    __nv_bfloat16* to = O + (size_t)r * F + f;
    if (vec) {
      *reinterpret_cast<uint4*>(to) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < F - f) to[j] = h[j];
    }
  }
}

cudaError_t gmm_bf16(const void* a, const void* w, const void* w_up,
                     void* out, const int* rows, int E, int C, int D, int F,
                     cudaStream_t st) {
  const int vec = D % 8 == 0 && F % 8 == 0 && mma::aligned16(a) &&
                  mma::aligned16(w) && (!w_up || mma::aligned16(w_up)) &&
                  mma::aligned16(out);
  dim3 grid((C + kMmaBR - 1) / kMmaBR, (F + kMmaBN - 1) / kMmaBN, E);
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* W = static_cast<const __nv_bfloat16*>(w);
  const auto* U = static_cast<const __nv_bfloat16*>(w_up);
  auto* O = static_cast<__nv_bfloat16*>(out);
  const bool gated = w_up != nullptr;
  auto kernel = gated ? gmm_mma_kernel<true> : gmm_mma_kernel<false>;
  const int bytes = kMmaStages * (int)mma_stage_bytes(gated, C);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, bytes, st>>>(A, W, U, O, rows, C, D, F, vec);
  return cudaGetLastError();
}

constexpr int kPerBlock = 8;  // assignments each dispatch block gathers

template <typename T>
cudaError_t dispatch(const void* x, const int64_t* idx, int* slot,
                     int* counts, void* buf, int n_tok, int k, int d, int E,
                     int C, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec = d % kVec == 0 && mma::aligned16(x) && mma::aligned16(buf);
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
// type (`bf16` 1: bfloat16 on the tensor cores, 0: float32 on the CUDA
// cores).  w_up null: out = a @ w; else
// out = silu(a @ w) * (a @ w_up) with K5's roundings.  rows (E,) int32 or
// null.  Returns cudaGetLastError() after the launch.
extern "C" int grouped_matmul_launch(const void* a, const void* w,
                                     const void* w_up, void* out,
                                     const void* rows, int E, int C, int D,
                                     int F, int bf16, void* stream) {
  if (E == 0 || C == 0 || F == 0) return 0;
  const int* r = static_cast<const int*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? gmm_bf16(a, w, w_up, out, r, E, C, D, F, st)
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
