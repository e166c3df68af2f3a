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
// where L[i, j] = exp(a_cum[i] - a_cum[j]) for i >= j and 0 above the
// diagonal (the mask goes before the exp, as on the TPU).  y is written in
// x's type.  B and C are shared by the heads.  The final state is not
// returned, as on the TPU.
//
// Bound on this card.  The function needs s^2 N multiply-adds per (b,
// chunk) for C B^T, and s^2 P / 2 + 2 s P N per (b, h, chunk), against
// 2 s P bytes of x and y per (b, h, chunk): in bf16 at the tensor cores'
// rate the bytes bound it, in f32 at the CUDA cores' rate the operations.
// The TPU's grid walks the chunk axis in order; a block that did the same
// here (one per (b, h): 64 or 160 at the train shape) left most of the
// card idle, and its f32 FMAs waited on two shared-memory loads each.
// This kernel reaches neither bound either: each block is one chain of
// dependent steps (copy in, products, two cluster barriers, products, copy
// out) with only two blocks an SM (bf16) or one (f32) to cover each
// other's waits, so latency bounds it (PERF.md gives the measured split).
//
// Design.  Parallel over chunks: one block per (b, h, chunk), the chunk
// axis a thread-block cluster of up to 8 blocks (grid (CL, H, B)); longer
// sequences walk windows of CL chunks in order.  Every block computes its
// chunk's in-chunk term and its local state contribution
// sum_j w_j x_j (x) B_j at once; the carried state then passes through the
// cluster's distributed shared memory: after a cluster barrier, block r
// runs the chain carried_{c+1} = exp(a_sum_c) carried_c + local_c over the
// window's chunks, in chunk order, for its 1/CL of the (P, N) elements,
// reading every block's local state and writing back each block's chunk-
// start state in its place (and, for the backward, to `states`); the last
// chunk's carry waits in the owner's shared memory for the next window.
// After a second barrier each block adds (exp(a_cum) (.) C) carried^T.
// This is the split of the published Mamba2 kernels (chunk state, state
// passing, chunk scan) in one launch, with the states kept on chip.
//
// bf16 (`ssd_fwd_mma_kernel`): the four products on the tensor cores,
// mma.sync m16n8k16 with f32 sums.  C B^T takes C and B as given; the
// three products with an operand computed in f32 (W = C B^T (.) L (.) dt,
// the carried state, w (.) x) feed that operand as a bf16 hi/lo pair, two
// products, so each term keeps ~16 significant bits where one bf16
// rounding would keep 8.  Warp w owns rows 16 w .. 16 w + 15 of the chunk:
// for each 16-column block under the diagonal it forms C B^T in
// registers, turns it into W (L through ex2.approx) and multiplies W into
// x.  Tile w has w + 1 such blocks, so warps w and 7 - w share the nine of
// tiles w and 7 - w, five and four (causal_blocks).  Tiles are swizzled
// rows of 16-byte chunks (mma_common.cuh); the local state's (P, N) f32
// tile takes the place of B once B is consumed, and after the chain it is
// split once into bf16 hi/lo tiles that the C carried^T product reads by
// ldmatrix.  A block holds 104 KB of shared memory, laid out for s = 128,
// so two share an SM; to fit their registers (two blocks' share is 128 a
// thread) the local state runs in two passes, the first waiting in the
// hand-over buffer, and C carried^T in two halves of P.
//
// f32 (`ssd_fwd_tf32_kernel`, the train path): the same grid, hand-off and
// warp layout, the products on the tensor cores in 3xTF32: mma.sync
// m16n8k8 with each f32 operand as a TF32 hi/lo pair and three products
// (a_lo b_hi + a_hi b_lo + a_hi b_hi), ~2^-21 of each term, as close to
// the plain f32 version as FMAs summed in another order.  Fragments come
// from f32 tiles with rows padded to 4 floats past a multiple of 32
// (conflict-free for the row-indexed loads); W's C-fragment feeds W x as
// its A fragment with the k order permuted.  188 KB of shared memory, one
// block an SM.
//
// Every block stages its chunk with asynchronous copies.  The in-chunk
// prefix sum of dt * A is sequential (`chunk_cumsum`): warp 0
// copies dt as a group of its own and thread 0 sums while the tiles are in
// flight.  x, dt, y are read and written through (b, h, l) strides, so the
// model's (B, L, H, P) layout is taken without a copy.
#include <cooperative_groups.h>

#include <algorithm>

#include "mma_common.cuh"
#include "ssd_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ssd;
using mma::mma_3xtf32;
using mma::smem_addr;
using mma::swz;
using mma::Tf32;
using mma::tf32;

constexpr int kCarry = 4;          // carried elements an owner thread holds
constexpr int kBCPitch = 16;       // 16-byte chunks a row of C, B (N <= 128)
constexpr int kXPitch = 8;         // 16-byte chunks a row of x (P <= 64)
constexpr int kStPitch = kMaxN + 8;  // floats a row of the bf16 state
constexpr int kPart = 4 * 8 * 32;  // float4 of W x a low warp hands over

// Block r's share of the chain over the window's nq chunks.  `st` holds,
// in each block q of the cluster, chunk q's local state (row pitch
// `pitch`); it is replaced by chunk q's start state.  decay_s: each
// block's exp(a_sum).  carry: the owner's running state between windows
// (kCarry * kThreads floats).  states: NULL, or the f32 start state of the
// window's first chunk (then one (P, N) slab per chunk).  An element's
// remote loads fly together; the accumulators of the caller stay live, so
// no more registers than that.
__device__ __forceinline__ void state_chain(cg::cluster_group& cluster,
                                            float* st, int pitch, int P,
                                            int N, int nq, bool first,
                                            bool more, const float* decay_s,
                                            float* carry,
                                            float* __restrict__ states) {
  const int r = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int E = P * N;
  const int per = (E + CL - 1) / CL;
  const int e0 = r * per, e1 = min(E, e0 + per);
  float dec[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    dec[q] = q < nq ? *cluster.map_shared_rank(decay_s, q) : 0.f;
  int slot = threadIdx.x;
  for (int e = e0 + (int)threadIdx.x; e < e1;
       e += kThreads, slot += kThreads) {
    const int p = e / N;
    float* elem = st + p * pitch + (e - p * N);
    float loc[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < nq) loc[q] = *cluster.map_shared_rank(elem, q);
    float run = first ? 0.f : carry[slot];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < nq) {
        *cluster.map_shared_rank(elem, q) = run;
        if (states) states[(size_t)q * E + e] = run;
        // state * decay + local, rounded twice as the plain version does
        run = __fadd_rn(__fmul_rn(run, dec[q]), loc[q]);
      }
    if (more) carry[slot] = run;
  }
}

// The causal in-chunk work of a chunk of 8 row tiles (s > 112): tile w has
// w + 1 16-column blocks.  Warps w and 7 - w (w < 4) share tiles w and
// 7 - w, nine blocks, as five and four: the low warp first takes tile
// 7 - w's blocks [0, 4 - w), hands them over in `part` and takes its own
// tile; after a barrier the high warp adds them (hand_over_add).  Smaller
// chunks keep one tile a warp.  in_chunk(r0, jb0, jb1, acc) adds tile
// r0 / 16's blocks [jb0, jb1) into acc.
template <typename F>
__device__ __forceinline__ void causal_blocks(int rows, float (&acc)[8][4],
                                              float4* part, F&& in_chunk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (rows == 8 * 16 && warp < 4) {
    in_chunk(16 * (7 - warp), 0, 4 - warp, acc);
    float4* dst = part + warp * 8 * 32 + lane;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      dst[n * 32] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
    in_chunk(16 * warp, 0, warp + 1, acc);
  } else if (rows == 8 * 16) {
    in_chunk(16 * warp, warp - 3, warp + 1, acc);
  } else if (16 * warp < rows) {
    in_chunk(16 * warp, 0, warp + 1, acc);
  }
}

// the high warp's share of causal_blocks, after a barrier
__device__ __forceinline__ void hand_over_add(int rows, float (&acc)[8][4],
                                              const float4* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (rows != 8 * 16 || warp < 4) return;
  const float4* src = part + (7 - warp) * 8 * 32 + lane;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float4 v = src[n * 32];
    acc[n][0] += v.x;
    acc[n][1] += v.y;
    acc[n][2] += v.z;
    acc[n][3] += v.w;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
// exp(x) as 2^(x log2 e) on the special-function unit: ~2^-22 relative
// error plus the rounding of the product, far below the hi/lo split's
// 2^-17; the bf16 kernel's L only (the f32 kernel keeps expf)
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The bf16 kernel's shared memory, laid out for the largest chunk so that
// every array sits at a constant offset (s <= 128 rows): C, then B and in
// its place the (P, N) state, x, the hand-over buffer, four per-row
// arrays, the carry and the decay.
constexpr uint32_t kCOff = 0;
constexpr uint32_t kBCBytes = kMaxS * kBCPitch * 16;
constexpr uint32_t kStBytes = kMaxP * kStPitch * 4;
constexpr uint32_t kROff = kCOff + kBCBytes;
constexpr uint32_t kXOff =
    kROff + (kBCBytes > kStBytes ? kBCBytes : kStBytes);
constexpr uint32_t kPartOff = kXOff + kMaxS * kXPitch * 16;
constexpr uint32_t kRowsOff = kPartOff + kPart * 16;
constexpr uint32_t kCarryOff = kRowsOff + 4 * kMaxS * 4;
constexpr uint32_t kDecayOff = kCarryOff + kCarry * kThreads * 4;
constexpr uint32_t kMmaSmem = kDecayOff + 16;

// 16-byte chunks [0, width / 8) of rows [0, rows) of a (rows, width) bf16
// slab, row stride ld, into a swizzled tile of `pitch` chunks; zeros past
// row n_valid and past column `width`
__device__ __forceinline__ void stage_bf16(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           long long ld, int n_valid,
                                           int rows, int width, int chunks,
                                           int pitch, bool vec) {
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    const bool in = r < n_valid && 8 * c < width;
    mma::stage16(dst + swz(r, c, pitch), in ? src + r * ld + 8 * c : src, in,
                 width - 8 * c, vec);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    ssd_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const __nv_bfloat16* __restrict__ Bm,
                       const __nv_bfloat16* __restrict__ Cm,
                       const float* __restrict__ D,
                       __nv_bfloat16* __restrict__ y,
                       float* __restrict__ states, Strides sd, int H, int L,
                       int P, int N, int s) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nc = L / s, nw = (nc + CL - 1) / CL;
  const int rows = round16(s);
  const int Pp = P <= 16 ? 16 : (P <= 32 ? 32 : 64);  // a power of 2
  const int Np = round16(N);

  const uint32_t base = smem_addr(smem_raw);
  const uint32_t cs = base + kCOff, bs = base + kROff, xs = base + kXOff;
  float* st = reinterpret_cast<float*>(smem_raw + kROff);  // B's place
  unsigned char* xs_ptr = smem_raw + kXOff;
  float4* part = reinterpret_cast<float4*>(smem_raw + kPartOff);
  float* acum = reinterpret_cast<float*>(smem_raw + kRowsOff);
  float* ecum = acum + kMaxS;
  float* wv = ecum + kMaxS;
  float* dts = wv + kMaxS;
  float* carry = reinterpret_cast<float*>(smem_raw + kCarryOff);
  float* decay_s = reinterpret_cast<float*>(smem_raw + kDecayOff);

  const float Av = A[b * sd.a[0] + h * sd.a[1]];
  const float Dv = D[b * sd.d[0] + h * sd.d[1]];
  const __nv_bfloat16* xb = x + b * sd.x[0] + h * sd.x[1];
  const float* dtb = dt + b * sd.dt[0] + h * sd.dt[1];
  const __nv_bfloat16* bmb = Bm + b * sd.bm[0];
  const __nv_bfloat16* cmb = Cm + b * sd.cm[0];
  __nv_bfloat16* yb = y + b * sd.y[0] + h * sd.y[1];
  const bool vec_x = P % 8 == 0 && sd.x[2] % 8 == 0 && mma::aligned16(x) &&
                     sd.x[0] % 8 == 0 && sd.x[1] % 8 == 0;
  const bool vec_y = P % 8 == 0 && sd.y[2] % 8 == 0 && mma::aligned16(y) &&
                     sd.y[0] % 8 == 0 && sd.y[1] % 8 == 0;
  const bool vec_bc = N % 8 == 0 && sd.bm[1] % 8 == 0 && sd.cm[1] % 8 == 0 &&
                      sd.bm[0] % 8 == 0 && sd.cm[0] % 8 == 0 &&
                      mma::aligned16(Bm) && mma::aligned16(Cm);

  // rows of this warp (the C-fragment rows g and g + 8 of its tile)
  const int i0 = 16 * warp;
  const bool row_warp = i0 < rows;
  const int ia = i0 + g, ib = ia + 8;

  for (int w = 0; w < nw; ++w) {
    const int c = w * CL + rank;
    const bool active = c < nc;
    float acc[8][4];  // (rows, P): W x, then + exp(a_cum) C carried^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    if (active) {
      const long long l0 = (long long)c * s;
      chunk_dt_start(dtb + l0 * sd.dt[2], sd.dt[2], dts, s);
      stage_bf16(cs, cmb + l0 * sd.cm[1], sd.cm[1], s, rows, N, Np / 8,
                 kBCPitch, vec_bc);
      stage_bf16(bs, bmb + l0 * sd.bm[1], sd.bm[1], s, rows, N, Np / 8,
                 kBCPitch, vec_bc);
      stage_bf16(xs, xb + l0 * sd.x[2], sd.x[2], s, rows, P, Pp / 8,
                 kXPitch, vec_x);
      mma::cp_async_commit();
      chunk_dt_sum(Av, dts, acum, s);
      mma::cp_async_wait<0>();
      __syncthreads();
      chunk_rows(dts, acum, ecum, wv, decay_s, s, rows);
      __syncthreads();

      // in-chunk term of row tile r0 (rows r0 .. r0 + 15) over the
      // 16-column blocks [jb0, jb1) under the diagonal: C B^T in
      // registers, then W = C B^T (.) L (.) dt as hi + lo, into x
      auto in_chunk = [&](int r0, int jb0, int jb1, float(&out)[8][4]) {
        const int ra = r0 + g, rb = ra + 8;
        const float aa = acum[min(ra, s - 1)], ab = acum[min(rb, s - 1)];
        for (int j0 = 16 * jb0; j0 < 16 * jb1 && j0 < s; j0 += 16) {
          float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 2
          for (int ks = 0; ks < Np / 16; ++ks) {
            uint32_t a[4], bb[4];
            mma::ldsm_x4(a, cs + swz(r0 + (lane & 15), 2 * ks + (lane >> 4),
                                     kBCPitch));
            mma::ldsm_x4(bb, bs + swz(j0 + (lane & 7) + ((lane >> 4) << 3),
                                      2 * ks + ((lane >> 3) & 1), kBCPitch));
            mma::mma_bf16(cb[0], a, bb[0], bb[1]);
            mma::mma_bf16(cb[1], a, bb[2], bb[3]);
          }
          float wf[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? ra : rb;
              const int j = j0 + 8 * nt + 2 * t + (e & 1);
              wf[nt][e] = (j <= i && i < s)
                              ? cb[nt][e] *
                                    exp_fast((e < 2 ? aa : ab) - acum[j]) *
                                    dts[j]
                              : 0.f;
            }
          uint32_t whi[4], wlo[4];
          mma::split_bf16(wf[0][0], wf[0][1], whi[0], wlo[0]);
          mma::split_bf16(wf[0][2], wf[0][3], whi[1], wlo[1]);
          mma::split_bf16(wf[1][0], wf[1][1], whi[2], wlo[2]);
          mma::split_bf16(wf[1][2], wf[1][3], whi[3], wlo[3]);
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            if (16 * pp >= Pp) break;
            uint32_t xv[4];
            mma::ldsm_x4_t(xv, xs + swz(j0 + (lane & 7) + (lane & 8),
                                        2 * pp + (lane >> 4), kXPitch));
            mma::mma_bf16(out[2 * pp], whi, xv[0], xv[1]);
            mma::mma_bf16(out[2 * pp], wlo, xv[0], xv[1]);
            mma::mma_bf16(out[2 * pp + 1], whi, xv[2], xv[3]);
            mma::mma_bf16(out[2 * pp + 1], wlo, xv[2], xv[3]);
          }
        }
      };
      causal_blocks(rows, acc, part, in_chunk);

      __syncthreads();  // the low warps' column blocks are in `part`
      hand_over_add(rows, acc, part);
      __syncthreads();  // `part` is free again

      // local state: (w (.) x)^T B, (P, N); warp w takes p-tile w % TP and
      // its share of the n-tile pairs, in two passes of up to two pairs (the
      // first pass waits in `part` while B is still read)
      const int TP = Pp / 16, GR = (kThreads / 32) / TP, NP2 = Np / 16;
      const int pt = warp % TP, gi = warp / TP;
      const int ppg = (NP2 + GR - 1) / GR;
      const int np0 = gi * ppg, np1 = min(NP2, np0 + ppg);
      float la[4][4];
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) la[n][e] = 0.f;
        const int q0 = np0 + 2 * pass;
        if (q0 < np1) {
          for (int j0 = 0; j0 < rows; j0 += 16) {
            uint32_t xa[4];
            mma::ldsm_x4_t(xa, xs + swz(j0 + (lane & 7) + ((lane >> 4) << 3),
                                        2 * pt + ((lane >> 3) & 1), kXPitch));
            const float w0 = wv[j0 + 2 * t], w1 = wv[j0 + 2 * t + 1];
            const float w8 = wv[j0 + 2 * t + 8], w9 = wv[j0 + 2 * t + 9];
            uint32_t ahi[4], alo[4];
            mma::split_bf16(mma::bf16_lo(xa[0]) * w0, mma::bf16_hi(xa[0]) * w1,
                            ahi[0], alo[0]);
            mma::split_bf16(mma::bf16_lo(xa[1]) * w0, mma::bf16_hi(xa[1]) * w1,
                            ahi[1], alo[1]);
            mma::split_bf16(mma::bf16_lo(xa[2]) * w8, mma::bf16_hi(xa[2]) * w9,
                            ahi[2], alo[2]);
            mma::split_bf16(mma::bf16_lo(xa[3]) * w8, mma::bf16_hi(xa[3]) * w9,
                            ahi[3], alo[3]);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int np = q0 + q;
              if (np >= np1) break;
              uint32_t bv[4];
              mma::ldsm_x4_t(bv, bs + swz(j0 + (lane & 7) + (lane & 8),
                                          2 * np + (lane >> 4), kBCPitch));
              mma::mma_bf16(la[2 * q], ahi, bv[0], bv[1]);
              mma::mma_bf16(la[2 * q], alo, bv[0], bv[1]);
              mma::mma_bf16(la[2 * q + 1], ahi, bv[2], bv[3]);
              mma::mma_bf16(la[2 * q + 1], alo, bv[2], bv[3]);
            }
          }
        }
        if (pass == 0) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
            part[(warp * 4 + n) * 32 + lane] =
                make_float4(la[n][0], la[n][1], la[n][2], la[n][3]);
        }
      }
      __syncthreads();  // B is consumed: the state takes its place
      // (the second pass from registers, the first from `part`)
#pragma unroll
      for (int pass = 0; pass < 2; ++pass)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int np = np0 + 2 * pass + q;
          if (np >= np1) break;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float4 v;
            if (pass == 0) {
              v = part[(warp * 4 + 2 * q + hf) * 32 + lane];
            } else {
              v = make_float4(la[2 * q + hf][0], la[2 * q + hf][1],
                              la[2 * q + hf][2], la[2 * q + hf][3]);
            }
            const int n = 16 * np + 8 * hf + 2 * t;
            const int p = 16 * pt + g;
            *reinterpret_cast<float2*>(st + p * kStPitch + n) =
                make_float2(v.x, v.y);
            *reinterpret_cast<float2*>(st + (p + 8) * kStPitch + n) =
                make_float2(v.z, v.w);
          }
        }
    }

    cluster.sync();  // every local state and decay of the window is out
    state_chain(
        cluster, st, kStPitch, P, N, min(CL, nc - w * CL), w == 0, w + 1 < nw,
        decay_s, carry,
        states ? states + (((size_t)b * H + h) * nc + (size_t)w * CL) * P * N
               : nullptr);
    cluster.sync();  // every chunk-start state is in place

    if (active) {
      // the carried state as bf16 hi and lo tiles in place of its f32
      // rows, 32 rows at a time: tile row p holds hi in chunks 0-15 and lo
      // in chunks 16-31 (512 bytes, below f32 row p's 544: rows still to
      // be read are never overwritten)
      for (int h0 = 0; h0 < Pp; h0 += 32) {
        const int pairs = min(32, Pp - h0) * (Np / 2);
        uint32_t hv[8], lv[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int idx = tid + k * kThreads;
          if (idx < pairs) {
            const int pr = h0 + idx / (Np / 2), n = 2 * (idx % (Np / 2));
            const float2 v =
                *reinterpret_cast<const float2*>(st + pr * kStPitch + n);
            mma::split_bf16(v.x, v.y, hv[k], lv[k]);
          }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int idx = tid + k * kThreads;
          if (idx < pairs) {
            const int pr = h0 + idx / (Np / 2), n = 2 * (idx % (Np / 2));
            const uint32_t off = 2 * (n & 7);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             bs + swz(pr, n >> 3, 2 * kBCPitch) + off),
                         "r"(hv[k]));
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                             bs + swz(pr, kBCPitch + (n >> 3), 2 * kBCPitch) +
                             off),
                         "r"(lv[k]));
          }
        }
        __syncthreads();
      }
      if (row_warp) {
        // exp(a_cum) (.) C carried^T (C as given, the state as hi + lo),
        // then y = W x + that + D x written over x in place; over P in two
        // halves of 32 columns, which keeps the registers under two
        // blocks' share
        const float ea = ecum[ia], eb = ecum[ib];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ph = 32 * half;
          if (ph >= Pp) break;
          float yo[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) yo[n][e] = 0.f;
          for (int ks = 0; ks < Np / 16; ++ks) {
            uint32_t a[4];
            mma::ldsm_x4(a, cs + swz(i0 + (lane & 15), 2 * ks + (lane >> 4),
                                     kBCPitch));
#pragma unroll
            for (int pp = 0; pp < 2; ++pp) {
              if (ph + 16 * pp >= Pp) break;
              const int row = ph + 16 * pp + (lane & 7) + ((lane >> 4) << 3);
              const int ch = 2 * ks + ((lane >> 3) & 1);
              uint32_t hb[4], lb[4];
              mma::ldsm_x4(hb, bs + swz(row, ch, 2 * kBCPitch));
              mma::ldsm_x4(lb, bs + swz(row, kBCPitch + ch, 2 * kBCPitch));
              mma::mma_bf16(yo[2 * pp], a, hb[0], hb[1]);
              mma::mma_bf16(yo[2 * pp], a, lb[0], lb[1]);
              mma::mma_bf16(yo[2 * pp + 1], a, hb[2], hb[3]);
              mma::mma_bf16(yo[2 * pp + 1], a, lb[2], lb[3]);
            }
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int pn = ph / 8 + n;
            if (8 * pn >= Pp) break;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int i = hf ? ib : ia;
              const uint32_t addr = xs + swz(i, pn, kXPitch) + 4 * t;
              uint32_t xv;
              asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(xv) : "r"(addr));
              const float e = hf ? eb : ea;
              const float y0 = acc[pn][2 * hf] + e * yo[n][2 * hf] +
                               Dv * mma::bf16_lo(xv);
              const float y1 = acc[pn][2 * hf + 1] + e * yo[n][2 * hf + 1] +
                               Dv * mma::bf16_hi(xv);
              asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                           "r"(mma::pack_bf16(y0, y1)));
            }
          }
        }
      }
      __syncthreads();
      // the chunk's y rows out, 16 bytes at a time where aligned
      const long long l0 = (long long)c * s;
      const int chunks = (P + 7) / 8;
      for (int idx = tid; idx < s * chunks; idx += kThreads) {
        const int r = idx / chunks, cc = idx - r * chunks;
        const unsigned char* src = xs_ptr + swz(r, cc, kXPitch);
        __nv_bfloat16* dst = yb + (l0 + r) * sd.y[2] + 8 * cc;
        if (vec_y) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(src);
          for (int k = 0; k < 8 && 8 * cc + k < P; ++k) dst[k] = v[k];
        }
      }
      __syncthreads();  // before the next window's copies land
    }
  }
}

// ---------------------------------------------------------------------------
// f32: tensor cores in 3xTF32
// ---------------------------------------------------------------------------
constexpr int kF32Pitch = kMaxN + 4;  // floats a row of C, B, the state
constexpr int kF32XPitch = kMaxP + 4;  // floats a row of x
// fixed layout (s <= 128): C, B and in its place the state, x, the
// hand-over buffer, four per-row arrays, the carry and the decay
constexpr uint32_t kF32BC = kMaxS * kF32Pitch * 4;
constexpr uint32_t kF32COff = 0;
constexpr uint32_t kF32ROff = kF32COff + kF32BC;
constexpr uint32_t kF32XOff = kF32ROff + kF32BC;
constexpr uint32_t kF32PartOff = kF32XOff + kMaxS * kF32XPitch * 4;
constexpr uint32_t kF32RowsOff = kF32PartOff + kPart * 16;
constexpr uint32_t kF32CarryOff = kF32RowsOff + 4 * kMaxS * 4;
constexpr uint32_t kF32DecayOff = kF32CarryOff + kCarry * kThreads * 4;
constexpr uint32_t kF32Smem = kF32DecayOff + 16;

// rows [0, rows) x columns [0, cols) (a multiple of 4) of a (n_valid,
// width) f32 slab with row stride ld into rows of `pitch` floats, zeros
// past row n_valid and column width: 16-byte asynchronous copies where
// `vec` (rows 16-byte aligned, width % 4 == 0), else element by element
__device__ __forceinline__ void stage_f32x4(float* dst, int pitch,
                                            const float* __restrict__ src,
                                            long long ld, int n_valid,
                                            int rows, int width, int cols,
                                            bool vec) {
  const int c4 = cols / 4;
  for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
    const int r = idx / c4, c = 4 * (idx - r * c4);
    float* d = dst + r * pitch + c;
    const bool in = r < n_valid && c < width;
    if (vec) {
      mma::cp_async16(smem_addr(d), in ? src + r * ld + c : src, in);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        d[k] = (in && c + k < width) ? src[r * ld + c + k] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_fwd_tf32_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ D, float* __restrict__ y,
                        float* __restrict__ states, Strides sd, int H, int L,
                        int P, int N, int s) {
  extern __shared__ __align__(128) unsigned char smem_f[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nc = L / s, nw = (nc + CL - 1) / CL;
  const int rows = round16(s);
  const int Pp = round16(P), Np = (N + 7) / 8 * 8;

  float* cs = reinterpret_cast<float*>(smem_f + kF32COff);
  float* bs = reinterpret_cast<float*>(smem_f + kF32ROff);
  float* st = bs;  // the state takes B's place
  float* xs = reinterpret_cast<float*>(smem_f + kF32XOff);
  float4* part = reinterpret_cast<float4*>(smem_f + kF32PartOff);
  float* acum = reinterpret_cast<float*>(smem_f + kF32RowsOff);
  float* ecum = acum + kMaxS;
  float* wv = ecum + kMaxS;
  float* dts = wv + kMaxS;
  float* carry = reinterpret_cast<float*>(smem_f + kF32CarryOff);
  float* decay_s = reinterpret_cast<float*>(smem_f + kF32DecayOff);

  const float Av = A[b * sd.a[0] + h * sd.a[1]];
  const float Dv = D[b * sd.d[0] + h * sd.d[1]];
  const float* xb = x + b * sd.x[0] + h * sd.x[1];
  const float* dtb = dt + b * sd.dt[0] + h * sd.dt[1];
  const float* bmb = Bm + b * sd.bm[0];
  const float* cmb = Cm + b * sd.cm[0];
  float* yb = y + b * sd.y[0] + h * sd.y[1];
  const bool vec_x = P % 4 == 0 && sd.x[2] % 4 == 0 && mma::aligned16(x) &&
                     sd.x[0] % 4 == 0 && sd.x[1] % 4 == 0;
  const bool vec_y = P % 4 == 0 && sd.y[2] % 4 == 0 && mma::aligned16(y) &&
                     sd.y[0] % 4 == 0 && sd.y[1] % 4 == 0;
  const bool vec_bc = N % 4 == 0 && sd.bm[1] % 4 == 0 && sd.cm[1] % 4 == 0 &&
                      sd.bm[0] % 4 == 0 && sd.cm[0] % 4 == 0 &&
                      mma::aligned16(Bm) && mma::aligned16(Cm);

  const int i0 = 16 * warp;  // this warp's rows i0 + g and i0 + g + 8
  const bool row_warp = i0 < rows;
  const int ia = i0 + g, ib = ia + 8;

  // A fragment (16 x 8, rows r0.., columns k0..) of a row-major f32 tile
  auto frag_a = [&](const float* m, int pitch, int r0, int k0,
                    Tf32 (&a)[4]) {
    const float* p0 = m + (r0 + g) * pitch + k0 + t;
    a[0] = tf32(p0[0]);
    a[1] = tf32(p0[8 * pitch]);
    a[2] = tf32(p0[4]);
    a[3] = tf32(p0[8 * pitch + 4]);
  };

  for (int w = 0; w < nw; ++w) {
    const int c = w * CL + rank;
    const bool active = c < nc;
    float acc[8][4];  // (rows, P): W x, then + exp(a_cum) C carried^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    if (active) {
      const long long l0 = (long long)c * s;
      chunk_dt_start(dtb + l0 * sd.dt[2], sd.dt[2], dts, s);
      stage_f32x4(cs, kF32Pitch, cmb + l0 * sd.cm[1], sd.cm[1], s, rows, N,
                  Np, vec_bc);
      stage_f32x4(bs, kF32Pitch, bmb + l0 * sd.bm[1], sd.bm[1], s, rows, N,
                  Np, vec_bc);
      stage_f32x4(xs, kF32XPitch, xb + l0 * sd.x[2], sd.x[2], s, rows, P, Pp,
                  vec_x);
      mma::cp_async_commit();
      chunk_dt_sum(Av, dts, acum, s);
      mma::cp_async_wait<0>();
      __syncthreads();
      chunk_rows(dts, acum, ecum, wv, decay_s, s, rows);
      __syncthreads();

      // in-chunk term of row tile r0 over the 16-column blocks [jb0, jb1)
      // under the diagonal: C B^T as two 16 x 8 tiles, W = C B^T (.) L (.)
      // dt, then W x.  W's C-fragment is the A fragment of W x with the k
      // order permuted (A column t is key 2t, column t + 4 key 2t + 1),
      // and x's B fragment takes its rows in that order.
      auto in_chunk = [&](int r0, int jb0, int jb1, float(&out)[8][4]) {
        const int ra = r0 + g, rb = ra + 8;
        const float aa = acum[min(ra, s - 1)], ab = acum[min(rb, s - 1)];
        for (int j0 = 16 * jb0; j0 < 16 * jb1 && j0 < s; j0 += 16) {
          float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          for (int k0 = 0; k0 < Np; k0 += 8) {
            Tf32 a[4];
            frag_a(cs, kF32Pitch, r0, k0, a);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const float* q = bs + (j0 + 8 * nt + g) * kF32Pitch + k0 + t;
              const Tf32 bb[2] = {tf32(q[0]), tf32(q[4])};
              mma_3xtf32(cb[nt], a, bb);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            Tf32 wa[4];  // A fragment of W's columns j0 + 8 nt ..
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? ra : rb;
              const int j = j0 + 8 * nt + 2 * t + (e & 1);
              const float wf =
                  (j <= i && i < s)
                      ? cb[nt][e] * expf((e < 2 ? aa : ab) - acum[j]) * dts[j]
                      : 0.f;
              // C-fragment e = (row g + 8 (e >> 1), key 2t + (e & 1)) is
              // A register (e >> 1) + 2 (e & 1)
              wa[(e >> 1) + 2 * (e & 1)] = tf32(wf);
            }
            const float* q = xs + (j0 + 8 * nt + 2 * t) * kF32XPitch + g;
#pragma unroll
            for (int pn = 0; pn < 8; ++pn) {
              if (8 * pn >= Pp) break;
              const Tf32 xv[2] = {tf32(q[8 * pn]),
                                  tf32(q[8 * pn + kF32XPitch])};
              mma_3xtf32(out[pn], wa, xv);
            }
          }
        }
      };
      causal_blocks(rows, acc, part, in_chunk);
      __syncthreads();  // the low warps' column blocks are in `part`
      hand_over_add(rows, acc, part);

      // local state (w (.) x)^T B, (P, N): warp w takes p-tile w % TP and
      // its share of the 8-column n-tiles
      const int TP = Pp / 16, GR = (kThreads / 32) / TP;  // per <= 8
      const int NT8 = Np / 8;
      const int per = (NT8 + GR - 1) / GR;
      const int pt = warp % TP, n0 = (warp / TP) * per;
      const int n1 = min(NT8, n0 + per);
      float la[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) la[n][e] = 0.f;
      if (warp < TP * GR) {
        for (int k0 = 0; k0 < rows; k0 += 8) {
          const float w0 = wv[k0 + t], w4 = wv[k0 + t + 4];
          const float* q = xs + (k0 + t) * kF32XPitch + 16 * pt + g;
          Tf32 a[4];
          a[0] = tf32(q[0] * w0);
          a[1] = tf32(q[8] * w0);
          a[2] = tf32(q[4 * kF32XPitch] * w4);
          a[3] = tf32(q[4 * kF32XPitch + 8] * w4);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            if (n0 + n >= n1) break;
            const float* r = bs + (k0 + t) * kF32Pitch + 8 * (n0 + n) + g;
            const Tf32 bb[2] = {tf32(r[0]), tf32(r[4 * kF32Pitch])};
            mma_3xtf32(la[n], a, bb);
          }
        }
      }
      __syncthreads();  // B is consumed: the state takes its place
      if (warp < TP * GR) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n0 + n >= n1) break;
          const int p = 16 * pt + g, nn = 8 * (n0 + n) + 2 * t;
          *reinterpret_cast<float2*>(st + p * kF32Pitch + nn) =
              make_float2(la[n][0], la[n][1]);
          *reinterpret_cast<float2*>(st + (p + 8) * kF32Pitch + nn) =
              make_float2(la[n][2], la[n][3]);
        }
      }
    }

    cluster.sync();  // every local state and decay of the window is out
    state_chain(
        cluster, st, kF32Pitch, P, N, min(CL, nc - w * CL), w == 0,
        w + 1 < nw, decay_s, carry,
        states ? states + (((size_t)b * H + h) * nc + (size_t)w * CL) * P * N
               : nullptr);
    cluster.sync();  // every chunk-start state is in place

    if (active) {
      if (row_warp) {
        // exp(a_cum) (.) C carried^T, then y = W x + that + D x over x
        float yo[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) yo[n][e] = 0.f;
        for (int k0 = 0; k0 < Np; k0 += 8) {
          Tf32 a[4];
          frag_a(cs, kF32Pitch, i0, k0, a);
#pragma unroll
          for (int pn = 0; pn < 8; ++pn) {
            if (8 * pn >= Pp) break;
            const float* q = st + (8 * pn + g) * kF32Pitch + k0 + t;
            const Tf32 bb[2] = {tf32(q[0]), tf32(q[4])};
            mma_3xtf32(yo[pn], a, bb);
          }
        }
        const float ea = ecum[ia], eb = ecum[ib];
#pragma unroll
        for (int pn = 0; pn < 8; ++pn) {
          if (8 * pn >= Pp) break;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float2* q = reinterpret_cast<float2*>(
                xs + (hf ? ib : ia) * kF32XPitch + 8 * pn + 2 * t);
            const float2 xv = *q;
            const float e = hf ? eb : ea;
            *q = make_float2(
                acc[pn][2 * hf] + e * yo[pn][2 * hf] + Dv * xv.x,
                acc[pn][2 * hf + 1] + e * yo[pn][2 * hf + 1] + Dv * xv.y);
          }
        }
      }
      __syncthreads();
      // the chunk's y rows out, 16 bytes at a time where aligned
      const long long l0 = (long long)c * s;
      const int c4 = (P + 3) / 4;
      for (int idx = tid; idx < s * c4; idx += kThreads) {
        const int r = idx / c4, cc = 4 * (idx - r * c4);
        const float* src = xs + r * kF32XPitch + cc;
        float* dst = yb + (l0 + r) * sd.y[2] + cc;
        if (vec_y) {
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(src);
        } else {
          for (int k = 0; k < 4 && cc + k < P; ++k) dst[k] = src[k];
        }
      }
      __syncthreads();  // before the next window's copies land
    }
  }
}

template <typename T, typename K>
int launch(K kernel, size_t smem, const void* x, const void* dt,
           const void* A, const void* Bm, const void* Cm, const void* D,
           void* y, void* states, const Strides& sd, int B, int H, int L,
           int P, int N, int s, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int CL = std::min(L / s, kMaxCluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                         static_cast<const float*>(dt),
                         static_cast<const float*>(A),
                         static_cast<const T*>(Bm), static_cast<const T*>(Cm),
                         static_cast<const float*>(D), static_cast<T*>(y),
                         static_cast<float*>(states), sd, H, L, P, N, s);
  if (e != cudaSuccess) return (int)e;
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
  if (s < 1 || s > kMaxS || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      L % s)
    return (int)cudaErrorInvalidValue;
  const Strides sd = strides_from(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(ssd_fwd_mma_kernel, kMmaSmem, x, dt, A, Bm,
                                 Cm, D, y, states, sd, B, H, L, P, N, s, st);
  return launch<float>(ssd_fwd_tf32_kernel, kF32Smem, x, dt, A, Bm, Cm, D, y,
                       states, sd, B, H, L, P, N, s, st);
}
