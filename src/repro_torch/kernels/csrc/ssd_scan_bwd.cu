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
// with dM[i, j] = g_i . x_j.
//
// Bound on this card: operations.  In f32 (the train step's type) the
// products, C B^T and g x^T over the causal half of every chunk, four more
// (s, s) products with s P or s N multiply-adds a row, four (s, P, N)
// state products, are ~17 M multiply-adds per (b, h, chunk) against
// ~0.3 MB in and out.
//
// Design: one cluster launch, the forward's grid and hand-off (ssd_scan.cu).
// One block per (b, h, chunk), the chunks of a row a thread-block cluster of
// up to 8 (grid (CL, H, B)); longer rows walk windows of CL chunks from the
// last window to the first.  Per window:
//   1. every block stages its chunk (x, dy, B, C, its saved start state S0
//      and dt; bf16 converted to f32 on the way), computes the state part
//      e (g S0) of dC and its local term sum_i e_i g_i (x) C_i of dS0,
//      (P, N), in place of S0;
//   2. after a cluster barrier, block r runs the chain dS1_c =
//      e_last(c + 1) dS1_{c + 1} + local_{c + 1} in reverse chunk order
//      for its 1/CL of the (P, N) elements, through distributed shared
//      memory, leaving each block's dS1 in place of its local term; the
//      carry to the previous window waits in the owner's registers;
//   3. after a second barrier every block computes the rest of its
//      chunk's gradients (passes C and R).
// Warp w owns row tile w (rows 16 w .. 16 w + 15) in both passes:
//   pass C: dx and dB of the tile's rows j, u (B dS1^T) + M^T g + D g and
//           u (x dS1) + Q^T C over the row blocks i >= j, M^T and Q^T
//           computed transposed (B C^T, x g^T); their row sums are the
//           column sums of dM (.) M and the direct dt terms;
//   pass R: dC of the tile's rows i, + Q B over the column blocks j <= i,
//           Q = dM (.) L (.) dt from C B^T and g x^T; the row sums of
//           dM (.) M (da_cum[i]).
// Computing the two score products twice (once a pass) keeps every (s, s)
// block in registers and every row sum inside one warp, with no block
// through shared memory.  Tile w has 8 - w blocks in pass C and w + 1 in
// pass R, nine for every warp, and the passes run back to back with no
// barrier between them, so no warp waits on another's share.
// Every product runs on the tensor cores in 3xTF32 (mma.sync m16n8k8, each
// f32 operand a TF32 hi/lo pair: mma_common.cuh), as the forward's f32
// kernel, with the split that costs two integer operations and a
// subtraction (tf32_fast: issue slots, not the tensor cores, bound this
// kernel; ~2^-20 of each product where the forward's keeps ~2^-21); an
// (s, s) block's C fragment is the A fragment of the next product with its
// k order permuted.  The bf16 instance runs the same
// code on its inputs converted to f32.
//
// Shared memory (226 KB, one block an SM): x, dy, B, C and the (P, N)
// state as f32 tiles laid out for s = 128, P = 64, N = 128 with no
// padding, swizzled (below), four per-row arrays and a few scalars.  dB
// and dC come out per head, (B, H, L, N) f32, summed over the heads
// afterwards by one ordered torch.sum; dA and dD per (b, h, chunk).  Every
// sum is taken in a fixed order and there are no atomics: the gradient is
// the same bits on every run.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "ssd_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ssd;
using mma::mma_3xtf32;
using mma::Tf32;
using mma::tf32_fast;

constexpr int kRowW = kMaxN;  // floats a row of C, B and the state
constexpr int kXW = kMaxP;    // floats a row of x, dy
constexpr int kCarry = kMaxP * kMaxN / kMaxCluster / kThreads;
constexpr int kS0Regs = kMaxP * kMaxN / kThreads;

// f32 tiles of W floats a row (a multiple of 32), element (r, c) at
// r W + (c ^ swz(r)): the XOR touches bits 2-4 only, so 16-byte chunks stay
// whole.  x, dy, B, C take SwzIn: the fragments read 8 rows x 4 columns
// (A, and B of a product with the tile's transpose) and rows 2t, 2t + 1 x
// 8 columns (B of a product with the tile in the permuted k order) without
// bank conflicts.  The state takes SwzSt, for 8 rows x 4 columns and rows
// t, t + 4 x 8 columns.
struct SwzIn {
  __device__ __forceinline__ int operator()(int r) const {
    return (r & 7) << 2;
  }
};
struct SwzSt {
  __device__ __forceinline__ int operator()(int r) const {
    return ((r & 3) << 3) | (r & 4);
  }
};

// fixed layout (s <= 128, P <= 64, N <= 128): C, B, x, dy, the state, four
// per-row arrays, and the scalars (block-sum slots, per-warp sums, the
// chunk's decay)
constexpr uint32_t kCOff = 0;
constexpr uint32_t kBOff = kCOff + kMaxS * kRowW * 4;
constexpr uint32_t kXOff = kBOff + kMaxS * kRowW * 4;
constexpr uint32_t kGOff = kXOff + kMaxS * kXW * 4;
constexpr uint32_t kStOff = kGOff + kMaxS * kXW * 4;
constexpr uint32_t kRowsOff = kStOff + kMaxP * kRowW * 4;
constexpr uint32_t kMiscOff = kRowsOff + 4 * kMaxS * 4;
constexpr uint32_t kSmem = kMiscOff + 32 * 4;
static_assert(kSmem <= 232448, "over a block's shared memory");

// rows [0, rows) x columns [0, cols) (a multiple of 4) of a (n_valid,
// width) slab with row stride ld into a swizzled f32 tile, zeros past row
// n_valid and column width: f32 by 16-byte asynchronous copies and bf16
// by 8-byte loads converted on the way where `vec` (rows aligned, width %
// 4 == 0), else element by element
template <int W, typename T, typename Swz>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const T* __restrict__ src,
                                           long long ld, int n_valid,
                                           int rows, int width, int cols,
                                           bool vec, Swz swz) {
  const int c4 = cols >> 2;
  for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
    const int r = idx / c4, c = 4 * (idx - r * c4);
    float* d = dst + r * W + (c ^ swz(r));
    const bool in = r < n_valid && c < width;
    const T* p = src + r * ld + c;
    if (vec) {
      if constexpr (std::is_same<T, float>::value) {
        mma::cp_async16(mma::smem_addr(d), in ? p : src, in);
      } else {
        const uint2 v =
            in ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
        *reinterpret_cast<float4*>(d) =
            make_float4(mma::bf16_lo(v.x), mma::bf16_hi(v.x),
                        mma::bf16_lo(v.y), mma::bf16_hi(v.y));
      }
    } else {
      float4 v;
      v.x = in ? to_f32(p[0]) : 0.f;
      v.y = in && c + 1 < width ? to_f32(p[1]) : 0.f;
      v.z = in && c + 2 < width ? to_f32(p[2]) : 0.f;
      v.w = in && c + 3 < width ? to_f32(p[3]) : 0.f;
      *reinterpret_cast<float4*>(d) = v;
    }
  }
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A fragment (16 x 8): rows r0 .. r0 + 15 (r0 % 8 == 0), columns k0 ..
// k0 + 7 of a SwzIn tile
template <int W>
__device__ __forceinline__ void frag_rows(const float* m, int r0, int k0,
                                          Tf32 (&a)[4]) {
  const int g = lane_g(), t = lane_t();
  const float* p = m + (r0 + g) * W;
  const int c0 = (k0 + t) ^ (g << 2), c1 = (k0 + t + 4) ^ (g << 2);
  a[0] = tf32_fast(p[c0]);
  a[1] = tf32_fast(p[8 * W + c0]);
  a[2] = tf32_fast(p[c1]);
  a[3] = tf32_fast(p[8 * W + c1]);
}

// B fragment (8 x 8) of the product with a tile's transpose: B[k][n] =
// m[n0 + n][k0 + k]
template <int W, typename Swz>
__device__ __forceinline__ void frag_bt(const float* m, int n0, int k0,
                                        Swz swz, Tf32 (&b)[2]) {
  const int g = lane_g(), t = lane_t();
  const float* p = m + (n0 + g) * W;
  const int sw = swz(n0 + g);
  b[0] = tf32_fast(p[(k0 + t) ^ sw]);
  b[1] = tf32_fast(p[(k0 + t + 4) ^ sw]);
}

// B fragment of the product with a SwzIn tile as stored, B[k][n] =
// m[k0 + k][n0 + n], in the permuted k order of an A fragment taken from a
// C fragment (A column t is k 2t, column t + 4 is k 2t + 1)
template <int W>
__device__ __forceinline__ void frag_b_perm(const float* m, int k0, int n0,
                                            Tf32 (&b)[2]) {
  const int g = lane_g(), t = lane_t();
  b[0] = tf32_fast(m[(k0 + 2 * t) * W + ((n0 + g) ^ (8 * t))]);
  b[1] = tf32_fast(m[(k0 + 2 * t + 1) * W + ((n0 + g) ^ (8 * t + 4))]);
}

// B fragment of the product with the state tile as stored (k order as
// given): B[k][n] = st[k0 + k][n0 + n]
__device__ __forceinline__ void frag_b_st(const float* st, int k0, int n0,
                                          Tf32 (&b)[2]) {
  const int g = lane_g(), t = lane_t();
  b[0] = tf32_fast(st[(k0 + t) * kRowW + ((n0 + g) ^ (8 * t))]);
  b[1] = tf32_fast(st[(k0 + t + 4) * kRowW + ((n0 + g) ^ (8 * t + 4))]);
}

// A fragment from the C fragment of a 16 x 8 tile: C element e is (row g +
// 8 (e >> 1), column 2t + (e & 1)), A register (e >> 1) + 2 (e & 1)
__device__ __forceinline__ int a_slot(int e) { return (e >> 1) + 2 * (e & 1); }

// the sum over the four lanes of a quad (the lanes of one fragment row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// two neighbouring f32 of a shared-memory tile row
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// adds to two neighbouring f32 of an output row of N that this thread
// wrote before (store2), n even
__device__ __forceinline__ void add2(float* row, int n, int N, float v0,
                                     float v1) {
  if ((N & 1) == 0 && n + 1 < N) {
    float2* q = reinterpret_cast<float2*>(row + n);
    const float2 o = *q;
    *q = make_float2(o.x + v0, o.y + v1);
  } else {
    if (n < N) row[n] += v0;
    if (n + 1 < N) row[n + 1] += v1;
  }
}

// two neighbouring f32 of an output row of N, n even
__device__ __forceinline__ void store2(float* row, int n, int N, float v0,
                                       float v1) {
  if ((N & 1) == 0 && n + 1 < N) {
    *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
  } else {
    if (n < N) row[n] = v0;
    if (n + 1 < N) row[n + 1] = v1;
  }
}

// One element of the reverse chain (SwzSt position of element e = (p, n)):
// block q's local term is replaced by dS1 of chunk q, from q = nq - 1 down,
// run = dS1 of the window's last chunk on entry and dS1 of the chunk before
// the window on return (each step rounded twice, as the plain version's
// autograd does)
__device__ __forceinline__ float chain_elem(cg::cluster_group& cluster,
                                            float* st, int e, int N, int nq,
                                            const float (&dec)[kMaxCluster],
                                            float run) {
  const int p = e / N, n = e - p * N;
  float* elem = st + p * kRowW + (n ^ SwzSt{}(p));
  float loc[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < nq) loc[q] = *cluster.map_shared_rank(elem, q);
#pragma unroll
  for (int q = kMaxCluster - 1; q >= 0; --q)
    if (q < nq) {
      *cluster.map_shared_rank(elem, q) = run;
      run = __fadd_rn(__fmul_rn(run, dec[q]), loc[q]);
    }
  return run;
}

// Block r's share of the reverse chain over the window's nq chunks.
// decay_s: each block's exp(a_sum).  carry: the owner's dS1 of the chunk
// before the window, kept in registers for the previous window (more
// than one window means CL = 8 and at most kCarry elements a thread).
__device__ __forceinline__ void state_chain_rev(cg::cluster_group& cluster,
                                                float* st, int P, int N,
                                                int nq, bool last, bool more,
                                                const float* decay_s,
                                                float (&carry)[kCarry]) {
  const int r = (int)cluster.block_rank();
  const int CL = (int)cluster.num_blocks();
  const int E = P * N;
  const int per = (E + CL - 1) / CL;
  const int e0 = r * per, e1 = min(E, e0 + per);
  float dec[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    dec[q] = q < nq ? *cluster.map_shared_rank(decay_s, q) : 0.f;
#pragma unroll
  for (int k = 0; k < kCarry; ++k) {
    const int e = e0 + (int)threadIdx.x + k * kThreads;
    if (e < e1) {
      const float run =
          chain_elem(cluster, st, e, N, nq, dec, last ? 0.f : carry[k]);
      if (more) carry[k] = run;
    }
  }
  // a single window of fewer than 8 chunks: more elements, no carry
  for (int e = e0 + (int)threadIdx.x + kCarry * kThreads; e < e1;
       e += kThreads)
    chain_elem(cluster, st, e, N, nq, dec, 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_tf32_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, const float* __restrict__ D,
                        const T* __restrict__ dy,
                        const float* __restrict__ states, T* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ dbp,
                        float* __restrict__ dcp, float* __restrict__ dap,
                        float* __restrict__ ddp, Strides sd, int H, int L,
                        int P, int N, int s) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nc = L / s, nw = (nc + CL - 1) / CL;
  const int rows = round16(s), tiles = rows / 16;
  const int P8 = (P + 7) / 8 * 8, N8 = (N + 7) / 8 * 8, P16 = round16(P);

  float* cs = reinterpret_cast<float*>(smem + kCOff);
  float* bs = reinterpret_cast<float*>(smem + kBOff);
  float* xs = reinterpret_cast<float*>(smem + kXOff);
  float* gs = reinterpret_cast<float*>(smem + kGOff);
  float* st = reinterpret_cast<float*>(smem + kStOff);  // S0, local, dS1
  float* acum = reinterpret_cast<float*>(smem + kRowsOff);
  float* dts = acum + kMaxS;
  float* ev = dts + kMaxS;  // exp(a_cum); after pass C, da_cum
  float* uv = ev + kMaxS;   // exp(a_sum - a_cum) dt; then the direct ddt
  float* red = reinterpret_cast<float*>(smem + kMiscOff);
  float* lastw = red + 8;   // per warp: sum_j du_j u_j
  float* decay_s = red + 16;

  const float Av = A[b * sd.a[0] + h * sd.a[1]];
  const float Dv = D[b * sd.d[0] + h * sd.d[1]];
  const T* xb = x + b * sd.x[0] + h * sd.x[1];
  const float* dtb = dt + b * sd.dt[0] + h * sd.dt[1];
  const T* bmb = Bm + b * sd.bm[0];
  const T* cmb = Cm + b * sd.cm[0];
  const T* dyb = dy + b * sd.y[0] + h * sd.y[1];
  T* dxb = dx + b * sd.dx[0] + h * sd.dx[1];
  float* ddtb = ddt + b * sd.ddt[0] + h * sd.ddt[1];
  const long long bh = (long long)b * H + h;
  auto al4 = [](const void* p) {  // aligned to 4 elements
    return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
  };
  const bool vec_x = P % 4 == 0 && sd.x[2] % 4 == 0 && sd.x[0] % 4 == 0 &&
                     sd.x[1] % 4 == 0 && al4(x);
  const bool vec_g = P % 4 == 0 && sd.y[2] % 4 == 0 && sd.y[0] % 4 == 0 &&
                     sd.y[1] % 4 == 0 && al4(dy);
  const bool vec_bc = N % 4 == 0 && sd.bm[1] % 4 == 0 &&
                      sd.cm[1] % 4 == 0 && sd.bm[0] % 4 == 0 &&
                      sd.cm[0] % 4 == 0 && al4(Bm) && al4(Cm);
  const bool vec_st = N % 4 == 0;  // contiguous (P, N) slabs

  // this warp's row tile: rows ra (C-fragment rows g) and rb (g + 8)
  const int r0 = 16 * warp;
  const bool tile = r0 < rows;
  const int ra = r0 + g, rb = ra + 8;

  float carry[kCarry];
  for (int w = nw - 1; w >= 0; --w) {
    const int c = w * CL + rank;
    const bool active = c < nc;
    const long long l0 = (long long)c * s;
    const long long bhc = bh * nc + c;
    float s0r[kS0Regs];  // S0 as stored, for <dS1, S0>
    // lane partials of da_cum[ra], [rb]: dC_state . C, then sum_j dM M
    float rowa = 0.f, rowb = 0.f;

    if (active) {
      chunk_dt_start(dtb + l0 * sd.dt[2], sd.dt[2], dts, s);
      stage_tile<kRowW>(cs, cmb + l0 * sd.cm[1], sd.cm[1], s, rows, N, N8,
                        vec_bc, SwzIn{});
      stage_tile<kRowW>(bs, bmb + l0 * sd.bm[1], sd.bm[1], s, rows, N, N8,
                        vec_bc, SwzIn{});
      // x and dy over whole rows, zeros past P: dD sums the tiles
      stage_tile<kXW>(xs, xb + l0 * sd.x[2], sd.x[2], s, rows, P, kXW, vec_x,
                      SwzIn{});
      stage_tile<kXW>(gs, dyb + l0 * sd.y[2], sd.y[2], s, rows, P, kXW,
                      vec_g, SwzIn{});
      // the whole state tile, zeros past (P, N): <dS1, S0> reads it all
      stage_tile<kRowW>(st, states + bhc * P * N, (long long)N, P, kMaxP, N,
                        kRowW, vec_st, SwzSt{});
      mma::cp_async_commit();
      chunk_dt_sum(Av, dts, acum, s);
      mma::cp_async_wait<0>();
      __syncthreads();
      chunk_rows(dts, acum, ev, uv, decay_s, s, rows);
      __syncthreads();

      // ---- dC of rows i, its state part e (g S0) (k = P): stored now, the
      // in-chunk part Q B added after the chain (pass R)
      if (tile) {
        float dc[16][4];
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dc[n][e] = 0.f;
        for (int k0 = 0; k0 < P8; k0 += 8) {
          Tf32 a[4];
          frag_rows<kXW>(gs, r0, k0, a);
#pragma unroll
          for (int nn = 0; nn < 16; ++nn) {
            if (8 * nn >= N8) break;
            Tf32 bb[2];
            frag_b_st(st, k0, 8 * nn, bb);
            mma_3xtf32(dc[nn], a, bb);
          }
        }
        // dC_state = e (g S0); da_cum[i] += dC_state_i . C_i
        const float ea = ev[ra], eb = ev[rb];
#pragma unroll
        for (int nn = 0; nn < 16; ++nn) {
          if (8 * nn >= N8) break;
          const int n = (8 * nn + 2 * t) ^ (g << 2);
          const float2 ca = ld2(cs + ra * kRowW + n);
          const float2 cb = ld2(cs + rb * kRowW + n);
          dc[nn][0] *= ea;
          dc[nn][1] *= ea;
          dc[nn][2] *= eb;
          dc[nn][3] *= eb;
          rowa = fmaf(dc[nn][0], ca.x, fmaf(dc[nn][1], ca.y, rowa));
          rowb = fmaf(dc[nn][2], cb.x, fmaf(dc[nn][3], cb.y, rowb));
        }
        float* dcr = dcp + (bh * L + l0) * N;
#pragma unroll
        for (int nn = 0; nn < 16; ++nn) {
          if (8 * nn >= N8) break;
          const int n = 8 * nn + 2 * t;
          if (ra < s)
            store2(dcr + (long long)ra * N, n, N, dc[nn][0], dc[nn][1]);
          if (rb < s)
            store2(dcr + (long long)rb * N, n, N, dc[nn][2], dc[nn][3]);
        }
      }

      // ---- the local term (e (.) g)^T C of dS0, (P, N), k = the chunk ----
      // warp w: p-tile w % TP and its share of the 8-column n-tiles
      const int TP = P16 / 16, GR = (kThreads / 32) / TP;
      const int NT8 = N8 / 8, per = (NT8 + GR - 1) / GR;
      const int m0 = 16 * (warp % TP), n0 = (warp / TP) * per;
      const int n1 = min(NT8, n0 + per);
      float la[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) la[n][e] = 0.f;
      if (warp < TP * GR) {
        for (int k0 = 0; k0 < rows; k0 += 8) {
          // A[p][i] = e_i g[i][p], the k order permuted as frag_b_perm's
          const float e0 = ev[k0 + 2 * t], e1 = ev[k0 + 2 * t + 1];
          const float* q0 = gs + (k0 + 2 * t) * kXW;
          const float* q1 = q0 + kXW;
          Tf32 a[4];
          a[0] = tf32_fast(e0 * q0[(m0 + g) ^ (8 * t)]);
          a[1] = tf32_fast(e0 * q0[(m0 + g + 8) ^ (8 * t)]);
          a[2] = tf32_fast(e1 * q1[(m0 + g) ^ (8 * t + 4)]);
          a[3] = tf32_fast(e1 * q1[(m0 + g + 8) ^ (8 * t + 4)]);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            if (n0 + n >= n1) break;
            Tf32 bb[2];
            frag_b_perm<kRowW>(cs, k0, 8 * (n0 + n), bb);
            mma_3xtf32(la[n], a, bb);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kS0Regs; ++k) s0r[k] = st[tid + k * kThreads];
      __syncthreads();  // S0 is read: the local term takes its place
      if (warp < TP * GR) {
        const int p = m0 + g;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n0 + n >= n1) break;
          const int col = (8 * (n0 + n) + 2 * t) ^ SwzSt{}(p);
          *reinterpret_cast<float2*>(st + p * kRowW + col) =
              make_float2(la[n][0], la[n][1]);
          *reinterpret_cast<float2*>(st + (p + 8) * kRowW + col) =
              make_float2(la[n][2], la[n][3]);
        }
      }
    }

    cluster.sync();  // every local term and decay of the window is out
    state_chain_rev(cluster, st, P, N, min(CL, nc - w * CL), w == nw - 1,
                    w > 0, decay_s, carry);
    cluster.sync();  // every chunk's dS1 is in place

    if (active) {
      // <dS1, S0> and dD = sum g x, as block sums in a fixed order
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < kS0Regs; ++k)
        part = fmaf(s0r[k], st[tid + k * kThreads], part);
      const float dot = block_sum(part, red);
      part = 0.f;
      for (int idx = tid; idx < rows * kXW; idx += kThreads)
        part = fmaf(gs[idx], xs[idx], part);
      const float dD = block_sum(part, red);

      // ---- pass C: dx and dB of rows j -----------------------------------
      if (tile) {
        float dxa[8][4], dba[16][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dxa[n][e] = 0.f;
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dba[n][e] = 0.f;
        // x dS1 (k = P): dB_j = u_j (x dS1)_j, du_j = (x dS1)_j . B_j
        for (int k0 = 0; k0 < P8; k0 += 8) {
          Tf32 a[4];
          frag_rows<kXW>(xs, r0, k0, a);
#pragma unroll
          for (int nn = 0; nn < 16; ++nn) {
            if (8 * nn >= N8) break;
            Tf32 bb[2];
            frag_b_st(st, k0, 8 * nn, bb);
            mma_3xtf32(dba[nn], a, bb);
          }
        }
        const float ua = uv[ra], ub = uv[rb];
        float dua = 0.f, dub = 0.f;
#pragma unroll
        for (int nn = 0; nn < 16; ++nn) {
          if (8 * nn >= N8) break;
          const int n = (8 * nn + 2 * t) ^ (g << 2);
          const float2 ba = ld2(bs + ra * kRowW + n);
          const float2 bb = ld2(bs + rb * kRowW + n);
          dua = fmaf(dba[nn][0], ba.x, fmaf(dba[nn][1], ba.y, dua));
          dub = fmaf(dba[nn][2], bb.x, fmaf(dba[nn][3], bb.y, dub));
          dba[nn][0] *= ua;
          dba[nn][1] *= ua;
          dba[nn][2] *= ub;
          dba[nn][3] *= ub;
        }
        dua = quad_sum(dua);
        dub = quad_sum(dub);
        // dx_j = u_j B_j dS1^T (k = N)
        for (int k0 = 0; k0 < N8; k0 += 8) {
          Tf32 a[4];
          frag_rows<kRowW>(bs, r0, k0, a);
#pragma unroll
          for (int pn = 0; pn < 8; ++pn) {
            if (8 * pn >= P8) break;
            Tf32 bb[2];
            frag_bt<kRowW>(st, 8 * pn, k0, SwzSt{}, bb);
            mma_3xtf32(dxa[pn], a, bb);
          }
        }
#pragma unroll
        for (int pn = 0; pn < 8; ++pn) {
          dxa[pn][0] *= ua;
          dxa[pn][1] *= ua;
          dxa[pn][2] *= ub;
          dxa[pn][3] *= ub;
        }
        // the row blocks i >= j: B C^T and x g^T (M^T and Q^T), then
        // M^T g into dx and Q^T C into dB
        const float aja = acum[ra], ajb = acum[rb];
        const float dja = dts[ra], djb = dts[rb];
        float cola = 0.f, colb = 0.f;  // sum_i dM M: -da_cum[j]
        float dta = 0.f, dtb2 = 0.f;   // sum_i dM C B^T L: ddt[j]
        for (int ib = warp; ib < tiles; ++ib) {
          const int i0 = 16 * ib;
          float bct[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          float xg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          for (int k0 = 0; k0 < N8; k0 += 8) {
            Tf32 a[4];
            frag_rows<kRowW>(bs, r0, k0, a);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              Tf32 bb[2];
              frag_bt<kRowW>(cs, i0 + 8 * nt, k0, SwzIn{}, bb);
              mma_3xtf32(bct[nt], a, bb);
            }
          }
          for (int k0 = 0; k0 < P8; k0 += 8) {
            Tf32 a[4];
            frag_rows<kXW>(xs, r0, k0, a);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              Tf32 bb[2];
              frag_bt<kXW>(gs, i0 + 8 * nt, k0, SwzIn{}, bb);
              mma_3xtf32(xg[nt], a, bb);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            Tf32 ma[4], qa[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = e < 2 ? ra : rb;
              const int i = i0 + 8 * nt + 2 * t + (e & 1);
              float m = 0.f, q = 0.f;
              if (i >= j && i < s) {
                const float lm = expf(acum[i] - (e < 2 ? aja : ajb));
                const float kk = bct[nt][e] * lm;
                const float dtj = e < 2 ? dja : djb;
                m = kk * dtj;
                q = xg[nt][e] * lm * dtj;
                // dM M off the diagonal, as in pass R
                const float tm = i > j ? xg[nt][e] * m : 0.f;
                if (e < 2) {
                  cola += tm;
                  dta = fmaf(xg[nt][e], kk, dta);
                } else {
                  colb += tm;
                  dtb2 = fmaf(xg[nt][e], kk, dtb2);
                }
              }
              ma[a_slot(e)] = tf32_fast(m);
              qa[a_slot(e)] = tf32_fast(q);
            }
#pragma unroll
            for (int pn = 0; pn < 8; ++pn) {
              if (8 * pn >= P8) break;
              Tf32 bb[2];
              frag_b_perm<kXW>(gs, i0 + 8 * nt, 8 * pn, bb);
              mma_3xtf32(dxa[pn], ma, bb);
            }
#pragma unroll
            for (int nn = 0; nn < 16; ++nn) {
              if (8 * nn >= N8) break;
              Tf32 bb[2];
              frag_b_perm<kRowW>(cs, i0 + 8 * nt, 8 * nn, bb);
              mma_3xtf32(dba[nn], qa, bb);
            }
          }
        }
        // dx = that + D g in x's type; dB per head in f32
        T* dxr = dxb + l0 * sd.dx[2];
#pragma unroll
        for (int pn = 0; pn < 8; ++pn) {
          if (8 * pn >= P8) break;
          const int p = 8 * pn + 2 * t;
          const int col = p ^ (g << 2);
          const float2 ga = ld2(gs + ra * kXW + col);
          const float2 gb = ld2(gs + rb * kXW + col);
          if (ra < s) {
            T* o = dxr + ra * sd.dx[2];
            if (p < P) o[p] = from_f32<T>(fmaf(Dv, ga.x, dxa[pn][0]));
            if (p + 1 < P) o[p + 1] = from_f32<T>(fmaf(Dv, ga.y, dxa[pn][1]));
          }
          if (rb < s) {
            T* o = dxr + rb * sd.dx[2];
            if (p < P) o[p] = from_f32<T>(fmaf(Dv, gb.x, dxa[pn][2]));
            if (p + 1 < P) o[p + 1] = from_f32<T>(fmaf(Dv, gb.y, dxa[pn][3]));
          }
        }
        float* dbr = dbp + (bh * L + l0) * N;
#pragma unroll
        for (int nn = 0; nn < 16; ++nn) {
          if (8 * nn >= N8) break;
          const int n = 8 * nn + 2 * t;
          if (ra < s)
            store2(dbr + (long long)ra * N, n, N, dba[nn][0], dba[nn][1]);
          if (rb < s)
            store2(dbr + (long long)rb * N, n, N, dba[nn][2], dba[nn][3]);
        }
        // ---- pass R: dC_i += sum_{j <= i} Q[i, j] B_j, Q = dM (.) L (.) dt
        // from C B^T and dM = g x^T over the column blocks j <= i
        float dc[16][4];
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dc[n][e] = 0.f;
        const float aa = acum[ra], ab = acum[rb];
        for (int jb = 0; jb <= warp; ++jb) {
          const int j0 = 16 * jb;
          float cbt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          float dm[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          for (int k0 = 0; k0 < N8; k0 += 8) {
            Tf32 a[4];
            frag_rows<kRowW>(cs, r0, k0, a);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              Tf32 bb[2];
              frag_bt<kRowW>(bs, j0 + 8 * nt, k0, SwzIn{}, bb);
              mma_3xtf32(cbt[nt], a, bb);
            }
          }
          for (int k0 = 0; k0 < P8; k0 += 8) {
            Tf32 a[4];
            frag_rows<kXW>(gs, r0, k0, a);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              Tf32 bb[2];
              frag_bt<kXW>(xs, j0 + 8 * nt, k0, SwzIn{}, bb);
              mma_3xtf32(dm[nt], a, bb);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            Tf32 qa[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? ra : rb;
              const int j = j0 + 8 * nt + 2 * t + (e & 1);
              float q = 0.f;
              if (j <= i && i < s) {
                const float lm = expf((e < 2 ? aa : ab) - acum[j]);
                const float m = cbt[nt][e] * lm * dts[j];
                q = dm[nt][e] * lm * dts[j];
                // dM M off the diagonal (on it, the row sum here and the
                // column sum of pass C cancel)
                const float tm = j < i ? dm[nt][e] * m : 0.f;
                if (e < 2) {
                  rowa += tm;
                } else {
                  rowb += tm;
                }
              }
              qa[a_slot(e)] = tf32_fast(q);
            }
#pragma unroll
            for (int nn = 0; nn < 16; ++nn) {
              if (8 * nn >= N8) break;
              Tf32 bb[2];
              frag_b_perm<kRowW>(bs, j0 + 8 * nt, 8 * nn, bb);
              mma_3xtf32(dc[nn], qa, bb);
            }
          }
        }
        float* dcr = dcp + (bh * L + l0) * N;
#pragma unroll
        for (int nn = 0; nn < 16; ++nn) {
          if (8 * nn >= N8) break;
          const int n = 8 * nn + 2 * t;
          if (ra < s)
            add2(dcr + (long long)ra * N, n, N, dc[nn][0], dc[nn][1]);
          if (rb < s)
            add2(dcr + (long long)rb * N, n, N, dc[nn][2], dc[nn][3]);
        }
        // da_cum and the direct ddt of rows ra, rb (u_j = exp(a_sum -
        // a_cum_j) dt_j: da_cum[j] -= du_j u_j, da_cum[-1] += the same,
        // ddt[j] += du_j exp(a_sum - a_cum_j))
        const float alast = acum[s - 1];
        const float dac_a = quad_sum(rowa) - quad_sum(cola) - dua * ua;
        const float dac_b = quad_sum(rowb) - quad_sum(colb) - dub * ub;
        const float ddt_a = quad_sum(dta) + dua * expf(alast - aja);
        const float ddt_b = quad_sum(dtb2) + dub * expf(alast - ajb);
        float lw = t == 0 ? fmaf(dua, ua, dub * ub) : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) lw += __shfl_xor_sync(kFull, lw, o);
        __syncwarp();  // this warp's reads of its rows' u are done
        if (t == 0) {
          ev[ra] = dac_a;
          ev[rb] = dac_b;
          uv[ra] = ddt_a;
          uv[rb] = ddt_b;
        }
        if (lane == 0) lastw[warp] = lw;
      } else if (lane == 0) {
        lastw[warp] = 0.f;
      }
      __syncthreads();
      if (tid == 0) {
        // da_cum[-1] += e_last <dS1, S0> + sum_j du_j u_j; a_cum[i] =
        // sum_{k <= i} dt_k A: da_k = sum_{i >= k} da_cum[i]
        float extra = *decay_s * dot;
        for (int k = 0; k < kThreads / 32; ++k) extra += lastw[k];
        float run = extra, dA = 0.f;
        for (int k = s - 1; k >= 0; --k) {
          run += ev[k];
          ddtb[(l0 + k) * sd.ddt[2]] = uv[k] + run * Av;
          dA = fmaf(run, dts[k], dA);
        }
        dap[bhc] = dA;
        ddp[bhc] = dD;
      }
      __syncthreads();  // before the next window's copies land
    }
  }
}

template <typename T>
int launch_bwd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* D, const void* dy,
               const void* states, void* dx, void* ddt, void* dbp, void* dcp,
               void* dap, void* ddp, const Strides& sd, int B, int H, int L,
               int P, int N, int s, cudaStream_t stream) {
  auto kernel = ssd_bwd_tf32_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const int CL = std::min(L / s, kMaxCluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const T*>(dy), static_cast<const float*>(states),
      static_cast<T*>(dx), static_cast<float*>(ddt), static_cast<float*>(dbp),
      static_cast<float*>(dcp), static_cast<float*>(dap),
      static_cast<float*>(ddp), sd, H, L, P, N, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Gradients of ssd_scan_fwd_launch.  x, dy, dx (B, H, L, P), Bm/Cm (B, L,
// N) in one type (bf16 when bf16 != 0, else f32); dt, ddt (B, H, L) and
// A/D (B, H) f32; all through strides[23] (ssd::Strides, the y entries
// being dy's).  states: the forward's (B, H, L / s, P, N) f32 chunk-start
// states.  dsend is not read or written (the dS chain stays on chip; NULL
// is fine).  Outputs, f32 and contiguous: dbp, dcp (B, H, L, N) per-head
// partials of dBm, dCm; dap, ddp (B, H, L / s) per-chunk partials of dA,
// dD.  Requires L % s == 0, s <= 128, P <= 64, N <= 128.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, const void* D,
                                   const void* dy, const void* states,
                                   void* dsend, void* dx, void* ddt,
                                   void* dbp, void* dcp, void* dap, void* ddp,
                                   const long long* strides, int B, int H,
                                   int L, int P, int N, int s, int bf16,
                                   void* stream) {
  (void)dsend;
  if (B == 0 || H == 0 || L == 0) return 0;
  if (s < 1 || s > kMaxS || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      L % s)
    return (int)cudaErrorInvalidValue;
  const Strides sd = strides_from(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<__nv_bfloat16>(x, dt, A, Bm, Cm, D, dy, states,
                                          dx, ddt, dbp, dcp, dap, ddp, sd, B,
                                          H, L, P, N, s, st)
              : launch_bwd<float>(x, dt, A, Bm, Cm, D, dy, states, dx, ddt,
                                  dbp, dcp, dap, ddp, sd, B, H, L, P, N, s,
                                  st);
}
