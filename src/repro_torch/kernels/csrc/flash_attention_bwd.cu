// Flash-attention backward kernels for Hopper (sm_90a).
//
// The JAX package has no Pallas backward for `flash_attention_bhsd`
// (src/repro/kernels/flash_attention.py): JAX trains through XLA's
// attention.  The port's forward is a hand-written kernel with no autograd
// of its own, so its gradient is a kernel too, in the FlashAttention-2
// scheme, as up to four launches on one stream:
//
//   1. delta = rowsum(dO * O)            one thread per (b, h, row)
//   2. dK, dV per (key tile, or key-tile pair under a causal mask; group
//      of query heads; kv head; b); each step also stores its 64 x 64 tile
//      of dS = P * (dP - delta) in f32
//   3. (when a KV head's query heads are split over blocks) the f32
//      partial dK, dV of the groups summed in group order
//   4. dQ = dS K per (b, h, 64-query tile) from those tiles, the longest
//      query tiles first
//
// Launch 2 rebuilds P = exp(s * scale - lse) from the forward's f32 row
// log-sum-exp; dP = dO V^T.  No float atomics: every sum runs in a fixed
// order, so two calls give the same bits.
//
// Bound on this card: operations.  Five products of 2 * D flops per live
// (query, key) pair (S, dP, dV, dK, dQ), every one on the tensor cores as
// 3xTF32 (mma.sync m16n8k8, each f32 operand a TF32 hi/lo pair:
// mma_common.cuh), where the earlier design ran them in f32 on the CUDA
// cores.  Storing dS (4 bytes a live pair: 378 MB at whisper-large-v3's
// encoder shape, written once and read once) spares launch 4 the rebuild
// of S and dP, which would make seven products of five; measured on the
// card, the rebuild cost launch 4 three times its time, more than the
// traffic it saves (PERF.md).
//
// Each product launch is a 64 x 64 tile loop in 8 warps.  In launch 2
// warp w owns keys 16 (w % 4) .. + 15 and, for the score products (S^T =
// K Q^T and dP^T = V dO^T), queries 32 (w / 4) .. + 31 of the step's
// tile; the score tiles go through shared memory in fragment order (one
// float4 a lane, conflict free), where the same warp row reads them back
// as the A operand of dV += P^T dO and dK += dS^T Q over all 64 queries,
// the output columns split in halves between w and w + 4.  The k order
// of those products is permuted (A column t is k 2t, t + 4 is 2t + 1) so
// that a C fragment is an A fragment without a shuffle.  Launch 4 reads
// dS from the stored [key][query] tiles the same way.  Staged f32 tiles
// have a pitch of D_pad + 4 floats (D_pad: D rounded up to 16, and to 64
// below it; the pitch is 4 or 20 mod 32), so every fragment read (8 rows
// x 4 columns, or rows 2t, 2t + 1 x 8 columns) hits 32 distinct banks.
//
// - The schedule.  A bidirectional mask gives every key tile the same
//   work, so launch 2 runs one key tile a block (whisper-large-v3's
//   encoder, B 2, 20 heads, S 1500: 960 blocks); a causal mask pairs key
//   tiles j and n - 1 - j, so every block walks n + 1 query tiles per head.
//   The G = H / KV query heads of a KV head are split over the fewest
//   groups that give 2 blocks per SM; each group writes f32 partial dK, dV,
//   summed in group order by launch 3.  At D <= 64 launch 2 fits two
//   blocks an SM (103 KB of shared memory), past it one; launch 4 two up
//   to D = 128 (a 2-slot ring of dS and K tiles).
// - Staging.  16-byte cp.async of f32 rows (bf16 inputs, or f32 views whose
//   rows are not 16-byte aligned, converted element by element instead: off
//   the main paths, which train in f32); launch 2's Q and dO have one slot,
//   staged as soon as the step's last product has read them.
// - The element pass.  Only a tile the mask cuts (a diagonal, a window
//   edge, the ragged tail, a row with one key) tests each element; the
//   others take exp2 of a scaled score and subtract delta.
// - Exact zeros on rows with one live key.  A softmax over one key is 1
//   with a gradient of 0, so where the mask leaves a query row one key (a
//   causal first row, window 1, S 1) P is set to exactly 1 and dS to
//   exactly 0: dQ and dK get exact zeros from those rows.  The dV product
//   takes dO as three TF32 parts (h + m + l = dO exactly) beside P's hi/lo,
//   four products where the others take three, so P = 1 passes dO through
//   bit for bit: where every row sees one key, dV is dO.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "mma_common.cuh"

namespace {

using mma::mma_3xtf32;
using mma::mma_tf32;
using mma::Tf32;

constexpr int kB = 64;  // query and key tile rows
constexpr int kThreads = 256;
// head_dim: launch 2's K, V, Q and dO tiles of 64 f32 rows with one score
// buffer fill 213 KB at 192, and pass the SM's 227 KB above 200
constexpr int kMaxD = 192;
constexpr int kFrags = kB * kB / 4;  // float4s of a 64 x 64 score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDP = kB + 4;  // pitch of launch 4's staged dS^T tiles

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

// D rounded up to 16 (a warp's half of the output columns is whole
// 8-column n-tiles), and every D <= 64 to 64: the instance that takes
// them (NT = 4) then knows its tile pitch at compile time, which spares
// the registers of two blocks an SM their address arithmetic
__host__ __device__ constexpr int pad_d(int D) {
  return D <= 64 ? 64 : (D + 15) & ~15;
}
// row pitch (floats) of a staged tile
__host__ __device__ constexpr int tile_pitch(int D) { return pad_d(D) + 4; }
// D_pad of the instance with NT n-tiles: a constant at NT = 4
template <int NT>
__device__ __forceinline__ int padded(int D) {
  return NT == 4 ? 64 : pad_d(D);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows r0 .. r0 + kB - 1 of an (S, D) matrix with row stride ss into a
// tile of pitch D_pad + 4, columns 0 .. D_pad - 1; rows past S and columns
// past D read as zeros.  `vec` (f32, D % 4 == 0, 16-byte aligned rows):
// 16-byte cp.async (zero-filled where out of range), waited for by the
// caller; otherwise element loads converted to f32 and stored.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           long long ss, int r0, int S,
                                           int D, int DP, bool vec,
                                           float* dst) {
  const int W = DP + 4;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      const int Dc = DP >> 2;
      for (int e = threadIdx.x; e < kB * Dc; e += kThreads) {
        const int r = e / Dc;
        const int c = e - r * Dc;
        const bool ok = r0 + r < S && 4 * c < D;
        cp_async16(dst + r * W + 4 * c,
                   ok ? src + (long long)(r0 + r) * ss + 4 * c : src,
                   ok ? 16 : 0);
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < kB * DP; e += kThreads) {
    const int r = e / DP;
    const int d = e - r * DP;
    dst[r * W + d] = (r0 + r < S && d < D)
                         ? to_f32(src[(long long)(r0 + r) * ss + d])
                         : 0.f;
  }
}

// kB entries r0 .. of an f32 row vector (lse or delta); zeros past S
__device__ __forceinline__ void stage_vec(const float* __restrict__ src,
                                          int r0, int S, float* dst) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const bool ok = r0 + r < S;
    cp_async4(dst + r, ok ? src + r0 + r : src, ok ? 4 : 0);
  }
}

__device__ __forceinline__ bool allowed(int qi, int kj, int S, int causal,
                                        int window) {
  bool ok = qi < S && kj < S;
  if (causal) ok = ok && kj <= qi;
  if (window > 0) ok = ok && kj > qi - window;
  return ok;
}

// query row qi (< S) sees exactly one key: its softmax is 1, its gradient 0
__device__ __forceinline__ bool one_key(int qi, int S, int causal,
                                        int window) {
  const int hi = causal ? qi : S - 1;
  const int lo = window > 0 ? max(0, qi - window + 1) : 0;
  return hi == lo;
}

// The key tiles [tb, te) that query tile i may see (the same set, seen
// from the key side, as the query tiles launch 2 walks for a key tile).
__host__ __device__ inline void key_tiles(int i, int S, int causal,
                                          int window, int* tb, int* te) {
  const int q0 = i * kB;
  *tb = (window > 0 ? (q0 - window + 1 > 0 ? q0 - window + 1 : 0) : 0) / kB;
  *te = ((causal ? (S < q0 + kB ? S : q0 + kB) : S) + kB - 1) / kB;
}

// (query tile q0, key tile k0) holds an element the mask hides, a row past
// S, or a row that sees one key: the step takes the per-element path
__device__ __forceinline__ bool tile_edge(int q0, int k0, int S, int causal,
                                          int window) {
  return q0 + kB > S || k0 + kB > S || (causal && k0 + kB - 1 > q0) ||
         (window > 0 && k0 <= q0 + kB - 1 - window) || window == 1 ||
         (causal && q0 == 0);
}

// An f32 operand as a TF32 pair in two operations: hi is a with its low 13
// bits cleared, lo = a - hi exactly, passed whole (mma.sync reads a .tf32
// operand's top 19 bits, so lo is truncated to TF32 there): a product
// keeps ~2^-21 of |a b|.
__device__ __forceinline__ Tf32 tf32_split(float a) {
  Tf32 v;
  v.h = __float_as_uint(a) & 0xffffe000u;
  v.l = __float_as_uint(a - __uint_as_float(v.h));
  return v;
}

// dS tiles before query tile i's in a head's run of live (query, key)
// tiles; with i = n_q, the run's length
__host__ __device__ inline long long tiles_before(int i, int S, int causal,
                                                  int window) {
  long long n = 0;
  for (int r = 0; r < i; ++r) {
    int tb, te;
    key_tiles(r, S, causal, window, &tb, &te);
    n += te - tb;
  }
  return n;
}

// --- fragments (g = lane / 4, t = lane % 4) --------------------------------

// A (16 x 8): rows r0 + g, r0 + g + 8; columns k0 + t, k0 + t + 4
__device__ __forceinline__ void frag_a(const float* m, int W, int r0, int k0,
                                       Tf32 (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = m + (r0 + g) * W + k0 + t;
  a[0] = tf32_split(p[0]);
  a[1] = tf32_split(p[8 * W]);
  a[2] = tf32_split(p[4]);
  a[3] = tf32_split(p[8 * W + 4]);
}

// B (8 x 8) of the product with the tile's transpose: B[k][n] =
// m[n0 + n][k0 + k]
__device__ __forceinline__ void frag_bt(const float* m, int W, int n0,
                                        int k0, Tf32 (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = m + (n0 + g) * W + k0 + t;
  b[0] = tf32_split(p[0]);
  b[1] = tf32_split(p[4]);
}

// B of the tile as stored, B[k][n] = m[k0 + k][n0 + n], in the permuted k
// order: b0 row k0 + 2t, b1 row k0 + 2t + 1
__device__ __forceinline__ const float* frag_bp_ptr(const float* m, int W,
                                                    int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  return m + (k0 + 2 * t) * W + n0 + g;
}

// an f32 as three TF32 parts with h + m + l == x exactly: h and m the
// roundings of x and of what h leaves (11 significant bits each), l the
// last <= 2 bits, which the tensor cores' 19-bit read keeps whole
struct Tf32x3 {
  uint32_t h, m, l;
};

__device__ __forceinline__ Tf32x3 tf32_exact(float x) {
  Tf32x3 v;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(v.h) : "f"(x));
  const float r = x - __uint_as_float(v.h);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(v.m) : "f"(r));
  v.l = __float_as_uint(r - __uint_as_float(v.m));
  return v;
}

// c += a b with a in hi/lo parts and b whole (three parts): the small
// terms first, so a = 1 (hi 1, lo 0) against zeros elsewhere gives b
// exactly
__device__ __forceinline__ void mma_4xtf32(float (&c)[4], const Tf32 (&a)[4],
                                           const Tf32x3 (&b)[2]) {
  mma_tf32(c, a[0].l, a[1].l, a[2].l, a[3].l, b[0].h, b[1].h);
  mma_tf32(c, a[0].h, a[1].h, a[2].h, a[3].h, b[0].l, b[1].l);
  mma_tf32(c, a[0].h, a[1].h, a[2].h, a[3].h, b[0].m, b[1].m);
  mma_tf32(c, a[0].h, a[1].h, a[2].h, a[3].h, b[0].h, b[1].h);
}

// a C fragment (rows g, g + 8; columns 2t, 2t + 1 of n-tile j of the
// warp's 16-row block rb) into a fragment-order score buffer, where it is
// the A fragment of k-step 4 hh + j in the permuted k order
__device__ __forceinline__ void put_frag(float4* buf, int rb, int ks,
                                         const float (&c)[4]) {
  buf[(rb * 8 + ks) * 32 + (threadIdx.x & 31)] =
      make_float4(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void get_frag(const float4* buf, int rb, int ks,
                                         Tf32 (&a)[4]) {
  const float4 v = buf[(rb * 8 + ks) * 32 + (threadIdx.x & 31)];
  a[0] = tf32_split(v.x);
  a[1] = tf32_split(v.y);
  a[2] = tf32_split(v.z);
  a[3] = tf32_split(v.w);
}

// S = A_s B_s^T and dP = A_d B_d^T for the warp's 16 rows r0 .. of the
// fixed tiles and 8 JN rows c0 .. of the moving ones (JN n-tiles), over
// the DP / 8 k-steps of the head dim
template <int JN>
__device__ __forceinline__ void scores(const float* as, const float* ad,
                                       const float* bs, const float* bd,
                                       int W, int DP, int r0, int c0,
                                       float (&s)[JN][4],
                                       float (&dp)[JN][4]) {
#pragma unroll
  for (int j = 0; j < JN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < DP; k0 += 8) {
    Tf32 a[4];
    frag_a(as, W, r0, k0, a);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      Tf32 b[2];
      frag_bt(bs, W, c0 + 8 * j, k0, b);
      mma_3xtf32(s[j], a, b);
    }
    frag_a(ad, W, r0, k0, a);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      Tf32 b[2];
      frag_bt(bd, W, c0 + 8 * j, k0, b);
      mma_3xtf32(dp[j], a, b);
    }
  }
}

// acc[j] += A x[:, n0 + 8 j ..] over the 64 rows of x, A the warp's rows
// of a fragment-order score buffer; j < nt of NT n-tiles.  `exact` takes x
// in three parts (the dV product).
template <int NT, bool exact>
__device__ __forceinline__ void update(const float4* buf, const float* x,
                                       int W, int rb, int n0, int nt,
                                       float (&acc)[NT][4]) {
#pragma unroll 1
  for (int ks = 0; ks < 8; ++ks) {
    Tf32 a[4];
    get_frag(buf, rb, ks, a);
    const float* p = frag_bp_ptr(x, W, 8 * ks, n0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        if constexpr (exact) {
          const Tf32x3 b[2] = {tf32_exact(p[8 * j]), tf32_exact(p[W + 8 * j])};
          mma_4xtf32(acc[j], a, b);
        } else {
          const Tf32 b[2] = {tf32_split(p[8 * j]), tf32_split(p[W + 8 * j])};
          mma_3xtf32(acc[j], a, b);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O), f32: one fmaf chain over d in increasing order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, Strides so, Strides sdo, int H, int S, int D,
    long long rows, int vec) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  const int s = (int)(row % S);
  const int h = (int)((row / S) % H);
  const long long b = row / ((long long)S * H);
  const T* orow = o + b * so.b + h * so.h + s * so.s;
  const T* drow = dout + b * sdo.b + h * sdo.h + s * sdo.s;
  float acc = 0.f;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      for (int d = 0; d < D; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(drow + d);
        const float4 y = *reinterpret_cast<const float4*>(orow + d);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
      delta[row] = acc;
      return;
    }
  }
  for (int d = 0; d < D; ++d)
    acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
  delta[row] = acc;
}

// blocks an SM of the product launches: two where their tiles fit twice
// (D <= 64; the second block hides the first one's staging and barriers)
__host__ __device__ constexpr int blocks_per_sm(int NT) {
  return NT <= 4 ? 2 : 1;
}

// ---------------------------------------------------------------------------
// 2. dK, dV per (key tile or causal pair, query-head group, kv head, b)
// ---------------------------------------------------------------------------
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(NT))
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, float* __restrict__ part,
                          float* __restrict__ ds, Strides sq, Strides sk,
                          Strides sv, Strides sdo,
                          Strides sdk, Strides sdv, int B, int H, int KV,
                          int S, int D, int causal, int window, float scale,
                          int groups, int vec) {
  // P and dS in two buffers, or (past D = 128) one, dS written once the dV
  // product has read P
  constexpr bool kTwoBuf = NT <= 8;
  const int DP = padded<NT>(D), W = DP + 4, nt = DP / 16;
  const int nk = (S + kB - 1) / kB;
  // the dS tiles of a head, read where a step stores its tile (held in
  // shared memory, not in a register the whole loop)
  __shared__ long long n_tiles_s;
  if (threadIdx.x == 0) n_tiles_s = tiles_before(nk, S, causal, window);
  const int kvh = blockIdx.y / groups;
  const int grp = blockIdx.y - kvh * groups;
  const int b = blockIdx.z;
  const int hg = H / KV / groups;  // query heads of this block
  const int h0 = kvh * (H / KV) + grp * hg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int rb = warp & 3, hh = warp >> 2;
  const int kr = 16 * rb;          // the warp's key rows
  const int qc = 32 * hh;          // its query columns of the score tiles
  const int dc = hh * (DP >> 1);   // its output columns
  const float sl2 = scale * kLog2e;

  // the fixed-size buffers first (constant addresses, no registers), then
  // the tiles of pitch W
  extern __shared__ float4 smem4[];
  float4* p_s = smem4;                          // P^T
  float4* ds_s = kTwoBuf ? p_s + kFrags : p_s;  // dS^T
  float* lse_s = reinterpret_cast<float*>(p_s + (kTwoBuf ? 2 : 1) * kFrags);
  float* dl_s = lse_s + kB;
  float* k_s = dl_s + kB;  // kB x W each
  float* v_s = k_s + kB * W;
  float* q_s = v_s + kB * W;
  float* do_s = q_s + kB * W;

  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  for (int half = 0; half < (causal ? 2 : 1); ++half) {
    const int t = half ? nk - 1 - (int)blockIdx.x : (int)blockIdx.x;
    if (half && t <= (int)blockIdx.x) break;  // the middle tile of odd nk
    const int k0 = t * kB;
    // query tiles that may see this key tile: q >= k (causal) and
    // q < k + window (window)
    const int qa = causal ? t : 0;
    const int qe = window > 0 ? min(S, k0 + kB - 1 + window) : S;
    const int nqt = (qe + kB - 1) / kB - qa;
    const int n = hg * nqt;

    auto stage = [&](int u) {
      const int h = h0 + u / nqt;
      const int q0 = (qa + u % nqt) * kB;
      stage_tile(q + b * sq.b + h * sq.h, sq.s, q0, S, D, DP, vec, q_s);
      stage_tile(dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, D, DP, vec,
                 do_s);
      const long long row = ((long long)b * H + h) * S;
      stage_vec(lse + row, q0, S, lse_s);
      stage_vec(delta + row, q0, S, dl_s);
    };

    float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

    if (half) __syncthreads();  // the first tile is done with every buffer
    stage_tile(kb, sk.s, k0, S, D, DP, vec, k_s);
    stage_tile(vb, sv.s, k0, S, D, DP, vec, v_s);
    stage(0);
    cp_async_commit();
    for (int u = 0; u < n; ++u) {
      cp_async_wait_all();
      __syncthreads();  // step u's tiles are in
      const int q0 = (qa + u % nqt) * kB;
      const bool edge = tile_edge(q0, k0, S, causal, window);
      const int qt = qa + u % nqt;
      int tb, te;
      key_tiles(qt, S, causal, window, &tb, &te);
      // dS^T as the [key][query] tile (qt, t) of launch 4's input
      float* dst = ds + ((((long long)b * H + h0 + u / nqt) * n_tiles_s +
                          tiles_before(qt, S, causal, window) + t - tb)
                         << 12);
      // the score tiles in passes of JN n-tiles: two at NT = 4, where the
      // registers of two blocks an SM leave no room for all four
      constexpr int JN = NT <= 4 ? 2 : 4;
      float s[JN][4], dp[JN][4];
#pragma unroll
      for (int pass = 0; pass < 4 / JN; ++pass) {
        scores<JN>(k_s, v_s, q_s, do_s, W, DP, kr, qc + 8 * JN * pass, s, dp);
        // P^T and dS^T: rows keys k0 + kr + g (+ 8), columns queries
#pragma unroll
        for (int jj = 0; jj < JN; ++jj) {
          const int j = JN * pass + jj;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = qc + 8 * j + 2 * tq + (e & 1);
            float p = exp2f(fmaf(s[jj][e], sl2, -kLog2e * lse_s[col]));
            float d = p * (dp[jj][e] - dl_s[col]);
            if (edge) {
              const int kj = k0 + kr + g + 8 * (e >> 1);
              const int qi = q0 + col;
              const bool ok = allowed(qi, kj, S, causal, window);
              const bool one = ok && one_key(qi, S, causal, window);
              p = ok ? (one ? 1.f : p) : 0.f;
              d = ok && !one ? d : 0.f;
            }
            s[jj][e] = p;
            dp[jj][e] = d;
          }
          put_frag(p_s, rb, 4 * hh + j, s[jj]);
          if constexpr (kTwoBuf) put_frag(ds_s, rb, 4 * hh + j, dp[jj]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float2*>(
                dst + (kr + g + 8 * i) * kB + qc + 8 * j + 2 * tq) =
                make_float2(dp[jj][2 * i], dp[jj][2 * i + 1]);
        }
      }
      __syncthreads();
      update<NT, true>(p_s, do_s, W, rb, dc, nt, dv_acc);
      if constexpr (!kTwoBuf) {  // JN == 4: dp holds the whole tile
        __syncthreads();  // P read: the buffer takes dS
#pragma unroll
        for (int j = 0; j < JN; ++j) put_frag(ds_s, rb, 4 * hh + j, dp[j]);
        __syncthreads();
      }
      update<NT, false>(ds_s, q_s, W, rb, dc, nt, dk_acc);
      if (u + 1 < n) {
        __syncthreads();  // the slot is read: stage the next step
        stage(u + 1);
        cp_async_commit();
      }
    }

    // keys k0 + kr + g (+ 8), columns dc + 8 j + 2 tq (+ 1)
    const long long part_n = (long long)B * KV * S * D;
    float* pk = part + (((long long)grp * B + b) * KV + kvh) * S * D;
    float* pv = pk + groups * part_n;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + kr + g + 8 * (e >> 1);
        const int d = dc + 8 * j + 2 * tq + (e & 1);
        if (kj >= S || d >= D) continue;
        if (groups == 1) {
          dk[b * sdk.b + kvh * sdk.h + kj * sdk.s + d] =
              from_f32<T>(dk_acc[j][e] * scale);
          dv[b * sdv.b + kvh * sdv.h + kj * sdv.s + d] =
              from_f32<T>(dv_acc[j][e]);
        } else {
          pk[(long long)kj * D + d] = dk_acc[j][e];
          pv[(long long)kj * D + d] = dv_acc[j][e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dK, dV = the groups' partials summed in group order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_sum_kernel(
    const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
    Strides sdk, Strides sdv, int KV, int S, int D, int groups,
    long long n, float scale) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const int d = (int)(e % D);
    const int s = (int)((e / D) % S);
    const int kvh = (int)((e / ((long long)D * S)) % KV);
    const long long b = e / ((long long)D * S * KV);
    float gk = 0.f, gv = 0.f;
    for (int g = 0; g < groups; ++g) {
      gk += part[g * n + e];
      gv += part[(groups + g) * n + e];
    }
    dk[b * sdk.b + kvh * sdk.h + s * sdk.s + d] = from_f32<T>(gk * scale);
    dv[b * sdv.b + kvh * sdv.h + s * sdv.s + d] = from_f32<T>(gv);
  }
}

// ---------------------------------------------------------------------------
// 4. dQ = dS K per (b, h, query tile), from launch 2's dS tiles, the
//    longest query tiles first
// ---------------------------------------------------------------------------
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const float* __restrict__ ds, const T* __restrict__ k,
                        T* __restrict__ dq, Strides sk, Strides sdq, int H,
                        int KV, int S, int D, int causal, int window,
                        float scale, int vec) {
  const int DP = padded<NT>(D), W = DP + 4, nt = DP / 16;
  const int nq = (S + kB - 1) / kB;
  const int qt = nq - 1 - (int)blockIdx.x;
  const int q0 = qt * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int rb = warp & 3, hh = warp >> 2;
  const int qr = 16 * rb;         // the warp's query rows
  const int dc = hh * (DP >> 1);  // its output columns

  // two slots of (dS^T [key][query] of pitch kDP, K tile of pitch W)
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const int slot_floats = kB * kDP + kB * W;

  int tb, te;
  key_tiles(qt, S, causal, window, &tb, &te);
  const int n = te - tb;
  const float* dsb =
      ds + ((((long long)b * H + h) * tiles_before(nq, S, causal, window) +
             tiles_before(qt, S, causal, window))
            << 12);
  const T* kb = k + b * sk.b + kvh * sk.h;
  auto stage = [&](int u, int slot) {
    float* d_s = base + slot * slot_floats;
    const float* src = dsb + ((long long)u << 12);
    for (int e = threadIdx.x; e < kB * kB / 4; e += kThreads) {
      const int r = e >> 4, c = e & 15;
      cp_async16(d_s + r * kDP + 4 * c, src + 4 * e, 16);
    }
    stage_tile(kb, sk.s, (tb + u) * kB, S, D, DP, vec, d_s + kB * kDP);
  };
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  stage(0, 0);
  cp_async_commit();
  for (int u = 0; u < n; ++u) {
    const int slot = u & 1;
    cp_async_wait_all();
    __syncthreads();  // step u's tiles are in; step u - 1 is done
    if (u + 1 < n) stage(u + 1, slot ^ 1);
    cp_async_commit();
    const float* d_s = base + slot * slot_floats;
    const float* k_s = d_s + kB * kDP;
#pragma unroll 1
    for (int ks = 0; ks < 8; ++ks) {
      // A = dS (queries x keys) read from dS^T, k in the permuted order
      const float* pa = d_s + (8 * ks + 2 * tq) * kDP + qr + g;
      const Tf32 a[4] = {tf32_split(pa[0]), tf32_split(pa[8]),
                         tf32_split(pa[kDP]), tf32_split(pa[kDP + 8])};
      const float* p = frag_bp_ptr(k_s, W, 8 * ks, dc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          const Tf32 bk[2] = {tf32_split(p[8 * j]), tf32_split(p[W + 8 * j])};
          mma_3xtf32(acc[j], a, bk);
        }
      }
    }
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + qr + g + 8 * (e >> 1);
      const int d = dc + 8 * j + 2 * tq + (e & 1);
      if (qi < S && d < D)
        dqb[(long long)qi * sdq.s + d] = from_f32<T>(acc[j][e] * scale);
    }
  }
}

// shared memory of the product launches: four staged tiles and the
// score buffers (plus launch 2's lse and delta)
size_t dkdv_smem_bytes(int D, bool two_buf) {
  return sizeof(float) * ((size_t)4 * kB * tile_pitch(D) +
                          (two_buf ? 2 : 1) * kB * kB + 2 * kB);
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) * 2 * ((size_t)kB * kDP + kB * tile_pitch(D));
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

// launch 2's blocks along the keys: a key tile each, or a causal pair
int key_blocks(int S, int causal) {
  const int nk = (S + kB - 1) / kB;
  return causal ? (nk + 1) / 2 : nk;
}

// The query-head groups of launch 2: the fewest (a divisor of G) that
// give at least two blocks an SM.
int head_groups(int B, int H, int KV, int S, int causal) {
  const int G = H / KV;
  const long long want = 2LL * sm_count();
  for (int g = 1; g < G; ++g)
    if (G % g == 0 && (long long)key_blocks(S, causal) * g * KV * B >= want)
      return g;
  return G;
}

// 16-byte-aligned rows of every (b, head, s) of a (B, heads, S, D) view
bool rows_aligned(const void* p, const long long* st, int B, int heads,
                  int S) {
  const long long n[3] = {B, heads, S};
  if (reinterpret_cast<size_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && st[i] % 4) return false;
  return true;
}

template <typename T, int NT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* work, void* dq, void* dk, void* dv,
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
  const int vec =
      std::is_same<T, float>::value && D % 4 == 0 &&
      rows_aligned(q, st, B, H, S) && rows_aligned(k, st + 3, B, KV, S) &&
      rows_aligned(v, st + 6, B, KV, S) && rows_aligned(o, st + 9, B, H, S) &&
      rows_aligned(dout, st + 12, B, H, S);
  const long long rows = (long long)B * H * S;
  float* ds = work;  // [b][h][live tile][key][query], 64 x 64 a tile
  float* delta = ds + ((long long)B * H *
                       tiles_before((S + kB - 1) / kB, S, causal, window)
                       << 12);
  float* part = delta + rows;

  flash_bwd_delta_kernel<T><<<(unsigned)((rows + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, so, sdo, H, S, D, rows, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int groups = head_groups(B, H, KV, S, causal);
  auto dkdv = flash_bwd_dkdv_kernel<T, NT>;
  const size_t b2 = dkdv_smem_bytes(D, NT <= 8);
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)b2);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(key_blocks(S, causal), KV * groups, B), kThreads, b2, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      part, ds, sq, sk, sv, sdo, sdk, sdv, B, H, KV, S, D, causal, window,
      scale, groups, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (groups > 1) {
    const long long n = (long long)B * KV * S * D;
    const long long blocks = std::min<long long>((n + kThreads - 1) / kThreads,
                                                 16LL * sm_count());
    flash_bwd_sum_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        part, static_cast<T*>(dk), static_cast<T*>(dv), sdk, sdv, KV, S, D,
        groups, n, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  auto dqk = flash_bwd_dq_kernel<T, NT>;
  const size_t b4 = dq_smem_bytes(D);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)b4);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((S + kB - 1) / kB, H, B), kThreads, b4, stream>>>(
      ds, kt, static_cast<T*>(dq), sk, sdq, H, KV, S, D, causal, window,
      scale, vec);
  return cudaGetLastError();
}

// NT: the n-tiles of a warp's half of the output columns, D_pad / 16
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* work, void* dq, void* dk, void* dv,
                     const long long* st, int B, int H, int KV, int S, int D,
                     int causal, int window, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 4>(q, k, v, o, dout, lse, work, dq, dk, dv, st, B, H,
                        KV, S, D, causal, window, stream);
  if (D <= 128)
    return launch<T, 8>(q, k, v, o, dout, lse, work, dq, dk, dv, st, B, H,
                        KV, S, D, causal, window, stream);
  return launch<T, 12>(q, k, v, o, dout, lse, work, dq, dk, dv, st, B, H,
                       KV, S, D, causal, window, stream);
}

}  // namespace

// f32 scratch the backward needs at these sizes, in floats: the dS tiles
// (64 x 64 for each live (query tile, key tile) of each (b, h)), delta
// (B, H, S), then the query-head groups' partial dK and dV when a KV
// head's heads are split over blocks.
extern "C" long long flash_attention_bwd_workspace(int B, int H, int KV,
                                                   int S, int D, int causal,
                                                   int window) {
  if (B < 1 || S < 1 || KV < 1 || H % KV) return 0;
  const long long rows = (long long)B * H * S;
  const long long tiles =
      tiles_before((S + kB - 1) / kB, S, causal, window);
  const int groups = head_groups(B, H, KV, S, causal);
  return ((long long)B * H * tiles << 12) + rows +
         (groups > 1 ? 2LL * groups * B * KV * S * D : 0);
}

// q/o/dout/dq (B, H, S, D) and k/v/dk/dv (B, KV, S, D), all of one type,
// views with a unit stride on D and the (b, head, s) element strides in
// `strides` (24 int64: q, k, v, o, dout, dq, dk, dv); lse (B, H, S) f32
// from the forward; `work` f32 scratch of flash_attention_bwd_workspace()
// floats.  D <= 192, H % KV == 0.  Returns the first CUDA error of the
// launches, else 0.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* work, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int KV, int S, int D,
    int causal, int window, int bf16, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (D < 1 || D > kMaxD || KV < 1 || H % KV)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* w = static_cast<float*>(work);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, l, w, dq, dk, dv,
                                   strides, B, H, KV, S, D, causal, window,
                                   st);
  return dispatch<float>(q, k, v, o, dout, l, w, dq, dk, dv, strides, B, H,
                         KV, S, D, causal, window, st);
}
