// Flash-attention backward kernels for Hopper (sm_90a).
//
// The JAX package has no Pallas backward for `flash_attention_bhsd`
// (src/repro/kernels/flash_attention.py): JAX trains through XLA's
// attention.  The port's forward is a hand-written kernel with no autograd
// of its own, so its gradient is a kernel too, in the FlashAttention-2
// scheme, as up to four launches on one stream:
//
//   1. delta = rowsum(dO * O)            one thread per (b, h, row)
//   2. dK, dV per (key-tile pair, group of query heads, kv head, b); each
//      step also stores its 64 x 64 tile of dS = P * (dP - delta) in f32
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
// (query, key) pair (S, dP, dV, dK, dQ), all in full f32 on the CUDA cores
// (TF32 would miss the f32 gates).  Keeping dS (4 bytes a live pair: 143
// MB of scratch at yi-9b's train shape, written once and read once) spares
// launch 4 the recompute of S and dP, which would make seven products of
// five.  What the design does about the rest:
//
// - Balanced blocks.  A block of launch 2 takes key tile j and key tile
//   n - 1 - j, so under a causal mask every block walks n + 1 query tiles
//   per head: at yi-9b's train shape (B 2, H 32, KV 4, S 1024, n = 16)
//   17 (head, query-tile) steps per block with one head per block, 512
//   blocks, where one block per key tile and KV head would give 128
//   blocks of 8 to 128 steps.  The G = H / KV query heads of a KV head
//   are split over the fewest groups that give 2 blocks per SM (yi 8
//   groups, granite-moe 3, zamba2 1); each group writes f32 partial dK,
//   dV, summed in group order by launch 3.  Launch 4 runs its query tiles
//   longest first.
// - Register tiles that shared memory can feed.  256 threads; a thread
//   holds a 4 x 4 tile of S and of dP (rows ty + 16 i, keys tx + 16 j) and
//   a 4-row x (4 NCH)-column tile of the dV and dK (or dQ) accumulators.
//   Every operand is read as a 16-byte LDS.128: S and dP along d (tiles
//   [row][d], d contiguous), the updates along their output columns (P
//   and dS [query][key], the stored dS^T [key][query] for dQ).  A warp spans 4 ty x
//   8 tx, so a read serves 4 or 8 distinct 16-byte chunks and broadcasts
//   the rest: 16 wavefronts a warp for 128 FMAs of S and dP per 4 d, 6
//   for 64 FMAs of the updates per query row (8 and 10.7 FMA issues per
//   wavefront, against the 4 at which shared memory keeps up).  Tile rows
//   are padded to an odd number of 16-byte chunks and P and dS go to a
//   [query][key] buffer of pitch 72: no bank conflicts in either.
// - Asynchronous staging: 16-byte cp.async into a 2-slot ring, so the
//   next query tile's Q, dO, lse and delta (launch 2) or the next key
//   tile's K and dS tile (launch 4) arrive while the current one is
//   multiplied.  bf16 inputs, or f32 views whose rows are not 16-byte aligned, are
//   converted element by element into the same f32 tiles instead (off the
//   main paths, which train in f32).
// - Exact zeros on rows with one live key.  delta is the same fmaf chain,
//   over d in increasing order from 0, as each element of dP; where a row
//   sees one key, O equals that key's V, so dP - delta is exactly 0 and
//   dQ and dK get exact zeros.  S is the forward's own chain too, scaled
//   by a rounded product (__fmul_rn: no fused multiply-add with lse), so
//   P is exactly 1 there and dV is exactly dO.
//
// Shared memory (f32 tiles of pitch P = tile_pitch(D)): launch 2 holds K,
// V, a 2-slot ring of Q and dO, one [query][key] buffer for P and then dS,
// and the ring's lse and delta: 222,208 B at D = 128, one block an SM.
// Past D = 128 (stablelm-12b's 160) two slots would pass the SM's 227 KB,
// so the ring has one: the next Q and dO are staged once the step has
// read them (187,392 B at D = 160, 220,160 B at the limit of 192), and a
// thread's accumulators grow to NCH = 3 chunks (96 f32 of dK and dV).
// Launch 4 holds a 2-slot ring of K and dS^T tiles: 100,352 B at D = 128,
// two blocks an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kB = 64;           // query and key tile rows
constexpr int kThreads = 256;
constexpr int kPP = kB + 8;      // pitch of P / dS [query][key]
// head_dim: launch 2's K, V, Q and dO tiles of 64 f32 rows fill 215 KB at
// 192 with one slot of Q and dO, and pass the SM's 227 KB above 200
constexpr int kMaxD = 192;

// slots of launch 2's Q / dO ring: two (staging overlaps the products) up
// to D = 128, where they fill 217 KB; one past it
__host__ __device__ constexpr int ring_slots(int nch) {
  return nch <= 2 ? 2 : 1;
}

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

// Row pitch (floats) of a staged tile: D rounded up to 4, plus an odd
// number of 16-byte chunks in all, so 8 consecutive rows read at one
// column chunk fall in 8 different bank groups.
__host__ __device__ inline int tile_pitch(int D) {
  int chunks = (D + 3) / 4 + 1;
  if (!(chunks & 1)) ++chunks;
  return 4 * chunks;
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
// tile of pitch P; rows past S and columns past D read as zeros.  `vec`
// (f32, D % 4 == 0, 16-byte aligned rows): 16-byte cp.async, waited for
// by the caller; otherwise element loads converted to f32 and stored.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           long long ss, int r0, int S,
                                           int D, int P, bool vec,
                                           float* dst) {
  const int Dc = (D + 3) >> 2;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      for (int e = threadIdx.x; e < kB * Dc; e += kThreads) {
        const int r = e / Dc;
        const int c = e - r * Dc;
        const bool ok = r0 + r < S;
        cp_async16(dst + r * P + 4 * c,
                   ok ? src + (long long)(r0 + r) * ss + 4 * c : src,
                   ok ? 16 : 0);
      }
      return;
    }
  }
  const int W = 4 * Dc;
  for (int e = threadIdx.x; e < kB * W; e += kThreads) {
    const int r = e / W;
    const int d = e - r * W;
    dst[r * P + d] = (r0 + r < S && d < D)
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

// The key tiles [tb, te) that query tile i may see (the same set, seen
// from the key side, as the query tiles launch 2 walks for a key tile).
__host__ __device__ inline void key_tiles(int i, int S, int causal,
                                          int window, int* tb, int* te) {
  const int q0 = i * kB;
  *tb = (window > 0 ? (q0 - window + 1 > 0 ? q0 - window + 1 : 0) : 0) / kB;
  *te = ((causal ? (S < q0 + kB ? S : q0 + kB) : S) + kB - 1) / kB;
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

// s = Q K^T and dp = dO V^T for the thread's 4 x 4 tile (query rows
// ty + 16 i, keys tx + 16 j): each element one fmaf chain over d in
// increasing order from 0, the forward's order and delta's.  U column
// chunks in flight: 2, or 1 beside NCH = 3's 96 accumulators.
template <int U>
__device__ __forceinline__ void scores(const float* q_s, const float* do_s,
                                       const float* k_s, const float* v_s,
                                       int Dc, int P, int ty, int tx,
                                       float s[4][4], float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll U
  for (int c = 0; c < Dc; ++c) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * P + 4 * c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * P + 4 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(do_s + (ty + 16 * i) * P + 4 * c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(v_s + (tx + 16 * j) * P + 4 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dp[i][j] = fmaf(a[i].x, b[j].x, dp[i][j]);
        dp[i][j] = fmaf(a[i].y, b[j].y, dp[i][j]);
        dp[i][j] = fmaf(a[i].z, b[j].z, dp[i][j]);
        dp[i][j] = fmaf(a[i].w, b[j].w, dp[i][j]);
      }
  }
}

// acc[i][4 n + e] += sum over the kB rows r of w[r][4 y + i] * x[r][col]
// with col = 4 (x0 + 16 n) + e: dV += P^T dO and dK += dS^T Q (w is
// [query][key], y the key group) or dQ += dS K (w is dS^T [key][query],
// y the query group).  Column chunks past the last are clamped onto it
// and their sums never written.
template <int NCH, int WP>
__device__ __forceinline__ void update(const float* w_s, const float* x_s,
                                       int P, int Dc, int y, int x0,
                                       float acc[4][4 * NCH]) {
  int col[NCH];
#pragma unroll
  for (int n = 0; n < NCH; ++n) col[n] = 4 * min(x0 + 16 * n, Dc - 1);
  // rows in flight: 4 up to NCH = 2; at NCH = 3 the 96 accumulators of
  // launch 2 leave registers for 2 (4 spilled at 255 registers)
  constexpr int kRows = NCH <= 2 ? 4 : 2;
#pragma unroll kRows
  for (int r = 0; r < kB; ++r) {
    const float4 w4 = *reinterpret_cast<const float4*>(w_s + r * WP + 4 * y);
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int n = 0; n < NCH; ++n) {
      const float4 x = *reinterpret_cast<const float4*>(x_s + r * P + col[n]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * n + 0] = fmaf(w[i], x.x, acc[i][4 * n + 0]);
        acc[i][4 * n + 1] = fmaf(w[i], x.y, acc[i][4 * n + 1]);
        acc[i][4 * n + 2] = fmaf(w[i], x.z, acc[i][4 * n + 2]);
        acc[i][4 * n + 3] = fmaf(w[i], x.w, acc[i][4 * n + 3]);
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

// ---------------------------------------------------------------------------
// 2. dK, dV per (key-tile pair, query-head group, kv head, b)
// ---------------------------------------------------------------------------
template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
    float* __restrict__ ds, Strides sq, Strides sk, Strides sv, Strides sdo,
    Strides sdk, Strides sdv, int B, int H, int KV, int S, int D, int causal,
    int window, float scale, int groups, int vec) {
  const int nk = (S + kB - 1) / kB;
  const long long n_tiles = tiles_before(nk, S, causal, window);
  const int kvh = blockIdx.y / groups;
  const int grp = blockIdx.y - kvh * groups;
  const int b = blockIdx.z;
  const int hg = H / KV / groups;  // query heads of this block
  const int h0 = kvh * (H / KV) + grp * hg;
  const int P = tile_pitch(D);
  const int Dc = (D + 3) >> 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // 0..15
  const int tx = (warp & 1) * 8 + (lane & 7);     // 0..15

  extern __shared__ float4 smem4[];
  constexpr int kSlots = ring_slots(NCH);
  float* k_s = reinterpret_cast<float*>(smem4);  // kB x P
  float* v_s = k_s + kB * P;                     // kB x P
  float* q_s = v_s + kB * P;                     // kSlots of kB x P
  float* do_s = q_s + kSlots * kB * P;           // kSlots of kB x P
  float* ps = do_s + kSlots * kB * P;            // kB x kPP: P, then dS
  float* lse_s = ps + kB * kPP;                  // 2 slots of kB
  float* dl_s = lse_s + 2 * kB;                  // 2 slots of kB

  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  for (int half = 0; half < 2; ++half) {
    const int t = half ? nk - 1 - (int)blockIdx.x : (int)blockIdx.x;
    if (half && t <= (int)blockIdx.x) break;  // the middle tile of odd nk
    const int k0 = t * kB;
    // query tiles that may see this key tile: q >= k (causal) and
    // q < k + window (window)
    const int qa = causal ? t : 0;
    const int qe = window > 0 ? min(S, k0 + kB - 1 + window) : S;
    const int nqt = (qe + kB - 1) / kB - qa;
    const int n = hg * nqt;

    auto stage = [&](int u, int slot) {
      const int h = h0 + u / nqt;
      const int q0 = (qa + u % nqt) * kB;
      stage_tile(q + b * sq.b + h * sq.h, sq.s, q0, S, D, P, vec,
                 q_s + slot * kB * P);
      stage_tile(dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, D, P, vec,
                 do_s + slot * kB * P);
      const long long row = ((long long)b * H + h) * S;
      stage_vec(lse + row, q0, S, lse_s + slot * kB);
      stage_vec(delta + row, q0, S, dl_s + slot * kB);
    };

    float dk_acc[4][4 * NCH], dv_acc[4][4 * NCH];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NCH; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

    if (half) __syncthreads();  // the first tile is done with every buffer
    stage_tile(kb, sk.s, k0, S, D, P, vec, k_s);
    stage_tile(vb, sv.s, k0, S, D, P, vec, v_s);
    stage(0, 0);
    cp_async_commit();
    for (int u = 0; u < n; ++u) {
      const int slot = kSlots == 2 ? u & 1 : 0;
      cp_async_wait_all();
      __syncthreads();  // step u's tiles are in; step u - 1 is done
      if (kSlots == 2 && u + 1 < n) stage(u + 1, slot ^ 1);
      cp_async_commit();
      const int qt = qa + u % nqt;
      const int q0 = qt * kB;
      const float* qs = q_s + slot * kB * P;
      const float* dos = do_s + slot * kB * P;
      const float* lr = lse_s + slot * kB;
      const float* dr = dl_s + slot * kB;

      float s[4][4], dp[4][4];
      scores<NCH <= 2 ? 2 : 1>(qs, dos, k_s, v_s, Dc, P, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = allowed(q0 + r, k0 + c, S, causal, window)
                              ? expf(__fmul_rn(s[i][j], scale) - lr[r])
                              : 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - dr[r]);
          ps[r * kPP + c] = p;
        }
      }
      __syncthreads();
      update<NCH, kPP>(ps, dos, P, Dc, ty, tx, dv_acc);
      __syncthreads();
      // dS to smem for dK, and as the [key][query] tile (qt, t) of
      // launch 4's input
      int tb, te;
      key_tiles(qt, S, causal, window, &tb, &te);
      float* dst = ds + ((((long long)b * H + h0 + u / nqt) * n_tiles +
                          tiles_before(qt, S, causal, window) + t - tb)
                         << 12);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(ty + 16 * i) * kPP + tx + 16 * j] = dp[i][j];
          dst[(tx + 16 * j) * kB + ty + 16 * i] = dp[i][j];
        }
      __syncthreads();
      update<NCH, kPP>(ps, qs, P, Dc, ty, tx, dk_acc);
      if (kSlots == 1 && u + 1 < n) {  // one slot: stage once it is read
        __syncthreads();
        stage(u + 1, 0);
        cp_async_commit();
      }
    }

    // keys k0 + 4 ty + i, columns 4 (tx + 16 n) + e
    const long long part_n = (long long)B * KV * S * D;
    float* pk = part + (((long long)grp * B + b) * KV + kvh) * S * D;
    float* pv = pk + groups * part_n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + 4 * ty + i;
      if (kj >= S) continue;
#pragma unroll
      for (int nn = 0; nn < NCH; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * (tx + 16 * nn) + e;
          if (d >= D) continue;
          const float gk = dk_acc[i][4 * nn + e];
          const float gv = dv_acc[i][4 * nn + e];
          if (groups == 1) {
            dk[b * sdk.b + kvh * sdk.h + kj * sdk.s + d] =
                from_f32<T>(gk * scale);
            dv[b * sdv.b + kvh * sdv.h + kj * sdv.s + d] = from_f32<T>(gv);
          } else {
            pk[(long long)kj * D + d] = gk;
            pv[(long long)kj * D + d] = gv;
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
template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_kernel(
    const float* __restrict__ ds, const T* __restrict__ k,
    T* __restrict__ dq, Strides sk, Strides sdq, int H, int KV, int S, int D,
    int causal, int window, float scale, int vec) {
  const int nq = (S + kB - 1) / kB;
  const int qt = nq - 1 - (int)blockIdx.x;
  const int q0 = qt * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int P = tile_pitch(D);
  const int Dc = (D + 3) >> 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // 2 slots of kB x P
  float* d_s = k_s + 2 * kB * P;                 // 2 slots of kB x kB

  int tb, te;
  key_tiles(qt, S, causal, window, &tb, &te);
  const int n = te - tb;
  const float* dsb =
      ds + ((((long long)b * H + h) * tiles_before(nq, S, causal, window) +
             tiles_before(qt, S, causal, window))
            << 12);
  const T* kb = k + b * sk.b + kvh * sk.h;
  auto stage = [&](int u, int slot) {
    stage_tile(kb, sk.s, (tb + u) * kB, S, D, P, vec, k_s + slot * kB * P);
    const float* src = dsb + ((long long)u << 12);
    for (int e = threadIdx.x; e < kB * kB / 4; e += kThreads)
      cp_async16(d_s + slot * kB * kB + 4 * e, src + 4 * e, 16);
  };
  float acc[4][4 * NCH];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NCH; ++c) acc[i][c] = 0.f;

  stage(0, 0);
  cp_async_commit();
  for (int u = 0; u < n; ++u) {
    const int slot = u & 1;
    cp_async_wait_all();
    __syncthreads();  // step u's tiles are in; step u - 1 is done
    if (u + 1 < n) stage(u + 1, slot ^ 1);
    cp_async_commit();
    update<NCH, kB>(d_s + slot * kB * kB, k_s + slot * kB * P, P, Dc, ty,
                    tx, acc);
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= S) continue;
#pragma unroll
    for (int nn = 0; nn < NCH; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (tx + 16 * nn) + e;
        if (d < D)
          dqb[(long long)qi * sdq.s + d] =
              from_f32<T>(acc[i][4 * nn + e] * scale);
      }
  }
}

size_t dkdv_smem_bytes(int D, int slots) {
  return sizeof(float) * ((size_t)(2 + 2 * slots) * kB * tile_pitch(D) +
                          (size_t)kB * kPP + 4 * kB);
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) * 2 * kB * ((size_t)tile_pitch(D) + kB);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

// The query-head groups of launch 2: the fewest (a divisor of G) that
// give at least two blocks an SM.
int head_groups(int B, int H, int KV, int S) {
  const int G = H / KV;
  const long long pairs = ((S + kB - 1) / kB + 1) / 2;
  const long long want = 2LL * sm_count();
  for (int g = 1; g < G; ++g)
    if (G % g == 0 && pairs * g * KV * B >= want) return g;
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

template <typename T, int NCH>
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

  const int groups = head_groups(B, H, KV, S);
  const int nk = (S + kB - 1) / kB;
  auto dkdv = flash_bwd_dkdv_kernel<T, NCH>;
  const size_t b2 = dkdv_smem_bytes(D, ring_slots(NCH));
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)b2);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((nk + 1) / 2, KV * groups, B), kThreads, b2, stream>>>(
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

  auto dqk = flash_bwd_dq_kernel<T, NCH>;
  const size_t b4 = dq_smem_bytes(D);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)b4);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(nk, H, B), kThreads, b4, stream>>>(
      ds, kt, static_cast<T*>(dq), sk, sdq, H, KV, S, D, causal, window,
      scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* work, void* dq, void* dk, void* dv,
                     const long long* st, int B, int H, int KV, int S, int D,
                     int causal, int window, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 1>(q, k, v, o, dout, lse, work, dq, dk, dv, st, B, H,
                        KV, S, D, causal, window, stream);
  if (D <= 128)
    return launch<T, 2>(q, k, v, o, dout, lse, work, dq, dk, dv, st, B, H,
                        KV, S, D, causal, window, stream);
  return launch<T, 3>(q, k, v, o, dout, lse, work, dq, dk, dv, st, B, H, KV,
                      S, D, causal, window, stream);
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
  const int groups = head_groups(B, H, KV, S);
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
