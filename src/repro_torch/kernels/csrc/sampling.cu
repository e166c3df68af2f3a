// Fused sampling kernel for Hopper (sm_90a), written in CUDA C++.
//
// Replaces the Pallas TPU kernel `_sampling_kernel` / `fused_sample_bv` in
// src/repro/kernels/sampling.py: padded-vocab mask; behaviour logprob
// under the unfiltered temperature-1 row; greedy first-occurrence argmax,
// or temperature (a true division), the exact top-k cutoff (the k-th
// largest value, duplicates counted), the top-p cutoff on order-preserving
// uint32 keys, and Gumbel-max with the noise passed in.
//
// Bound on this card: bytes (logits and noise read once, 8 bytes per
// vocab entry), 1.25 us for 8 rows of 65536.  The first version kept one
// 1024-thread block per row (8 of 132 SMs busy) and streamed the row from
// L2 once per step: 2 + k + 2 + 33 + 1 passes with top-k 50 and top-p,
// each ending in a block reduction, ~8.6 us a pass.
//
// Design.  One cluster of kCluster blocks per row (grid (kCluster, B)):
// each block loads its 1/kCluster of the logits and of the noise into
// shared memory once (16-byte loads) and never reads device memory again.
// Every step is a block reduction whose partials the blocks exchange
// through distributed shared memory after one cluster barrier; each block
// merges them in rank order, so every block holds the same result and the
// run is deterministic.  Steps:
//   1. row max and first argmax (the greedy token);
//   2. sum exp(x - max) (the log-sum-exp), published with the first top-k
//      histogram;
//   top-k: a 4-round radix select on the sort keys, 8 bits a round: a
//      256-bin histogram of counts (warp-aggregated shared atomics) over
//      the keys that match the digits chosen so far finds the bin of the
//      k-th largest key, exactly, duplicates counted;
//   top-p: a 4-round radix descent on the same keys over the candidates
//      (the top-k survivors): 256-bin histograms of each key's mass
//      exp(x - mx) as an integer of 2^-40 units, so sums are exact in any
//      order, find the smallest key t with mass(keys > t) < p * z;
//   Gumbel-max over the filtered row, first index on ties.
// About a dozen cluster barriers a call, where the first version made 88
// passes over the row.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kBins = 256;
constexpr float kNegInf = -1e30f;
constexpr float kMassScale = 1099511627776.f;  // 2^40
constexpr unsigned kFull = 0xffffffffu;

struct ArgMax {
  float v;
  int i;
};

// larger value wins; on a tie the smaller index (first occurrence)
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// Order-preserving map float32 -> uint32: a < b  <=>  key(a) < key(b).
__device__ __forceinline__ uint32_t sort_key(float x) {
  const uint32_t bits = __float_as_uint(x);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k >> 31) ? (k & 0x7fffffffu) : ~k);
}

// What the blocks of a cluster publish to each other.
struct Shared {
  uint32_t count[4][kBins];  // top-k histograms, one per round
  unsigned long long mass[4][kBins];  // top-p histograms
  float pmax, psum, pgval;   // this block's partials
  int pidx, pgidx;
  // block-local scratch
  float rv[kWarps];
  int ri[kWarps];
  unsigned long long scan[kWarps];
  unsigned long long pick;   // the chosen bin's exclusive sum
  unsigned long long total;  // z
};

__device__ ArgMax block_argmax(ArgMax x, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    x = better(x, {__shfl_xor_sync(kFull, x.v, o),
                   __shfl_xor_sync(kFull, x.i, o)});
  if (lane == 0) {
    sh.rv[warp] = x.v;
    sh.ri[warp] = x.i;
  }
  __syncthreads();
  x = {sh.rv[0], sh.ri[0]};
  for (int w = 1; w < kWarps; ++w) x = better(x, {sh.rv[w], sh.ri[w]});
  __syncthreads();  // the scratch is reused by the next reduction
  return x;
}

// in a fixed order: warp shuffles, then the warp totals in warp order
__device__ float block_sum(float v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) sh.rv[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += sh.rv[w];
  __syncthreads();
  return t;
}

// Inclusive sum over threads 0 .. kBins - 1 in thread order (thread d'
// holds bin kBins - 1 - d', so the sum is over the bins >= its own).
__device__ unsigned long long bins_scan(unsigned long long v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) sh.scan[warp] = v;
  __syncthreads();
  unsigned long long add = 0;
  for (int w = 0; w < warp && w < kBins / 32; ++w) add += sh.scan[w];
  __syncthreads();
  return v + add;
}

__global__ void __launch_bounds__(kThreads) fused_sample_kernel(
    const float* __restrict__ logits,  // (B, V)
    const float* __restrict__ gumbel,  // (B, V)
    int* __restrict__ tok_out,         // (B,)
    float* __restrict__ lp_out,        // (B,)
    int V, int per, float temperature, int top_k, float top_p,
    int vocab_size) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t row = blockIdx.y;
  const float* lrow = logits + row * V;
  const float* grow = gumbel + row * V;
  const int n_valid = (vocab_size > 0 && vocab_size < V) ? vocab_size : V;
  const int lo = rank * per;
  const int n = max(0, min(V, lo + per) - lo);  // this block's entries
  const int iters = (per + kThreads - 1) / kThreads;  // warp-uniform
  const bool sample = temperature > 0.f;
  float* xs = smem;       // the logits, masked, then divided by T
  float* gs = smem + per;  // the noise

  // load once: 16-byte loads where the rows allow
  const bool vec = V % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(logits) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(gumbel) & 15) == 0;
  if (vec) {
    for (int c = tid; c < n / 4; c += kThreads) {
      const int i = lo + 4 * c;
      float4 v = *reinterpret_cast<const float4*>(lrow + i);
      v.x = i < n_valid ? v.x : kNegInf;
      v.y = i + 1 < n_valid ? v.y : kNegInf;
      v.z = i + 2 < n_valid ? v.z : kNegInf;
      v.w = i + 3 < n_valid ? v.w : kNegInf;
      reinterpret_cast<float4*>(xs)[c] = v;
      if (sample)
        reinterpret_cast<float4*>(gs)[c] =
            *reinterpret_cast<const float4*>(grow + i);
    }
  } else {
    for (int c = tid; c < n; c += kThreads) {
      xs[c] = lo + c < n_valid ? lrow[lo + c] : kNegInf;
      if (sample) gs[c] = grow[lo + c];
    }
  }
  for (int d = tid; d < 4 * kBins; d += kThreads) {
    (&sh.count[0][0])[d] = 0u;
    (&sh.mass[0][0])[d] = 0ull;
  }
  __syncthreads();

  // 1. the row max and its first index
  ArgMax best{-INFINITY, V};
  for (int c = tid; c < n; c += kThreads) best = better(best, {xs[c], lo + c});
  best = block_argmax(best, sh);
  if (tid == 0) {
    sh.pmax = best.v;
    sh.pidx = best.i;
  }
  cluster.sync();
  best = {-INFINITY, V};
  for (int q = 0; q < kCluster; ++q)
    best = better(best, {*cluster.map_shared_rank(&sh.pmax, q),
                         *cluster.map_shared_rank(&sh.pidx, q)});
  const float m0 = best.v;

  // 2. sum exp(x - m0), published with the first top-k histogram
  float z0 = 0.f;
  for (int c = tid; c < n; c += kThreads) z0 += expf(xs[c] - m0);
  z0 = block_sum(z0, sh);
  if (tid == 0) sh.psum = z0;

  const bool use_k = sample && top_k > 0 && top_k < V;
  const bool use_p = sample && top_p < 1.f;
  if (sample)
    for (int c = tid; c < n; c += kThreads) xs[c] = xs[c] / temperature;

  // top-k: the k-th largest key, 8 bits a round
  uint32_t kpfx = 0;
  float cutoff = kNegInf;
  if (use_k) {
    __syncthreads();
    unsigned long long krem = (unsigned long long)top_k;
    for (int rd = 0; rd < 4; ++rd) {
      const int shift = 24 - 8 * rd;
      for (int it = 0; it < iters; ++it) {
        const int c = tid + it * kThreads;
        int bin = kBins;
        if (c < n) {
          const uint32_t k = sort_key(xs[c]);
          if (rd == 0 || (k >> (shift + 8)) == kpfx) bin = (k >> shift) & 255;
        }
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin < kBins && lane == __ffs(peers) - 1)
          atomicAdd(&sh.count[rd][bin], (uint32_t)__popc(peers));
      }
      cluster.sync();
      const int d = kBins - 1 - tid;
      unsigned long long tot = 0;
      if (tid < kBins)
        for (int q = 0; q < kCluster; ++q)
          tot += *cluster.map_shared_rank(&sh.count[rd][d], q);
      const unsigned long long incl = bins_scan(tid < kBins ? tot : 0, sh);
      // the bins >= d hold at least krem keys for d <= d*
      const int dstar =
          __syncthreads_count(tid < kBins && incl >= krem) - 1;
      if (tid < kBins && d == dstar) sh.pick = incl - tot;
      __syncthreads();
      krem -= sh.pick;
      kpfx = (kpfx << 8) | (uint32_t)dstar;
      __syncthreads();  // sh.pick is rewritten next round
    }
    cutoff = key_value(kpfx);
  } else if (sample) {
    cluster.sync();  // the sums of step 2
  }
  if (!sample) cluster.sync();
  float zs = 0.f;
  for (int q = 0; q < kCluster; ++q)
    zs += *cluster.map_shared_rank(&sh.psum, q);
  const float lse = m0 + logf(zs);

  int tok = best.i;
  if (sample) {
    // top-p over the candidates (the top-k survivors): the smallest key t
    // with mass(keys > t) < p z, masses as integers of 2^-40
    const float mx = m0 / temperature;  // the largest x, always kept
    uint32_t hi = 0;
    if (use_p && !(top_p > 0.f)) {
      hi = sort_key(mx);  // nothing has mass < 0: keep the max
    } else if (use_p) {
      unsigned long long above = 0;
      double thr = 0.0;
      for (int rd = 0; rd < 4; ++rd) {
        const int shift = 24 - 8 * rd;
        for (int c = tid; c < n; c += kThreads) {
          const float x = xs[c];
          if (use_k && x < cutoff) continue;
          const uint32_t k = sort_key(x);
          if (rd > 0 && (k >> (shift + 8)) != hi) continue;
          const unsigned long long m =
              (unsigned long long)(expf(x - mx) * kMassScale);
          if (m) atomicAdd(&sh.mass[rd][(k >> shift) & 255], m);
        }
        cluster.sync();
        const int d = kBins - 1 - tid;
        unsigned long long tot = 0;
        if (tid < kBins)
          for (int q = 0; q < kCluster; ++q)
            tot += *cluster.map_shared_rank(&sh.mass[rd][d], q);
        const unsigned long long incl = bins_scan(tid < kBins ? tot : 0, sh);
        if (rd == 0) {
          if (tid == kBins - 1) sh.total = incl;  // z: every candidate
          __syncthreads();
          thr = (double)top_p * (double)sh.total;
        }
        const unsigned long long excl = incl - tot;
        // mass above bin d's keys is < p z for d >= d*
        const bool ok = tid < kBins && (double)(above + excl) < thr;
        const int dstar = kBins - __syncthreads_count(ok);
        if (tid < kBins && d == dstar) sh.pick = excl;
        __syncthreads();
        above += sh.pick;
        hi = (hi << 8) | (uint32_t)dstar;
        __syncthreads();
      }
    }
    // Gumbel-max over the filtered row, first occurrence on ties
    ArgMax g{-INFINITY, V};
    for (int c = tid; c < n; c += kThreads) {
      float x = xs[c];
      if (use_k && x < cutoff) x = kNegInf;
      if (use_p && sort_key(x) < hi) x = kNegInf;
      g = better(g, {x + gs[c], lo + c});
    }
    g = block_argmax(g, sh);
    if (tid == 0) {
      sh.pgval = g.v;
      sh.pgidx = g.i;
    }
    cluster.sync();
    g = {-INFINITY, V};
    for (int q = 0; q < kCluster; ++q)
      g = better(g, {*cluster.map_shared_rank(&sh.pgval, q),
                     *cluster.map_shared_rank(&sh.pgidx, q)});
    tok = g.i;
  }
  if (rank == 0 && tid == 0) {
    tok_out[row] = tok;
    lp_out[row] = (tok < n_valid ? lrow[tok] : kNegInf) - lse;
  }
  cluster.sync();  // no block leaves while another reads its partials
}

}  // namespace

// logits, gumbel (B, V) f32 -> tok (B,) int32, lp (B,) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_sample_bv_launch(const void* logits, const void* gumbel,
                                      void* tok, void* lp, int B, int V,
                                      float temperature, int top_k,
                                      float top_p, int vocab_size,
                                      void* stream) {
  if (B == 0) return 0;
  if (V < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  // a multiple of 4 entries a block: 16-byte aligned slices
  const int per = ((V + kCluster - 1) / kCluster + 3) / 4 * 4;
  const size_t smem = 2 * sizeof(float) * (size_t)per;
  cudaError_t e = cudaFuncSetAttribute(
      fused_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fused_sample_kernel,
                         static_cast<const float*>(logits),
                         static_cast<const float*>(gumbel),
                         static_cast<int*>(tok), static_cast<float*>(lp), V,
                         per, temperature, top_k, top_p, vocab_size);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
