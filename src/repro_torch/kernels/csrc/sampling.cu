// Fused sampling kernel for Hopper (sm_90a), written in CUDA C++.
//
// Replaces the Pallas TPU kernel `_sampling_kernel` / `fused_sample_bv` in
// src/repro/kernels/sampling.py: padded-vocab mask; behaviour logprob
// under the unfiltered temperature-1 row; greedy first-occurrence argmax,
// or temperature, exact top-k by k max-peels, top-p by a 33-step
// bisection on order-preserving uint32 keys, and Gumbel-max with the
// noise passed in.
//
// Design.  Grid (B,): one 1024-thread block per row.  Every step is a
// block reduction (max, sum, first-occurrence argmax, count) with no
// tensor-core work.  The TPU kernel keeps the whole row in VMEM; an f32
// row at yi-9b's padded vocab (65536) is 256 KB, more than the 227 KB of
// shared memory a block may have, so here every pass streams the row from
// global memory (after the first pass, from L2) with 16-byte loads and
// recomputes the tempered, filtered value of each element on the fly;
// nothing is written back.  A top-k peel is an argmax over the elements
// that come after the previous peel in (value descending, index
// ascending) order, so duplicates are peeled once per occurrence, as
// lax.top_k counts them.
//
// Bound on this card: bytes (logits and noise read once, 8 bytes per
// vocab entry).  This first version makes 2 + top_k + 2 + 33 + 1 passes
// over the row with top-k and top-p on, so it is far from that bound;
// keeping the row in a cluster's distributed shared memory, or selecting
// the top-k candidates in one pass, are the known next steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread
constexpr float kNegInf = -1e30f;

struct ArgMax {
  float v;
  int i;
};

// larger value wins; on a tie the smaller index (first occurrence)
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinU {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a < b ? a : b;
  }
};
struct MaxU {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const {
    return a > b ? a : b;
  }
};

// Reduce one 4-byte value over the block; every thread gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T x, Op op, T* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = scratch[lane];  // kWarps == 32
    for (int o = 16; o > 0; o >>= 1)
      x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) scratch[0] = x;
  }
  __syncthreads();
  x = scratch[0];
  __syncthreads();  // scratch is reused by the next reduction
  return x;
}

__device__ ArgMax block_argmax(ArgMax x, float* sv, int* si) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax y{__shfl_xor_sync(0xffffffffu, x.v, o),
             __shfl_xor_sync(0xffffffffu, x.i, o)};
    x = better(x, y);
  }
  if (lane == 0) {
    sv[warp] = x.v;
    si[warp] = x.i;
  }
  __syncthreads();
  if (warp == 0) {
    x = ArgMax{sv[lane], si[lane]};
    for (int o = 16; o > 0; o >>= 1) {
      ArgMax y{__shfl_xor_sync(0xffffffffu, x.v, o),
               __shfl_xor_sync(0xffffffffu, x.i, o)};
      x = better(x, y);
    }
    if (lane == 0) {
      sv[0] = x.v;
      si[0] = x.i;
    }
  }
  __syncthreads();
  x = ArgMax{sv[0], si[0]};
  __syncthreads();
  return x;
}

// Order-preserving map float32 -> uint32: a < b  <=>  key(a) < key(b).
__device__ __forceinline__ uint32_t sort_key(float x) {
  const uint32_t bits = __float_as_uint(x);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

// Call f(x, g, i) for every vocab index i of the row, where x is the
// logit masked to -1e30 at or past n_valid and g the noise (0 when `noise`
// is null).  Neighbouring threads read neighbouring 16-byte chunks, and a
// thread issues kUnroll chunks before it uses any, so it waits on memory
// once per kUnroll chunks, not once per element.
template <typename F>
__device__ __forceinline__ void scan_row(const float* __restrict__ row,
                                         const float* __restrict__ noise,
                                         int V, int n_valid, F f) {
  const bool vec =
      V % 4 == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(noise) & 15) == 0;
  if (!vec) {
    for (int i = threadIdx.x; i < V; i += kThreads)
      f(i < n_valid ? row[i] : kNegInf, noise ? noise[i] : 0.f, i);
    return;
  }
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* n4p = reinterpret_cast<const float4*>(noise);
  const int n4 = V / 4;
  for (int c0 = threadIdx.x; c0 < n4; c0 += kThreads * kUnroll) {
    float4 x[kUnroll], g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      if (c < n4) {
        x[u] = r4[c];
        g[u] = noise ? n4p[c] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = 4 * (c0 + u * kThreads);
      if (i < V) {
        f(i < n_valid ? x[u].x : kNegInf, g[u].x, i);
        f(i + 1 < n_valid ? x[u].y : kNegInf, g[u].y, i + 1);
        f(i + 2 < n_valid ? x[u].z : kNegInf, g[u].z, i + 2);
        f(i + 3 < n_valid ? x[u].w : kNegInf, g[u].w, i + 3);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) fused_sample_kernel(
    const float* __restrict__ logits,  // (B, V)
    const float* __restrict__ gumbel,  // (B, V)
    int* __restrict__ tok_out,         // (B,)
    float* __restrict__ lp_out,        // (B,)
    int V, float temperature, int top_k, float top_p, int vocab_size) {
  __shared__ float sf[kWarps];
  __shared__ int si[kWarps];
  __shared__ uint32_t su[kWarps];

  const float* row = logits + (size_t)blockIdx.x * V;
  const float* noise = gumbel + (size_t)blockIdx.x * V;
  const int n_valid = (vocab_size > 0 && vocab_size < V) ? vocab_size : V;

  // pass 1: row max (and first argmax, the greedy token)
  ArgMax best{-INFINITY, V};
  scan_row(row, nullptr, V, n_valid,
           [&](float x, float, int i) { best = better(best, {x, i}); });
  best = block_argmax(best, sf, si);
  const float m0 = best.v;
  // pass 2: log-sum-exp of the unfiltered temperature-1 row
  float z0 = 0.f;
  scan_row(row, nullptr, V, n_valid,
           [&](float x, float, int) { z0 += expf(x - m0); });
  z0 = block_reduce(z0, Sum(), sf);
  const float lse = m0 + logf(z0);

  int tok = best.i;
  if (temperature > 0.f) {
    // exact top-k: peel the max k times, in (value desc, index asc) order
    const bool use_k = top_k > 0 && top_k < V;
    float cutoff = kNegInf;
    if (use_k) {
      ArgMax prev{INFINITY, -1};
      for (int p = 0; p < top_k; ++p) {
        ArgMax cur{-INFINITY, V};
        scan_row(row, nullptr, V, n_valid, [&](float r, float, int i) {
          const float x = r / temperature;
          if (x < prev.v || (x == prev.v && i > prev.i))
            cur = better(cur, {x, i});
        });
        prev = block_argmax(cur, sf, si);
      }
      cutoff = prev.v;
    }
    auto filtered = [&](float r) {
      const float x = r / temperature;
      return (use_k && x < cutoff) ? kNegInf : x;
    };
    // nucleus: bisect the key space for the smallest value whose
    // strictly-greater mass is < p; the cutoff token is always kept
    const bool use_p = top_p < 1.f;
    uint32_t hi = 0;
    if (use_p) {
      float mx = -INFINITY;
      uint32_t kmin = 0xffffffffu, kmax = 0;
      scan_row(row, nullptr, V, n_valid, [&](float r, float, int) {
        const float x = filtered(r);
        const uint32_t k = sort_key(x);
        mx = fmaxf(mx, x);
        kmin = min(kmin, k);
        kmax = max(kmax, k);
      });
      mx = block_reduce(mx, Max(), sf);
      kmin = block_reduce(kmin, MinU(), su);
      kmax = block_reduce(kmax, MaxU(), su);
      float z = 0.f;
      scan_row(row, nullptr, V, n_valid,
               [&](float r, float, int) { z += expf(filtered(r) - mx); });
      z = block_reduce(z, Sum(), sf);
      uint32_t lo = kmin - 1u;  // H(lo) = 1 >= p
      hi = kmax;                // H(hi) = 0 <  p
      for (int it = 0; it < 33; ++it) {
        const uint32_t mid = lo + (hi - lo) / 2u;
        float above = 0.f;
        scan_row(row, nullptr, V, n_valid, [&](float r, float, int) {
          const float x = filtered(r);
          if (sort_key(x) > mid) above += expf(x - mx);
        });
        above = block_reduce(above, Sum(), sf) / z;
        const bool keep = above >= top_p;
        lo = keep ? mid : lo;
        hi = keep ? hi : mid;
      }
    }
    // Gumbel-max over the filtered row, first occurrence on ties
    ArgMax g{-INFINITY, V};
    scan_row(row, noise, V, n_valid, [&](float r, float gn, int i) {
      float x = filtered(r);
      if (use_p && sort_key(x) < hi) x = kNegInf;
      g = better(g, {x + gn, i});
    });
    tok = block_argmax(g, sf, si).i;
  }
  if (threadIdx.x == 0) {
    tok_out[blockIdx.x] = tok;
    lp_out[blockIdx.x] = (tok < n_valid ? row[tok] : kNegInf) - lse;
  }
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
  fused_sample_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(gumbel),
      static_cast<int*>(tok), static_cast<float*>(lp), V, temperature, top_k,
      top_p, vocab_size);
  return cudaGetLastError();
}
