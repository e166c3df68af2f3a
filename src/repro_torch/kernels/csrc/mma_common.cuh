// Tensor-core building blocks: asynchronous and element-wise 16-byte
// copies into swizzled shared-memory tiles, ldmatrix and the warp-level
// mma.sync.m16n8k16 product with bf16 inputs and f32 sums (moe_gmm.cu,
// ssd_scan.cu), bf16 packing of f32 pairs, and the 3xTF32 product
// (mma.sync.m16n8k8 with f32 operands as TF32 hi/lo pairs) of the SSD
// scan's f32 kernels (ssd_scan.cu, ssd_scan_bwd.cu).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4), each
// register holding two adjacent bf16 (or two f32 for C):
//   A (16 x 16, row-major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same),
//                           a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same)
//   B (16 x 8, k x n):      b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9; col g)
//   C (16 x 8, f32):        c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// so a C tile of two neighbouring n-tiles, rounded to bf16, is the A
// fragment of the next product without a trip through shared memory
// (wgmma's accumulators and register A operand keep the same layout in each
// warp: see wgmma_common.cuh).
//
// Shared-memory tiles hold rows of 16-byte chunks (8 bf16), `pitch` chunks a
// row with pitch a multiple of 8, chunk c of row r stored at chunk
// c ^ (r % 8): the eight row addresses of one ldmatrix 8 x 8 matrix then
// fall in eight different 16-byte bank groups.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of chunk c of row r in a swizzled tile of `pitch` chunks a row
__device__ __forceinline__ uint32_t swz(int r, int c, int pitch) {
  return (uint32_t)(r * pitch + (c ^ (r & 7))) * 16u;
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !pred (src is
// then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// four 8 x 8 b16 matrices, each transposed; lanes 8i .. 8i+7 give the row
// addresses of matrix i, register i receives it
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// four 8 x 8 b16 matrices as stored; lanes 8i .. 8i+7 give the row
// addresses of matrix i, register i receives it
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// two matrices from the addresses of lanes 0-15
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr)
      : "memory");
}

// c += a b on the tensor cores, bf16 inputs, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two f32 of a packed bf16 pair (lo half first)
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// f32 pair (a, b) as two bf16 pairs hi + lo, hi the rounding of (a, b) and
// lo the rounding of what hi leaves: a ~ bf16_lo(hi) + bf16_lo(lo) to 16
// significant bits, so one product with an exact bf16 operand becomes two
// mma.sync products with an error of ~2^-17 of each term
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - bf16_lo(hi), b - bf16_hi(hi));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// 8 bf16 of a row, element i valid where i < n (the rest zero), packed for
// st_shared16: the staging path for rows that are not 16-byte aligned
__device__ __forceinline__ void load8_scalar(uint32_t (&v)[4],
                                             const __nv_bfloat16* src, int n) {
  unsigned short h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h[i] = i < n ? __bfloat16_as_ushort(src[i]) : (unsigned short)0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = (uint32_t)h[2 * i] | ((uint32_t)h[2 * i + 1] << 16);
}

// One 16-byte chunk of a tile: by cp.async where `vec` (rows 16-byte
// aligned, whole chunks), else element by element with the first n valid;
// zeros where !in (src is then not read).
__device__ __forceinline__ void stage16(uint32_t dst,
                                        const __nv_bfloat16* src, bool in,
                                        int n, bool vec) {
  if (vec) {
    cp_async16(dst, src, in);
  } else {
    uint32_t v[4];
    load8_scalar(v, src, in ? min(8, n) : 0);
    st_shared16(dst, v);
  }
}

// TF32 operands of mma.m16n8k8: each f32 operand as hi + lo, hi the TF32
// rounding and lo that of what hi leaves (22 significant bits together);
// a product a b is a_lo b_hi + a_hi b_lo + a_hi b_hi (the small terms
// first), ~2^-21 of |a b|, as close as f32 FMAs summed in another order.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(a));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(a - __uint_as_float(hi)));
}

struct Tf32 {  // a fragment as hi and lo parts
  uint32_t h, l;
};

__device__ __forceinline__ Tf32 tf32(float a) {
  Tf32 v;
  split_tf32(a, v.h, v.l);
  return v;
}

// The same pair in two integer operations and a subtraction, for kernels
// whose issue slots bound them: hi is a rounded to TF32 half away from
// zero (0x1000 added, the low 13 bits cleared), lo = a - hi is
// passed whole, and mma.sync reads a .tf32 operand's top 19 bits, so lo is
// truncated to TF32 (the "big + small" split of CUTLASS's fast 3xTF32):
// a product keeps ~2^-20 of |a b| (the rounded split of tf32(), ~2^-21).
__device__ __forceinline__ Tf32 tf32_fast(float a) {
  Tf32 v;
  v.h = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  v.l = __float_as_uint(a - __uint_as_float(v.h));
  return v;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: A (16 x 8) as a[4], B (8 x 8) as b[2]
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Tf32 (&a)[4],
                                           const Tf32 (&b)[2]) {
  mma_tf32(c, a[0].l, a[1].l, a[2].l, a[3].l, b[0].h, b[1].h);
  mma_tf32(c, a[0].h, a[1].h, a[2].h, a[3].h, b[0].l, b[1].l);
  mma_tf32(c, a[0].h, a[1].h, a[2].h, a[3].h, b[0].h, b[1].h);
}

}  // namespace mma
