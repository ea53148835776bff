// Inline-PTX building blocks of the bf16 attention kernels (sm_80 and up;
// built here for sm_90a): 16-byte asynchronous copies into shared memory,
// ldmatrix fragment loads, the m16n8k16 bf16 tensor-core product with
// f32 accumulators, and the SFU's exp2. Fragment layouts, for lane l of a warp, g = l / 4 and
// c = 2 (l % 4):
//
//   A (16 x 16, row-major)  a0: (g, c..c+1)   a1: (g+8, c..c+1)
//                           a2: (g, c+8..c+9) a3: (g+8, c+8..c+9)
//   B (16 x 8, k x n)       b0: (k c..c+1, n g)  b1: (k c+8..c+9, n g)
//   C (16 x 8, f32)         c0, c1: (g, c..c+1)  c2, c3: (g+8, c..c+1)
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices whose rows lanes 0-7, 8-15,
// 16-23 and 24-31 address; lane l receives (row g, columns c..c+1) of
// each, or with .trans (rows c..c+1, column g).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; with full false
// nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b on the tensor cores, 16 x 8 x 16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU alone; results below 2^-126 flush to 0 (a softmax
// weight that small adds nothing next to the row's max, which is 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> bf16 pairs hi and lo with hi + lo = (x, y) to about 16 bits:
// x in the low half. P rounded to bf16 alone carries 2^-9 relative error
// a weight, which moves an output near 0 past the bf16 check's
// 1e-3 + 8e-3 |out| (tests/test_torch_flash_attention.py emulates it);
// hi + lo as two products keeps it near f32's.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 back = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - back.x, y - back.y));
}

}  // namespace mma_bf16

// ---- Hopper's warpgroup products (sm_90a) --------------------------------
//
// wgmma.mma_async: a warpgroup of 4 warps multiplies a 64-row A (here
// from registers, each warp's 16 rows in the m16n8k16 A layout above)
// by a B tile that it reads from shared memory through a descriptor. The
// 64 x N f32 accumulator is spread as in m16n8k16's C, warp w holding rows
// 16 w .. 16 w + 15: d[j][0..1] at (g, 8 j + c..c+1), d[j][2..3] at row
// g + 8. B tiles use the 128-byte swizzle: 128-byte rows, 8-row atoms of
// 1024 bytes (1024-aligned), 16-byte chunk k of row r stored at chunk
// k ^ (r % 8).
namespace wgmma {

// the smem offset of 16-byte chunk `chunk` of 128-byte row `row`
__device__ __forceinline__ uint32_t swizzle128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row % 8)) << 4);
}

// a descriptor of a 128-byte-swizzled tile at `addr` (1024-aligned, or
// advanced within a row by whole 16-byte chunks): both strides 1024 bytes
// (8-row atoms), which is the only stride these tiles step over
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(64) << 16) |
         (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// order the async proxy's reads after this thread's cp.async writes
__device__ __forceinline__ void fence_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accesses of d across a fence or a wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    asm volatile("" : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])::"memory");
}

// d (+)= a b, 64 x 64 x 16: scale_d 0 overwrites d; kTransB 1 reads B
// stored k-rows-major (n contiguous), 0 n-rows-major (k contiguous)
template <int kTransB>
__device__ __forceinline__ void m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
}

}  // namespace wgmma
