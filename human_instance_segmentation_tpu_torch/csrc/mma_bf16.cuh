// bf16 tensor-core fragments for the hand-written kernels (tail.cu,
// mbconv.cu): ldmatrix loads from shared memory and mma.sync m16n8k16 with
// float32 accumulators; and a staging loop that keeps several global loads
// in flight.
//
// Operands lie in shared memory as rows of bf16 with the contraction index
// fastest: A as [m][k] (one row per pixel), B as [n][k] (one row per output
// channel), so the non-transposed ldmatrix gives both fragments. Each row
// address handed to ldmatrix must be 16-byte aligned; eight rows whose
// starts are an odd multiple of 16 bytes apart fall into eight different
// 16-byte bank groups and load without a conflict.
//
// Fragment layout (PTX ISA, mma.m16n8k16 .bf16): lane = 4 g + t holds
//   A: a0 = (row g, k 2t..2t+1), a1 = (row g+8, k 2t..), a2 = (row g, k
//      2t+8..), a3 = (row g+8, k 2t+8..);
//   B: b0 = (k 2t..2t+1, column g), b1 = (k 2t+8.., column g);
//   C: c0, c1 = (row g, columns 2t, 2t+1), c2, c3 = (row g+8, same columns).
// ldmatrix .x4 with lane L addressing row L % 8 of matrix L / 8 returns the
// four matrices in r0..r3; for A, matrix q covers rows 8 (q & 1) ..., k
// 8 (q >> 1) ..., which makes r0..r3 = a0..a3.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// HIST_SKIP switches parts of the hand-written kernels off, for
// scripts/profile_torch_kernels.py only (every served build has 0): bits 1-16
// the tail's source loads, upsample, conv0, conv1 and head products; bits
// 32-512 the MBConv's input loads, expand product, depthwise taps, project
// product and SiLUs; bits 1024-65536 the int8 tail's (csrc/tail_q.cu) input
// staging, conv0, conv1 and head products, float border, requantizing
// epilogues, and the epilogues' wait for the products.
#ifndef HIST_SKIP
#define HIST_SKIP 0
#endif

namespace hist_mma {

__host__ __device__ constexpr bool skip(int bit) { return (HIST_SKIP & bit) != 0; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one 32-bit word of two bf16, round to nearest even, lo first
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// for i = threadIdx.x, + nthreads, ... < n: store(i, load(i)), with B loads
// of a thread in flight before its first store (a plain loop waits out each
// global load's latency before the next)
template <int B, typename Load, typename Store>
__device__ __forceinline__ void batched_copy(int n, int nthreads, Load load, Store store) {
  for (int base = threadIdx.x; base < n; base += B * nthreads) {
    decltype(load(0)) v[B];
#pragma unroll
    for (int k = 0; k < B; ++k)
      if (base + k * nthreads < n) v[k] = load(base + k * nthreads);
#pragma unroll
    for (int k = 0; k < B; ++k)
      if (base + k * nthreads < n) store(base + k * nthreads, v[k]);
  }
}

// one 32-bit word of two bf16 -> two floats (exact)
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

}  // namespace hist_mma
