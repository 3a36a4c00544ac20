// Fused SAME conv (k in {1,3}) + bias -> LayerNorm2d over the whole ROI
// -> per-channel affine -> optional residual -> ReLU, NHWC, for Hopper.
//
// Replaces the JAX package's Pallas kernel
// human_instance_segmentation_tpu/ops/pallas_head.py::conv_ln_act
// (_conv_ln_act :195, kernel body _kernel :90-151). The TPU kernel keeps one
// ROI in VMEM and normalises it in one grid step. Here a block cannot own a
// whole ROI's conv (192 pixels x 384 channels x 3456-deep contraction at the
// served shape), and LayerNorm2d's statistics span all of H*W*C of the ROI,
// so the work is split in two launches:
//
//  (a) conv, an implicit GEMM into a float32 scratch buffer (N, P, Co) that
//      the wrapper allocates, conv + bias:
//      - bf16 with Ci and Co multiples of 8 and 16-byte aligned pixel rows
//        (the served shapes): conv_bf16_wgmma_kernel, wgmma.mma_async
//        m64nBNk16 bf16 x bf16 -> f32 on the s8 core's tiles (csrc/
//        s8_igemm.cuh, wide regime): the pixels of all ROIs numbered across
//        the batch (6,144 at the served shape: a 16x12 ROI fills no tile),
//        A and B K-major in the 128-byte swizzle, K walked in 16-byte chunks
//        (8 channels) of the flattened (tap, channel) index, each chunk a
//        zero-filling cp.async from the shifted pixel, a ring of three
//        stages, the tile (64 or 128 pixels x 64, 96 or 128 channels) picked
//        per launch so the 132 SMs fill (pick_wide_tile: 64 x 96 at the served
//        shape). A bf16 k16 step is
//        32 bytes like an s8 k32 step, so the tile layouts are the s8 core's
//        byte for byte. The weights come packed K-major once per weight by the
//        wrapper (ops/cuda_head.py::prepare_bf16).
//      - bf16 of any other shape (ragged channels, unaligned rows):
//        conv_bf16_kernel, WMMA 16x16x16 from scalar-staged slices.
//      - float32: conv_f32_kernel, FMAs (no TF32, so f32 stays f32).
//  (b) norm (ln_act_kernel): a cluster of LN_CLUSTER blocks per ROI, each
//      owning a fixed 1/LN_CLUSTER of the ROI's values. Mean in one pass,
//      then the biased variance of the float32 differences in a second (as
//      pallas_head.py:143-144 does; not E[x^2] - E[x]^2, which loses digits
//      over 73,728 values), then affine, residual, ReLU and the cast to the
//      output dtype. The two sums run in float64 and round to float32 once.
//      Their order is fixed, so a run repeats itself bit for bit: each thread
//      sums its values in index order, a block reduces its threads by a fixed
//      shuffle tree and its warps in warp order, and each block of the
//      cluster adds the blocks' partial sums in rank order, read through
//      distributed shared memory. The plain version (ops/cuda_head.py) sums
//      in float64 too, in its own order; float64 holds the 73,728-term sum
//      to far below a float32 ulp, so the rounded mean and variance agree.
//      Every float32 step after them is one correctly rounded op (__fsub_rn,
//      __fmul_rn, __fadd_rn; rstd = 1 / sqrt(var + eps) in float64), so the
//      kernel and its plain version agree bit for bit whenever the conv stage
//      does (the int8 form's integer conv does). In int8 serving a one-ulp
//      difference here would move later quantizers by whole codes.
//
// Bound: at the served shape (32 ROIs x 16x12 pixels x 384 -> 384, k=3) the
// conv costs 2*192*384*384*9 = 0.51 GFLOP per ROI, 16.3 GFLOP per call and
// five calls per forward: 0.0165 ms at the bf16 peak. What holds the wgmma
// conv is the ring: 54 steps of 128 bytes of K a tile, each behind two
// barriers and a cp.async wait (0.42 GB of operand rows from L2 per call;
// larger tiles that move half of that were no faster). The norm pass reads
// 9.4 MB of scratch once (each block keeps its share in shared memory) on
// 256 blocks.
//
// The int8 form (conv_ln_act(xscale=...), pallas_head.py:178-187 and the
// quantized branch of _kernel :103-106, :140-141) swaps stage (a) for the
// wide (wgmma) kernel of s8_igemm.cuh: x is quantized once, into the
// staging buffer xq_ws, as round(x * inv) with inv = float32(1 / xscale)
// (__fmul_rn, rintf, clip +-127); the weights arrive quantized per output
// channel and packed K-major from the wrapper, which makes them once per
// weight and scale (ops/cuda_head.py::prepare_s8); the tensor cores
// accumulate s8 x s8 in int32, and the epilogue writes float(acc) *
// qscale[co] + b[co] (qscale = xscale * sw, each step rounded once, as
// JAX's acc.astype(f32) * qscale + b) from the accumulator registers into
// the same float32 scratch. Stage (b) is the same.
//
// Every launcher returns cudaGetLastError(); the Python wrapper raises on a
// non-zero value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <mma.h>

#include <cstdint>

#include "s8_igemm.cuh"

using namespace nvcuda;

// The s8 conv core's entry point (csrc/qconv.cu on csrc/s8_igemm.cuh).
extern "C" int s8_conv_launch(const void* x, long long sn, long long sc, long long sh,
                              long long sw, int in_dtype, const void* wp, const void* qparam,
                              int qmode, const void* scale, const void* bias, void* out,
                              int out_dtype, void* xq_ws, int N, int H, int W, int Ci, int Co,
                              int k, int pad, void* stream_ptr);

namespace {

constexpr int BM = 64;  // pixels per block tile
constexpr int BN = 64;  // output channels per block tile
constexpr int BK = 32;  // input channels per contraction step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Pixel coordinates of the block's BM rows (-1e6 marks a row past P, so
// every tap of it falls outside the image and loads zero).
__device__ __forceinline__ void tile_rows(int* rowy, int* rowx, int p0, int P, int W) {
  for (int m = threadIdx.x; m < BM; m += blockDim.x) {
    const int p = p0 + m;
    rowy[m] = p < P ? p / W : -1000000;
    rowx[m] = p < P ? p % W : 0;
  }
}

// ---- (a) bf16, any channel counts: scalar staging, 4 warps of 32x32 ----

__global__ void __launch_bounds__(128)
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int H, int W, int Ci, int Co, int k) {
  const int P = H * W;
  const int p0 = blockIdx.x * BM, co0 = blockIdx.y * BN, n = blockIdx.z;
  __shared__ __align__(32) __nv_bfloat16 As[BM][BK + 8];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK][BN + 8];
  __shared__ __align__(32) float Cs[BM][BN + 4];
  __shared__ int rowy[BM], rowx[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  tile_rows(rowy, rowx, p0, P, W);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const __nv_bfloat16* xn = x + (size_t)n * P * Ci;
  const int half = k / 2;
  __syncthreads();

  for (int tap = 0; tap < k * k; ++tap) {
    const int dy = tap / k - half, dx = tap % k - half;
    const __nv_bfloat16* wt = w + (size_t)tap * Ci * Co;
    for (int c0 = 0; c0 < Ci; c0 += BK) {
      for (int e = tid; e < BM * BK; e += 128) {
        const int m = e / BK, kk = e % BK, c = c0 + kk;
        const int py = rowy[m] + dy, px = rowx[m] + dx;
        __nv_bfloat16 v = zero;
        if (c < Ci && py >= 0 && py < H && px >= 0 && px < W)
          v = xn[((size_t)py * W + px) * Ci + c];
        As[m][kk] = v;
      }
      for (int e = tid; e < BK * BN; e += 128) {
        const int kk = e / BN, nn = e % BN, c = c0 + kk, co = co0 + nn;
        Bs[kk][nn] = (c < Ci && co < Co) ? wt[(size_t)c * Co + co] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], BK + 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], BN + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j], BN + 4,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += 128) {
    const int m = e / BN, nn = e % BN, p = p0 + m, co = co0 + nn;
    if (p < P && co < Co) out[((size_t)n * P + p) * Co + co] = Cs[m][nn] + bias[co];
  }
}

// ---- (a) bf16, Ci % 8 == 0 and Co % 8 == 0, aligned rows: wgmma ---------

// d (64 x BN float32, BN / 2 registers a thread) += A (64 x 16 bf16) * B (BN x 16 bf16)^T
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
      "}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(1));
}

// x: (N, H, W, Ci) bf16 contiguous, 16-byte aligned, Ci % 8 == 0. wp: Co rows
// of Kp bytes, K = tap * Ci + c, zero past k*k*Ci. out: (N*H*W, Co) float32,
// conv + bias. The ring, its loads and its barriers are the s8 core's
// wide_kernel's (s8_igemm.cuh), with 16-byte chunks of 8 channels.
template <int BN, int WGS>
__global__ void __launch_bounds__(128 * WGS)
conv_bf16_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                       int Kp, const float* __restrict__ bias, float* __restrict__ out, int N,
                       int H, int W, int Ci, int Co, int k) {
  using namespace s8igemm;
  constexpr int BM = 64 * WGS, T = 128 * WGS;
  constexpr int A_BYTES = BM * STEP_BYTES, STAGE_BYTES = (BM + BN) * STEP_BYTES;
  constexpr int ROWS_PER_PASS = T / 8, A_PASSES = BM / ROWS_PER_PASS, B_PASSES = BN / ROWS_PER_PASS;
  static_assert(BN % ROWS_PER_PASS == 0, "B rows divide over the threads");
  extern __shared__ __align__(16) uint8_t bf16_wide_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<std::uintptr_t>(bf16_wide_smem) + 1023) & ~static_cast<std::uintptr_t>(1023));
  float* s_bias = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);

  const int tid = threadIdx.x;
  const int pad = k / 2;
  const long long M = (long long)N * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  for (int i = tid; i < BN; i += T) s_bias[i] = co0 + i < Co ? bias[co0 + i] : 0.0f;
  const int cpc = Ci / 8;      // 16-byte chunks of a pixel
  const int KT = k * k * cpc;  // 16-byte chunks of K that hold data
  const int steps = (KT + 7) / 8;
  const char* xb = reinterpret_cast<const char*>(x);
  const char* wb = reinterpret_cast<const char*>(wp);
  const long long sW = 2LL * Ci, sH = sW * W, sN = sH * H;  // bytes

  const int cj = tid & 7, r0 = tid >> 3;
  const int sw_col = (cj ^ (r0 & 7)) << 4;
  long long base[A_PASSES];
  int iy0[A_PASSES], ix0[A_PASSES];
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) {
    const long long m = m0 + r0 + i * ROWS_PER_PASS;
    if (m < M) {  // M < 2^31 (checked by the launcher): 32-bit divisions
      const unsigned q = (unsigned)m / (unsigned)W, n = q / (unsigned)H;
      iy0[i] = (int)(q - n * H) - pad;
      ix0[i] = (int)((unsigned)m - q * W) - pad;
      base[i] = n * sN + iy0[i] * sH + ix0[i] * sW;
    } else {  // a row past M reads only zeros
      iy0[i] = -(1 << 28);
      ix0[i] = 0;
      base[i] = 0;
    }
  }

  auto load = [&](int step, int slot) {
    uint8_t* a_s = smem + slot * STAGE_BYTES;
    uint8_t* b_s = a_s + A_BYTES;
    const int j = step * 8 + cj;
    const int tap = j / cpc, cc = j - tap * cpc;
    const int ky = tap / k, kx = tap - ky * k;
    const bool kvalid = j < KT;
    const long long koff = ky * sH + kx * sW + cc * 16;
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      const int r = r0 + i * ROWS_PER_PASS;
      const int iy = iy0[i] + ky, ix = ix0[i] + kx;
      const bool ok = kvalid && iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp_async16(a_s + r * STEP_BYTES + sw_col, ok ? xb + base[i] + koff : xb, ok ? 16 : 0);
    }
    const char* wk = wb + (size_t)step * STEP_BYTES + cj * 16;
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i) {
      const int r = r0 + i * ROWS_PER_PASS;
      const bool ok = co0 + r < Co;
      cp_async16(b_s + r * STEP_BYTES + sw_col, ok ? wk + (size_t)(co0 + r) * Kp : wb, ok ? 16 : 0);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  const int wg = tid / 128;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step `it` have landed
    fence_async_proxy();
    __syncthreads();  // everyone's have
    const uint8_t* a_s = smem + (it % STAGES) * STAGE_BYTES;
    const uint64_t da = smem_desc(a_s + wg * 64 * STEP_BYTES), db = smem_desc(a_s + A_BYTES);
    const int nk = min(4, (KT - it * 8 + 1) / 2);  // 32-byte sub-steps that hold data
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < nk) wgmma_bf16<BN>(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's products of step it - 1 are done,
    __syncthreads();  // and everyone's: their stage can be refilled while step `it` multiplies
    if (it + STAGES - 1 < steps) load(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
  }
  wgmma_wait<0>();

  // accumulator layout as the s8 core's: warp w of the warpgroup holds rows
  // 16 w .. 16 w + 15; lane l holds, of each 8-column group j, columns 2 (l %
  // 4) and + 1 of rows l / 4 (registers 4 j, 4 j + 1) and l / 4 + 8 (4 j + 2, + 3)
  const int lane = tid & 31, warp = (tid >> 5) & 3, cl = 2 * (lane & 3);
  const long long row = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int co = co0 + 8 * j + cl;  // Co % 8 == 0: both channels exist or neither
    if (co >= Co) continue;
    const float b0 = s_bias[8 * j + cl], b1 = s_bias[8 * j + cl + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < M)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8 * h) * Co + co) =
            make_float2(__fadd_rn(acc[4 * j + 2 * h], b0), __fadd_rn(acc[4 * j + 2 * h + 1], b1));
  }
}

template <int BN, int WGS>
cudaError_t launch_wgmma_tile(const __nv_bfloat16* x, const __nv_bfloat16* wp, int Kp,
                              const float* bias, float* out, int N, int H, int W, int Ci, int Co,
                              int k, cudaStream_t stream) {
  constexpr int BM = 64 * WGS, SMEM = s8igemm::wide_smem_bytes(BM, BN);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(conv_bf16_wgmma_kernel<BN, WGS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long M = (long long)N * H * W;
  if (M >= (1ll << 31) - BM) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (Co + BN - 1) / BN);
  conv_bf16_wgmma_kernel<BN, WGS><<<grid, 128 * WGS, SMEM, stream>>>(x, wp, Kp, bias, out, N, H, W,
                                                                     Ci, Co, k);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* wp, int Kp,
                         const float* bias, float* out, int N, int H, int W, int Ci, int Co, int k,
                         cudaStream_t stream) {
  // the s8 core's tile rule: a bf16 step moves the bytes of an s8 step; a
  // larger tile, which moves fewer operand bytes, measured no faster
  // (scripts/profile_torch_kernels.py conv_tile)
  s8igemm::WideTile t = s8igemm::pick_wide_tile((long long)N * H * W, Co, k, Ci / 8);
#if defined(HIST_BF16_TILE) && HIST_BF16_TILE != 0  // profiling builds only: BN * 10 + warpgroups
  t = s8igemm::WideTile{HIST_BF16_TILE / 10, HIST_BF16_TILE % 10};
#endif
#define CONV_LN_TILE(BN_, WGS_)                                                                 \
  if (t.bn == BN_ && t.wgs == WGS_)                                                             \
    return launch_wgmma_tile<BN_, WGS_>(x, wp, Kp, bias, out, N, H, W, Ci, Co, k, stream);
  CONV_LN_TILE(64, 1) CONV_LN_TILE(96, 1) CONV_LN_TILE(128, 1)
  CONV_LN_TILE(64, 2) CONV_LN_TILE(96, 2) CONV_LN_TILE(128, 2)
#undef CONV_LN_TILE
  return cudaErrorInvalidValue;
}

// ---- (a) f32: FMA implicit GEMM, 16x16 threads of 4x4 outputs ----------

__global__ void __launch_bounds__(256)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out,
                int H, int W, int Ci, int Co, int k) {
  const int P = H * W;
  const int p0 = blockIdx.x * BM, co0 = blockIdx.y * BN, n = blockIdx.z;
  __shared__ float As[BK][BM + 4];  // [channel][pixel]
  __shared__ float Bs[BK][BN + 4];  // [channel][out channel]
  __shared__ int rowy[BM], rowx[BM];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  tile_rows(rowy, rowx, p0, P, W);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const float* xn = x + (size_t)n * P * Ci;
  const int half = k / 2;
  __syncthreads();

  for (int tap = 0; tap < k * k; ++tap) {
    const int dy = tap / k - half, dx = tap % k - half;
    const float* wt = w + (size_t)tap * Ci * Co;
    for (int c0 = 0; c0 < Ci; c0 += BK) {
      for (int e = tid; e < BM * BK; e += 256) {
        const int m = e / BK, kk = e % BK, c = c0 + kk;
        const int py = rowy[m] + dy, px = rowx[m] + dx;
        float v = 0.0f;
        if (c < Ci && py >= 0 && py < H && px >= 0 && px < W)
          v = xn[((size_t)py * W + px) * Ci + c];
        As[kk][m] = v;
      }
      for (int e = tid; e < BK * BN; e += 256) {
        const int kk = e / BN, nn = e % BN, c = c0 + kk, co = co0 + nn;
        Bs[kk][nn] = (c < Ci && co < Co) ? wt[(size_t)c * Co + co] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (p < P && co < Co) out[((size_t)n * P + p) * Co + co] = acc[i][j] + bias[co];
    }
  }
}

// ---- (b) LayerNorm2d over one ROI + affine + residual + ReLU -----------

constexpr int LN_CLUSTER = 8;  // blocks per ROI (the portable cluster size)
constexpr int LN_THREADS = 256;

// Sum over the block in a fixed order (each warp by a shuffle tree, then the
// warps in warp order); thread 0 gets the total.
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int i = 0; i < LN_THREADS / 32; ++i) total += red[i];
  __syncthreads();  // red is reused by the next call
  return total;
}

// The sum over the cluster of each block's slot (thread 0 of every block
// calls it after cluster.sync()), in rank order.
__device__ double cluster_total(cooperative_groups::cluster_group& cluster, double* slot) {
  double total = 0.0;
  for (unsigned r = 0; r < LN_CLUSTER; ++r) total += *cluster.map_shared_rank(slot, r);
  return total;
}

// grid (LN_CLUSTER, N), clusters of LN_CLUSTER blocks along x: block r of
// ROI y owns values [L r / LN_CLUSTER, L (r + 1) / LN_CLUSTER) of it. With
// `cache` the block keeps them in dynamic shared memory after the first pass
// (36 KB at the served shape), so the scratch buffer is read once.
template <typename T>
__global__ void __cluster_dims__(LN_CLUSTER, 1, 1) __launch_bounds__(LN_THREADS)
ln_act_kernel(const float* __restrict__ acc, const float* __restrict__ gamma,
              const float* __restrict__ beta, const T* __restrict__ res, T* __restrict__ out,
              int P, int Co, double eps, int relu, int cache) {
  extern __shared__ float ln_chunk[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  __shared__ double red[LN_THREADS / 32];
  __shared__ double part[2];  // this block's sum, then its sum of squares
  __shared__ float stat[2];   // mean, rstd
  const size_t L = (size_t)P * Co;
  const unsigned rank = cluster.block_rank();
  const size_t lo = L * rank / LN_CLUSTER, hi = L * (rank + 1) / LN_CLUSTER;
  const size_t base = (size_t)blockIdx.y * L;
  const float* a = acc + base;
  const float* v = cache ? ln_chunk - lo : a;  // where passes 2 and 3 read value i

  double s = 0.0;
  for (size_t i = lo + threadIdx.x; i < hi; i += LN_THREADS) {
    const float ai = a[i];
    if (cache) ln_chunk[i - lo] = ai;
    s += ai;
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) part[0] = s;
  cluster.sync();
  if (threadIdx.x == 0)
    stat[0] = __double2float_rn(__ddiv_rn(cluster_total(cluster, &part[0]), (double)L));
  __syncthreads();
  const float mean = stat[0];

  double q = 0.0;  // d * d is exact in float64
  for (size_t i = lo + threadIdx.x; i < hi; i += LN_THREADS) {
    const double d = __fsub_rn(v[i], mean);
    q += d * d;
  }
  q = block_sum(q, red);
  if (threadIdx.x == 0) part[1] = q;
  cluster.sync();
  if (threadIdx.x == 0) {
    const double var = __ddiv_rn(cluster_total(cluster, &part[1]), (double)L);
    stat[1] = __double2float_rn(__drcp_rn(__dsqrt_rn(__dadd_rn(var, eps))));
  }
  cluster.sync();  // every block has read the others' slots before any leaves; stat is out
  const float rstd = stat[1];

  for (size_t i = lo + threadIdx.x; i < hi; i += LN_THREADS) {
    const int co = (int)(i % Co);
    float y = __fmul_rn(__fsub_rn(v[i], mean), rstd);
    y = __fadd_rn(__fmul_rn(y, gamma[co]), beta[co]);
    if (res != nullptr) y = __fadd_rn(y, to_f(res[base + i]));
    if (relu) y = fmaxf(y, 0.0f);
    out[base + i] = from_f<T>(y);
  }
}

constexpr int LN_CACHE_MAX = 200 * 1024;  // bytes of a block's values kept in shared memory

template <typename T>
cudaError_t launch_ln_act_t(const float* acc, const float* g, const float* be, const void* res,
                            void* out, int N, int P, int Co, double eps, int relu,
                            cudaStream_t stream) {
  const size_t L = (size_t)P * Co;
  const size_t bytes = (L + LN_CLUSTER - 1) / LN_CLUSTER * sizeof(float);
  const int cache = bytes <= (size_t)LN_CACHE_MAX;
  // the kernel's static shared memory counts against the same 48 KB default,
  // so any cached chunk opts in (16 x 16 x 384 caches exactly 48 KB a block)
  static size_t configured = 0;
  if (cache && bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(ln_act_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           LN_CACHE_MAX);
    if (err != cudaSuccess) return err;
    configured = LN_CACHE_MAX;
  }
  ln_act_kernel<T><<<dim3(LN_CLUSTER, N), LN_THREADS, cache ? bytes : 0, stream>>>(
      acc, g, be, static_cast<const T*>(res), static_cast<T*>(out), P, Co, eps, relu, cache);
  return cudaGetLastError();
}

int launch_ln_act(const float* acc, const void* gamma, const void* beta, const void* residual,
                  void* out, int N, int P, int Co, double eps, int relu, int dtype,
                  cudaStream_t stream) {
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (dtype == 1)
    return static_cast<int>(launch_ln_act_t<__nv_bfloat16>(acc, g, be, residual, out, N, P, Co,
                                                           eps, relu, stream));
  return static_cast<int>(launch_ln_act_t<float>(acc, g, be, residual, out, N, P, Co, eps, relu,
                                                 stream));
}

}  // namespace

// x (N, H, W, Ci) contiguous; with wp (bf16 only: Ci, Co multiples of 8,
// x 16-byte aligned) the wgmma conv on the packed weights (Co rows of Kp
// bytes, ops/cuda_head.py::prepare_bf16) and w is not read; without it the
// scalar-staged bf16 or the float32 kernel on w (k, k, Ci, Co) contiguous.
extern "C" int conv_ln_act_launch(const void* x, const void* w, const void* wp, int Kp,
                                  const void* b, const void* gamma, const void* beta,
                                  const void* residual, void* out, void* scratch, int N, int H,
                                  int W, int Ci, int Co, int k, double eps, int relu, int dtype,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N == 0) return 0;
  const int P = H * W;
  const dim3 grid((P + BM - 1) / BM, (Co + BN - 1) / BN, N);
  float* acc = static_cast<float*>(scratch);
  const float* bias = static_cast<const float*>(b);
  cudaError_t err;
  if (wp != nullptr) {
    if (dtype != 1 || Ci % 8 != 0 || Co % 8 != 0 || reinterpret_cast<std::uintptr_t>(x) % 16 != 0 ||
        Kp < k * k * Ci * 2 || Kp % 128 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_wgmma(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp),
                       Kp, bias, acc, N, H, W, Ci, Co, k, stream);
  } else {
    if (dtype == 1) {
      conv_bf16_kernel<<<grid, 128, 0, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                                 static_cast<const __nv_bfloat16*>(w), bias, acc,
                                                 H, W, Ci, Co, k);
    } else {
      conv_f32_kernel<<<grid, 256, 0, stream>>>(static_cast<const float*>(x),
                                                static_cast<const float*>(w), bias, acc, H, W, Ci,
                                                Co, k);
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_ln_act(acc, gamma, beta, residual, out, N, P, Co, eps, relu, dtype, stream);
}

extern "C" int conv_ln_act_s8_launch(const void* x, long long sn, long long sc, long long sh,
                                     long long sw, const void* wp, const void* inv,
                                     const void* qscale, const void* b, const void* gamma,
                                     const void* beta, const void* residual, void* out,
                                     void* scratch, void* xq_ws, int N, int H, int W, int Ci,
                                     int Co, int k, double eps, int relu, int dtype,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N == 0) return 0;
  float* acc = static_cast<float*>(scratch);
  // in dtype 0 f32 / 1 bf16 as here; qmode 1: round(x * inv); float32 out (0)
  const int err = s8_conv_launch(x, sn, sc, sh, sw, dtype == 1 ? 1 : 0, wp, inv, 1, qscale, b, acc,
                                 0, xq_ws, N, H, W, Ci, Co, k, k / 2, stream_ptr);
  if (err != 0) return err;
  return launch_ln_act(acc, gamma, beta, residual, out, N, H * W, Co, eps, relu, dtype, stream);
}
