// s8 x s8 -> s32 implicit-GEMM convolution for Hopper (NHWC input, HWIO
// weights, stride 1, symmetric zero padding), shared by csrc/qconv.cu
// (qconv2d and s8_matmul) and csrc/conv_ln_act.cu (the int8 form of the
// fused unit).
//
// GEMM view: rows are output pixels of one image, columns output channels,
// and the contraction runs over the k*k taps and, within a tap, over
// BK-channel slices of the input (zero-filled past Ci, so any Ci works;
// Ci = 2 + skip concatenations and 258 occur in the served model). One
// block of 4 warps owns a BM-pixel x BN-channel tile of one image, each
// warp a 32 x WN part as WMMA 16x16x16 signed-char fragments accumulating
// in int32 on the tensor cores (exact: |acc| <= K * 127^2, far below 2^31
// for the K of this model). The tile follows Co, so that narrow outputs do
// not pay for a 64-wide tile of zeros: Co <= 16 takes 128 x 16 x 32
// (decoder4, the 1-2 channel logit heads), Co <= 32 takes 128 x 32 x 32
// (decoder3), wider outputs 64 x 64 x 64.
//
// Input staging, two launches: a float32 or bf16 input is first quantized
// once per value by stage_kernel into an int8 NHWC buffer whose channel
// count is padded to a multiple of 16 with zero codes (an int8 input is
// copied there), so every conv stages its input with 16-byte cp.async
// copies from aligned rows. The quantizers:
//   Q_DIV  round(x / s)             (qconv2d, quant.py:176 divides)
//   Q_MUL  round(x * s), s = 1/xs   (the fused unit, pallas_head.py:105)
// use __fdiv_rn / __fmul_rn so nvcc cannot contract or approximate them,
// rintf (round half to even, as jnp.round and torch.round), then a clip to
// +-127. Quantizing in the conv's loader instead would redo it for each of
// the k*k taps, through registers: 1.8-2.3x slower per conv at the served
// shapes (PERF.md).
//
// Operands are staged in shared memory as 16x16 sub-tiles of 256 contiguous
// bytes, so every WMMA load is 32-byte aligned (int8 WMMA needs that; a
// plain row-major tile would put every second k-step 16 bytes off). Two
// stages: the next (tap, slice) is copied with cp.async (zero-filled past
// the image or the channel count) while the tensor cores work on the
// current one. Weights whose Co divides by 16 are copied the same way,
// others one value at a time.
//
// Epilogue: int32 out (s8_matmul), or float(acc) * scale[co] (+ bias[co]),
// each step rounded once (__int2float_rn, __fmul_rn, __fadd_rn), stored as
// float32 or bf16 (round to nearest even), NHWC; stores past P or Co are
// masked.
//
// Bound: the staging pass is memory-bound (2-4 bytes read and 1 written per
// input value: 0.9 GB at decoder4's 32 x 480 x 640 x 32 bf16 input). The
// conv is tensor-core work done with WMMA (mma.sync) and a two-stage
// pipeline, well below what wgmma with TMA reaches; a 1-2 channel logit
// head uses 1-2 of the 16 columns of each fragment. Warp-specialised TMA
// loads and wgmma are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

// Internal linkage: each .cu that includes this gets its own copy of the
// kernels (two translation units sharing a weak __global__ template stub
// would register one host symbol for two device modules).
namespace s8igemm {
namespace {

using namespace nvcuda;

constexpr int THREADS = 128;  // 4 warps

enum { Q_DIV = 0, Q_MUL = 1 };
enum { IN_F32 = 0, IN_BF16 = 1, IN_S8 = 2 };
enum { OUT_F32 = 0, OUT_BF16 = 1, OUT_S32 = 2 };

// Block tile BM x BN, contraction slice BK; each warp owns 32 rows x WN
// columns, the 4 warps laid out (BM / 32) x (BN / WN).
template <int BM_, int BN_, int BK_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WN = WN_;
  static constexpr int FM = 2, FN = WN / 16;  // 16x16 fragments per warp
  static_assert((BM / 32) * (BN / WN) == THREADS / 32, "4 warps per tile");
  union Smem {
    struct {
      int8_t a[2][BK / 16][BM / 16][16][16];  // [stage][k sub][pixel sub][pixel][k]
      int8_t b[2][BK / 16][BN / 16][16][16];  // [stage][k sub][co sub][k][co]
    } st;
    int c[BM][BN + 4];  // epilogue, after the last stage is read
  };
};
using WideTile = Tile<64, 64, 64, 32>;
using Narrow32Tile = Tile<128, 32, 32, 32>;
using Narrow16Tile = Tile<128, 16, 32, 16>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t quantize(float v, float s, int qmode) {
  const float t = qmode == Q_DIV ? __fdiv_rn(v, s) : __fmul_rn(v, s);
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(rintf(t), -127.0f), 127.0f)));
}

// Quantize-once staging: x (R rows of Ci values, float32 or bf16) ->
// xq (R rows of Cp = Ci rounded up to 16 int8 codes, zero past Ci), one
// 16-byte vector of codes per thread; an int8 x is only copied and padded.
template <typename T>
__global__ void __launch_bounds__(256)
stage_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, long long R, int Ci, int Cp,
             const float* __restrict__ qparam, int qmode) {
  constexpr bool kS8 = std::is_same<T, int8_t>::value;
  constexpr int kPer = 16 / sizeof(T);  // values per 16-byte load
  const int vecs = Cp / 16;
  const bool wide = Ci % 16 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  float q = 0.0f;
  if constexpr (!kS8) q = *qparam;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x; v < R * vecs;
       v += (long long)gridDim.x * blockDim.x) {
    const long long r = v / vecs;
    const int c0 = (int)(v % vecs) * 16;
    const T* src = x + r * Ci + c0;
    alignas(16) T in[16];
    if (wide) {
#pragma unroll
      for (int j = 0; j < 16 / kPer; ++j)
        reinterpret_cast<uint4*>(in)[j] = reinterpret_cast<const uint4*>(src)[j];
    }
    alignas(16) int8_t o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (c0 + i >= Ci) {
        o[i] = 0;
        continue;
      }
      const T val = wide ? in[i] : src[i];
      if constexpr (kS8) {
        o[i] = val;
      } else {
        o[i] = quantize(as_float(val), q, qmode);
      }
    }
    *reinterpret_cast<uint4*>(xq + r * Cp + c0) = *reinterpret_cast<const uint4*>(o);
  }
}

// Variant only names the caller in a profile (0 qconv/s8_matmul, 1 the
// fused unit); the code is the same. xq is int8 NHWC with a row stride of
// ldx >= Ci codes, ldx % 16 == 0, 16-byte aligned.
template <class TL, int Variant>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const int8_t* __restrict__ xq, int ldx, const int8_t* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            void* __restrict__ out, int out_dtype, int H, int W, int Ci, int Co, int k, int pad,
            int Ho, int Wo, int vec_b) {
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, FM = TL::FM, FN = TL::FN;
  const int P = Ho * Wo;
  const int p0 = blockIdx.x * BM, co0 = blockIdx.y * BN, n = blockIdx.z;
  __shared__ __align__(128) typename TL::Smem sm;
  __shared__ int rowy[BM], rowx[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32, wm = warp / (BN / TL::WN), wn = warp % (BN / TL::WN);
  for (int m = tid; m < BM; m += THREADS) {
    const int p = p0 + m;  // a row past P reads only zeros
    rowy[m] = p < P ? p / Wo - pad : -1000000;
    rowx[m] = p < P ? p % Wo - pad : 0;
  }
  __syncthreads();

  const int8_t* xn = xq + (size_t)n * H * W * ldx;
  const int csteps = (Ci + BK - 1) / BK;
  const int steps = k * k * csteps;

  // Stage one (tap, channel slice) into stage s: 16-byte cp.async copies of
  // the input (zero-filled past the image or the channel count), and of the
  // weights when Co % 16 == 0 (one value at a time otherwise).
  auto load = [&](int step, int s) {
    const int tap = step / csteps, c0 = (step % csteps) * BK;
    const int ky = tap / k, kx = tap % k;
    for (int v = tid; v < BM * BK / 16; v += THREADS) {
      const int m = v / (BK / 16), cc = (v % (BK / 16)) * 16, c = c0 + cc;
      const int py = rowy[m] + ky, px = rowx[m] + kx;
      const bool ok = c < Ci && py >= 0 && py < H && px >= 0 && px < W;
      cp_async16(&sm.st.a[s][cc >> 4][m >> 4][m & 15][0],
                 ok ? xn + ((size_t)py * W + px) * ldx + c : xn, ok ? 16 : 0);
    }
    const int8_t* wt = w + (size_t)tap * Ci * Co;
    if (vec_b) {
      for (int v = tid; v < BK * BN / 16; v += THREADS) {
        const int kk = v / (BN / 16), nn = (v % (BN / 16)) * 16;
        const int c = c0 + kk, co = co0 + nn;
        const bool ok = c < Ci && co < Co;
        cp_async16(&sm.st.b[s][kk >> 4][nn >> 4][kk & 15][0], ok ? wt + (size_t)c * Co + co : w,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kk = e / BN, nn = e % BN, c = c0 + kk, co = co0 + nn;
        sm.st.b[s][kk >> 4][nn >> 4][kk & 15][nn & 15] =
            (c < Ci && co < Co) ? wt[(size_t)c * Co + co] : int8_t(0);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  load(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    const int s = step & 1;
    if (step + 1 < steps) load(step + 1, s ^ 1);  // the stage read one step ago
    cp_async_commit();
    cp_async_wait<1>();  // every copy but the newest group has landed: stage s
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &sm.st.a[s][ks][wm * FM + i][0][0], 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &sm.st.b[s][ks][wn * FN + j][0][0], 16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // stage s is refilled by the next iteration's load
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&sm.c[(wm * FM + i) * 16][(wn * FN + j) * 16], acc[i][j], BN + 4,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int m = e / BN, nn = e % BN, p = p0 + m, co = co0 + nn;
    if (p >= P || co >= Co) continue;
    const size_t o = ((size_t)n * P + p) * Co + co;
    const int a = sm.c[m][nn];
    if (out_dtype == OUT_S32) {
      static_cast<int*>(out)[o] = a;
      continue;
    }
    float v = __fmul_rn(__int2float_rn(a), scale[co]);
    if (bias != nullptr) v = __fadd_rn(v, bias[co]);
    if (out_dtype == OUT_F32)
      static_cast<float*>(out)[o] = v;
    else
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  }
}

template <class TL, int Variant>
cudaError_t launch_tile(const int8_t* xq, int ldx, const int8_t* w, const float* scale,
                        const float* bias, void* out, int out_dtype, int N, int H, int W, int Ci,
                        int Co, int k, int pad, int Ho, int Wo, int vec_b, cudaStream_t stream) {
  const dim3 grid((Ho * Wo + TL::BM - 1) / TL::BM, (Co + TL::BN - 1) / TL::BN, N);
  conv_kernel<TL, Variant><<<grid, THREADS, 0, stream>>>(xq, ldx, w, scale, bias, out, out_dtype,
                                                         H, W, Ci, Co, k, pad, Ho, Wo, vec_b);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stage(const void* x, int8_t* xq, long long R, int Ci, int Cp,
                         const float* qparam, int qmode, cudaStream_t stream) {
  const long long work = R * (Cp / 16);
  if (work == 0) return cudaSuccess;
  const int blocks = (int)(work < (1 << 14) * 256LL ? (work + 255) / 256 : 1 << 14);
  stage_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const T*>(x), xq, R, Ci, Cp, qparam,
                                              qmode);
  return cudaGetLastError();
}

// Launch on x (N, H, W, Ci) of in_dtype and w (k, k, Ci, Co) int8; out is
// (N, H + 2 pad - k + 1, W + 2 pad - k + 1, Co). x is first quantized (a
// float input) or copied (an int8 one) into xq_ws, N * H * W rows of Ci
// rounded up to 16 codes: qparam points at one float32, the divisor for
// Q_DIV, the multiplier for Q_MUL (unused for an int8 input). scale (Co,)
// float32 (unused for OUT_S32), bias (Co,) float32 or null. Returns
// cudaErrorInvalidValue for a missing staging buffer or an unknown dtype,
// else cudaGetLastError().
template <int Variant>
cudaError_t launch(const void* x, const void* w, const float* qparam, int qmode,
                   const float* scale, const float* bias, void* out, void* xq_ws, int N, int H,
                   int W, int Ci, int Co, int k, int pad, int in_dtype, int out_dtype,
                   cudaStream_t stream) {
  const int Ho = H + 2 * pad - k + 1, Wo = W + 2 * pad - k + 1;
  if (N == 0 || Ho <= 0 || Wo <= 0 || Co == 0) return cudaSuccess;
  if (xq_ws == nullptr) return cudaErrorInvalidValue;
  const long long R = (long long)N * H * W;
  const int ldx = (Ci + 15) / 16 * 16;
  int8_t* xq = static_cast<int8_t*>(xq_ws);
  cudaError_t err;
  switch (in_dtype) {
    case IN_F32: err = launch_stage<float>(x, xq, R, Ci, ldx, qparam, qmode, stream); break;
    case IN_BF16:
      err = launch_stage<__nv_bfloat16>(x, xq, R, Ci, ldx, qparam, qmode, stream);
      break;
    case IN_S8: err = launch_stage<int8_t>(x, xq, R, Ci, ldx, qparam, qmode, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int vec_b = Co % 16 == 0 && reinterpret_cast<std::uintptr_t>(w) % 16 == 0;
  const int8_t* wq = static_cast<const int8_t*>(w);
  if (Co <= 16)
    return launch_tile<Narrow16Tile, Variant>(xq, ldx, wq, scale, bias, out, out_dtype, N, H, W,
                                              Ci, Co, k, pad, Ho, Wo, vec_b, stream);
  if (Co <= 32)
    return launch_tile<Narrow32Tile, Variant>(xq, ldx, wq, scale, bias, out, out_dtype, N, H, W,
                                              Ci, Co, k, pad, Ho, Wo, vec_b, stream);
  return launch_tile<WideTile, Variant>(xq, ldx, wq, scale, bias, out, out_dtype, N, H, W, Ci,
                                        Co, k, pad, Ho, Wo, vec_b, stream);
}

}  // namespace
}  // namespace s8igemm
