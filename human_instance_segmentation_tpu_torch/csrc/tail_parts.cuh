// Pieces shared by csrc/tail.cu (the float tail) and csrc/tail_q.cu (the
// int8 tail, whose border is the float tail of the dequantized input): the
// int8 tail's quantizer, and the bf16 tail's tensor-core parts, a 3x3 conv
// over pixel-major bf16 activations as an implicit GEMM on mma.sync
// m16n8k16 and its BN + ReLU epilogue rounded to bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace tail_parts {

using namespace hist_mma;

// round(v * inv) clipped to +-127, half to even: one correctly rounded
// multiply, so no contraction can move a value across a rounding boundary
__device__ __forceinline__ int8_t requant(float v, float inv) {
  return static_cast<int8_t>(
      __float2int_rn(fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f)));
}

// An input value of the int8 tail as float: x itself, or (dequantized) the
// float tail's input of the border, float(code) * s_x with code = x for an
// int8 x and requant(x, inv) otherwise.
__device__ __forceinline__ float value_f(float v) { return v; }
__device__ __forceinline__ float value_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float value_f(int8_t v) { return static_cast<float>(v); }
template <typename T>
__device__ __forceinline__ float dequantized(T v, float inv, float sx) {
  const int8_t code = std::is_same<T, int8_t>::value ? static_cast<int8_t>(value_f(v))
                                                      : requant(value_f(v), inv);
  return __fmul_rn(static_cast<float>(code), sx);
}

// One axis of the 2x half-pixel upsample at full-resolution index g of a
// source of n: the two source indices and weights, in the plain version's
// operand order (even: 0.25 * prev + 0.75 * cur; odd: 0.75 * cur + 0.25 * next).
__device__ __forceinline__ void up_taps(int g, int n, int& i0, int& i1, float& w0, float& w1) {
  const int i = g >> 1;
  if (g & 1) {
    i0 = i; i1 = min(i + 1, n - 1); w0 = 0.75f; w1 = 0.25f;
  } else {
    i0 = max(i - 1, 0); i1 = i; w0 = 0.25f; w1 = 0.75f;
  }
}

constexpr int MT = 2;  // 16-pixel M tiles per warp and step
// bytes per weight row (one K step's 16 bf16); rows n with bit 2 set hold
// their two 16-byte halves swapped, so the eight rows of an ldmatrix fall
// into different bank groups without padding
constexpr int WROW = 32;

// bytes per pixel of an activation buffer with g groups of 16 channels: the
// 16 bytes of padding make it an odd multiple of 16 (conflict-free ldmatrix)
__host__ __device__ constexpr int pix_bytes(int g) { return 32 * g + 16; }

// acc[mt][nt] = the (16 x 8) tile (M tile m0 / 16 + mt, N tile nt) of a 3x3
// conv as a product. src: bf16 activations pixel-major, pix_bytes(G) per
// pixel, srcw pixels a row; output pixel m of the outw-wide region reads the
// 3x3 window whose top-left pixel is m's row and column (rows past M read the
// last pixel; the caller drops them). wsm: [9 G][8 NT] rows of WROW bytes, K step
// (dy * 3 + dx) * G + cg holding, in row n, the weights of channels 16 cg ...
// 16 cg + 15 of tap (dy, dx) for output n.
template <int G, int NT, bool ON = true>  // ON false: zero sums (profiling builds only)
__device__ __forceinline__ void conv3x3(float (&acc)[MT][NT][4], uint32_t src, int srcw, int outw,
                                        int M, int m0, uint32_t wsm, int lane) {
  constexpr int PB = pix_bytes(G);
  const int q = lane >> 3, r = lane & 7;
  uint32_t a_base[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = min(m0 + 16 * mt + r + 8 * (q & 1), M - 1);
    a_base[mt] = src + ((m / outw) * srcw + m % outw) * PB + (q >> 1) * 16;
  }
  const uint32_t b_base = wsm + ((q >> 1) * 8 + r) * WROW + (((q & 1) ^ ((r >> 2) & 1)) * 16);
  __syncwarp();  // the epilogue before diverges; ldmatrix and mma.sync need the whole warp
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;
  if (!ON) return;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int cg = 0; cg < G; ++cg) {
      const int ks = tap * G + cg;
      const uint32_t aoff = ((tap / 3) * srcw + tap % 3) * PB + cg * 32;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], a_base[mt] + aoff);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        const uint32_t baddr = b_base + (ks * 8 * NT + nt * 8) * WROW;
        if (nt + 1 < NT) {
          uint32_t b[4];
          ldsm_x4(b, baddr);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
          }
        } else {
          uint32_t b[2];
          ldsm_x2(b, baddr);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
        }
      }
    }
  }
}

// BN (multiply, then add), ReLU, rounded to bf16; zero outside the image (the
// next conv's padding). The region starts at global (gy0, gx0) and is outw
// wide; dst is pixel-major with pix_bytes(NT / 2) per pixel.
template <int NT>
__device__ __forceinline__ void store_bn_relu(const float (&acc)[MT][NT][4], unsigned char* dst,
                                              int M, int m0, int outw, int gy0, int gx0, int H,
                                              int W, const float* scale, const float* shift,
                                              int lane) {
  constexpr int PB = pix_bytes(NT / 2);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 16 * mt + g + 8 * half;
      if (m >= M) continue;
      const int r = m / outw, c = m - r * outw;
      const int gy = gy0 + r, gx = gx0 + c;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int o = nt * 8 + 2 * t;
        const float* a = acc[mt][nt] + 2 * half;
        const float v0 = fmaxf(__fadd_rn(__fmul_rn(a[0], scale[o]), shift[o]), 0.0f);
        const float v1 = fmaxf(__fadd_rn(__fmul_rn(a[1], scale[o + 1]), shift[o + 1]), 0.0f);
        *reinterpret_cast<uint32_t*>(dst + m * PB + o * 2) = inside ? pack_bf16x2(v0, v1) : 0u;
      }
    }
}

}  // namespace tail_parts
