// Int8 fused stage-1 tail for Hopper: the last decoder block of the
// people-seg UNet and its 3x3 seg head with three s8 x s8 -> s32 convs and
// calibrated static activation scales, in one launch (plus a small pass that
// quantizes a float input once).
//
// Replaces the JAX package's Pallas kernel
// human_instance_segmentation_tpu/ops/pallas_tail_q.py::tail_with_borders_q
// (_tail_kernel_q :108, launched at :236). That kernel takes its input in
// space-to-depth form, runs per-phase patch matmuls, interleaves the phases
// with a permutation matmul and keeps 32-wide alignment margins; none of that
// comes along. What is kept is the function: conv0 is the composition of the
// 2x bilinear upsample with the 3x3 conv (four 3x3 kernels on the input's own
// grid, one per output parity, zero padding on that grid), its s32 sums are
// dequantized, shifted, rectified and requantized for conv1, conv1's likewise
// for the head. As in the JAX package the outer six rows and columns of the
// map are not int8: the wrapper (ops/cuda_tail.py::tail_q) overwrites them
// with the float tail kernel's result on four dequantized edge strips. Every
// pixel this kernel is answerable for (rows and columns 6 ... -7) depends on
// no padding of the input grid and on no value outside the image.
//
// Arithmetic, equal to ops/cuda_tail.py::tail_q_plain bit for bit: integer
// sums are exact; after them every step is one correctly rounded float32
// operation (__int2float_rn, __fmul_rn by the dequant scale, __fadd_rn of
// the shift, fmaxf, __fmul_rn by 1/scale, rintf, clip), so no contraction
// can move a value across a quantizer's rounding boundary.
//
// Design: one block of 8 warps per 16 x 32 tile of output pixels. Shared
// memory holds the input codes on their own grid with a halo (12 x 20
// cells), conv0's requantized output at full resolution with a 2-pixel halo,
// conv1's with a 1-pixel halo, and all weights. Each conv is a matrix product
// on the tensor cores with mma.sync m16n8k32 (s8 x s8 -> s32): a warp owns 16
// consecutive pixels of the flattened output region and all output channels.
// Activations lie pixel-major with the channels padded to 16, so the three
// taps of one kernel row are one contiguous run of 3 * C bytes: the
// contraction walks each kernel row in 32-byte steps, the weights padded with
// zero codes to a multiple of 32 per row (what the A operand reads past the
// third tap is the next pixel's codes, times zero). Fragments are loaded as
// 32-bit words straight from shared memory, which needs 4-byte alignment
// only. conv0's four parities share one A operand (N = 4 C). The head has one
// output channel; it runs on the same path with N padded to 8.
//
// Bound: operations on the int8 tensor cores, 2 * 9 * (Ci * C + C * C + C)
// per output pixel, against one byte per input code and 2-4 per logit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TH = 16, TW = 32;              // output tile (full resolution)
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int XH = TH / 2 + 4, XW = TW / 2 + 4;    // input cells staged (halo 2)
constexpr int C0H = TH / 2 + 2, C0W = TW / 2 + 2;  // cells conv0 computes (halo 1)
constexpr int Y0H = TH + 4, Y0W = TW + 4;          // conv0 output, halo 2
constexpr int Y1H = TH + 2, Y1W = TW + 2;          // conv1 output, halo 1
constexpr int SLACK = 32;  // the last 32-byte step of a kernel row may read past the buffer's end

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// round(v * inv) clipped to +-127, half to even
__device__ __forceinline__ int8_t requant(float v, float inv) {
  return static_cast<int8_t>(
      __float2int_rn(fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One warp's 16 x (8 NT) tile of a 3x3 conv as a matrix product. src holds
// int8 codes pixel-major, `cs` bytes per pixel and `srcw` pixels per row; the
// output region is `outw` wide and output pixel (r, c) reads the 3x3 window
// whose top-left source pixel is (r, c). wsm: [3][ks][8 NT][32] codes, the
// contraction index within kernel row dy being dx * cs + channel. Rows m0 + g
// and m0 + g + 8 of the tile are the flattened output pixels (clamped to the
// last one). acc[nt][0..1]: row g, columns nt*8 + 2t, +1; acc[nt][2..3]: row
// g + 8 (g = lane / 4, t = lane % 4).
template <int NT>
__device__ __forceinline__ void conv_mma(int (&acc)[NT][4], const int8_t* __restrict__ src, int cs,
                                         int srcw, int outw, int M, int m0,
                                         const int8_t* __restrict__ wsm, int ks, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // the epilogue before this call diverges; mma.sync needs the whole warp
  const int ma = min(m0 + g, M - 1), mb = min(m0 + g + 8, M - 1);
  const int8_t* pa = src + ((ma / outw) * srcw + ma % outw) * cs + t * 4;
  const int8_t* pb = src + ((mb / outw) * srcw + mb % outw) * cs + t * 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0;
  for (int dy = 0; dy < 3; ++dy) {
    for (int s = 0; s < ks; ++s) {
      const int off = dy * srcw * cs + s * 32;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(pa + off);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(pb + off);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(pa + off + 16);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(pb + off + 16);
      const int8_t* wb = wsm + ((dy * ks + s) * (8 * NT) + g) * 32 + t * 4;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wb + nt * 8 * 32);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wb + nt * 8 * 32 + 16);
        mma_s8(acc[nt], a0, a1, a2, a3, b0, b1);
      }
    }
  }
}

struct Layout {  // byte offsets into dynamic shared memory
  int fp, w0, w1, wh, xs, y0, y1, total;
};

__host__ __device__ inline int ksteps(int cs) { return (3 * cs + 31) / 32; }

__host__ __device__ inline Layout layout(int Cip, int Cp) {
  Layout L;
  int o = 0;
  L.fp = o; o += ((7 * Cp + 4) * 4 + 15) / 16 * 16;
  L.w0 = o; o += 3 * ksteps(Cip) * 4 * Cp * 32;
  L.w1 = o; o += 3 * ksteps(Cp) * Cp * 32;
  L.wh = o; o += 3 * ksteps(Cp) * 8 * 32;
  L.xs = o; o += XH * XW * Cip + SLACK;
  L.y0 = o; o += Y0H * Y0W * Cp + SLACK;
  L.y1 = o; o += Y1H * Y1W * Cp + SLACK;
  L.total = o;
  return L;
}

// xq (B, h, w, Ci) int8 contiguous. w0q [3][ks0][4 Cp][32], w1q [3][ks1][Cp][32],
// whq [3][ks1][8][32] int8 as conv_mma reads them. fp float32: g0 (4 Cp: the
// dequant scale of parity * Cp + channel), b0 (Cp), g1 (Cp), b1 (Cp), then
// gh, bh, 1 / s_mid, 1 / s_head. out (B, 2h, 2w). Cip = Ci rounded up to 16,
// Cp = 16 CPB = C rounded up to 16; padded channels have zero weights, scales
// and shifts.
template <typename T, int CPB>
__global__ void __launch_bounds__(THREADS)
tail_q_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w0q,
              const int8_t* __restrict__ w1q, const int8_t* __restrict__ whq,
              const float* __restrict__ fp, T* __restrict__ out, int h, int w, int Ci, int Cip) {
  constexpr int Cp = 16 * CPB;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(Cip, Cp);
  float* fps = reinterpret_cast<float*>(smem + L.fp);
  int8_t* w0s = reinterpret_cast<int8_t*>(smem + L.w0);
  int8_t* w1s = reinterpret_cast<int8_t*>(smem + L.w1);
  int8_t* whs = reinterpret_cast<int8_t*>(smem + L.wh);
  int8_t* xs = reinterpret_cast<int8_t*>(smem + L.xs);
  int8_t* y0 = reinterpret_cast<int8_t*>(smem + L.y0);
  int8_t* y1 = reinterpret_cast<int8_t*>(smem + L.y1);
  const float* g0 = fps;
  const float* b0 = fps + 4 * Cp;
  const float* g1 = fps + 5 * Cp;
  const float* b1 = fps + 6 * Cp;

  const int H = 2 * h, W = 2 * w;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;  // both even
  const int ks0 = ksteps(Cip), ks1 = ksteps(Cp);

  for (int i = tid; i < 7 * Cp + 4; i += THREADS) fps[i] = fp[i];
  {
    const int n0 = (L.w1 - L.w0) / 16, n1 = (L.wh - L.w1) / 16, nh = (L.xs - L.wh) / 16;
    for (int i = tid; i < n0; i += THREADS)
      reinterpret_cast<uint4*>(w0s)[i] = reinterpret_cast<const uint4*>(w0q)[i];
    for (int i = tid; i < n1; i += THREADS)
      reinterpret_cast<uint4*>(w1s)[i] = reinterpret_cast<const uint4*>(w1q)[i];
    for (int i = tid; i < nh; i += THREADS)
      reinterpret_cast<uint4*>(whs)[i] = reinterpret_cast<const uint4*>(whq)[i];
  }
  // ---- the input cells, zero outside the input's grid and past Ci
  const int ci0 = ty0 / 2 - 2, cj0 = tx0 / 2 - 2;
  const int8_t* xb = xq + (size_t)b * h * w * Ci;
  if (Ci == Cip && reinterpret_cast<std::uintptr_t>(xq) % 16 == 0) {
    const int vpc = Cip / 16;
    for (int i = tid; i < XH * XW * vpc; i += THREADS) {
      const int cell = i / vpc, v = i - cell * vpc;
      const int gi = ci0 + cell / XW, gj = cj0 + cell % XW;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gi >= 0 && gi < h && gj >= 0 && gj < w)
        val = reinterpret_cast<const uint4*>(xb + ((size_t)gi * w + gj) * Ci)[v];
      reinterpret_cast<uint4*>(xs)[i] = val;
    }
  } else {
    for (int i = tid; i < XH * XW * Cip; i += THREADS) {
      const int cell = i / Cip, c = i - cell * Cip;
      const int gi = ci0 + cell / XW, gj = cj0 + cell % XW;
      xs[i] = (c < Ci && gi >= 0 && gi < h && gj >= 0 && gj < w)
                  ? xb[((size_t)gi * w + gj) * Ci + c] : int8_t(0);
    }
  }
  __syncthreads();

  const float inv_mid = fps[7 * Cp + 2], inv_head = fps[7 * Cp + 3];

  // ---- conv0 (upsample composed in) on the input's grid: cell (r, c) of the
  // C0H x C0W region gives the four full-resolution pixels (2r + py, 2c + px)
  // of y0, requantized with 1 / s_mid; zero outside the image (conv1's padding)
  {
    constexpr int NT = 4 * Cp / 8, M = C0H * C0W;
    for (int m0 = warp * 16; m0 < M; m0 += WARPS * 16) {
      int acc[NT][4];
      conv_mma<NT>(acc, xs, Cip, XW, C0W, M, m0, w0s, ks0, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + g + 8 * half;
        if (m >= M) continue;
        const int r = m / C0W, c = m - r * C0W;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = nt * 8 + 2 * t + j;
            const int par = n / Cp, o = n - par * Cp;
            const int ly = 2 * r + (par >> 1), lx = 2 * c + (par & 1);
            const int gy = ty0 - 2 + ly, gx = tx0 - 2 + lx;
            const float v = fmaxf(
                __fadd_rn(__fmul_rn(__int2float_rn(acc[nt][2 * half + j]), g0[n]), b0[o]), 0.0f);
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            y0[(ly * Y0W + lx) * Cp + o] = inside ? requant(v, inv_mid) : int8_t(0);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- conv1 over y0, requantized with 1 / s_head; zero outside the image
  {
    constexpr int NT = Cp / 8, M = Y1H * Y1W;
    for (int m0 = warp * 16; m0 < M; m0 += WARPS * 16) {
      int acc[NT][4];
      conv_mma<NT>(acc, y0, Cp, Y0W, Y1W, M, m0, w1s, ks1, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + g + 8 * half;
        if (m >= M) continue;
        const int r = m / Y1W, c = m - r * Y1W;
        const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int o = nt * 8 + 2 * t + j;
            const float v = fmaxf(
                __fadd_rn(__fmul_rn(__int2float_rn(acc[nt][2 * half + j]), g1[o]), b1[o]), 0.0f);
            y1[(r * Y1W + c) * Cp + o] = inside ? requant(v, inv_head) : int8_t(0);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- seg head over y1: column 0 of the 8-wide product is the logit
  {
    constexpr int M = TH * TW;
    const float gh = fps[7 * Cp], bh = fps[7 * Cp + 1];
    for (int m0 = warp * 16; m0 < M; m0 += WARPS * 16) {
      int acc[1][4];
      conv_mma<1>(acc, y1, Cp, Y1W, TW, M, m0, whs, ks1, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + g + 8 * half;
        const int gy = ty0 + m / TW, gx = tx0 + m % TW;
        if (t == 0 && gy < H && gx < W)
          store(out + ((size_t)b * H + gy) * W + gx,
                __fadd_rn(__fmul_rn(__int2float_rn(acc[0][2 * half]), gh), bh));
      }
    }
  }
}

// x: logical (B, h, w, Ci) with element strides sb, sh, sw, sc -> xq (B, h, w,
// Ci) int8 contiguous, clip(round(x * inv)). A thread owns 16 channels of one
// pixel; neighbouring threads take neighbouring pixels when the channels are
// strided in memory (an NCHW tensor), neighbouring channel groups otherwise.
template <typename T>
__global__ void __launch_bounds__(256)
quantize_kernel(const T* __restrict__ x, long long sb, long long sh, long long sw, long long sc,
                int8_t* __restrict__ xq, float inv, long long P, int h, int w, int Ci) {
  const int groups = (Ci + 15) / 16;
  const long long total = P * groups;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    long long p;
    int grp;
    if (sc == 1) {
      grp = (int)(i % groups); p = i / groups;
    } else {
      p = i % P; grp = (int)(i / P);
    }
    const int px = (int)(p % w), py = (int)((p / w) % h);
    const long long pb = p / ((long long)w * h);
    const T* src = x + pb * sb + py * sh + px * sw;
    int8_t* dst = xq + p * Ci;
    const int c0 = grp * 16, n = min(16, Ci - c0);
    alignas(16) int8_t codes[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      codes[j] = j < n ? requant(to_f(src[(long long)(c0 + j) * sc]), inv) : int8_t(0);
    if (n == 16 && Ci % 16 == 0 && reinterpret_cast<std::uintptr_t>(xq) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst + c0) = *reinterpret_cast<const uint4*>(codes);
    } else {
      for (int j = 0; j < n; ++j) dst[c0 + j] = codes[j];
    }
  }
}

template <typename T, int CPB>
int launch(const int8_t* xq, const int8_t* w0q, const int8_t* w1q, const int8_t* whq,
           const float* fp, void* out, int B, int h, int w, int Ci, int Cip,
           cudaStream_t stream) {
  const Layout L = layout(Cip, 16 * CPB);
  if (L.total > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(tail_q_kernel<T, CPB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((2 * w + TW - 1) / TW, (2 * h + TH - 1) / TH, B);
  tail_q_kernel<T, CPB><<<grid, THREADS, L.total, stream>>>(xq, w0q, w1q, whq, fp,
                                                            static_cast<T*>(out), h, w, Ci, Cip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory a block needs at the padded widths (not a launcher).
extern "C" int tail_q_smem_bytes_for(int Cip, int Cp) { return layout(Cip, Cp).total; }

// x (float32 or bfloat16, any strides) -> int8 codes, contiguous NHWC.
extern "C" int tail_q_quantize_launch(const void* x, long long sb, long long sh, long long sw,
                                      long long sc, void* xq, float inv, int B, int h, int w,
                                      int Ci, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long P = (long long)B * h * w, work = P * ((Ci + 15) / 16);
  if (work == 0) return 0;
  const int blocks = (int)(work < (1 << 16) * 256LL ? (work + 255) / 256 : 1 << 16);
  int8_t* q = static_cast<int8_t*>(xq);
  if (dtype == 1)
    quantize_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), sb, sh, sw, sc, q, inv, P, h, w, Ci);
  else
    quantize_kernel<float><<<blocks, 256, 0, stream>>>(static_cast<const float*>(x), sb, sh, sw,
                                                       sc, q, inv, P, h, w, Ci);
  return static_cast<int>(cudaGetLastError());
}

// The int8 map (every pixel; the wrapper overwrites the outer six rows and
// columns). Cp is 16 or 32. out dtype 0 float32, 1 bfloat16.
extern "C" int tail_q_launch(const void* xq, const void* w0q, const void* w1q, const void* whq,
                             const void* fp, void* out, int B, int h, int w, int Ci, int Cip,
                             int Cp, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((size_t)B * h * w == 0) return 0;
  if (Cip % 16 != 0 || Cip < Ci || (Cp != 16 && Cp != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* q0 = static_cast<const int8_t*>(w0q);
  const int8_t* q1 = static_cast<const int8_t*>(w1q);
  const int8_t* qh = static_cast<const int8_t*>(whq);
  const float* f = static_cast<const float*>(fp);
  if (dtype == 1) {
    if (Cp == 16)
      return launch<__nv_bfloat16, 1>(x8, q0, q1, qh, f, out, B, h, w, Ci, Cip, stream);
    return launch<__nv_bfloat16, 2>(x8, q0, q1, qh, f, out, B, h, w, Ci, Cip, stream);
  }
  if (Cp == 16) return launch<float, 1>(x8, q0, q1, qh, f, out, B, h, w, Ci, Cip, stream);
  return launch<float, 2>(x8, q0, q1, qh, f, out, B, h, w, Ci, Cip, stream);
}
