// Int8 fused stage-1 tail for Hopper: the last decoder block of the
// people-seg UNet and its 3x3 seg head with three s8 x s8 -> s32 convs and
// calibrated static activation scales, the outer six rows and columns being
// the float tail of the dequantized input.
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
// for the head. Every pixel of the int8 map that is kept (rows and columns 6
// ... -7) depends on no padding of the input grid and on no value outside the
// image. The outer six rows and columns are the float tail (csrc/tail.cu's
// rule) of deq = float(xq) * s_x on the whole map, which is what the JAX
// package's four edge strips compute (the strips' own edges lie further from
// the kept pixels than the tail's receptive field).
//
// Arithmetic, equal to ops/cuda_tail.py::tail_q_plain bit for bit in the
// interior: x is quantized once as clip(rint(x * float32(1 / s_x))) (tail_parts::
// requant); integer sums are exact; after them every step is one correctly
// rounded float32 operation (__int2float_rn, __fmul_rn by the dequant scale,
// __fadd_rn of the shift, fmaxf, requant), so no contraction can move a value
// across a quantizer's rounding boundary.
//
// Design. A persistent grid (two blocks of 8 warps an SM) walks the 16 x 32
// output tiles; a block stages every weight once. For each tile it reads the
// 12 x 20 input cells with their halo straight from x through its strides
// (float32, bf16 or int8; an NCHW tensor viewed as NHWC needs no copy) and
// quantizes each value once into a pixel-major int8 tile in shared memory, so
// device memory never holds an int8 copy of a float x. Each conv is then a
// matrix product on the tensor cores with mma.sync m16n8k32: conv0 over the 10
// x 18 cells it needs (N = 4 parities x C; a warp item is a 16-cell M tile and
// half of N), conv1 over the 18 x 34 pixels the head needs, the head (N padded
// to 8). The contraction runs over 16-byte halves of the flattened (tap,
// 16-channel group) index: a 32-byte step's two halves are read at two taps'
// shifted pixels (the fragment's registers a0/a1 and a2/a3 come from separate
// 16-byte runs), so a C = 16 conv takes 5 steps for its 9 taps where one step
// per kernel row and 32 bytes took 6 (the last half-step meets zero weights).
// Pixel rows of the int8 buffers are an odd multiple of 16 bytes and weight
// rows swap their halves where bit 2 of the row is set, so the 32-bit
// fragment loads of a warp meet 32 different banks.
//
// The border is the kernel's own where the output is bf16: a tile that meets
// the outer six rows or columns runs, after its int8 head, the bf16 float tail
// (csrc/tail_parts.cuh: mma.sync m16n8k16 with float32 sums, the upsampled
// input and both BN + ReLU outputs rounded to bf16) on bands of at most 6 x 32
// and 16 x 6 output pixels, upsampling the dequantized codes it already holds
// (the taps clamped into the image), and writes those pixels; the int8 head
// skips them. A float32 output keeps the float32 rule on the float32 units:
// there the int8 map writes every pixel and one more launch of the float tail
// (csrc/tail.cu, border mode) overwrites the border.
//
// Bound: operations on the int8 tensor cores, 2 * 9 * (Ci * C + C * C + C)
// per output pixel, against 2 bytes per bf16 input value and 2-4 per logit.
// What holds it (scripts/profile_torch_kernels.py, parts switched off): the
// requantizing epilogues, most of it their wait for the products they read;
// then the border bands and each tile's serial staging. Two blocks of 8 warps
// an SM, at the 128-register cap, hide little of it; issuing the next
// item's products before an epilogue spilled and was slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"
#include "tail_parts.cuh"

namespace {

using namespace tail_parts;

constexpr int TH = 16, TW = 32;              // output tile (full resolution)
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int XH = TH / 2 + 4, XW = TW / 2 + 4;    // input cells staged (halo 2)
constexpr int C0H = TH / 2 + 2, C0W = TW / 2 + 2;  // cells conv0 computes (halo 1)
constexpr int Y0H = TH + 4, Y0W = TW + 4;          // conv0 output, halo 2
constexpr int Y1H = TH + 2, Y1W = TW + 2;          // conv1 output, halo 1
constexpr int BORDER = 6;                          // outer rows and columns that are float
constexpr int MAX_CPC = 4;                         // 16-channel groups of the input, at most
// HIST_SKIP bits of this kernel (csrc/mma_bf16.cuh; profiling builds only)
constexpr int SKIP_FILL = 1024, SKIP_CONV0 = 2048, SKIP_CONV1 = 4096, SKIP_HEAD = 8192,
              SKIP_BORDER = 16384, SKIP_REQUANT = 32768, SKIP_DEPEND = 65536;

// A product's sum as the epilogue reads it; SKIP_DEPEND (profiling builds
// only) hands it a value that does not wait for the products instead
__device__ __forceinline__ int product(int acc) {
  return skip(SKIP_DEPEND) ? static_cast<int>(threadIdx.x) : acc;
}

// The float border's bands: at most BORDER x TW or TH x BORDER output pixels,
// with the upsampled input (halo 3) and conv0's output (halo 2) of the larger
constexpr int BAND_U = (BORDER + 6) * (TW + 6) > (TH + 6) * (BORDER + 6)
                           ? (BORDER + 6) * (TW + 6) : (TH + 6) * (BORDER + 6);
constexpr int BAND_Y0 = (BORDER + 4) * (TW + 4) > (TH + 4) * (BORDER + 4)
                            ? (BORDER + 4) * (TW + 4) : (TH + 4) * (BORDER + 4);

// bytes per pixel of an int8 buffer with c channels: an odd multiple of 16
__host__ __device__ constexpr int pix_stride(int c) { return c % 32 == 16 ? c : c + 16; }
// 32-byte contraction steps of a 3x3 conv over cpc 16-channel groups
__host__ __device__ constexpr int ksteps(int cpc) { return (9 * cpc + 1) / 2; }
__host__ __device__ constexpr int up16(int b) { return (b + 15) / 16 * 16; }
__host__ __device__ constexpr int imax2(int a, int b) { return a > b ? a : b; }

// The int8 code of relu(float(acc) * g + b) requantized with inv, each step
// one correctly rounded float32 op (requant's clip bounds are integers, and
// the value is >= 0)
__device__ __forceinline__ uint32_t relu_code(int acc, float g, float b, float inv) {
  const float v = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), g), b), 0.0f);
  return static_cast<uint32_t>(__float2int_rn(fminf(__fmul_rn(v, inv), 127.0f)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The byte offset, from an output pixel's window corner, of contraction half
// h of a 3x3 conv over CPC 16-channel groups whose source rows hold SRCW
// pixels of PS bytes: tap h / CPC, channels 16 (h % CPC) ...; 0 past the
// last half, where the weights are zero. Every argument is known at compile
// time, so the unrolled step loop carries no offset table.
template <int CPC, int SRCW, int PS>
__device__ __forceinline__ constexpr int half_offset(int h) {
  return h < 9 * CPC ? (((h / CPC) / 3) * SRCW + (h / CPC) % 3) * PS + (h % CPC) * 16 : 0;
}

// One warp's B fragments of NT 8-column tiles (rows n0 ...) for all KS steps,
// held in registers across the M tiles of a block (conv1 and the head at C =
// 16, whose 30 registers spare 1,100 fragment loads of shared memory a tile).
template <int NT, int KS>
struct BFrags {
  uint32_t b[KS][NT][2];
};

// wsm: [steps][nrows] rows of 32 bytes, the two 16-byte halves swapped in rows
// with bit 2 set (so the 32-bit loads of a warp meet 32 banks)
template <int NT, int KS>
__device__ __forceinline__ void load_b(BFrags<NT, KS>& f, const int8_t* __restrict__ wsm, int nrows,
                                       int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int sw = ((g >> 2) & 1) * 16;  // the swizzled position of half 0 in row g (mod 8)
  const int8_t* wrow = wsm + (n0 + g) * 32 + t * 4;
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int8_t* p = wrow + (s * nrows + nt * 8) * 32;
      f.b[s][nt][0] = *reinterpret_cast<const uint32_t*>(p + sw);
      f.b[s][nt][1] = *reinterpret_cast<const uint32_t*>(p + (sw ^ 16));
    }
}

// One warp's 16 x (8 NT) tile of a 3x3 conv over CPC 16-channel groups as a
// product. src holds int8 codes pixel-major, pix_stride(16 CPC) bytes per
// pixel and SRCW pixels per row; the output region is OUTW wide and output
// pixel (r, c) reads the 3x3 window whose top-left source pixel is (r, c).
// The contraction runs over 16-byte halves (half_offset), two to a step. B:
// from `breg` (BREG) or from wsm, rows n0 ... of [steps][nrows]. Rows m0 + g
// and m0 + g + 8 are the flattened output pixels (clamped to the last one).
// acc[nt][0..1]: row g, columns nt*8 + 2t, +1; acc[nt][2..3]: row g + 8 (g =
// lane / 4, t = lane % 4).
template <int NT, int CPC, int SRCW, int OUTW, bool BREG, int SKIP>
__device__ __forceinline__ void conv_mma(int (&acc)[NT][4], const int8_t* __restrict__ src, int M,
                                         int m0, const int8_t* __restrict__ wsm, int nrows, int n0,
                                         const BFrags<NT, ksteps(CPC)>& breg, int lane) {
  constexpr int PS = pix_stride(16 * CPC), KS = ksteps(CPC);
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // the epilogue before this call diverges; mma.sync needs the whole warp
  const int ma = min(m0 + g, M - 1), mb = min(m0 + g + 8, M - 1);
  const int8_t* pa = src + ((ma / OUTW) * SRCW + ma % OUTW) * PS + t * 4;
  const int8_t* pb = src + ((mb / OUTW) * SRCW + mb % OUTW) * PS + t * 4;
  const int sw = ((g >> 2) & 1) * 16;
  const int8_t* wrow = wsm + (n0 + g) * 32 + t * 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0;
  if (skip(SKIP)) return;  // profiling builds only
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int o0 = half_offset<CPC, SRCW, PS>(2 * s), o1 = half_offset<CPC, SRCW, PS>(2 * s + 1);
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(pa + o0);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(pb + o0);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(pa + o1);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(pb + o1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      if constexpr (BREG) {
        b0 = breg.b[s][nt][0];
        b1 = breg.b[s][nt][1];
      } else {
        const int8_t* p = wrow + (s * nrows + nt * 8) * 32;
        b0 = *reinterpret_cast<const uint32_t*>(p + sw);
        b1 = *reinterpret_cast<const uint32_t*>(p + (sw ^ 16));
      }
      mma_s8(acc[nt], a0, a1, a2, a3, b0, b1);
    }
  }
}

struct Layout {  // byte offsets into dynamic shared memory
  int fp, w0, w1, wh, bfp, bw0, bw1, bwh, xs, act, y1, bu, by0, total;
};

// cpi, cp: 16-channel groups of the input and of the convs; border: the block
// computes the bf16 float border (bf16 output)
__host__ __device__ inline Layout layout(int cpi, int cp, bool border) {
  const int Cp = 16 * cp;
  Layout L{};
  int o = 0;
  L.fp = o; o += up16((7 * Cp + 4) * 4);
  L.w0 = o; o += ksteps(cpi) * 4 * Cp * 32;
  L.w1 = o; o += ksteps(cp) * Cp * 32;
  L.wh = o; o += ksteps(cp) * 8 * 32;
  L.bfp = L.bw0 = L.bw1 = L.bwh = o;
  if (border) {
    L.bfp = o; o += up16((4 * Cp + 4) * 4);
    L.bw0 = o; o += 9 * cpi * Cp * WROW;
    L.bw1 = o; o += 9 * cp * Cp * WROW;
    L.bwh = o; o += 9 * cp * 8 * WROW;
  }
  L.xs = o; o += up16(XH * XW * pix_stride(16 * cpi));
  // the int8 activations, and the border's bf16 ones (after the int8 head) in
  // the same bytes: the upsampled input (later conv1's output) and conv0's
  L.act = o;
  const int y0b = up16(Y0H * Y0W * pix_stride(Cp));
  L.y1 = o + y0b;
  const int int8_bytes = y0b + up16(Y1H * Y1W * pix_stride(Cp));
  L.bu = o;
  L.by0 = o + BAND_U * pix_bytes(cpi);
  const int band_bytes = border ? BAND_U * pix_bytes(cpi) + BAND_Y0 * pix_bytes(cp) : 0;
  o += imax2(int8_bytes, band_bytes);
  L.total = o;
  return L;
}

// The staged input cells: x's values at cells (ci0 .., cj0 ..) (XH x XW),
// quantized with inv unless x is int8, zero outside the image and past Ci,
// into xs (pixel stride xps). An item is 16 channels of one cell: with the
// channels innermost in memory neighbouring threads take neighbouring channel
// groups, otherwise neighbouring cells (an NCHW plane is read along its rows).
// vec: channels innermost, Ci a multiple of 16 and 16-byte aligned rows.
template <typename Tin>
__device__ __noinline__ void fill_cells(int8_t* xs, int xps, const Tin* __restrict__ xb,
                                        long long sh, long long sw, long long sc, float inv, int h,
                                        int w, int Ci, int cpi, int ci0, int cj0, int vec) {
  const int items = XH * XW * cpi;
  for (int i = threadIdx.x; i < items; i += THREADS) {
    int cell, grp;
    if (sc == 1) {
      cell = i / cpi; grp = i - cell * cpi;
    } else {
      grp = i / (XH * XW); cell = i - grp * (XH * XW);
    }
    const int r = cell / XW, cidx = cell - r * XW;
    const int gi = ci0 + r, gj = cj0 + cidx;
    uint32_t word[4] = {0u, 0u, 0u, 0u};
    if (gi >= 0 && gi < h && gj >= 0 && gj < w) {
      const Tin* p = xb + gi * sh + gj * sw + (long long)grp * 16 * sc;
      int8_t code[16];
      if (vec) {
        constexpr int PER = 16 / sizeof(Tin);  // values in a 16-byte load
        Tin v[16];
#pragma unroll
        for (int k = 0; k < 16 / PER; ++k)
          *reinterpret_cast<uint4*>(v + k * PER) = reinterpret_cast<const uint4*>(p)[k];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          code[j] = std::is_same<Tin, int8_t>::value ? static_cast<int8_t>(value_f(v[j]))
                                                      : requant(value_f(v[j]), inv);
      } else {
        float v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = grp * 16 + j < Ci ? value_f(p[j * sc]) : 0.0f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          code[j] = std::is_same<Tin, int8_t>::value ? static_cast<int8_t>(v[j]) : requant(v[j], inv);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        word[k] = (uint32_t)(uint8_t)code[4 * k] | ((uint32_t)(uint8_t)code[4 * k + 1] << 8) |
                  ((uint32_t)(uint8_t)code[4 * k + 2] << 16) |
                  ((uint32_t)(uint8_t)code[4 * k + 3] << 24);
    }
    *reinterpret_cast<uint4*>(xs + cell * xps + grp * 16) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// conv0 of the float border for a runtime number of input groups
template <int NT>
__device__ __forceinline__ void border_conv0(int cpi, float (&acc)[MT][NT][4], uint32_t src,
                                             int srcw, int outw, int M, int m0, uint32_t wsm,
                                             int lane) {
  switch (cpi) {
    case 1: conv3x3<1, NT>(acc, src, srcw, outw, M, m0, wsm, lane); break;
    case 2: conv3x3<2, NT>(acc, src, srcw, outw, M, m0, wsm, lane); break;
    case 3: conv3x3<3, NT>(acc, src, srcw, outw, M, m0, wsm, lane); break;
    default: conv3x3<4, NT>(acc, src, srcw, outw, M, m0, wsm, lane); break;
  }
}

// The bf16 float tail of the dequantized cells on output rows [ry0, ry1) x
// columns [rx0, rx1) (inside the image and the block's tile), written to out.
// xs holds the tile's cells from (ci0, cj0); every cell the upsample reads
// (its taps clamped into the image) lies among them.
template <int CPB>
__device__ void border_band(int ry0, int ry1, int rx0, int rx1, unsigned char* smem,
                            const Layout& L, const int8_t* xs, int xps, int ci0, int cj0, int cpi,
                            float sx, int h, int w, __nv_bfloat16* __restrict__ outb) {
  constexpr int Cp = 16 * CPB, NT = 2 * CPB;
  const int H = 2 * h, W = 2 * w;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int uh = ry1 - ry0 + 6, uw = rx1 - rx0 + 6;
  unsigned char* us = smem + L.bu;
  unsigned char* y0s = smem + L.by0;
  const float* fps = reinterpret_cast<const float*>(smem + L.bfp);

  // the upsampled dequantized input, bf16, zero outside the image; a thread
  // writes 8 channels of one pixel
  {
    const int pb = pix_bytes(cpi);
    for (int it = tid; it < uh * uw * 2 * cpi; it += THREADS) {
      const int p = it % (uh * uw), c8 = it / (uh * uw);
      const int gy = ry0 - 3 + p / uw, gx = rx0 - 3 + p % uw;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        int i0, i1, j0, j1;
        float wy0, wy1, wx0, wx1;
        up_taps(gy, h, i0, i1, wy0, wy1);
        up_taps(gx, w, j0, j1, wx0, wx1);
        const int8_t* c00 = xs + ((i0 - ci0) * XW + j0 - cj0) * xps + c8 * 8;
        const int8_t* c01 = xs + ((i0 - ci0) * XW + j1 - cj0) * xps + c8 * 8;
        const int8_t* c10 = xs + ((i1 - ci0) * XW + j0 - cj0) * xps + c8 * 8;
        const int8_t* c11 = xs + ((i1 - ci0) * XW + j1 - cj0) * xps + c8 * 8;
        auto deq = [&](int8_t q) {  // the float tail's bf16 input
          return __bfloat162float(__float2bfloat16_rn(__fmul_rn(static_cast<float>(q), sx)));
        };
        float val[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float a = __fadd_rn(__fmul_rn(wy0, deq(c00[e])), __fmul_rn(wy1, deq(c10[e])));
          const float d = __fadd_rn(__fmul_rn(wy0, deq(c01[e])), __fmul_rn(wy1, deq(c11[e])));
          val[e] = __fadd_rn(__fmul_rn(wx0, a), __fmul_rn(wx1, d));
        }
        v = make_uint4(pack_bf16x2(val[0], val[1]), pack_bf16x2(val[2], val[3]),
                       pack_bf16x2(val[4], val[5]), pack_bf16x2(val[6], val[7]));
      }
      *reinterpret_cast<uint4*>(us + p * pb + c8 * 16) = v;
    }
  }
  __syncthreads();
  {  // conv0 -> y0 (from (ry0 - 2, rx0 - 2))
    const int ow = uw - 2, M = (uh - 2) * ow;
    for (int m0 = warp * 16 * MT; m0 < M; m0 += WARPS * 16 * MT) {
      float acc[MT][NT][4];
      border_conv0<NT>(cpi, acc, smem_addr(us), uw, ow, M, m0, smem_addr(smem + L.bw0), lane);
      store_bn_relu<NT>(acc, y0s, M, m0, ow, ry0 - 2, rx0 - 2, H, W, fps, fps + Cp, lane);
    }
  }
  __syncthreads();
  {  // conv1 -> y1 in the upsample's bytes (from (ry0 - 1, rx0 - 1))
    const int ow = uw - 4, M = (uh - 4) * ow;
    for (int m0 = warp * 16 * MT; m0 < M; m0 += WARPS * 16 * MT) {
      float acc[MT][NT][4];
      conv3x3<CPB, NT>(acc, smem_addr(y0s), uw - 2, ow, M, m0, smem_addr(smem + L.bw1), lane);
      store_bn_relu<NT>(acc, us, M, m0, ow, ry0 - 1, rx0 - 1, H, W, fps + 2 * Cp, fps + 3 * Cp,
                        lane);
    }
  }
  __syncthreads();
  {  // the head: column 0 of the 8-wide product is the logit
    const int ow = rx1 - rx0, M = (ry1 - ry0) * ow;
    const int g = lane >> 2, t = lane & 3;
    const float bh = fps[4 * Cp];
    for (int m0 = warp * 16 * MT; m0 < M; m0 += WARPS * 16 * MT) {
      float acc[MT][1][4];
      conv3x3<CPB, 1>(acc, smem_addr(us), uw - 4, ow, M, m0, smem_addr(smem + L.bwh), lane);
      if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = m0 + 16 * mt + g + 8 * half;
            if (m < M)
              outb[(size_t)(ry0 + m / ow) * W + rx0 + m % ow] =
                  __float2bfloat16_rn(__fadd_rn(acc[mt][0][2 * half], bh));
          }
      }
    }
  }
  __syncthreads();  // the next band (or tile) reuses the buffers
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// x: logical (B, h, w, Ci) float32, bf16 or int8 (in_dtype 0, 1, 2) with
// element strides sb, sh, sw, sc. w0q [ksteps(cpi)][4 Cp][32], w1q
// [ksteps(cp)][Cp][32], whq [ksteps(cp)][8][32] int8, half h of the
// contraction at bytes 16 (h % 2) of step h / 2. fp float32: g0 (4 Cp: the
// dequant scale of parity * Cp + channel), b0, g1, b1 (Cp each), then gh, bh,
// 1 / s_mid, 1 / s_head. With a bf16 output (BORDER): bw0, bw1, bwh, bfp, the
// float tail's operands as ops/cuda_tail.py::pack_tail_weights lays them out.
// out (B, 2h, 2w). Cip = 16 cpi >= Ci, Cp = 16 CPB >= C; padded channels have
// zero weights, scales and shifts.
template <typename T, int CPB>
__global__ void __launch_bounds__(THREADS, 2)
tail_q_kernel(const void* __restrict__ x, int in_dtype, long long sb, long long sh, long long sw,
              long long sc, int vec, float inv, float sx, const int8_t* __restrict__ w0q,
              const int8_t* __restrict__ w1q, const int8_t* __restrict__ whq,
              const float* __restrict__ fp, const __nv_bfloat16* __restrict__ bw0,
              const __nv_bfloat16* __restrict__ bw1, const __nv_bfloat16* __restrict__ bwh,
              const float* __restrict__ bfp, T* __restrict__ out, int B, int h, int w, int Ci,
              int cpi) {
  constexpr bool BORDER_IN = std::is_same<T, __nv_bfloat16>::value;
  constexpr int Cp = 16 * CPB;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(cpi, CPB, BORDER_IN);
  float* fps = reinterpret_cast<float*>(smem + L.fp);
  const int8_t* w0s = reinterpret_cast<const int8_t*>(smem + L.w0);
  const int8_t* w1s = reinterpret_cast<const int8_t*>(smem + L.w1);
  const int8_t* whs = reinterpret_cast<const int8_t*>(smem + L.wh);
  int8_t* xs = reinterpret_cast<int8_t*>(smem + L.xs);
  int8_t* y0 = reinterpret_cast<int8_t*>(smem + L.act);
  int8_t* y1 = reinterpret_cast<int8_t*>(smem + L.y1);
  const int xps = pix_stride(16 * cpi), yps = pix_stride(Cp);
  const int ks0 = ksteps(cpi);
  constexpr int KS1 = ksteps(CPB);
  constexpr bool BREG = CPB == 1;  // conv1's and the head's B fragments in registers

  const int H = 2 * h, W = 2 * w;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = tiles_x * tiles_y * B;

  // ---- once per block: parameters, weights (halves swapped in rows with bit
  // 2 set)
  for (int i = tid; i < 7 * Cp + 4; i += THREADS) fps[i] = fp[i];
  {
    const int n0 = ks0 * 4 * Cp * 2, n1 = KS1 * Cp * 2, nh = KS1 * 8 * 2;  // 16-byte chunks
    for (int i = tid; i < n0 + n1 + nh; i += THREADS) {
      const int8_t* src;
      int dst_off, j;
      if (i < n0) {
        src = w0q; dst_off = L.w0; j = i;
      } else if (i < n0 + n1) {
        src = w1q; dst_off = L.w1; j = i - n0;
      } else {
        src = whq; dst_off = L.wh; j = i - n0 - n1;
      }
      const int row = j / 2, half = j & 1;
      const int pos = half ^ ((row >> 2) & 1);
      *reinterpret_cast<uint4*>(smem + dst_off + row * 32 + pos * 16) =
          reinterpret_cast<const uint4*>(src)[j];
    }
  }
  if constexpr (BORDER_IN) {
    for (int i = tid; i < 4 * Cp + 1; i += THREADS)
      reinterpret_cast<float*>(smem + L.bfp)[i] = bfp[i];
    const int n0 = (L.bw1 - L.bw0) / 16, n1 = (L.bwh - L.bw1) / 16, nh = 9 * CPB * 8 * WROW / 16;
    uint4* dst = reinterpret_cast<uint4*>(smem + L.bw0);  // bw0, bw1, bwh lie back to back
    for (int i = tid; i < n0 + n1 + nh; i += THREADS)
      dst[i] = i < n0        ? reinterpret_cast<const uint4*>(bw0)[i]
               : i < n0 + n1 ? reinterpret_cast<const uint4*>(bw1)[i - n0]
                             : reinterpret_cast<const uint4*>(bwh)[i - n0 - n1];
  }
  __syncthreads();
  BFrags<Cp / 8, KS1> b1reg;  // conv1's and the head's B fragments (BREG)
  BFrags<1, KS1> bhreg;
  if constexpr (BREG) {
    load_b(b1reg, w1s, Cp, 0, lane);
    load_b(bhreg, whs, 8, 0, lane);
  }
  const float* g0 = fps;
  const float* b0 = fps + 4 * Cp;
  const float* g1 = fps + 5 * Cp;
  const float* b1 = fps + 6 * Cp;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_x * tiles_y);
    const int rest = tile - b * tiles_x * tiles_y;
    const int ty0 = (rest / tiles_x) * TH, tx0 = (rest % tiles_x) * TW;  // both even
    const int ci0 = ty0 / 2 - 2, cj0 = tx0 / 2 - 2;
    __syncthreads();  // the last tile's conv0 (and border) no longer read xs
    if (skip(SKIP_FILL)) {
    } else if (in_dtype == 0)
      fill_cells<float>(xs, xps, static_cast<const float*>(x) + b * sb, sh, sw, sc, inv, h, w, Ci,
                        cpi, ci0, cj0, vec);
    else if (in_dtype == 1)
      fill_cells<__nv_bfloat16>(xs, xps, static_cast<const __nv_bfloat16*>(x) + b * sb, sh, sw, sc,
                                inv, h, w, Ci, cpi, ci0, cj0, vec);
    else
      fill_cells<int8_t>(xs, xps, static_cast<const int8_t*>(x) + b * sb, sh, sw, sc, inv, h, w,
                         Ci, cpi, ci0, cj0, vec);
    __syncthreads();

    const float inv_mid = fps[7 * Cp + 2], inv_head = fps[7 * Cp + 3];

    // ---- conv0 (upsample composed in) on the input's grid: cell (r, c) of
    // the C0H x C0W region gives the four full-resolution pixels (2r + py, 2c
    // + px) of y0, requantized with 1 / s_mid; zero outside the image (conv1's
    // padding). An item is a 16-cell M tile and half of the 4 Cp columns.
    {
      constexpr int NT = 4 * CPB, M = C0H * C0W, MTILES = (M + 15) / 16;  // half of 4 Cp / 8
      for (int item = warp; item < 2 * MTILES; item += WARPS) {
        const int m0 = (item >> 1) * 16, nh = item & 1;
        int acc[NT][4];
        switch (cpi) {  // conv0 reads B from shared memory
#define TAIL_Q_CONV0(C)                                                                        \
  case C: {                                                                                    \
    const BFrags<NT, ksteps(C)> none{};                                                        \
    conv_mma<NT, C, XW, C0W, false, SKIP_CONV0>(acc, xs, M, m0, w0s, 4 * Cp, nh * 8 * NT, none, \
                                                lane);                                         \
    break;                                                                                     \
  }
          TAIL_Q_CONV0(1) TAIL_Q_CONV0(2) TAIL_Q_CONV0(3) TAIL_Q_CONV0(4)
#undef TAIL_Q_CONV0
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = (nh * NT + nt) * 8 + 2 * t;
          const int par = n / Cp, o = n - par * Cp;
          const float2 gs = *reinterpret_cast<const float2*>(g0 + n);
          const float2 bs = *reinterpret_cast<const float2*>(b0 + o);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = m0 + g + 8 * half;
            if (m >= M) continue;
            const int r = m / C0W, c = m - r * C0W;
            const int ly = 2 * r + (par >> 1), lx = 2 * c + (par & 1);
            const int gy = ty0 - 2 + ly, gx = tx0 - 2 + lx;
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            uint32_t pair = 0u;
            if (inside && !skip(SKIP_REQUANT))
              pair = relu_code(product(acc[nt][2 * half]), gs.x, bs.x, inv_mid) |
                     relu_code(product(acc[nt][2 * half + 1]), gs.y, bs.y, inv_mid) << 8;
            *reinterpret_cast<uint16_t*>(y0 + (ly * Y0W + lx) * yps + o) = (uint16_t)pair;
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
        conv_mma<NT, CPB, Y0W, Y1W, BREG, SKIP_CONV1>(acc, y0, M, m0, w1s, Cp, 0, b1reg, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int o = nt * 8 + 2 * t;
          const float2 gs = *reinterpret_cast<const float2*>(g1 + o);
          const float2 bs = *reinterpret_cast<const float2*>(b1 + o);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = m0 + g + 8 * half;
            if (m >= M) continue;
            const int r = m / Y1W, c = m - r * Y1W;
            const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            uint32_t pair = 0u;
            if (inside && !skip(SKIP_REQUANT))
              pair = relu_code(product(acc[nt][2 * half]), gs.x, bs.x, inv_head) |
                     relu_code(product(acc[nt][2 * half + 1]), gs.y, bs.y, inv_head) << 8;
            *reinterpret_cast<uint16_t*>(y1 + (r * Y1W + c) * yps + o) = (uint16_t)pair;
          }
        }
      }
    }
    __syncthreads();

    // ---- seg head over y1: column 0 of the 8-wide product is the logit; with
    // the border in the kernel the border pixels are left to it
    {
      constexpr int M = TH * TW;
      const float gh = fps[7 * Cp], bh = fps[7 * Cp + 1];
      for (int m0 = warp * 16; m0 < M; m0 += WARPS * 16) {
        int acc[1][4];
        conv_mma<1, CPB, Y1W, TW, BREG, SKIP_HEAD>(acc, y1, M, m0, whs, 8, 0, bhreg, lane);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + g + 8 * half;
          const int gy = ty0 + m / TW, gx = tx0 + m % TW;
          const bool border = gy < BORDER || gy >= H - BORDER || gx < BORDER || gx >= W - BORDER;
          if (t == 0 && gy < H && gx < W && !(BORDER_IN && border))
            store_out(out + ((size_t)b * H + gy) * W + gx,
                      __fadd_rn(__fmul_rn(__int2float_rn(acc[0][2 * half]), gh), bh));
        }
      }
    }

    // ---- the float border: row bands across the tile, then column bands down it
    if constexpr (BORDER_IN) {
      const int ye = min(ty0 + TH, H), xe = min(tx0 + TW, W);
      const bool top = ty0 < BORDER, bottom = ye > H - BORDER;
      const bool left = tx0 < BORDER, right = xe > W - BORDER;
      if ((top || bottom || left || right) && !skip(SKIP_BORDER)) {
        __syncthreads();  // the head no longer reads y1, whose bytes the bands take
        __nv_bfloat16* outb = reinterpret_cast<__nv_bfloat16*>(out) + (size_t)b * H * W;
        int end = ty0;
        if (top) {
          end = min(ye, BORDER);
          border_band<CPB>(ty0, end, tx0, xe, smem, L, xs, xps, ci0, cj0, cpi, sx, h, w, outb);
        }
        if (bottom && max(end, H - BORDER) < ye)
          border_band<CPB>(max(max(ty0, end), H - BORDER), ye, tx0, xe, smem, L, xs, xps, ci0,
                           cj0, cpi, sx, h, w, outb);
        end = tx0;
        if (left) {
          end = min(xe, BORDER);
          border_band<CPB>(ty0, ye, tx0, end, smem, L, xs, xps, ci0, cj0, cpi, sx, h, w, outb);
        }
        if (right && max(end, W - BORDER) < xe)
          border_band<CPB>(ty0, ye, max(max(tx0, end), W - BORDER), xe, smem, L, xs, xps, ci0,
                           cj0, cpi, sx, h, w, outb);
      }
    }
  }
}

template <typename T, int CPB>
int launch(const void* x, int in_dtype, long long sb, long long sh, long long sw, long long sc,
           float inv, float sx, const void* w0q, const void* w1q, const void* whq, const void* fp,
           const void* bw0, const void* bw1, const void* bwh, const void* bfp, void* out, int B,
           int h, int w, int Ci, int cpi, cudaStream_t stream) {
  const Layout L = layout(cpi, CPB, std::is_same<T, __nv_bfloat16>::value);
  if (L.total > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tail_q_kernel<T, CPB>;
  // the attribute and the resident blocks per launch shape, asked once (one
  // card per process)
  static int configured = 0, cap_for[MAX_CPC + 1] = {0, 0, 0, 0, 0};
  cudaError_t err;
  if (L.total > configured) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = L.total;
  }
  if (cap_for[cpi] == 0) {
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, L.total)) !=
            cudaSuccess)
      return static_cast<int>(err);
    cap_for[cpi] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long ntiles = (long long)((2 * w + TW - 1) / TW) * ((2 * h + TH - 1) / TH) * B;
  const long long cap = cap_for[cpi];
  const int blocks = (int)(ntiles < cap ? ntiles : cap);
  // 16-byte loads of whole channel runs: channels innermost, every pixel's run aligned
  const int elem = in_dtype == 0 ? 4 : in_dtype == 1 ? 2 : 1;
  const long long per = 16 / elem;
  const int vec = sc == 1 && Ci % 16 == 0 && sb % per == 0 && sh % per == 0 && sw % per == 0 &&
                  reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  kernel<<<blocks, THREADS, L.total, stream>>>(
      x, in_dtype, sb, sh, sw, sc, vec, inv, sx, static_cast<const int8_t*>(w0q),
      static_cast<const int8_t*>(w1q), static_cast<const int8_t*>(whq),
      static_cast<const float*>(fp), static_cast<const __nv_bfloat16*>(bw0),
      static_cast<const __nv_bfloat16*>(bw1), static_cast<const __nv_bfloat16*>(bwh),
      static_cast<const float*>(bfp), static_cast<T*>(out), B, h, w, Ci, cpi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory a block needs with Cip and Cp channels, with the
// bf16 border (border 1) or without (not a launcher).
extern "C" int tail_q_smem_bytes_for(int Cip, int Cp, int border) {
  return layout(Cip / 16, Cp / 16, border != 0).total;
}

// The int8 tail: x (float32, bfloat16 or int8 by in_dtype 0, 1, 2) and its
// element strides (batch, row, column, channel); inv = float32(1 / s_x), sx =
// s_x; w0q, w1q, whq, fp as ops/cuda_tail.py::pack_tail_weights_q lays them
// out; with a bf16 output (out_dtype 1) bw0, bw1, bwh, bfp, the float tail's
// operands (ops/cuda_tail.py::pack_tail_weights), and the border is written
// here; with a float32 output (0) they are not read and the border is left to
// tail_border_f32_launch. Cip = 16 .. 64 a multiple of 16 >= Ci; Cp 16 or 32.
extern "C" int tail_q_launch(const void* x, long long sb, long long sh, long long sw,
                             long long sc, int in_dtype, float inv, float sx, const void* w0q,
                             const void* w1q, const void* whq, const void* fp, const void* bw0,
                             const void* bw1, const void* bwh, const void* bfp, void* out, int B,
                             int h, int w, int Ci, int Cip, int Cp, int out_dtype,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((size_t)B * h * w == 0) return 0;
  if (Cip % 16 != 0 || Cip < Ci || Cip > 16 * MAX_CPC || (Cp != 16 && Cp != 32) ||
      in_dtype < 0 || in_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpi = Cip / 16;
#define TAIL_Q_ARGS \
  x, in_dtype, sb, sh, sw, sc, inv, sx, w0q, w1q, whq, fp, bw0, bw1, bwh, bfp, out, B, h, w, Ci, \
      cpi, stream
  if (out_dtype == 1) {
    if (bw0 == nullptr || bw1 == nullptr || bwh == nullptr || bfp == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (Cp == 16) return launch<__nv_bfloat16, 1>(TAIL_Q_ARGS);
    return launch<__nv_bfloat16, 2>(TAIL_Q_ARGS);
  }
  if (out_dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Cp == 16) return launch<float, 1>(TAIL_Q_ARGS);
  return launch<float, 2>(TAIL_Q_ARGS);
#undef TAIL_Q_ARGS
}
