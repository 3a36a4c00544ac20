// Fused serving MBConv for Hopper (EfficientNet's mobile inverted bottleneck
// with squeeze-excitation, BatchNorms folded into the convs by the caller):
//   a = silu(we^T x + be)                    1x1 expand (skipped at ratio 1)
//   d = silu(depthwise_kxk(a) + bdw)         zero padding, k in {3, 5}, stride 1 or 2
//   se = sigmoid(silu(mean(d) wr + br) ws + bs)      per image and channel
//   y = wp^T (d * se) + bp (+ x)             1x1 project, optional residual
//
// Replaces the JAX package's two Pallas calls in
// human_instance_segmentation_tpu/ops/pallas_mbconv.py::fused_mbconv_chw
// (_sums_kernel :83 and _apply_kernel :99 over _expand_dw :47). What is kept
// is their idea: two passes that both recompute the cheap expand and
// depthwise conv, so the expanded tensor (6x the input's channels) never goes
// through device memory. Pass 1 (APPLY = false) writes per-tile channel sums
// of d; the wrapper adds the tiles in a fixed order and computes the tiny
// squeeze-excite products; pass 2 (APPLY = true) recomputes d, scales it and
// projects. What is not kept: the (C, H*W) flat layout with lane padding and
// column masks, the 8-aligned row slabs, and full-resolution compute for
// stride 2 (this kernel computes only the kept positions 2o + 1).
//
// Arithmetic (ops/cuda_mbconv.py's plain version follows the same rule):
// x and the folded weights are read in their dtype T (float32 or bfloat16)
// and widened; every sum is float32; a is rounded to T after its SiLU; the
// depthwise taps are multiplied and summed in float32; d stays float32 for
// the sums; d * se is rounded to T before the project; y is rounded to T
// before the residual is added (in T). So in bfloat16 both 1x1 products
// multiply bf16 operands, which the tensor cores do with float32 sums.
//
// Bound: each pass reads x once and pass 2 writes y once (the weights are a
// few KB), and that is within a factor of two of what the two SiLUs'
// exponentials take on the special-function units, which sets the bound at
// the served shapes.
//
// float32 (mbconv_kernel): one block of 256 threads per 8 x 16 tile of
// output pixels of one image, on the float32 units. The input tile with its
// halo ((8 - 1) * s + k rows) is staged once in shared memory for all Ci
// channels; the expanded channels are walked in chunks of 16: the chunk's `a`
// over the halo tile (a thread owns a position and 16 channels), its
// depthwise output (a warp owns 32 pixels of one channel, so the per-tile
// channel sum is a shuffle tree and four partial sums added in a fixed order,
// no atomics), and in pass 2 the chunk's contribution to the project sums,
// which live in shared memory for all Co. SiLU with expf and a true division.
//
// bfloat16 (mbconv_bf16_kernel): the same two passes and chunks of 16
// expanded channels, with both 1x1 products on the tensor cores (mma.sync
// m16n8k16, fragments by ldmatrix from pixel-major rows padded to an odd
// multiple of 16 bytes). The tile is 16 x 16 output pixels at stride 1 (the
// halo costs 1.27x at k3, 1.56x at k5, against 1.41x and 1.88x at 8 x 16) and
// 8 x 16 at stride 2, where the halo is already small and Co reaches 80.
//   expand: A = the staged halo tile (positions x Ci, K padded to 16), B = the
//     chunk's 16 columns of we; SiLU as x / (1 + __expf(-x)) with
//     __fdividef; `a` rounded to bf16 into shared memory, zero outside the
//     image (the depthwise conv's padding). At stride 2 the even columns of
//     the halo tile are stored before the odd ones, so the kept positions 2o +
//     1 read neighbouring words.
//   depthwise: a thread owns two channels of four vertically adjacent output
//     pixels (each `a` word read feeds up to 8 FMAs); pass 1 sums d per
//     channel in a fixed order (thread, shuffle tree, warps), pass 2 stores
//     round(d * se) pixel-major as the project's A operand.
//   project: A = that (pixels x 16 channels of the chunk), B = the chunk's
//     rows of wp; every warp keeps its pixels' sums for up to 64 (two M tiles)
//     or 128 (one M tile) output channels in registers across the chunks, so
//     nothing but y goes back to memory; wider Co is split over blocks
//     (blockIdx.z), each recomputing the expand and the depthwise conv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int TH = 8, TW = 16, TP = TH * TW;  // output tile
constexpr int THREADS = 256;
constexpr int CK = 16;   // expanded channels per chunk
constexpr int COB = 4;   // output channels per project item
constexpr int ACS = TP + 1;  // row stride of the project sums: channel-fastest reads hit 32 banks
static_assert(TP % 32 == 0 && THREADS % TP == 0, "a warp stays inside one channel");
constexpr int WPC = TP / 32;  // warps per channel in the depthwise step

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

struct Layout {  // byte offsets into dynamic shared memory
  int accs, wps, ds, wes, bes, wdws, bdws, ses, red, xs, as, total;
};

__host__ __device__ inline Layout layout(int Ci, int Co, int k, int stride, bool expand,
                                         bool apply) {
  const int IH = (TH - 1) * stride + k, IW = (TW - 1) * stride + k, IP = IH * IW;
  const int Cop = (Co + COB - 1) / COB * COB;
  Layout L;
  int o = 0;
  L.accs = o; o += apply ? (Cop * ACS * 4 + 15) / 16 * 16 : 0;
  L.wps = o;  o += apply ? CK * Cop * 4 : 0;
  L.ds = o;   o += apply ? CK * TP * 4 : 0;
  L.wes = o;  o += expand ? Ci * CK * 4 : 0;
  L.bes = o;  o += CK * 4;
  L.wdws = o; o += k * k * CK * 4;
  L.bdws = o; o += CK * 4;
  L.ses = o;  o += CK * 4;
  L.red = o;  o += CK * WPC * 4;
  L.xs = o;   o += expand ? (Ci * IP * 4 + 15) / 16 * 16 : 0;
  L.as = o;   o += (CK * IP * 4 + 15) / 16 * 16;
  L.total = o;
  return L;
}

// x (B, Ci, H, W) and out (B, Co, Ho, Wo) are read and written through their
// element strides (xst, ost: batch, channel, row, column), so a channels-last
// tensor, which is what the served encoder hands over, needs no copy; the loops
// that touch them run channel-fastest when the channel stride is 1. we (Ci, Cm)
// or null (then Cm == Ci); be (Cm); wdw (K*K, Cm); bdw (Cm); se (B, Cm), wp
// (Cm, Co), bp (Co), out: pass 2 only; partial (B, tiles, Cm) float32: pass 1
// only; these are contiguous.
struct Strides {
  long long b, c, h, w;
};

template <int K, bool APPLY>
__global__ void __launch_bounds__(THREADS)
mbconv_kernel(const float* __restrict__ x, Strides xst, const float* __restrict__ we,
              const float* __restrict__ be, const float* __restrict__ wdw,
              const float* __restrict__ bdw, const float* __restrict__ se,
              const float* __restrict__ wp, const float* __restrict__ bp, float* __restrict__ out,
              Strides ost, float* __restrict__ partial, int Ci, int Cm, int Co, int H, int W,
              int Ho, int Wo, int S, int residual) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool expand = we != nullptr;
  const Layout L = layout(Ci, Co, K, S, expand, APPLY);
  float* accs = reinterpret_cast<float*>(smem + L.accs);
  float* wps = reinterpret_cast<float*>(smem + L.wps);
  float* ds = reinterpret_cast<float*>(smem + L.ds);
  float* wes = reinterpret_cast<float*>(smem + L.wes);
  float* bes = reinterpret_cast<float*>(smem + L.bes);
  float* wdws = reinterpret_cast<float*>(smem + L.wdws);
  float* bdws = reinterpret_cast<float*>(smem + L.bdws);
  float* ses = reinterpret_cast<float*>(smem + L.ses);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* as = reinterpret_cast<float*>(smem + L.as);

  const int IH = (TH - 1) * S + K, IW = (TW - 1) * S + K, IP = IH * IW;
  const int Cop = (Co + COB - 1) / COB * COB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  // output o reads input rows o * S + (S - 1) - K/2 ... + K/2: SAME padding at
  // stride 1, and at stride 2 the positions 2o + 1 of the stride-1 map
  const int gy0 = oy0 * S + (S - 1) - K / 2, gx0 = ox0 * S + (S - 1) - K / 2;
  const float* xb = x + b * xst.b;
  const float zero = 0.0f;

  if (expand) {
    for (int i = tid; i < Ci * IP; i += THREADS) {
      int ci, p;
      if (xst.c == 1) {
        p = i / Ci; ci = i - p * Ci;
      } else {
        ci = i / IP; p = i - ci * IP;
      }
      const int gy = gy0 + p / IW, gx = gx0 + p % IW;
      xs[ci * IP + p] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                            ? xb[ci * xst.c + gy * xst.h + gx * xst.w] : zero;
    }
  }
  if (APPLY)
    for (int i = tid; i < Cop * ACS; i += THREADS) accs[i] = 0.0f;

  for (int c0 = 0; c0 < Cm; c0 += CK) {
    __syncthreads();  // the previous chunk's buffers are no longer read
    if (expand)
      for (int i = tid; i < Ci * CK; i += THREADS) {
        const int ci = i / CK, c = c0 + i % CK;
        wes[i] = c < Cm ? we[(size_t)ci * Cm + c] : 0.0f;
      }
    for (int i = tid; i < K * K * CK; i += THREADS) {
      const int tap = i / CK, c = c0 + i % CK;
      wdws[i] = c < Cm ? wdw[(size_t)tap * Cm + c] : 0.0f;
    }
    if (tid < CK) {
      const int c = c0 + tid;
      bes[tid] = (expand && c < Cm) ? be[c] : 0.0f;
      bdws[tid] = c < Cm ? bdw[c] : 0.0f;
      if (APPLY) ses[tid] = c < Cm ? se[(size_t)b * Cm + c] : 0.0f;
    }
    if (APPLY)
      for (int i = tid; i < CK * Cop; i += THREADS) {
        const int c = c0 + i / Cop, co = i % Cop;
        wps[i] = (c < Cm && co < Co) ? wp[(size_t)c * Co + co] : 0.0f;
      }
    __syncthreads();

    // ---- a = round(silu(expand)) over the halo tile, zero outside the image
    if (expand) {
      for (int p = tid; p < IP; p += THREADS) {
        float acc[CK];
#pragma unroll
        for (int c = 0; c < CK; ++c) acc[c] = 0.0f;
        for (int ci = 0; ci < Ci; ++ci) {
          const float xv = xs[ci * IP + p];
          const float4* w4 = reinterpret_cast<const float4*>(wes + ci * CK);
#pragma unroll
          for (int q = 0; q < CK / 4; ++q) {
            const float4 w = w4[q];
            acc[4 * q + 0] = fmaf(xv, w.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv, w.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv, w.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv, w.w, acc[4 * q + 3]);
          }
        }
        const int gy = gy0 + p / IW, gx = gx0 + p % IW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int c = 0; c < CK; ++c)
          as[c * IP + p] = inside ? silu(acc[c] + bes[c]) : 0.0f;
      }
    } else {
      for (int i = tid; i < CK * IP; i += THREADS) {
        int cl, p;
        if (xst.c == 1) {
          p = i / CK; cl = i - p * CK;
        } else {
          cl = i / IP; p = i - cl * IP;
        }
        const int c = c0 + cl;
        const int gy = gy0 + p / IW, gx = gx0 + p % IW;
        as[cl * IP + p] = (c < Cm && gy >= 0 && gy < H && gx >= 0 && gx < W)
                              ? xb[c * xst.c + gy * xst.h + gx * xst.w] : zero;
      }
    }
    __syncthreads();

    // ---- d = silu(depthwise + bias): item = channel * TP + pixel
    for (int i = tid; i < CK * TP; i += THREADS) {
      const int cl = i / TP, pix = i - cl * TP;
      const int py = pix / TW, px = pix - py * TW;
      const float* a = as + cl * IP + (py * S) * IW + px * S;
      float s = 0.0f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          s = fmaf(a[dy * IW + dx], wdws[(dy * K + dx) * CK + cl], s);
      const bool valid = oy0 + py < Ho && ox0 + px < Wo;
      const float d = valid ? silu(s + bdws[cl]) : 0.0f;
      if (APPLY) {
        ds[i] = d * ses[cl];
      } else {
        float v = d;  // the warp's 32 pixels of channel cl, summed in a fixed order
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[cl * WPC + warp % WPC] = v;
      }
    }
    __syncthreads();

    if (!APPLY) {
      if (tid < CK && c0 + tid < Cm) {
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < WPC; ++j) v += red[tid * WPC + j];
        const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
        partial[((size_t)b * gridDim.x * gridDim.y + tile) * Cm + c0 + tid] = v;
      }
    } else {
      // ---- project sums: item = output-channel group * TP + pixel
      for (int i = tid; i < (Cop / COB) * TP; i += THREADS) {
        const int cog = i / TP, pix = i - cog * TP, co0 = cog * COB;
        float acc[COB];
#pragma unroll
        for (int q = 0; q < COB; ++q) acc[q] = accs[(co0 + q) * ACS + pix];
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          const float dv = ds[c * TP + pix];
          const float4 w = *reinterpret_cast<const float4*>(wps + c * Cop + co0);
          acc[0] = fmaf(dv, w.x, acc[0]);
          acc[1] = fmaf(dv, w.y, acc[1]);
          acc[2] = fmaf(dv, w.z, acc[2]);
          acc[3] = fmaf(dv, w.w, acc[3]);
        }
#pragma unroll
        for (int q = 0; q < COB; ++q) accs[(co0 + q) * ACS + pix] = acc[q];
      }
    }
  }

  if (APPLY) {
    __syncthreads();
    float* ob = out + b * ost.b;
    for (int i = tid; i < Co * TP; i += THREADS) {
      int co, pix;
      if (ost.c == 1) {
        pix = i / Co; co = i - pix * Co;
      } else {
        co = i / TP; pix = i - co * TP;
      }
      const int oy = oy0 + pix / TW, ox = ox0 + pix % TW;
      if (oy >= Ho || ox >= Wo) continue;
      float y = accs[co * ACS + pix] + bp[co];
      if (residual) y += xb[co * xst.c + oy * xst.h + ox * xst.w];  // S == 1, Co == Ci
      ob[co * ost.c + oy * ost.h + ox * ost.w] = y;
    }
  }
}

template <int K, bool APPLY>
int launch(const void* x, Strides xst, const void* we, const void* be, const void* wdw,
           const void* bdw, const void* se, const void* wp, const void* bp, void* out,
           Strides ost, float* partial, int B, int Ci, int Cm, int Co, int H, int W, int S,
           int residual, cudaStream_t stream) {
  const Layout L = layout(Ci, Co, K, S, we != nullptr, APPLY);
  if (L.total > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mbconv_kernel<K, APPLY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Ho = H / S, Wo = W / S;
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B);
  mbconv_kernel<K, APPLY><<<grid, THREADS, L.total, stream>>>(
      static_cast<const float*>(x), xst, static_cast<const float*>(we),
      static_cast<const float*>(be), static_cast<const float*>(wdw), static_cast<const float*>(bdw),
      static_cast<const float*>(se), static_cast<const float*>(wp), static_cast<const float*>(bp),
      static_cast<float*>(out), ost, partial, Ci, Cm, Co, H, W, Ho, Wo, S, residual);
  return static_cast<int>(cudaGetLastError());
}

template <bool APPLY>
int launch_k(int k, const void* x, Strides xst, const void* we, const void* be, const void* wdw,
             const void* bdw, const void* se, const void* wp, const void* bp, void* out,
             Strides ost, float* partial, int B, int Ci, int Cm, int Co, int H, int W, int S,
             int residual, cudaStream_t stream) {
  if (k == 3)
    return launch<3, APPLY>(x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, partial, B, Ci, Cm, Co,
                            H, W, S, residual, stream);
  if (k == 5)
    return launch<5, APPLY>(x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, partial, B, Ci, Cm, Co,
                            H, W, S, residual, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- bfloat16 route on the tensor cores ------------------------------------

namespace bf {

using namespace hist_mma;

constexpr int TW = 16;       // output tile width; the height is 8 MT
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int CK = 16;       // expanded channels per chunk: one K step of the project
constexpr int PX = 4;        // vertically adjacent output pixels per depthwise item
constexpr int DSB = 48;      // bytes per pixel of d * se: 16 bf16 and 16 bytes of padding
constexpr int WROW = 48;     // bytes per row of the project's B operand, likewise

__device__ __forceinline__ float silu(float v) {
  return skip(512) ? v : __fdividef(v, 1.0f + __expf(-v));
}

// output channels a block keeps in registers (per warp: MT M tiles of 16 pixels)
__host__ __device__ constexpr int n_tiles(int mt) { return mt == 2 ? 8 : 16; }
// M tiles per warp: two (a 16 x 16 tile) at stride 1 unless Co > 64 in pass 2
__host__ __device__ inline int m_tiles(int stride, int Co, bool apply) {
  return stride == 1 && (!apply || Co <= 8 * n_tiles(2)) ? 2 : 1;
}
// bytes per pixel of the staged input: Ci padded to 16, then 16 bytes
__host__ __device__ inline int x_bytes(int Ci) { return (Ci + 15) / 16 * 32 + 16; }

struct Layout {  // byte offsets into dynamic shared memory
  int xs, as, ds, wes, wps, wdws, bes, bdws, ses, red, total;
};

__host__ __device__ inline Layout layout(int Ci, int k, int stride, int mt, bool expand,
                                         bool apply) {
  const int TH = 8 * mt, IH = (TH - 1) * stride + k, IW = (TW - 1) * stride + k;
  Layout L;
  int o = 0;
  L.xs = o;   o += expand ? IH * IW * x_bytes(Ci) : 0;
  L.as = o;   o += IH * IW * CK * 2;
  L.ds = o;   o += apply ? TH * TW * DSB : 0;
  L.wes = o;  o += expand ? CK * x_bytes(Ci) : 0;
  L.wps = o;  o += apply ? 8 * n_tiles(mt) * WROW : 0;
  L.wdws = o; o += k * k * CK * 4;
  L.bes = o;  o += CK * 4;
  L.bdws = o; o += CK * 4;
  L.ses = o;  o += CK * 4;
  L.red = o;  o += WARPS * CK * 4;
  L.total = o;
  return L;
}

// Pass 1 (APPLY = false): partial (B, tiles, Cm) float32 sums of d per tile.
// Pass 2: y for output channels co0 ... co0 + 8 n_tiles(MT) - 1, co0 =
// (blockIdx.z % groups) * 8 n_tiles(MT). Operands as mbconv_kernel's, bf16.
template <int K, int S, int MT, bool APPLY>
__global__ void __launch_bounds__(THREADS, 2)
mbconv_bf16_kernel(const __nv_bfloat16* __restrict__ x, Strides xst,
                   const __nv_bfloat16* __restrict__ we, const __nv_bfloat16* __restrict__ be,
                   const __nv_bfloat16* __restrict__ wdw, const __nv_bfloat16* __restrict__ bdw,
                   const __nv_bfloat16* __restrict__ se, const __nv_bfloat16* __restrict__ wp,
                   const __nv_bfloat16* __restrict__ bp, __nv_bfloat16* __restrict__ out,
                   Strides ost, float* __restrict__ partial, int Ci, int Cm, int Co, int H, int W,
                   int Ho, int Wo, int residual, int groups) {
  constexpr int TH = 8 * MT, TP = TH * TW, NT = n_tiles(MT);
  constexpr int IH = (TH - 1) * S + K, IW = (TW - 1) * S + K, IP = IH * IW;
  constexpr int HALF = (IW + 1) / 2;  // stride 2: the even columns of the halo tile come first
  constexpr int RG = TH / PX;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool expand = we != nullptr;
  const Layout L = layout(Ci, K, S, MT, expand, APPLY);
  unsigned char* xs = smem + L.xs;
  unsigned char* as = smem + L.as;
  unsigned char* ds = smem + L.ds;
  __nv_bfloat16* wes = reinterpret_cast<__nv_bfloat16*>(smem + L.wes);
  __nv_bfloat16* wps = reinterpret_cast<__nv_bfloat16*>(smem + L.wps);
  float* wdws = reinterpret_cast<float*>(smem + L.wdws);
  float* bes = reinterpret_cast<float*>(smem + L.bes);
  float* bdws = reinterpret_cast<float*>(smem + L.bdws);
  float* ses = reinterpret_cast<float*>(smem + L.ses);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int XB = x_bytes(Ci), Cip = (Ci + 15) / 16 * 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, q = lane >> 3, r = lane & 7;
  const int b = APPLY ? blockIdx.z / groups : blockIdx.z;
  const int co0 = APPLY ? (blockIdx.z % groups) * 8 * NT : 0;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int gy0 = oy0 * S + (S - 1) - K / 2, gx0 = ox0 * S + (S - 1) - K / 2;
  const __nv_bfloat16* xb = x + b * xst.b;
  // the halo tile's position p = row * IW + column lies at a_pos(p) in `as`
  auto a_pos = [&](int p) {
    const int row = p / IW, col = p - row * IW;
    return row * IW + (S == 2 ? (col & 1) * HALF + (col >> 1) : col);
  };
  const bool vec = xst.c == 1 && Ci % 8 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                   xst.w % 8 == 0 && xst.h % 8 == 0 && xst.b % 8 == 0;

  // x at halo position p, channels 8 c8 ... 8 c8 + 7 (vec) or channel ci, zero
  // outside the image and past Ci
  auto load8 = [&](int p, int c8) {
    const int gy = gy0 + p / IW, gx = gx0 + p % IW;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (8 * c8 < Ci && gy >= 0 && gy < H && gx >= 0 && gx < W && !skip(32))
      v = *reinterpret_cast<const uint4*>(xb + gy * xst.h + gx * xst.w + 8 * c8);
    return v;
  };
  auto load1 = [&](int p, int ci) {
    const int gy = gy0 + p / IW, gx = gx0 + p % IW;
    __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
    if (ci < Ci && gy >= 0 && gy < H && gx >= 0 && gx < W && !skip(32))
      v = xb[ci * xst.c + gy * xst.h + gx * xst.w];
    return v;
  };
  // channels innermost in memory: neighbouring threads take neighbouring
  // channels; else neighbouring positions
  auto where = [&](int i, int nc, int& p, int& c) {
    if (xst.c == 1) {
      p = i / nc; c = i - p * nc;
    } else {
      c = i / IP; p = i - c * IP;
    }
  };

  // ---- the input tile with its halo, all Ci channels
  if (expand) {
    if (vec) {
      const int v8 = Cip / 8;
      batched_copy<4>(IP * v8, THREADS, [&](int i) { return load8(i / v8, i % v8); },
                      [&](int i, uint4 v) {
                        *reinterpret_cast<uint4*>(xs + (i / v8) * XB + 16 * (i % v8)) = v;
                      });
    } else {
      batched_copy<8>(IP * Cip, THREADS, [&](int i) {
        int p, ci;
        where(i, Cip, p, ci);
        return load1(p, ci);
      }, [&](int i, __nv_bfloat16 v) {
        int p, ci;
        where(i, Cip, p, ci);
        reinterpret_cast<__nv_bfloat16*>(xs + p * XB)[ci] = v;
      });
    }
  }

  float acc[MT][NT][4];  // pass 2: the project sums of this warp's pixels
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;
  const int nto = APPLY ? min(NT, (Co - co0 + 7) / 8) : 0;

  for (int c0 = 0; c0 < Cm; c0 += CK) {
    __syncthreads();  // the previous chunk's buffers are no longer read
    if (expand)
      batched_copy<4>(CK * Cip, THREADS, [&](int i) {
        const int n = i % CK, ci = i / CK;  // neighbouring threads, neighbouring columns of we
        return (ci < Ci && c0 + n < Cm) ? we[(size_t)ci * Cm + c0 + n] : __float2bfloat16_rn(0.0f);
      }, [&](int i, __nv_bfloat16 v) { wes[(i % CK) * (XB / 2) + i / CK] = v; });
    batched_copy<2>(K * K * CK, THREADS, [&](int i) {
      const int tap = i / CK, c = c0 + i % CK;
      return c < Cm ? __bfloat162float(wdw[(size_t)tap * Cm + c]) : 0.0f;
    }, [&](int i, float v) { wdws[i] = v; });
    if (tid < CK) {
      const int c = c0 + tid;
      bes[tid] = (expand && c < Cm) ? __bfloat162float(be[c]) : 0.0f;
      bdws[tid] = c < Cm ? __bfloat162float(bdw[c]) : 0.0f;
      if (APPLY) ses[tid] = c < Cm ? __bfloat162float(se[(size_t)b * Cm + c]) : 0.0f;
    }
    if (APPLY)
      batched_copy<4>(CK * 8 * NT, THREADS, [&](int i) {
        const int k = i / (8 * NT), n = i - k * (8 * NT);
        const int c = c0 + k, co = co0 + n;
        return (c < Cm && co < Co) ? wp[(size_t)c * Co + co] : __float2bfloat16_rn(0.0f);
      }, [&](int i, __nv_bfloat16 v) { wps[(i % (8 * NT)) * (WROW / 2) + i / (8 * NT)] = v; });
    if (!expand) {  // a = x: the chunk's channels of the halo tile (Cm == Ci)
      if (vec) {
        batched_copy<4>(IP * 2, THREADS, [&](int i) { return load8(i / 2, c0 / 8 + i % 2); },
                        [&](int i, uint4 v) {
                          unsigned char* dst = as + a_pos(i / 2) * (CK * 2) + 16 * (i % 2);
                          *reinterpret_cast<uint4*>(dst) = v;
                        });
      } else {
        batched_copy<8>(IP * CK, THREADS, [&](int i) {
          int p, cl;
          where(i, CK, p, cl);
          return load1(p, c0 + cl);
        }, [&](int i, __nv_bfloat16 v) {
          int p, cl;
          where(i, CK, p, cl);
          reinterpret_cast<__nv_bfloat16*>(as + a_pos(p) * (CK * 2))[cl] = v;
        });
      }
    }
    __syncthreads();

    // ---- a = round(silu(we^T x + be)) over the halo tile, on the tensor cores
    if (expand) {
      const uint32_t xs_a = smem_addr(xs), wes_a = smem_addr(wes);
      const int ksteps = Cip / 16;
      for (int m0 = warp * 16; m0 < IP; m0 += WARPS * 16) {
        __syncwarp();
        float e[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        const int pa = min(m0 + r + 8 * (q & 1), IP - 1);
        for (int kk = 0; kk < (skip(64) ? 0 : ksteps); ++kk) {
          uint32_t a[4], bw[4];
          ldsm_x4(a, xs_a + pa * XB + kk * 32 + (q >> 1) * 16);
          ldsm_x4(bw, wes_a + ((q >> 1) * 8 + r) * XB + kk * 32 + (q & 1) * 16);
          mma_bf16(e[0], a, bw[0], bw[1]);
          mma_bf16(e[1], a, bw[2], bw[3]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = m0 + g + 8 * half;
          if (p >= IP) continue;
          const int gy = gy0 + p / IW, gx = gx0 + p % IW;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
          uint32_t* dst = reinterpret_cast<uint32_t*>(as + a_pos(p) * (CK * 2));
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int c = nt * 8 + 2 * t;
            const float v0 = silu(__fadd_rn(e[nt][2 * half], bes[c]));
            const float v1 = silu(__fadd_rn(e[nt][2 * half + 1], bes[c + 1]));
            dst[c / 2] = inside ? pack_bf16x2(v0, v1) : 0u;
          }
        }
      }
      __syncthreads();
    }

    // ---- d = silu(depthwise(a) + bdw): a thread owns channels 2 cp, 2 cp + 1
    // of PX vertically adjacent pixels; neighbouring lanes take neighbouring
    // channel pairs, then neighbouring columns
    float sum0 = 0.0f, sum1 = 0.0f;
    for (int it = tid; it < 8 * TW * RG; it += THREADS) {
      const int cp = it & 7, col = (it >> 3) & (TW - 1), rg = it >> 7;
      float d0[PX], d1[PX];
#pragma unroll
      for (int p = 0; p < PX; ++p) d0[p] = d1[p] = 0.0f;
#pragma unroll
      for (int dx = 0; dx < (skip(128) ? 0 : K); ++dx) {
        float2 wv[K];
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
          wv[dy] = *reinterpret_cast<const float2*>(wdws + (dy * K + dx) * CK + 2 * cp);
        const int pc = S == 2 ? (dx & 1) * HALF + col + (dx >> 1) : col + dx;
        const unsigned char* src = as + ((rg * PX * S) * IW + pc) * (CK * 2) + 4 * cp;
#pragma unroll
        for (int j = 0; j < (PX - 1) * S + K; ++j) {
          const float2 v = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(src + j * IW * CK * 2));
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const int dy = j - p * S;
            if (dy >= 0 && dy < K) {
              d0[p] = fmaf(v.x, wv[dy].x, d0[p]);
              d1[p] = fmaf(v.y, wv[dy].y, d1[p]);
            }
          }
        }
      }
      const float bd0 = bdws[2 * cp], bd1 = bdws[2 * cp + 1];
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int py = rg * PX + p;
        const bool valid = oy0 + py < Ho && ox0 + col < Wo;
        const float v0 = valid ? silu(__fadd_rn(d0[p], bd0)) : 0.0f;
        const float v1 = valid ? silu(__fadd_rn(d1[p], bd1)) : 0.0f;
        if (APPLY) {
          *reinterpret_cast<uint32_t*>(ds + (py * TW + col) * DSB + 4 * cp) =
              pack_bf16x2(__fmul_rn(v0, ses[2 * cp]), __fmul_rn(v1, ses[2 * cp + 1]));
        } else {
          sum0 += v0;
          sum1 += v1;
        }
      }
    }

    if (!APPLY) {  // lanes cp, cp + 8, cp + 16, cp + 24 hold channel pair cp
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 8);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 8);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 16);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 16);
      if (lane < 8) {
        red[warp * CK + 2 * lane] = sum0;
        red[warp * CK + 2 * lane + 1] = sum1;
      }
      __syncthreads();
      if (tid < CK && c0 + tid < Cm) {
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < WARPS; ++j) v += red[j * CK + tid];
        const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
        partial[((size_t)b * gridDim.x * gridDim.y + tile) * Cm + c0 + tid] = v;
      }
    } else {
      __syncthreads();  // d * se complete
      // ---- project: acc += (d * se) (pixels x 16) * wp rows (16 x Co)
      const uint32_t ds_a = smem_addr(ds), wps_a = smem_addr(wps);
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], ds_a + ((warp * MT + mt) * 16 + r + 8 * (q & 1)) * DSB + (q >> 1) * 16);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        if (nt < nto && !skip(256)) {
          uint32_t bw[4];
          ldsm_x4(bw, wps_a + (nt * 8 + (q >> 1) * 8 + r) * WROW + (q & 1) * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][nt], a[mt], bw[0], bw[1]);
            mma_bf16(acc[mt][nt + 1], a[mt], bw[2], bw[3]);
          }
        }
      }
    }
  }

  if (APPLY) {  // y = round(acc + bp) (+ x), through the output's strides
    __nv_bfloat16* ob = out + b * ost.b;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pix = (warp * MT + mt) * 16 + g + 8 * half;
        const int oy = oy0 + pix / TW, ox = ox0 + pix % TW;
        if (oy >= Ho || ox >= Wo) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int co = co0 + nt * 8 + 2 * t + j;
            if (nt >= nto || co >= Co) continue;
            float y = __bfloat162float(__float2bfloat16_rn(
                __fadd_rn(acc[mt][nt][2 * half + j], __bfloat162float(bp[co]))));
            if (residual)  // S == 1, Co == Ci
              y = __fadd_rn(y, __bfloat162float(xb[co * xst.c + oy * xst.h + ox * xst.w]));
            ob[co * ost.c + oy * ost.h + ox * ost.w] = __float2bfloat16_rn(y);
          }
      }
  }
}

template <int K, int S, int MT, bool APPLY>
int launch(const void* x, Strides xst, const void* we, const void* be, const void* wdw,
           const void* bdw, const void* se, const void* wp, const void* bp, void* out,
           Strides ost, float* partial, int B, int Ci, int Cm, int Co, int H, int W,
           int residual, cudaStream_t stream) {
  const Layout L = layout(Ci, K, S, MT, we != nullptr, APPLY);
  if (L.total > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mbconv_bf16_kernel<K, S, MT, APPLY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Ho = H / S, Wo = W / S, TH = 8 * MT;
  const int groups = APPLY ? (Co + 8 * n_tiles(MT) - 1) / (8 * n_tiles(MT)) : 1;
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B * groups);
  using bf16 = __nv_bfloat16;
  mbconv_bf16_kernel<K, S, MT, APPLY><<<grid, THREADS, L.total, stream>>>(
      static_cast<const bf16*>(x), xst, static_cast<const bf16*>(we), static_cast<const bf16*>(be),
      static_cast<const bf16*>(wdw), static_cast<const bf16*>(bdw), static_cast<const bf16*>(se),
      static_cast<const bf16*>(wp), static_cast<const bf16*>(bp), static_cast<bf16*>(out), ost,
      partial, Ci, Cm, Co, H, W, Ho, Wo, residual, groups);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_s(int stride, int apply, const void* x, Strides xst, const void* we, const void* be,
             const void* wdw, const void* bdw, const void* se, const void* wp, const void* bp,
             void* out, Strides ost, float* partial, int B, int Ci, int Cm, int Co, int H, int W,
             int residual, cudaStream_t stream) {
  const int mt = m_tiles(stride, Co, apply != 0);
#define HIST_MBCONV_LAUNCH(S_, MT_, APPLY_)                                                    \
  return launch<K, S_, MT_, APPLY_>(x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, partial, B, \
                                    Ci, Cm, Co, H, W, residual, stream)
  if (stride == 1) {
    if (!apply) HIST_MBCONV_LAUNCH(1, 2, false);
    if (mt == 2) HIST_MBCONV_LAUNCH(1, 2, true);
    HIST_MBCONV_LAUNCH(1, 1, true);
  }
  if (!apply) HIST_MBCONV_LAUNCH(2, 1, false);
  HIST_MBCONV_LAUNCH(2, 1, true);
#undef HIST_MBCONV_LAUNCH
}

}  // namespace bf

}  // namespace

// Bytes of shared memory a block needs (not a launcher); elem is the size of x's
// element (4 float32, 2 bfloat16).
extern "C" int mbconv_smem_bytes_for(int Ci, int Co, int k, int stride, int elem, int expand,
                                     int apply) {
  if (elem == 2)
    return bf::layout(Ci, k, stride, bf::m_tiles(stride, Co, apply != 0), expand != 0,
                      apply != 0).total;
  return layout(Ci, Co, k, stride, expand != 0, apply != 0).total;
}

// Tiles per image of the (H / stride, W / stride) output in pass 1: the
// middle extent of its partial sums (not a launcher); elem as above.
extern "C" int mbconv_tiles_for(int Ho, int Wo, int stride, int elem) {
  const int th = elem == 2 ? 8 * bf::m_tiles(stride, 0, false) : TH;
  return ((Wo + TW - 1) / TW) * ((Ho + th - 1) / th);
}

// Pass 1 (apply == 0) writes partial; pass 2 (apply == 1) reads se and writes
// out. x and out come with their element strides (batch, channel, row,
// column). we and be are null at expand ratio 1. dtype 0 float32, 1 bfloat16.
extern "C" int mbconv_launch(const void* x, long long xsb, long long xsc, long long xsh,
                             long long xsw, const void* we, const void* be, const void* wdw,
                             const void* bdw, const void* se, const void* wp, const void* bp,
                             void* out, long long osb, long long osc, long long osh,
                             long long osw, void* partial, int B, int Ci, int Cm, int Co, int H,
                             int W, int k, int stride, int residual, int apply, int dtype,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((size_t)B * Cm * (H / stride) * (W / stride) == 0) return 0;
  if (stride != 1 && stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  float* part = static_cast<float*>(partial);
  const Strides xst{xsb, xsc, xsh, xsw}, ost{osb, osc, osh, osw};
  if (dtype == 1) {
    if (k == 3)
      return bf::launch_s<3>(stride, apply, x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, part,
                             B, Ci, Cm, Co, H, W, residual, stream);
    if (k == 5)
      return bf::launch_s<5>(stride, apply, x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, part,
                             B, Ci, Cm, Co, H, W, residual, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (apply)
    return launch_k<true>(k, x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, part, B, Ci, Cm, Co,
                          H, W, stride, residual, stream);
  return launch_k<false>(k, x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, part, B, Ci, Cm, Co, H,
                         W, stride, residual, stream);
}
