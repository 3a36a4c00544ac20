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
// before the residual is added (in T). expf and the division keep full
// precision.
//
// Design: one block of 256 threads per 8 x 16 tile of output pixels of one
// image. The input tile with its halo ((8 - 1) * s + k rows) is staged once
// in shared memory for all Ci channels; the expanded channels are walked in
// chunks of 16: the chunk's `a` over the halo tile (a thread owns a position
// and 16 channels, weights as broadcast float4 loads), its depthwise output
// (a warp owns 32 pixels of one channel, so the per-tile channel sum is a
// shuffle tree and four partial sums added in a fixed order, no atomics), and
// in pass 2 the chunk's contribution to the project sums, which live in shared
// memory for all Co (a thread owns a pixel and 4 output channels). Channel
// counts are free: a partial chunk meets zero weights.
//
// Bound: each pass reads x once and pass 2 writes y once (the weights are a
// few KB), and that is within a factor of two of what the two SiLUs'
// exponentials take on the special-function units, which sets the bound at
// the served shapes. This kernel is far from either: it runs 2 * (Ci + k*k +
// Co) * Cm operations per output pixel and pass on the float32 units, with
// the halo's expand on top, and a full-precision SiLU per expanded value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TH = 8, TW = 16, TP = TH * TW;  // output tile
constexpr int THREADS = 256;
constexpr int CK = 16;   // expanded channels per chunk
constexpr int COB = 4;   // output channels per project item
constexpr int ACS = TP + 1;  // row stride of the project sums: channel-fastest reads hit 32 banks
static_assert(TP % 32 == 0 && THREADS % TP == 0, "a warp stays inside one channel");
constexpr int WPC = TP / 32;  // warps per channel in the depthwise step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  T t;
  from_f(t, v);
  return to_f(t);
}
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

struct Layout {  // byte offsets into dynamic shared memory
  int accs, wps, ds, wes, bes, wdws, bdws, ses, red, xs, as, total;
};

__host__ __device__ inline Layout layout(int Ci, int Co, int k, int stride, int elem, bool expand,
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
  L.xs = o;   o += expand ? (Ci * IP * elem + 15) / 16 * 16 : 0;
  L.as = o;   o += (CK * IP * elem + 15) / 16 * 16;
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

template <typename T, int K, bool APPLY>
__global__ void __launch_bounds__(THREADS)
mbconv_kernel(const T* __restrict__ x, Strides xst, const T* __restrict__ we,
              const T* __restrict__ be, const T* __restrict__ wdw, const T* __restrict__ bdw,
              const T* __restrict__ se, const T* __restrict__ wp, const T* __restrict__ bp,
              T* __restrict__ out, Strides ost, float* __restrict__ partial, int Ci, int Cm,
              int Co, int H, int W, int Ho, int Wo, int S, int residual) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool expand = we != nullptr;
  const Layout L = layout(Ci, Co, K, S, (int)sizeof(T), expand, APPLY);
  float* accs = reinterpret_cast<float*>(smem + L.accs);
  float* wps = reinterpret_cast<float*>(smem + L.wps);
  float* ds = reinterpret_cast<float*>(smem + L.ds);
  float* wes = reinterpret_cast<float*>(smem + L.wes);
  float* bes = reinterpret_cast<float*>(smem + L.bes);
  float* wdws = reinterpret_cast<float*>(smem + L.wdws);
  float* bdws = reinterpret_cast<float*>(smem + L.bdws);
  float* ses = reinterpret_cast<float*>(smem + L.ses);
  float* red = reinterpret_cast<float*>(smem + L.red);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* as = reinterpret_cast<T*>(smem + L.as);

  const int IH = (TH - 1) * S + K, IW = (TW - 1) * S + K, IP = IH * IW;
  const int Cop = (Co + COB - 1) / COB * COB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  // output o reads input rows o * S + (S - 1) - K/2 ... + K/2: SAME padding at
  // stride 1, and at stride 2 the positions 2o + 1 of the stride-1 map
  const int gy0 = oy0 * S + (S - 1) - K / 2, gx0 = ox0 * S + (S - 1) - K / 2;
  const T* xb = x + b * xst.b;
  T zero;
  from_f(zero, 0.0f);

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
        wes[i] = c < Cm ? to_f(we[(size_t)ci * Cm + c]) : 0.0f;
      }
    for (int i = tid; i < K * K * CK; i += THREADS) {
      const int tap = i / CK, c = c0 + i % CK;
      wdws[i] = c < Cm ? to_f(wdw[(size_t)tap * Cm + c]) : 0.0f;
    }
    if (tid < CK) {
      const int c = c0 + tid;
      bes[tid] = (expand && c < Cm) ? to_f(be[c]) : 0.0f;
      bdws[tid] = c < Cm ? to_f(bdw[c]) : 0.0f;
      if (APPLY) ses[tid] = c < Cm ? to_f(se[(size_t)b * Cm + c]) : 0.0f;
    }
    if (APPLY)
      for (int i = tid; i < CK * Cop; i += THREADS) {
        const int c = c0 + i / Cop, co = i % Cop;
        wps[i] = (c < Cm && co < Co) ? to_f(wp[(size_t)c * Co + co]) : 0.0f;
      }
    __syncthreads();

    // ---- a = round(silu(expand)) over the halo tile, zero outside the image
    if (expand) {
      for (int p = tid; p < IP; p += THREADS) {
        float acc[CK];
#pragma unroll
        for (int c = 0; c < CK; ++c) acc[c] = 0.0f;
        for (int ci = 0; ci < Ci; ++ci) {
          const float xv = to_f(xs[ci * IP + p]);
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
          from_f(as[c * IP + p], inside ? silu(acc[c] + bes[c]) : 0.0f);
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
      const T* a = as + cl * IP + (py * S) * IW + px * S;
      float s = 0.0f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          s = fmaf(to_f(a[dy * IW + dx]), wdws[(dy * K + dx) * CK + cl], s);
      const bool valid = oy0 + py < Ho && ox0 + px < Wo;
      const float d = valid ? silu(s + bdws[cl]) : 0.0f;
      if (APPLY) {
        ds[i] = round_to<T>(d * ses[cl]);
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
    T* ob = out + b * ost.b;
    for (int i = tid; i < Co * TP; i += THREADS) {
      int co, pix;
      if (ost.c == 1) {
        pix = i / Co; co = i - pix * Co;
      } else {
        co = i / TP; pix = i - co * TP;
      }
      const int oy = oy0 + pix / TW, ox = ox0 + pix % TW;
      if (oy >= Ho || ox >= Wo) continue;
      float y = round_to<T>(accs[co * ACS + pix] + to_f(bp[co]));
      if (residual) y += to_f(xb[co * xst.c + oy * xst.h + ox * xst.w]);  // S == 1, Co == Ci
      from_f(ob[co * ost.c + oy * ost.h + ox * ost.w], y);
    }
  }
}

template <typename T, int K, bool APPLY>
int launch(const void* x, Strides xst, const void* we, const void* be, const void* wdw,
           const void* bdw, const void* se, const void* wp, const void* bp, void* out,
           Strides ost, float* partial, int B, int Ci, int Cm, int Co, int H, int W, int S,
           int residual, cudaStream_t stream) {
  const Layout L = layout(Ci, Co, K, S, (int)sizeof(T), we != nullptr, APPLY);
  if (L.total > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mbconv_kernel<T, K, APPLY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Ho = H / S, Wo = W / S;
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B);
  mbconv_kernel<T, K, APPLY><<<grid, THREADS, L.total, stream>>>(
      static_cast<const T*>(x), xst, static_cast<const T*>(we), static_cast<const T*>(be),
      static_cast<const T*>(wdw), static_cast<const T*>(bdw), static_cast<const T*>(se),
      static_cast<const T*>(wp), static_cast<const T*>(bp), static_cast<T*>(out), ost, partial, Ci,
      Cm, Co, H, W, Ho, Wo, S, residual);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool APPLY>
int launch_k(int k, const void* x, Strides xst, const void* we, const void* be, const void* wdw,
             const void* bdw, const void* se, const void* wp, const void* bp, void* out,
             Strides ost, float* partial, int B, int Ci, int Cm, int Co, int H, int W, int S,
             int residual, cudaStream_t stream) {
  if (k == 3)
    return launch<T, 3, APPLY>(x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, partial, B, Ci, Cm,
                               Co, H, W, S, residual, stream);
  if (k == 5)
    return launch<T, 5, APPLY>(x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, partial, B, Ci, Cm,
                               Co, H, W, S, residual, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Bytes of shared memory a block needs (not a launcher); elem is sizeof(T).
extern "C" int mbconv_smem_bytes_for(int Ci, int Co, int k, int stride, int elem, int expand,
                                     int apply) {
  return layout(Ci, Co, k, stride, elem, expand != 0, apply != 0).total;
}

// Tiles per image of the (H / stride, W / stride) output: the middle extent
// of pass 1's partial sums (not a launcher).
extern "C" int mbconv_tiles_for(int Ho, int Wo) {
  return ((Wo + TW - 1) / TW) * ((Ho + TH - 1) / TH);
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
    if (apply)
      return launch_k<__nv_bfloat16, true>(k, x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, part,
                                           B, Ci, Cm, Co, H, W, stride, residual, stream);
    return launch_k<__nv_bfloat16, false>(k, x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, part,
                                          B, Ci, Cm, Co, H, W, stride, residual, stream);
  }
  if (apply)
    return launch_k<float, true>(k, x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, part, B, Ci,
                                 Cm, Co, H, W, stride, residual, stream);
  return launch_k<float, false>(k, x, xst, we, be, wdw, bdw, se, wp, bp, out, ost, part, B, Ci, Cm,
                                Co, H, W, stride, residual, stream);
}
