// Fused stage-1 tail for Hopper: the last decoder block of the people-seg
// UNet and its 3x3 seg head in one launch,
//   2x half-pixel bilinear upsample (edge-clamped) -> conv3x3 -> BN -> ReLU
//   -> conv3x3 -> BN -> ReLU -> conv3x3 + bias -> dense (B, H, W) logits.
//
// Replaces the JAX package's Pallas kernel
// human_instance_segmentation_tpu/ops/pallas_tail.py::tail_with_borders
// (_tail_kernel :138-255). That kernel takes its input in space-to-depth
// form, runs per-phase matmuls with one-hot permutations and recomputes the
// outer six rows and columns outside the kernel. None of that comes along:
// this kernel reads the plain decoder output (any strides, so an NCHW
// tensor viewed as NHWC needs no copy), clamps the upsample at the image
// edge itself and zero-pads each conv's full-resolution input by global
// coordinate, so one launch gives the whole map.
//
// Arithmetic (the plain version, ops/cuda_tail.py::tail_plain, does the
// same): inputs and weights are read in their dtype (float32 or bfloat16)
// and widened; everything in between is float32 (upsample with separate
// multiplies and adds, rows first; conv sums; BN as one scale and shift per
// channel, folded by the wrapper); the logit is rounded once to the input's
// dtype on store.
//
// Design: one block per TH x TW output tile. Shared memory holds the
// upsampled input with a 3-pixel halo for IC input channels at a time as
// channel planes (the input channels are walked in chunks, the conv0 sums
// stay in registers), then conv0's output with a 2-pixel halo, conv1's with
// a 1-pixel halo, and the weights. A thread owns PX vertically adjacent
// pixels of one column and OC output channels: PX + 2 shared-memory loads of
// a column feed 3 taps x PX pixels x OC FMAs, the weights come as broadcast
// float4 loads. The kernel is bound by latency more than by issue slots:
// PX = 2 with 384 threads (24 warps an SM) ran 20% faster than PX = 4 with
// 192 on the H100. Channel counts are padded to OC by the wrapper (zero
// weights), so Ci and C are free; the launcher refuses what does not fit
// shared memory.
//
// Bound: operations. 2 * 9 * (Ci*C + C*C + C) FLOP per output pixel
// (14,112 at Ci 32, C 16) against 2*Ci/4 + 2 bytes (bf16); this kernel runs
// them on the float32 units, not the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TH = 16, TW = 32;       // output tile
constexpr int THREADS = 384;
constexpr int IC = 8;                 // input channels per conv0 chunk
constexpr int OC = 16;                // output channels per thread
constexpr int PX = 2;                 // rows per thread
constexpr int UH = TH + 6, UW = TW + 6;          // upsampled tile, halo 3
constexpr int Y0H = TH + 4, Y0W = TW + 4;        // conv0 output, halo 2
constexpr int Y0H_ALLOC = Y0H + 2;               // a partial last row group of conv1 reads past Y0H
constexpr int Y1H = TH + 2, Y1W = TW + 2;        // conv1 output, halo 1
constexpr int Y1G = (Y1H + PX - 1) / PX;         // conv1 row groups (the last may be partial)
static_assert(Y0H % PX == 0 && TH % PX == 0, "row groups");
static_assert(Y1G * PX + 2 <= Y0H_ALLOC, "conv1 reads stay inside y0");
static_assert((Y0H / PX) * Y0W <= THREADS && Y1G * Y1W <= THREADS, "one item per thread");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

// acc[p][o] += sum over ci < nci, 3x3 taps of src[ci][(row0 + p + dy) * srcw + col + dx]
//                                            * wgt[((dy * 3 + dx) * nci + ci) * wstride + o]
__device__ __forceinline__ void conv_accumulate(float (&acc)[PX][OC], const float* __restrict__ src,
                                                int plane, int srcw, int row0, int col,
                                                const float* __restrict__ wgt, int wstride,
                                                int nci) {
  for (int ci = 0; ci < nci; ++ci) {
    const float* s = src + ci * plane + row0 * srcw + col;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float v[PX + 2];
#pragma unroll
      for (int j = 0; j < PX + 2; ++j) v[j] = s[j * srcw + dx];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float4* w4 =
            reinterpret_cast<const float4*>(wgt + ((dy * 3 + dx) * nci + ci) * wstride);
#pragma unroll
        for (int q = 0; q < OC / 4; ++q) {
          const float4 w = w4[q];
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            acc[p][4 * q + 0] = fmaf(v[p + dy], w.x, acc[p][4 * q + 0]);
            acc[p][4 * q + 1] = fmaf(v[p + dy], w.y, acc[p][4 * q + 1]);
            acc[p][4 * q + 2] = fmaf(v[p + dy], w.z, acc[p][4 * q + 2]);
            acc[p][4 * q + 3] = fmaf(v[p + dy], w.w, acc[p][4 * q + 3]);
          }
        }
      }
    }
  }
}

// x: logical (B, h, w, Ci) with element strides sb, sh, sw, sc.
// w0: (9, Cip, Cp) float32, Cip a multiple of IC and Cp of OC, zero beyond
// the real channels; st0/st1: (2, Cp) scale then shift; w1: (9, Cp, Cp);
// wh: (9, Cp); bh: (1,) float32; out: (B, 2h, 2w) contiguous.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
tail_kernel(const T* __restrict__ x, long long sb, long long sh, long long sw, long long sc,
            const float* __restrict__ w0, const float* __restrict__ st0,
            const float* __restrict__ w1, const float* __restrict__ st1,
            const float* __restrict__ wh, const float* __restrict__ bh, T* __restrict__ out,
            int h, int w, int Ci, int Cip, int Cp) {
  extern __shared__ __align__(16) float smem[];
  const int H = 2 * h, W = 2 * w;
  // bufA: the upsampled chunk and its conv0 weights, later conv1's output
  float* u = smem;                               // IC x UH x UW
  float* w0c = smem + IC * UH * UW;              // 9 x IC x OC
  float* y1 = smem;                              // Cp x Y1H x Y1W
  const int sizeA = max(IC * UH * UW + 9 * IC * OC, Cp * Y1H * Y1W);
  float* y0 = smem + sizeA;                      // Cp x Y0H_ALLOC x Y0W
  float* w1s = y0 + Cp * Y0H_ALLOC * Y0W;        // 9 x Cp x Cp
  float* whs = w1s + 9 * Cp * Cp;                // 9 x Cp
  float* sts = whs + 9 * Cp;                     // st0 (2 x Cp), st1 (2 x Cp)

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const T* xb = x + (long long)b * sb;

  for (int i = tid; i < 9 * Cp * Cp; i += THREADS) w1s[i] = w1[i];
  for (int i = tid; i < 9 * Cp; i += THREADS) whs[i] = wh[i];
  for (int i = tid; i < 2 * Cp; i += THREADS) {
    sts[i] = st0[i];
    sts[2 * Cp + i] = st1[i];
  }

  // ---- conv0 over the upsampled input, OC output channels at a time ------
  const bool item0 = tid < (Y0H / PX) * Y0W;
  const int rg0 = tid / Y0W, c0 = tid - rg0 * Y0W;
  for (int cb = 0; cb < Cp; cb += OC) {
    float acc[PX][OC];
#pragma unroll
    for (int p = 0; p < PX; ++p)
#pragma unroll
      for (int o = 0; o < OC; ++o) acc[p][o] = 0.0f;
    for (int ck = 0; ck < Cip; ck += IC) {
      __syncthreads();  // the previous chunk (or y1 of nothing yet) is no longer read
      for (int i = tid; i < IC * UH * UW; i += THREADS) {
        int cl, px;
        if (sc == 1) {  // channels innermost in memory: neighbouring threads, neighbouring channels
          cl = i % IC; px = i / IC;
        } else {        // planes: neighbouring threads, neighbouring pixels
          px = i % (UH * UW); cl = i / (UH * UW);
        }
        const int r = px / UW, c = px - r * UW;
        const int gy = ty0 - 3 + r, gx = tx0 - 3 + c;
        const int ci = ck + cl;
        float val = 0.0f;  // SAME padding of the full-resolution conv input
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Ci) {
          int i0, i1, j0, j1;
          float wy0, wy1, wx0, wx1;
          up_taps(gy, h, i0, i1, wy0, wy1);
          up_taps(gx, w, j0, j1, wx0, wx1);
          const T* xc = xb + (long long)ci * sc;
          const float a = __fadd_rn(__fmul_rn(wy0, to_f(xc[i0 * sh + j0 * sw])),
                                    __fmul_rn(wy1, to_f(xc[i1 * sh + j0 * sw])));
          const float d = __fadd_rn(__fmul_rn(wy0, to_f(xc[i0 * sh + j1 * sw])),
                                    __fmul_rn(wy1, to_f(xc[i1 * sh + j1 * sw])));
          val = __fadd_rn(__fmul_rn(wx0, a), __fmul_rn(wx1, d));
        }
        u[cl * (UH * UW) + px] = val;
      }
      for (int i = tid; i < 9 * IC * OC; i += THREADS) {
        const int o = i % OC, cl = (i / OC) % IC, tap = i / (OC * IC);
        w0c[i] = w0[((long long)tap * Cip + ck + cl) * Cp + cb + o];
      }
      __syncthreads();
      if (item0) conv_accumulate(acc, u, UH * UW, UW, rg0 * PX, c0, w0c, OC, IC);
    }
    if (item0) {
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int r = rg0 * PX + p;
        const int gy = ty0 - 2 + r, gx = tx0 - 2 + c0;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int o = 0; o < OC; ++o) {
          const float v = fmaxf(fmaf(acc[p][o], sts[cb + o], sts[Cp + cb + o]), 0.0f);
          y0[(cb + o) * (Y0H_ALLOC * Y0W) + r * Y0W + c0] = inside ? v : 0.0f;
        }
      }
    }
  }
  __syncthreads();  // y0 complete; bufA free for y1

  // ---- conv1 ---------------------------------------------------------------
  const bool item1 = tid < Y1G * Y1W;
  const int rg1 = tid / Y1W, c1 = tid - rg1 * Y1W;
  for (int cb = 0; cb < Cp; cb += OC) {
    if (!item1) break;
    float acc[PX][OC];
#pragma unroll
    for (int p = 0; p < PX; ++p)
#pragma unroll
      for (int o = 0; o < OC; ++o) acc[p][o] = 0.0f;
    conv_accumulate(acc, y0, Y0H_ALLOC * Y0W, Y0W, rg1 * PX, c1, w1s + cb, Cp, Cp);
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int r = rg1 * PX + p;
      if (r >= Y1H) continue;
      const int gy = ty0 - 1 + r, gx = tx0 - 1 + c1;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int o = 0; o < OC; ++o) {
        const float v =
            fmaxf(fmaf(acc[p][o], sts[2 * Cp + cb + o], sts[3 * Cp + cb + o]), 0.0f);
        y1[(cb + o) * (Y1H * Y1W) + r * Y1W + c1] = inside ? v : 0.0f;
      }
    }
  }
  __syncthreads();

  // ---- seg head ------------------------------------------------------------
  if (tid < (TH / PX) * TW) {
    const int rg = tid / TW, c = tid - rg * TW;
    float acc[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p) acc[p] = 0.0f;
    for (int ci = 0; ci < Cp; ++ci) {
      const float* s = y1 + ci * (Y1H * Y1W) + rg * PX * Y1W + c;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float v[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) v[j] = s[j * Y1W + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float wv = whs[(dy * 3 + dx) * Cp + ci];
#pragma unroll
          for (int p = 0; p < PX; ++p) acc[p] = fmaf(v[p + dy], wv, acc[p]);
        }
      }
    }
    const int gx = tx0 + c;
    const float bias = bh[0];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int gy = ty0 + rg * PX + p;
      if (gy < H && gx < W) store(out + ((long long)b * H + gy) * W + gx, acc[p] + bias);
    }
  }
}

size_t tail_smem_bytes(int Cp) {
  const int chunk = IC * UH * UW + 9 * IC * OC, y1 = Cp * Y1H * Y1W;
  const int sizeA = chunk > y1 ? chunk : y1;
  return sizeof(float) * ((size_t)sizeA + (size_t)Cp * Y0H_ALLOC * Y0W + 9 * (size_t)Cp * Cp +
                          9 * (size_t)Cp + 4 * (size_t)Cp);
}

template <typename T>
int launch(const void* x, long long sb, long long sh, long long sw, long long sc, const float* w0,
           const float* st0, const float* w1, const float* st1, const float* wh,
           const float* bh, void* out, int B, int h, int w, int Ci, int Cip, int Cp,
           cudaStream_t stream) {
  const size_t smem = tail_smem_bytes(Cp);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(tail_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((2 * w + TW - 1) / TW, (2 * h + TH - 1) / TH, B);
  tail_kernel<T><<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), sb, sh, sw, sc, w0,
                                                  st0, w1, st1, wh, bh, static_cast<T*>(out), h,
                                                  w, Ci, Cip, Cp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the kernel needs at padded width Cp, for the wrapper's check.
extern "C" int tail_smem_bytes_for(int Cp) { return (int)tail_smem_bytes(Cp); }

extern "C" int tail_launch(const void* x, long long sb, long long sh, long long sw, long long sc,
                           const void* w0, const void* st0, const void* w1, const void* st1,
                           const void* wh, const void* bh, void* out, int B, int h, int w, int Ci,
                           int Cip, int Cp, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((size_t)B * h * w == 0) return 0;
  if (Cip % IC != 0 || Cp % OC != 0 || Cip < Ci) return static_cast<int>(cudaErrorInvalidValue);
  const float* f0 = static_cast<const float*>(w0);
  const float* s0 = static_cast<const float*>(st0);
  const float* f1 = static_cast<const float*>(w1);
  const float* s1 = static_cast<const float*>(st1);
  const float* fh = static_cast<const float*>(wh);
  const float* fb = static_cast<const float*>(bh);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, sb, sh, sw, sc, f0, s0, f1, s1, fh, fb, out, B, h, w, Ci, Cip,
                                 Cp, stream);
  return launch<float>(x, sb, sh, sw, sc, f0, s0, f1, s1, fh, fb, out, B, h, w, Ci, Cip, Cp,
                       stream);
}
