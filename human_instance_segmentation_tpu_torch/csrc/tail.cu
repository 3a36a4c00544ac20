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
// these kernels read the plain decoder output (any strides, so an NCHW
// tensor viewed as NHWC needs no copy), clamp the upsample at the image
// edge themselves and zero-pad each conv's full-resolution input by global
// coordinate, so one launch gives the whole map.
//
// Arithmetic (the plain version, ops/cuda_tail.py::tail_plain, does the
// same). BN is one float32 scale and shift per channel (folded by the
// wrapper), applied to the float32 conv sum as a multiply, then an add, then
// the ReLU; the upsample is computed in float32, rows first, each weight a
// separate multiply and add, so it is equal to the plain version's bit for
// bit.
//   float32 (tail_kernel): everything between input and logit is float32.
//   bfloat16 (tail_bf16_kernel): each conv multiplies bf16 operands with
//   float32 sums; the upsampled input, conv0's and conv1's outputs after BN
//   and ReLU are rounded to bf16 (the JAX kernel's rule, with BN kept as a
//   float32 epilogue instead of being folded into the weights before they
//   are rounded). Both round the logit once on store.
//
// Bound: operations. 2 * 9 * (Ci*C + C*C + C) FLOP per output pixel (14,112
// at Ci 32, C 16) against 2*Ci/4 + 2 bytes (bf16): 0.14 ms for a batch of 32
// at 480x640 on the bf16 tensor cores.
//
// float32 design: one block per TH x TW output tile. Shared memory holds the
// upsampled input with a 3-pixel halo for IC input channels at a time as
// channel planes (the input channels are walked in chunks, the conv0 sums
// stay in registers), then conv0's output with a 2-pixel halo, conv1's with
// a 1-pixel halo, and the weights. A thread owns PX vertically adjacent
// pixels of one column and OC output channels on the float32 units.
//
// bfloat16 design: each 3x3 conv is an implicit GEMM on the tensor cores
// (mma.sync m16n8k16, fragments by ldmatrix): M = the pixels of the conv's
// output region, flattened; K = 9 taps x 16-channel groups; N = 16 output
// channels (8 for the head, whose seven extra columns are zero weights). A
// warp owns two 16-pixel M tiles and all N. Activations lie pixel-major with
// the channels fastest and 16 bytes of padding per pixel (so the eight rows
// of an ldmatrix fall into different bank groups): a K step is one tap's 16
// channels of 16 consecutive output pixels, read at the tap's shifted pixel.
// Per 24 x 16 output tile a block of 8 warps stages the half-resolution
// source cells as bf16 planes, upsamples them into bf16 (the taps clamped
// into the image, zero outside it), runs conv0 over
// the 28 x 20 region conv1 needs, conv1 over 26 x 18 (into the upsample's
// buffer) and the head. 106 KB of shared memory, two blocks per SM; each
// block loads the weights once and walks tiles, and on the served NCHW
// memory the next tile's source cells arrive by cp.async while it computes
// the current one.
//
// Why the upsample is computed and not composed into conv0 (a half-resolution
// 3x3 conv with N = 4 x 16, as the JAX kernel and tail_q.cu do): the rule
// above rounds the upsampled input, which composing would skip, and the
// product is the same size either way (9 Ci x 16 multiply-adds per output
// pixel). What composing would save is the upsample's arithmetic; switched
// off in scripts/profile_torch_kernels.py it was 0.62 of 2.02 ms before the
// 2 x 2 pixel pairing below cut its cell reads by four, against a kernel that
// must then clamp its taps by coordinate at every border tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"
#include "tail_parts.cuh"

namespace {

using namespace tail_parts;

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
//
// BORDER (the float border of the int8 tail, csrc/tail_q.cu): x is float32,
// bf16 or int8 (Tin) and the tail runs on its dequantized values (tail_parts::
// dequantized with inv = float32(1 / s_x) and sx); only the blocks whose tile
// meets the outer BORDER_PX rows or columns of the map work, and they write
// only those pixels.
constexpr int BORDER_PX = 6;

__device__ __forceinline__ bool in_border(int gy, int gx, int H, int W) {
  return gy < BORDER_PX || gy >= H - BORDER_PX || gx < BORDER_PX || gx >= W - BORDER_PX;
}

template <typename Tin, bool BORDER>
__global__ void __launch_bounds__(THREADS, 2)
tail_kernel(const Tin* __restrict__ x, long long sb, long long sh, long long sw, long long sc,
            float inv, float sx, const float* __restrict__ w0, const float* __restrict__ st0,
            const float* __restrict__ w1, const float* __restrict__ st1,
            const float* __restrict__ wh, const float* __restrict__ bh, float* __restrict__ out,
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
  if (BORDER && ty0 >= BORDER_PX && ty0 + TH <= H - BORDER_PX && tx0 >= BORDER_PX &&
      tx0 + TW <= W - BORDER_PX)
    return;  // an interior tile: the int8 map's
  const Tin* xb = x + (long long)b * sb;
  auto ld = [&](const Tin* p) { return BORDER ? dequantized(*p, inv, sx) : value_f(*p); };

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
          const Tin* xc = xb + (long long)ci * sc;
          const float a = __fadd_rn(__fmul_rn(wy0, ld(xc + i0 * sh + j0 * sw)),
                                    __fmul_rn(wy1, ld(xc + i1 * sh + j0 * sw)));
          const float d = __fadd_rn(__fmul_rn(wy0, ld(xc + i0 * sh + j1 * sw)),
                                    __fmul_rn(wy1, ld(xc + i1 * sh + j1 * sw)));
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
      if (gy < H && gx < W && (!BORDER || in_border(gy, gx, H, W)))
        out[((long long)b * H + gy) * W + gx] = acc[p] + bias;
    }
  }
}

size_t tail_smem_bytes(int Cp) {
  const int chunk = IC * UH * UW + 9 * IC * OC, y1 = Cp * Y1H * Y1W;
  const int sizeA = chunk > y1 ? chunk : y1;
  return sizeof(float) * ((size_t)sizeA + (size_t)Cp * Y0H_ALLOC * Y0W + 9 * (size_t)Cp * Cp +
                          9 * (size_t)Cp + 4 * (size_t)Cp);
}

template <typename Tin, bool BORDER>
int launch(const void* x, long long sb, long long sh, long long sw, long long sc, float inv,
           float sx, const void* w0, const void* st0, const void* w1, const void* st1,
           const void* wh, const void* bh, void* out, int B, int h, int w, int Ci, int Cip, int Cp,
           cudaStream_t stream) {
  const size_t smem = tail_smem_bytes(Cp);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(tail_kernel<Tin, BORDER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((2 * w + TW - 1) / TW, (2 * h + TH - 1) / TH, B);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  tail_kernel<Tin, BORDER><<<grid, THREADS, smem, stream>>>(
      static_cast<const Tin*>(x), sb, sh, sw, sc, inv, sx, f(w0), f(st0), f(w1), f(st1), f(wh),
      f(bh), static_cast<float*>(out), h, w, Ci, Cip, Cp);
  return static_cast<int>(cudaGetLastError());
}

// ---- bfloat16 route on the tensor cores ------------------------------------

namespace bf {

using namespace hist_mma;

constexpr int TH = 24, TW = 16;                   // output tile (full resolution)
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int UH = TH + 6, UW = TW + 6;           // upsampled input, halo 3
constexpr int Y0H = TH + 4, Y0W = TW + 4;         // conv0 output, halo 2
constexpr int Y1H = TH + 2, Y1W = TW + 2;         // conv1 output, halo 1
constexpr int SH = TH / 2 + 4, SW = TW / 2 + 4;   // half-resolution source cells
// bf16 per channel plane of the staged cells: rows stay 4-byte aligned, and
// 97 words (odd) keep channel-fastest stores free of bank conflicts
constexpr int SPLANE = SH * SW + 2;
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

struct Layout {  // byte offsets into dynamic shared memory
  int fp, w0, w1, wh, u, y0, cells, total;
};

// fp: s0, t0, s1, t1 (Cp each), bh, padding; w0 [9 G0][Cp] rows, w1 [9
// G1][Cp], wh [9 G1][8] (WROW bytes each); u: the upsampled input, later
// conv1's output; y0: conv0's output; cells: the half-resolution source
// cells [Cip][SPLANE] bf16, the next tile's arriving while a tile computes
__host__ __device__ constexpr Layout layout(int g0, int g1) {
  Layout L{};
  int o = 0;
  L.fp = o; o += (4 * 16 * g1 + 4) * 4;
  L.w0 = o; o += 9 * g0 * 16 * g1 * WROW;
  L.w1 = o; o += 9 * g1 * 16 * g1 * WROW;
  L.wh = o; o += 9 * g1 * 8 * WROW;
  L.u = o;  o += imax(UH * UW * pix_bytes(g0), Y1H * Y1W * pix_bytes(g1));
  L.y0 = o; o += Y0H * Y0W * pix_bytes(g1);
  L.cells = o; o += (16 * g0 * SPLANE * 2 + 15) / 16 * 16;
  L.total = o;
  return L;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x: logical (B, h, w, Ci) bf16 with element strides sb, sh, sw, sc; w0, w1,
// wh, fp as layout() lists them (ops/cuda_tail.py::pack_tail_weights lays
// them out in device memory; fp's padding is not read); out (B, 2h, 2w).
// Cip = 16 G0 >= Ci, Cp = 16 G1 >= C; padded channels have zero weights,
// scales and shifts. A block loads the weights once and walks the output
// tiles blockIdx.x, + gridDim.x, ... With `async` (channel planes whose
// column pairs are 4-byte aligned: the served NCHW memory) the next tile's
// source cells are copied with cp.async while the block computes the
// current one; otherwise each tile loads them when it starts.
template <int G0, int G1>
__global__ void __launch_bounds__(THREADS, 2)
tail_bf16_kernel(const __nv_bfloat16* __restrict__ x, long long sb, long long sh, long long sw,
                 long long sc, const __nv_bfloat16* __restrict__ w0,
                 const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ wh,
                 const float* __restrict__ fp, __nv_bfloat16* __restrict__ out, int B, int h,
                 int w, int Ci, int async) {
  constexpr int Cip = 16 * G0, Cp = 16 * G1;
  constexpr Layout L = layout(G0, G1);
  extern __shared__ __align__(16) unsigned char smem[];
  float* fps = reinterpret_cast<float*>(smem + L.fp);
  unsigned char* us = smem + L.u;
  unsigned char* y0s = smem + L.y0;
  __nv_bfloat16* cells = reinterpret_cast<__nv_bfloat16*>(smem + L.cells);

  const int H = 2 * h, W = 2 * w;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = tiles_x * tiles_y * B;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < 4 * Cp + 1; i += THREADS) fps[i] = fp[i];
  {
    constexpr int n0 = (L.w1 - L.w0) / 16, n1 = (L.wh - L.w1) / 16;
    const uint4* src0 = reinterpret_cast<const uint4*>(w0);
    const uint4* src1 = reinterpret_cast<const uint4*>(w1);
    const uint4* srch = reinterpret_cast<const uint4*>(wh);
    uint4* dst = reinterpret_cast<uint4*>(smem + L.w0);  // w0, w1, wh lie back to back
    batched_copy<8>((L.u - L.w0) / 16, THREADS, [&](int i) {
      return i < n0 ? src0[i] : i < n0 + n1 ? src1[i - n0] : srch[i - n0 - n1];
    }, [&](int i, uint4 v) { dst[i] = v; });
  }
  const float* s0 = fps;
  const float* t0 = fps + Cp;
  const float* s1 = fps + 2 * Cp;
  const float* t1 = fps + 3 * Cp;

  // The source cells of a tile: rows ty0 / 2 - 2 ... (SH), columns tx0 / 2 -
  // 2 ... (SW), channels < Ci; cells outside the image are not loaded (the
  // upsample clamps its taps into the image, which is its edge rule).
  auto corner = [&](int tile, int& b, int& ty0, int& tx0) {
    b = tile / (tiles_x * tiles_y);
    const int rest = tile - b * tiles_x * tiles_y;
    ty0 = (rest / tiles_x) * TH;
    tx0 = (rest % tiles_x) * TW;
  };
  auto prefetch = [&](int tile) {  // channel planes, two columns per 4-byte copy
    int b, ty0, tx0;
    corner(tile, b, ty0, tx0);
    const __nv_bfloat16* xb = x + b * sb;
    const uint32_t base = smem_addr(cells);
    for (int i = tid; i < Ci * SH * (SW / 2); i += THREADS) {
      const int c = i / (SH * (SW / 2)), rest = i - c * (SH * (SW / 2));
      const int r = rest / (SW / 2), k = rest - r * (SW / 2);
      const int gi = ty0 / 2 - 2 + r, gj = tx0 / 2 - 2 + 2 * k;
      if (gi >= 0 && gi < h && gj >= 0 && gj < w && !skip(1))
        cp_async4(base + (c * SPLANE + r * SW + 2 * k) * 2, xb + c * sc + gi * sh + gj);
    }
    cp_async_commit();
  };

  if (async && (int)blockIdx.x < ntiles) prefetch(blockIdx.x);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int b, ty0, tx0;  // ty0, tx0 even
    corner(tile, b, ty0, tx0);
    const int si0 = ty0 / 2 - 2, sj0 = tx0 / 2 - 2;
    if (async) {
      cp_async_wait_all();
    } else {  // sc == 1 (channels innermost): neighbouring threads, neighbouring channels
      const __nv_bfloat16* xb = x + b * sb;
      auto where = [&](int i, int& c, int& p) {
        if (sc == 1) {
          c = i % Cip; p = i / Cip;
        } else {
          p = i % (SH * SW); c = i / (SH * SW);
        }
      };
      batched_copy<8>(Cip * SH * SW, THREADS, [&](int i) {
        int c, p;
        where(i, c, p);
        const int gi = min(max(si0 + p / SW, 0), h - 1), gj = min(max(sj0 + p % SW, 0), w - 1);
        return (c < Ci && !skip(1)) ? xb[gi * sh + gj * sw + c * sc] : __float2bfloat16_rn(0.0f);
      }, [&](int i, __nv_bfloat16 v) {
        int c, p;
        where(i, c, p);
        cells[c * SPLANE + p] = v;
      });
    }
    __syncthreads();  // the cells are in; the last tile's head is done with u

    // ---- upsample into u, 2 x 2 pixels at a time. u starts at an odd row and
    // column (ty0 - 3, tx0 - 3), so the pixels 2k + 1 and 2k + 2 of a pair both
    // interpolate between cells i and i + 1 (0.75, 0.25 and 0.25, 0.75), the
    // cell indices clamped into the image (the edge rule); rows first, each
    // weight a separate multiply and add, as the plain version does. Zero
    // outside the image (conv0's padding) and past Ci. A thread writes 8
    // channels of the four pixels.
    {
      constexpr int PB = pix_bytes(G0), BH = UH / 2, BW = UW / 2;
      static_assert(UH % 2 == 0 && UW % 2 == 0, "pixel pairs");
      for (int it = tid; it < BH * BW * (Cip / 8); it += THREADS) {
        const int q = it % (BH * BW), c8 = it / (BH * BW);
        const int br = q / BW, bc = q - br * BW;
        const int gy = ty0 - 3 + 2 * br, gx = tx0 - 3 + 2 * bc;  // odd
        const int ra = max(gy >> 1, 0) - si0, rb = min((gy >> 1) + 1, h - 1) - si0;
        const int ca = max(gx >> 1, 0) - sj0, cb = min((gx >> 1) + 1, w - 1) - sj0;
        bool inside[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int y = gy + (k >> 1), xx = gx + (k & 1);
          inside[k] = y >= 0 && y < H && xx >= 0 && xx < W && 8 * c8 < Ci && !skip(2);
        }
        uint32_t words[4][4];  // [pixel (row-major in the 2 x 2)][channel pair]
        if (inside[0] || inside[1] || inside[2] || inside[3]) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float val[4][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = c8 * 8 + 2 * k + e;
              const __nv_bfloat16* cs = cells + c * SPLANE;
              const float c00 = __bfloat162float(cs[ra * SW + ca]);
              const float c01 = __bfloat162float(cs[ra * SW + cb]);
              const float c10 = __bfloat162float(cs[rb * SW + ca]);
              const float c11 = __bfloat162float(cs[rb * SW + cb]);
              // rows: the odd pixel row (0.75, 0.25), the even one (0.25, 0.75)
              const float ta = __fadd_rn(__fmul_rn(0.75f, c00), __fmul_rn(0.25f, c10));
              const float tb = __fadd_rn(__fmul_rn(0.75f, c01), __fmul_rn(0.25f, c11));
              const float ba = __fadd_rn(__fmul_rn(0.25f, c00), __fmul_rn(0.75f, c10));
              const float bb = __fadd_rn(__fmul_rn(0.25f, c01), __fmul_rn(0.75f, c11));
              const bool real = c < Ci;
              val[0][e] = real ? __fadd_rn(__fmul_rn(0.75f, ta), __fmul_rn(0.25f, tb)) : 0.0f;
              val[1][e] = real ? __fadd_rn(__fmul_rn(0.25f, ta), __fmul_rn(0.75f, tb)) : 0.0f;
              val[2][e] = real ? __fadd_rn(__fmul_rn(0.75f, ba), __fmul_rn(0.25f, bb)) : 0.0f;
              val[3][e] = real ? __fadd_rn(__fmul_rn(0.25f, ba), __fmul_rn(0.75f, bb)) : 0.0f;
            }
#pragma unroll
            for (int px = 0; px < 4; ++px) words[px][k] = pack_bf16x2(val[px][0], val[px][1]);
          }
        }
#pragma unroll
        for (int px = 0; px < 4; ++px) {
          const uint4 v = inside[px] ? make_uint4(words[px][0], words[px][1], words[px][2],
                                                  words[px][3])
                                     : make_uint4(0u, 0u, 0u, 0u);
          const int p = (2 * br + (px >> 1)) * UW + 2 * bc + (px & 1);
          *reinterpret_cast<uint4*>(us + p * PB + c8 * 16) = v;
        }
      }
    }
    __syncthreads();  // u complete; the cells are no longer read
    if (async && tile + (int)gridDim.x < ntiles) prefetch(tile + gridDim.x);

    // ---- conv0 over u -> y0 (28 x 20 region from (ty0 - 2, tx0 - 2))
    {
      constexpr int M = Y0H * Y0W, NT = 2 * G1;
      for (int m0 = warp * 16 * MT; m0 < M; m0 += WARPS * 16 * MT) {
        float acc[MT][NT][4];
        conv3x3<G0, NT, !skip(4)>(acc, smem_addr(us), UW, Y0W, M, m0, smem_addr(smem + L.w0),
                                  lane);
        store_bn_relu<NT>(acc, y0s, M, m0, Y0W, ty0 - 2, tx0 - 2, H, W, s0, t0, lane);
      }
    }
    __syncthreads();  // y0 complete; u is no longer read: y1 takes its place

    // ---- conv1 over y0 -> y1 (26 x 18 region from (ty0 - 1, tx0 - 1))
    {
      constexpr int M = Y1H * Y1W, NT = 2 * G1;
      for (int m0 = warp * 16 * MT; m0 < M; m0 += WARPS * 16 * MT) {
        float acc[MT][NT][4];
        conv3x3<G1, NT, !skip(8)>(acc, smem_addr(y0s), Y0W, Y1W, M, m0, smem_addr(smem + L.w1),
                                  lane);
        store_bn_relu<NT>(acc, us, M, m0, Y1W, ty0 - 1, tx0 - 1, H, W, s1, t1, lane);
      }
    }
    __syncthreads();

    // ---- seg head over y1: column 0 of the 8-wide product is the logit; an
    // M tile is one 16-pixel row of the output tile
    {
      constexpr int M = TH * TW;
      const int g = lane >> 2, t = lane & 3;
      const float bh = fps[4 * Cp];
      for (int m0 = warp * 16 * MT; m0 < M; m0 += WARPS * 16 * MT) {
        float acc[MT][1][4];
        conv3x3<G1, 1, !skip(16)>(acc, smem_addr(us), Y1W, TW, M, m0, smem_addr(smem + L.wh),
                                  lane);
        if (t == 0) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int m = m0 + 16 * mt + g + 8 * half;
              const int gy = ty0 + m / TW, gx = tx0 + m % TW;
              if (m < M && gy < H && gx < W)
                out[((size_t)b * H + gy) * W + gx] =
                    __float2bfloat16_rn(__fadd_rn(acc[mt][0][2 * half], bh));
            }
        }
      }
    }
  }
}

template <int G0, int G1>
int launch(const void* x, long long sb, long long sh, long long sw, long long sc, const void* w0,
           const void* w1, const void* wh, const void* fp, void* out, int B, int h, int w,
           int Ci, cudaStream_t stream) {
  constexpr Layout L = layout(G0, G1);
  if (L.total > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(tail_bf16_kernel<G0, G1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tail_bf16_kernel<G0, G1>,
                                                           THREADS, L.total)) != cudaSuccess)
    return static_cast<int>(err);
  const long long ntiles = (long long)((2 * w + TW - 1) / TW) * ((2 * h + TH - 1) / TH) * B;
  const int blocks = (int)(ntiles < (long long)sms * per_sm ? ntiles : (long long)sms * per_sm);
  // cp.async moves 4-byte column pairs of a channel plane: they must be aligned
  const int async = sc != 1 && sw == 1 && sh % 2 == 0 && sc % 2 == 0 && sb % 2 == 0 && w % 2 == 0 &&
                    reinterpret_cast<std::uintptr_t>(x) % 4 == 0;
  tail_bf16_kernel<G0, G1><<<blocks, THREADS, L.total, stream>>>(
      static_cast<const __nv_bfloat16*>(x), sb, sh, sw, sc, static_cast<const __nv_bfloat16*>(w0),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(wh),
      static_cast<const float*>(fp), static_cast<__nv_bfloat16*>(out), B, h, w, Ci, async);
  return static_cast<int>(cudaGetLastError());
}

template <int G0>
int launch_g1(int g1, const void* x, long long sb, long long sh, long long sw, long long sc,
              const void* w0, const void* w1, const void* wh, const void* fp, void* out, int B,
              int h, int w, int Ci, cudaStream_t stream) {
  if (g1 == 1) return launch<G0, 1>(x, sb, sh, sw, sc, w0, w1, wh, fp, out, B, h, w, Ci, stream);
  if (g1 == 2) return launch<G0, 2>(x, sb, sh, sw, sc, w0, w1, wh, fp, out, B, h, w, Ci, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace bf

}  // namespace

// Shared memory the float32 kernel needs at padded width Cp, for the wrapper's check.
extern "C" int tail_smem_bytes_for(int Cp) { return (int)tail_smem_bytes(Cp); }

// float32: x and its element strides (batch, row, column, channel), the
// weights padded to Cip / Cp as ops/cuda_tail.py::tail lays them out.
extern "C" int tail_launch(const void* x, long long sb, long long sh, long long sw, long long sc,
                           const void* w0, const void* st0, const void* w1, const void* st1,
                           const void* wh, const void* bh, void* out, int B, int h, int w, int Ci,
                           int Cip, int Cp, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((size_t)B * h * w == 0) return 0;
  if (Cip % IC != 0 || Cp % OC != 0 || Cip < Ci) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, false>(x, sb, sh, sw, sc, 1.0f, 1.0f, w0, st0, w1, st1, wh, bh, out, B, h,
                              w, Ci, Cip, Cp, stream);
}

// The float32 border of the int8 tail (ops/cuda_tail.py::tail_q with a
// float32 output): x (float32, bfloat16 or int8 by in_dtype 0, 1, 2) and its
// element strides (batch, row, column, channel), quantized with inv =
// float32(1 / s_x) unless int8 and dequantized with sx; weights as
// tail_launch takes them; writes the outer six rows and columns of out.
extern "C" int tail_border_f32_launch(const void* x, long long sb, long long sh, long long sw,
                                      long long sc, int in_dtype, float inv, float sx,
                                      const void* w0, const void* st0, const void* w1,
                                      const void* st1, const void* wh, const void* bh, void* out,
                                      int B, int h, int w, int Ci, int Cip, int Cp,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((size_t)B * h * w == 0) return 0;
  if (Cip % IC != 0 || Cp % OC != 0 || Cip < Ci) return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype == 0)
    return launch<float, true>(x, sb, sh, sw, sc, inv, sx, w0, st0, w1, st1, wh, bh, out, B, h, w,
                               Ci, Cip, Cp, stream);
  if (in_dtype == 1)
    return launch<__nv_bfloat16, true>(x, sb, sh, sw, sc, inv, sx, w0, st0, w1, st1, wh, bh, out,
                                       B, h, w, Ci, Cip, Cp, stream);
  if (in_dtype == 2)
    return launch<int8_t, true>(x, sb, sh, sw, sc, inv, sx, w0, st0, w1, st1, wh, bh, out, B, h, w,
                                Ci, Cip, Cp, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory the bfloat16 kernel needs with g0 and g1 16-channel groups (not a launcher).
extern "C" int tail_bf16_smem_bytes_for(int g0, int g1) { return bf::layout(g0, g1).total; }

// bfloat16: x and its element strides (batch, row, column, channel); w0, w1,
// wh, fp as ops/cuda_tail.py::pack_tail_weights lays them out; g0 = Cip / 16
// in 1..4, g1 = Cp / 16 in 1..2, within the shared memory of a block
// (tail_bf16_smem_bytes_for).
extern "C" int tail_bf16_launch(const void* x, long long sb, long long sh, long long sw,
                                long long sc, const void* w0, const void* w1, const void* wh,
                                const void* fp, void* out, int B, int h, int w, int Ci, int g0,
                                int g1, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((size_t)B * h * w == 0) return 0;
  if (Ci > 16 * g0) return static_cast<int>(cudaErrorInvalidValue);
  switch (g0) {
#define HIST_TAIL_LAUNCH(G0_) \
  return bf::launch_g1<G0_>(g1, x, sb, sh, sw, sc, w0, w1, wh, fp, out, B, h, w, Ci, stream)
    case 1: HIST_TAIL_LAUNCH(1);
    case 2: HIST_TAIL_LAUNCH(2);
    case 3: HIST_TAIL_LAUNCH(3);
    case 4: HIST_TAIL_LAUNCH(4);
#undef HIST_TAIL_LAUNCH
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
