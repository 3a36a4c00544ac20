// Gather RoIAlign with grid_sample semantics (bilinear, zero padding,
// align_corners=aligned), NHWC, any channel count, for Hopper: one launch
// crops one feature map, or two maps of the same B, H, W and dtype, with one
// ROI table.
//
// Replaces the JAX package's Pallas kernel
// human_instance_segmentation_tpu/ops/pallas_roi_align.py::roi_align_pallas
// (kernel _kernel :44-83). The TPU kernel blends two source rows per output
// row on the VPU and interpolates along x with a matmul, with channels
// padded to 8 for Mosaic's layout (C <= 8), one map per call. Here one thread
// computes one output pixel (n, y, x) for every channel of both maps: the
// ROI, the sample positions and the four hat weights are worked out once a
// pixel, then the taps of up to four channels of each map are loaded
// together (one memory latency a pixel at the served channel counts) and
// each channel is blended with three multiply-adds. Each map is read
// through its element strides (a logit map that is an NCHW tensor viewed as
// NHWC needs no copy); the outputs are contiguous (N, oh, ow, C). Index
// arithmetic is 32-bit within an image (the wrapper checks that it fits),
// the image's offset 64-bit.
//
// Positions follow ops/sampling.py::grid_sample_positions exactly:
// t = i / (out - 1) (0 when out == 1), p = lo + t * (hi - lo), minus 0.5
// unless aligned, with the _rn intrinsics so nvcc does not contract the
// arithmetic into FMAs the plain version does not use. Tap weights are the
// hat weights max(0, 1 - |p - j|) of the plain version's interpolation
// matrices; a tap outside [0, S-1] reads zero, so a box edge at exactly 1.0
// gives zeros on the last row or column, as grid_sample does. batch_idx is
// truncated and clipped to [0, B-1] (sentinel rois read image 0; the caller
// masks them).
//
// Bound: bytes and launch latency. At the served shapes (32 ROIs of a
// 480x640 image -> 64x48, the RGB map and the logit map) it writes 98,304
// pixels of 3 + 2 bf16 channels and reads at most four taps of each: under
// 5 MB, about a microsecond of HBM time. What a caller sees is the launch:
// the model's two crops are one launch, and a call does one ctypes call and
// two allocations on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

__device__ __forceinline__ float sample_pos(float lo, float hi, int i, int n, int aligned) {
  const float t = n == 1 ? 0.0f : __fdiv_rn((float)i, (float)(n - 1));
  const float f = __fadd_rn(lo, __fmul_rn(t, __fsub_rn(hi, lo)));
  return aligned ? f : __fsub_rn(f, 0.5f);
}

__device__ __forceinline__ float hat(float p, float j) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, j))));
}

// one feature map: base pointer, element strides (image, row, column,
// channel), channels, output (N, oh, ow, C) contiguous
struct Map {
  const void* feat;
  long long sb;
  int sy, sx, sc, c;
  void* out;
};

// where a pixel's four taps are: rows y0, y0 + 1 and columns x0, x0 + 1,
// each with its hat weight and whether it lies inside the image
struct Taps {
  int b, y[2], x[2];
  float wy[2], wx[2];
  bool yin[2], xin[2];
};

constexpr int CHUNK = 4;  // channels of a map whose taps are loaded together

// the four taps of channels c0 .. c0 + CHUNK - 1 (those the map has and
// that lie inside the image), all loads issued before any is used
template <typename T>
__device__ __forceinline__ void gather(const Map& m, const Taps& t, int c0,
                                       float (&v)[CHUNK][2][2]) {
  const T* base = static_cast<const T*>(m.feat) + t.b * m.sb;
#pragma unroll
  for (int q = 0; q < CHUNK; ++q) {
    const T* src = base + (c0 + q) * m.sc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool inside = c0 + q < m.c && t.xin[i] && t.yin[j];
        v[q][i][j] = inside ? to_f(src[t.y[j] * m.sy + t.x[i] * m.sx]) : 0.0f;
      }
    }
  }
}

// the bilinear blend of the gathered taps, written to the pixel's outputs
template <typename T>
__device__ __forceinline__ void blend(const Map& m, const Taps& t, int c0,
                                      const float (&v)[CHUNK][2][2], int pix) {
  T* dst = static_cast<T*>(m.out) + (size_t)pix * m.c + c0;
#pragma unroll
  for (int q = 0; q < CHUNK; ++q) {
    if (c0 + q >= m.c) break;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!t.xin[i]) continue;
      float col = 0.0f;  // y-blend of column x[i], as the plain version's Wy product
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (t.yin[j]) col += t.wy[j] * v[q][i][j];
      }
      acc += t.wx[i] * col;
    }
    dst[q] = from_f<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    roi_align_kernel(Map m1, Map m2, const float* __restrict__ rois, int B, int H, int W,
                     int total, int oh, int ow, float ssh, float ssw, int aligned) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= total) return;
  const int per_roi = oh * ow;
  const int n = pix / per_roi;
  const int rem = pix - n * per_roi;
  const int oy = rem / ow;
  const int ox = rem - oy * ow;

  const float* roi = rois + n * 5;
  Taps t;
  t.b = min(max((int)roi[0], 0), B - 1);
  const float py = sample_pos(__fmul_rn(roi[2], ssh), __fmul_rn(roi[4], ssh), oy, oh, aligned);
  const float px = sample_pos(__fmul_rn(roi[1], ssw), __fmul_rn(roi[3], ssw), ox, ow, aligned);
  const float y0f = floorf(py), x0f = floorf(px);
  const int y0 = (int)y0f, x0 = (int)x0f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    t.y[j] = y0 + j;
    t.x[j] = x0 + j;
    t.wy[j] = hat(py, y0f + (float)j);
    t.wx[j] = hat(px, x0f + (float)j);
    t.yin[j] = t.y[j] >= 0 && t.y[j] < H;
    t.xin[j] = t.x[j] >= 0 && t.x[j] < W;
  }
  for (int c0 = 0; c0 < max(m1.c, m2.c); c0 += CHUNK) {
    float v1[CHUNK][2][2], v2[CHUNK][2][2];
    gather<T>(m1, t, c0, v1);
    gather<T>(m2, t, c0, v2);
    blend<T>(m1, t, c0, v1, pix);
    blend<T>(m2, t, c0, v2, pix);
  }
}

template <typename T>
int launch(const Map& m1, const Map& m2, const float* rois, int B, int H, int W, int N, int oh,
           int ow, float ssh, float ssw, int aligned, cudaStream_t stream) {
  const int total = N * oh * ow;
  const int threads = 256;
  roi_align_kernel<T><<<(total + threads - 1) / threads, threads, 0, stream>>>(
      m1, m2, rois, B, H, W, total, oh, ow, ssh, ssw, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Map i: features, element strides (image, row, column, channel), channels,
// out (N, oh, ow, C) contiguous; both maps in one dtype (0 f32, 1 bf16). The
// second map is skipped when its channel count is 0. rois: (N, 5) float32
// contiguous. N * oh * ow and each map's offsets within an image must fit in
// an int (the wrapper checks).
extern "C" int roi_align_launch(const void* f1, long long s1b, long long s1y, long long s1x,
                                long long s1c, int c1, void* out1, const void* f2, long long s2b,
                                long long s2y, long long s2x, long long s2c, int c2, void* out2,
                                const void* rois, int B, int H, int W, int N, int oh, int ow,
                                float ssh, float ssw, int aligned, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((long long)N * oh * ow == 0 || c1 == 0) return 0;
  const Map m1{f1, s1b, (int)s1y, (int)s1x, (int)s1c, c1, out1};
  const Map m2{f2, s2b, (int)s2y, (int)s2x, (int)s2c, c2, out2};
  const float* r = static_cast<const float*>(rois);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(m1, m2, r, B, H, W, N, oh, ow, ssh, ssw, aligned, stream);
  }
  return launch<float>(m1, m2, r, B, H, W, N, oh, ow, ssh, ssw, aligned, stream);
}

extern "C" const char* hist_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
