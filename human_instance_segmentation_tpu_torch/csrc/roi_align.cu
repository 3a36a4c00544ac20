// Gather RoIAlign with grid_sample semantics (bilinear, zero padding,
// align_corners=aligned), NHWC, any channel count, for Hopper.
//
// Replaces the JAX package's Pallas kernel
// human_instance_segmentation_tpu/ops/pallas_roi_align.py::roi_align_pallas
// (kernel _kernel :44-83). The TPU kernel blends two source rows per output
// row on the VPU and interpolates along x with a matmul, with channels
// padded to 8 for Mosaic's layout (C <= 8). Here one thread computes one
// output element (n, y, x, c) from its four bilinear taps; there is no
// channel limit and no layout padding.
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
// Bound: bandwidth and launch latency. At the served shape (32 ROIs of a
// 480x640x3 image -> 64x48) it writes 295k outputs and reads at most four
// taps each: about 5 MB, a few microseconds of HBM time.

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

template <typename T>
__global__ void roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                                 T* __restrict__ out, int B, int H, int W, int C, int N, int oh,
                                 int ow, float ssh, float ssw, int aligned) {
  const size_t total = (size_t)N * oh * ow * C;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    size_t r = idx / C;
    const int ox = (int)(r % ow);
    r /= ow;
    const int oy = (int)(r % oh);
    const int n = (int)(r / oh);

    const float* roi = rois + (size_t)n * 5;
    const int b = min(max((int)roi[0], 0), B - 1);
    const float py = sample_pos(__fmul_rn(roi[2], ssh), __fmul_rn(roi[4], ssh), oy, oh, aligned);
    const float px = sample_pos(__fmul_rn(roi[1], ssw), __fmul_rn(roi[3], ssw), ox, ow, aligned);
    const float y0f = floorf(py), x0f = floorf(px);
    const int y0 = (int)y0f, x0 = (int)x0f;
    const float wy[2] = {hat(py, y0f), hat(py, y0f + 1.0f)};
    const float wx[2] = {hat(px, x0f), hat(px, x0f + 1.0f)};

    const T* fb = feat + (size_t)b * H * W * C + c;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int xx = x0 + i;
      if (xx < 0 || xx >= W) continue;
      float col = 0.0f;  // y-blend of column xx, as the plain version's Wy product
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int yy = y0 + j;
        if (yy >= 0 && yy < H) col += wy[j] * to_f(fb[((size_t)yy * W + xx) * C]);
      }
      acc += wx[i] * col;
    }
    out[idx] = from_f<T>(acc);
  }
}

}  // namespace

extern "C" int roi_align_launch(const void* features, const void* rois, void* out, int B, int H,
                                int W, int C, int N, int oh, int ow, float ssh, float ssw,
                                int aligned, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t total = (size_t)N * oh * ow * C;
  if (total == 0) return 0;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65535 * 8 ? want : 65535 * 8);
  const float* r = static_cast<const float*>(rois);
  if (dtype == 1) {
    roi_align_kernel<__nv_bfloat16><<<blocks, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(features), r, static_cast<__nv_bfloat16*>(out), B, H, W,
        C, N, oh, ow, ssh, ssw, aligned);
  } else {
    roi_align_kernel<float><<<blocks, threads, 0, stream>>>(static_cast<const float*>(features), r,
                                                            static_cast<float*>(out), B, H, W, C,
                                                            N, oh, ow, ssh, ssw, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hist_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
