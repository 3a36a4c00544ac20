// Binary-mask edge smoothing on float32 planes (P, H, W) for Hopper.
//
// Replaces the JAX package's Pallas kernel
// human_instance_segmentation_tpu/ops/pallas_kernels.py::edge_smooth_pallas
// (kernel _edge_smooth_kernel :112-139). The TPU kernel takes planes padded
// outside the kernel, keeps one whole padded plane in VMEM and walks it in
// row tiles, with column shifts as lane rolls. Here the zero padding is
// resolved on load and the thresholds are launch arguments. (The bilateral
// filter, the file's other Pallas kernel, is csrc/bilateral.cu.)
//
// edge_smooth: |8c - sum(neighbours)| -> sigmoid(. * strength) -> blend of c
// with the 1-2-1 blur / 16 -> > threshold, zero padding. Bound: bytes (8
// per pixel). One thread per pixel reads its nine taps through L1. The blend
// uses the _rn intrinsics so nvcc forms no FMA the plain version lacks: the
// output is a threshold and must not flip on a contraction.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void edge_smooth_kernel(const float* __restrict__ m, float* __restrict__ out, int H,
                                   int W, float strength, float threshold) {
  const int gx = blockIdx.x * blockDim.x + threadIdx.x;
  const int gy = blockIdx.y * blockDim.y + threadIdx.y;
  if (gx >= W || gy >= H) return;
  const float* plane = m + (size_t)blockIdx.z * H * W;
  float v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int yy = gy + i - 1, xx = gx + j - 1;
      v[i][j] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? plane[(size_t)yy * W + xx] : 0.0f;
    }
  }
  const float c = v[1][1];
  const float corners = (v[0][0] + v[0][2]) + (v[2][0] + v[2][2]);
  const float sides = (v[0][1] + v[1][0]) + (v[1][2] + v[2][1]);
  const float edges = fabsf(__fsub_rn(__fmul_rn(8.0f, c), __fadd_rn(corners, sides)));
  const float ew = 1.0f / (1.0f + expf(-__fmul_rn(edges, strength)));
  const float blurred = __fmul_rn(
      __fadd_rn(__fadd_rn(corners, __fmul_rn(2.0f, sides)), __fmul_rn(4.0f, c)), 1.0f / 16.0f);
  const float smoothed =
      __fadd_rn(__fmul_rn(c, __fsub_rn(1.0f, ew)), __fmul_rn(blurred, ew));
  out[((size_t)blockIdx.z * H + gy) * W + gx] = smoothed > threshold ? 1.0f : 0.0f;
}

}  // namespace

// mask, out: (P, H, W) float32.
extern "C" int edge_smooth_launch(const void* mask, void* out, int P, int H, int W, float strength,
                                  float threshold, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((size_t)P * H * W == 0) return 0;
  dim3 block(32, 8);
  dim3 grid((W + 31) / 32, (H + 7) / 8, P);
  edge_smooth_kernel<<<grid, block, 0, stream>>>(static_cast<const float*>(mask),
                                                 static_cast<float*>(out), H, W, strength,
                                                 threshold);
  return static_cast<int>(cudaGetLastError());
}
