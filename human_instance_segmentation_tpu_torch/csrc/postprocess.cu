// Post-processing stencils on float32 planes (P, H, W) for Hopper: the exact
// bilateral filter and the binary-mask edge smoothing.
//
// Replace the JAX package's Pallas kernels
// human_instance_segmentation_tpu/ops/pallas_kernels.py::bilateral_filter_pallas
// (kernel _bilateral_kernel :48-74) and ::edge_smooth_pallas (kernel
// _edge_smooth_kernel :112-139). The TPU kernels take planes padded outside
// the kernel, keep one whole padded plane in VMEM and walk it in row tiles,
// with column shifts as lane rolls. Here the padding is resolved on load
// (reflect for the bilateral filter, zero for the edge smoothing), a block
// owns one tile of one plane, and k, the sigmas and the thresholds are
// launch arguments.
//
// bilateral_filter: out = sum(w * v) / (sum(w) + 1e-8) over the k x k window,
// w = spatial[di][dj] * exp(-(v - centre)^2 * inv2s2), taps summed row-major
// (di, then dj) as the plain version does. The spatial table comes from the
// wrapper (the plain version's own table). expf is the full-precision one.
// Bound: the special-function and float32 units, not bytes (k^2 exps per
// pixel against 8 bytes per pixel). A block stages its tile plus halo in
// shared memory; each thread computes BIL_ROWS pixels of one column.
//
// edge_smooth: |8c - sum(neighbours)| -> sigmoid(. * strength) -> blend of c
// with the 1-2-1 blur / 16 -> > threshold, zero padding. Bound: bytes (8
// per pixel). One thread per pixel reads its nine taps through L1. The blend
// uses the _rn intrinsics so nvcc forms no FMA the plain version lacks: the
// output is a threshold and must not flip on a contraction.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BIL_TW = 32;   // tile width = threads in x
constexpr int BIL_TY = 8;    // threads in y
constexpr int BIL_ROWS = 4;  // pixels per thread, BIL_TY apart
constexpr int BIL_TH = BIL_TY * BIL_ROWS;

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

__global__ void bilateral_kernel(const float* __restrict__ x, const float* __restrict__ spatial,
                                 float* __restrict__ out, int H, int W, int k, float inv2s2) {
  extern __shared__ float smem[];
  const int pad = k / 2;
  const int sw = BIL_TW + 2 * pad;
  const int sh = BIL_TH + 2 * pad;
  float* tile = smem;            // sh x sw
  float* sp = smem + sh * sw;    // k x k
  const int x0 = blockIdx.x * BIL_TW, y0 = blockIdx.y * BIL_TH;
  const float* plane = x + (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.y * BIL_TW + threadIdx.x;
  const int nthreads = BIL_TW * BIL_TY;
  for (int i = tid; i < sh * sw; i += nthreads) {
    const int r = i / sw, c = i - r * sw;
    // a tile that hangs past the image reads a clamped (unused) position
    const int gy = reflect(min(y0 + r - pad, H - 1 + pad), H);
    const int gx = reflect(min(x0 + c - pad, W - 1 + pad), W);
    tile[i] = plane[(size_t)gy * W + gx];
  }
  for (int i = tid; i < k * k; i += nthreads) sp[i] = spatial[i];
  __syncthreads();

  const int gx = x0 + threadIdx.x;
#pragma unroll
  for (int p = 0; p < BIL_ROWS; ++p) {
    const int ly = threadIdx.y + p * BIL_TY;
    const int gy = y0 + ly;
    if (gx >= W || gy >= H) continue;
    const float centre = tile[(ly + pad) * sw + threadIdx.x + pad];
    float num = 0.0f, den = 0.0f;
    for (int di = 0; di < k; ++di) {
      const float* row = tile + (ly + di) * sw + threadIdx.x;
      for (int dj = 0; dj < k; ++dj) {
        const float v = row[dj];
        const float d = v - centre;
        const float wgt = sp[di * k + dj] * expf(-(d * d) * inv2s2);
        num += wgt * v;
        den += wgt;
      }
    }
    out[((size_t)blockIdx.z * H + gy) * W + gx] = num / (den + 1e-8f);
  }
}

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

// x, out: (P, H, W) float32; spatial: (k, k) float32.
extern "C" int bilateral_filter_launch(const void* x, const void* spatial, void* out, int P, int H,
                                       int W, int k, float inv2s2, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((size_t)P * H * W == 0) return 0;
  const int pad = k / 2;
  const size_t smem =
      ((size_t)(BIL_TW + 2 * pad) * (BIL_TH + 2 * pad) + (size_t)k * k) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bilateral_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((W + BIL_TW - 1) / BIL_TW, (H + BIL_TH - 1) / BIL_TH, P);
  dim3 block(BIL_TW, BIL_TY);
  bilateral_kernel<<<grid, block, smem, stream>>>(static_cast<const float*>(x),
                                                  static_cast<const float*>(spatial),
                                                  static_cast<float*>(out), H, W, k, inv2s2);
  return static_cast<int>(cudaGetLastError());
}

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
