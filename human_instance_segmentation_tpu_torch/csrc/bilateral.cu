// The exact bilateral filter on float32 planes (P, H, W) for Hopper.
//
// Replaces the JAX package's Pallas kernel
// human_instance_segmentation_tpu/ops/pallas_kernels.py::bilateral_filter_pallas
// (kernel _bilateral_kernel :48-74). The TPU kernel takes a plane padded
// outside the kernel, keeps it whole in VMEM and walks it in row tiles with
// the column shifts as lane rolls. Here a block stages one tile of one plane
// with its halo in shared memory, reflect padding resolved while it loads.
//
// out = sum(w * v) / (sum(w) + 1e-8) over the k x k window, with the spatial
// weight folded into the exponent of the range weight:
//   w = 2^(-(di^2 + dj^2) a_s - (v - c)^2 a_r),  a = log2(e) / (2 sigma^2),
// the values staged times sqrt(a_r), so a weight is one subtraction, one
// FFMA and one ex2.approx (no spatial table); the centre tap is exactly 1.
//
// Bound: the special-function unit (16 ex2 a clock on an SM) against 8
// bytes a pixel. The weight is symmetric, w(p, q) = w(q, p) to the bit, so
// the function needs (k^2 - 1) / 2 exps a pixel, 24 at k = 7, not 48. For k
// = 3, 5, 7, 9 (template parameter; the tap loops unroll into straight-line
// code with the spatial terms in registers) each pair is computed once:
// - a thread computes BIL_R adjacent rows of one column from register
//   windows of BIL_R + k - 1 staged values per column offset, so most taps
//   cost no shared-memory load;
// - a vertical pair inside the thread's rows is computed by its upper pixel
//   and added to both;
// - a pair with the column dj to the right is computed by its left pixel
//   and handed dj lanes on with one __shfl_up_sync. The first k / 2 lanes of
//   a warp are halo lanes: they stand on the columns left of the block's
//   outputs, compute only what they hand on, and store nothing (29 output
//   columns a block at k = 7);
// - a pair whose other pixel lies outside the thread's rows is computed by
//   each of its pixels (9 of 48 taps a pixel at k = 7 and 8 rows).
// That is 29.25 exps a pixel at k = 7 (32.3 counting the halo lanes) against
// 48, and about seven issue slots a shared pair. Any other odd k takes the
// generic instantiation K = 0 of the same kernel: every tap by its own
// pixel, from shared memory, no halo lanes. The taps are summed in another
// order than the plain version's row-major one; with ex2.approx that moves
// the result by far less than the 1e-5 the port holds it to.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BIL_LANES = 32;           // threads in x = lanes of a warp
constexpr int BIL_TY = 4;               // warps in a block, one band of rows each
constexpr int BIL_R = 8;                // output rows per thread, adjacent
constexpr int BIL_TH = BIL_TY * BIL_R;  // tile height

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

// the weight of a tap of staged value v for staged centre c (both scaled by
// sqrt(a_r)); s = -(di^2 + dj^2) a_s
__device__ __forceinline__ float weight(float v, float c, float s) {
  const float d = v - c;
  return ex2(fmaf(-d, d, s));
}

__device__ __forceinline__ void add(float w, float v, float& num, float& den) {
  num = fmaf(w, v, num);
  den += w;
}

// K = 0: any odd k, every tap computed by its own pixel. K = 3, 5, 7, 9: the
// taps unrolled and each pair's weight shared between its two pixels; the
// first K / 2 lanes of a warp are halo lanes whose pixels belong to the
// block on the left and only give their weights to the lanes on their right.
template <int K>
__global__ void __launch_bounds__(BIL_LANES* BIL_TY)
    bilateral_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int k_arg,
                     float as, float ar) {
  extern __shared__ float tile[];
  constexpr int HL = K / 2;                // halo lanes
  constexpr int OW = BIL_LANES - HL;       // output columns of a block
  const int k = K > 0 ? K : k_arg;
  const int pad = k / 2;
  const int sw = BIL_LANES + 2 * pad;
  const int sh = BIL_TH + 2 * pad;
  const int x0 = blockIdx.x * OW, y0 = blockIdx.y * BIL_TH;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const float* plane = x + (size_t)blockIdx.z * H * W;
  const float q = sqrtf(ar);  // staged values carry sqrt(a_r): (v - c)^2 a_r is one FFMA

  // stage the tile, lane l's pixel at column x0 - HL + l, with a halo of
  // pad on every side, reflect resolved on load; positions past the
  // reflect range (halo lanes' far taps, rows and columns past the image)
  // read a clamped position whose value reaches no stored output
  for (int c = lane; c < sw; c += BIL_LANES) {
    const int gx = reflect(min(max(x0 - HL + c - pad, -pad), W - 1 + pad), W);
    for (int r = ty; r < sh; r += BIL_TY) {
      const int gy = reflect(min(y0 + r - pad, H - 1 + pad), H);
      tile[r * sw + c] = q * plane[(size_t)gy * W + gx];
    }
  }
  __syncthreads();

  // colp[i * sw + o]: band row i - pad (i in [0, BIL_R + 2 pad)), column offset o
  const int r0 = ty * BIL_R;
  const float* colp = tile + r0 * sw + lane + pad;
  float centre[BIL_R], num[BIL_R], den[BIL_R];
#pragma unroll
  for (int r = 0; r < BIL_R; ++r) {
    centre[r] = colp[(r + pad) * sw];
    num[r] = centre[r];  // the centre tap, weight exactly 1
    den[r] = 1.0f;
  }
  if constexpr (K > 0) {
    constexpr int P = K / 2;
    constexpr int NW = BIL_R + 2 * P;  // window length
    float sd[2 * P * P + 1];           // -m a_s by squared distance m; unused entries vanish
#pragma unroll
    for (int m = 0; m <= 2 * P * P; ++m) sd[m] = -(float)m * as;
    {  // dj = 0: the pair (r, r + di) inside the band is computed once, by row r
      float c[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) c[i] = colp[i * sw];
#pragma unroll
      for (int r = 0; r < BIL_R; ++r) {
#pragma unroll
        for (int di = 1; di <= P; ++di) {
          const float w = weight(c[r + P + di], centre[r], sd[di * di]);
          add(w, c[r + P + di], num[r], den[r]);
          if (r + di < BIL_R) add(w, centre[r], num[r + di], den[r + di]);
          if (r - di < 0) add(weight(c[r + P - di], centre[r], sd[di * di]), c[r + P - di], num[r],
                              den[r]);
        }
      }
    }
#pragma unroll
    for (int dj = 1; dj <= P; ++dj) {
      // a: the column dj to the right, b: dj to the left. Each lane computes
      // its pixels' pairs with the column on its right and passes each
      // weight dj lanes on, where it is the pair's weight for the pixel on
      // the right (its tap at (-di, -dj), whose value is b[r + P]); a pair
      // whose left pixel lies outside this thread's band is computed by its
      // right pixel
      float a[NW], b[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        a[i] = colp[i * sw + dj];
        b[i] = colp[i * sw - dj];
      }
#pragma unroll
      for (int r = 0; r < BIL_R; ++r) {
#pragma unroll
        for (int di = -P; di <= P; ++di) {
          const float s = sd[di * di + dj * dj];
          const float w = weight(a[r + P + di], centre[r], s);
          add(w, a[r + P + di], num[r], den[r]);
          const float given = __shfl_up_sync(0xffffffffu, w, dj);
          if (r + di >= 0 && r + di < BIL_R) add(given, b[r + P], num[r + di], den[r + di]);
          if (r - di < 0 || r - di >= BIL_R) {
            add(weight(b[r + P - di], centre[r], s), b[r + P - di], num[r], den[r]);
          }
        }
      }
    }
  } else {
    for (int dj = -pad; dj <= pad; ++dj) {
      for (int di = -pad; di <= pad; ++di) {
        if (di == 0 && dj == 0) continue;
        const float s = -(float)(di * di + dj * dj) * as;
#pragma unroll
        for (int r = 0; r < BIL_R; ++r) {
          const float v = colp[(r + pad + di) * sw + dj];
          add(weight(v, centre[r], s), v, num[r], den[r]);
        }
      }
    }
  }

  const int gx = x0 - HL + lane;
  if (lane < HL || gx >= W) return;
  const float inv_q = 1.0f / q;
  float* dst = out + (size_t)blockIdx.z * H * W + gx;
#pragma unroll
  for (int r = 0; r < BIL_R; ++r) {
    const int gy = y0 + r0 + r;
    if (gy < H) dst[(size_t)gy * W] = num[r] / (den[r] + 1e-8f) * inv_q;
  }
}

template <int K>
int launch(const float* x, float* out, int P, int H, int W, int k, float as, float ar,
           cudaStream_t stream) {
  const int pad = k / 2;
  const size_t smem = (size_t)(BIL_LANES + 2 * pad) * (BIL_TH + 2 * pad) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bilateral_kernel<K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int OW = BIL_LANES - K / 2;
  dim3 grid((W + OW - 1) / OW, (H + BIL_TH - 1) / BIL_TH, P);
  dim3 block(BIL_LANES, BIL_TY);
  bilateral_kernel<K><<<grid, block, smem, stream>>>(x, out, H, W, k, as, ar);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (P, H, W) float32; k odd with k / 2 < H and W; a_s, a_r =
// log2(e) / (2 sigma^2) of the spatial and the range Gaussian.
extern "C" int bilateral_filter_launch(const void* x, void* out, int P, int H, int W, int k,
                                       float a_s, float a_r, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((size_t)P * H * W == 0) return 0;
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  switch (k) {
    case 3: return launch<3>(xp, op, P, H, W, k, a_s, a_r, stream);
    case 5: return launch<5>(xp, op, P, H, W, k, a_s, a_r, stream);
    case 7: return launch<7>(xp, op, P, H, W, k, a_s, a_r, stream);
    case 9: return launch<9>(xp, op, P, H, W, k, a_s, a_r, stream);
    default: return launch<0>(xp, op, P, H, W, k, a_s, a_r, stream);
  }
}
