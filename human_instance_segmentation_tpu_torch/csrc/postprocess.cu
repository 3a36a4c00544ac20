// Binary-mask edge smoothing on float32 planes (P, H, W) for Hopper.
//
// Replaces the JAX package's Pallas kernel
// human_instance_segmentation_tpu/ops/pallas_kernels.py::edge_smooth_pallas
// (kernel _edge_smooth_kernel :112-139). The TPU kernel takes planes padded
// outside the kernel, keeps one whole padded plane in VMEM and walks it in
// row tiles, with column shifts as lane rolls. Here the zero padding is
// resolved by global coordinate on load and the thresholds are launch
// arguments. (The bilateral filter, the file's other Pallas kernel, is
// csrc/bilateral.cu.)
//
// edge_smooth: |8c - sum(neighbours)| -> sigmoid(. * strength) -> blend of c
// with the 1-2-1 blur / 16 -> > threshold, zero padding.
//
// Bound: bytes, 4 in and 4 out a pixel; one expf and one division a pixel
// are far from any limit. So the design moves each byte once, in wide
// accesses, with many loads in flight:
// - a warp owns a segment of 32 * V columns of kRows output rows of one
//   plane; each lane owns V adjacent columns (V = 4: one 16-byte load
//   and store a row; V = 1 for widths that are not a multiple of 4 or a base
//   that is not 16-byte aligned, picked by the wrapper);
// - it loads its strip's rows and the halo row above and below into
//   registers before computing anything, so every load of the strip is in
//   flight together;
// - the left and right neighbour columns come from the adjacent lanes
//   (__shfl_up_sync / __shfl_down_sync); only lane 0 and lane 31 load one
//   extra scalar a row;
// - rows -1 and H and columns -1 and W read as 0, by global coordinate;
// - loads through the read-only path (ld.global.nc), streaming stores
//   (__stcs); a block's eight warps are eight strips of one segment, one
//   below the other, so a halo row is the row a neighbouring warp of the
//   same block reads, and can come from L1;
// - the grid is (strips / 8, segments, planes), so no thread divides by a
//   runtime value; at the served (32, 480, 640) shape 38,400 warps, about
//   six waves over 132 SMs.
// What limits it is how many warps an SM holds while their loads are out,
// against the halo rows each warp reads again: 2 rows a warp at 6 blocks an
// SM (40 registers) was the fastest build, ahead of 4 rows at 4 blocks and
// of 8 rows at 88 registers, and an L2 prefetch of a warp's next strip
// only slowed it (scripts/profile_torch_kernels.py edge; PERF.md).
// The arithmetic is the plain version's, grouped as before (corners and
// sides summed in pairs, the _rn intrinsics so nvcc forms no FMA the plain
// version lacks, full expf and 1 / (1 + e)): the output is a threshold and
// must not flip on a contraction.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 2;   // output rows a warp
constexpr int kWarps = 8;  // warps a block, one strip below the other
constexpr int kMinBlocks = 6;  // blocks an SM must hold: a cap of 40 registers
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float smooth_px(float ul, float u, float ur, float l, float c, float r,
                                           float dl, float d, float dr, float strength,
                                           float threshold) {
  const float corners = (ul + ur) + (dl + dr);
  const float sides = (u + l) + (r + d);
  const float edges = fabsf(__fsub_rn(__fmul_rn(8.0f, c), __fadd_rn(corners, sides)));
  const float ew = 1.0f / (1.0f + expf(-__fmul_rn(edges, strength)));
  const float blurred = __fmul_rn(
      __fadd_rn(__fadd_rn(corners, __fmul_rn(2.0f, sides)), __fmul_rn(4.0f, c)), 1.0f / 16.0f);
  const float smoothed =
      __fadd_rn(__fmul_rn(c, __fsub_rn(1.0f, ew)), __fmul_rn(blurred, ew));
  return smoothed > threshold ? 1.0f : 0.0f;
}

// Row y's V columns from x0 (zeros outside the plane). V = 4 needs W % 4 == 0
// and a 16-byte aligned plane, so a lane's columns are all in or all out.
template <int V>
__device__ __forceinline__ void load_row(const float* plane, int y, int x0, int H, int W,
                                         float (&a)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = 0.0f;
  if (y < 0 || y >= H || x0 >= W) return;
  const float* p = plane + (size_t)y * W + x0;
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    a[0] = t.x;
    a[1] = t.y;
    a[2] = t.z;
    a[3] = t.w;
  } else {
    a[0] = __ldg(p);
  }
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    edge_smooth_kernel(const float* __restrict__ m, float* __restrict__ out, int H, int W,
                       float strength, float threshold) {
  // grid: (strips / kWarps, segments, planes); no division by a runtime value
  const int lane = threadIdx.x & 31;
  const int y0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (y0 >= H) return;  // the whole warp
  const int seg = blockIdx.y;
  const size_t p = blockIdx.z;
  const float* plane = m + p * H * W;
  const int xs = seg * 32 * V;  // the segment's first column
  const int x0 = xs + lane * V;

  // the strip and its halo rows, every load issued before any is used
  float v[kRows + 2][V];
  float halo[kRows + 2];  // lane 0: column xs - 1; lane 31: column xs + 32 V
  const int hx = lane == 0 ? xs - 1 : xs + 32 * V;
  const bool edge_lane = (lane == 0 && hx >= 0) || (lane == 31 && hx < W);
#pragma unroll
  for (int i = 0; i < kRows + 2; ++i) {
    const int y = y0 - 1 + i;
    load_row<V>(plane, y, x0, H, W, v[i]);
    halo[i] = (edge_lane && y >= 0 && y < H) ? __ldg(plane + (size_t)y * W + hx) : 0.0f;
  }
  float left[kRows + 2], right[kRows + 2];
#pragma unroll
  for (int i = 0; i < kRows + 2; ++i) {
    const float l = __shfl_up_sync(kFull, v[i][V - 1], 1);
    const float r = __shfl_down_sync(kFull, v[i][0], 1);
    left[i] = lane == 0 ? halo[i] : l;
    right[i] = lane == 31 ? halo[i] : r;
  }

  if (x0 >= W) return;  // after the shuffles: these lanes only handed on zeros
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + r;
    if (y >= H) break;
    float o[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float ul = j == 0 ? left[r] : v[r][j - 1];
      const float ur = j == V - 1 ? right[r] : v[r][j + 1];
      const float l = j == 0 ? left[r + 1] : v[r + 1][j - 1];
      const float rt = j == V - 1 ? right[r + 1] : v[r + 1][j + 1];
      const float dl = j == 0 ? left[r + 2] : v[r + 2][j - 1];
      const float dr = j == V - 1 ? right[r + 2] : v[r + 2][j + 1];
      o[j] = smooth_px(ul, v[r][j], ur, l, v[r + 1][j], rt, dl, v[r + 2][j], dr, strength,
                       threshold);
    }
    float* q = out + (p * H + y) * W + x0;
    if constexpr (V == 4) {
      __stcs(reinterpret_cast<float4*>(q), make_float4(o[0], o[1], o[2], o[3]));
    } else {
      __stcs(q, o[0]);
    }
  }
}

template <int V>
int launch(const float* m, float* out, int P, int H, int W, float strength, float threshold,
           cudaStream_t stream) {
  if (P > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);  // gridDim.z
  const int strips = (H + kRows - 1) / kRows;
  const dim3 grid((strips + kWarps - 1) / kWarps, (W + 32 * V - 1) / (32 * V), P);
  edge_smooth_kernel<V><<<grid, kWarps * 32, 0, stream>>>(m, out, H, W, strength, threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mask, out: (P, H, W) float32. vec: columns a lane, 4 (W % 4 == 0, both
// pointers 16-byte aligned) or 1 (any width and alignment).
extern "C" int edge_smooth_launch(const void* mask, void* out, int P, int H, int W, int vec,
                                  float strength, float threshold, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if ((size_t)P * H * W == 0) return 0;
  const float* m = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  if (vec == 4) {
    if (W % 4 || reinterpret_cast<uintptr_t>(m) % 16 || reinterpret_cast<uintptr_t>(o) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<4>(m, o, P, H, W, strength, threshold, stream);
  }
  if (vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<1>(m, o, P, H, W, strength, threshold, stream);
}
