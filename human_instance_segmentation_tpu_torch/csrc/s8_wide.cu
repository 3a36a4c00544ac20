// The wgmma kernels of the s8 conv core (csrc/s8_igemm.cuh, wide regime: more
// than 32 output channels, the fused unit's conv, s8_matmul) for blocks of two
// warpgroups (128 pixels), in a translation unit of their own so that they
// compile beside csrc/qconv.cu, which holds the dispatch. Not called from
// Python: s8_conv_launch (csrc/qconv.cu) is the entry point.

#include "s8_igemm.cuh"

// xq: int8 pixels of cpc * 16 codes, byte strides sN, sH, sW, every pixel
// 16-byte aligned; wp (Co, Kp) int8 packed K-major; out (N, Ho, Wo, Co); bn:
// the tile's width in output channels (64, 96 or 128).
extern "C" int s8_wide_launch_2wg(int bn, const void* xq, long long sN, long long sH,
                                  long long sW, const void* wp, int Kp, const void* scale,
                                  const void* bias, void* out, int out_dtype, int Co, int N, int H,
                                  int W, int cpc, int k, int pad, int Ho, int Wo,
                                  void* stream_ptr) {
  const s8igemm::Epilogue ep{static_cast<const float*>(scale), static_cast<const float*>(bias), out,
                             out_dtype, Co};
  return static_cast<int>(s8igemm::launch_wide<2>(
      bn, static_cast<const int8_t*>(xq), sN, sH, sW, static_cast<const int8_t*>(wp), Kp, ep, N, H,
      W, cpc, k, pad, Ho, Wo, static_cast<cudaStream_t>(stream_ptr)));
}
