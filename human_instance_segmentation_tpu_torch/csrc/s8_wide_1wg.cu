// The wgmma kernels of the s8 conv core (csrc/s8_igemm.cuh, wide regime) for
// blocks of one warpgroup (64 pixels: the small maps of stage 2), compiled
// beside csrc/s8_wide.cu. Not called from Python: s8_conv_launch
// (csrc/qconv.cu) is the entry point.

#include "s8_igemm.cuh"

// As s8_wide_launch_2wg (csrc/s8_wide.cu).
extern "C" int s8_wide_launch_1wg(int bn, const void* xq, long long sN, long long sH,
                                  long long sW, const void* wp, int Kp, const void* scale,
                                  const void* bias, void* out, int out_dtype, int Co, int N, int H,
                                  int W, int cpc, int k, int pad, int Ho, int Wo,
                                  void* stream_ptr) {
  const s8igemm::Epilogue ep{static_cast<const float*>(scale), static_cast<const float*>(bias), out,
                             out_dtype, Co};
  return static_cast<int>(s8igemm::launch_wide<1>(
      bn, static_cast<const int8_t*>(xq), sN, sH, sW, static_cast<const int8_t*>(wp), Kp, ep, N, H,
      W, cpc, k, pad, Ho, Wo, static_cast<cudaStream_t>(stream_ptr)));
}
