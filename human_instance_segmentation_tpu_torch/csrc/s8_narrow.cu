// The one-launch kernel of the s8 conv core for narrow outputs (csrc/
// s8_igemm.cuh, Co <= 32: the last two decoder stages, the logit heads), in a
// translation unit of its own so that it compiles beside csrc/qconv.cu, which
// holds the dispatch. Not called from Python: s8_conv_launch (csrc/qconv.cu)
// is the entry point.

#include "s8_igemm.cuh"

// x viewed (N, Ci, H, W) through its element strides, float32, bf16 or int8
// (in_dtype); wp (Co, Kp) int8 packed K-major; out (N, Ho, Wo, Co).
extern "C" int s8_narrow_launch(const void* x, long long sn, long long sc, long long sh,
                                long long sw, int in_dtype, const void* wp, int Kp,
                                const void* qparam, int qmode, const void* scale, const void* bias,
                                void* out, int out_dtype, int Co, int N, int H, int W, int Ci,
                                int k, int pad, int Ho, int Wo, void* stream_ptr) {
  const s8igemm::Strides st{sn, sc, sh, sw};
  const s8igemm::Epilogue ep{static_cast<const float*>(scale), static_cast<const float*>(bias), out,
                             out_dtype, Co};
  return static_cast<int>(s8igemm::launch_narrow(
      x, in_dtype, st, static_cast<const int8_t*>(wp), Kp, static_cast<const float*>(qparam), qmode,
      ep, N, H, W, Ci, k, pad, Ho, Wo, static_cast<cudaStream_t>(stream_ptr)));
}
