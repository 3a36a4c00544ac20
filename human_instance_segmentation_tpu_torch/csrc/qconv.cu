// s8 convolution of the int8 serving path, for Hopper: ops/quant.py's
// qconv2d (every QConv outside the fused unit) and s8_matmul.
//
// Replaces, on the TPU side: XLA's s8 x s8 -> s32 conv_general_dilated that
// human_instance_segmentation_tpu/ops/quant.py::qconv2d (:232) lowers to,
// and the Pallas s8 GEMM probe scripts/exp_r4_probe.py::probe_mosaic_int8
// (pallas_call :59, a 256x256 s8 dot) and bench_pallas_matmul_int8 (:86, a
// 4096^3 s8 GEMM timed against the int8 peak). A 1x1 conv over M pixels is
// exactly that GEMM, so s8_matmul runs the wide kernel on a one-row image of
// M pixels with an int32 output, the same main loop without the epilogue's
// float steps.
//
// The kernels are in csrc/s8_igemm.cuh (design, bounds and rounding are noted
// there): wgmma for Co > 32 and a one-launch mma.sync kernel that quantizes
// its input tile into shared memory for Co <= 32, instantiated in csrc/
// s8_wide.cu, s8_wide_1wg.cu and s8_narrow.cu so that they compile side by
// side; this file holds the dispatch and the quantize-once staging pass. The int8 form of the fused
// unit (csrc/conv_ln_act.cu) calls s8_conv_launch too, with qmode 1. x is read through its strides
// as a logical (N, Ci, H, W) tensor, the weights come packed K-major, and
// the output is NHWC. qconv2d divides: a float input is quantized as
// round(x / sx) with __fdiv_rn, and the epilogue is float(acc) * (sx * sw[co])
// cast to the output dtype, then + bias[co] in that dtype, as in JAX
// (qconv2d's cast, then QConv's add).

#include "s8_igemm.cuh"

// The kernels of the two regimes are compiled in translation units of their
// own, beside this one: csrc/s8_wide.cu, csrc/s8_wide_1wg.cu, csrc/s8_narrow.cu.
extern "C" int s8_wide_launch_2wg(int bn, const void* xq, long long sN, long long sH,
                                  long long sW, const void* wp, int Kp, const void* scale,
                                  const void* bias, void* out, int out_dtype, int Co, int N, int H,
                                  int W, int cpc, int k, int pad, int Ho, int Wo,
                                  void* stream_ptr);
extern "C" int s8_wide_launch_1wg(int bn, const void* xq, long long sN, long long sH,
                                  long long sW, const void* wp, int Kp, const void* scale,
                                  const void* bias, void* out, int out_dtype, int Co, int N, int H,
                                  int W, int cpc, int k, int pad, int Ho, int Wo,
                                  void* stream_ptr);
extern "C" int s8_narrow_launch(const void* x, long long sn, long long sc, long long sh,
                                long long sw, int in_dtype, const void* wp, int Kp,
                                const void* qparam, int qmode, const void* scale, const void* bias,
                                void* out, int out_dtype, int Co, int N, int H, int W, int Ci,
                                int k, int pad, int Ho, int Wo, void* stream_ptr);

namespace {

using namespace s8igemm;

cudaError_t launch_wide_any(const void* xq, long long sN, long long sH, long long sW,
                            const void* wp, int Kp, const float* scale, const float* bias,
                            void* out, int out_dtype, int Co, int N, int H, int W, int cpc, int k,
                            int pad, int Ho, int Wo, cudaStream_t stream) {
  const WideTile t = pick_wide_tile((long long)N * Ho * Wo, Co, k, cpc);
  return static_cast<cudaError_t>(
      (t.wgs == 2 ? s8_wide_launch_2wg : s8_wide_launch_1wg)(t.bn, xq, sN, sH, sW, wp, Kp, scale,
                                                             bias, out, out_dtype, Co, N, H, W,
                                                             cpc, k, pad, Ho, Wo, stream));
}

// x viewed (N, Ci, H, W) through st; wp (Co, packed_k(Ci, k)) int8; out (N,
// H + 2 pad - k + 1, W + 2 pad - k + 1, Co). qparam points at one float32,
// the divisor for Q_DIV, the multiplier for Q_MUL (unused for an int8
// input). scale (Co,) float32 (unused for OUT_S32), bias (Co,) float32 or
// null. xq_ws: the staging buffer where needs_staging() says so. Returns
// cudaErrorInvalidValue for a missing staging buffer or an unknown dtype,
// else cudaGetLastError().
cudaError_t launch(const void* x, const Strides& st, int in_dtype, const void* wp,
                   const float* qparam, int qmode, const float* scale, const float* bias,
                   void* out, int out_dtype, void* xq_ws, int N, int H, int W, int Ci, int Co,
                   int k, int pad, cudaStream_t stream) {
  const int Ho = H + 2 * pad - k + 1, Wo = W + 2 * pad - k + 1;
  if (N == 0 || Ho <= 0 || Wo <= 0 || Co == 0) return cudaSuccess;
  if (in_dtype != IN_F32 && in_dtype != IN_BF16 && in_dtype != IN_S8) return cudaErrorInvalidValue;
  const int Kp = packed_k(Ci, k);
  if (takes_narrow(Ci, Co, k))
    return static_cast<cudaError_t>(s8_narrow_launch(x, st.n, st.c, st.h, st.w, in_dtype, wp, Kp,
                                                     qparam, qmode, scale, bias, out, out_dtype,
                                                     Co, N, H, W, Ci, k, pad, Ho, Wo, stream));
  const int Cp = (Ci + 15) / 16 * 16;
  if (!needs_staging(x, st, in_dtype, Ci, Co, k))
    return launch_wide_any(x, st.n, st.h, st.w, wp, Kp, scale, bias, out, out_dtype, Co, N, H, W,
                           Cp / 16, k, pad, Ho, Wo, stream);
  if (xq_ws == nullptr) return cudaErrorInvalidValue;
  int8_t* xq = static_cast<int8_t*>(xq_ws);
  cudaError_t err;
  switch (in_dtype) {
    case IN_F32: err = launch_stage<float>(x, st, xq, N, H, W, Ci, Cp, qparam, qmode, stream); break;
    case IN_BF16:
      err = launch_stage<__nv_bfloat16>(x, st, xq, N, H, W, Ci, Cp, qparam, qmode, stream);
      break;
    default: err = launch_stage<int8_t>(x, st, xq, N, H, W, Ci, Cp, qparam, qmode, stream); break;
  }
  if (err != cudaSuccess) return err;
  return launch_wide_any(xq, (long long)H * W * Cp, (long long)W * Cp, Cp, wp, Kp, scale, bias, out,
                         out_dtype, Co, N, H, W, Cp / 16, k, pad, Ho, Wo, stream);
}

}  // namespace

// Whether s8_conv_launch needs xq_ws for this input, an int8 buffer of
// N * H * W rows of Ci rounded up to 16 codes: 1 or 0 (not a launcher).
extern "C" int s8_conv_needs_staging(const void* x, long long sn, long long sc, long long sh,
                                     long long sw, int in_dtype, int Ci, int Co, int k) {
  const s8igemm::Strides st{sn, sc, sh, sw};
  return s8igemm::needs_staging(x, st, in_dtype, Ci, Co, k) ? 1 : 0;
}

// Bytes in one packed weight row for (Ci, k) (not a launcher).
extern "C" int s8_conv_packed_k(int Ci, int k) { return s8igemm::packed_k(Ci, k); }

extern "C" int s8_conv_launch(const void* x, long long sn, long long sc, long long sh,
                              long long sw, int in_dtype, const void* wp, const void* qparam,
                              int qmode, const void* scale, const void* bias, void* out,
                              int out_dtype, void* xq_ws, int N, int H, int W, int Ci, int Co,
                              int k, int pad, void* stream_ptr) {
  const s8igemm::Strides st{sn, sc, sh, sw};
  return static_cast<int>(launch(x, st, in_dtype, wp, static_cast<const float*>(qparam), qmode,
                                 static_cast<const float*>(scale),
                                 static_cast<const float*>(bias), out, out_dtype, xq_ws, N, H, W,
                                 Ci, Co, k, pad, static_cast<cudaStream_t>(stream_ptr)));
}
