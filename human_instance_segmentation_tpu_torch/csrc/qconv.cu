// s8 convolution of the int8 serving path, for Hopper: ops/quant.py's
// qconv2d (every QConv outside the fused unit) and s8_matmul.
//
// Replaces, on the TPU side: XLA's s8 x s8 -> s32 conv_general_dilated that
// human_instance_segmentation_tpu/ops/quant.py::qconv2d (:232) lowers to,
// and the Pallas s8 GEMM probe scripts/exp_r4_probe.py::probe_mosaic_int8
// (pallas_call :59, a 256x256 s8 dot) and bench_pallas_matmul_int8 (:86, a
// 4096^3 s8 GEMM timed against the int8 peak). A 1x1 conv over M pixels is
// exactly that GEMM, so s8_matmul runs this kernel with H = 1, W = M, k = 1
// and an int32 output, the same main loop without the epilogue.
//
// The kernel is csrc/s8_igemm.cuh (design, bounds and rounding are noted
// there). qconv2d divides: a float input is quantized once, into the
// staging buffer xq_ws, as round(x / sx) with __fdiv_rn (quant.py:176), and
// the epilogue is float(acc) * (sx * sw[co]) cast to the output dtype
// (quant.py:237); the bias is added afterwards in the output dtype, by
// QConv, as in JAX.

#include "s8_igemm.cuh"

extern "C" int s8_conv_launch(const void* x, const void* w, const void* qparam, int qmode,
                              const void* scale, const void* bias, void* out, void* xq_ws, int N,
                              int H, int W, int Ci, int Co, int k, int pad, int in_dtype,
                              int out_dtype, void* stream_ptr) {
  return static_cast<int>(s8igemm::launch<0>(
      x, w, static_cast<const float*>(qparam), qmode, static_cast<const float*>(scale),
      static_cast<const float*>(bias), out, xq_ws, N, H, W, Ci, Co, k, pad, in_dtype, out_dtype,
      static_cast<cudaStream_t>(stream_ptr)));
}
