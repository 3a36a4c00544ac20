// s8 x s8 -> s32 implicit-GEMM convolution for Hopper (stride 1, symmetric
// zero padding), shared by csrc/qconv.cu (qconv2d and s8_matmul) and
// csrc/conv_ln_act.cu (the int8 form of the fused unit).
//
// Replaces, on the TPU side: XLA's s8 conv_general_dilated behind
// human_instance_segmentation_tpu/ops/quant.py::qconv2d, the s8 dot of the
// quantized branch of ops/pallas_head.py::_kernel, and the Pallas s8 GEMM
// probes scripts/exp_r4_probe.py:59 and :86.
//
// Operands. x is read as a logical (N, C, H, W) tensor through its element
// strides, so channels-last memory, contiguous NCHW memory and an NHWC
// tensor viewed as NCHW all come in without a copy; float32, bf16 or int8.
// The weights arrive packed once by the wrapper (ops/quant.py::
// pack_weight_kmajor): one row per output channel, the contraction index
// K = tap * Cp + c fastest (Cp = Ci rounded up to 16), zero codes past Ci
// and the row zero-padded to Kp, a multiple of 128 bytes. That is the
// K-major B operand wgmma needs for 8-bit types, and the same rows serve the
// mma.sync path. The output is NHWC.
//
// Two regimes, chosen by Co:
//
//  wide (Co > 32; qconv2d, the fused unit and s8_matmul alike):
//    tensor-core work. On this card only wgmma reaches the int8 rate, so a
//    block of one or two warpgroups owns a (64 or 128 pixels) x BN tile, BN
//    in {64, 96, 128} following Co, and issues
//    wgmma.mma_async m64nBNk32 s8 with the s32 sums in registers. Pixels are
//    numbered across the whole batch (a 16x12 ROI map would not fill one
//    tile), and the tile shape is picked per launch so that small maps still
//    spread over the 132 SMs (pick_wide_tile). A and B tiles are 128 bytes of K
//    per row in the 128-byte swizzle the wgmma descriptor names: the 16-byte
//    chunk c of row r lies at r * 128 + ((c ^ (r & 7)) << 4), eight rows to a
//    1024-byte group. K is walked in 16-byte chunks of the flattened (tap,
//    channel) index, so a 64-channel conv packs two taps into one 128-byte
//    step and no step multiplies padding: an im2col at chunk granularity,
//    each chunk a zero-filling cp.async from the shifted pixel. A ring of
//    three stages is filled two steps ahead. A step has two barriers: one
//    publishes the stage that landed, one frees the stage of the step before;
//    the wgmma group just issued is running across both (wait_group 1).
//    Measured, a block's loads and products still do not overlap (every
//    thread issues cp.async; a producer warp would), so the ring is kept
//    short: three stages let two or three blocks share an SM and overlap each
//    other (four stages were 10-30% slower on the convs, two on the GEMM).
//    The epilogue runs straight from the accumulator registers. A float input
//    is first quantized once into an int8 buffer of N*H*W rows of Cp codes
//    (stage_kernel); an int8 input whose pixels are 16-byte aligned rows of
//    Ci = Cp codes is read where it lies.
//
//  narrow (Co <= 32: the last two decoder stages and the logit heads):
//    bound by bytes (decoder4/conv0 moves 0.94 GB for 0.15 TOP). One launch:
//    a block reads a 16 x 32 output tile's input with its halo through x's
//    strides, quantizes every value once into a pixel-major int8 tile in
//    shared memory, runs all k*k taps from it with mma.sync m16n8k32 (ldmatrix
//    fragment loads at the tap's shift; pixel and weight rows padded so that
//    a load's eight rows touch 32 banks), and writes the output once. No int8
//    copy of the input in device memory, no second launch. What is left
//    between it and its byte bound is the quantizer's arithmetic (eight or
//    nine operations a value, see Quantizer) and the serial fill - multiply -
//    store of a block, hidden only by the other blocks of the SM.
//
// The kernels are templates; csrc/s8_wide.cu, s8_wide_1wg.cu and s8_narrow.cu
// instantiate them side by side, csrc/qconv.cu holds the dispatch and the
// staging pass.
//
// Quantizers, one correctly rounded op per step so nvcc cannot contract or
// approximate them:
//   Q_DIV  round(x / s)             (qconv2d divides)
//   Q_MUL  round(x * s), s = 1/xs   (the fused unit multiplies)
// __fdiv_rn / __fmul_rn, a clip to +-127 and a round half to even (as
// jnp.round and torch.round) done by a float add (see Quantizer).
//
// Epilogue: int32 out (s8_matmul), or v = float(acc) * scale[co] rounded to
// the output type, then (if given) + bias[co] in that type (bf16: both
// widened, added in float32, rounded once): JAX's order, qconv2d's cast and
// then QConv's add. With a float32 output this is also the fused unit's
// float(acc) * qscale + b.
//
// Integer sums are exact in any order (|acc| <= K * 127^2 < 2^31 for every
// K of this model), so both regimes equal the plain version bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

// Internal linkage: each .cu that includes this gets its own copy of the
// kernels (two translation units sharing a weak __global__ template stub
// would register one host symbol for two device modules).
namespace s8igemm {
namespace {

enum { Q_DIV = 0, Q_MUL = 1 };
enum { IN_F32 = 0, IN_BF16 = 1, IN_S8 = 2 };
enum { OUT_F32 = 0, OUT_BF16 = 1, OUT_S32 = 2 };

// Element strides of x viewed as (N, C, H, W).
struct Strides {
  long long n, c, h, w;
};

// What the epilogue needs: per-channel scale and optional bias (float32),
// the NHWC output and its type.
struct Epilogue {
  const float* scale;
  const float* bias;
  void* out;
  int out_dtype;
  int Co;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The quantizer of one launch. Rounding to the nearest code needs neither
// rintf nor a float-to-int conversion (both run on the quarter-rate
// conversion unit, which would bound the byte-bound kernels): adding 1.5 *
// 2^23 rounds t to an integer, ties to even, in the sum's low mantissa bits,
// whose low byte is the two's-complement code. Q_DIV must equal round(x / s)
// with a correctly rounded division; x * RN(1 / s) is within 2^-22 of it, so
// it gives the same code unless it lies within 2.5e-4 of a tie (eight times
// the error at |t| <= 127; past the clip both give +-127); only a 16-value
// vector that holds such a value is redone with the division (about one in
// 100).
constexpr float ROUND_MAGIC = 12582912.0f;  // 1.5 * 2^23
struct Quantizer {
  float s, r;  // the scale parameter; its reciprocal, or 0 when that cannot be used
  int qmode;
};
__device__ __forceinline__ Quantizer make_quantizer(const float* qparam, int qmode) {
  Quantizer q{*qparam, 0.0f, qmode};
  if (qmode == Q_DIV) {
    const float r = __frcp_rn(q.s);
    if (r > 0.0f && r < 3.0e38f && q.s > 1.0e-30f) q.r = r;
  }
  return q;
}
__device__ __forceinline__ float clip127(float t) { return fminf(fmaxf(t, -127.0f), 127.0f); }
// Four codes in one word, from the low bytes of four rounded sums.
__device__ __forceinline__ unsigned pack4(unsigned c0, unsigned c1, unsigned c2, unsigned c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040), 0x5410);
}
__device__ __forceinline__ unsigned round_bits(float t) {
  return __float_as_uint(__fadd_rn(clip127(t), ROUND_MAGIC));
}
// The exact Q_DIV codes of four values; out of line, it runs rarely.
__device__ __noinline__ unsigned quantize4_div(float a, float b, float c, float d, float s) {
  return pack4(round_bits(__fdiv_rn(a, s)), round_bits(__fdiv_rn(b, s)),
               round_bits(__fdiv_rn(c, s)), round_bits(__fdiv_rn(d, s)));
}

// Sixteen values of type T as they lie in memory, in 32-bit registers (an
// array of T indexed below 32 bits would be kept in local memory).
template <typename T>
struct Raw16 {
  unsigned w[4 * sizeof(T)];
};
template <typename T>
__device__ __forceinline__ void zero16(Raw16<T>& raw) {
#pragma unroll
  for (int j = 0; j < 4 * (int)sizeof(T); ++j) raw.w[j] = 0u;
}
__device__ __forceinline__ unsigned bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ unsigned bits_of(int8_t v) { return static_cast<uint8_t>(v); }
// Sixteen channels c0 .. c0 + 15 of the pixel at p with channel stride sc,
// zero past Ci, one value at a time (ragged or unaligned channels, NCHW
// memory); out of line, the served layouts take the vector loads.
template <typename T>
__device__ __noinline__ Raw16<T> load16_scalar(const T* p, long long sc, int c0, int Ci) {
  constexpr int kPerWord = 4 / sizeof(T);
  Raw16<T> raw;
  zero16(raw);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c0 + i < Ci)
      raw.w[i / kPerWord] |= bits_of(p[(long long)(c0 + i) * sc]) << (32 / kPerWord * (i % kPerWord));
  return raw;
}
// The same; vec: sc == 1, Ci is a whole number of 16-byte loads and p is
// 16-byte aligned, so the values come as 16-byte loads (zeros past Ci).
template <typename T>
__device__ __forceinline__ void load16(Raw16<T>& raw, const T* p, long long sc, int c0, int Ci,
                                       bool vec) {
  constexpr int kPer = 16 / sizeof(T);  // values in a 16-byte load
  if (vec) {
#pragma unroll
    for (int j = 0; j < (int)sizeof(T); ++j) {
      uint4 q = make_uint4(0, 0, 0, 0);
      if (c0 + (j + 1) * kPer <= Ci) q = reinterpret_cast<const uint4*>(p + c0)[j];
      raw.w[4 * j] = q.x, raw.w[4 * j + 1] = q.y, raw.w[4 * j + 2] = q.z, raw.w[4 * j + 3] = q.w;
    }
  } else {
    raw = load16_scalar<T>(p, sc, c0, Ci);
  }
}
template <typename T>
__device__ __forceinline__ float value_of(const Raw16<T>& raw, int i);
template <>
__device__ __forceinline__ float value_of<float>(const Raw16<float>& raw, int i) {
  return __uint_as_float(raw.w[i]);
}
template <>
__device__ __forceinline__ float value_of<__nv_bfloat16>(const Raw16<__nv_bfloat16>& raw, int i) {
  return __uint_as_float(i % 2 ? raw.w[i / 2] & 0xFFFF0000u : raw.w[i / 2] << 16);
}
// The sixteen values as int8 codes (an int8 input is passed through).
template <typename T>
__device__ __forceinline__ uint4 pack16(const Raw16<T>& raw, const Quantizer& q) {
  if constexpr (std::is_same<T, int8_t>::value) {
    return make_uint4(raw.w[0], raw.w[1], raw.w[2], raw.w[3]);
  } else {
    // t = x * (1 / s) or x * s; its code, and whether t - rint(t) is within
    // the approximation's reach of a tie
    const float m = q.qmode == Q_DIV ? q.r : q.s;
    bool near_tie = false;
    float v[16];
    unsigned c[16], w[4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[i] = value_of<T>(raw, i);
      const float t = clip127(__fmul_rn(v[i], m));
      const float u = __fadd_rn(t, ROUND_MAGIC);
      near_tie |= fabsf(__fsub_rn(t, __fsub_rn(u, ROUND_MAGIC))) > 0.5f - 2.5e-4f;
      c[i] = __float_as_uint(u);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = pack4(c[4 * j], c[4 * j + 1], c[4 * j + 2], c[4 * j + 3]);
    if (q.qmode == Q_DIV && (near_tie || q.r == 0.0f)) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = quantize4_div(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3], q.s);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Whether every pixel of x is a run of channels that 16-byte loads can take
// (load16); with whole = 16 also a run of whole 16-code vectors, which the
// wgmma kernel can read in place from an int8 x.
template <typename T>
bool vector_rows(const void* x, const Strides& st, int Ci, int whole = 16 / sizeof(T)) {
  const long long e = 16 / sizeof(T);
  return st.c == 1 && Ci % whole == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
         st.n % e == 0 && st.h % e == 0 && st.w % e == 0;
}

// The epilogue's per-channel operands for channels co and co + 1.
struct ChannelPair {
  float s0, s1, b0, b1;
};
__device__ __forceinline__ ChannelPair load_channels(const Epilogue& e, int co) {
  ChannelPair c{0.0f, 0.0f, 0.0f, 0.0f};
  if (e.out_dtype == OUT_S32 || co >= e.Co) return c;
  const bool two = co + 1 < e.Co;
  c.s0 = e.scale[co];
  if (two) c.s1 = e.scale[co + 1];
  if (e.bias != nullptr) {
    c.b0 = e.bias[co];
    if (two) c.b1 = e.bias[co + 1];
  }
  return c;
}
// The same from the block's copies in shared memory (index i, i + 1 in range).
__device__ __forceinline__ ChannelPair shared_channels(const float* scale, const float* bias, int i) {
  return ChannelPair{scale[i], scale[i + 1], bias[i], bias[i + 1]};
}
// float(acc) * scale rounded to the output type, then + bias in that type.
__device__ __forceinline__ float finish_f32(const Epilogue& e, int acc, float s, float b) {
  const float v = __fmul_rn(__int2float_rn(acc), s);
  return e.bias != nullptr ? __fadd_rn(v, b) : v;
}
__device__ __forceinline__ __nv_bfloat16 finish_bf16(const Epilogue& e, int acc, float s, float b) {
  const __nv_bfloat16 h = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), s));
  return e.bias != nullptr ? __float2bfloat16_rn(__fadd_rn(__bfloat162float(h), b)) : h;
}
// Two neighbouring output channels co, co + 1 (co even) of one pixel (row =
// pixel * Co), from their int32 sums.
__device__ __forceinline__ void store_pair(const Epilogue& e, size_t row, int co, int a0, int a1,
                                           const ChannelPair& c) {
  if (co >= e.Co) return;
  const bool two = co + 1 < e.Co;
  const bool vec = two && e.Co % 2 == 0;  // then the pair is aligned
  const size_t o = row + co;
  if (e.out_dtype == OUT_S32) {
    int* out = static_cast<int*>(e.out);
    if (vec) {
      *reinterpret_cast<int2*>(out + o) = make_int2(a0, a1);
    } else {
      out[o] = a0;
      if (two) out[o + 1] = a1;
    }
  } else if (e.out_dtype == OUT_F32) {
    float* out = static_cast<float*>(e.out);
    const float v0 = finish_f32(e, a0, c.s0, c.b0), v1 = finish_f32(e, a1, c.s1, c.b1);
    if (vec) {
      *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
    } else {
      out[o] = v0;
      if (two) out[o + 1] = v1;
    }
  } else {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(e.out);
    const __nv_bfloat16 v0 = finish_bf16(e, a0, c.s0, c.b0), v1 = finish_bf16(e, a1, c.s1, c.b1);
    if (vec) {
      *reinterpret_cast<__nv_bfloat162*>(out + o) = __halves2bfloat162(v0, v1);
    } else {
      out[o] = v0;
      if (two) out[o + 1] = v1;
    }
  }
}
// The same where the caller knows that both channels exist and that Co is
// even (the pair is aligned), with the output type fixed at compile time: no
// checks, one vector store. o: the pair's element offset in the output.
template <int OUT>
__device__ __forceinline__ void store2(void* out, size_t o, int a0, int a1, const ChannelPair& c,
                                       bool bias) {
  if constexpr (OUT == OUT_S32) {
    *reinterpret_cast<int2*>(static_cast<int*>(out) + o) = make_int2(a0, a1);
  } else {
    float v0 = __fmul_rn(__int2float_rn(a0), c.s0), v1 = __fmul_rn(__int2float_rn(a1), c.s1);
    if constexpr (OUT == OUT_F32) {
      if (bias) v0 = __fadd_rn(v0, c.b0), v1 = __fadd_rn(v1, c.b1);
      *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
    } else {
      __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      if (bias) {
        const float2 f = __bfloat1622float2(h);
        h = __floats2bfloat162_rn(__fadd_rn(f.x, c.b0), __fadd_rn(f.y, c.b1));
      }
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) = h;
    }
  }
}

// ---- quantize-once staging for the wide regime ---------------------------
//
// x -> xq (N*H*W rows of Cp = Ci rounded up to 16 int8 codes, zero past Ci),
// one 16-byte vector of codes per thread. Channels-last memory: consecutive
// threads take consecutive vectors of a pixel. Any other strides: consecutive
// threads take consecutive pixels, so NCHW memory is read along W.
template <typename T>
__global__ void __launch_bounds__(256)
stage_kernel(const T* __restrict__ x, Strides st, int8_t* __restrict__ xq, int N, int H, int W,
             int Ci, int Cp, const float* __restrict__ qparam, int qmode, int vec) {
  const int vecs = Cp / 16;
  const long long R = (long long)N * H * W;
  Quantizer q{1.0f, 0.0f, Q_MUL};
  if constexpr (!std::is_same<T, int8_t>::value) q = make_quantizer(qparam, qmode);
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x; v < R * vecs;
       v += (long long)gridDim.x * blockDim.x) {
    long long r;
    int c0;
    if (st.c == 1) {
      r = v / vecs;
      c0 = (int)(v % vecs) * 16;
    } else {
      r = v % R;
      c0 = (int)(v / R) * 16;
    }
    const int px = (int)(r % W), py = (int)((r / W) % H), n = (int)(r / ((long long)W * H));
    Raw16<T> in;
    load16<T>(in, x + n * st.n + py * st.h + px * st.w, st.c, c0, Ci, vec);
    *reinterpret_cast<uint4*>(xq + r * Cp + c0) = pack16<T>(in, q);
  }
}

template <typename T>
cudaError_t launch_stage(const void* x, const Strides& st, int8_t* xq, int N, int H, int W,
                         int Ci, int Cp, const float* qparam, int qmode, cudaStream_t stream) {
  const long long work = (long long)N * H * W * (Cp / 16);
  if (work == 0) return cudaSuccess;
  const int blocks = (int)(work < (1 << 16) * 256LL ? (work + 255) / 256 : 1 << 16);
  stage_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const T*>(x), st, xq, N, H, W, Ci, Cp,
                                              qparam, qmode, vector_rows<T>(x, st, Ci) ? 1 : 0);
  return cudaGetLastError();
}

// ---- wide regime: wgmma ---------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async writes shared memory through the generic proxy; wgmma reads it
// through the async proxy.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows in
// the 128-byte swizzle: start address, leading offset 1 (unused for this
// layout), 1024 bytes from one 8-row group to the next, layout type 1. A
// 32-byte step along K adds 2 to it.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x BN int32, BN / 2 registers a thread) += A (64 x 32 s8) * B (BN x 32 s8)^T
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
      "}, %48, %49, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "n"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "n"(1));
}

constexpr int STAGES = 3;       // ring depth; the loads run STAGES - 1 steps ahead
constexpr int STEP_BYTES = 128;  // bytes of K per row and step

// the ring, the block's scales and biases, and room to align the ring to 1024 bytes
constexpr int wide_smem_bytes(int bm, int bn) {
  return STAGES * (bm + bn) * STEP_BYTES + 2 * bn * (int)sizeof(float) + 1024;
}

// The epilogue of a block whose BN channels all exist (Co even), for one
// output type: this thread's two rows, pair after pair.
template <int OUT, int BN>
__device__ __forceinline__ void wide_store(const int (&acc)[BN / 2], const Epilogue& ep,
                                           const float* s_scale, const float* s_bias,
                                           long long row, long long M, int co0, int lane) {
  const int cl = 2 * (lane & 3);
  const bool bias = ep.bias != nullptr, r0 = row < M, r1 = row + 8 < M;
  const size_t o0 = (size_t)row * ep.Co + co0 + cl, o1 = o0 + (size_t)8 * ep.Co;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    ChannelPair c{0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (OUT != OUT_S32) c = shared_channels(s_scale, s_bias, 8 * j + cl);
    if (r0) store2<OUT>(ep.out, o0 + 8 * j, acc[4 * j], acc[4 * j + 1], c, bias);
    if (r1) store2<OUT>(ep.out, o1 + 8 * j, acc[4 * j + 2], acc[4 * j + 3], c, bias);
  }
}

// xq: int8 pixels of Cp = cpc * 16 codes, byte
// strides sN, sH, sW, every pixel 16-byte aligned. wp: Co rows of Kp codes.
template <int BN, int WGS>
__global__ void __launch_bounds__(128 * WGS)
wide_kernel(const int8_t* __restrict__ xq, long long sN, long long sH, long long sW,
            const int8_t* __restrict__ wp, int Kp, Epilogue ep, int N, int H, int W, int cpc,
            int k, int pad, int Ho, int Wo) {
  constexpr int BM = 64 * WGS, T = 128 * WGS;
  constexpr int A_BYTES = BM * STEP_BYTES, STAGE_BYTES = (BM + BN) * STEP_BYTES;
  constexpr int ROWS_PER_PASS = T / 8, A_PASSES = BM / ROWS_PER_PASS, B_PASSES = BN / ROWS_PER_PASS;
  static_assert(BN % ROWS_PER_PASS == 0, "B rows divide over the threads");
  extern __shared__ __align__(16) uint8_t s8_wide_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<std::uintptr_t>(s8_wide_smem) + 1023) & ~static_cast<std::uintptr_t>(1023));

  float* s_scale = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  float* s_bias = s_scale + BN;

  const int tid = threadIdx.x;
  const long long M = (long long)N * Ho * Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  // the epilogue's operands, read from shared memory after the main loop's barriers
  if (ep.out_dtype != OUT_S32)
    for (int i = tid; i < BN; i += T) {
      const bool ok = co0 + i < ep.Co;
      s_scale[i] = ok ? ep.scale[co0 + i] : 0.0f;
      s_bias[i] = ok && ep.bias != nullptr ? ep.bias[co0 + i] : 0.0f;
    }
  const int KT = k * k * cpc;  // 16-byte chunks of K that hold data
  const int steps = (KT + 7) / 8;

  // This thread copies chunk column cj of rows r0 + i * ROWS_PER_PASS; the
  // swizzled column is the same for all of them (ROWS_PER_PASS % 8 == 0).
  const int cj = tid & 7, r0 = tid >> 3;
  const int sw_col = (cj ^ (r0 & 7)) << 4;
  long long base[A_PASSES];
  int iy0[A_PASSES], ix0[A_PASSES];
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) {
    const long long m = m0 + r0 + i * ROWS_PER_PASS;
    if (m < M) {  // M < 2^31 (launch_wide_tile): 32-bit divisions
      const unsigned q = (unsigned)m / (unsigned)Wo, n = q / (unsigned)Ho;
      iy0[i] = (int)(q - n * Ho) - pad;
      ix0[i] = (int)((unsigned)m - q * Wo) - pad;
      base[i] = n * sN + iy0[i] * sH + ix0[i] * sW;
    } else {  // a row past M reads only zeros
      iy0[i] = -(1 << 28);
      ix0[i] = 0;
      base[i] = 0;
    }
  }

  auto load = [&](int step, int slot) {
    uint8_t* a_s = smem + slot * STAGE_BYTES;
    uint8_t* b_s = a_s + A_BYTES;
    const int j = step * 8 + cj;
    const int tap = j / cpc, cc = j - tap * cpc;
    const int ky = tap / k, kx = tap - ky * k;
    const bool kvalid = j < KT;
    const long long koff = ky * sH + kx * sW + cc * 16;
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      const int r = r0 + i * ROWS_PER_PASS;
      const int iy = iy0[i] + ky, ix = ix0[i] + kx;
      const bool ok = kvalid && iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp_async16(a_s + r * STEP_BYTES + sw_col, ok ? xq + base[i] + koff : xq, ok ? 16 : 0);
    }
    const int8_t* wk = wp + (size_t)step * STEP_BYTES + cj * 16;
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i) {
      const int r = r0 + i * ROWS_PER_PASS;
      const bool ok = co0 + r < ep.Co;
      cp_async16(b_s + r * STEP_BYTES + sw_col, ok ? wk + (size_t)(co0 + r) * Kp : wp, ok ? 16 : 0);
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  const int wg = tid / 128;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step `it` have landed
    fence_async_proxy();
    __syncthreads();  // everyone's have
    const uint8_t* a_s = smem + (it % STAGES) * STAGE_BYTES;
    const uint64_t da = smem_desc(a_s + wg * 64 * STEP_BYTES), db = smem_desc(a_s + A_BYTES);
    const int nk = min(4, (KT - it * 8 + 1) / 2);  // 32-byte sub-steps that hold data
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < nk) wgmma_s8<BN>(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's products of step it - 1 are done,
    __syncthreads();  // and everyone's: their stage can be refilled while step `it` multiplies
    if (it + STAGES - 1 < steps) load(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
  }
  wgmma_wait<0>();

  // Accumulator layout: warp w of the warpgroup holds rows 16 w .. 16 w + 15;
  // lane l holds, of each 8-column group j, columns 2 (l % 4) and + 1 of rows
  // l / 4 (registers 4 j, 4 j + 1) and l / 4 + 8 (4 j + 2, 4 j + 3).
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const long long row = m0 + wg * 64 + warp * 16 + (lane >> 2);
  if (co0 + BN <= ep.Co && ep.Co % 2 == 0) {  // a whole tile of channels: no checks per pair
    switch (ep.out_dtype) {
      case OUT_BF16: wide_store<OUT_BF16, BN>(acc, ep, s_scale, s_bias, row, M, co0, lane); break;
      case OUT_F32: wide_store<OUT_F32, BN>(acc, ep, s_scale, s_bias, row, M, co0, lane); break;
      default: wide_store<OUT_S32, BN>(acc, ep, s_scale, s_bias, row, M, co0, lane); break;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int co = co0 + 8 * j + 2 * (lane & 3);
    ChannelPair c{0.0f, 0.0f, 0.0f, 0.0f};
    if (ep.out_dtype != OUT_S32) c = shared_channels(s_scale, s_bias, 8 * j + 2 * (lane & 3));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < M)
        store_pair(ep, (size_t)(row + 8 * h) * ep.Co, co, acc[4 * j + 2 * h],
                   acc[4 * j + 2 * h + 1], c);
  }
}

template <int BN, int WGS>
cudaError_t launch_wide_tile(const int8_t* xq, long long sN, long long sH, long long sW,
                             const int8_t* wp, int Kp, const Epilogue& ep, int N, int H, int W,
                             int cpc, int k, int pad, int Ho, int Wo, cudaStream_t stream) {
  constexpr int BM = 64 * WGS, SMEM = wide_smem_bytes(BM, BN);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(wide_kernel<BN, WGS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long M = (long long)N * Ho * Wo;
  if (M >= (1ll << 31) - BM) return cudaErrorInvalidValue;  // the kernel numbers pixels in 32 bits
  const dim3 grid((unsigned)((M + BM - 1) / BM), (ep.Co + BN - 1) / BN);
  wide_kernel<BN, WGS><<<grid, 128 * WGS, SMEM, stream>>>(xq, sN, sH, sW, wp, Kp, ep, N,
                                                                   H, W, cpc, k, pad, Ho, Wo);
  return cudaGetLastError();
}

// Pick the tile (BN, warpgroups). A block of BM x BN costs about BM * BN * (1
// + 32 / BM + 32 / BN) (the products, plus the loads and the epilogue a small
// tile amortises less well), and a launch takes as many rounds as its busiest
// SM gets blocks. Large maps end at 128 x 128 (a 256-wide tile, one block to
// an SM, measured 2-10% slower even on the 4096^3 product); the 16x12 and
// 32x24 maps of stage 2 split over Co and take 64-pixel tiles to reach all
// 132 SMs. A short
// contraction (a 1x1 conv) is mostly epilogue, so it takes only tiles of
// which two fit on an SM: one block's stores overlap the other's loads.
struct WideTile {
  int bn, wgs;
};
inline WideTile pick_wide_tile(long long M, int Co, int k, int cpc) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const bool short_k = (k * k * cpc + 7) / 8 <= 6;
  const WideTile tiles[6] = {{64, 1}, {96, 1}, {128, 1}, {64, 2}, {96, 2}, {128, 2}};
  double best = 0.0;
  WideTile pick{0, 0};
  for (const WideTile& t : tiles) {
    const int bm = 64 * t.wgs;
    if (short_k && 2 * wide_smem_bytes(bm, t.bn) > 227 * 1024) continue;
    const long long blocks = ((M + bm - 1) / bm) * ((Co + t.bn - 1) / t.bn);
    const double cost = (double)((blocks + sms - 1) / sms) * bm * t.bn *
                        (1.0 + 32.0 / bm + 32.0 / t.bn);
    if (pick.bn == 0 || cost < best) best = cost, pick = t;
  }
  return pick;
}

// The wgmma kernels of blocks with WGS warpgroups (each set is instantiated in
// a translation unit of its own, csrc/s8_wide.cu and csrc/s8_wide_1wg.cu).
template <int WGS>
cudaError_t launch_wide(int bn, const int8_t* xq, long long sN, long long sH, long long sW,
                        const int8_t* wp, int Kp, const Epilogue& ep, int N, int H, int W,
                        int cpc, int k, int pad, int Ho, int Wo, cudaStream_t stream) {
#define S8IGEMM_TILE(BN_)                                                                         \
  if (bn == BN_)                                                                                  \
    return launch_wide_tile<BN_, WGS>(xq, sN, sH, sW, wp, Kp, ep, N, H, W, cpc, k, pad, Ho, Wo,   \
                                      stream);
  S8IGEMM_TILE(64) S8IGEMM_TILE(96) S8IGEMM_TILE(128)
#undef S8IGEMM_TILE
  return cudaErrorInvalidValue;
}

// ---- narrow regime: one launch, quantize into shared memory, mma.sync ------

constexpr int TILE_H = 16, TILE_W = 32, NARROW_THREADS = 256;  // a warp owns two tile rows

__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix4(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                          unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// A row of 16-byte chunks padded so that eight consecutive rows, read 16
// bytes each (one matrix of an ldmatrix), touch 32 different banks: a stride
// of 16 (mod 32) bytes.
__host__ __device__ constexpr int bank_stride(int bytes) {
  return bytes % 32 == 16 ? bytes : bytes + 16;
}

struct NarrowSmem {
  int pixel_stride, weight_stride, ksteps, tile_bytes, weight_bytes, total;
};
inline NarrowSmem narrow_smem(int Ci, int k) {
  NarrowSmem s;
  const int Cp = (Ci + 15) / 16 * 16;
  s.pixel_stride = bank_stride(Cp);
  s.ksteps = (k * k * Cp + 31) / 32;
  s.weight_stride = bank_stride(s.ksteps * 32);
  s.tile_bytes = (TILE_H + k - 1) * (TILE_W + k - 1) * s.pixel_stride;
  s.weight_bytes = 32 * s.weight_stride;  // sized for the widest output
  s.total = s.tile_bytes + s.weight_bytes + s.ksteps * 2 * (int)sizeof(int);
  return s;
}

// The input tile with its halo (th x tw pixels from (gy0, gx0), zero outside
// the image), quantized once into tile[pixel * pixel_stride + channel]. Out of
// line: one copy per input type serves every output width.
template <typename T>
__device__ __noinline__ void fill_tile(int8_t* tile, const T* xn, Strides st, const float* qparam,
                                       int qmode, int H, int W, int Ci, int cpc, int gy0, int gx0,
                                       int th, int tw, int pixel_stride, int vec) {
  const int tid = threadIdx.x;
  // the input tile with its halo, quantized once; the loads of U vectors are
  // issued before the first is used. floor(v / d) = (v * ceil(2^32 / d)) >> 32
  // for the small v and d here.
  Quantizer q{1.0f, 0.0f, Q_MUL};
  if constexpr (!std::is_same<T, int8_t>::value) q = make_quantizer(qparam, qmode);
  const int npx = th * tw, total = npx * cpc;
  const unsigned long long rcp_tw = ((1ull << 32) + tw - 1) / tw;
  const unsigned long long rcp_v = ((1ull << 32) + (st.c == 1 ? cpc : npx) - 1) /
                                   (st.c == 1 ? cpc : npx);
  constexpr int U = 2;
  for (int v0 = tid; v0 < total; v0 += NARROW_THREADS * U) {
    Raw16<T> in[U];
    int dst[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * NARROW_THREADS;
      dst[u] = -1;
      if (v >= total) continue;
      const int dv = (int)(((unsigned long long)v * rcp_v) >> 32);
      int pi, c0;
      if (st.c == 1) {  // consecutive threads: consecutive vectors of a pixel
        pi = dv;
        c0 = (v - dv * cpc) * 16;
      } else {  // consecutive pixels of a row of the tile
        pi = v - dv * npx;
        c0 = dv * 16;
      }
      const int py = (int)(((unsigned long long)pi * rcp_tw) >> 32), px = pi - py * tw;
      const int gy = gy0 + py, gx = gx0 + px;
      dst[u] = pi * pixel_stride + c0;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        load16<T>(in[u], xn + gy * st.h + gx * st.w, st.c, c0, Ci, vec);
      else
        zero16(in[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (dst[u] >= 0) *reinterpret_cast<uint4*>(tile + dst[u]) = pack16<T>(in[u], q);
  }
}

// NB: 8-channel output groups (Co <= 8 NB). x is float32, bf16 or int8
// (in_dtype): only the tile fill depends on it.
template <int NB>
__global__ void __launch_bounds__(NARROW_THREADS)
narrow_kernel(const void* __restrict__ x, int in_dtype, Strides st, const int8_t* __restrict__ wp,
              int Kp,
              const float* __restrict__ qparam, int qmode, Epilogue ep, int H, int W, int Ci,
              int k, int pad, int Ho, int Wo, int tiles_x, int tiles_y, int vec, int pixel_stride,
              int weight_stride, int ksteps, int tile_bytes) {
  extern __shared__ __align__(16) uint8_t s8_narrow_smem[];
  int8_t* tile = reinterpret_cast<int8_t*>(s8_narrow_smem);
  int8_t* wsm = tile + tile_bytes;
  int* halfoff = reinterpret_cast<int*>(wsm + NB * 8 * weight_stride);

  const int tid = threadIdx.x;
  const int tx = blockIdx.x % tiles_x, ty = (blockIdx.x / tiles_x) % tiles_y;
  const int n = blockIdx.x / (tiles_x * tiles_y);
  const int oy0 = ty * TILE_H, ox0 = tx * TILE_W;
  const int th = TILE_H + k - 1, tw = TILE_W + k - 1;
  const int cpc = (Ci + 15) / 16, KT = k * k * cpc;

  // byte offset, from a pixel of the tile, of each 16-byte half-step of K
  for (int h = tid; h < ksteps * 2; h += NARROW_THREADS) {
    const int tap = h / cpc, cc = h - tap * cpc;
    halfoff[h] = h < KT ? ((tap / k) * tw + tap % k) * pixel_stride + cc * 16 : 0;
  }
  // weights: NB * 8 rows of K, zero past Co and past the data
  for (int v = tid; v < NB * 8 * ksteps * 2; v += NARROW_THREADS) {
    const int r = v / (ksteps * 2), h = v - r * (ksteps * 2);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < ep.Co && h < KT) val = *reinterpret_cast<const uint4*>(wp + (size_t)r * Kp + h * 16);
    *reinterpret_cast<uint4*>(wsm + r * weight_stride + h * 16) = val;
  }
  if (in_dtype == IN_F32)
    fill_tile<float>(tile, static_cast<const float*>(x) + n * st.n, st, qparam, qmode, H, W, Ci,
                     cpc, oy0 - pad, ox0 - pad, th, tw, pixel_stride, vec);
  else if (in_dtype == IN_BF16)
    fill_tile<__nv_bfloat16>(tile, static_cast<const __nv_bfloat16*>(x) + n * st.n, st, qparam,
                             qmode, H, W, Ci, cpc, oy0 - pad, ox0 - pad, th, tw, pixel_stride, vec);
  else
    fill_tile<int8_t>(tile, static_cast<const int8_t*>(x) + n * st.n, st, qparam, qmode, H, W, Ci,
                      cpc, oy0 - pad, ox0 - pad, th, tw, pixel_stride, vec);
  __syncthreads();

  // Warp w: tile rows 2 w and 2 w + 1, each as two 16-pixel m-blocks. Fragments
  // come by ldmatrix, four 8-row x 16-byte matrices a load (a lane's word of
  // each is row lane / 4, bytes 4 (lane % 4) ..: the mma fragment layout). A:
  // pixels 0-7 and 8-15 of the m-block at the first and the second half-step of
  // K; lane i gives the address of row i % 8 of matrix i / 8. B: the two
  // half-steps of two 8-channel groups.
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2;
  int acc[4][NB][4];
#pragma unroll
  for (int mb = 0; mb < 4; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][nb][i] = 0;
  unsigned pa[4];
#pragma unroll
  for (int mb = 0; mb < 4; ++mb)
    pa[mb] = smem_u32(tile + ((2 * warp + (mb >> 1)) * tw + (mb & 1) * 16 + (lane & 15)) *
                                 pixel_stride);
  const int second_half = lane >> 4;
  const unsigned pb = smem_u32(wsm + ((lane >> 4) * 8 + (lane & 7)) * weight_stride +
                               ((lane >> 3) & 1) * 16);
  for (int ks = 0; ks < ksteps; ++ks) {
    const int off = halfoff[2 * ks + second_half];
    unsigned b[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2)
      ldmatrix4(b[nb][0], b[nb][1], b[nb + 1][0], b[nb + 1][1],
                pb + nb * 8 * weight_stride + ks * 32);
#pragma unroll
    for (int mb = 0; mb < 4; ++mb) {
      unsigned a0, a1, a2, a3;
      ldmatrix4(a0, a1, a2, a3, pa[mb] + off);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_s8(acc[mb][nb], a0, a1, a2, a3, b[nb][0], b[nb][1]);
    }
  }

  // c0, c1: pixel g, channels 2 (lane % 4), + 1; c2, c3: pixel g + 8
  ChannelPair c[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) c[nb] = load_channels(ep, nb * 8 + (lane & 3) * 2);
  const bool full = ep.Co == NB * 8, bias = ep.bias != nullptr;  // else checks per pair
#pragma unroll
  for (int mb = 0; mb < 4; ++mb) {
    const int oy = oy0 + 2 * warp + (mb >> 1);
    if (oy >= Ho) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = ox0 + (mb & 1) * 16 + g + 8 * h;
      if (ox >= Wo) continue;
      const size_t row = (((size_t)n * Ho + oy) * Wo + ox) * ep.Co;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int co = nb * 8 + (lane & 3) * 2, a0 = acc[mb][nb][2 * h], a1 = acc[mb][nb][2 * h + 1];
        if (full && ep.out_dtype == OUT_BF16)
          store2<OUT_BF16>(ep.out, row + co, a0, a1, c[nb], bias);
        else if (full && ep.out_dtype == OUT_F32)
          store2<OUT_F32>(ep.out, row + co, a0, a1, c[nb], bias);
        else
          store_pair(ep, row, co, a0, a1, c[nb]);
      }
    }
  }
}

template <int NB>
cudaError_t launch_narrow_nb(const void* x, int in_dtype, const Strides& st, const int8_t* wp,
                             int Kp, const float* qparam, int qmode, const Epilogue& ep, int N,
                             int H, int W, int Ci, int k, int pad, int Ho, int Wo,
                             const NarrowSmem& s, cudaStream_t stream) {
  static int configured = 0;
  if (s.total > configured) {
    cudaError_t err = cudaFuncSetAttribute(narrow_kernel<NB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, s.total);
    if (err != cudaSuccess) return err;
    configured = s.total;
  }
  const bool vec = in_dtype == IN_F32    ? vector_rows<float>(x, st, Ci)
                   : in_dtype == IN_BF16 ? vector_rows<__nv_bfloat16>(x, st, Ci)
                                         : vector_rows<int8_t>(x, st, Ci);
  const int tiles_x = (Wo + TILE_W - 1) / TILE_W, tiles_y = (Ho + TILE_H - 1) / TILE_H;
  narrow_kernel<NB><<<(unsigned)((long long)N * tiles_x * tiles_y), NARROW_THREADS, s.total,
                      stream>>>(x, in_dtype, st, wp, Kp, qparam, qmode, ep, H, W, Ci, k, pad, Ho, Wo,
                                tiles_x, tiles_y, vec ? 1 : 0, s.pixel_stride, s.weight_stride,
                                s.ksteps, s.tile_bytes);
  return cudaGetLastError();
}

// The one-launch kernel for Co <= 32 (see takes_narrow()).
template <int Unused = 0>
cudaError_t launch_narrow(const void* x, int in_dtype, const Strides& st, const int8_t* wp, int Kp,
                          const float* qparam, int qmode, const Epilogue& ep, int N, int H, int W,
                          int Ci, int k, int pad, int Ho, int Wo, cudaStream_t stream) {
  const NarrowSmem s = narrow_smem(Ci, k);
  if (ep.Co <= 16)
    return launch_narrow_nb<2>(x, in_dtype, st, wp, Kp, qparam, qmode, ep, N, H, W, Ci, k, pad, Ho,
                               Wo, s, stream);
  return launch_narrow_nb<4>(x, in_dtype, st, wp, Kp, qparam, qmode, ep, N, H, W, Ci, k, pad, Ho,
                             Wo, s, stream);
}

// ---- what the dispatch (csrc/qconv.cu) needs ---------------------------------

constexpr int NARROW_MAX_CO = 32;
constexpr int NARROW_MAX_SMEM = 100 * 1024;  // two blocks to an SM at least

// The packed row length the wrapper must give the weights.
inline int packed_k(int Ci, int k) { return (k * k * ((Ci + 15) / 16 * 16) + 127) / 128 * 128; }

inline bool takes_narrow(int Ci, int Co, int k) {
  return Co <= NARROW_MAX_CO && narrow_smem(Ci, k).total <= NARROW_MAX_SMEM;
}

// Whether a launch needs the int8 staging buffer (N*H*W rows of Ci rounded up
// to 16 codes): the wide regime does, unless x is int8 already and every
// pixel is a 16-byte aligned run of Ci = Cp codes.
inline bool needs_staging(const void* x, const Strides& st, int in_dtype, int Ci, int Co, int k) {
  if (takes_narrow(Ci, Co, k)) return false;
  return !(in_dtype == IN_S8 && vector_rows<int8_t>(x, st, Ci));
}

}  // namespace
}  // namespace s8igemm
