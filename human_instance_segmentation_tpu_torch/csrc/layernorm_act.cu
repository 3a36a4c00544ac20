// LayerNorm2d with its epilogue (affine, optional residual, ReLU or identity,
// optional int8 quantize) in two launches, for Hopper.
//
// Replaces no TPU kernel: in the JAX package XLA fuses this chain. The
// stage-2 heads run it after every conv outside the fused unit
// (csrc/conv_ln_act.cu, whose gate takes only small high-channel maps); in
// plain PyTorch (ops/norms.py LayerNorm2d, F.relu, the residual add,
// ops/s2d.quantize_static) it is 12 to 19 kernels that each read and write the
// whole map, about 60 bytes moved a normalised bf16 value, and it was the
// largest block of stage 2's device time in the served B0 and B7 forwards.
//
// Bound: bytes. A bf16 map of E values is read twice (statistics, apply) and
// written once: 6E bytes, 5E with int8 codes out, 2E more with a residual
// (float32: 4 bytes a value instead of 2). The arithmetic is a few
// operations a value.
//
// (a) ln_stats_kernel, grid (P, N): block p of sample n reads a fixed slice of
//     the sample's C*H*W values. They lie contiguous in NCHW and in
//     channels-last memory alike, so this pass does not depend on the
//     layout. A thread loads up to four 8-value vectors (one 16-byte load of
//     bf16, two of float32) before it uses any, folds them into one (count,
//     mean, M2) by two passes over its registers and merges that into its
//     running summary by Chan's rule; the block merges its threads down a
//     fixed shuffle tree and its warps in order and writes one partial. No
//     atomics and no E[x^2] - E[x]^2: the result repeats bit for bit from run
//     to run and loses no digits where the mean is large beside the spread.
// (b) ln_apply_kernel, the same grid: warp 0 merges the sample's P partials in
//     a fixed order (a few hundred bytes, from L2), then mean and rstd =
//     rsqrtf(var + eps) with the biased variance; the block streams its slice
//     once and rounds as the plain chain does, each step one correctly
//     rounded op (__fsub_rn, __fmul_rn, __fadd_rn: nvcc forms no FMA the chain
//     lacks): y = T((x - mean) * rstd), T(y * g), T(. + b), T(. + residual),
//     then ReLU. It writes T (x's dtype), or int8 codes clamp(rint(v * inv),
//     +-127) with inv = float32(1 / scale), which is quantize_static on the
//     same value.
//     Channels-last input with C % 8 == 0 (the served layout: every QConv
//     writes NHWC) reads 8 channels of a pixel a vector; NCHW input, another
//     C or a pointer off 16 bytes takes the scalar form, which indexes
//     either layout. The residual is read through its own strides, as a
//     vector at x's offset where its strides are x's. The output keeps x's
//     memory layout.
// P is picked by the wrapper (ops/cuda_norm.py::plan) so that N * P blocks fill
// the 132 SMs about twice over, each block at least 4,096 values.
//
// Every launcher returns cudaGetLastError(); the Python wrapper raises on a
// non-zero value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;     // values a vector
constexpr int kUnroll = 4;  // vectors a thread loads before it uses any (statistics)
constexpr unsigned kFull = 0xffffffffu;

enum Form { kChannelsLastVec = 0, kScalar = 1 };

struct Args {
  const void* x;
  const void* res;          // null: no residual
  long long rs[4];          // residual's element strides (N, C, H, W)
  int res_same;             // 1: the residual's strides are x's
  const void* gamma;
  const void* beta;
  void* out;
  float4* partial;          // (N, P): count, mean, M2
  float2* stats;            // (N,): mean, biased variance; null: not written
  long long per_sample;     // C * H * W
  long long chunk;          // values a block
  int C, H, W;
  int channels_last;
  float eps;
  int relu;
  float inv;                // float32(1 / scale) for int8 codes out
};

struct Stat {
  float n, mean, m2;
};

// Chan's merge of two (count, mean, M2) summaries.
__device__ __forceinline__ Stat merge(const Stat& a, const Stat& b) {
  if (b.n == 0.0f) return a;
  if (a.n == 0.0f) return b;
  const float n = a.n + b.n;
  const float fb = b.n / n;
  const float delta = b.mean - a.mean;
  return {n, a.mean + delta * fb, a.m2 + b.m2 + delta * delta * a.n * fb};
}

// Lane 0 ends with the warp's summary, merged down a fixed tree.
__device__ __forceinline__ Stat warp_merge(Stat s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Stat o{__shfl_down_sync(kFull, s.n, off), __shfl_down_sync(kFull, s.mean, off),
                 __shfl_down_sync(kFull, s.m2, off)};
    s = merge(s, o);
  }
  return s;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to T (the plain chain's cast between its ops)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// 8 values from a 16-byte aligned p; kStream: the last read of them (evict first)
template <bool kStream>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 u = kStream ? __ldcs(q) : __ldg(q);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

template <bool kStream>
__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = kStream ? __ldcs(q) : __ldg(q);
  const float4 b = kStream ? __ldcs(q + 1) : __ldg(q + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// v holds values already rounded to the output type (codes for int8)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(int8_t* p, const float (&v)[kVec]) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(v[j])))
                << (8 * (j % 4));
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(int8_t* p, float v) { *p = static_cast<int8_t>(v); }

// One value through the chain, rounding to T where the plain chain does.
template <typename T, typename O, bool kRes>
__device__ __forceinline__ float epilogue(float x, float mean, float rstd, float g, float b,
                                          float r, int relu, float inv) {
  float y = rnd<T>(__fmul_rn(__fsub_rn(x, mean), rstd));
  y = rnd<T>(__fmul_rn(y, g));
  y = rnd<T>(__fadd_rn(y, b));
  if constexpr (kRes) y = rnd<T>(__fadd_rn(y, r));
  if (relu) y = y <= 0.0f ? 0.0f : y;  // F.relu: NaN stays NaN
  if constexpr (std::is_same<O, int8_t>::value) {
    y = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.0f), 127.0f);
  }
  return y;
}

// The residual's element at x's flat index i of sample n, through its strides.
__device__ __forceinline__ long long res_offset(const Args& a, long long n, long long i) {
  long long c, h, w;
  if (a.channels_last) {
    c = i % a.C;
    const long long pix = i / a.C;
    h = pix / a.W;
    w = pix % a.W;
  } else {
    const long long hw = (long long)a.H * a.W;
    c = i / hw;
    const long long r = i % hw;
    h = r / a.W;
    w = r % a.W;
  }
  return n * a.rs[0] + c * a.rs[1] + h * a.rs[2] + w * a.rs[3];
}

template <typename T, bool kVecForm>
__global__ void __launch_bounds__(kThreads) ln_stats_kernel(const Args a) {
  const int p = blockIdx.x;
  const long long n = blockIdx.y;
  const long long lo = p * a.chunk;
  const long long hi = min(lo + a.chunk, a.per_sample);
  const T* xs = static_cast<const T*>(a.x) + n * a.per_sample;
  Stat s{0.0f, 0.0f, 0.0f};
  if constexpr (kVecForm) {
    constexpr long long kStride = (long long)kThreads * kVec;
    for (long long base = lo + (long long)threadIdx.x * kVec; base < hi;
         base += kStride * kUnroll) {
      float v[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * kStride < hi) load8<false>(xs + base + u * kStride, v[u]);
      }
      float sum = 0.0f;
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * kStride < hi) {
          sum += ((v[u][0] + v[u][1]) + (v[u][2] + v[u][3])) +
                 ((v[u][4] + v[u][5]) + (v[u][6] + v[u][7]));
          cnt += kVec;
        }
      }
      const float m = sum / static_cast<float>(cnt);
      float m2 = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * kStride < hi) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float d = v[u][j] - m;
            m2 += d * d;
          }
        }
      }
      s = merge(s, Stat{static_cast<float>(cnt), m, m2});
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      s = merge(s, Stat{1.0f, to_f(xs[i]), 0.0f});
    }
  }
  s = warp_merge(s);
  __shared__ Stat ws[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) ws[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stat t = ws[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = merge(t, ws[w]);
    a.partial[n * gridDim.x + p] = make_float4(t.n, t.mean, t.m2, 0.0f);
  }
}

template <typename T, typename O, int kForm, bool kRes>
__global__ void __launch_bounds__(kThreads) ln_apply_kernel(const Args a) {
  const int p = blockIdx.x;
  const long long n = blockIdx.y;
  __shared__ float s_mean, s_rstd;
  if (threadIdx.x < 32) {
    Stat s{0.0f, 0.0f, 0.0f};
    for (int q = threadIdx.x; q < (int)gridDim.x; q += 32) {
      const float4 t = a.partial[n * gridDim.x + q];
      s = merge(s, Stat{t.x, t.y, t.z});
    }
    s = warp_merge(s);
    if (threadIdx.x == 0) {
      const float var = s.m2 / s.n;
      s_mean = s.mean;
      s_rstd = rsqrtf(var + a.eps);
      if (a.stats != nullptr && p == 0) a.stats[n] = make_float2(s.mean, var);
    }
  }
  __syncthreads();
  const float mean = s_mean, rstd = s_rstd;

  const long long lo = p * a.chunk;
  const long long hi = min(lo + a.chunk, a.per_sample);
  const long long off = n * a.per_sample;
  const T* x = static_cast<const T*>(a.x) + off;
  const T* res = static_cast<const T*>(a.res);
  const T* gamma = static_cast<const T*>(a.gamma);
  const T* beta = static_cast<const T*>(a.beta);
  O* out = static_cast<O*>(a.out) + off;
  const long long hw = (long long)a.H * a.W;

  if constexpr (kForm == kScalar) {
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const int c = a.channels_last ? (int)(i % a.C) : (int)(i / hw);
      float r = 0.0f;
      if constexpr (kRes) r = to_f(res[a.res_same ? off + i : res_offset(a, n, i)]);
      store1(out + i, epilogue<T, O, kRes>(to_f(x[i]), mean, rstd, to_f(gamma[c]),
                                           to_f(beta[c]), r, a.relu, a.inv));
    }
  } else {
    for (long long i = lo + (long long)threadIdx.x * kVec; i < hi; i += (long long)kThreads * kVec) {
      float v[kVec], g[kVec], b[kVec], r[kVec], o[kVec];
      const int c = (int)(i % a.C);  // 8 channels of one pixel
      load8<true>(x + i, v);
      load8<false>(gamma + c, g);
      load8<false>(beta + c, b);
      if constexpr (kRes) {
        if (a.res_same) {
          load8<true>(res + off + i, r);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) r[j] = to_f(res[res_offset(a, n, i + j)]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) r[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        o[j] = epilogue<T, O, kRes>(v[j], mean, rstd, g[j], b[j], r[j], a.relu, a.inv);
      }
      store8(out + i, o);
    }
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T, typename O, int kForm>
void launch_apply(const Args& a, dim3 grid, cudaStream_t stream) {
  if (a.res != nullptr) {
    ln_apply_kernel<T, O, kForm, true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    ln_apply_kernel<T, O, kForm, false><<<grid, kThreads, 0, stream>>>(a);
  }
}

template <typename T, typename O>
int launch(const Args& a, int N, int P, int form, cudaStream_t stream) {
  const dim3 grid(P, N);
  if (form == kChannelsLastVec) {
    const int ob = static_cast<int>(sizeof(O)) * kVec;  // bytes of one output vector
    const bool ok = a.channels_last && a.C % kVec == 0 && a.chunk % kVec == 0 &&
                    aligned(a.x, 16) && aligned(a.out, ob < 16 ? ob : 16) &&
                    aligned(a.gamma, 16) && aligned(a.beta, 16) &&
                    (a.res == nullptr || !a.res_same || aligned(a.res, 16));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    ln_stats_kernel<T, true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    ln_stats_kernel<T, false><<<grid, kThreads, 0, stream>>>(a);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (form == kChannelsLastVec) {
    launch_apply<T, O, kChannelsLastVec>(a, grid, stream);
  } else {
    launch_apply<T, O, kScalar>(a, grid, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (N, C, H, W), contiguous in NCHW (channels_last 0) or channels-last
// (channels_last 1) memory, dtype 0 float32 / 1 bf16. res: null or a tensor of
// x's shape and dtype with element strides (rsn, rsc, rsh, rsw); res_same 1
// when they are x's. gamma, beta: (C,) in x's dtype. out: x's shape and
// layout, x's dtype or int8 (out_int8). partial: (N, P) float4 scratch;
// stats: null or (N,) float2, mean and biased variance. chunk: values a
// block, P * chunk >= C*H*W, a multiple of 8 in the vector form. form: 0
// channels-last vectors, 1 scalar. inv: float32(1 / scale).
extern "C" int ln_act_launch(const void* x, const void* res, long long rsn, long long rsc,
                             long long rsh, long long rsw, int res_same, const void* gamma,
                             const void* beta, void* out, void* partial, void* stats, int N,
                             int C, int H, int W, int channels_last, int P, long long chunk,
                             int form, int dtype, int out_int8, float eps, int relu, float inv,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long per_sample = (long long)C * H * W;
  if ((long long)N * per_sample == 0) return 0;
  if (N > 65535 || P < 1 || chunk < 1 || chunk * P < per_sample || form < 0 || form > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, res, {rsn, rsc, rsh, rsw}, res_same, gamma, beta, out,
               static_cast<float4*>(partial), static_cast<float2*>(stats), per_sample, chunk,
               C, H, W, channels_last, eps, relu, inv};
  if (dtype == 1) {
    return out_int8 ? launch<__nv_bfloat16, int8_t>(a, N, P, form, stream)
                    : launch<__nv_bfloat16, __nv_bfloat16>(a, N, P, form, stream);
  }
  return out_int8 ? launch<float, int8_t>(a, N, P, form, stream)
                  : launch<float, float>(a, N, P, form, stream);
}
