// Bilinear Resize for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel resize_bilinear
// (src/repro/kernels/resize/resize.py:52): half-pixel bilinear resize of an
// (H, W, C) map to (out_h, out_w, C), four taps per output element with f32
// weights, cast back to the input's dtype.
//
// Bound on an H100: it reads each input element about once (more when it
// enlarges, less when it shrinks) and writes each output element once with a
// few dozen f32 operations, so the bytes set the bound (input once, output
// once over 3.35 TB/s); at small maps the launch sets the time.
//
// Design: one thread per output element, consecutive threads on consecutive
// channels (coalesced loads of each tap, coalesced stores); a 2-D grid of
// output rows by blocks of a row's (ox, c) elements.  Each thread computes
// its taps and weights in f32 exactly as the JAX package's tm_ops does:
// s = (i + 0.5) * (H / out_h) - 0.5 with H / out_h rounded to f32 on the
// host, i0 = clip(floor(s), 0, H - 1), i1 = min(i0 + 1, H - 1),
// w = clip(s - i0, 0, 1); then top = v00 * (1 - wx) + v01 * wx, the same for
// the bottom row, and top * (1 - wy) + bot * wy.  Every product and sum is a
// round-to-nearest intrinsic, so the compiler contracts none of them into an
// FMA and the result is the plain PyTorch version's, operation for
// operation.  The cast back rounds to nearest even for bf16 and truncates
// toward zero for the integer dtypes (a convex combination of in-range values
// stays in range).
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Dtype { kInt8 = 0, kInt32 = 1, kBf16 = 2, kF32 = 3 };

constexpr int kThreads = 256;

struct ResizeArgs {
  int H, W, C, out_h, out_w;
  float scale_y, scale_x;  // H / out_h and W / out_w, rounded to f32
};

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(v);
  } else {
    return static_cast<float>(v);
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(v);
  } else if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return static_cast<T>(__float2int_rz(v));
  }
}

// taps and weight of output coordinate i along an axis of n input samples
__device__ __forceinline__ void taps(int i, float scale, int n, int& i0,
                                     int& i1, float& w) {
  const float s = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f),
                                      scale),
                            0.5f);
  const float f = fminf(fmaxf(floorf(s), 0.0f), static_cast<float>(n - 1));
  i0 = static_cast<int>(f);
  i1 = min(i0 + 1, n - 1);
  w = fminf(fmaxf(__fsub_rn(s, static_cast<float>(i0)), 0.0f), 1.0f);
}

__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resize_kernel(const T* __restrict__ x, T* __restrict__ out,
              const ResizeArgs a) {
  const int64_t row_elems = static_cast<int64_t>(a.out_w) * a.C;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= row_elems) return;
  const int ox = static_cast<int>(e / a.C);
  const int c = static_cast<int>(e - static_cast<int64_t>(ox) * a.C);
  int x0, x1;
  float wx;
  taps(ox, a.scale_x, a.W, x0, x1, wx);
  for (int oy = blockIdx.y; oy < a.out_h; oy += gridDim.y) {
    int y0, y1;
    float wy;
    taps(oy, a.scale_y, a.H, y0, y1, wy);
    const T* top_row = x + static_cast<int64_t>(y0) * a.W * a.C;
    const T* bot_row = x + static_cast<int64_t>(y1) * a.W * a.C;
    const float v00 = to_f32(top_row[static_cast<int64_t>(x0) * a.C + c]);
    const float v01 = to_f32(top_row[static_cast<int64_t>(x1) * a.C + c]);
    const float v10 = to_f32(bot_row[static_cast<int64_t>(x0) * a.C + c]);
    const float v11 = to_f32(bot_row[static_cast<int64_t>(x1) * a.C + c]);
    const float top = lerp(v00, v01, wx);
    const float bot = lerp(v10, v11, wx);
    out[static_cast<int64_t>(oy) * row_elems + e] = from_f32<T>(lerp(top, bot, wy));
  }
}

template <typename T>
void launch(const void* x, void* out, const ResizeArgs& a, cudaStream_t s) {
  const int64_t row_elems = static_cast<int64_t>(a.out_w) * a.C;
  const dim3 grid(static_cast<unsigned>((row_elems + kThreads - 1) / kThreads),
                  static_cast<unsigned>(a.out_h < 65535 ? a.out_h : 65535));
  resize_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                              static_cast<T*>(out), a);
}

}  // namespace

extern "C" int resize_bilinear(const void* x, void* out, int dtype, int H,
                               int W, int C, int out_h, int out_w,
                               float scale_y, float scale_x, void* stream) {
  if (H <= 0 || W <= 0 || C <= 0 || out_h <= 0 || out_w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ResizeArgs a{H, W, C, out_h, out_w, scale_y, scale_x};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kInt8: launch<int8_t>(x, out, a, s); break;
    case kInt32: launch<int32_t>(x, out, a, s); break;
    case kBf16: launch<__nv_bfloat16>(x, out, a, s); break;
    case kF32: launch<float>(x, out, a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
