// Img2col and the implicit-GEMM convolution for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels in
// src/repro/kernels/img2col/img2col.py:
//   * img2col <- img2col (:63, slabs that do not overlap, kh == stride) and
//     _img2col_overlap (:94, overlapping slabs, e.g. 3x3 stride 1).  The two
//     Pallas sites differ only in how a BlockSpec can cut the input rows;
//     here one kernel serves both.
//   * conv2d  <- conv2d / _conv_kernel (:130): patches @ w with f32
//     accumulation, the patch matrix never written to device memory.
//
// img2col.  Output (OH*OW, kh*kw*C), column k = (ky*kw + kx)*C + c, tap
// (oy*stride + ky - pad, ox*stride + kx - pad).  It only moves data, so its
// bound is the bytes it must move (input once, output once) over HBM
// bandwidth; the output is kh*kw times the input for stride 1.  Design: in
// NHWC each output row is kh*kw runs of C contiguous elements, so the kernel
// copies in units of the widest power of two bytes (<= 16) that divides a
// run's byte length: one thread per output unit, consecutive threads on
// consecutive units (coalesced stores, reads contiguous along each run).
// Taps that fall outside the input write the map's fill, a unit-wide bit
// pattern the host builds from the element's bytes, so every dtype is
// bit-exact.  Index arithmetic is in units: 32-bit where the host proves
// every unit index fits in 31 bits (the Table III output, 458 MB, is 28.6 M
// 16-byte units), and each division by a runtime size is a multiply-high by
// a magic number the host computed.  Addresses are formed by indexing a
// typed pointer, so a byte offset never passes through 32 bits.
//
// conv2d.  out[p, oc] = sum_k patch[p, k] * w[k, oc] with M = OH*OW rows,
// N = OC columns and K = kh*kw*C, accumulated in f32 (bf16 read as f32) and
// rounded once to x's dtype at the store.  At the EDSR body conv (224x224x64
// -> 64, K = 576) it is bound by its f32 operations (2*M*N*K over 67 TFLOP/s
// without tensor cores), not by bytes.  Design: a shared-memory tiled FMA
// GEMM, 128x64 output tile per block of 256 threads, 8x4 outputs per
// thread, K in steps of 16.  The A tile is gathered straight from x: each
// thread keeps one output row's (oy, ox) for the whole K loop and walks its
// columns' (ky, kx, c) incrementally, so no division sits in the loop; taps
// outside x read zero (the JAX package pads with jnp.pad).  The next K tile
// is loaded into registers while the current one is multiplied.  No tensor
// cores, no TMA: wgmma and a TMA pipeline are later work.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Dtype { kInt8 = 0, kInt32 = 1, kBf16 = 2, kF32 = 3 };

// ---------------------------------------------------------------------------
// img2col
// ---------------------------------------------------------------------------

constexpr int kCopyThreads = 256;

// Unsigned division by a runtime divisor: 32-bit multiply-high with the
// host's magic number (Granlund-Montgomery: q = (t + ((n - t) >> sh1)) >> sh2,
// t = umulhi(n, magic), exact for every n < 2^32), or plain 64-bit division.
struct Div {
  uint64_t d;
  uint32_t magic;
  uint32_t shifts;  // sh1 | sh2 << 8
};

template <bool Narrow>
__device__ __forceinline__ uint64_t divide(uint64_t n, const Div& v) {
  if constexpr (Narrow) {
    const uint32_t n32 = static_cast<uint32_t>(n);
    const uint32_t t = __umulhi(n32, v.magic);
    return (t + ((n32 - t) >> (v.shifts & 0xff))) >> (v.shifts >> 8);
  } else {
    return n / v.d;
  }
}

struct Img2colArgs {
  int64_t units;       // output units in all
  int64_t H, W;        // input rows and columns
  int64_t stride, pad;
  int64_t kw, R;       // taps per row of the kernel, units per run (C)
  Div by_R, by_taps, by_kw, by_OW;
  uint64_t fill_lo, fill_hi;  // the fill pattern, one unit wide
};

template <typename Unit>
__device__ __forceinline__ Unit fill_unit(uint64_t lo, uint64_t hi) {
  Unit u;
  if constexpr (sizeof(Unit) == 16) {
    uint64_t both[2] = {lo, hi};
    memcpy(&u, both, 16);
  } else {
    memcpy(&u, &lo, sizeof(Unit));
  }
  return u;
}

template <typename Unit, bool Narrow>
__global__ void __launch_bounds__(kCopyThreads)
img2col_kernel(const Unit* __restrict__ x, Unit* __restrict__ out,
               const Img2colArgs a) {
  using S = typename std::conditional<Narrow, int32_t, int64_t>::type;
  const Unit fill = fill_unit<Unit>(a.fill_lo, a.fill_hi);
  const uint64_t step = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       i < static_cast<uint64_t>(a.units); i += step) {
    // i -> (run, r): run -> (row p, tap): tap -> (ky, kx): p -> (oy, ox)
    const uint64_t run = divide<Narrow>(i, a.by_R);
    const uint64_t r = i - run * a.by_R.d;
    const uint64_t p = divide<Narrow>(run, a.by_taps);
    const uint64_t tap = run - p * a.by_taps.d;
    const uint64_t ky = divide<Narrow>(tap, a.by_kw);
    const uint64_t kx = tap - ky * a.by_kw.d;
    const uint64_t oy = divide<Narrow>(p, a.by_OW);
    const uint64_t ox = p - oy * a.by_OW.d;
    const S y = static_cast<S>(oy * a.stride + ky) - static_cast<S>(a.pad);
    const S xx = static_cast<S>(ox * a.stride + kx) - static_cast<S>(a.pad);
    Unit v = fill;
    if (y >= 0 && y < static_cast<S>(a.H) && xx >= 0 &&
        xx < static_cast<S>(a.W)) {
      v = x[(static_cast<S>(y) * static_cast<S>(a.W) + xx) *
                static_cast<S>(a.R) + static_cast<S>(r)];
    }
    out[i] = v;
  }
}

inline unsigned copy_grid(int64_t n) {
  const int64_t blocks = (n + kCopyThreads - 1) / kCopyThreads;
  const int64_t cap = 132 * 16;  // blocks in flight; the loop strides
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

template <typename Unit>
void launch_img2col(const void* x, void* out, const Img2colArgs& a,
                    int narrow, cudaStream_t s) {
  const Unit* xu = static_cast<const Unit*>(x);
  Unit* ou = static_cast<Unit*>(out);
  if (narrow) {
    img2col_kernel<Unit, true><<<copy_grid(a.units), kCopyThreads, 0, s>>>(
        xu, ou, a);
  } else {
    img2col_kernel<Unit, false><<<copy_grid(a.units), kCopyThreads, 0, s>>>(
        xu, ou, a);
  }
}

// ---------------------------------------------------------------------------
// conv2d: implicit GEMM
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 64, kBK = 16;
constexpr int kConvThreads = 256;
constexpr int kTM = 8, kTN = 4;     // outputs per thread: rows x columns
constexpr int kALoads = kBM * kBK / kConvThreads;  // 8 A elements a thread
constexpr int kBLoads = kBK * kBN / kConvThreads;  // 4 B elements a thread

struct ConvArgs {
  int H, W, C, kw, stride, pad, OW;
  int M, N, K;
};

template <typename T>
__device__ __forceinline__ float as_f32(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ out, const ConvArgs a) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loads: this thread's row of the tile and its 8 consecutive columns
  const int a_row = t / 2;
  const int a_col = (t % 2) * kALoads;
  const int p = m0 + a_row;
  const bool row_ok = p < a.M;
  const int oy = row_ok ? p / a.OW : 0;
  const int ox = row_ok ? p - oy * a.OW : 0;
  const int y_base = oy * a.stride - a.pad;
  const int x_base = ox * a.stride - a.pad;
  // (ky, kx, c) of column k = a_col, walked forward one column at a time
  int k_next = a_col;
  int c = a.C > 0 ? a_col % a.C : 0;
  int tap = a.C > 0 ? a_col / a.C : 0;
  int kx = tap % a.kw;
  int ky = tap / a.kw;

  // B loads: row b_row of the tile, 4 consecutive output channels
  const int b_row = t / (kBN / kBLoads);
  const int b_col = (t % (kBN / kBLoads)) * kBLoads;

  float a_reg[kALoads];
  float b_reg[kBLoads];

  auto load_tile = [&](int k0) {
    // A: walk k from k0 + a_col; the walk state already stands there
#pragma unroll
    for (int j = 0; j < kALoads; ++j) {
      float v = 0.0f;
      const int y = y_base + ky;
      const int xx = x_base + kx;
      if (row_ok && k_next < a.K && y >= 0 && y < a.H && xx >= 0 &&
          xx < a.W) {
        v = as_f32(x[(static_cast<int64_t>(y) * a.W + xx) * a.C + c]);
      }
      a_reg[j] = v;
      ++k_next;
      if (++c == a.C) {
        c = 0;
        if (++kx == a.kw) {
          kx = 0;
          ++ky;
        }
      }
    }
    // skip the other thread's half of the tile: BK - kALoads columns
#pragma unroll
    for (int j = 0; j < kBK - kALoads; ++j) {
      ++k_next;
      if (++c == a.C) {
        c = 0;
        if (++kx == a.kw) {
          kx = 0;
          ++ky;
        }
      }
    }
    const int k = k0 + b_row;
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) {
      const int n = n0 + b_col + j;
      b_reg[j] = (k < a.K && n < a.N)
                     ? as_f32(w[static_cast<int64_t>(k) * a.N + n])
                     : 0.0f;
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int j = 0; j < kALoads; ++j) As[a_col + j][a_row] = a_reg[j];
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) Bs[b_row][b_col + j] = b_reg[j];
  };

  // compute layout: 16 x 16 threads, rows ty*8.., columns tx*4..
  const int tx = t % (kBN / kTN);
  const int ty = t / (kBN / kTN);
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  load_tile(0);
  store_tile();
  __syncthreads();
  for (int k0 = 0; k0 < a.K; k0 += kBK) {
    const bool more = k0 + kBK < a.K;
    if (more) load_tile(k0 + kBK);  // in flight while this tile multiplies
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&As[kk][ty * kTM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
      const float av[kTM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                             a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bw[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store_tile();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= a.M) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < a.N) out[static_cast<int64_t>(m) * a.N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int img2col(const void* x, void* out, int unit_bytes,
                       int64_t units, int64_t H, int64_t W, int64_t stride,
                       int64_t pad, int64_t kw, int64_t R, int64_t taps,
                       int64_t OW, const int64_t* magics, uint64_t fill_lo,
                       uint64_t fill_hi, int narrow, void* stream) {
  // magics: (magic, shifts) of R, taps, kw and OW, in that order
  if (units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Img2colArgs a;
  a.units = units;
  a.H = H;
  a.W = W;
  a.stride = stride;
  a.pad = pad;
  a.kw = kw;
  a.R = R;
  const int64_t divisors[4] = {R, taps, kw, OW};
  Div* divs[4] = {&a.by_R, &a.by_taps, &a.by_kw, &a.by_OW};
  for (int k = 0; k < 4; ++k) {
    divs[k]->d = static_cast<uint64_t>(divisors[k]);
    divs[k]->magic = static_cast<uint32_t>(magics[2 * k]);
    divs[k]->shifts = static_cast<uint32_t>(magics[2 * k + 1]);
  }
  a.fill_lo = fill_lo;
  a.fill_hi = fill_hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes) {
    case 1: launch_img2col<uint8_t>(x, out, a, narrow, s); break;
    case 2: launch_img2col<uint16_t>(x, out, a, narrow, s); break;
    case 4: launch_img2col<uint32_t>(x, out, a, narrow, s); break;
    case 8: launch_img2col<uint2>(x, out, a, narrow, s); break;
    case 16: launch_img2col<uint4>(x, out, a, narrow, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv2d(const void* x, const void* w, void* out, int dtype,
                      int H, int W, int C, int kw, int stride, int pad,
                      int OW, int M, int N, int K, void* stream) {
  // K == 0 (no input channels) is an empty sum: the kernel stores zeros
  if (M <= 0 || N <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a{H, W, C, kw, stride, pad, OW, M, N, K};
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      conv2d_kernel<float><<<grid, kConvThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), a);
      break;
    case kBf16:
      conv2d_kernel<__nv_bfloat16><<<grid, kConvThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(w),
          static_cast<__nv_bfloat16*>(out), a);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
