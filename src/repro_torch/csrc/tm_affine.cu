// Coarse-grained TM kernels for Hopper (sm_90a): the TMU's address generator.
//
// Replaces the JAX package's Pallas kernels in
// src/repro/kernels/tm_affine/tm_affine.py:
//   * tm_affine_block  <- _block_call / _block_kernel (block mode: a signed
//     axis permutation with block-aligned offsets; transpose, rot90, split,
//     the Add epilogue);
//   * tm_affine_gather <- _gather_call / _gather_kernel (gather mode: any
//     MixedRadixMap, out-of-bounds elements read the fill register).
//
// Bound on an H100: both kernels only move data, so the bound is the bytes
// they must move (input read once, epilogue operand read once, output
// written once) over HBM bandwidth (3.35 TB/s).
//
// Design against that bound: one thread per output element in a grid-stride
// loop, so consecutive threads write consecutive output elements (coalesced
// stores).  Each thread computes its source address from the map itself,
// the TMU's own address generator: the block kernel from per-axis signed
// strides, the gather kernel from the mixed-radix digit splits and the
// integer affine rows (numerators, offset numerator, common denominator,
// floor division), validity against in_shape and the digit bounds.  The
// Pallas gather kernel instead streams a precomputed int32 index and a bool
// mask beside the data (5 bytes per element, more than an int8 or bf16
// element itself); here the only traffic is the data.  So that the address
// arithmetic stays below the memory time:
//   * the map's registers are an int64 array in device memory, staged into
//     shared memory once per block;
//   * where the host proves every index fits in 31 bits the arithmetic is
//     32-bit, and every division of a coordinate by a shape or a radix is a
//     multiply-high by a magic number the host computed (Granlund-
//     Montgomery), not a division;
//   * the affine rows are sparse (only non-zero numerators are stored) and
//     read the digits from a per-thread column of shared memory;
//   * rows the host proves stay inside in_shape skip the bounds test and
//     the clamp;
//   * on the 32-bit path each thread carries four outputs at once: one
//     load of each register serves all four, and their four independent
//     chains of shared-memory loads hide each other's latency.
// Reads follow the map and are not coalesced for transposes; tiling through
// shared memory is later work.
//
// Element types: int8, int32, bf16, f32.  EW epilogue: add, sub, mul, max.
// Integer arithmetic wraps (computed in unsigned), bf16 goes through f32 and
// rounds to nearest even, and max propagates NaN like jnp.maximum.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxAxes = 12;
constexpr int kMaxDigits = 2 * kMaxAxes;
constexpr int kBlockThreads = 256;
constexpr int kGatherThreads = 128;

enum Dtype { kInt8 = 0, kInt32 = 1, kBf16 = 2, kF32 = 3 };
enum Ew { kNone = 0, kAdd = 1, kSub = 2, kMul = 3, kMax = 4 };

// ---------------------------------------------------------------------------
// element-wise epilogue
// ---------------------------------------------------------------------------

template <int EW>
__device__ __forceinline__ float ew_float(float a, float b) {
  if (EW == kAdd) return a + b;
  if (EW == kSub) return a - b;
  if (EW == kMul) return a * b;
  // NaN-propagating max (fmaxf would return the other operand)
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <int EW>
__device__ __forceinline__ int32_t ew_int(int32_t a, int32_t b) {
  const uint32_t ua = static_cast<uint32_t>(a);
  const uint32_t ub = static_cast<uint32_t>(b);
  if (EW == kAdd) return static_cast<int32_t>(ua + ub);
  if (EW == kSub) return static_cast<int32_t>(ua - ub);
  if (EW == kMul) return static_cast<int32_t>(ua * ub);
  return a > b ? a : b;
}

template <typename T, int EW>
__device__ __forceinline__ T apply_ew(T a, T b) {
  if constexpr (std::is_same<T, float>::value) {
    return ew_float<EW>(a, b);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(
        ew_float<EW>(__bfloat162float(a), __bfloat162float(b)));
  } else {
    // int8 results wrap on the narrowing conversion (two's complement)
    return static_cast<T>(ew_int<EW>(static_cast<int32_t>(a),
                                     static_cast<int32_t>(b)));
  }
}

// ---------------------------------------------------------------------------
// index arithmetic
//
// Narrow instantiations (the host proves every coordinate, row value and
// flat index fits in 31 bits) compute in 32 bits: coordinates are divided by
// a multiply-high with a magic number the host computed (Granlund-
// Montgomery: q = (t + ((n - t) >> sh1)) >> sh2, t = umulhi(n, magic),
// exact for every n < 2^32).  Wide instantiations compute in 64 bits and
// divide plainly.
// ---------------------------------------------------------------------------

template <bool Narrow>
struct Index;

template <>
struct Index<true> {
  using U = uint32_t;  // coordinates and digits
  using S = int32_t;   // affine rows and flat indices
  __device__ static __forceinline__ U div(U n, int64_t d, int64_t magic,
                                          int64_t shifts) {
    const uint32_t t = __umulhi(n, static_cast<uint32_t>(magic));
    return (t + ((n - t) >> (shifts & 0xff))) >> (shifts >> 8);
  }
};

template <>
struct Index<false> {
  using U = uint64_t;
  using S = int64_t;
  __device__ static __forceinline__ U div(U n, int64_t d, int64_t, int64_t) {
    return n / static_cast<U>(d);
  }
};

template <typename S>
__device__ __forceinline__ S floordiv(S a, S b) {
  // b > 0 (a common denominator); C++ '/' truncates toward zero
  S q = a / b;
  if (q * b > a) --q;
  return q;
}

// ---------------------------------------------------------------------------
// block mode
//
// regs: [0] ndim  [1] base  [2 + d] out_shape  [14 + d] coef
//       [26 + d] magic of out_shape[d]  [38 + d] its shifts (sh1 | sh2 << 8)
// The source flat index of output coordinate o is base + sum_d coef[d]·o[d]
// (coef[d] = sign[d] * in_stride[src_axis[d]]).
// ---------------------------------------------------------------------------

constexpr int kBlockRegs = 2 + 4 * kMaxAxes;

template <typename T, int EW, bool Narrow>
__global__ void __launch_bounds__(kBlockThreads)
block_kernel(const T* __restrict__ x, const T* __restrict__ y,
             T* __restrict__ out, const int64_t* __restrict__ regs,
             int64_t numel) {
  using U = typename Index<Narrow>::U;
  using S = typename Index<Narrow>::S;
  __shared__ int64_t s_regs[kBlockRegs];
  for (int k = threadIdx.x; k < kBlockRegs; k += blockDim.x) s_regs[k] = regs[k];
  __syncthreads();
  const int ndim = static_cast<int>(s_regs[0]);
  const S base = static_cast<S>(s_regs[1]);
  const int64_t* shape = s_regs + 2;
  const int64_t* coef = s_regs + 2 + kMaxAxes;
  const int64_t* magic = s_regs + 2 + 2 * kMaxAxes;
  const int64_t* shifts = s_regs + 2 + 3 * kMaxAxes;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < numel; i += stride) {
    U rem = static_cast<U>(i);
    S src = base;
    for (int d = ndim - 1; d > 0; --d) {
      const U q = Index<Narrow>::div(rem, shape[d], magic[d], shifts[d]);
      src += static_cast<S>(rem - q * static_cast<U>(shape[d])) *
             static_cast<S>(coef[d]);
      rem = q;
    }
    if (ndim > 0) src += static_cast<S>(rem) * static_cast<S>(coef[0]);
    T v = x[src];
    if constexpr (EW != kNone) v = apply_ew<T, EW>(v, y[i]);
    out[i] = v;
  }
}

// ---------------------------------------------------------------------------
// gather mode
//
// regs (int64), a = output axis, j = digit split, r = input row, k = entry:
//   [0] n_out  [1] n_in  [2] n_splits  [3] fill bits (low bytes)
//   [4] n_bounds  [5] in_numel
//   [8 + a]  out_shape      [20 + a] its magic     [32 + a] its shifts
//   [44 + j] split axis     [56 + j] radix         [68 + j] radix magic
//   [80 + j] radix shifts
//   [92 + 7 r + f] row r: f = 0 offset numerator, 1 denominator, 2 in_shape,
//       3 in_stride, 4/5 first/end non-zero numerator, 6 checked (the host
//       could not prove the row stays inside in_shape)
//   [176 + k] bounded digit [188 + k] its bound (valid iff digit < bound)
//   [200 + k] digit of non-zero numerator k     [488 + k] its value
// The digit vector is (quotients in place of the output coordinates,
// remainders appended in split order), as MixedRadixMap.expand_digits.
// ---------------------------------------------------------------------------

constexpr int kNnz = kMaxAxes * kMaxDigits;
constexpr int kRows = 92;
constexpr int kBounds = kRows + 7 * kMaxAxes;
constexpr int kNz = kBounds + 2 * kMaxAxes;
constexpr int kGatherRegs = kNz + 2 * kNnz;

template <typename T, int EW, bool Narrow>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const T* __restrict__ x, const T* __restrict__ y,
              T* __restrict__ out, const int64_t* __restrict__ regs,
              int64_t numel) {
  using U = typename Index<Narrow>::U;
  using S = typename Index<Narrow>::S;
  // outputs per thread per iteration: independent address chains that
  // share every register-file load
  constexpr int kPer = Narrow ? 4 : 1;
  constexpr int kCols = kGatherThreads * kPer;
  __shared__ int64_t s_regs[kGatherRegs];
  // the digits of every output in flight (dynamic shared memory sized to
  // the map's digit count)
  extern __shared__ __align__(8) unsigned char s_dyn[];
  U* s_dig = reinterpret_cast<U*>(s_dyn);
  const int t = threadIdx.x;
  // digit d of this thread's output u
  auto dig = [&](int d, int u) -> U& {
    return s_dig[d * kCols + t + u * kGatherThreads];
  };
  for (int k = threadIdx.x; k < kGatherRegs; k += blockDim.x) s_regs[k] = regs[k];
  __syncthreads();
  const int n_out = static_cast<int>(s_regs[0]);
  const int n_in = static_cast<int>(s_regs[1]);
  const int n_splits = static_cast<int>(s_regs[2]);
  const int n_bounds = static_cast<int>(s_regs[4]);
  const S last = static_cast<S>(s_regs[5] - 1);
  T fill;
  {
    const int64_t bits = s_regs[3];
    memcpy(&fill, &bits, sizeof(T));
  }
  const int64_t* out_shape = s_regs + 8;
  const int64_t* out_magic = s_regs + 20;
  const int64_t* out_shifts = s_regs + 32;
  const int64_t* split_axis = s_regs + 44;
  const int64_t* radix = s_regs + 56;
  const int64_t* radix_magic = s_regs + 68;
  const int64_t* radix_shifts = s_regs + 80;
  const int64_t* rows = s_regs + kRows;
  const int64_t* bound_digit = s_regs + kBounds;
  const int64_t* bound_val = s_regs + kBounds + kMaxAxes;
  const int64_t* nz_digit = s_regs + kNz;
  const int64_t* nz_value = s_regs + kNz + kNnz;

  const int64_t step = static_cast<int64_t>(gridDim.x) * kCols;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kCols; base < numel;
       base += step) {
    // output u of this thread is element base + t + u * blockDim, so the
    // stores stay coalesced for every u
    U rem[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int64_t i = base + t + u * kGatherThreads;
      rem[u] = static_cast<U>(i < numel ? i : 0);
    }
    // output coordinates, last axis fastest
    for (int a = n_out - 1; a > 0; --a) {
      const int64_t size = out_shape[a], mg = out_magic[a], sh = out_shifts[a];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const U q = Index<Narrow>::div(rem[u], size, mg, sh);
        dig(a, u) = rem[u] - q * static_cast<U>(size);
        rem[u] = q;
      }
    }
    if (n_out > 0) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) dig(0, u) = rem[u];
    }
    // mixed-radix digit splits, applied left to right
    for (int j = 0; j < n_splits; ++j) {
      const int ax = static_cast<int>(split_axis[j]);
      const int64_t rd = radix[j], mg = radix_magic[j], sh = radix_shifts[j];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const U v = dig(ax, u);
        const U q = Index<Narrow>::div(v, rd, mg, sh);
        dig(ax, u) = q;
        dig(n_out + j, u) = v - q * static_cast<U>(rd);
      }
    }
    bool valid[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) valid[u] = true;
    for (int k = 0; k < n_bounds; ++k) {
      const int dg = static_cast<int>(bound_digit[k]);
      const int64_t bv = bound_val[k];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        valid[u] = valid[u] && static_cast<int64_t>(dig(dg, u)) < bv;
      }
    }
    // integer affine rows -> input coordinates -> flat source index
    S flat[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) flat[u] = 0;
    for (int r = 0; r < n_in; ++r) {
      const int64_t* row = rows + 7 * r;
      S acc[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) acc[u] = static_cast<S>(row[0]);
      for (int64_t k = row[4]; k < row[5]; ++k) {
        const int dg = static_cast<int>(nz_digit[k]);
        const S v = static_cast<S>(nz_value[k]);
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          acc[u] += v * static_cast<S>(dig(dg, u));
        }
      }
      const S den = static_cast<S>(row[1]);
      const bool checked = row[6] != 0;
      const S hi = static_cast<S>(row[2] - 1);
      const S st = static_cast<S>(row[3]);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        S c = den == 1 ? acc[u] : floordiv<S>(acc[u], den);
        if (checked) {
          valid[u] = valid[u] && c >= 0 && c <= hi;
          c = c < 0 ? 0 : (c > hi ? hi : c);
        }
        flat[u] += c * st;
      }
    }
    // rows the host proved in range can leave it only where a digit bound
    // already failed: keep even that address inside the input
    T v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const S f = flat[u] < 0 ? 0 : (flat[u] > last ? last : flat[u]);
      v[u] = fill;
      if (valid[u] && base + t + u * kGatherThreads < numel) v[u] = x[f];
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int64_t i = base + t + u * kGatherThreads;
      if (i < numel) {
        T o = v[u];
        if constexpr (EW != kNone) o = apply_ew<T, EW>(o, y[i]);
        out[i] = o;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: pick the instantiation and launch
// ---------------------------------------------------------------------------

inline unsigned grid_for(int64_t numel, int threads) {
  const int64_t blocks = (numel + threads - 1) / threads;
  const int64_t cap = 132 * 32;  // enough blocks in flight; the loop strides
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

template <bool Gather, typename T, int EW, bool Narrow>
void launch_typed(const void* x, const void* y, void* out, const void* regs,
                  int64_t numel, int n_digits, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  const int64_t* rt = static_cast<const int64_t*>(regs);
  if constexpr (Gather) {
    constexpr int per = Narrow ? 4 : 1;
    using U = typename Index<Narrow>::U;
    const size_t dyn = static_cast<size_t>(n_digits > 0 ? n_digits : 1) *
                       kGatherThreads * per * sizeof(U);
    if (dyn > 32 * 1024) {
      cudaFuncSetAttribute(gather_kernel<T, EW, Narrow>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(dyn));
    }
    gather_kernel<T, EW, Narrow>
        <<<grid_for(numel, kGatherThreads * per), kGatherThreads, dyn,
           stream>>>(
            xt, yt, ot, rt, numel);
  } else {
    block_kernel<T, EW, Narrow>
        <<<grid_for(numel, kBlockThreads), kBlockThreads, 0, stream>>>(
            xt, yt, ot, rt, numel);
  }
}

template <bool Gather, typename T, bool Narrow>
int launch_ew(int ew, const void* x, const void* y, void* out,
              const void* regs, int64_t numel, int n_digits,
              cudaStream_t stream) {
  switch (ew) {
    case kNone: launch_typed<Gather, T, kNone, Narrow>(x, y, out, regs, numel, n_digits, stream); break;
    case kAdd: launch_typed<Gather, T, kAdd, Narrow>(x, y, out, regs, numel, n_digits, stream); break;
    case kSub: launch_typed<Gather, T, kSub, Narrow>(x, y, out, regs, numel, n_digits, stream); break;
    case kMul: launch_typed<Gather, T, kMul, Narrow>(x, y, out, regs, numel, n_digits, stream); break;
    case kMax: launch_typed<Gather, T, kMax, Narrow>(x, y, out, regs, numel, n_digits, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <bool Gather, bool Narrow>
int launch_dtype(int dtype, int ew, const void* x, const void* y, void* out,
                 const void* regs, int64_t numel, int n_digits,
                 cudaStream_t stream) {
  switch (dtype) {
    case kInt8: return launch_ew<Gather, int8_t, Narrow>(ew, x, y, out, regs, numel, n_digits, stream);
    case kInt32: return launch_ew<Gather, int32_t, Narrow>(ew, x, y, out, regs, numel, n_digits, stream);
    case kBf16: return launch_ew<Gather, __nv_bfloat16, Narrow>(ew, x, y, out, regs, numel, n_digits, stream);
    case kF32: return launch_ew<Gather, float, Narrow>(ew, x, y, out, regs, numel, n_digits, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool Gather>
int launch(const void* x, const void* y, void* out, const void* regs,
           int dtype, int ew, int64_t numel, int narrow, int n_digits,
           void* stream) {
  if (numel <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = narrow
      ? launch_dtype<Gather, true>(dtype, ew, x, y, out, regs, numel,
                                   n_digits, s)
      : launch_dtype<Gather, false>(dtype, ew, x, y, out, regs, numel,
                                    n_digits, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tm_affine_block(const void* x, const void* y, void* out,
                               const void* regs, int dtype, int ew,
                               int64_t numel, int narrow, void* stream) {
  return launch<false>(x, y, out, regs, dtype, ew, numel, narrow, 0, stream);
}

extern "C" int tm_affine_gather(const void* x, const void* y, void* out,
                                const void* regs, int dtype, int ew,
                                int64_t numel, int narrow, int n_digits,
                                void* stream) {
  return launch<true>(x, y, out, regs, dtype, ew, numel, narrow, n_digits,
                      stream);
}
