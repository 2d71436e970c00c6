// Coarse-grained TM kernels for Hopper (sm_90a): the TMU's address generator.
//
// Replaces the JAX package's Pallas kernels in
// src/repro/kernels/tm_affine/tm_affine.py:
//   * tm_affine_block  <- _block_call / _block_kernel (block mode: a signed
//     axis permutation with block-aligned offsets; transpose, rot90, split,
//     the Add epilogue);
//   * tm_affine_gather <- _gather_call / _gather_kernel (gather mode: any
//     MixedRadixMap, out-of-bounds elements read the fill register; a
//     separable path for maps whose address splits into a run table and a
//     per-run base, a general path for the rest).
//
// Bound on an H100: both kernels only move data, so the bound is the bytes
// they must move (input read once, epilogue operand read once, output
// written once) over HBM bandwidth (3.35 TB/s).  What stands between a
// kernel and that bound is the work per byte (index arithmetic, one access
// per element) and uncoalesced accesses.
//
// Block mode: the host decodes the map once (kernels/tm_affine/
// tm_affine.py: _block_regs, cached per map and dtype) and picks one of
// three paths, written into the register table beside the map:
//   * vector — the innermost output axis reads the source's innermost axis
//     forward (transpose, rot90, split and Add of HWC maps, which keep C
//     innermost).  Each output row is then one contiguous source run, so
//     the kernel moves V bytes per access (V the largest power of two <= 16
//     that divides the run, the base and every other coefficient in bytes:
//     every vector is aligned), runs the index arithmetic once per vector,
//     and keeps four vectors in flight per thread;
//   * tile — the innermost output axis reads with a stride (HWC -> CHW, a
//     4-d permutation): a 32 x 64 tile of (the output axis that reads the
//     source's innermost axis, the innermost output axis) is read in the
//     source's order into padded shared memory and written in the output's
//     order, so both sides coalesce, 8 loads in flight per thread;
//   * scalar — what neither takes (a reversed innermost axis, 64-bit
//     maps): one thread per output element in a grid-stride loop.
//
// Gather mode has two paths, chosen by the host's plan
// (kernels/tm_affine/tm_affine.py: separable_plan, gather_launch):
//   * separable (sep_kernel) — the maps of the main path (upsample, pixel
//     shuffle and unshuffle, rearrange, pads, reshapes) have a suffix of
//     output axes over which the source address separates into base(outer
//     digits) + off[p]: a run of R consecutive output elements whose
//     sources are one table of offsets from a base that only the outer
//     digits decide.  The host builds the table (R int32 entries, fill
//     marked) and the outer map's words; the kernel stages the table in
//     shared memory, decodes each run's base once (magic-number divisions,
//     one thread a run, a step ahead), and moves the run as 16-byte
//     accesses where the table and every base keep them aligned (upsample:
//     a whole output pixel's channels from one source pixel), else element
//     by element;
//   * general (gather_kernel) — what no suffix within the table's cap
//     separates (img2col-like maps whose rows mix outer and inner digits
//     under a bounds check), and 64-bit maps: one thread per output element
//     in a grid-stride loop, so consecutive threads write consecutive
//     output elements (coalesced stores).  Each thread computes its source
//     address from the map itself, the TMU's own address generator: the
//     mixed-radix digit splits and the integer affine rows (numerators,
//     offset numerator, common denominator, floor division), validity
//     against in_shape and the digit bounds.
// The Pallas gather kernel instead streams a precomputed int32 index and a
// bool mask beside the data (5 bytes per element, more than an int8 or bf16
// element itself); here the only traffic is the data (and, on the
// separable path, a table of at most 32 KB per block).  So that the
// general kernel's address arithmetic stays below the memory time:
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
// The gather's reads follow the map and coalesce only where it does.
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
//       [50] the host's path (0 scalar, 1 vector, 2 tile)  [51] V, the
//       bytes each access moves
//       vector path: [52 + k] words 0-49 again, in units of V bytes
//       tile path: [52] p  [53] tiles along p  [54] its magic  [55] its
//       shifts  [56] tiles along the innermost axis  [57] its magic  [58]
//       its shifts
// The source flat index of output coordinate o is base + sum_d coef[d]·o[d]
// (coef[d] = sign[d] * in_stride[src_axis[d]]).  The scalar path
// (block_kernel) takes any map, 32- or 64-bit; the vector and tile paths
// only 32-bit ones.
// ---------------------------------------------------------------------------

constexpr int kBlockRegs = 2 + 4 * kMaxAxes;
constexpr int kVecTable = kBlockRegs + 2;
constexpr int kTileWords = kBlockRegs + 2;
constexpr int kBlockTable = kVecTable + kBlockRegs;
enum BlockPath { kScalar = 0, kVector = 1, kTiled = 2 };

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
// block mode, vector path: the innermost output axis reads the source's
// innermost axis forward (coef +1), so every output row is one contiguous
// source run.  The host's table at kVecTable is the block table in units of
// V bytes (V divides the run, the base and every other coefficient, so
// every vector of x, y and out is aligned): the kernel is block_kernel's
// over V-byte elements, with the index arithmetic once per vector and
// kVecPer vectors in flight per thread.
// ---------------------------------------------------------------------------

template <int VB> struct VecOf;
template <> struct VecOf<1> { using type = uint8_t; };
template <> struct VecOf<2> { using type = uint16_t; };
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// the EW epilogue on each element of a vector
template <typename T, int EW, typename V>
__device__ __forceinline__ V apply_ew_vec(V a, V b) {
  constexpr int n = sizeof(V) / sizeof(T);
  T ea[n], eb[n];
  memcpy(ea, &a, sizeof(V));
  memcpy(eb, &b, sizeof(V));
#pragma unroll
  for (int i = 0; i < n; ++i) ea[i] = apply_ew<T, EW>(ea[i], eb[i]);
  memcpy(&a, ea, sizeof(V));
  return a;
}

constexpr int kVecPer = 4;

template <typename T, int EW, int VB>
__global__ void __launch_bounds__(kBlockThreads)
vector_kernel(const typename VecOf<VB>::type* __restrict__ x,
              const typename VecOf<VB>::type* __restrict__ y,
              typename VecOf<VB>::type* __restrict__ out,
              const int64_t* __restrict__ regs, int64_t n_vec) {
  using V = typename VecOf<VB>::type;
  using U = uint32_t;
  using S = int32_t;
  __shared__ int64_t s_regs[kBlockRegs];
  for (int k = threadIdx.x; k < kBlockRegs; k += blockDim.x) {
    s_regs[k] = regs[kVecTable + k];
  }
  __syncthreads();
  const int ndim = static_cast<int>(s_regs[0]);
  const S base = static_cast<S>(s_regs[1]);
  const int64_t* shape = s_regs + 2;
  const int64_t* coef = s_regs + 2 + kMaxAxes;
  const int64_t* magic = s_regs + 2 + 2 * kMaxAxes;
  const int64_t* shifts = s_regs + 2 + 3 * kMaxAxes;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x * kVecPer;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x * kVecPer +
                    threadIdx.x;
       i0 < n_vec; i0 += step) {
    V v[kVecPer];
#pragma unroll
    for (int u = 0; u < kVecPer; ++u) {
      const int64_t i = i0 + u * blockDim.x;
      if (i >= n_vec) continue;
      U rem = static_cast<U>(i);
      S src = base;
      for (int d = ndim - 1; d > 0; --d) {
        const U q = Index<true>::div(rem, shape[d], magic[d], shifts[d]);
        src += static_cast<S>(rem - q * static_cast<U>(shape[d])) *
               static_cast<S>(coef[d]);
        rem = q;
      }
      src += static_cast<S>(rem) * static_cast<S>(coef[0]);
      v[u] = x[src];
    }
#pragma unroll
    for (int u = 0; u < kVecPer; ++u) {
      const int64_t i = i0 + u * blockDim.x;
      if (i >= n_vec) continue;
      V o = v[u];
      if constexpr (EW != kNone) o = apply_ew_vec<T, EW>(o, y[i]);
      out[i] = o;
    }
  }
}

// ---------------------------------------------------------------------------
// block mode, tile path: the innermost output axis reads with a stride
// (HWC -> CHW, a 4-d permutation), and output axis p reads the source's
// innermost axis forward.  A kTileP x kTileL tile of (p, innermost) is
// read along p (the source's order) into padded shared memory and written
// along the innermost axis (the output's order): both sides coalesced, 8
// loads in flight per thread.
// Words at kTileWords: p, the tiles along p (its magic, its shifts), the
// tiles along the innermost axis (its magic, its shifts).  A tile's index
// is ((outer) tiles_p + tp) tiles_last + tl, outer the row-major index of
// the other output axes.
// ---------------------------------------------------------------------------

constexpr int kTileP = 32;  // tile extent along p: the lanes of a read
constexpr int kTileL = 64;  // along the innermost axis: two lanes' worth
constexpr int kTileRows = kBlockThreads / 32;  // 8

template <typename T, int EW>
__global__ void __launch_bounds__(kBlockThreads)
tile_kernel(const T* __restrict__ x, const T* __restrict__ y,
            T* __restrict__ out, const int64_t* __restrict__ regs,
            int64_t n_tiles) {
  using U = uint32_t;
  using S = int32_t;
  __shared__ int64_t s_regs[kBlockTable];
  __shared__ T tile[kTileL][kTileP + 1];
  for (int k = threadIdx.x; k < kBlockTable; k += blockDim.x) {
    s_regs[k] = regs[k];
  }
  __syncthreads();
  const int ndim = static_cast<int>(s_regs[0]);
  const S base = static_cast<S>(s_regs[1]);
  const int64_t* shape = s_regs + 2;
  const int64_t* coef = s_regs + 2 + kMaxAxes;
  const int64_t* magic = s_regs + 2 + 2 * kMaxAxes;
  const int64_t* shifts = s_regs + 2 + 3 * kMaxAxes;
  const int64_t* tw = s_regs + kTileWords;
  const int p = static_cast<int>(tw[0]);
  const int last = ndim - 1;
  const S size_p = static_cast<S>(shape[p]);
  const S size_l = static_cast<S>(shape[last]);
  const S coef_l = static_cast<S>(coef[last]);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int64_t tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
    U rem = static_cast<U>(tile_i);
    U q = Index<true>::div(rem, tw[4], tw[5], tw[6]);
    const S l0 = static_cast<S>(rem - q * static_cast<U>(tw[4])) * kTileL;
    rem = q;
    q = Index<true>::div(rem, tw[1], tw[2], tw[3]);
    const S p0 = static_cast<S>(rem - q * static_cast<U>(tw[1])) * kTileP;
    rem = q;
    // the other axes: their source offsets, and the output's row-major
    // strides (stride_p for p)
    S src = base + p0 + l0 * coef_l, dst = l0, stride = size_l;
    S stride_p = 0;
    for (int d = last - 1; d >= 0; --d) {
      if (d == p) {
        stride_p = stride;
      } else {
        q = Index<true>::div(rem, shape[d], magic[d], shifts[d]);
        const S od = static_cast<S>(rem - q * static_cast<U>(shape[d]));
        rem = q;
        src += od * static_cast<S>(coef[d]);
        dst += od * stride;
      }
      stride *= static_cast<S>(shape[d]);
    }
    dst += p0 * stride_p;
    // read along p (lanes), 8 rows of the innermost axis per pass
#pragma unroll
    for (int i = 0; i < kTileL / kTileRows; ++i) {
      const int li = ty + i * kTileRows;
      if (p0 + tx < size_p && l0 + li < size_l) {
        tile[li][tx] = x[src + tx + li * coef_l];
      }
    }
    __syncthreads();
    // write along the innermost axis (lanes, two halves of 32)
#pragma unroll
    for (int i = 0; i < kTileP / kTileRows; ++i) {
#pragma unroll
      for (int h = 0; h < kTileL / 32; ++h) {
        const int pi = ty + i * kTileRows, li = tx + 32 * h;
        if (p0 + pi < size_p && l0 + li < size_l) {
          const S o = dst + pi * stride_p + li;
          T v = tile[li][pi];
          if constexpr (EW != kNone) v = apply_ew<T, EW>(v, y[o]);
          out[o] = v;
        }
      }
    }
    __syncthreads();
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
// gather mode, separable path
//
// The host (kernels/tm_affine/tm_affine.py: separable_plan) found a suffix
// of output axes over which the source address separates: output element
// p of run q (runs of U accesses, each of VB bytes: one element, or 16
// bytes) reads unit base(q) + off[p] of x where valid(q) and
// off[p] != kSepInvalid, else the fill.  base and valid(q) depend only on
// the outer digits (the axes before the suffix and their splits); off is a
// table of U int32 entries, in units of V bytes.
//
// words (int64):
//   [0] outer axes  [1] outer splits  [2] outer rows  [3] outer bounds
//   [4] U  [5] its magic  [6] its shifts  [7] fill bits
//   [12 + a] outer extent  [24 + a] its magic  [36 + a] its shifts
//   [48 + j] split axis  [60 + j] radix  [72 + j] its magic  [84 + j] shifts
//   [96 + k] bounded outer digit  [108 + k] its bound
//   [120 + 5 r + f] row r: f = 0 offset numerator, 1 denominator, 2 the
//       largest in-range coordinate, 3 stride (units), 4 checked
//   [180 + 24 r + d] row r's numerator of outer digit d
// The outer digit vector is (the outer coordinates with quotients in
// place, the outer splits' remainders in order), as expand_digits.
// ---------------------------------------------------------------------------

constexpr int kSepThreads = 128;
constexpr int kSepMaxChunk = 2048;  // accesses of a block step, at most
constexpr int kSepWords = 180 + kMaxAxes * kMaxDigits;
constexpr int kSepMaxTable = 8192;  // tm_affine.py SEP_CAP
constexpr int32_t kSepInvalid = INT32_MIN;  // a table entry: fill
constexpr int32_t kSepNoRun = INT32_MIN;    // a run's base: the run is fill

// accesses a thread keeps in flight: 8 of 16 bytes, 16 of one element
template <int VB>
__host__ __device__ constexpr int sep_per() { return VB >= 8 ? 8 : 16; }

// base of run q from the outer digits, or kSepNoRun where a digit bound or
// a checked row fails (32-bit: the host proves every partial sum fits and
// |base| < 2^31, so no base is kSepNoRun)
__device__ __forceinline__ int32_t sep_run(const int64_t* w, uint32_t q) {
  const int n_ax = static_cast<int>(w[0]);
  const int n_sp = static_cast<int>(w[1]);
  const int n_rows = static_cast<int>(w[2]);
  const int n_bounds = static_cast<int>(w[3]);
  uint32_t dig[kMaxDigits];
  uint32_t rem = q;
  for (int a = n_ax - 1; a > 0; --a) {
    const uint32_t d = Index<true>::div(rem, w[12 + a], w[24 + a], w[36 + a]);
    dig[a] = rem - d * static_cast<uint32_t>(w[12 + a]);
    rem = d;
  }
  if (n_ax > 0) dig[0] = rem;
  for (int j = 0; j < n_sp; ++j) {
    const int ax = static_cast<int>(w[48 + j]);
    const uint32_t v = dig[ax];
    const uint32_t d = Index<true>::div(v, w[60 + j], w[72 + j], w[84 + j]);
    dig[ax] = d;
    dig[n_ax + j] = v - d * static_cast<uint32_t>(w[60 + j]);
  }
  bool ok = true;
  for (int k = 0; k < n_bounds; ++k) {
    ok = ok && static_cast<int64_t>(dig[w[96 + k]]) < w[108 + k];
  }
  int32_t b = 0;
  for (int r = 0; r < n_rows; ++r) {
    const int64_t* row = w + 120 + 5 * r;
    const int64_t* nums = w + 180 + kMaxDigits * r;
    int32_t acc = static_cast<int32_t>(row[0]);
    for (int d = 0; d < n_ax + n_sp; ++d) {
      acc += static_cast<int32_t>(nums[d]) * static_cast<int32_t>(dig[d]);
    }
    const int32_t den = static_cast<int32_t>(row[1]);
    int32_t c = den == 1 ? acc : floordiv<int32_t>(acc, den);
    if (row[4] != 0) {
      const int32_t hi = static_cast<int32_t>(row[2]);
      ok = ok && c >= 0 && c <= hi;
      c = c < 0 ? 0 : (c > hi ? hi : c);
    }
    b += c * static_cast<int32_t>(row[3]);
  }
  return ok ? b : kSepNoRun;
}

// The bases of the runs that accesses [c0, c1) touch, into s_base.
__device__ __forceinline__ void sep_decode(const int64_t* w, uint32_t c0,
                                           uint32_t c1, uint32_t U,
                                           int32_t* s_base) {
  const uint32_t first = Index<true>::div(c0, U, w[5], w[6]);
  const uint32_t n_runs = Index<true>::div(c1 - 1, U, w[5], w[6]) - first + 1;
  for (uint32_t r = threadIdx.x; r < n_runs; r += kSepThreads) {
    s_base[r] = sep_run(w, first + r);
  }
}

// A block step moves P x kSepThreads consecutive accesses of the output,
// thread t taking accesses t, t + kSepThreads, ... (consecutive threads on
// consecutive accesses: coalesced stores), its P loads issued before its
// stores.  The runs a step touches are decoded into shared memory one
// step ahead, one thread a run, between the step's loads and its stores,
// so that the decode overlaps the loads in flight; two buffers of bases
// and one barrier a step.  The run table sits in shared memory for the
// block's life.
template <typename T, int EW, int VB>
__global__ void __launch_bounds__(kSepThreads, 8)
sep_kernel(const typename VecOf<VB>::type* __restrict__ x,
           const typename VecOf<VB>::type* __restrict__ y,
           typename VecOf<VB>::type* __restrict__ out,
           const int64_t* __restrict__ words,
           const int32_t* __restrict__ offs, uint32_t n_units) {
  using V = typename VecOf<VB>::type;
  constexpr int P = sep_per<VB>();
  constexpr uint32_t kChunk = kSepThreads * P;
  static_assert(kChunk <= kSepMaxChunk, "a step's runs overflow s_base");
  __shared__ int64_t w[kSepWords];
  __shared__ int32_t s_base[2][kSepMaxChunk + 1];
  extern __shared__ int32_t s_off[];
  for (int k = threadIdx.x; k < kSepWords; k += blockDim.x) w[k] = words[k];
  const uint32_t U = static_cast<uint32_t>(words[4]);
  for (uint32_t k = threadIdx.x; k < U; k += blockDim.x) s_off[k] = offs[k];
  V fill;
  {
    const int64_t bits = words[7];
    T f;
    memcpy(&f, &bits, sizeof(T));
    T lanes[VB / sizeof(T)];
#pragma unroll
    for (int e = 0; e < static_cast<int>(VB / sizeof(T)); ++e) lanes[e] = f;
    memcpy(&fill, lanes, VB);
  }
  __syncthreads();
  const int64_t umg = w[5], ush = w[6];
  const int t = threadIdx.x;
  const uint32_t step = gridDim.x * kChunk;
  uint32_t c0 = blockIdx.x * kChunk;
  if (c0 < n_units) {
    sep_decode(w, c0, n_units - c0 < kChunk ? n_units : c0 + kChunk, U,
               s_base[0]);
  }
  __syncthreads();
  for (int b = 0; c0 < n_units; c0 += step, b ^= 1) {
    const uint32_t c1 = n_units - c0 < kChunk ? n_units : c0 + kChunk;
    const uint32_t first = Index<true>::div(c0, U, umg, ush);
    const int32_t* bases = s_base[b];
    V v[P];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const uint32_t i = c0 + t + u * kSepThreads;
      v[u] = fill;
      if (i < c1) {
        const uint32_t q = Index<true>::div(i, U, umg, ush);
        const int32_t o = s_off[i - q * U];
        const int32_t base = bases[q - first];
        if (base != kSepNoRun && o != kSepInvalid) v[u] = x[base + o];
      }
    }
    // the next step's runs, while this step's loads are in flight
    if (c0 + step < n_units) {
      const uint32_t n0 = c0 + step;
      sep_decode(w, n0, n_units - n0 < kChunk ? n_units : n0 + kChunk, U,
                 s_base[b ^ 1]);
    }
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const uint32_t i = c0 + t + u * kSepThreads;
      if (i < c1) {
        V o = v[u];
        if constexpr (EW != kNone) {
          if constexpr (VB == sizeof(T)) {
            T a, e;
            memcpy(&a, &o, sizeof(T));
            memcpy(&e, &y[i], sizeof(T));
            a = apply_ew<T, EW>(a, e);
            memcpy(&o, &a, sizeof(T));
          } else {
            o = apply_ew_vec<T, EW>(o, y[i]);
          }
        }
        out[i] = o;
      }
    }
    __syncthreads();  // the next step reads s_base[b ^ 1]; b is free again
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


// the vector and tile paths of block mode (32-bit index arithmetic only)
template <typename T, int EW>
int launch_block_path(int path, int vb, const void* x, const void* y,
                      void* out, const void* regs, int64_t units,
                      cudaStream_t stream) {
  const int64_t* rt = static_cast<const int64_t*>(regs);
  if (path == kTiled) {
    const int64_t cap = 132 * 8;
    tile_kernel<T, EW><<<static_cast<unsigned>(units < cap ? units : cap),
                         kBlockThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<T*>(out), rt, units);
    return 0;
  }
  const unsigned grid = grid_for((units + kVecPer - 1) / kVecPer,
                                 kBlockThreads);
#define VEC_CASE(b)                                                        \
  case b:                                                                  \
    if constexpr (static_cast<size_t>(b) >= 2 * sizeof(T)) {              \
      using V = typename VecOf<b>::type;                                   \
      vector_kernel<T, EW, b><<<grid, kBlockThreads, 0, stream>>>(         \
          static_cast<const V*>(x), static_cast<const V*>(y),              \
          static_cast<V*>(out), rt, units);                                \
      return 0;                                                            \
    }                                                                      \
    break;
  switch (vb) {
    VEC_CASE(2) VEC_CASE(4) VEC_CASE(8) VEC_CASE(16)
    default: break;
  }
#undef VEC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int block_path_ew(int ew, int path, int vb, const void* x, const void* y,
                  void* out, const void* regs, int64_t units,
                  cudaStream_t s) {
  switch (ew) {
    case kNone: return launch_block_path<T, kNone>(path, vb, x, y, out, regs, units, s);
    case kAdd: return launch_block_path<T, kAdd>(path, vb, x, y, out, regs, units, s);
    case kSub: return launch_block_path<T, kSub>(path, vb, x, y, out, regs, units, s);
    case kMul: return launch_block_path<T, kMul>(path, vb, x, y, out, regs, units, s);
    case kMax: return launch_block_path<T, kMax>(path, vb, x, y, out, regs, units, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int block_path(int dtype, int ew, int path, int vb, const void* x,
               const void* y, void* out, const void* regs, int64_t units,
               cudaStream_t s) {
  switch (dtype) {
    case kInt8: return block_path_ew<int8_t>(ew, path, vb, x, y, out, regs, units, s);
    case kInt32: return block_path_ew<int32_t>(ew, path, vb, x, y, out, regs, units, s);
    case kBf16: return block_path_ew<__nv_bfloat16>(ew, path, vb, x, y, out, regs, units, s);
    case kF32: return block_path_ew<float>(ew, path, vb, x, y, out, regs, units, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// sep_kernel's static shared memory: its words and two steps' run bases
constexpr size_t kSepStaticSmem =
    sizeof(int64_t) * kSepWords + sizeof(int32_t) * 2 * (kSepMaxChunk + 1);

template <typename T, int EW, int VB>
int launch_sep_vec(const void* x, const void* y, void* out,
                   const int64_t* w, const int32_t* o, int64_t units,
                   size_t dyn, cudaStream_t stream) {
  using V = typename VecOf<VB>::type;
  const int64_t cap = 132 * 16;  // blocks in flight; the loop strides
  const int64_t chunk = kSepThreads * sep_per<VB>();
  const int64_t chunks = (units + chunk - 1) / chunk;
  // a run table past the 48 KB a block gets without asking
  if (kSepStaticSmem + dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sep_kernel<T, EW, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sep_kernel<T, EW, VB>
      <<<static_cast<unsigned>(chunks < cap ? chunks : cap), kSepThreads,
         dyn, stream>>>(static_cast<const V*>(x), static_cast<const V*>(y),
                        static_cast<V*>(out), w, o,
                        static_cast<uint32_t>(units));
  return 0;
}

// the separable path: the instantiation for (T, EW, vbytes), accesses of
// one element or of 16 bytes, the run table in dynamic shared memory
template <typename T, int EW>
int launch_sep(int vbytes, const void* x, const void* y, void* out,
               const void* words, const void* offs, int64_t numel,
               int table_len, cudaStream_t stream) {
  const int ve = vbytes / static_cast<int>(sizeof(T));
  if (ve < 1 || vbytes % static_cast<int>(sizeof(T)) != 0 || numel % ve != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t units = numel / ve;
  const size_t dyn = static_cast<size_t>(table_len) * sizeof(int32_t);
  const int64_t* w = static_cast<const int64_t*>(words);
  const int32_t* o = static_cast<const int32_t*>(offs);
  if (vbytes == static_cast<int>(sizeof(T))) {
    return launch_sep_vec<T, EW, sizeof(T)>(x, y, out, w, o, units, dyn,
                                            stream);
  }
  if (vbytes == 16) {
    return launch_sep_vec<T, EW, 16>(x, y, out, w, o, units, dyn, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int sep_ew(int ew, int vbytes, const void* x, const void* y, void* out,
           const void* words, const void* offs, int64_t numel, int table_len,
           cudaStream_t s) {
  switch (ew) {
    case kNone: return launch_sep<T, kNone>(vbytes, x, y, out, words, offs, numel, table_len, s);
    case kAdd: return launch_sep<T, kAdd>(vbytes, x, y, out, words, offs, numel, table_len, s);
    case kSub: return launch_sep<T, kSub>(vbytes, x, y, out, words, offs, numel, table_len, s);
    case kMul: return launch_sep<T, kMul>(vbytes, x, y, out, words, offs, numel, table_len, s);
    case kMax: return launch_sep<T, kMax>(vbytes, x, y, out, words, offs, numel, table_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int sep_dtype(int dtype, int ew, int vbytes, const void* x, const void* y,
              void* out, const void* words, const void* offs, int64_t numel,
              int table_len, cudaStream_t s) {
  switch (dtype) {
    case kInt8: return sep_ew<int8_t>(ew, vbytes, x, y, out, words, offs, numel, table_len, s);
    case kInt32: return sep_ew<int32_t>(ew, vbytes, x, y, out, words, offs, numel, table_len, s);
    case kBf16: return sep_ew<__nv_bfloat16>(ew, vbytes, x, y, out, words, offs, numel, table_len, s);
    case kF32: return sep_ew<float>(ew, vbytes, x, y, out, words, offs, numel, table_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Block mode over the host's path (regs [50]): kScalar runs block_kernel
// over numel elements; kVector runs vector_kernel over `units` vectors of
// `vbytes` bytes (x, y and out aligned to it); kTiled runs tile_kernel over
// `units` tiles.  The vector and tile paths need the 32-bit arithmetic.
extern "C" int tm_affine_block(const void* x, const void* y, void* out,
                               const void* regs, int dtype, int ew,
                               int64_t numel, int narrow, int path,
                               int vbytes, int64_t units, void* stream) {
  if (path == kScalar) {
    return launch<false>(x, y, out, regs, dtype, ew, numel, narrow, 0,
                         stream);
  }
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(out);
  if (numel <= 0 || units <= 0 || !narrow ||
      (path != kVector && path != kTiled) ||
      (path == kVector && (vbytes <= 0 || any % vbytes != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = block_path(dtype, ew, path, vbytes, x, y, out, regs, units,
                            static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Gather mode over the host's path: 0 runs the general kernel over the
// register file `regs` (n_digits digits, `narrow` 32-bit); 1 runs the
// separable kernel over its words `regs` and run table `offs` (table_len
// entries), moving numel elements as accesses of `vbytes` bytes (x, y and
// out aligned to it).
extern "C" int tm_affine_gather(const void* x, const void* y, void* out,
                                const void* regs, int dtype, int ew,
                                int64_t numel, int narrow, int n_digits,
                                int path, int vbytes, const void* offs,
                                int table_len, void* stream) {
  if (path == 0) {
    return launch<true>(x, y, out, regs, dtype, ew, numel, narrow, n_digits,
                        stream);
  }
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(out);
  if (path != 1 || numel <= 0 || numel >= (int64_t{1} << 31) || !narrow ||
      offs == nullptr || vbytes <= 0 || any % vbytes != 0 ||
      table_len < 1 || table_len > kSepMaxTable) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = sep_dtype(dtype, ew, vbytes, x, y, out, regs, offs, numel,
                           table_len, static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
