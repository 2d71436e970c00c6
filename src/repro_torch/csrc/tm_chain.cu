// Forwarding-chain megakernel for Hopper (sm_90a): a producer->consumer run
// of coarse TM instructions in ONE launch.
//
// Replaces the JAX package's Pallas kernel in
// src/repro/kernels/tm_affine/chain.py: _chain_executable (body
// _chain_kernel).  The host (kernels/tm_affine/chain.py) pulls every link
// of the chain back onto the final output: a flat index j into the chain
// input, and per level a validity mask, a fill, and for a link with an
// element-wise epilogue the flat index p of its operand.  A terminal
// multi-band Route adds "extra" bands, each a flat index into its own
// source with its own mask and fill.
//
// Bound on an H100: bytes over HBM bandwidth (3.35 TB/s).  The function
// must read the chain input, every epilogue operand and every Route band
// source once and write the output once; the intermediates of the chain
// never reach device memory.
//
// Design: one thread per output element in a grid-stride loop, so the
// output, j, p, idx and the masks are read and written coalesced; the
// chain input and the operands are gathered.  Each thread computes exactly
// what _chain_kernel computes for its element:
//   v = x[j]; for each level: v = mask ? v : fill, then v = ew(v, y[p]);
//   for each extra band: v = v + (mask ? z[idx] : fill)
// rounding to the element type after every step (a bf16 chain rounds after
// each epilogue and each band sum, an int8 chain wraps at each level), as
// the Pallas body keeps v in the working dtype.  The levels and extras are
// runtime data: a descriptor table passed by value as a __grid_constant__
// kernel parameter, so it sits in the constant bank, is read by every
// thread at the same address (a broadcast), and costs no copy of its own
// per call.  The index arrays are uploaded once per chain and device; the
// table holds their pointers beside the operand pointers of this call.
//
// This simple design streams 4 bytes of index (and 1 of mask) per element
// per array, as the Pallas kernel does; generating the addresses from the
// maps' registers, as the gather kernel in tm_affine.cu does, is later
// work.
//
// Element types: int8, int32, bf16, f32.  EW epilogue: add, sub, mul, max,
// with the arithmetic of tm_affine.cu: integers wrap (computed in
// unsigned), bf16 goes through f32 and rounds to nearest even, max
// propagates NaN.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;  // chain.MAX_LEVELS
constexpr int kMaxExtras = 16;  // chain.MAX_EXTRAS

enum Dtype { kInt8 = 0, kInt32 = 1, kBf16 = 2, kF32 = 3 };
enum Ew { kNone = 0, kAdd = 1, kSub = 2, kMul = 3, kMax = 4 };

// ---------------------------------------------------------------------------
// element-wise arithmetic, rounded to T after every operation
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ew_float(int ew, float a, float b) {
  switch (ew) {
    case kAdd: return a + b;
    case kSub: return a - b;
    case kMul: return a * b;
    default:
      // NaN-propagating max (fmaxf would return the other operand)
      if (a != a) return a;
      if (b != b) return b;
      return a > b ? a : b;
  }
}

__device__ __forceinline__ int32_t ew_int(int ew, int32_t a, int32_t b) {
  const uint32_t ua = static_cast<uint32_t>(a);
  const uint32_t ub = static_cast<uint32_t>(b);
  switch (ew) {
    case kAdd: return static_cast<int32_t>(ua + ub);
    case kSub: return static_cast<int32_t>(ua - ub);
    case kMul: return static_cast<int32_t>(ua * ub);
    default: return a > b ? a : b;
  }
}

template <typename T>
__device__ __forceinline__ T apply_ew(int ew, T a, T b) {
  if constexpr (std::is_same<T, float>::value) {
    return ew_float(ew, a, b);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(
        ew_float(ew, __bfloat162float(a), __bfloat162float(b)));
  } else {
    // int8 results wrap on the narrowing conversion (two's complement)
    return static_cast<T>(ew_int(ew, static_cast<int32_t>(a),
                                 static_cast<int32_t>(b)));
  }
}

template <typename T>
__device__ __forceinline__ T from_bits(int64_t bits) {
  T v;
  memcpy(&v, &bits, sizeof(T));  // the low bytes hold the value
  return v;
}

// ---------------------------------------------------------------------------
// the descriptor table
//
// The host passes int64 words (chain._device_consts): j; per level mask,
// fill bits, ew code, p, y; per extra idx, mask, fill bits, z.  A pointer of
// 0 means none: a level without a mask is never out of bounds, a level
// without an epilogue has no p and y.
// ---------------------------------------------------------------------------

struct Level {
  const uint8_t* mask;
  int64_t fill;
  int64_t ew;
  const int32_t* p;
  const void* y;
};

struct Extra {
  const int32_t* idx;
  const uint8_t* mask;
  int64_t fill;
  const void* z;
};

struct Chain {
  const int32_t* j;
  int n_levels;
  int n_extras;
  Level level[kMaxLevels];
  Extra extra[kMaxExtras];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const T* __restrict__ x, T* __restrict__ out,
             const __grid_constant__ Chain c, int64_t numel) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < numel; i += stride) {
    T v = x[c.j[i]];
    for (int l = 0; l < c.n_levels; ++l) {
      const Level& lv = c.level[l];
      if (lv.mask != nullptr && lv.mask[i] == 0) v = from_bits<T>(lv.fill);
      if (lv.ew != kNone) {
        v = apply_ew<T>(static_cast<int>(lv.ew), v,
                        static_cast<const T*>(lv.y)[lv.p[i]]);
      }
    }
    for (int e = 0; e < c.n_extras; ++e) {
      const Extra& ex = c.extra[e];
      const T u = (ex.mask != nullptr && ex.mask[i] == 0)
                      ? from_bits<T>(ex.fill)
                      : static_cast<const T*>(ex.z)[ex.idx[i]];
      v = apply_ew<T>(kAdd, v, u);
    }
    out[i] = v;
  }
}

inline unsigned grid_for(int64_t numel) {
  const int64_t blocks = (numel + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // enough blocks in flight; the loop strides
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

template <typename T>
void launch_typed(const void* x, void* out, const Chain& c, int64_t numel,
                  cudaStream_t stream) {
  chain_kernel<T><<<grid_for(numel), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c, numel);
}

}  // namespace

extern "C" int tm_chain(const void* x, void* out, const int64_t* desc,
                        int dtype, int64_t numel, int n_levels, int n_extras,
                        void* stream) {
  if (numel <= 0 || n_levels < 0 || n_levels > kMaxLevels || n_extras < 0 ||
      n_extras > kMaxExtras) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Chain c;
  memset(&c, 0, sizeof(c));
  const int64_t* w = desc;
  c.j = reinterpret_cast<const int32_t*>(*w++);
  c.n_levels = n_levels;
  c.n_extras = n_extras;
  for (int l = 0; l < n_levels; ++l) {
    Level& lv = c.level[l];
    lv.mask = reinterpret_cast<const uint8_t*>(*w++);
    lv.fill = *w++;
    lv.ew = *w++;
    lv.p = reinterpret_cast<const int32_t*>(*w++);
    lv.y = reinterpret_cast<const void*>(*w++);
  }
  for (int e = 0; e < n_extras; ++e) {
    Extra& ex = c.extra[e];
    ex.idx = reinterpret_cast<const int32_t*>(*w++);
    ex.mask = reinterpret_cast<const uint8_t*>(*w++);
    ex.fill = *w++;
    ex.z = reinterpret_cast<const void*>(*w++);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kInt8: launch_typed<int8_t>(x, out, c, numel, s); break;
    case kInt32: launch_typed<int32_t>(x, out, c, numel, s); break;
    case kBf16: launch_typed<__nv_bfloat16>(x, out, c, numel, s); break;
    case kF32: launch_typed<float>(x, out, c, numel, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
