// The forwarding chain's descriptor table and its per-element walk, shared
// by the chain megakernel (tm_chain.cu) and the cross-engine kernels
// (xchain_commit.cu, xchain_prologue.cu, through chain_walk.cuh).
//
// The host (kernels/tm_affine/chain.py) pulls every link of a chain back
// onto the final output: a flat index j into the chain's source, and per
// level a validity mask, a fill, and for a link with an element-wise
// epilogue the flat index p of its operand.  A terminal multi-band Route
// adds "extra" bands, each a flat index into its own source with its own
// mask and fill.  Element i of the chain's output is
//   v = source[j[i]]; for each level: v = mask ? v : fill, then
//   v = ew(v, y[p]); for each extra band: v = v + (mask ? z[idx] : fill)
// rounded to the element type after every step (a bf16 chain rounds after
// each epilogue and each band sum, an int8 chain wraps at each level), as
// the JAX package's Pallas body keeps v in the working dtype.
//
// Element-wise arithmetic is that of tm_affine.cu: integers wrap (computed
// in unsigned), bf16 goes through f32 and rounds to nearest even, max
// propagates NaN.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace chain {


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

// The descriptor table passed by value as a __grid_constant__ kernel
// parameter: it sits in the constant bank and every thread reads it at the
// same address (a broadcast).  Returns false on a table the kernel cannot
// take.
inline bool parse(const int64_t* desc, int n_levels, int n_extras, Chain* c) {
  if (n_levels < 0 || n_levels > kMaxLevels || n_extras < 0 ||
      n_extras > kMaxExtras) {
    return false;
  }
  memset(c, 0, sizeof(*c));
  const int64_t* w = desc;
  c->j = reinterpret_cast<const int32_t*>(*w++);
  c->n_levels = n_levels;
  c->n_extras = n_extras;
  for (int l = 0; l < n_levels; ++l) {
    Level& lv = c->level[l];
    lv.mask = reinterpret_cast<const uint8_t*>(*w++);
    lv.fill = *w++;
    lv.ew = *w++;
    lv.p = reinterpret_cast<const int32_t*>(*w++);
    lv.y = reinterpret_cast<const void*>(*w++);
  }
  for (int e = 0; e < n_extras; ++e) {
    Extra& ex = c->extra[e];
    ex.idx = reinterpret_cast<const int32_t*>(*w++);
    ex.mask = reinterpret_cast<const uint8_t*>(*w++);
    ex.fill = *w++;
    ex.z = reinterpret_cast<const void*>(*w++);
  }
  return true;
}

// False when some level masks element i out: its fill then overwrites the
// value read from the source, which need not be read (or computed) at all.
__device__ __forceinline__ bool source_needed(const Chain& c, int64_t i) {
  for (int l = 0; l < c.n_levels; ++l) {
    if (c.level[l].mask != nullptr && c.level[l].mask[i] == 0) return false;
  }
  return true;
}

// The walk after the source read: every level, then every extra band.
template <typename T>
__device__ __forceinline__ T apply(const Chain& c, T v, int64_t i) {
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
  return v;
}

// Element i of the chain's output, its source a tensor in memory.
template <typename T>
__device__ __forceinline__ T eval(const T* __restrict__ x, const Chain& c,
                                  int64_t i) {
  return apply<T>(c, x[c.j[i]], i);
}

}  // namespace chain
