// The forwarding chain's descriptor tables and its element-wise arithmetic,
// shared by the chain megakernel (tm_chain.cu) and the cross-engine kernels
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
// the JAX package's Pallas body keeps v in the working dtype.  chain_plain
// (chain.py) computes this walk in PyTorch; every kernel's walk is held
// against it.
//
// Element-wise arithmetic is that of tm_affine.cu: integers wrap (computed
// in unsigned), bf16 goes through f32 and rounds to nearest even, max
// propagates NaN.
//
// Two descriptors of the same walk: chain::Chain holds the full-size
// index and mask arrays (read by the cross-engine kernels through
// chain_walk.cuh); chain::Runs holds them factored over runs of R
// consecutive output elements (chain.py build_run_plan), as the chain
// megakernel reads them: element o R + p reads index base[o] + off[p] and
// mask outer[o] & run[p], the R-entry run tables staged in shared memory.

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

// ---------------------------------------------------------------------------
// the run-table descriptor
//
// The host passes int64 words (chain._Launch): R, run table bytes, run
// table pointer, base_j pointer, off_j offset, elements per access, the
// magic and shifts of R / elements per access; per level outer mask
// pointer, run mask offset, fill bits, ew code, base_p pointer, off_p
// offset, y; per extra base pointer, off offset, outer mask pointer, run
// mask offset, fill bits, z.  Offsets are bytes into the run tables (staged
// in shared memory); a pointer of 0 or an offset of -1 means none: a level
// without a mask passes everywhere, a mask without an outer (run) part
// passes on every run (position).
// ---------------------------------------------------------------------------

struct RunLevel {
  const uint8_t* outer_ok;
  const int32_t* base;  // the epilogue operand's base per run
  const void* y;
  int64_t fill;
  int32_t run_ok;  // offsets into the staged run tables
  int32_t off;
  int32_t ew;
};

struct RunExtra {
  const int32_t* base;
  const uint8_t* outer_ok;
  const void* z;
  int64_t fill;
  int32_t off;
  int32_t run_ok;
};

struct Runs {
  const void* table;  // the run tables, 16-byte aligned, table_bytes long
  const int32_t* base_j;
  int32_t table_bytes;
  int32_t off_j;
  uint32_t units;  // accesses a run: R / vec
  uint32_t magic;  // of units (tm_affine.py _magic)
  uint32_t shifts;
  int32_t vec;
  int n_levels;
  int n_extras;
  RunLevel level[kMaxLevels];
  RunExtra extra[kMaxExtras];
};

// Returns false on a table the kernel cannot take.
inline bool parse_runs(const int64_t* w, int n_levels, int n_extras,
                       Runs* c) {
  if (n_levels < 0 || n_levels > kMaxLevels || n_extras < 0 ||
      n_extras > kMaxExtras || w[0] < 1 || w[5] < 1 || w[0] % w[5] != 0 ||
      w[1] < 0 || w[1] % 16 != 0) {
    return false;
  }
  memset(c, 0, sizeof(*c));
  c->table = reinterpret_cast<const void*>(w[2]);
  c->base_j = reinterpret_cast<const int32_t*>(w[3]);
  c->table_bytes = static_cast<int32_t>(w[1]);
  c->off_j = static_cast<int32_t>(w[4]);
  c->vec = static_cast<int32_t>(w[5]);
  c->units = static_cast<uint32_t>(w[0] / w[5]);
  c->magic = static_cast<uint32_t>(w[6]);
  c->shifts = static_cast<uint32_t>(w[7]);
  c->n_levels = n_levels;
  c->n_extras = n_extras;
  w += 8;
  for (int l = 0; l < n_levels; ++l, w += 7) {
    RunLevel& lv = c->level[l];
    lv.outer_ok = reinterpret_cast<const uint8_t*>(w[0]);
    lv.run_ok = static_cast<int32_t>(w[1]);
    lv.fill = w[2];
    lv.ew = static_cast<int32_t>(w[3]);
    lv.base = reinterpret_cast<const int32_t*>(w[4]);
    lv.off = static_cast<int32_t>(w[5]);
    lv.y = reinterpret_cast<const void*>(w[6]);
  }
  for (int e = 0; e < n_extras; ++e, w += 6) {
    RunExtra& ex = c->extra[e];
    ex.base = reinterpret_cast<const int32_t*>(w[0]);
    ex.off = static_cast<int32_t>(w[1]);
    ex.outer_ok = reinterpret_cast<const uint8_t*>(w[2]);
    ex.run_ok = static_cast<int32_t>(w[3]);
    ex.fill = w[4];
    ex.z = reinterpret_cast<const void*>(w[5]);
  }
  return true;
}

// run o = u / units of access u (multiply-high, as tm_affine.cu divides)
__device__ __forceinline__ uint32_t run_of(const Runs& c, uint32_t u) {
  const uint32_t t = __umulhi(u, c.magic);
  return (t + ((u - t) >> (c.shifts & 0xff))) >> (c.shifts >> 8);
}

// whether a mask (outer pointer, run offset) passes at run o, position p
__device__ __forceinline__ bool passes(const uint8_t* outer, int32_t run,
                                       const char* s, uint32_t o,
                                       uint32_t p) {
  return (outer == nullptr || outer[o] != 0) &&
         (run < 0 || reinterpret_cast<const uint8_t*>(s + run)[p] != 0);
}

__device__ __forceinline__ int32_t off_at(const char* s, int32_t off,
                                          uint32_t p) {
  return reinterpret_cast<const int32_t*>(s + off)[p];
}

}  // namespace chain
