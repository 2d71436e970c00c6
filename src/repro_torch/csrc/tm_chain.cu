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
// Design against that bound: the full-size pullback (4 bytes of index and
// 1 of mask per element per array: 16 MB beside 10 MB of data at the YOLO
// neck) is not streamed.  The host factors it over runs of R consecutive
// output elements (chain.py build_run_plan, checked element by element):
// element o R + p reads index base[o] + off[p] and mask outer[o] & run[p].
// Each block stages the R-entry run tables in shared memory once; the
// per-run bases and outer masks are read from device memory, a warp's
// threads at one address (a run holds many of a warp's accesses), the
// bases of j and of the first extra band a step ahead (the first step's
// while the tables are staged), so that the source and that band are read
// in one trip.  A thread keeps a few accesses in flight, consecutive
// threads on consecutive accesses (coalesced stores); where every table
// allows it (runs of 16 bytes, 16-byte aligned), an access moves 16 bytes.
//
// Each element is computed as chain_plain (chain.py) computes it, in the
// same order and rounding after every step, except that nothing is
// computed that a later fill overwrites: the walk starts at the last level
// that masks the element (its fill, then its epilogue), and the source is
// read only where no level masks the element.
//
// The levels and extras are runtime data: a descriptor (chain::Runs)
// passed by value as a __grid_constant__ kernel parameter, read by every
// thread at the same address.
//
// Element types: int8, int32, bf16, f32.  EW epilogue: add, sub, mul, max.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "chain_desc.cuh"

namespace {

constexpr int kThreads = 256;

// accesses a thread keeps in flight: 4 of one element, or 16 elements in
// 16-byte accesses but at least two (a bf16 access unpacks into 8
// registers for the epilogues and the band sums; ptxas spilled 8 bytes of
// the int8 kernel at one access)
template <int V>
__host__ __device__ constexpr int units_of() {
  return V == 1 ? 4 : (16 / V > 2 ? 16 / V : 2);
}

// V elements moved by one access
template <typename T, int V>
struct alignas(V * sizeof(T)) Elems {
  T e[V];
};

// int8 in 16-byte accesses: four elements a 32-bit word, their sums,
// differences and maxima taken by the SIMD byte instructions (unpacked
// bytes spilled)
template <int V>
struct alignas(V) Words {
  uint32_t w[V / 4];
};

template <typename T, int V>
using Pack = typename std::conditional<sizeof(T) == 1 && V >= 4, Words<V>,
                                       Elems<T, V>>::type;

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const void* p, int64_t i) {
  return reinterpret_cast<const Pack<T, V>*>(static_cast<const T*>(p) + i)[0];
}

// the fill register's low bytes as T (no memcpy: nothing goes to the stack)
template <typename T>
__device__ __forceinline__ T fill_of(int64_t bits) {
  if constexpr (std::is_same<T, float>::value) {
    return __int_as_float(static_cast<int>(bits));
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(bits));
  } else {
    return static_cast<T>(bits);  // int8, int32: two's complement low bytes
  }
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> splat(int64_t bits) {
  Pack<T, V> r;
  if constexpr (sizeof(T) == 1 && V >= 4) {
    const uint32_t b = static_cast<uint32_t>(bits & 0xff) * 0x01010101u;
#pragma unroll
    for (int q = 0; q < V / 4; ++q) r.w[q] = b;
  } else {
    const T f = fill_of<T>(bits);
#pragma unroll
    for (int e = 0; e < V; ++e) r.e[e] = f;
  }
  return r;
}

// a <ew> b element by element, rounded (wrapped) to T as chain::apply_ew
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> apply(int ew, Pack<T, V> a,
                                            const Pack<T, V>& b) {
  if constexpr (sizeof(T) == 1 && V >= 4) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const uint32_t x = a.w[q], y = b.w[q];
      switch (ew) {
        case chain::kAdd: a.w[q] = __vadd4(x, y); break;
        case chain::kSub: a.w[q] = __vsub4(x, y); break;
        case chain::kMax: a.w[q] = __vmaxs4(x, y); break;
        default: {  // kMul: byte by byte, wrapped
          uint32_t r = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int32_t m = static_cast<int8_t>(x >> (8 * k)) *
                              static_cast<int8_t>(y >> (8 * k));
            r |= (static_cast<uint32_t>(m) & 0xffu) << (8 * k);
          }
          a.w[q] = r;
        }
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) a.e[e] = chain::apply_ew<T>(ew, a.e[e], b.e[e]);
  }
  return a;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
run_kernel(const T* __restrict__ x, T* __restrict__ out,
           const __grid_constant__ chain::Runs c, uint32_t n_units) {
  using P = Pack<T, V>;
  constexpr int kUnits = units_of<V>();
  extern __shared__ int4 s_table[];
  const uint32_t step = gridDim.x * kThreads * kUnits;
  uint32_t u0 = blockIdx.x * kThreads * kUnits + threadIdx.x;
  // a step's accesses: run o, first position p, and the bases of j and of
  // the first extra band, loaded a step ahead (the first step's while the
  // run tables are staged) so that the source and band reads do not wait
  // for them
  uint32_t o[kUnits], p[kUnits];
  int32_t base_j[kUnits], base_z[kUnits];
  bool live[kUnits];
  auto prepare = [&](uint32_t first) {
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const uint32_t u = first + k * kThreads;
      live[k] = u < n_units;
      const uint32_t uu = live[k] ? u : 0;
      o[k] = chain::run_of(c, uu);
      p[k] = (uu - o[k] * c.units) * V;
      base_j[k] = live[k] ? c.base_j[o[k]] : 0;
      base_z[k] = live[k] && c.n_extras > 0 ? c.extra[0].base[o[k]] : 0;
    }
  };
  prepare(u0);
  const int4* table = static_cast<const int4*>(c.table);
  for (int k = threadIdx.x; k < c.table_bytes / 16; k += kThreads) {
    s_table[k] = table[k];
  }
  __syncthreads();
  const char* s = reinterpret_cast<const char*>(s_table);
  for (; u0 < n_units; u0 += step) {
    uint32_t dead[kUnits];  // bit l: level l masks the element
#pragma unroll
    for (int k = 0; k < kUnits; ++k) dead[k] = 0;
    for (int l = 0; l < c.n_levels; ++l) {
      const chain::RunLevel& lv = c.level[l];
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        if (!chain::passes(lv.outer_ok, lv.run_ok, s, o[k], p[k])) {
          dead[k] |= 1u << l;
        }
      }
    }
    // the source and the first extra band, read together
    P v[kUnits] = {}, z0[kUnits] = {};
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if (live[k] && dead[k] == 0) {
        v[k] = load<T, V>(x, static_cast<int64_t>(base_j[k]) +
                                 chain::off_at(s, c.off_j, p[k]));
      }
    }
    if (c.n_extras > 0) {
      const chain::RunExtra& ex = c.extra[0];
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        if (live[k] && chain::passes(ex.outer_ok, ex.run_ok, s, o[k], p[k])) {
          z0[k] = load<T, V>(ex.z, static_cast<int64_t>(base_z[k]) +
                                       chain::off_at(s, ex.off, p[k]));
        } else {
          z0[k] = splat<T, V>(ex.fill);
        }
      }
    }
    for (int l = 0; l < c.n_levels; ++l) {
      const chain::RunLevel& lv = c.level[l];
      // (dead >> l) > 1: a later level's fill overwrites this one
      if (lv.ew != chain::kNone) {
        P y[kUnits];
#pragma unroll
        for (int k = 0; k < kUnits; ++k) {
          if (live[k] && (dead[k] >> l) <= 1) {
            y[k] = load<T, V>(lv.y, static_cast<int64_t>(lv.base[o[k]]) +
                                        chain::off_at(s, lv.off, p[k]));
          }
        }
#pragma unroll
        for (int k = 0; k < kUnits; ++k) {
          if ((dead[k] >> l) > 1) continue;
          if ((dead[k] >> l) == 1) v[k] = splat<T, V>(lv.fill);
          v[k] = apply<T, V>(lv.ew, v[k], y[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kUnits; ++k) {
          if ((dead[k] >> l) == 1) v[k] = splat<T, V>(lv.fill);
        }
      }
    }
    for (int e = 0; e < c.n_extras; ++e) {
      const chain::RunExtra& ex = c.extra[e];
      P z[kUnits];
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        if (e == 0) {
          z[k] = z0[k];
        } else if (live[k] &&
                   chain::passes(ex.outer_ok, ex.run_ok, s, o[k], p[k])) {
          z[k] = load<T, V>(ex.z, static_cast<int64_t>(ex.base[o[k]]) +
                                      chain::off_at(s, ex.off, p[k]));
        } else {
          z[k] = splat<T, V>(ex.fill);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnits; ++k) v[k] = apply<T, V>(chain::kAdd, v[k], z[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if (live[k]) {
        reinterpret_cast<P*>(out)[u0 + k * kThreads] = v[k];
      }
    }
    prepare(u0 + step);
  }
}

template <typename T, int V>
int launch_vec(const void* x, void* out, const chain::Runs& c, int64_t numel,
               cudaStream_t stream) {
  const int64_t units = numel / V;
  const size_t smem = static_cast<size_t>(c.table_bytes);
  // a run table past the 48 KB a block gets without asking
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        run_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // blocks in flight: 8 an SM, fewer where the tables fill shared memory;
  // the loop strides over the rest
  const int64_t per_sm = smem == 0 ? 8 : 200 * 1024 / static_cast<int64_t>(smem);
  const int64_t cap = 132 * (per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm));
  const int64_t chunk = static_cast<int64_t>(kThreads) * units_of<V>();
  const int64_t blocks = (units + chunk - 1) / chunk;
  run_kernel<T, V><<<static_cast<unsigned>(blocks < cap ? blocks : cap),
                     kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c,
      static_cast<uint32_t>(units));
  return 0;
}

// accesses of one element, or of 16 bytes
template <typename T>
int launch_typed(const void* x, void* out, const chain::Runs& c,
                 int64_t numel, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (c.vec == 1) return launch_vec<T, 1>(x, out, c, numel, stream);
  if (c.vec == kVec && numel % kVec == 0) {
    return launch_vec<T, kVec>(x, out, c, numel, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int tm_chain(const void* x, void* out, const int64_t* desc,
                        int dtype, int64_t numel, int n_levels, int n_extras,
                        void* stream) {
  chain::Runs c;
  if (numel <= 0 || numel >= (int64_t{1} << 31) ||
      !chain::parse_runs(desc, n_levels, n_extras, &c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (dtype) {
    case chain::kInt8: rc = launch_typed<int8_t>(x, out, c, numel, s); break;
    case chain::kInt32: rc = launch_typed<int32_t>(x, out, c, numel, s); break;
    case chain::kBf16: rc = launch_typed<__nv_bfloat16>(x, out, c, numel, s); break;
    case chain::kF32: rc = launch_typed<float>(x, out, c, numel, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
