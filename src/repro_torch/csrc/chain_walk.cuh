// The forwarding chain's walk over a whole output, shared by the
// cross-engine kernels: the commit (xchain_commit.cu) walks it after its
// product, over the product's scratch; the prologue (xchain_prologue.cu)
// walks it before its product, into the scratch the product reads.
//
// Element i of the output is chain_desc.cuh's walk of element i, with the
// same arithmetic in the same order (a Route band is summed as
// v + (mask ? z : fill), so -0.0 + 0.0 gives +0.0, as in the JAX package).
// What this file adds is the order of the loads: a thread takes kChainStep
// elements a step, nthreads apart, so that each load of a warp covers 32
// consecutive outputs (j, masks and indices coalesced), and issues the
// step's loads in two rounds instead of one round trip per element and
// array: first j, every level's mask and the first extra band's index and
// mask; then the source reads and the first band's reads, a read that a
// mask discards skipped.  Epilogue operands and further bands follow in
// one round each.  A chain with no mask, epilogue or extra band (a pure
// gather, as ESPCN's PixelShuffle) reads j and the source only.
//
// The source is read through L2 (ld.global.cg): the commit's source was
// written by other SMs in the same launch.  __noinline__: one copy per
// element type, however many tile shapes the kernel instantiates (the
// commit's build took 72 s with the walk inlined in each, 38-56 s
// without).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "chain_desc.cuh"

namespace chain {

constexpr int kChainStep = 8;  // elements a thread per step

// *p read at L2
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  if constexpr (sizeof(T) == 4) {
    const unsigned int u = __ldcg(reinterpret_cast<const unsigned int*>(p));
    T v;
    memcpy(&v, &u, 4);
    return v;
  } else if constexpr (sizeof(T) == 2) {
    const unsigned short u =
        __ldcg(reinterpret_cast<const unsigned short*>(p));
    T v;
    memcpy(&v, &u, 2);
    return v;
  } else {
    const signed char u = __ldcg(reinterpret_cast<const signed char*>(p));
    T v;
    memcpy(&v, &u, 1);
    return v;
  }
}

// The chain c over src into out (numel elements), by every thread of the
// grid.
template <typename T>
__device__ __noinline__ void walk(const Chain& c, const T* __restrict__ src,
                                  T* __restrict__ out, int64_t numel) {
  constexpr int S = kChainStep;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  // the table's fields in registers: the stores to out do not make the
  // compiler read them again
  const int32_t* __restrict__ j = c.j;
  const int n_levels = c.n_levels, n_extras = c.n_extras;
  bool gather = n_extras == 0;
  for (int l = 0; l < n_levels; ++l) {
    gather = gather && c.level[l].mask == nullptr &&
             c.level[l].ew == kNone;
  }
  if (gather) {
    for (int64_t i0 = first; i0 < numel; i0 += nthreads * S) {
      int jv[S];
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int64_t i = i0 + u * nthreads;
        jv[u] = i < numel ? j[i] : 0;
      }
      T v[S];
#pragma unroll
      for (int u = 0; u < S; ++u) v[u] = load_cg(src + jv[u]);
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int64_t i = i0 + u * nthreads;
        if (i < numel) out[i] = v[u];
      }
    }
    return;
  }
  // the first extra band, loaded beside j
  const bool has0 = n_extras > 0;
  const int32_t* __restrict__ idx0 = has0 ? c.extra[0].idx : nullptr;
  const uint8_t* __restrict__ mask0 = has0 ? c.extra[0].mask : nullptr;
  const T* __restrict__ z0 = has0 ? static_cast<const T*>(c.extra[0].z)
                                  : nullptr;
  const T fill0 = from_bits<T>(has0 ? c.extra[0].fill : 0);
  for (int64_t i0 = first; i0 < numel; i0 += nthreads * S) {
    // round 1: j, the levels' masks (bit l of drop: level l masks the
    // element out) and the first band's index and mask
    int jv[S], iv[S];
    uint32_t drop[S];
    bool in[S], band[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int64_t i = i0 + u * nthreads;
      in[u] = i < numel;
      jv[u] = in[u] ? j[i] : 0;
      drop[u] = 0;
      iv[u] = in[u] && has0 ? idx0[i] : 0;
      band[u] = in[u] && has0 && (mask0 == nullptr || mask0[i] != 0);
    }
    for (int l = 0; l < n_levels; ++l) {
      const uint8_t* __restrict__ mask = c.level[l].mask;
      if (mask == nullptr) continue;
#pragma unroll
      for (int u = 0; u < S; ++u) {
        if (in[u] && mask[i0 + u * nthreads] == 0) drop[u] |= 1u << l;
      }
    }
    // round 2: the source (where no level masks the element out) and the
    // first band (where its mask keeps it)
    T v[S], z[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      v[u] = in[u] && drop[u] == 0 ? load_cg(src + jv[u]) : from_bits<T>(0);
      z[u] = band[u] ? z0[iv[u]] : fill0;
    }
    // the levels in order: the mask's fill, then the epilogue
    for (int l = 0; l < n_levels; ++l) {
      const Level& lv = c.level[l];
      if (lv.mask != nullptr) {
        const T fill = from_bits<T>(lv.fill);
#pragma unroll
        for (int u = 0; u < S; ++u) {
          if ((drop[u] >> l) & 1u) v[u] = fill;
        }
      }
      if (lv.ew != kNone) {
        const int ew = static_cast<int>(lv.ew);
        const int32_t* __restrict__ p = lv.p;
        const T* __restrict__ ys = static_cast<const T*>(lv.y);
        int pv[S];
#pragma unroll
        for (int u = 0; u < S; ++u) pv[u] = in[u] ? p[i0 + u * nthreads] : 0;
        T yv[S];
#pragma unroll
        for (int u = 0; u < S; ++u) yv[u] = ys[pv[u]];
#pragma unroll
        for (int u = 0; u < S; ++u) v[u] = apply_ew<T>(ew, v[u], yv[u]);
      }
    }
    // the bands in order: the first from round 2, the rest a round each
    if (has0) {
#pragma unroll
      for (int u = 0; u < S; ++u) v[u] = apply_ew<T>(kAdd, v[u], z[u]);
    }
    for (int e = 1; e < n_extras; ++e) {
      const Extra& ex = c.extra[e];
      const int32_t* __restrict__ idx = ex.idx;
      const uint8_t* __restrict__ mask = ex.mask;
      const T* __restrict__ zs = static_cast<const T*>(ex.z);
      const T fill = from_bits<T>(ex.fill);
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int64_t i = i0 + u * nthreads;
        iv[u] = in[u] ? idx[i] : 0;
        band[u] = in[u] && (mask == nullptr || mask[i] != 0);
      }
#pragma unroll
      for (int u = 0; u < S; ++u) z[u] = band[u] ? zs[iv[u]] : fill;
#pragma unroll
      for (int u = 0; u < S; ++u) v[u] = apply_ew<T>(kAdd, v[u], z[u]);
    }
#pragma unroll
    for (int u = 0; u < S; ++u) {
      if (in[u]) out[i0 + u * nthreads] = v[u];
    }
  }
}

}  // namespace chain
