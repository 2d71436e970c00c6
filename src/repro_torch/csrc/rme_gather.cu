// RME compaction kernels for Hopper (sm_90a): stable compaction of record
// streams under a threshold test (evaluate, Bboxcal) or a runtime mask
// (assemble).
//
// Replaces the JAX package's Pallas kernels in
// src/repro/kernels/rme_gather/rme_gather.py:
//   * rme_evaluate <- evaluate / _evaluate_kernel (one stream) and
//     evaluate_batched / _evaluate_batched_kernel (one stream per grid step);
//   * rme_evaluate_chained <- evaluate_chained / _evaluate_chain_kernel (the
//     record stream gathered from a chain input through a coarse pullback:
//     element e is slab[idx[e]], or fill where ok[e] is false);
//   * rme_assemble <- assemble / _assemble_kernel and assemble_batched /
//     _assemble_batched_kernel (the mask is an input, no indices are
//     written).
// One launch serves each family: the grid has one block row per record
// stream, and an unbatched call is a batch of one.
//
// Bound on an H100: bytes over HBM bandwidth (3.35 TB/s) — the predicate
// input up to the point the commit buffer is full (for evaluate one 32-byte
// sector per row, as the scores sit a record apart; for assemble the mask),
// the surviving rows, and the packed output (capacity rows, their source
// indices and the count).  The chained evaluate also reads its pullback
// (4 bytes of index per element read, 1 of mask).
//
// Design against that bound: the Pallas kernels sort (a stable argsort of
// the inverted mask).  Here each record stream is walked in tiles of
// blockDim rows: the predicate is tested (at the promoted dtype for
// evaluate, != 0 for assemble), a block-wide exclusive prefix sum of the
// mask (warp ballots, then a scan of the per-warp counts) gives every
// survivor its packed slot in the same stable order as argsort(stable=True),
// and the tile's survivors are copied row by row, coalesced.  The walk stops
// as soon as the commit buffer is full, so rows past the last kept survivor
// are never read.  Slots past the count are zero-filled and their source
// index is N.  The copy is the bulk of the bytes, so it is spread over up
// to 16 blocks per stream (a grid of B x split): every block of a stream
// runs the same cheap scan of the predicate and copies only the slots
// congruent to its index, with several rows' loads in flight per thread.
// The chained evaluate applies the fill before the threshold test, so the
// predicate sees the value the unchained producer would have stored.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

enum Dtype { kInt8 = 0, kInt32 = 1, kBf16 = 2, kF32 = 3 };
enum Cmp { kGe = 0, kGt = 1, kLe = 2, kLt = 3 };

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(v);
  } else {
    return static_cast<float>(v);  // int32 -> f32 rounds to nearest
  }
}

template <typename T>
__device__ __forceinline__ T zero_value() {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(0.0f);
  } else {
    return static_cast<T>(0);
  }
}

template <typename V>
__device__ __forceinline__ bool compare(V a, V b, int cmp) {
  switch (cmp) {
    case kGe: return a >= b;
    case kGt: return a > b;
    case kLe: return a <= b;
    default: return a < b;
  }
}

// ---------------------------------------------------------------------------
// where a stream's records come from
// ---------------------------------------------------------------------------

// (B, N, D) records, contiguous
template <typename T>
struct Direct {
  using Elem = T;
  const T* x;
  int64_t n, d;
  __device__ __forceinline__ T at(int64_t b, int64_t r, int64_t c) const {
    return x[(b * n + r) * d + c];
  }
};

// (B, N, D) records pulled back into a flat chain input: element e reads
// slab[idx[e]], or fill where ok (may be null: never out of bounds) is 0
template <typename T>
struct Pulled {
  using Elem = T;
  const T* slab;
  const int32_t* idx;
  const uint8_t* ok;
  T fill;
  int64_t n, d;
  __device__ __forceinline__ T at(int64_t b, int64_t r, int64_t c) const {
    const int64_t e = (b * n + r) * d + c;
    if (ok != nullptr && ok[e] == 0) return fill;
    return slab[idx[e]];
  }
};

// ---------------------------------------------------------------------------
// which records survive
// ---------------------------------------------------------------------------

// int_mode: the promoted dtype is the records' integer dtype (an integer
// threshold), compared as int64; otherwise the promoted dtype is f32 or
// bf16 and the threshold arrives already rounded to it, so an f32 compare
// is exact for both.
struct Threshold {
  int64_t score_index;
  int cmp;
  int int_mode;
  float thr;
  int64_t thr_i;
  template <typename Src>
  __device__ __forceinline__ bool operator()(const Src& src, int64_t b,
                                             int64_t r) const {
    using T = typename Src::Elem;
    const T s = src.at(b, r, score_index);
    if constexpr (std::is_integral<T>::value) {
      if (int_mode) return compare<int64_t>(static_cast<int64_t>(s), thr_i, cmp);
    }
    return compare<float>(to_float(s), thr, cmp);
  }
};

// a (B, N) runtime mask of int32 (mask_bytes 4) or bool (1); != 0 keeps
struct Mask {
  const void* mask;
  int mask_bytes;
  int64_t n;
  template <typename Src>
  __device__ __forceinline__ bool operator()(const Src&, int64_t b,
                                             int64_t r) const {
    const int64_t e = b * n + r;
    if (mask_bytes == 4) return static_cast<const int32_t*>(mask)[e] != 0;
    return static_cast<const uint8_t*>(mask)[e] != 0;
  }
};

// ---------------------------------------------------------------------------
// the compaction
// ---------------------------------------------------------------------------

// Copy packed slots [lo, hi) that belong to this block (slot % split ==
// blockIdx.y): element e of the block's share is row lo + k0 + (e / d) *
// split, column e % d.  The source row of slot lo + k is rows[k] (or zero).
template <typename Src, bool Zero>
__device__ __forceinline__ void copy_slots(const Src& src, int64_t b,
                                           typename Src::Elem* __restrict__ ob,
                                           const int64_t* rows, int64_t lo,
                                           int64_t hi, int64_t d) {
  using T = typename Src::Elem;
  const int64_t split = gridDim.y;
  const int64_t k0 = (static_cast<int64_t>(blockIdx.y) - lo % split + split) % split;
  if (lo + k0 >= hi) return;
  const int64_t mine = (hi - lo - k0 + split - 1) / split;
  const int64_t total = mine * d;
  for (int64_t e0 = threadIdx.x; e0 < total; e0 += kThreads * kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = e0 + u * kThreads;
      if (e < total) {
        const int64_t j = e / d;
        const int64_t k = k0 + j * split;
        if constexpr (Zero) {
          v[u] = zero_value<T>();
        } else {
          v[u] = src.at(b, rows[k], e - j * d);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = e0 + u * kThreads;
      if (e < total) {
        const int64_t j = e / d;
        ob[(lo + k0 + j * split) * d + (e - j * d)] = v[u];
      }
    }
  }
}

// idx may be null (assemble writes no source indices)
template <typename Src, typename Pred>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const Src src, const Pred pred,
               typename Src::Elem* __restrict__ out, int32_t* __restrict__ idx,
               int32_t* __restrict__ cnt, int64_t n, int64_t d,
               int64_t capacity) {
  __shared__ int32_t s_warp[kWarps];
  __shared__ int64_t s_src[kThreads];
  const int64_t b = blockIdx.x;
  const bool writer = blockIdx.y == 0;  // writes indices, count, padding ids
  typename Src::Elem* ob = out + b * capacity * d;
  int32_t* ib = idx == nullptr ? nullptr : idx + b * capacity;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int64_t running = 0;  // survivors so far (uniform across the block)
  for (int64_t t0 = 0; t0 < n && running < capacity; t0 += kThreads) {
    const int64_t r = t0 + threadIdx.x;
    const bool keep = r < n && pred(src, b, r);
    // block-wide exclusive prefix sum of the mask
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    const int in_warp = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      int v = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += up;
      }
      if (lane < kWarps) s_warp[lane] = v;  // inclusive per-warp totals
    }
    __syncthreads();
    const int before = (warp == 0 ? 0 : s_warp[warp - 1]) + in_warp;
    const int tile_total = s_warp[kWarps - 1];
    if (keep && running + before < capacity) {
      s_src[before] = r;
      if (writer && ib != nullptr) {
        ib[running + before] = static_cast<int32_t>(r);
      }
    }
    __syncthreads();
    const int64_t room = capacity - running;
    const int64_t n_copy = tile_total < room ? tile_total : room;
    copy_slots<Src, false>(src, b, ob, s_src, running, running + n_copy, d);
    running += tile_total;
    __syncthreads();  // s_warp / s_src are reused by the next tile
  }
  const int64_t count = running < capacity ? running : capacity;
  copy_slots<Src, true>(src, b, ob, nullptr, count, capacity, d);
  if (writer) {
    if (ib != nullptr) {
      for (int64_t s = count + threadIdx.x; s < capacity; s += kThreads) {
        ib[s] = static_cast<int32_t>(n);
      }
    }
    if (threadIdx.x == 0) cnt[b] = static_cast<int32_t>(count);
  }
}

template <typename Src, typename Pred>
void launch(const Src& src, const Pred& pred, void* out, void* idx, void* cnt,
            int64_t batch, int64_t n, int64_t d, int64_t capacity,
            cudaStream_t stream) {
  // up to 16 blocks per stream share the copy; more than one block per 16
  // slots would leave blocks idle
  int64_t split = (capacity + 15) / 16;
  split = split < 1 ? 1 : (split > 16 ? 16 : split);
  const dim3 grid(static_cast<unsigned>(batch), static_cast<unsigned>(split));
  compact_kernel<Src, Pred><<<grid, kThreads, 0, stream>>>(
      src, pred, static_cast<typename Src::Elem*>(out),
      static_cast<int32_t*>(idx), static_cast<int32_t*>(cnt), n, d, capacity);
}

template <typename T>
struct Tag {
  using type = T;
};

// call f(Tag<T>{}) for the element type named by dtype
template <typename F>
int by_dtype(int dtype, int64_t batch, F f) {
  if (batch <= 0 || batch > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case kInt8: f(Tag<int8_t>{}); break;
    case kInt32: f(Tag<int32_t>{}); break;
    case kBf16: f(Tag<__nv_bfloat16>{}); break;
    case kF32: f(Tag<float>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rme_evaluate(const void* x, void* out, void* idx, void* cnt,
                            int dtype, int64_t batch, int64_t n, int64_t d,
                            int64_t capacity, int64_t score_index, int cmp,
                            int int_mode, double thr_f, int64_t thr_i,
                            void* stream) {
  const Threshold pred{score_index, cmp, int_mode, static_cast<float>(thr_f),
                       thr_i};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, batch, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const Direct<T> src{static_cast<const T*>(x), n, d};
    launch(src, pred, out, idx, cnt, batch, n, d, capacity, s);
  });
}

extern "C" int rme_evaluate_chained(const void* slab, const void* pull,
                                    const void* ok, int64_t fill_bits,
                                    void* out, void* idx, void* cnt,
                                    int dtype, int64_t batch, int64_t n,
                                    int64_t d, int64_t capacity,
                                    int64_t score_index, int cmp, int int_mode,
                                    double thr_f, int64_t thr_i,
                                    void* stream) {
  const Threshold pred{score_index, cmp, int_mode, static_cast<float>(thr_f),
                       thr_i};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, batch, [&](auto tag) {
    using T = typename decltype(tag)::type;
    T fill;
    memcpy(&fill, &fill_bits, sizeof(T));  // the low bytes hold the value
    const Pulled<T> src{static_cast<const T*>(slab),
                        static_cast<const int32_t*>(pull),
                        static_cast<const uint8_t*>(ok), fill, n, d};
    launch(src, pred, out, idx, cnt, batch, n, d, capacity, s);
  });
}

extern "C" int rme_assemble(const void* x, const void* mask, int mask_bytes,
                            void* out, void* cnt, int dtype, int64_t batch,
                            int64_t n, int64_t d, int64_t capacity,
                            void* stream) {
  if (mask_bytes != 1 && mask_bytes != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask pred{mask, mask_bytes, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, batch, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const Direct<T> src{static_cast<const T*>(x), n, d};
    launch(src, pred, out, nullptr, cnt, batch, n, d, capacity, s);
  });
}
