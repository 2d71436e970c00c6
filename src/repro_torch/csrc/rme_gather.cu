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
// (4 bytes of index per element read, 1 of mask).  At the detect tail's
// size (2352 rows of 85, capacity 256) that is well under a microsecond
// of bytes: the kernel is bound by its chain of dependent trips to memory.
//
// Design against that chain: the Pallas kernels sort (a stable argsort of
// the inverted mask).  Here each record stream is walked in rounds of
// kRound rows, each thread owning kRows consecutive rows of a round, with
// all of its predicate loads issued before any is used (for the chained
// evaluate, every ok and idx of its scores in one trip, then every slab
// read in the next; a score that ok masks takes the fill and skips its
// slab read).  One block-wide exclusive scan of the per-thread counts (a
// warp scan, then a scan of the warp totals) gives each survivor its slot
// in the order of argsort(stable=True), and the round's survivors' rows go
// to a slot list in shared memory.  Their rows (the first capacity
// survivors) are then copied element by element, coalesced, each thread
// issuing kCopy loads (for the chained evaluate, every idx and ok first,
// then the slab) before any store.  The walk stops after the round in which
// the count reaches capacity, so a long stream stops early, once per round.
// Slots past the count are zero-filled and their source index is N.
//
// The copy is the bulk of the bytes, so it is spread over the stream's
// blocks (a grid of B x split: one block per 8 slots, at most 16), each
// copying the slots congruent to its index.  Every block of a stream runs
// the same scan (the scores are in L2 after the first) and keeps its own
// slot list: a cluster of the stream's blocks reading block 0's list
// through distributed shared memory measured slower on every shape timed
// (PERF.md, which also times caps of 4, 8 and 32 blocks a stream).
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
constexpr int kRows = 8;                  // rows a thread scans a round
constexpr int kRound = kThreads * kRows;  // rows a round
constexpr int kCopy = 8;                  // loads a thread issues per step
constexpr int kMaxSplit = 16;             // blocks a stream's copy, at most

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
// where a stream's records come from: K elements at flat (B, N, D) offsets
// e[k] (where live[k]), every load issued before any is used
// ---------------------------------------------------------------------------

// (B, N, D) records, contiguous
template <typename T>
struct Direct {
  using Elem = T;
  const T* x;
  template <int K>
  __device__ __forceinline__ void gather(const int64_t (&e)[K],
                                         const bool (&live)[K],
                                         T (&v)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (live[k]) v[k] = x[e[k]];
    }
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
  template <int K>
  __device__ __forceinline__ void gather(const int64_t (&e)[K],
                                         const bool (&live)[K],
                                         T (&v)[K]) const {
    int32_t j[K];
    bool in[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {  // one trip: every ok and idx
      in[k] = live[k] && (ok == nullptr || ok[e[k]] != 0);
      j[k] = live[k] ? idx[e[k]] : 0;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {  // the next: every slab read
      if (live[k]) v[k] = in[k] ? slab[j[k]] : fill;
    }
  }
};

// ---------------------------------------------------------------------------
// which records survive: rows r0 .. r0 + kRows - 1 of stream b (those
// below n)
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
  __device__ __forceinline__ unsigned keep(const Src& src, int64_t b,
                                           int64_t r0, int64_t n,
                                           int64_t d) const {
    using T = typename Src::Elem;
    int64_t e[kRows];
    bool live[kRows];
    T s[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      live[k] = r0 + k < n;
      e[k] = (b * n + r0 + k) * d + score_index;
    }
    src.gather(e, live, s);
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      bool keep;
      if constexpr (std::is_integral<T>::value) {
        keep = int_mode ? compare<int64_t>(static_cast<int64_t>(s[k]), thr_i,
                                           cmp)
                        : compare<float>(to_float(s[k]), thr, cmp);
      } else {
        keep = compare<float>(to_float(s[k]), thr, cmp);
      }
      bits |= (live[k] && keep) ? 1u << k : 0u;
    }
    return bits;
  }
};

// a (B, N) runtime mask of int32 (mask_bytes 4) or bool (1); != 0 keeps
struct Mask {
  const void* mask;
  int mask_bytes;
  template <typename Src>
  __device__ __forceinline__ unsigned keep(const Src&, int64_t b, int64_t r0,
                                           int64_t n, int64_t) const {
    int32_t m[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t e = b * n + r0 + k;
      m[k] = 0;
      if (r0 + k < n) {
        m[k] = mask_bytes == 4 ? static_cast<const int32_t*>(mask)[e]
                               : static_cast<const uint8_t*>(mask)[e];
      }
    }
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) bits |= m[k] != 0 ? 1u << k : 0u;
    return bits;
  }
};

// ---------------------------------------------------------------------------
// the compaction
// ---------------------------------------------------------------------------

// Copy packed slots [lo, hi) that belong to this block (slot % split ==
// rank): element e of the block's share is slot lo + k0 + (e / d) split,
// column e % d, its row rows[slot - lo]; or zeros (Zero).  kCopy loads in
// flight per thread, then the stores.  Slots and columns are 32-bit (the
// capacity is below 2^31), addresses 64-bit.
template <typename Src, bool Zero>
__device__ __forceinline__ void copy_slots(const Src& src, int64_t b,
                                           int64_t n, uint32_t d,
                                           typename Src::Elem* __restrict__ ob,
                                           const int32_t* rows, uint32_t lo,
                                           uint32_t hi, uint32_t split,
                                           uint32_t rank) {
  using T = typename Src::Elem;
  const uint32_t k0 = (rank + split - lo % split) % split;
  if (lo + k0 >= hi || d == 0) return;
  const uint32_t mine = (hi - lo - k0 + split - 1) / split;
  const int64_t total = static_cast<int64_t>(mine) * d;
  // element e = threadIdx.x + u kThreads as (slot j, column c), stepped on
  const uint32_t sj = kThreads / d, sc = kThreads % d;
  uint32_t j = threadIdx.x / d, c = threadIdx.x % d;
  for (int64_t e0 = threadIdx.x; e0 < total; e0 += kThreads * kCopy) {
    int64_t from[kCopy], to[kCopy];
    bool live[kCopy];
    T v[kCopy];
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      live[u] = e0 + u * kThreads < total;
      const uint32_t slot = k0 + j * split;  // relative to lo
      to[u] = static_cast<int64_t>(lo + slot) * d + c;
      from[u] = 0;
      if constexpr (!Zero) {
        if (live[u]) from[u] = (b * n + rows[slot]) * d + c;
      }
      j += sj;
      c += sc;
      if (c >= d) {
        c -= d;
        ++j;
      }
    }
    if constexpr (Zero) {
#pragma unroll
      for (int u = 0; u < kCopy; ++u) v[u] = zero_value<T>();
    } else {
      src.gather(from, live, v);
    }
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      if (live[u]) ob[to[u]] = v[u];
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
  __shared__ int32_t s_total;
  __shared__ int32_t s_slot[kRound];  // rows of a round's survivors, in order
  const int64_t b = blockIdx.x;
  const int rank = blockIdx.y;
  const int split = gridDim.y;
  const bool writer = rank == 0;  // writes indices, count, padding ids
  typename Src::Elem* ob = out + b * capacity * d;
  int32_t* ib = idx == nullptr ? nullptr : idx + b * capacity;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int64_t running = 0;  // survivors so far (uniform across the stream)
  for (int64_t r0 = 0; r0 < n && running < capacity; r0 += kRound) {
    const int64_t rt = r0 + static_cast<int64_t>(threadIdx.x) * kRows;
    const unsigned bits = pred.keep(src, b, rt, n, d);
    const int mine = __popc(bits);
    // block-wide exclusive scan of the per-thread counts
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += up;
      }
      if (lane < kWarps) s_warp[lane] = v;  // inclusive warp totals
      if (lane == kWarps - 1) s_total = v;
    }
    __syncthreads();
    int at = (warp == 0 ? 0 : s_warp[warp - 1]) + incl - mine;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if ((bits >> k) & 1u) {
        const int32_t r = static_cast<int32_t>(rt + k);
        s_slot[at] = r;
        if (writer && ib != nullptr && running + at < capacity) {
          ib[running + at] = r;
        }
        ++at;
      }
    }
    __syncthreads();
    const int total = s_total;
    const int64_t room = capacity - running;
    copy_slots<Src, false>(
        src, b, n, static_cast<uint32_t>(d), ob, s_slot,
        static_cast<uint32_t>(running),
        static_cast<uint32_t>(running + (total < room ? total : room)), split,
        rank);
    running += total;
    __syncthreads();  // s_warp / s_slot / s_total are reused
  }
  const int64_t count = running < capacity ? running : capacity;
  copy_slots<Src, true>(src, b, n, static_cast<uint32_t>(d), ob, nullptr,
                        static_cast<uint32_t>(count),
                        static_cast<uint32_t>(capacity), split, rank);
  if (writer) {
    if (ib != nullptr) {
      for (int64_t s = count + threadIdx.x; s < capacity; s += kThreads) {
        ib[s] = static_cast<int32_t>(n);
      }
    }
    if (threadIdx.x == 0) cnt[b] = static_cast<int32_t>(count);
  }
}

// the blocks a stream's copy is spread over: one per 8 slots, at most
// kMaxSplit
inline unsigned split_of(int64_t capacity) {
  const int64_t split = (capacity + 7) / 8;
  return static_cast<unsigned>(
      split < 1 ? 1 : (split > kMaxSplit ? kMaxSplit : split));
}

template <typename Src, typename Pred>
int launch(const Src& src, const Pred& pred, void* out, void* idx, void* cnt,
           int64_t batch, int64_t n, int64_t d, int64_t capacity,
           cudaStream_t stream) {
  using T = typename Src::Elem;
  // rows, slots and the count are int32; a column is 32-bit
  if (n < 0 || n > INT32_MAX || capacity < 0 || capacity > INT32_MAX ||
      d < 0 || d > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  T* o = static_cast<T*>(out);
  int32_t* i = static_cast<int32_t*>(idx);
  int32_t* c = static_cast<int32_t*>(cnt);
  const dim3 grid(static_cast<unsigned>(batch), split_of(capacity));
  compact_kernel<Src, Pred><<<grid, kThreads, 0, stream>>>(
      src, pred, o, i, c, n, d, capacity);
  return 0;
}

template <typename T>
struct Tag {
  using type = T;
};

// call f(Tag<T>{}) for the element type named by dtype; f returns the
// launch's error code
template <typename F>
int by_dtype(int dtype, int64_t batch, F f) {
  if (batch <= 0 || batch > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc;
  switch (dtype) {
    case kInt8: rc = f(Tag<int8_t>{}); break;
    case kInt32: rc = f(Tag<int32_t>{}); break;
    case kBf16: rc = f(Tag<__nv_bfloat16>{}); break;
    case kF32: rc = f(Tag<float>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
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
    const Direct<T> src{static_cast<const T*>(x)};
    return launch(src, pred, out, idx, cnt, batch, n, d, capacity, s);
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
                        static_cast<const uint8_t*>(ok), fill};
    return launch(src, pred, out, idx, cnt, batch, n, d, capacity, s);
  });
}

extern "C" int rme_assemble(const void* x, const void* mask, int mask_bytes,
                            void* out, void* cnt, int dtype, int64_t batch,
                            int64_t n, int64_t d, int64_t capacity,
                            void* stream) {
  if (mask_bytes != 1 && mask_bytes != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask pred{mask, mask_bytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, batch, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const Direct<T> src{static_cast<const T*>(x)};
    return launch(src, pred, out, nullptr, cnt, batch, n, d, capacity, s);
  });
}
