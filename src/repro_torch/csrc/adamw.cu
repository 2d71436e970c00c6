// Fused AdamW for Hopper (sm_90a): the clip norm's sums of squares and the
// update, each one pass over a table of leaves.
//
// Replaces no Pallas kernel: the JAX package's AdamW (src/repro/optim/
// adamw.py, adamw_update and global_norm) is jnp, which XLA fuses.  The
// port's plain version (repro_torch/optim/adamw.py, adamw_update_plain)
// runs about 15 eager elementwise kernels over every slice of every leaf and
// the norm three more, each reading and writing whole f32 slices: about 158
// bytes a parameter.
//
// Bound on an H100: bytes.  The update needs, a parameter, the gradient read
// twice (2 or 4 bytes each: once for the norm, once for the update), the f32
// master, m and v each read and written once (24 bytes) and the parameter
// written once in its dtype (2 or 4 bytes): 30 bytes at bf16, over 3.35 TB/s.
// A few operations an element are far below the card's FLOP rate.
//
// Design: streaming, as a memory-bound pass wants.
//
//  * The C entry point packs its leaves (pointers, element counts, dtypes)
//    from host arrays into a table of at most kMaxLeaves leaves, passed by
//    value as a __grid_constant__ argument: no host-to-device copy and no
//    synchronisation.  The caller splits a longer tree into several tables.
//  * A leaf is cut into tiles; a persistent grid of kBlocksPerSm blocks an SM
//    walks the table's tiles in order, each block tile after tile, finding
//    each tile's leaf by a cursor that only moves forward.  Two blocks of 256
//    threads an SM keep 57 KB of loads in flight there, past what HBM's
//    latency needs.
//  * A thread reads 8 elements at once: 16-byte loads and stores (bf16: one,
//    f32: two) where every pointer of the leaf is 16-byte aligned, a scalar
//    path for a tile's tail and for misaligned views.  Offsets are 64-bit.
//    Loads and stores carry the evict-first hint (ld/st.global.cs): none of
//    the bytes is read again in the pass.
//
// adamw_sumsq: each leaf's sum of squares of its gradient (bf16 or f32), in
// f32.  sumsq_partial_kernel writes one partial sum a tile of kSumTile
// elements (each thread's 8 lane sums, then a shuffle tree, then the warps in
// order); sumsq_final_kernel, one block a leaf, sums a leaf's partials in a
// fixed order.  No atomics: two runs on the same inputs give the same bits.
//
// adamw_apply: for every element, the plain version's arithmetic in its
// order, each step rounded as the eager kernels round it on the card (their
// `a + alpha * b` is one fused multiply-add, addcmul's `a + alpha * (b * c)`
// one after the rounded product), so the two agree bit for bit; scale, c1,
// c2 and lr are read from 0-d device tensors:
//   g = grad * scale
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * (g * g)
//   u = (m / c1) / (sqrt(v / c2) + eps) + wd * w
//   w = w - lr * u
//   param = w, rounded to nearest even in bf16
// instantiated for gradient in {bf16, f32} x parameter in {bf16, f32}, the
// pair chosen a leaf.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;   // leaves a table holds (TABLE in adamw.py)
constexpr int kThreads = 256;
constexpr int kVec = 8;          // elements a thread reads at once
constexpr int64_t kApplyTile = kThreads * kVec;    // one vector a thread
constexpr int kSumIters = 8;
constexpr int64_t kSumTile = kApplyTile * kSumIters;  // SUM_TILE in adamw.py
constexpr int kBlocksPerSm = 2;  // 84.6% of HBM peak, 4: 81.5-83.0%
constexpr int kFinalThreads = 512;

enum KindBits { kGradBf16 = 1, kParamBf16 = 2 };

struct Leaf {
  const void* g;   // gradient, bf16 or f32
  float* w;        // f32 master weights
  float* m;
  float* v;
  void* p;         // the parameter written, bf16 or f32
  int64_t n;       // elements
  int64_t tile0;   // the leaf's first tile in the table
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int64_t n_tiles;
  int n_leaves;
  uint8_t kind[kMaxLeaves];     // KindBits
  uint8_t aligned[kMaxLeaves];  // every pointer of the leaf 16-byte aligned
};

struct Hyper {
  const float* scale;  // the clip scale, c1, c2 and lr: 0-d device tensors
  const float* c1;
  const float* c2;
  const float* lr;
  float b1, omb1, b2, omb2, eps, wd;  // omb1 = 1 - b1 rounded from double
};

// --- loads and stores ------------------------------------------------------

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[kVec]) {
  const int4 raw = __ldcs(reinterpret_cast<const int4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1,
         make_float4(x[4], x[5], x[6], x[7]));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[kVec]) {
  int4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  }
  __stcs(reinterpret_cast<int4*>(p), raw);
}

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// --- reductions ------------------------------------------------------------

// The block's sum of x, in thread 0: a shuffle tree in each warp, then the
// warps in order.  smem holds a float a warp.
template <int kBlock>
__device__ __forceinline__ float block_sum(float x, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (threadIdx.x % 32 == 0) smem[threadIdx.x / 32] = x;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) total += smem[w];
  }
  __syncthreads();  // smem is written again by the next tile
  return total;
}

// This thread's sum of squares over elements [a, b) of g, a tile of at most
// kSumTile elements.
template <typename G>
__device__ __forceinline__ float sumsq_tile(const G* g, int64_t a, int64_t b,
                                            bool vec) {
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
  int64_t rest_from = a;
  if (vec) {
    const int64_t nvec = (b - a) / kVec;
#pragma unroll
    for (int k = 0; k < kSumIters; ++k) {
      const int64_t j = threadIdx.x + k * kThreads;
      if (j < nvec) {
        float x[kVec];
        load8(g + a + j * kVec, x);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = __fmaf_rn(x[e], x[e], acc[e]);
      }
    }
    rest_from = a + nvec * kVec;
  }
  float rest = 0.0f;
  for (int64_t i = rest_from + threadIdx.x; i < b; i += kThreads) {
    const float x = load1(g + i);
    rest = __fmaf_rn(x, x, rest);
  }
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
         ((acc[4] + acc[5]) + (acc[6] + acc[7])) + rest;
}

// --- the update ------------------------------------------------------------

struct Step {
  float scale, c1, c2, lr;
};

__device__ __forceinline__ void adamw(float graw, float& w, float& m, float& v,
                                      const Hyper& h, const Step& s) {
  const float g = __fmul_rn(graw, s.scale);
  m = __fmaf_rn(h.omb1, g, __fmul_rn(m, h.b1));
  v = __fmaf_rn(h.omb2, __fmul_rn(g, g), __fmul_rn(v, h.b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), h.eps);
  const float u = __fmaf_rn(h.wd, w, __fdiv_rn(__fdiv_rn(m, s.c1), denom));
  w = __fsub_rn(w, __fmul_rn(u, s.lr));
}

// Elements [a, b) of leaf L, a tile of at most kApplyTile elements.
template <typename G, typename P>
__device__ __forceinline__ void apply_tile(const Leaf& L, int64_t a, int64_t b,
                                           bool vec, const Hyper& h,
                                           const Step& s) {
  const G* g = static_cast<const G*>(L.g);
  P* p = static_cast<P*>(L.p);
  int64_t rest_from = a;
  if (vec) {
    const int64_t nvec = (b - a) / kVec;
    if (threadIdx.x < nvec) {
      const int64_t i = a + static_cast<int64_t>(threadIdx.x) * kVec;
      float gx[kVec], w[kVec], m[kVec], v[kVec];
      load8(g + i, gx);
      load8(L.w + i, w);
      load8(L.m + i, m);
      load8(L.v + i, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) adamw(gx[e], w[e], m[e], v[e], h, s);
      store8(L.m + i, m);
      store8(L.v + i, v);
      store8(L.w + i, w);
      store8(p + i, w);
    }
    rest_from = a + nvec * kVec;
  }
  for (int64_t i = rest_from + threadIdx.x; i < b; i += kThreads) {
    float w = L.w[i], m = L.m[i], v = L.v[i];
    adamw(load1(g + i), w, m, v, h, s);
    L.m[i] = m;
    L.v[i] = v;
    L.w[i] = w;
    store1(p + i, w);
  }
}

// --- kernels ---------------------------------------------------------------

// Moves the cursor li to the leaf that holds `tile` (leaves of no tile are
// stepped over).
__device__ __forceinline__ int leaf_of(const Table& tab, int li, int64_t tile) {
  while (li + 1 < tab.n_leaves && tile >= tab.leaf[li + 1].tile0) ++li;
  return li;
}

__global__ void __launch_bounds__(kThreads)
sumsq_partial_kernel(const __grid_constant__ Table tab,
                     float* __restrict__ partial) {
  __shared__ float smem[kThreads / 32];
  int li = 0;
  for (int64_t tile = blockIdx.x; tile < tab.n_tiles; tile += gridDim.x) {
    li = leaf_of(tab, li, tile);
    const Leaf& L = tab.leaf[li];
    const int64_t a = (tile - L.tile0) * kSumTile;
    const int64_t b = a + kSumTile < L.n ? a + kSumTile : L.n;
    const bool vec = tab.aligned[li];
    const float x =
        (tab.kind[li] & kGradBf16)
            ? sumsq_tile(static_cast<const __nv_bfloat16*>(L.g), a, b, vec)
            : sumsq_tile(static_cast<const float*>(L.g), a, b, vec);
    const float total = block_sum<kThreads>(x, smem);
    if (threadIdx.x == 0) partial[tile] = total;
  }
}

__global__ void __launch_bounds__(kFinalThreads)
sumsq_final_kernel(const __grid_constant__ Table tab,
                   const float* __restrict__ partial,
                   float* __restrict__ sums) {
  __shared__ float smem[kFinalThreads / 32];
  const int li = blockIdx.x;
  const int64_t t0 = tab.leaf[li].tile0;
  const int64_t t1 = li + 1 < tab.n_leaves ? tab.leaf[li + 1].tile0
                                           : tab.n_tiles;
  float acc = 0.0f;
  for (int64_t t = t0 + threadIdx.x; t < t1; t += kFinalThreads) {
    acc += partial[t];
  }
  const float total = block_sum<kFinalThreads>(acc, smem);
  if (threadIdx.x == 0) sums[li] = total;
}

__global__ void __launch_bounds__(kThreads)
apply_kernel(const __grid_constant__ Table tab, const __grid_constant__ Hyper h) {
  const Step s{*h.scale, *h.c1, *h.c2, *h.lr};
  int li = 0;
  for (int64_t tile = blockIdx.x; tile < tab.n_tiles; tile += gridDim.x) {
    li = leaf_of(tab, li, tile);
    const Leaf& L = tab.leaf[li];
    const int64_t a = (tile - L.tile0) * kApplyTile;
    const int64_t b = a + kApplyTile < L.n ? a + kApplyTile : L.n;
    const bool vec = tab.aligned[li];
    switch (tab.kind[li]) {
      case 0:
        apply_tile<float, float>(L, a, b, vec, h, s);
        break;
      case kGradBf16:
        apply_tile<__nv_bfloat16, float>(L, a, b, vec, h, s);
        break;
      case kParamBf16:
        apply_tile<float, __nv_bfloat16>(L, a, b, vec, h, s);
        break;
      default:
        apply_tile<__nv_bfloat16, __nv_bfloat16>(L, a, b, vec, h, s);
        break;
    }
  }
}

// --- host ------------------------------------------------------------------

// The table of leaves [0, n_leaves) with tiles of `tile` elements; w, m, v
// and p may be null (the sums of squares read only g).  False when the
// table cannot hold the leaves or an argument is out of range.
bool pack(Table& tab, int n_leaves, const uint64_t* g, const uint64_t* w,
          const uint64_t* m, const uint64_t* v, const uint64_t* p,
          const int64_t* n, const int* kind, int64_t tile) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return false;
  tab = Table{};
  int64_t tiles = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (n[i] < 0 || (kind[i] & ~(kGradBf16 | kParamBf16)) != 0) return false;
    Leaf& L = tab.leaf[i];
    L.g = reinterpret_cast<const void*>(g[i]);
    uint64_t bits = g[i];
    if (w != nullptr) {
      L.w = reinterpret_cast<float*>(w[i]);
      L.m = reinterpret_cast<float*>(m[i]);
      L.v = reinterpret_cast<float*>(v[i]);
      L.p = reinterpret_cast<void*>(p[i]);
      bits |= w[i] | m[i] | v[i] | p[i];
    }
    L.n = n[i];
    L.tile0 = tiles;
    tiles += (n[i] + tile - 1) / tile;
    tab.kind[i] = static_cast<uint8_t>(kind[i]);
    tab.aligned[i] = bits % 16 == 0;
  }
  tab.n_tiles = tiles;
  tab.n_leaves = n_leaves;
  return true;
}

// The persistent grid for `tiles` tiles on the current device.
int grid_for(int64_t tiles) {
  static int sms = 0;  // the same card for the process's life
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 0;
      return 0;
    }
  }
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
  return static_cast<int>(tiles < most ? tiles : most);
}

}  // namespace

// sums[i] = the sum of squares of leaf i's gradient g[i] (n[i] elements, bf16
// where kind[i] has bit 0, else f32), for the n_leaves <= 64 leaves of one
// table.  partial is f32 scratch of partial_cap >= the table's tiles of
// 16384 elements.
extern "C" int adamw_sumsq(const uint64_t* g, const int64_t* n,
                           const int* kind, int n_leaves, void* partial,
                           int64_t partial_cap, void* sums, void* stream) {
  Table tab;
  if (!pack(tab, n_leaves, g, nullptr, nullptr, nullptr, nullptr, n, kind,
            kSumTile) ||
      tab.n_tiles > partial_cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tab.n_tiles > 0) {
    const int grid = grid_for(tab.n_tiles);
    if (grid <= 0) return static_cast<int>(cudaErrorInvalidDevice);
    sumsq_partial_kernel<<<grid, kThreads, 0, s>>>(
        tab, static_cast<float*>(partial));
  }
  sumsq_final_kernel<<<n_leaves, kFinalThreads, 0, s>>>(
      tab, static_cast<const float*>(partial), static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

// One AdamW step over the n_leaves <= 64 leaves of one table: leaf i's
// gradient g[i] (bf16 where kind[i] has bit 0, else f32), its f32 master
// w[i], moments m[i] and v[i], updated in place, and the parameter p[i]
// written (bf16 where kind[i] has bit 1, else f32), n[i] elements each.
extern "C" int adamw_apply(const uint64_t* g, const uint64_t* w,
                           const uint64_t* m, const uint64_t* v,
                           const uint64_t* p, const int64_t* n,
                           const int* kind, int n_leaves, const void* scale,
                           const void* c1, const void* c2, const void* lr,
                           float b1, float omb1, float b2, float omb2,
                           float eps, float wd, void* stream) {
  Table tab;
  if (!pack(tab, n_leaves, g, w, m, v, p, n, kind, kApplyTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tab.n_tiles == 0) return static_cast<int>(cudaGetLastError());
  const int grid = grid_for(tab.n_tiles);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const Hyper h{static_cast<const float*>(scale), static_cast<const float*>(c1),
                static_cast<const float*>(c2), static_cast<const float*>(lr),
                b1, omb1, b2, omb2, eps, wd};
  apply_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(tab,
                                                                          h);
  return static_cast<int>(cudaGetLastError());
}
