// The implicit-GEMM core shared by the convolution (img2col.cu: conv2d),
// the compute -> TM commit (xchain_commit.cu) and the TM -> compute
// prologue (xchain_prologue.cu), and the Hopper helpers the product kernels
// share (matmul_tm.cu: mbarriers, TMA, cp.async, the accumulator types).
//
// out[m, n] = sum_k A(m, k) B(k, n), stored row-major (M, N) and rounded
// once to the element type T:
//   mm    A(m, k) = x[m K + k], B(k, n) = w[k ldb + col0 + n];
//   conv  m = (b, oh, ow), k = (ky, kx, ci) (the img2col column order),
//         A(m, k) = x[b, oh s + ky - pt, ow s + kx - pl, ci] (0 outside x),
//         B(k, n) = w[k ldb + col0 + n] (HWIO weights flattened).
// Floats accumulate in f32 (bf16 widened) with fmaf, every output's K
// products in ascending k; integers in uint32, which wraps: the exact sum
// modulo 2^bits, bit-exact against an integer product.
//
// Bound: the f32 operations, 2 M N K over 67 TFLOP/s on the CUDA cores (no
// TF32: the f32 tolerance 2 gamma_K sum |x w| of core/fp_bounds.py does not
// hold for it).  So the design is about feeding the FMA pipes:
//   * a block of threads = (BM / 8) x NCT owns a BM x BN output tile; each
//     thread holds 8 rows (tr, tr + BM/8, ...) by TN columns in registers
//     (BN = TN NCT: 8 x 8 at BN = 64, or 8 x 4 with NCT = 16 where the
//     8 x 8 tiles would leave the card with fewer warps than it holds;
//     NCT = 4 column threads where BN <= 32).  Per k a thread reads its 8 A values as 16-byte loads that
//     cover 16 bytes of K (so per k, 2 of them in f32) and ceil(TN / 4)
//     16-byte B loads: at 8 x 8, 4 loads per 64 FMAs, and a warp's lanes
//     share all but 384 bytes of a k's reads (0.19 B from the banks per
//     FMA), every load conflict-free (below);
//   * A enters shared memory without passing through registers: a ring of
//     `stages` stages, each BM rows x 128 bytes of K in TMA's 128-byte
//     swizzle (16-byte unit q of row r at r 128 + ((q ^ (r & 7)) 16)), so
//     that the 8 lanes of a 16-byte load phase, which read rows r..r+1 or
//     one row, hit distinct bank groups or broadcast.  A conv's stage is one
//     filter tap (ky, kx) by 128 bytes of channels, fetched by TMA in im2col
//     mode (a 4-d NHWC tensor map; the patch matrix is never in memory;
//     taps outside x arrive as zeros); an mm's stage is a 2-d TMA box.
//     Where TMA cannot take the operand (C or K sizeof(T) not a multiple of
//     16 bytes, x off 16 bytes) every thread copies its rows' elements with
//     cp.async, zero-filling (src-size 0) what lies outside x, into the same
//     layout, K packed densely across taps;
//   * B (K x BN of the weights, in the accumulator type) streams in the
//     same stages beside A: by TMA as well where its rows allow (4-byte
//     types, TN a multiple of 4: a thread's columns are then groups of 4
//     spaced NCT groups apart, so a B row in shared memory is the tile's
//     columns in order and its NCT column threads read distinct 16-byte
//     units), else by every thread with 4-byte cp.async copies (narrow
//     types widened through registers);
//   * each stage completes on a full mbarrier (TMA's bytes, or every
//     copying thread's arrival); each warp arrives on the stage's empty
//     mbarrier once done with it, and the stage's producers wait for that
//     before refilling it: where TMA brings A and B the only producer is
//     thread 0 (a copy-only warp would cost the computing threads
//     registers), so the computing warps are bound to one another only
//     through the data, never by a block barrier.  Blocks are persistent:
//     the host plan (kernels/img2col/img2col.py: conv_plan) sizes BM, the
//     stages and the grid from the card's SM count and the blocks an SM
//     holds, so that the last round of tiles is as full as it can be, and
//     this file checks the plan against the card before a launch.
//
// The host passes the product's geometry as 17 int64 words (Gemm below;
// kernels/matmul_tm/chain.py: Gemm.words).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoders come from cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace igemm {

// ---------------------------------------------------------------------------
// accumulation: f32 for floats, wrapping uint32 for integers
// ---------------------------------------------------------------------------

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = uint32_t; };
template <> struct Acc<int32_t> { using type = uint32_t; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ uint32_t widen(int8_t v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}
__device__ __forceinline__ uint32_t widen(int32_t v) {
  return static_cast<uint32_t>(v);
}

__device__ __forceinline__ float mac(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ uint32_t mac(uint32_t a, uint32_t b,
                                        uint32_t acc) {
  return a * b + acc;
}

template <typename T>
__device__ __forceinline__ T narrow(typename Acc<T>::type acc) {
  if constexpr (std::is_same<T, float>::value) {
    return acc;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(acc);
  } else {
    return static_cast<T>(static_cast<int32_t>(acc));  // two's complement
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename A>
__device__ __forceinline__ A from_word(uint32_t u) {
  if constexpr (std::is_same<A, float>::value) return __uint_as_float(u);
  else return u;
}

// element e of a 32-bit word of T, widened to the accumulator type
template <typename T>
__device__ __forceinline__ typename Acc<T>::type elem(uint32_t u, int e) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(u);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __uint_as_float(e ? (u & 0xffff0000u) : (u << 16));
  } else if constexpr (std::is_same<T, int8_t>::value) {
    return static_cast<uint32_t>(static_cast<int32_t>(u << (24 - 8 * e)) >> 24);
  } else {
    return u;
  }
}

// ---------------------------------------------------------------------------
// Hopper helpers: mbarriers, TMA, cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed; a pipeline that stalls
// for 2^24 polls (seconds) traps, failing the launch instead of hanging it
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 2-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// pixels of a 4-d NHWC im2col tensor map: the walk starts at base pixel
// (n, h, w) and runs through the map's bounding box; each pixel is read at
// (h + oh, w + ow), channels c on, zeros outside the tensor
__device__ __forceinline__ void tma_load_im2col(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int c, int w,
                                                int h, int n, uint16_t ow,
                                                uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h),
      "r"(n), "h"(ow), "h"(oh)
      : "memory");
}

// the 4 bytes at src, of which only the first `n` (0-4) are read; the rest
// of the word is zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// ---------------------------------------------------------------------------
// host: TMA tensor-map encoders looked up through cudart's entry-point
// query, so that no library links libcuda
// ---------------------------------------------------------------------------

template <typename Fn>
Fn entry_point(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault,
                                       &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<Fn>(p);
}

using EncodeTiledFn = decltype(&cuTensorMapEncodeTiled);
using EncodeIm2colFn = decltype(&cuTensorMapEncodeIm2col);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn =
      entry_point<EncodeTiledFn>("cuTensorMapEncodeTiled");
  return fn;
}

inline EncodeIm2colFn encode_im2col() {
  static EncodeIm2colFn fn =
      entry_point<EncodeIm2colFn>("cuTensorMapEncodeIm2col");
  return fn;
}

template <typename T> constexpr CUtensorMapDataType tma_type();
template <> constexpr CUtensorMapDataType tma_type<int8_t>() {
  return CU_TENSOR_MAP_DATA_TYPE_UINT8;
}
template <> constexpr CUtensorMapDataType tma_type<int32_t>() {
  return CU_TENSOR_MAP_DATA_TYPE_INT32;
}
template <> constexpr CUtensorMapDataType tma_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType tma_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

inline uint32_t align_up(size_t v, size_t a) {
  return static_cast<uint32_t>((v + a - 1) / a * a);
}

// ---------------------------------------------------------------------------
// the product's geometry and the core's launch arguments
// ---------------------------------------------------------------------------

struct Gemm {
  int64_t kind;  // 0: mm, 1: NHWC conv with HWIO weights
  int64_t M, N, K;
  int64_t ldb, col0;  // B(k, n) = w[k ldb + col0 + n]
  int64_t B, H, W, C, OH, OW, kh, kw, stride, pt, pl;  // conv only
};
constexpr int kGemmWords = 17;

inline bool parse_gemm(const int64_t* words, Gemm* g) {
  int64_t* dst = reinterpret_cast<int64_t*>(g);
  for (int i = 0; i < kGemmWords; ++i) dst[i] = words[i];
  return g->M > 0 && g->N > 0 && g->K >= 0 && (g->kind == 0 || g->kind == 1);
}

constexpr int kIgRows = 8;         // output rows per thread
constexpr int kIgRowBytes = 128;   // bytes of K per row per stage
// threads of a block; two blocks of the most an SM: at most 168 registers
// a thread (65536 over 2 x 192, in the per-warp units of 256), which holds
// the 8 x 8 tile's 64 accumulators, 32 words of A and 8 of B
constexpr int kIgMaxThreads = 192;
constexpr int kIgMinBlocks = 2;
constexpr int kIgMaxBoxRows = 256;  // rows of one TMA box
constexpr int kIgMaxBoxes = 2;
constexpr int kIgMaxStages = 4;
enum IgPath { kIgTma = 0, kIgAsync = 1 };

struct Args {
  Gemm g;
  const void* x;
  const void* w;
  void* out;       // (M, N) row-major
  int path;        // A: kIgTma or kIgAsync
  int b_tma;       // B by TMA (4-byte types, rows 16-byte aligned)
  int bm, stages;  // tile rows, ring stages
  int n_k;         // K steps per tile
  int n_kc;        // channel chunks per filter tap (TMA conv)
  int n_ntiles, n_tiles;
  int box_rows, n_boxes;  // TMA boxes of a stage
  int out_vec;     // the output rows allow 4-element vector stores
  int probe;       // 1: the FMA loop alone (no loads and no waits)
  int spread;      // blocks on each SM where tiles are spread (else 1)
  uint32_t stage_bytes, a_bytes;  // a stage: A (bm x 128 bytes), then B
  uint32_t off_bars;  // the ring's mbarriers: full[kIgMaxStages], empty[...]
};

__device__ __forceinline__ uint32_t swz128(int r, int q) {
  return static_cast<uint32_t>(r * kIgRowBytes + ((q ^ (r & 7)) << 4));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// an arrival on `bar` once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// Tile column of a thread's column jj (column thread tc).  Where TN is a
// multiple of 4 the thread's columns are groups of 4 spaced NCT groups
// apart (tc's 16-byte B loads then hit distinct bank groups, and a B row in
// shared memory is the tile's columns in order, which TMA can copy);
// otherwise TN consecutive columns, stored interleaved (b_pos).
template <int TN, int NCT>
__device__ __forceinline__ int col_of(int tc, int jj) {
  if constexpr (TN % 4 == 0) {
    return ((jj / 4) * NCT + tc) * 4 + jj % 4;
  } else {
    return tc * TN + jj;
  }
}

// Where tile column n sits in a B row in shared memory.
template <int TN, int NCT>
__device__ __forceinline__ int b_pos(int n) {
  if constexpr (TN % 4 == 0) {
    return n;
  } else {
    const int tc = n / TN, jj = n - tc * TN;
    return ((jj / 4) * NCT + tc) * 4 + jj % 4;
  }
}

// The first k of a K step and how many of its BK columns are real.  A TMA
// conv step is one filter tap by a chunk of channels; otherwise K runs
// densely across taps.
template <typename T>
__device__ __forceinline__ void k_step(const Args& a, int ks, int64_t* kb,
                                       int* nv, int* tap, int* c0) {
  constexpr int BK = kIgRowBytes / sizeof(T);
  if (a.g.kind == 1 && a.path == kIgTma) {
    *tap = ks / a.n_kc;
    *c0 = (ks - *tap * a.n_kc) * BK;
    *kb = static_cast<int64_t>(*tap) * a.g.C + *c0;
    const int64_t left = a.g.C - *c0;
    *nv = static_cast<int>(left < BK ? left : BK);
  } else {
    *tap = 0;
    *c0 = 0;
    *kb = static_cast<int64_t>(ks) * BK;
    const int64_t left = a.g.K - *kb;
    *nv = static_cast<int>(left < BK ? left : BK);
  }
}

// One element of T from global memory into shared memory: cp.async with
// zero fill for 4-byte types, through a register for the narrow ones.
template <typename T>
__device__ __forceinline__ void copy_elem(uint32_t dst, uint8_t* dst_p,
                                          const T* src, bool valid,
                                          const void* any) {
  if constexpr (sizeof(T) == 4) {
    cp_async4(dst, valid ? static_cast<const void*>(src) : any,
              valid ? 4u : 0u);
  } else {
    T v;
    if (valid) {
      v = *src;
    } else {
      memset(&v, 0, sizeof(T));
    }
    *reinterpret_cast<T*>(dst_p) = v;
  }
}

// The SM this thread runs on.
__device__ __forceinline__ int sm_id() {
  uint32_t id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return static_cast<int>(id);
}

// This block's place in the tile order (its tiles are place, + gridDim.x,
// ...).  Where a cooperative kernel has fewer tiles than blocks
// (a.spread > 1: the grid is exactly a.spread blocks on every SM), each
// block has written its SM to place_of[blockIdx.x] before a grid barrier;
// the block that is the r-th of its SM (by block index) among the SMs in
// order of their ids takes place r SMs + (its SM's rank), so tiles
// 0 .. SMs - 1 land one on each SM, whatever order the card placed the
// blocks in.  Else the block index.
__device__ __forceinline__ int tile_place(const Args& a,
                                          const int* place_of) {
  const int b = static_cast<int>(blockIdx.x);
  if (a.spread <= 1) return b;
  __shared__ int s_count[2];
  if (threadIdx.x == 0) s_count[0] = s_count[1] = 0;
  __syncthreads();
  const int me = place_of[b];
  int below = 0, before = 0;  // blocks on lower SMs; earlier ones on mine
  for (int q = threadIdx.x; q < static_cast<int>(gridDim.x);
       q += blockDim.x) {
    const int sm = place_of[q];
    below += sm < me;
    before += sm == me && q < b;
  }
  if (below) atomicAdd(&s_count[0], below);
  if (before) atomicAdd(&s_count[1], before);
  __syncthreads();
  const int sms = static_cast<int>(gridDim.x) / a.spread;
  return s_count[1] * sms + s_count[0] / a.spread;
}

// Stage `st` gets item j of this block, completing on the stage's full
// barrier: A and B by TMA (thread 0: one arrival with the bytes expected)
// where the plan says so, the rest by every thread (cp.async, or through
// registers for narrow types; one arrival each).
template <typename T, int TN, int NCT>
__device__ void load_item(const CUtensorMap* amap, const CUtensorMap* bmap,
                          const Args& a, uint8_t* smem, int st, int j,
                          int4* coords, int place) {
  using AccT = typename Acc<T>::type;
  constexpr int BK = kIgRowBytes / sizeof(T);
  constexpr int EPU = 16 / sizeof(T);
  constexpr int TNP = (TN + 3) / 4 * 4;
  constexpr int BNP = TNP * NCT;
  constexpr int BN = TN * NCT;
  const int t = threadIdx.x, nt = blockDim.x;
  const int tile = place + (j / a.n_k) * gridDim.x;
  const int ks = j % a.n_k;
  const int64_t m0 = static_cast<int64_t>(tile / a.n_ntiles) * a.bm;
  const int n0 = (tile % a.n_ntiles) * BN;
  int64_t kb;
  int nv, tap, c0;
  k_step<T>(a, ks, &kb, &nv, &tap, &c0);
  uint8_t* stage = smem + static_cast<size_t>(st) * a.stage_bytes;
  const uint32_t stage_s = smem_u32(stage);
  const uint32_t full = smem_u32(smem) + a.off_bars + 8 * st;
  const Gemm& g = a.g;
  const T* x = static_cast<const T*>(a.x);
  const bool a_tma = a.path == kIgTma;

  if (t == 0 && (a_tma || a.b_tma)) {
    int boxes = 0;
    if (a_tma) {
      for (int q = 0; q < a.n_boxes; ++q) {
        if (m0 + static_cast<int64_t>(q) * a.box_rows < g.M) ++boxes;
      }
    }
    mbar_expect_tx(full, static_cast<uint32_t>(
                             boxes * a.box_rows * kIgRowBytes +
                             (a.b_tma ? BK * BNP * sizeof(AccT) : 0)));
    if (a_tma && g.kind == 1 && ks == 0) {  // the tile's base pixels
      for (int q = 0; q < boxes; ++q) {
        const int64_t m = m0 + static_cast<int64_t>(q) * a.box_rows;
        const int64_t ow = m % g.OW, r = m / g.OW;
        const int64_t oh = r % g.OH, b = r / g.OH;
        coords[q] = make_int4(static_cast<int>(ow * g.stride - g.pl),
                              static_cast<int>(oh * g.stride - g.pt),
                              static_cast<int>(b), 0);
      }
    }
    for (int q = 0; q < boxes; ++q) {
      const uint32_t dst = stage_s + q * a.box_rows * kIgRowBytes;
      if (g.kind == 1) {
        const int ky = tap / static_cast<int>(g.kw);
        const int kx = tap - ky * static_cast<int>(g.kw);
        tma_load_im2col(dst, amap, full, c0, coords[q].x, coords[q].y,
                        coords[q].z, static_cast<uint16_t>(kx),
                        static_cast<uint16_t>(ky));
      } else {
        tma_load_2d(dst, amap, full, static_cast<int>(kb),
                    static_cast<int>(m0 + q * a.box_rows));
      }
    }
    if (a.b_tma) {
      tma_load_2d(stage_s + a.a_bytes, bmap, full, n0, static_cast<int>(kb));
    }
  }
  if (a_tma && a.b_tma) return;

  if (!a_tma) {
    // every thread: rows t, t + nt, ...; K from kb densely, zero past nv
    for (int r = t; r < a.bm; r += nt) {
      const int64_t m = m0 + r;
      const bool row_ok = m < g.M;
      uint8_t* rowp = stage + r * kIgRowBytes;
      const uint32_t rows = stage_s + r * kIgRowBytes;
      if (g.kind == 0) {
        const T* src = x + (row_ok ? m : 0) * g.K + kb;
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          const uint32_t off = (((kk / EPU) ^ (r & 7)) << 4) +
                               (kk % EPU) * sizeof(T);
          copy_elem<T>(rows + off, rowp + off, src + kk, row_ok && kk < nv,
                       x);
        }
      } else {
        const int64_t mm = row_ok ? m : 0;
        const int64_t ow = mm % g.OW, rr = mm / g.OW;
        const int64_t oh = rr % g.OH, b = rr / g.OH;
        const int64_t iy0 = oh * g.stride - g.pt, ix0 = ow * g.stride - g.pl;
        const T* xb = x + b * g.H * g.W * g.C;
        // (ky, kx, c) of k = kb, walked forward
        int64_t c = g.C > 0 ? kb % g.C : 0;
        int64_t tp = g.C > 0 ? kb / g.C : 0;
        int64_t ky = tp / g.kw, kx = tp - ky * g.kw;
        for (int kk = 0; kk < BK; ++kk) {
          const int64_t iy = iy0 + ky, ix = ix0 + kx;
          const bool ok = row_ok && kk < nv && iy >= 0 && iy < g.H &&
                          ix >= 0 && ix < g.W;
          const uint32_t off = (((kk / EPU) ^ (r & 7)) << 4) +
                               (kk % EPU) * sizeof(T);
          copy_elem<T>(rows + off, rowp + off,
                       xb + (iy * g.W + ix) * g.C + c, ok, x);
          if (++c == g.C) {
            c = 0;
            if (++kx == g.kw) {
              kx = 0;
              ++ky;
            }
          }
        }
      }
    }
  }

  if (!a.b_tma) {
    // B: rows kb .. kb + nv, columns n0 .. n0 + BN, column n of the tile
    // at b_pos(n) of its row
    const T* w = static_cast<const T*>(a.w);
    uint8_t* bp = stage + a.a_bytes;
    const uint32_t bs = stage_s + a.a_bytes;
    for (int e = t; e < BK * BN; e += nt) {
      const int kk = e / BN, n = e - kk * BN;
      const int64_t col = n0 + n;
      const bool ok = kk < nv && col < g.N;
      const uint32_t off = static_cast<uint32_t>(
          (kk * BNP + b_pos<TN, NCT>(n)) * sizeof(AccT));
      const T* src = w + (ok ? (kb + kk) * g.ldb + g.col0 + col : 0);
      if constexpr (sizeof(T) == 4) {
        cp_async4(bs + off, src, ok ? 4u : 0u);
      } else {
        *reinterpret_cast<AccT*>(bp + off) = ok ? widen(*src) : AccT(0);
      }
    }
  }
  if constexpr (sizeof(T) == 4) {
    cp_async_arrive(full);
  } else {
    mbar_arrive(full);
  }
}

// The products of one stage: nq 16-byte units of K of each of the thread's
// rows against the B rows of those k, in ascending k.
template <typename T, int TN, int NCT>
__device__ __forceinline__ void compute_stage(
    typename Acc<T>::type (&acc)[kIgRows][TN], const uint8_t* as,
    const typename Acc<T>::type* bsm, int tr, int rt, int tc, int nq) {
  using AccT = typename Acc<T>::type;
  constexpr int EPU = 16 / sizeof(T);
  constexpr int PER = 4 / sizeof(T);  // elements of a 32-bit word
  constexpr int TNP = (TN + 3) / 4 * 4;
  constexpr int BNP = TNP * NCT;
  auto unit = [&](int q) {
    uint4 av[kIgRows];
#pragma unroll
    for (int i = 0; i < kIgRows; ++i) {
      av[i] = *reinterpret_cast<const uint4*>(as + swz128(tr + i * rt, q));
    }
    const AccT* brow = bsm + q * EPU * BNP + tc * 4;
#pragma unroll
    for (int e = 0; e < EPU; ++e) {
      AccT ai[kIgRows], bv[TNP];
#pragma unroll
      for (int i = 0; i < kIgRows; ++i) {
        ai[i] = elem<T>(word(av[i], e / PER), e % PER);
      }
#pragma unroll
      for (int h = 0; h < TNP / 4; ++h) {
        const uint4 u =
            *reinterpret_cast<const uint4*>(brow + e * BNP + h * NCT * 4);
        bv[4 * h] = from_word<AccT>(u.x);
        bv[4 * h + 1] = from_word<AccT>(u.y);
        bv[4 * h + 2] = from_word<AccT>(u.z);
        bv[4 * h + 3] = from_word<AccT>(u.w);
      }
#pragma unroll
      for (int i = 0; i < kIgRows; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(ai[i], bv[j], acc[i][j]);
      }
    }
  };
  if constexpr (sizeof(T) == 4) {
#pragma unroll 2
    for (int q = 0; q < nq; ++q) unit(q);
  } else {
#pragma unroll 1
    for (int q = 0; q < nq; ++q) unit(q);
  }
}

// The tile's rows, rounded once to T: where TN is a multiple of 4, each
// group of 4 columns as one vector store when the row allows.
template <typename T, int TN, int NCT>
__device__ __forceinline__ void store_tile(
    const Args& a, const typename Acc<T>::type (&acc)[kIgRows][TN],
    int64_t m0, int n0, int tr, int rt, int tc) {
  T* out = static_cast<T*>(a.out);
  const int64_t N = a.g.N;
#pragma unroll
  for (int i = 0; i < kIgRows; ++i) {
    const int64_t m = m0 + tr + i * rt;
    if (m >= a.g.M) continue;
    T* o = out + m * N + n0;
#pragma unroll
    for (int h = 0; h < (TN + 3) / 4; ++h) {
      const int n = col_of<TN, NCT>(tc, 4 * h);
      if constexpr (TN % 4 == 0) {
        if (a.out_vec && n0 + n + 4 <= N) {
          T tmp[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) tmp[e] = narrow<T>(acc[i][4 * h + e]);
          if constexpr (sizeof(T) == 4) {
            uint4 u;
            memcpy(&u, tmp, 16);
            *reinterpret_cast<uint4*>(o + n) = u;
          } else if constexpr (sizeof(T) == 2) {
            uint2 u;
            memcpy(&u, tmp, 8);
            *reinterpret_cast<uint2*>(o + n) = u;
          } else {
            uint32_t u;
            memcpy(&u, tmp, 4);
            *reinterpret_cast<uint32_t*>(o + n) = u;
          }
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = 4 * h + e;
        if (jj < TN) {
          const int ne = col_of<TN, NCT>(tc, jj);
          if (n0 + ne < N) o[ne] = narrow<T>(acc[i][jj]);
        }
      }
    }
  }
}

// Every tile of this block (tiles place, + gridDim.x, ...), stored to
// a.out.  The ring runs across tile boundaries: items (tile, K step) in
// order, stages - 1 of them in flight ahead of the one computed.  A stage
// completes on its full barrier; each warp arrives on its empty barrier
// once done with it, and the stage's producers (thread 0 where TMA brings
// A and B, else every thread) wait for that before refilling it, so the
// warps are bound to one another only through the data.
template <typename T, int TN, int NCT>
__device__ void run_tiles(const CUtensorMap* amap, const CUtensorMap* bmap,
                          const Args& a, int place) {
  using AccT = typename Acc<T>::type;
  constexpr int EPU = 16 / sizeof(T);
  constexpr int BN = TN * NCT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ int4 coords[kIgMaxBoxes];
  const int t = threadIdx.x;
  const int rt = blockDim.x / NCT;  // row threads
  const int tr = t / NCT, tc = t - tr * NCT;
  const int S = a.stages;
  const bool by_all = a.path != kIgTma || !a.b_tma;  // every thread copies
  const uint32_t full0 = smem_u32(smem) + a.off_bars;
  const uint32_t empty0 = full0 + 8 * kIgMaxStages;
  const int my_tiles =
      place < a.n_tiles ? (a.n_tiles - 1 - place) / gridDim.x + 1 : 0;

  AccT acc[kIgRows][TN];
#pragma unroll
  for (int i = 0; i < kIgRows; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  }
  if (a.n_k == 0) {  // K == 0: empty sums, zeros
    for (int q = 0; q < my_tiles; ++q) {
      const int tile = place + q * gridDim.x;
      store_tile<T, TN, NCT>(a, acc,
                             static_cast<int64_t>(tile / a.n_ntiles) * a.bm,
                             (tile % a.n_ntiles) * BN, tr, rt, tc);
    }
    return;
  }
  const int n_items = my_tiles * a.n_k;
  if (a.probe) {
    // the FMA loop alone: stage 0 (zeros) for every item, no loads, no
    // waits
    for (uint32_t i = t; i < a.stage_bytes / 4; i += blockDim.x) {
      reinterpret_cast<uint32_t*>(smem)[i] = 0;
    }
    __syncthreads();
    const AccT* bsm = reinterpret_cast<const AccT*>(smem + a.a_bytes);
    for (int j = 0; j < n_items; ++j) {
      compute_stage<T, TN, NCT>(acc, smem, bsm, tr, rt, tc,
                                kIgRowBytes / 16);
      if (j % a.n_k == a.n_k - 1) {
        const int tile = place + (j / a.n_k) * gridDim.x;
        store_tile<T, TN, NCT>(a, acc,
                               static_cast<int64_t>(tile / a.n_ntiles) * a.bm,
                               (tile % a.n_ntiles) * BN, tr, rt, tc);
      }
    }
    return;
  }
  if (t == 0) {
    const uint32_t arrivals = (a.path == kIgTma || a.b_tma ? 1u : 0u) +
                              (by_all ? static_cast<uint32_t>(blockDim.x) : 0u);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, arrivals);
      mbar_init(empty0 + 8 * s, blockDim.x / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const bool producer = by_all || t == 0;
  for (int j = 0; j < S - 1 && j < n_items; ++j) {
    if (producer) {
      load_item<T, TN, NCT>(amap, bmap, a, smem, j, j, coords, place);
    }
  }
  for (int j = 0; j < n_items; ++j) {
    const int jn = j + S - 1;
    if (jn < n_items && producer) {
      // every warp is done with the stage item jn - S used
      if (jn >= S) mbar_wait(empty0 + 8 * (jn % S), ((jn / S) - 1) & 1);
      if (t == 0) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_item<T, TN, NCT>(amap, bmap, a, smem, jn % S, jn, coords,
                            place);
    }
    const int st = j % S;
    mbar_wait(full0 + 8 * st, (j / S) & 1);
    const uint8_t* as = smem + static_cast<size_t>(st) * a.stage_bytes;
    const AccT* bsm = reinterpret_cast<const AccT*>(as + a.a_bytes);
    const int ks = j % a.n_k;
    int64_t kb;
    int nv, tap, c0;
    k_step<T>(a, ks, &kb, &nv, &tap, &c0);
    if (nv == kIgRowBytes / static_cast<int>(sizeof(T))) {
      // a full step: a trip count the compiler knows, so the loop unrolls
      // without a remainder
      compute_stage<T, TN, NCT>(acc, as, bsm, tr, rt, tc, kIgRowBytes / 16);
    } else {
      compute_stage<T, TN, NCT>(acc, as, bsm, tr, rt, tc, (nv + EPU - 1) / EPU);
    }
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(empty0 + 8 * st);
    if (ks == a.n_k - 1) {
      const int tile = place + (j / a.n_k) * gridDim.x;
      store_tile<T, TN, NCT>(a, acc,
                             static_cast<int64_t>(tile / a.n_ntiles) * a.bm,
                             (tile % a.n_ntiles) * BN, tr, rt, tc);
#pragma unroll
      for (int i = 0; i < kIgRows; ++i) {
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host: the plan's launch, checked against the card
// ---------------------------------------------------------------------------

// The tile width of a product N columns wide: N rounded up to 4 where
// N <= 32, else column tiles of 64 (kernels/img2col/img2col.py: conv_plan).
inline int64_t tile_bn(int64_t N) { return N <= 32 ? (N + 3) / 4 * 4 : 64; }

// The TMA A map: im2col over the NHWC x (conv) or 2-d boxes of x (mm).
template <typename T>
bool a_tensor_map(CUtensorMap* map, const Args& a) {
  constexpr uint32_t BK = kIgRowBytes / sizeof(T);
  const Gemm& g = a.g;
  const cuuint64_t size = sizeof(T);
  if (g.kind == 0) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(g.K),
                                static_cast<cuuint64_t>(g.M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(g.K) * size};
    const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(a.box_rows)};
    const cuuint32_t unit[2] = {1, 1};
    return encode(map, tma_type<T>(), 2, const_cast<void*>(a.x), dims,
                  strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const EncodeIm2colFn encode = encode_im2col();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(g.C), static_cast<cuuint64_t>(g.W),
      static_cast<cuuint64_t>(g.H), static_cast<cuuint64_t>(g.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(g.C) * size,
                                 static_cast<cuuint64_t>(g.W * g.C) * size,
                                 static_cast<cuuint64_t>(g.H * g.W * g.C) *
                                     size};
  // the base pixels (top-left taps) of the outputs: w from -pl by stride to
  // (OW - 1) stride - pl, as offsets from x's first and last column
  const int lower[2] = {static_cast<int>(-g.pl), static_cast<int>(-g.pt)};
  const int upper[2] = {
      static_cast<int>((g.OW - 1) * g.stride - g.pl - (g.W - 1)),
      static_cast<int>((g.OH - 1) * g.stride - g.pt - (g.H - 1))};
  const cuuint32_t unit[4] = {1, static_cast<cuuint32_t>(g.stride),
                              static_cast<cuuint32_t>(g.stride), 1};
  return encode(map, tma_type<T>(), 4, const_cast<void*>(a.x), dims, strides,
                lower, upper, BK, static_cast<cuuint32_t>(a.box_rows), unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA B map: the K x BN boxes of the weights' columns col0 .. col0 + N
// (rows ldb apart), zeros past K and past N.
template <typename T, int BN>
bool b_tensor_map(CUtensorMap* map, const Args& a) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const Gemm& g = a.g;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(g.N),
                              static_cast<cuuint64_t>(g.K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(g.ldb) * sizeof(T)};
  const cuuint32_t box[2] = {BN, kIgRowBytes / sizeof(T)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, tma_type<T>(), 2,
                const_cast<T*>(static_cast<const T*>(a.w) + g.col0), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Fill in the launch arguments from the plan (path, bm, stages), encode the
// A and B maps, size the shared memory, and check the plan against the
// card: the kernel must hold `blocks` blocks an SM and `grid` must not
// exceed what the card holds at once.  B goes by TMA where its rows can
// (4-byte types, whose shared-memory rows are then the tiles' columns in
// order: TN a multiple of 4; rows and w + col0 16-byte aligned).  Returns a
// CUDA error code.
template <typename T, int TN, int NCT>
int prepare(Args* a, CUtensorMap* map, CUtensorMap* bmap, const void* kernel,
            int path, int bm, int stages, int blocks, int grid,
            size_t* smem) {
  using AccT = typename Acc<T>::type;
  constexpr int BK = kIgRowBytes / sizeof(T);
  constexpr int BN = TN * NCT;
  constexpr int BNP = (TN + 3) / 4 * 4 * NCT;
  Gemm& g = a->g;
  const int threads = bm / kIgRows * NCT;
  const int64_t n_mtiles = (g.M + bm - 1) / bm;
  const int64_t n_ntiles = (g.N + BN - 1) / BN;
  const bool tma = path == kIgTma;
  const bool conv = g.kind == 1;
  if (tile_bn(g.N) != BN || bm % 32 != 0 || bm < 32 ||
      threads > kIgMaxThreads || threads % 32 != 0 || stages < 2 ||
      stages > kIgMaxStages ||
      (path != kIgTma && path != kIgAsync) || blocks < 1 || grid < 1 ||
      n_mtiles * n_ntiles >= (int64_t{1} << 31) || g.M >= (int64_t{1} << 40) ||
      (tma && (g.K < 1 || reinterpret_cast<uintptr_t>(a->x) % 16 != 0 ||
               ((conv ? g.C : g.K) * static_cast<int64_t>(sizeof(T))) % 16 !=
                   0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a->path = path;
  a->bm = bm;
  a->stages = stages;
  a->n_ntiles = static_cast<int>(n_ntiles);
  a->n_tiles = static_cast<int>(n_mtiles * n_ntiles);
  a->n_kc = conv ? static_cast<int>((g.C + BK - 1) / BK) : 1;
  a->n_k = static_cast<int>(tma && conv ? g.kh * g.kw * a->n_kc
                                        : (g.K + BK - 1) / BK);
  a->n_boxes = (bm + kIgMaxBoxRows - 1) / kIgMaxBoxRows;
  a->box_rows = bm / a->n_boxes;
  a->b_tma = sizeof(T) == 4 && TN % 4 == 0 && g.K >= 1 &&
             (g.ldb * 4) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(static_cast<const T*>(a->w) +
                                         g.col0) % 16 == 0;
  a->out_vec = g.N % 4 == 0 &&
               reinterpret_cast<uintptr_t>(a->out) % (4 * sizeof(T)) == 0;
  a->a_bytes = static_cast<uint32_t>(bm * kIgRowBytes);
  a->stage_bytes = align_up(a->a_bytes + BK * BNP * sizeof(AccT), 1024);
  a->off_bars = static_cast<uint32_t>(stages) * a->stage_bytes;
  // the full and empty barriers, and the 1024-byte alignment
  *smem = a->off_bars + 16 * kIgMaxStages + 1024;
  memset(map, 0, sizeof(*map));
  memset(bmap, 0, sizeof(*bmap));
  if ((tma && !a_tensor_map<T>(map, *a)) ||
      (a->b_tma && !b_tensor_map<T, BN>(bmap, *a))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, *smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // the plan assumed more blocks an SM than the card holds, or a grid the
  // card cannot hold at once (blocks past the tiles have none: a
  // cooperative kernel may run them for its other phase)
  if (per_sm < blocks || grid > static_cast<int64_t>(blocks) * sms) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // a cooperative grid of exactly `blocks` on every SM with fewer tiles:
  // the kernel spreads its tiles over the SMs (tile_place)
  a->spread =
      a->n_tiles < grid && grid == blocks * sms && per_sm == blocks ? blocks
                                                                     : 1;
  return 0;
}

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory an
// SM holds of `kernel` (the plan's occupancy input), or the negated CUDA
// error.
inline int kernel_blocks(const void* kernel, int threads, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                        smem);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace igemm

// Dispatch on the plan's tile width BN and column threads NCT to a kernel
// template K<T, TN, NCT>: NCT = 4 column threads of TN = BN / 4 columns
// where BN <= 32; at BN = 64 either 8 of 8 or 16 of 4 (the plan's nct).
#define IGEMM_DISPATCH(bn, nct, CASE)                                      \
  switch ((bn) * 32 + (nct)) {                                             \
    CASE(1, 4) CASE(2, 4) CASE(3, 4) CASE(4, 4) CASE(5, 4) CASE(6, 4)      \
    CASE(7, 4) CASE(8, 4) CASE(8, 8) CASE(4, 16)                           \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }

// The case label of (TN, NCT) in IGEMM_DISPATCH.
#define IGEMM_KEY(tn, nct) ((tn) * (nct) * 32 + (nct))
