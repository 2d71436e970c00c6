// The product with a TM store for Hopper (sm_90a), in ONE launch.
//
// Replaces the JAX package's Pallas kernel in
// src/repro/kernels/matmul_tm/matmul_tm.py: matmul_tm (body _mm_kernel): a
// tiled x @ w whose store writes each tile to its TM destination
// (identity, transpose, pixel shuffle, a split band).  The other two
// cross-engine kernels are xchain_commit.cu and xchain_prologue.cu.
//
// out[m, n] = sum_k x[m K + k] w[k ldb + col0 + n].  Floats accumulate in
// f32 (bf16 inputs widened) and round to the element type once, as
// _mm_kernel's f32 accumulator cast at commit; integers accumulate in
// uint32, which wraps, and truncate to the element type: the exact sum
// modulo 2^bits, what an integer dot_general or mm gives.
//
// Summation order, on which the float tolerance depends: every output sums
// its K products one at a time in ascending k with fmaf.  Two evaluations
// in other orders lie within 2 gamma_K sum |A B| of each other
// (core/fp_bounds.py).
//
// matmul_tm (mm_tm_kernel): a streamed tall-skinny product with a staged TM
// store.  Its callers' products are tall and narrow (ESPCN's last layer:
// (230400, 288) x (288, 27)), so the bound is the bytes of A, read once:
// 290 MB over 3.35 TB/s is 0.087 ms, above the 0.054 ms of its f32
// operations over 67 TFLOP/s.  Next in line is the rate at which shared
// memory feeds the registers (128 bytes per clock per SM, as many as the
// FMA pipes take operands), so the register tile is sized for bytes per
// FMA, not only for FMAs:
//   * persistent blocks, one per SM, walk output tiles of kMmBM = 512 rows
//     by BN columns, BN = N rounded up to a multiple of 4 when N <= 32
//     (27 -> 28), else column tiles of 32;
//   * A flows through a ring of kMmStages shared-memory stages, each 512
//     rows x 64 bytes of K: with TMA (a 2D tensor map over x, 64-byte
//     swizzle, completion on an mbarrier; thread 0 refills a stage once
//     every thread is done with it) where the row pitch K sizeof(T) is a
//     multiple of 16 bytes and x is 16-byte aligned, else with 4-byte
//     cp.async copies of each row's window, two stages ahead, that all
//     threads shift into the same swizzled layout just before use; rows and
//     columns past x read zeros.  Boxes 32 bytes wide streamed A at under
//     2 TB/s; 64 bytes wide, faster;
//   * B (K x BN, widened to the accumulator type, as two halves of BN / 2
//     columns) is loaded into shared memory once per block, or in slabs of
//     K rows where it does not fit beside the ring, and is read as
//     broadcast 16-byte loads;
//   * each of the 256 threads owns 4 rows x BN / 2 columns in registers:
//     per k it reads 4 A values and BN / 2 B values, 72 bytes for 56 FMAs
//     at BN = 28, where a thread holding 2 rows x 28 columns read 120 bytes
//     for 56 (shared memory feeds 128 bytes per clock per SM); the swizzle
//     makes the 16-byte reads of A conflict-free, and the B row of k + 1
//     and the next 16 bytes of A load while the FMAs of k run.  No warp
//     only copies: beside a producer warp ptxas capped a thread at 168
//     registers.  Every output sums its products with fmaf in ascending k,
//     as above;
//   * the epilogue stages each 256-row pass in shared memory in the
//     destination's order and writes it with aligned 16-byte stores:
//     contiguous rows of N (identity, a split band), rows of M (transpose),
//     or per image row and dy one run of (pixels) s C elements (pixel
//     shuffle); a pixel shuffle tiled in columns (N > 32), or split in more
//     runs than a pass has rows, stores element by element.
// No tensor cores: the operands are f32 and TF32 keeps about three digits.
//
// The accumulator types and the mbarrier and TMA helpers are igemm.cuh's.
//
// Element types: int8, int32, bf16, f32.  Each entry point returns
// cudaGetLastError() after its launch.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "chain_desc.cuh"
#include "igemm.cuh"

namespace {

using igemm::Acc;
using igemm::align_up;
using igemm::elem;
using igemm::from_word;
using igemm::mac;
using igemm::mbar_expect_tx;
using igemm::mbar_init;
using igemm::mbar_wait;
using igemm::narrow;
using igemm::smem_u32;
using igemm::tma_load_2d;
using igemm::tma_type;
using igemm::widen;
using igemm::word;

enum StoreMode { kIdentity = 0, kTranspose = 1, kPixelShuffle = 2 };

// ---------------------------------------------------------------------------
// matmul_tm: the streamed tall-skinny product (mm_tm_kernel)
// ---------------------------------------------------------------------------

constexpr int kMmThreads = 256;    // 8 warps, all computing
constexpr int kMmRowThreads = 128; // thread t: rows t % 128 + 128 i, half t / 128
constexpr int kMmTM = 4;           // rows per thread
constexpr int kMmBM = kMmRowThreads * kMmTM;  // 512 rows of an output tile
constexpr int kMmBox = 256;        // rows of one TMA box
constexpr int kMmChunk = 64;  // bytes of a row per stage: one swizzle row
constexpr int kMmStages = 4;  // TMA ring
constexpr int kMmStageBytes = kMmBM * kMmChunk;
constexpr int kMmWinSets = 2;  // cp.async: stages of windows in flight
constexpr int kMmMaxBN = 32;
constexpr int kMmHalf = kMmMaxBN / 2;  // a B panel row: two halves of 16
constexpr int kMmBRow = kMmMaxBN;      // words of a B panel row
constexpr int kMmPass = 256;           // rows of one staged store pass
constexpr int kMmMaxRuns = kMmThreads;  // runs of a staged pass
constexpr int kRawWords = 18;  // one row's window: 64 bytes + 3 of lead
enum MmPath { kTma = 0, kAsync = 1 };

struct MmArgs {
  const void* x;
  const void* w;
  void* out;
  int64_t M, N, K, ldb, col0;
  int64_t mode, W, C, s;  // the store (StoreMode; pixel shuffle geometry)
  int n_chunks;              // K steps of kMmChunk bytes
  int n_ntiles;              // column tiles
  int n_tiles;               // row tiles x column tiles
  int kb;                    // rows of the B slab in shared memory
  int path;
  // shared-memory layout, byte offsets from the 1024-aligned base (the
  // ring of A stages sits at 0)
  uint32_t off_bars, off_runs, off_cols, off_stage, off_b;
};

// the 4 bytes at src, of which only the first `n` (1-4) are read; the rest
// of the word is zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// Byte offset of 16-byte unit q (0-3) of row r in a stage: TMA's 64-byte
// swizzle (address bits 4-5 ^= bits 7-8), so that 8 consecutive rows read
// at one q hit 8 different bank groups.
__device__ __forceinline__ uint32_t swz(int r, int q) {
  return static_cast<uint32_t>(r * kMmChunk + ((q ^ ((r >> 1) & 3)) << 4));
}

// One B panel row of a thread's BN / 2 columns into registers (16-byte
// loads, a last pair as 8 bytes).
template <typename A, int TN>
__device__ __forceinline__ void load_brow(A (&bv)[TN], const A* b) {
#pragma unroll
  for (int j = 0; j < TN; j += 4) {
    if (j + 4 <= TN) {
      const uint4 w = *reinterpret_cast<const uint4*>(b + j);
      bv[j] = from_word<A>(w.x);
      bv[j + 1] = from_word<A>(w.y);
      bv[j + 2] = from_word<A>(w.z);
      bv[j + 3] = from_word<A>(w.w);
    } else {
      const uint2 w = *reinterpret_cast<const uint2*>(b + j);
      bv[j] = from_word<A>(w.x);
      bv[j + 1] = from_word<A>(w.y);
    }
  }
}

// The products of one 32-bit word of A per row (2 or 4 k of a narrow type)
// with the B panel rows from b on: acc[i][j] += A(row i, k) B(k, j), k
// ascending.
template <typename T, int TN>
__device__ __forceinline__ void word_step(
    typename Acc<T>::type (&acc)[kMmTM][TN], const uint32_t (&aw)[kMmTM],
    const typename Acc<T>::type* b) {
  using AccT = typename Acc<T>::type;
  constexpr int kPerWord = 4 / sizeof(T);
#pragma unroll
  for (int e = 0; e < kPerWord; ++e) {
    AccT ai[kMmTM], bv[TN];
#pragma unroll
    for (int i = 0; i < kMmTM; ++i) ai[i] = elem<T>(aw[i], e);
    load_brow<AccT, TN>(bv, b + e * kMmBRow);
#pragma unroll
    for (int i = 0; i < kMmTM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = mac(ai[i], bv[j], acc[i][j]);
    }
  }
}

// Item j of a block: its (j / n_chunks)-th tile's first row, and the byte
// offset in a row of its chunk j % n_chunks.
__device__ __forceinline__ int64_t item_row(const MmArgs& a, int j) {
  const int tile = blockIdx.x + (j / a.n_chunks) * gridDim.x;
  return static_cast<int64_t>(tile / a.n_ntiles) * kMmBM;
}

// The k of one stage for 4-byte types, software-pipelined: the B row of
// k + 1 and the A rows of the next 16 bytes are loaded while the FMAs of k
// run, so that the FMAs seldom wait on a shared-memory load.
template <typename T, int TN>
__device__ __forceinline__ void chunk_wide(
    typename Acc<T>::type (&acc)[kMmTM][TN], const uint8_t* as, int rt,
    const typename Acc<T>::type* brow) {
  using AccT = typename Acc<T>::type;
  constexpr int kK = kMmChunk / 4;
  uint4 av[2][kMmTM];
#pragma unroll
  for (int i = 0; i < kMmTM; ++i) {
    av[0][i] = *reinterpret_cast<const uint4*>(as + swz(rt + i * kMmRowThreads, 0));
  }
  AccT bc[TN], bn[TN];
  load_brow<AccT, TN>(bc, brow);
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (k + 1 < kK) load_brow<AccT, TN>(bn, brow + (k + 1) * kMmBRow);
    if (k % 4 == 1 && k / 4 + 1 < kMmChunk / 16) {
#pragma unroll
      for (int i = 0; i < kMmTM; ++i) {
        av[(k / 4 + 1) % 2][i] = *reinterpret_cast<const uint4*>(
            as + swz(rt + i * kMmRowThreads, k / 4 + 1));
      }
    }
    AccT ai[kMmTM];
#pragma unroll
    for (int i = 0; i < kMmTM; ++i) {
      ai[i] = from_word<AccT>(word(av[(k / 4) % 2][i], k % 4));
    }
#pragma unroll
    for (int i = 0; i < kMmTM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = mac(ai[i], bc[j], acc[i][j]);
    }
    if (k + 1 < kK) {
#pragma unroll
      for (int j = 0; j < TN; ++j) bc[j] = bn[j];
    }
  }
}

// The cp.async path, for a row pitch that TMA cannot take.  Copy: thread t
// copies the 4-byte words that cover the 32 bytes of item j's chunk in rows
// t, t + 256, ... into each row's window of window set j % kMmWinSets.
template <typename T>
__device__ void copy_windows(const MmArgs& a, uint32_t win_s, int j) {
  const uintptr_t xb = reinterpret_cast<uintptr_t>(a.x);
  const int64_t pitch = a.K * static_cast<int64_t>(sizeof(T));
  const uintptr_t xend = xb + static_cast<uintptr_t>(a.M * pitch);
  const int64_t m0 = item_row(a, j);
  const int64_t cb = static_cast<int64_t>(j % a.n_chunks) * kMmChunk;
  const int len = static_cast<int>(pitch - cb < kMmChunk ? pitch - cb
                                                          : kMmChunk);
  for (int r = threadIdx.x; r < kMmBM; r += kMmThreads) {
    const int64_t m = m0 + r;
    if (m >= a.M) break;
    const uintptr_t start = xb + static_cast<uintptr_t>(m * pitch + cb);
    const uintptr_t w0 = start & ~static_cast<uintptr_t>(3);
    const int nw = static_cast<int>((start + len - w0 + 3) >> 2);
    const uint32_t dst =
        win_s + 4 * (((j % kMmWinSets) * kMmBM + r) * kRawWords);
    for (int k = 0; k < nw; ++k) {
      const uintptr_t src = w0 + 4 * k;
      const uintptr_t left = xend - src;
      cp_async4(dst + 4 * k, reinterpret_cast<const void*>(src),
                left < 4 ? static_cast<uint32_t>(left) : 4u);
    }
  }
}

// Unpack: funnel-shift each row's window of item j into the swizzled stage,
// zero past the row's end and past M.
template <typename T>
__device__ void unpack_windows(const MmArgs& a, const uint32_t* win,
                               uint8_t* stage, int j) {
  const uintptr_t xb = reinterpret_cast<uintptr_t>(a.x);
  const int64_t pitch = a.K * static_cast<int64_t>(sizeof(T));
  const int64_t m0 = item_row(a, j);
  const int64_t cb = static_cast<int64_t>(j % a.n_chunks) * kMmChunk;
  const int len = static_cast<int>(pitch - cb < kMmChunk ? pitch - cb
                                                          : kMmChunk);
  for (int r = threadIdx.x; r < kMmBM; r += kMmThreads) {
    const int64_t m = m0 + r;
    const bool valid = m < a.M;
    const uint32_t* wb = win + ((j % kMmWinSets) * kMmBM + r) * kRawWords;
    const uint32_t sh =
        valid ? 8 * static_cast<uint32_t>(
                        (xb + static_cast<uintptr_t>(m * pitch + cb)) & 3)
              : 0;
#pragma unroll
    for (int q = 0; q < kMmChunk / 16; ++q) {
      uint32_t o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = 4 * q + u;
        uint32_t v = valid ? __funnelshift_r(wb[k], wb[k + 1], sh) : 0u;
        const int rest = len - 4 * k;  // bytes of the row in this word
        if (rest <= 0) v = 0;
        else if (rest < 4) v &= (1u << (8 * rest)) - 1;
        o[u] = v;
      }
      *reinterpret_cast<uint4*>(stage + swz(r, q)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// Rows [k0, k0 + kb) of the column tile's B panel, widened, zero past K and
// past N, into shared memory: row k holds the two halves of BN / 2 columns
// at 0 and kMmHalf; many loads in flight per thread.
template <typename T, int BN>
__device__ void load_b(const MmArgs& a, typename Acc<T>::type* bp, int n0,
                       int k0) {
  using AccT = typename Acc<T>::type;
  constexpr int kU = 16, TN = BN / 2;
  const T* w = static_cast<const T*>(a.w);
  const int total = a.kb * kMmBRow;
  for (int e0 = threadIdx.x; e0 < total; e0 += kU * kMmThreads) {
    AccT v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kMmThreads;
      const int slot = e % kMmBRow, j = slot % kMmHalf;
      const int64_t k = k0 + e / kMmBRow;
      const int64_t n = n0 + (slot / kMmHalf) * TN + j;
      v[u] = 0;
      if (e < total && j < TN && k < a.K && n < a.N) {
        v[u] = widen(w[k * a.ldb + a.col0 + n]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kMmThreads;
      if (e < total) bp[e] = v[u];
    }
  }
}

// The store of one tile: rows [m0, m0 + kMmBM) x columns [n0, n0 + nb), in
// passes of kMmPass rows (thread t holds rows t % 128 and t % 128 + 128 of
// each, columns (t / 128) BN / 2 on).  A pass is cut into runs, each
// contiguous in out; run i is staged at shared element run_s[i], congruent
// to its start in out modulo the 16-byte vector, so that the copy-out moves
// whole aligned vectors and only a run's two ends go element by element.
template <typename T, int BN>
__device__ __forceinline__ void store_tile(
    const MmArgs& a, const typename Acc<T>::type (&acc)[kMmTM][BN / 2],
    int64_t m0, int n0, int nb, uint8_t* smem) {
  constexpr int kVec = 16 / sizeof(T), TN = BN / 2;
  constexpr int kRowsPer = kMmPass / kMmRowThreads;  // a thread's rows in a pass
  T* out = static_cast<T*>(a.out);
  T* sb = reinterpret_cast<T*>(smem + a.off_stage);
  int64_t* run_g = reinterpret_cast<int64_t*>(smem + a.off_runs);
  int* run_len = reinterpret_cast<int*>(run_g + kMmMaxRuns);
  int* run_s = run_len + kMmMaxRuns;
  const int* col_dy = reinterpret_cast<const int*>(smem + a.off_cols);
  const int* col_pos = col_dy + kMmMaxBN;
  const int t = threadIdx.x, rt = t % kMmRowThreads;
  const int c0 = (t / kMmRowThreads) * TN;  // this thread's first column
  const int64_t N = a.N, W = a.W, s = a.s, C = a.C;
#pragma unroll 1
  for (int p = 0; p < kMmBM / kMmPass; ++p) {
    const int64_t ma = m0 + p * kMmPass;
    if (ma >= a.M) break;
    const int R = static_cast<int>(a.M - ma < kMmPass ? a.M - ma : kMmPass);
    // this pass's rows of the accumulators, rounded to T
    T v[kRowsPer][TN];
#pragma unroll
    for (int pp = 0; pp < kMmBM / kMmPass; ++pp) {
      if (pp != p) continue;
#pragma unroll
      for (int ii = 0; ii < kRowsPer; ++ii) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          v[ii][j] = narrow<T>(acc[kRowsPer * pp + ii][j]);
        }
      }
    }
    int n_runs, maxlen;
    int64_t y0 = 0;
    if (a.mode == kIdentity) {
      n_runs = nb == N ? 1 : R;
      maxlen = nb == N ? R * nb : nb;
    } else if (a.mode == kTranspose) {
      n_runs = nb;
      maxlen = R;
    } else if (nb == N) {
      y0 = ma / W;
      n_runs = static_cast<int>((ma + R - 1) / W - y0 + 1) * static_cast<int>(s);
      maxlen = static_cast<int>((R < W ? R : W) * s * C);
    } else {
      n_runs = kMmMaxRuns + 1;  // a column-tiled shuffle has no long runs
      maxlen = 0;
    }
    if (n_runs > kMmMaxRuns) {  // element by element, straight from registers
#pragma unroll
      for (int ii = 0; ii < kRowsPer; ++ii) {
        const int lr = rt + ii * kMmRowThreads;
        if (lr >= R) continue;
        const int64_t m = ma + lr, y = m / W, x = m - y * W;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if (c0 + j >= nb) continue;
          const int64_t n = n0 + c0 + j, ch = n / (s * s), r = n - ch * s * s;
          const int64_t dy = r / s, dx = r - dy * s;
          out[((y * s + dy) * (W * s) + x * s + dx) * C + ch] = v[ii][j];
        }
      }
      continue;
    }
    __syncthreads();  // the last copy-out is done with the staging area
    if (t < n_runs) {
      int64_t g, e;
      int len;
      if (a.mode == kIdentity && nb == N) {
        g = ma * N, len = R * nb, e = 0;
      } else if (a.mode == kIdentity) {
        g = (ma + t) * N + n0, len = nb, e = static_cast<int64_t>(t) * nb;
      } else if (a.mode == kTranspose) {
        g = (n0 + t) * a.M + ma, len = R, e = static_cast<int64_t>(t) * R;
      } else {  // one image row's pixels of the pass, one dy
        const int64_t seg = t / s, dy = t - seg * s, y = y0 + seg;
        const int64_t ps = ma > y * W ? ma : y * W;
        const int64_t pe = ma + R < (y + 1) * W ? ma + R : (y + 1) * W;
        len = static_cast<int>((pe - ps) * s * C);
        g = ((y * s + dy) * W * s + (ps - y * W) * s) * C;
        e = (ps - ma) * N + dy * len;
      }
      run_g[t] = g;
      run_len[t] = len;
      run_s[t] = static_cast<int>(kVec * (e / kVec + 2 * t) + g % kVec);
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < kRowsPer; ++ii) {
      const int lr = rt + ii * kMmRowThreads;
      if (lr >= R) continue;
      // element (lr, col) of the pass goes to sb[base + col step] for the
      // identity stores, to sb[run_s[col] + lr] for the transpose, and for
      // the shuffle to its run (image row, dy) at (x - x0) s C + dx C + ch
      int base = 0, step = 1;
      const int* rs = run_s;
      if (a.mode == kPixelShuffle) {
        const int64_t m = ma + lr, y = m / W, x = m - y * W;
        const int64_t xs = (ma > y * W ? ma : y * W) - y * W;
        rs = run_s + (y - y0) * s;
        base = static_cast<int>((x - xs) * s * C);
      } else if (a.mode == kTranspose) {
        base = lr, step = 0;
      } else {
        base = nb == N ? run_s[0] + lr * nb : run_s[lr];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = c0 + j;
        if (col >= nb) continue;
        const int idx = a.mode == kPixelShuffle ? rs[col_dy[col]] + base + col_pos[col]
                        : step ? base + col : run_s[col] + base;
        sb[idx] = v[ii][j];
      }
    }
    __syncthreads();
    const int slots = (maxlen + kVec - 1) / kVec + 1;
    for (int q = t; q < n_runs * slots; q += kMmThreads) {
      const int i = q / slots, qi = q - i * slots;
      const int64_t g = run_g[i];
      const int len = run_len[i], s0 = run_s[i];
      const int e0 = qi * kVec - static_cast<int>(g % kVec);
      if (e0 >= len) continue;
      if (e0 >= 0 && e0 + kVec <= len) {
        *reinterpret_cast<uint4*>(out + g + e0) =
            *reinterpret_cast<const uint4*>(sb + s0 + e0);
      } else {
        for (int e = e0 < 0 ? 0 : e0; e < e0 + kVec && e < len; ++e) {
          out[g + e] = sb[s0 + e];
        }
      }
    }
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kMmThreads, 1)
mm_tm_kernel(const __grid_constant__ CUtensorMap amap,
             const __grid_constant__ MmArgs a) {
  using AccT = typename Acc<T>::type;
  constexpr int kc = kMmChunk / sizeof(T);  // k per stage
  constexpr int kPerWord = 4 / sizeof(T);
  constexpr int TN = BN / 2;                // columns per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = ring + a.off_bars;
  const int t = threadIdx.x, rt = t % kMmRowThreads;
  const int half = t / kMmRowThreads;
  const bool tma = a.path == kTma;
  if (t == 0 && tma) {
    for (int st = 0; st < kMmStages; ++st) mbar_init(full0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (a.mode == kPixelShuffle) {  // per column: its dy and place in a run
    int* col_dy = reinterpret_cast<int*>(smem + a.off_cols);
    for (int j = t; j < kMmMaxBN; j += kMmThreads) {
      const int64_t s = a.s, ch = j / (s * s), r = j - ch * s * s;
      col_dy[j] = static_cast<int>(r / s);
      col_dy[kMmMaxBN + j] = static_cast<int>((r % s) * a.C + ch);
    }
  }
  __syncthreads();

  // The items (tile, chunk) this block streams, in order.  TMA: thread 0
  // keeps kMmStages of them in flight, refilling a stage once every thread
  // is done with it.  cp.async: every thread copies its rows' windows
  // kMmWinSets items ahead and unpacks them into stage 0 just before use;
  // the window sets lie in the ring's stages 1 on.
  const int n_items = ((a.n_tiles - 1 - static_cast<int>(blockIdx.x)) /
                           static_cast<int>(gridDim.x) + 1) * a.n_chunks;
  uint32_t* win = reinterpret_cast<uint32_t*>(smem + kMmStageBytes);
  auto issue = [&](int j) {
    const int st = j % kMmStages;
    const int row = static_cast<int>(item_row(a, j));
    mbar_expect_tx(full0 + 8 * st, kMmStageBytes);
#pragma unroll
    for (int bx = 0; bx < kMmBM / kMmBox; ++bx) {
      tma_load_2d(ring + st * kMmStageBytes + bx * kMmBox * kMmChunk, &amap,
                  full0 + 8 * st, (j % a.n_chunks) * kc, row + bx * kMmBox);
    }
  };
  if (tma) {
    if (t == 0) {
      for (int j = 0; j < kMmStages && j < n_items; ++j) issue(j);
    }
  } else {
    for (int j = 0; j < kMmWinSets; ++j) {
      if (j < n_items) copy_windows<T>(a, smem_u32(win), j);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
  }

  AccT* bp = reinterpret_cast<AccT*>(smem + a.off_b);
  int it = 0;
  int b_n0 = -1, b_k0 = 0;  // the B slab in shared memory
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int64_t m0 = static_cast<int64_t>(tile / a.n_ntiles) * kMmBM;
    const int n0 = (tile % a.n_ntiles) * BN;
    const int nb = static_cast<int>(a.N - n0 < BN ? a.N - n0 : BN);
    AccT acc[kMmTM][TN];
#pragma unroll
    for (int i = 0; i < kMmTM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0;
    }
    for (int c = 0; c < a.n_chunks; ++c, ++it) {
      const int k0 = c * kc;
      if (n0 != b_n0 || k0 < b_k0 || k0 >= b_k0 + a.kb) {
        __syncthreads();  // nobody reads the old slab any more
        load_b<T, BN>(a, bp, n0, k0);
        __syncthreads();
        b_n0 = n0;
        b_k0 = k0;
      }
      const int st = tma ? it % kMmStages : 0;
      if (tma) {
        mbar_wait(full0 + 8 * st, (it / kMmStages) & 1);
      } else {
        asm volatile("cp.async.wait_group %0;" ::"n"(kMmWinSets - 1)
                     : "memory");
        __syncthreads();  // every thread's windows of item it have landed
        unpack_windows<T>(a, win, smem, it);
        __syncthreads();
        if (it + kMmWinSets < n_items)
          copy_windows<T>(a, smem_u32(win), it + kMmWinSets);
        asm volatile("cp.async.commit_group;" ::: "memory");
      }
      const uint8_t* as = smem + st * kMmStageBytes;
      const AccT* brow = bp + (k0 - b_k0) * kMmBRow + half * kMmHalf;
      if constexpr (sizeof(T) == 4) {
        chunk_wide<T, TN>(acc, as, rt, brow);
      } else {
        // one 32-bit word of each row at a time (2 or 4 k), a loop
#pragma unroll 1
        for (int q = 0; q < kMmChunk / 16; ++q) {
          uint4 av[kMmTM];
#pragma unroll
          for (int i = 0; i < kMmTM; ++i) {
            av[i] = *reinterpret_cast<const uint4*>(
                as + swz(rt + i * kMmRowThreads, q));
          }
          const AccT* bq = brow + q * 4 * kPerWord * kMmBRow;
#pragma unroll 1
          for (int wi = 0; wi < 4; ++wi) {
            uint32_t aw[kMmTM];
#pragma unroll
            for (int i = 0; i < kMmTM; ++i) aw[i] = word(av[i], wi);
            word_step<T, TN>(acc, aw, bq + wi * kPerWord * kMmBRow);
          }
        }
      }
      __syncthreads();  // every thread is done with stage st
      if (tma && t == 0 && it + kMmStages < n_items) {
        // the threads' reads of the stage before TMA's write of it
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue(it + kMmStages);
      }
    }
    store_tile<T, BN>(a, acc, m0, n0, nb, smem);
  }
}

// x (M, K) in boxes of kMmBox rows x 64 bytes, 64-byte swizzle, zero fill
template <typename T>
bool a_tensor_map(CUtensorMap* map, const MmArgs& a) {
  const igemm::EncodeTiledFn encode = igemm::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.K),
                              static_cast<cuuint64_t>(a.M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.K) * sizeof(T)};
  const cuuint32_t box[2] = {kMmChunk / sizeof(T), kMmBox};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, tma_type<T>(), 2, const_cast<void*>(a.x), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Shared-memory layout of one block (one per SM: 256 threads, so that each
// may hold 255 registers, its 112 accumulators and 8 rows of A among them)
// and its launch: the B slab takes what the ring and the staging area
// leave.
template <typename T, int BN>
int launch_mm(MmArgs a, cudaStream_t s) {
  using AccT = typename Acc<T>::type;
  constexpr int kc = kMmChunk / sizeof(T);
  constexpr int kVec = 16 / sizeof(T);
  constexpr size_t kBudget = 227 * 1024;  // a block's most
  size_t off = static_cast<size_t>(kMmStages) * kMmStageBytes;
  a.off_bars = static_cast<uint32_t>(off);
  off += 16 * kMmStages;
  static_assert(kMmWinSets * kMmBM * kRawWords * 4 <=
                    (kMmStages - 1) * kMmStageBytes,
                "the cp.async windows live in the ring's stages 1 on");
  a.off_runs = align_up(off, 16);
  off = a.off_runs + kMmMaxRuns * (8 + 4 + 4);
  a.off_cols = static_cast<uint32_t>(off);
  off += 2 * kMmMaxBN * 4;
  a.off_stage = align_up(off, 16);
  off = a.off_stage + align_up(
      (kMmPass * BN + kVec * (2 * kMmMaxRuns + 1)) * sizeof(T), 16);
  a.off_b = static_cast<uint32_t>(off);
  const int64_t k_pad = (a.K + kc - 1) / kc * kc;
  const int64_t fit = static_cast<int64_t>(kBudget - 1024 - off) /
                      (kMmBRow * sizeof(AccT)) / kc * kc;
  if (fit < kc) return static_cast<int>(cudaErrorInvalidValue);
  a.kb = static_cast<int>(k_pad > 0 && k_pad < fit ? k_pad : fit);
  const size_t smem =
      off + static_cast<size_t>(a.kb) * kMmBRow * sizeof(AccT) + 1024;

  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (a.path == kTma && !a_tensor_map<T>(&map, a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = mm_tm_kernel<T, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kMmThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = a.n_tiles < blocks ? a.n_tiles : blocks;
  kernel<<<grid, kMmThreads, smem, s>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_mm(const MmArgs& a, int bn, cudaStream_t s) {
  switch (bn) {
#define MM_CASE(b) \
  case b: return launch_mm<T, b>(a, s);
    MM_CASE(4) MM_CASE(8) MM_CASE(12) MM_CASE(16) MM_CASE(20) MM_CASE(24)
    MM_CASE(28) MM_CASE(32)
#undef MM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
}  // namespace

// x (M, K) @ w[:, col0:col0+N] of w (K, ldb), stored through `mode` into
// out (16-byte aligned).  `path` (kTma or kAsync) and `bn` are the host's
// plan (kernels/matmul_tm/matmul_tm.py: mm_plan): TMA needs a row pitch
// K sizeof(T) that is a multiple of 16 bytes and x 16-byte aligned; bn is
// N rounded up to a multiple of 4 when N <= 32, else 32.
extern "C" int matmul_tm(const void* x, const void* w, void* out, int dtype,
                         int64_t M, int64_t N, int64_t K, int64_t ldb,
                         int64_t col0, int mode, int64_t H, int64_t W,
                         int64_t C, int64_t s, int path, int bn,
                         void* stream) {
  const int64_t size = dtype == chain::kInt8 ? 1 : dtype == chain::kBf16 ? 2
                                                                       : 4;
  const int64_t want_bn = N <= kMmMaxBN ? (N + 3) / 4 * 4 : kMmMaxBN;
  const int64_t n_ntiles = (N + want_bn - 1) / want_bn;
  const int64_t n_tiles = (M + kMmBM - 1) / kMmBM * n_ntiles;
  if (M <= 0 || N <= 0 || K < 0 || mode < kIdentity || mode > kPixelShuffle ||
      (path != kTma && path != kAsync) || bn != want_bn ||
      M >= (int64_t{1} << 31) || n_tiles >= (int64_t{1} << 31) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (mode == kPixelShuffle && (W <= 0 || s <= 0 || C <= 0)) ||
      (path == kTma && (K < 1 || (K * size) % 16 != 0 ||
                        reinterpret_cast<uintptr_t>(x) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MmArgs a = {};
  a.x = x;
  a.w = w;
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.ldb = ldb;
  a.col0 = col0;
  a.mode = mode;
  a.W = W;
  a.C = C;
  a.s = s;
  a.n_chunks = static_cast<int>((K * size + kMmChunk - 1) / kMmChunk);
  a.n_ntiles = static_cast<int>(n_ntiles);
  a.n_tiles = static_cast<int>(n_tiles);
  a.path = path;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case chain::kInt8: return dispatch_mm<int8_t>(a, bn, st);
    case chain::kInt32: return dispatch_mm<int32_t>(a, bn, st);
    case chain::kBf16: return dispatch_mm<__nv_bfloat16>(a, bn, st);
    case chain::kF32: return dispatch_mm<float>(a, bn, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
