// Cross-engine kernels for Hopper (sm_90a): a product with a data-movement
// store or load around it, in ONE launch each.
//
// Replaces three Pallas kernels of the JAX package:
//   matmul_tm       src/repro/kernels/matmul_tm/matmul_tm.py: matmul_tm
//                   (body _mm_kernel): a tiled x @ w whose store writes each
//                   tile to its TM destination (identity, transpose, pixel
//                   shuffle, a split band);
//   xchain_commit   src/repro/kernels/matmul_tm/chain.py: _commit_executable:
//                   a 2D product or an NHWC conv feeding a forwarding chain
//                   (compute -> TM), the product never stored;
//   xchain_prologue src/repro/kernels/matmul_tm/chain.py:
//                   _prologue_executable: a forwarding chain feeding one
//                   operand of a 2D product or an NHWC conv (TM -> compute),
//                   the chain's output never stored.
//
// The product is an implicit GEMM, out[m, n] = sum_k A(m, k) B(k, n):
//   mm    A(m, k) = x[m K + k], B(k, n) = w[k ldb + col0 + n];
//   conv  m = (b, oh, ow), k = (ky, kx, ci) (the img2col column order),
//         A(m, k) = x[b, oh s + ky - pt, ow s + kx - pl, ci] (0 outside x),
//         B(k, n) = w[k N + n] (HWIO weights flattened), out NHWC.
// Floats accumulate in f32 (bf16 inputs widened) and round to the element
// type once, as _mm_kernel's f32 accumulator cast at commit; integers
// accumulate in uint32, which wraps, and truncate to the element type: the
// exact sum modulo 2^bits, what an integer dot_general or mm gives.
//
// Summation order, on which the float tolerance depends: every output sums
// its K products one at a time in ascending k with fmaf (conv: ky, then kx,
// then ci; a tap outside x contributes nothing).  Two evaluations in other
// orders lie within 2 gamma_K sum |A B| of each other
// (core/fp_bounds.py).
//
// Bounds on an H100: matmul_tm and xchain_prologue by operations (2 M N K
// f32 operations over 67 TFLOP/s outside the tensor cores) or bytes,
// whichever is larger; xchain_commit the same.  These are simple kernels:
//   matmul_tm, xchain_prologue — a 64x64 output tile per block of 256
//   threads, 4x4 outputs per thread, the K loop in steps of 16 staged in
//   shared memory (the Hopper counterpart of the VMEM operand blocks).
//   The prologue loads its crossing operand's tile THROUGH the chain's
//   pullback (chain_desc.cuh) from the chain's sources: the tile staged in
//   shared memory is the chain's output, which never reaches device memory.
//   xchain_commit — driven from the chain's output side, so that it needs
//   no grid-wide barrier: each thread takes one output element, follows
//   the chain's pullback j to the product element it reads, computes that
//   element's K-term sum in place, and walks the chain's levels.  A COARSE
//   chain reads each product element at most a few times, so the
//   recomputation is bounded; an element some level masks out skips the
//   product (its fill overwrites it).
// wgmma, TMA and a product tile shared by the elements that read it are
// later work.
//
// Element types: int8, int32, bf16, f32.  Each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_desc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;  // output tile rows
constexpr int kBN = 64;  // output tile columns
constexpr int kBK = 16;  // K step staged in shared memory
constexpr int kTM = 4;   // outputs per thread along m
constexpr int kTN = 4;   // outputs per thread along n

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

// ---------------------------------------------------------------------------
// the product's geometry
// ---------------------------------------------------------------------------

struct Gemm {
  int64_t kind;  // 0: mm, 1: NHWC conv with HWIO weights
  int64_t M, N, K;
  int64_t ldb, col0;  // B(k, n) = w[k ldb + col0 + n]
  int64_t B, H, W, C, OH, OW, kh, kw, stride, pt, pl;  // conv only
};
constexpr int kGemmWords = 17;

// Flat index of A(m, k) in x, or -1 for a conv tap outside x.
__device__ __forceinline__ int64_t a_index(const Gemm& g, int64_t m,
                                           int64_t k) {
  if (g.kind == 0) return m * g.K + k;
  const int64_t ow = m % g.OW;
  const int64_t t = m / g.OW;
  const int64_t oh = t % g.OH;
  const int64_t b = t / g.OH;
  const int64_t ci = k % g.C;
  const int64_t tap = k / g.C;
  const int64_t ih = oh * g.stride + tap / g.kw - g.pt;
  const int64_t iw = ow * g.stride + tap % g.kw - g.pl;
  if (ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return -1;
  return ((b * g.H + ih) * g.W + iw) * g.C + ci;
}

// out[m, n] in place: K products summed in ascending k (xchain_commit).
template <typename T>
__device__ typename Acc<T>::type product(const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         const Gemm& g, int64_t m,
                                         int64_t n) {
  typename Acc<T>::type acc = 0;
  if (g.kind == 0) {
    const T* xr = x + m * g.K;
    const T* wc = w + g.col0 + n;
    for (int64_t k = 0; k < g.K; ++k) {
      acc = mac(widen(xr[k]), widen(wc[k * g.ldb]), acc);
    }
    return acc;
  }
  const int64_t ow = m % g.OW;
  const int64_t t = m / g.OW;
  const int64_t oh = t % g.OH;
  const int64_t b = t / g.OH;
  for (int64_t ky = 0; ky < g.kh; ++ky) {
    const int64_t ih = oh * g.stride + ky - g.pt;
    if (ih < 0 || ih >= g.H) continue;
    for (int64_t kx = 0; kx < g.kw; ++kx) {
      const int64_t iw = ow * g.stride + kx - g.pl;
      if (iw < 0 || iw >= g.W) continue;
      const T* xp = x + ((b * g.H + ih) * g.W + iw) * g.C;
      const T* wp = w + (ky * g.kw + kx) * g.C * g.ldb + g.col0 + n;
      for (int64_t ci = 0; ci < g.C; ++ci) {
        acc = mac(widen(xp[ci]), widen(wp[ci * g.ldb]), acc);
      }
    }
  }
  return acc;
}

// ---------------------------------------------------------------------------
// xchain_commit: one thread per chain output element
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
commit_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ out, const __grid_constant__ chain::Chain c,
              const __grid_constant__ Gemm g, int64_t numel) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < numel; i += stride) {
    T v = chain::from_bits<T>(0);
    if (chain::source_needed(c, i)) {
      const int64_t f = c.j[i];  // the product element this output reads
      v = narrow<T>(product<T>(x, w, g, f / g.N, f % g.N));
    }
    out[i] = chain::apply<T>(c, v, i);
  }
}

// ---------------------------------------------------------------------------
// tiled product: matmul_tm (direct operands, a TM store) and
// xchain_prologue (one operand loaded through the chain, a plain store)
// ---------------------------------------------------------------------------

enum Src { kDirect = 0, kChainA = 1, kChainB = 2 };
enum StoreMode { kIdentity = 0, kTranspose = 1, kPixelShuffle = 2 };

struct Store {
  int64_t mode;
  int64_t H, W, C, s;  // pixel shuffle: rows are the H x W pixels in raster
                       // order, columns the C s^2 channels, c-major
};

// Where out[m, n] lands.  Transpose: out (N, M).  Pixel shuffle: m = y W +
// x, n = ch s^2 + dy s + dx -> (y s + dy, x s + dx, ch) of (H s, W s, C).
__device__ __forceinline__ int64_t store_index(const Store& st,
                                               const Gemm& g, int64_t m,
                                               int64_t n) {
  if (st.mode == kTranspose) return n * g.M + m;
  if (st.mode == kPixelShuffle) {
    const int64_t y = m / st.W, x = m % st.W;
    const int64_t ch = n / (st.s * st.s), r = n % (st.s * st.s);
    const int64_t dy = r / st.s, dx = r % st.s;
    return ((y * st.s + dy) * (st.W * st.s) + x * st.s + dx) * st.C + ch;
  }
  return m * g.N + n;
}

template <typename T, int kSrc>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T* __restrict__ xa, const T* __restrict__ wb,
            T* __restrict__ out, const __grid_constant__ chain::Chain c,
            const __grid_constant__ Gemm g, const __grid_constant__ Store st) {
  using A = typename Acc<T>::type;
  __shared__ A As[kBK][kBM];
  __shared__ A Bs[kBK][kBN];
  const int t = threadIdx.x;
  const int ty = t / (kBN / kTN), tx = t % (kBN / kTN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  A acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;
  }
  for (int64_t k0 = 0; k0 < g.K; k0 += kBK) {
    // stage the A tile (kBM x kBK) and the B tile (kBK x kBN); neighbouring
    // threads take neighbouring k (A) and n (B), the operands' minor axes
#pragma unroll
    for (int l = 0; l < kBM * kBK / kThreads; ++l) {
      const int e = t + l * kThreads;
      const int r = e / kBK, kk = e % kBK;
      const int64_t m = m0 + r, k = k0 + kk;
      A v = 0;
      if (m < g.M && k < g.K) {
        const int64_t ai = a_index(g, m, k);
        if (ai >= 0) {
          v = widen(kSrc == kChainA ? chain::eval<T>(xa, c, ai) : xa[ai]);
        }
      }
      As[kk][r] = v;
    }
#pragma unroll
    for (int l = 0; l < kBK * kBN / kThreads; ++l) {
      const int e = t + l * kThreads;
      const int kk = e / kBN, cc = e % kBN;
      const int64_t k = k0 + kk, n = n0 + cc;
      A v = 0;
      if (k < g.K && n < g.N) {
        const int64_t bi = k * g.ldb + g.col0 + n;
        v = widen(kSrc == kChainB ? chain::eval<T>(wb, c, bi) : wb[bi]);
      }
      Bs[kk][cc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      A a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + i * (kBM / kTM)];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tx + j * (kBN / kTN)];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = mac(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t m = m0 + ty + i * (kBM / kTM);
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t n = n0 + tx + j * (kBN / kTN);
      if (n < g.N) out[store_index(st, g, m, n)] = narrow<T>(acc[i][j]);
    }
  }
}

inline unsigned grid_for(int64_t numel) {
  const int64_t blocks = (numel + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // enough blocks in flight; the loop strides
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

bool parse_gemm(const int64_t* words, Gemm* g) {
  int64_t* dst = reinterpret_cast<int64_t*>(g);
  for (int i = 0; i < kGemmWords; ++i) dst[i] = words[i];
  return g->M > 0 && g->N > 0 && g->K >= 0 && (g->kind == 0 || g->kind == 1);
}

template <typename T, int kSrc>
void launch_gemm(const void* xa, const void* wb, void* out,
                 const chain::Chain& c, const Gemm& g, const Store& st,
                 cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((g.N + kBN - 1) / kBN),
                  static_cast<unsigned>((g.M + kBM - 1) / kBM));
  gemm_kernel<T, kSrc><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(xa), static_cast<const T*>(wb),
      static_cast<T*>(out), c, g, st);
}

template <typename T>
void launch_commit(const void* x, const void* w, void* out,
                   const chain::Chain& c, const Gemm& g, int64_t numel,
                   cudaStream_t s) {
  commit_kernel<T><<<grid_for(numel), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), c, g, numel);
}

template <int kSrc>
int dispatch_gemm(int dtype, const void* xa, const void* wb, void* out,
                  const chain::Chain& c, const Gemm& g, const Store& st,
                  cudaStream_t s) {
  switch (dtype) {
    case chain::kInt8: launch_gemm<int8_t, kSrc>(xa, wb, out, c, g, st, s);
      break;
    case chain::kInt32: launch_gemm<int32_t, kSrc>(xa, wb, out, c, g, st, s);
      break;
    case chain::kBf16:
      launch_gemm<__nv_bfloat16, kSrc>(xa, wb, out, c, g, st, s);
      break;
    case chain::kF32: launch_gemm<float, kSrc>(xa, wb, out, c, g, st, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) @ w[:, col0:col0+N] of w (K, ldb), stored through `mode`.
extern "C" int matmul_tm(const void* x, const void* w, void* out, int dtype,
                         int64_t M, int64_t N, int64_t K, int64_t ldb,
                         int64_t col0, int mode, int64_t H, int64_t W,
                         int64_t C, int64_t s, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || mode < kIdentity || mode > kPixelShuffle) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Gemm g = {};
  g.kind = 0;
  g.M = M;
  g.N = N;
  g.K = K;
  g.ldb = ldb;
  g.col0 = col0;
  const Store st = {mode, H, W, C, s};
  chain::Chain c;
  memset(&c, 0, sizeof(c));
  return dispatch_gemm<kDirect>(dtype, x, w, out, c, g, st,
                                static_cast<cudaStream_t>(stream));
}

// The product of x and w (geometry in `gemm`, kGemmWords int64 words)
// through the chain in `desc` (chain_desc.cuh) into out (numel elements).
extern "C" int xchain_commit(const void* x, const void* w, void* out,
                             const int64_t* desc, const int64_t* gemm,
                             int dtype, int64_t numel, int n_levels,
                             int n_extras, void* stream) {
  chain::Chain c;
  Gemm g;
  if (numel <= 0 || !chain::parse(desc, n_levels, n_extras, &c) ||
      !parse_gemm(gemm, &g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case chain::kInt8: launch_commit<int8_t>(x, w, out, c, g, numel, s); break;
    case chain::kInt32: launch_commit<int32_t>(x, w, out, c, g, numel, s);
      break;
    case chain::kBf16:
      launch_commit<__nv_bfloat16>(x, w, out, c, g, numel, s);
      break;
    case chain::kF32: launch_commit<float>(x, w, out, c, g, numel, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The product (geometry in `gemm`) whose operand `cross_pos` (0: x, 1: w)
// is the output of the chain in `desc` over `src`; `other` is the other
// operand.  out is (M, N) row-major (mm) or NHWC (conv).
extern "C" int xchain_prologue(const void* src, const void* other, void* out,
                               const int64_t* desc, const int64_t* gemm,
                               int dtype, int cross_pos, int n_levels,
                               int n_extras, void* stream) {
  chain::Chain c;
  Gemm g;
  if (!chain::parse(desc, n_levels, n_extras, &c) || !parse_gemm(gemm, &g) ||
      (cross_pos != 0 && cross_pos != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Store st = {kIdentity, 0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cross_pos == 0
             ? dispatch_gemm<kChainA>(dtype, src, other, out, c, g, st, s)
             : dispatch_gemm<kChainB>(dtype, other, src, out, c, g, st, s);
}
