// Img2col and the implicit-GEMM convolution for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels in
// src/repro/kernels/img2col/img2col.py:
//   * img2col <- img2col (:63, slabs that do not overlap, kh == stride) and
//     _img2col_overlap (:94, overlapping slabs, e.g. 3x3 stride 1).  The two
//     Pallas sites differ only in how a BlockSpec can cut the input rows;
//     here one kernel serves both.
//   * conv2d  <- conv2d / _conv_kernel (:130): patches @ w with f32
//     accumulation, the patch matrix never written to device memory.
//
// img2col.  Output (OH*OW, kh*kw*C), column k = (ky*kw + kx)*C + c, tap
// (oy*stride + ky - pad, ox*stride + kx - pad).  It only moves data, so its
// bound is the bytes it must move (input once, output once) over HBM
// bandwidth; the output is kh*kw times the input for stride 1.  Design: in
// NHWC each output row is kh*kw runs of C contiguous elements, so the kernel
// copies in units of the widest power of two bytes (<= 16) that divides a
// run's byte length: one thread per output unit, consecutive threads on
// consecutive units (coalesced stores, reads contiguous along each run).
// Taps that fall outside the input write the map's fill, a unit-wide bit
// pattern the host builds from the element's bytes, so every dtype is
// bit-exact.  Index arithmetic is in units: 32-bit where the host proves
// every unit index fits in 31 bits (the Table III output, 458 MB, is 28.6 M
// 16-byte units), and each division by a runtime size is a multiply-high by
// a magic number the host computed.  Addresses are formed by indexing a
// typed pointer, so a byte offset never passes through 32 bits.
//
// conv2d.  out[p, oc] = sum_k patch[p, k] * w[k, oc] with M = OH*OW rows,
// N = OC columns and K = kh*kw*C, accumulated in f32 (bf16 read as f32) and
// rounded once to x's dtype at the store.  At the EDSR body conv (224x224x64
// -> 64, K = 576) it is bound by its f32 operations (2*M*N*K over 67 TFLOP/s
// without tensor cores: 0.0552 ms), not by bytes.  Design: the implicit-GEMM
// core of igemm.cuh (shared with xchain_commit.cu): persistent blocks of
// (BM / 8) x NCT threads, 8 x 8 outputs a thread at BN = 64, the patch rows
// fetched by TMA in im2col mode one filter tap at a time (cp.async where
// C sizeof(T) is not a multiple of 16 bytes or x is off 16 bytes) through
// a ring of mbarrier stages beside the weights' K rows, and the rows
// stored with 16-byte stores where N allows.  Taps outside x read zero (the
// JAX package pads with jnp.pad).  The host plan (conv_plan) picks the
// path, BM, BN, the stages and the grid; the entry point checks it.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "igemm.cuh"

namespace {

enum Dtype { kInt8 = 0, kInt32 = 1, kBf16 = 2, kF32 = 3 };

// ---------------------------------------------------------------------------
// img2col
// ---------------------------------------------------------------------------

constexpr int kCopyThreads = 256;

// Unsigned division by a runtime divisor: 32-bit multiply-high with the
// host's magic number (Granlund-Montgomery: q = (t + ((n - t) >> sh1)) >> sh2,
// t = umulhi(n, magic), exact for every n < 2^32), or plain 64-bit division.
struct Div {
  uint64_t d;
  uint32_t magic;
  uint32_t shifts;  // sh1 | sh2 << 8
};

template <bool Narrow>
__device__ __forceinline__ uint64_t divide(uint64_t n, const Div& v) {
  if constexpr (Narrow) {
    const uint32_t n32 = static_cast<uint32_t>(n);
    const uint32_t t = __umulhi(n32, v.magic);
    return (t + ((n32 - t) >> (v.shifts & 0xff))) >> (v.shifts >> 8);
  } else {
    return n / v.d;
  }
}

struct Img2colArgs {
  int64_t units;       // output units in all
  int64_t H, W;        // input rows and columns
  int64_t stride, pad;
  int64_t kw, R;       // taps per row of the kernel, units per run (C)
  Div by_R, by_taps, by_kw, by_OW;
  uint64_t fill_lo, fill_hi;  // the fill pattern, one unit wide
};

template <typename Unit>
__device__ __forceinline__ Unit fill_unit(uint64_t lo, uint64_t hi) {
  Unit u;
  if constexpr (sizeof(Unit) == 16) {
    uint64_t both[2] = {lo, hi};
    memcpy(&u, both, 16);
  } else {
    memcpy(&u, &lo, sizeof(Unit));
  }
  return u;
}

template <typename Unit, bool Narrow>
__global__ void __launch_bounds__(kCopyThreads)
img2col_kernel(const Unit* __restrict__ x, Unit* __restrict__ out,
               const Img2colArgs a) {
  using S = typename std::conditional<Narrow, int32_t, int64_t>::type;
  const Unit fill = fill_unit<Unit>(a.fill_lo, a.fill_hi);
  const uint64_t step = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       i < static_cast<uint64_t>(a.units); i += step) {
    // i -> (run, r): run -> (row p, tap): tap -> (ky, kx): p -> (oy, ox)
    const uint64_t run = divide<Narrow>(i, a.by_R);
    const uint64_t r = i - run * a.by_R.d;
    const uint64_t p = divide<Narrow>(run, a.by_taps);
    const uint64_t tap = run - p * a.by_taps.d;
    const uint64_t ky = divide<Narrow>(tap, a.by_kw);
    const uint64_t kx = tap - ky * a.by_kw.d;
    const uint64_t oy = divide<Narrow>(p, a.by_OW);
    const uint64_t ox = p - oy * a.by_OW.d;
    const S y = static_cast<S>(oy * a.stride + ky) - static_cast<S>(a.pad);
    const S xx = static_cast<S>(ox * a.stride + kx) - static_cast<S>(a.pad);
    Unit v = fill;
    if (y >= 0 && y < static_cast<S>(a.H) && xx >= 0 &&
        xx < static_cast<S>(a.W)) {
      v = x[(static_cast<S>(y) * static_cast<S>(a.W) + xx) *
                static_cast<S>(a.R) + static_cast<S>(r)];
    }
    out[i] = v;
  }
}

inline unsigned copy_grid(int64_t n) {
  const int64_t blocks = (n + kCopyThreads - 1) / kCopyThreads;
  const int64_t cap = 132 * 16;  // blocks in flight; the loop strides
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

template <typename Unit>
void launch_img2col(const void* x, void* out, const Img2colArgs& a,
                    int narrow, cudaStream_t s) {
  const Unit* xu = static_cast<const Unit*>(x);
  Unit* ou = static_cast<Unit*>(out);
  if (narrow) {
    img2col_kernel<Unit, true><<<copy_grid(a.units), kCopyThreads, 0, s>>>(
        xu, ou, a);
  } else {
    img2col_kernel<Unit, false><<<copy_grid(a.units), kCopyThreads, 0, s>>>(
        xu, ou, a);
  }
}

// ---------------------------------------------------------------------------
// conv2d: the implicit-GEMM core of igemm.cuh over one (H, W, C) image
// ---------------------------------------------------------------------------

template <typename T, int TN, int NCT>
__global__ void __launch_bounds__(igemm::kIgMaxThreads, igemm::kIgMinBlocks)
conv2d_kernel(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap bmap,
              const __grid_constant__ igemm::Args a) {
  igemm::run_tiles<T, TN, NCT>(&amap, &bmap, a, blockIdx.x);
}

template <typename T, int TN, int NCT>
int launch_conv(igemm::Args a, int path, int bm, int stages, int blocks,
                int grid, cudaStream_t s) {
  CUtensorMap map, bmap;
  size_t smem = 0;
  const void* fn = reinterpret_cast<const void*>(conv2d_kernel<T, TN, NCT>);
  const int rc = igemm::prepare<T, TN, NCT>(&a, &map, &bmap, fn, path, bm,
                                            stages, blocks, grid, &smem);
  if (rc != 0) return rc;
  conv2d_kernel<T, TN, NCT>
      <<<grid, bm / igemm::kIgRows * NCT, smem, s>>>(map, bmap, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_conv(const igemm::Args& a, int path, int bm, int bn, int nct,
                  int stages, int blocks, int grid, cudaStream_t s) {
#define CONV_CASE(tn, nct)                                               \
  case IGEMM_KEY(tn, nct):                                                   \
    return launch_conv<T, tn, nct>(a, path, bm, stages, blocks, grid, s);
  IGEMM_DISPATCH(bn, nct, CONV_CASE)
#undef CONV_CASE
}

template <typename T>
int blocks_per_sm(int bn, int nct, int threads, int smem) {
#define BLOCKS_CASE(tn, nct)                                              \
  case IGEMM_KEY(tn, nct):                                                   \
    return igemm::kernel_blocks(                                          \
        reinterpret_cast<const void*>(conv2d_kernel<T, tn, nct>), threads, \
        smem);
  IGEMM_DISPATCH(bn, nct, BLOCKS_CASE)
#undef BLOCKS_CASE
}

}  // namespace

extern "C" int img2col(const void* x, void* out, int unit_bytes,
                       int64_t units, int64_t H, int64_t W, int64_t stride,
                       int64_t pad, int64_t kw, int64_t R, int64_t taps,
                       int64_t OW, const int64_t* magics, uint64_t fill_lo,
                       uint64_t fill_hi, int narrow, void* stream) {
  // magics: (magic, shifts) of R, taps, kw and OW, in that order
  if (units <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Img2colArgs a;
  a.units = units;
  a.H = H;
  a.W = W;
  a.stride = stride;
  a.pad = pad;
  a.kw = kw;
  a.R = R;
  const int64_t divisors[4] = {R, taps, kw, OW};
  Div* divs[4] = {&a.by_R, &a.by_taps, &a.by_kw, &a.by_OW};
  for (int k = 0; k < 4; ++k) {
    divs[k]->d = static_cast<uint64_t>(divisors[k]);
    divs[k]->magic = static_cast<uint32_t>(magics[2 * k]);
    divs[k]->shifts = static_cast<uint32_t>(magics[2 * k + 1]);
  }
  a.fill_lo = fill_lo;
  a.fill_hi = fill_hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes) {
    case 1: launch_img2col<uint8_t>(x, out, a, narrow, s); break;
    case 2: launch_img2col<uint16_t>(x, out, a, narrow, s); break;
    case 4: launch_img2col<uint32_t>(x, out, a, narrow, s); break;
    case 8: launch_img2col<uint2>(x, out, a, narrow, s); break;
    case 16: launch_img2col<uint4>(x, out, a, narrow, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (H, W, C) conv w (kh, kw, C, N) -> out (OH, OW, N), through the host's
// plan (kernels/img2col/img2col.py: conv_plan): `path` (TMA im2col or
// cp.async), `bm` tile rows, `bn` tile columns over `nct` column threads,
// `stages`, the `blocks` an SM must hold and the persistent `grid`.
// `probe` 1 runs the FMA loop alone (no loads; the output is then not the
// conv).
extern "C" int conv2d(const void* x, const void* w, void* out, int dtype,
                      int H, int W, int C, int kh, int kw, int stride,
                      int pad, int OH, int OW, int N, int path, int bm,
                      int bn, int nct, int stages, int blocks, int grid,
                      int probe, void* stream) {
  // K == 0 (no input channels) is an empty sum: the kernel stores zeros
  if (OH <= 0 || OW <= 0 || N <= 0 || C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  igemm::Args a = {};
  a.g = {1, static_cast<int64_t>(OH) * OW, N, static_cast<int64_t>(kh) * kw * C,
         N, 0, 1, H, W, C, OH, OW, kh, kw, stride, pad, pad};
  a.x = x;
  a.w = w;
  a.out = out;
  a.probe = probe;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_conv<float>(a, path, bm, bn, nct, stages, blocks, grid,
                                  s);
    case kBf16:
      return dispatch_conv<__nv_bfloat16>(a, path, bm, bn, nct, stages,
                                          blocks, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks an SM holds of the conv kernel for (dtype, bn, nct) at `threads`
// threads and `smem` bytes of dynamic shared memory, or the negated CUDA
// error: the host plan's occupancy input.
extern "C" int conv2d_blocks(int dtype, int bn, int nct, int threads,
                             int smem) {
  switch (dtype) {
    case kF32: return blocks_per_sm<float>(bn, nct, threads, smem);
    case kBf16: return blocks_per_sm<__nv_bfloat16>(bn, nct, threads, smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
