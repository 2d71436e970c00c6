// The compute -> TM commit for Hopper (sm_90a): a 2D product or an NHWC
// conv feeding a forwarding chain, in ONE launch.
//
// Replaces the JAX package's Pallas kernel in
// src/repro/kernels/matmul_tm/chain.py: _commit_executable (body
// _commit_kernel), which computes the whole product once into a VMEM slab
// (ys_ref, in the element type) and then runs the chain over that slab.
//
// Bound on an H100: the product's operations (2 M N K f32 over 67
// TFLOP/s; at ESPCN's conv3 + PixelShuffle, (1, 360, 640, 32) x
// (3, 3, 32, 27), 3.58 GFLOP: 0.0535 ms), above the bytes of x, w and the
// chain's output.
//
// Design: the same two stages as the Pallas kernel, in one cooperative
// launch.
//   1. The product phase: the implicit-GEMM core of igemm.cuh (the conv
//      kernel's, img2col.cu) computes every product tile, conv or mm, and
//      rounds it once to T into a scratch (M, N) tensor the wrapper
//      allocates: ys_ref's counterpart.  At ESPCN it is 24.9 MB and stays
//      in the 50 MB L2.
//   2. A grid-wide barrier (cooperative_groups::this_grid().sync()): the
//      grid is no larger than the blocks the card holds at once, which the
//      host plan sizes and the launch checks; a grid that cannot be
//      co-resident fails to launch instead of hanging.
//   3. The chain phase: every output element i walks the chain of
//      chain_desc.cuh with the scratch as its source (j[i] the product
//      element it reads; levels, masks, fills, epilogue operands and extra
//      Route bands as the chain megakernel, tm_chain.cu, walks them), by
//      chain_walk.cuh's walk (shared with xchain_prologue.cu): eight
//      elements a thread at a time, their loads issued in rounds.  The
//      scratch is read through L2 (ld.global.cg): it was written by other
//      SMs in this launch.
// Variants that run one phase (`phases` 1: the product, then the barrier;
// 2: the barrier, then the chain over whatever the scratch holds) time the
// two phases apart.  Element types: int8, int32 (bit-exact, the sums wrap),
// bf16 and f32.  The entry point returns cudaGetLastError() after its
// launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "chain_desc.cuh"
#include "chain_walk.cuh"
#include "igemm.cuh"

namespace {

namespace cg = cooperative_groups;

template <typename T, int TN, int NCT>
__global__ void __launch_bounds__(igemm::kIgMaxThreads, igemm::kIgMinBlocks)
commit_kernel(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap bmap,
              const __grid_constant__ igemm::Args a,
              const __grid_constant__ chain::Chain c, T* __restrict__ out,
              int64_t numel, int phases) {
  if (phases & 1) {
    igemm::run_tiles<T, TN, NCT>(&amap, &bmap, a, blockIdx.x);  // to scratch
  }
  cg::this_grid().sync();
  if (!(phases & 2)) return;
  chain::walk<T>(c, static_cast<const T*>(a.out), out, numel);
}

template <typename T, int TN, int NCT>
int launch_commit(igemm::Args a, const chain::Chain& c, void* out,
                  int64_t numel, int path, int bm, int stages, int blocks,
                  int grid, int phases, cudaStream_t s) {
  CUtensorMap map, bmap;
  size_t smem = 0;
  auto kernel = commit_kernel<T, TN, NCT>;
  const int rc = igemm::prepare<T, TN, NCT>(
      &a, &map, &bmap, reinterpret_cast<const void*>(kernel), path, bm,
      stages, blocks, grid, &smem);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(bm / igemm::kIgRows * NCT));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, map, bmap, a, c,
                                             static_cast<T*>(out), numel,
                                             phases);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const igemm::Args& a, const chain::Chain& c, void* out,
             int64_t numel, int path, int bm, int bn, int nct, int stages,
             int blocks, int grid, int phases, cudaStream_t s) {
#define COMMIT_CASE(tn, nct)                                              \
  case IGEMM_KEY(tn, nct):                                                   \
    return launch_commit<T, tn, nct>(a, c, out, numel, path, bm, stages, \
                                     blocks, grid, phases, s);
  IGEMM_DISPATCH(bn, nct, COMMIT_CASE)
#undef COMMIT_CASE
}

template <typename T>
int blocks_per_sm(int bn, int nct, int threads, int smem) {
#define BLOCKS_CASE(tn, nct)                                              \
  case IGEMM_KEY(tn, nct):                                                   \
    return igemm::kernel_blocks(                                          \
        reinterpret_cast<const void*>(commit_kernel<T, tn, nct>), threads, \
        smem);
  IGEMM_DISPATCH(bn, nct, BLOCKS_CASE)
#undef BLOCKS_CASE
}

}  // namespace

// The product of x and w (geometry in `gemm`, kGemmWords int64 words) into
// `scratch` ((M, N), T), then the chain in `desc` (chain_desc.cuh) over it
// into out (numel elements), through the host's plan
// (kernels/matmul_tm/chain.py: xchain_commit_card_plan): `path`, `bm`,
// `bn` over `nct` column threads, `stages`, the `blocks` an SM must hold
// and the co-resident `grid`.  `phases`: 3 both, 1 the product phase
// alone, 2 the chain phase alone.
extern "C" int xchain_commit(const void* x, const void* w, void* out,
                             void* scratch, const int64_t* desc,
                             const int64_t* gemm, int dtype, int64_t numel,
                             int n_levels, int n_extras, int path, int bm,
                             int bn, int nct, int stages, int blocks,
                             int grid, int phases, void* stream) {
  chain::Chain c;
  igemm::Args a = {};
  if (numel <= 0 || !chain::parse(desc, n_levels, n_extras, &c) ||
      !igemm::parse_gemm(gemm, &a.g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.x = x;
  a.w = w;
  a.out = scratch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case chain::kInt8:
      return dispatch<int8_t>(a, c, out, numel, path, bm, bn, nct, stages,
                              blocks, grid, phases, s);
    case chain::kInt32:
      return dispatch<int32_t>(a, c, out, numel, path, bm, bn, nct, stages,
                               blocks, grid, phases, s);
    case chain::kBf16:
      return dispatch<__nv_bfloat16>(a, c, out, numel, path, bm, bn, nct,
                                     stages, blocks, grid, phases, s);
    case chain::kF32:
      return dispatch<float>(a, c, out, numel, path, bm, bn, nct, stages,
                             blocks, grid, phases, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks an SM holds of the commit kernel for (dtype, bn, nct) at `threads`
// threads and `smem` bytes of dynamic shared memory, or the negated CUDA
// error: the host plan's occupancy input.
extern "C" int xchain_commit_blocks(int dtype, int bn, int nct, int threads,
                                    int smem) {
  switch (dtype) {
    case chain::kInt8: return blocks_per_sm<int8_t>(bn, nct, threads, smem);
    case chain::kInt32: return blocks_per_sm<int32_t>(bn, nct, threads, smem);
    case chain::kBf16:
      return blocks_per_sm<__nv_bfloat16>(bn, nct, threads, smem);
    case chain::kF32: return blocks_per_sm<float>(bn, nct, threads, smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
