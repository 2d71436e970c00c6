// The TM -> compute prologue for Hopper (sm_90a): a forwarding chain
// feeding one operand of a 2D product or an NHWC conv, in ONE launch.
//
// Replaces the JAX package's Pallas kernel in
// src/repro/kernels/matmul_tm/chain.py: _prologue_executable (body
// _prologue_kernel), which walks the chain into a VMEM buffer (the
// crossing operand, never in HBM) and binds the product to it in the last
// grid step.
//
// Bound on an H100: the product's operations (2 M N K f32 over 67
// TFLOP/s; at the YOLOv3-Tiny neck, Upsample (8, 14, 14, 128) + Route
// (8, 28, 28, 128) into head 2's 1x1 conv (1, 1, 256, 255), 0.82 GFLOP:
// 0.0122 ms), above the bytes of the chain's sources, w and the output.
//
// Design: xchain_commit.cu's two phases in the other order, in one
// cooperative launch.
//   1. The chain phase: chain_walk.cuh's walk (shared with the commit)
//      writes the crossing operand into a scratch tensor the wrapper
//      allocates, in the operand's own layout: the mm's (M, K) x, the
//      conv's NHWC input, or the weights where the chain feeds them
//      (cross_pos 1).  At the YOLO neck it is 6.4 MB and stays in the
//      50 MB L2.  Every block of the product's persistent grid takes part
//      (12 warps an SM), so the walk's loads go out in two rounds a step
//      (j, the masks and the band's index together; then the reads).
//   2. A grid-wide barrier (cooperative_groups::this_grid().sync()),
//      after a proxy fence: the product reads the scratch through TMA (the
//      async proxy), the walk wrote it with ordinary stores.  The grid is
//      no larger than the blocks the card holds at once (igemm::prepare
//      checks the host's plan), so a grid that cannot be co-resident fails
//      to launch instead of hanging.
//   3. The product phase: igemm.cuh's implicit-GEMM core over the scratch
//      and the other operand, as conv2d and the commit run it: A by TMA 2-d
//      boxes (an mm, or a 1x1 conv of stride 1 run as its mm) or im2col (a
//      kxk conv), or by cp.async where TMA cannot take it, B by TMA or
//      cp.async, persistent blocks sized by the host plan
//      (kernels/img2col/img2col.py: conv_plan; at the neck 8 x 4 tiles a
//      thread, 264 tiles on 2 x 132 blocks), the identity store to out.
//      Where there are fewer tiles than blocks, each block records its SM
//      before the barrier and the tiles go to blocks on distinct SMs first
//      (igemm::tile_place), whatever order the card placed the blocks in.
// Variants that run one phase (`phases` 1: the chain, then the barrier;
// 2: the barrier, then the product over whatever the scratch holds) time
// the two phases apart.  Element types: int8, int32 (bit-exact, the sums
// wrap), bf16 and f32.  The entry point returns cudaGetLastError() after
// its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_desc.cuh"
#include "chain_walk.cuh"
#include "igemm.cuh"

namespace {

namespace cg = cooperative_groups;

template <typename T, int TN, int NCT>
__global__ void __launch_bounds__(igemm::kIgMaxThreads, igemm::kIgMinBlocks)
prologue_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ igemm::Args a,
                const __grid_constant__ chain::Chain c,
                const T* __restrict__ src, T* __restrict__ scratch,
                int* __restrict__ place_of, int64_t numel, int phases) {
  if (phases & 1) chain::walk<T>(c, src, scratch, numel);
  if (a.spread > 1 && threadIdx.x == 0) {
    place_of[blockIdx.x] = igemm::sm_id();  // read by tile_place
  }
  // the scratch's generic-proxy stores before the product's TMA reads
  asm volatile("fence.proxy.async.global;" ::: "memory");
  cg::this_grid().sync();
  if (!(phases & 2)) return;
  asm volatile("fence.proxy.async.global;" ::: "memory");
  igemm::run_tiles<T, TN, NCT>(&amap, &bmap, a,
                               igemm::tile_place(a, place_of));
}

template <typename T, int TN, int NCT>
int launch_prologue(igemm::Args a, const chain::Chain& c, const void* src,
                    void* scratch, int* place_of, int64_t numel, int path,
                    int bm,
                    int stages, int blocks, int grid, int phases,
                    cudaStream_t s) {
  CUtensorMap map, bmap;
  size_t smem = 0;
  auto kernel = prologue_kernel<T, TN, NCT>;
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
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, map, bmap, a, c, static_cast<const T*>(src),
      static_cast<T*>(scratch), place_of, numel, phases);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const igemm::Args& a, const chain::Chain& c, const void* src,
             void* scratch, int* place_of, int64_t numel, int path, int bm,
             int bn, int nct, int stages, int blocks, int grid, int phases,
             cudaStream_t s) {
#define PROLOGUE_CASE(tn, nct)                                             \
  case IGEMM_KEY(tn, nct):                                                   \
    return launch_prologue<T, tn, nct>(a, c, src, scratch, place_of, numel, \
                                       path, bm, stages, blocks, grid,      \
                                       phases, s);
  IGEMM_DISPATCH(bn, nct, PROLOGUE_CASE)
#undef PROLOGUE_CASE
}

template <typename T>
int blocks_per_sm(int bn, int nct, int threads, int smem) {
#define BLOCKS_CASE(tn, nct)                                               \
  case IGEMM_KEY(tn, nct):                                                   \
    return igemm::kernel_blocks(                                           \
        reinterpret_cast<const void*>(prologue_kernel<T, tn, nct>),        \
        threads, smem);
  IGEMM_DISPATCH(bn, nct, BLOCKS_CASE)
#undef BLOCKS_CASE
}

}  // namespace

// The product (geometry in `gemm`, kGemmWords int64 words) whose operand
// `cross_pos` (0: x, 1: w) is the output of the chain in `desc`
// (chain_desc.cuh) over `src`, numel elements walked into `scratch` (the
// operand's shape and layout); `other` is the other operand and out the
// (M, N) row-major or NHWC product.  The host's plan
// (kernels/matmul_tm/chain.py: xchain_prologue_card_plan) gives `path`,
// `bm`, `bn` over `nct` column threads, `stages`, the `blocks` an SM must
// hold and the co-resident `grid`; `place_of` holds `grid` ints, each
// block's SM where the kernel spreads fewer tiles than blocks over the
// SMs.  `phases`: 3 both, 1 the chain phase alone, 2 the product phase
// alone.
extern "C" int xchain_prologue(const void* src, const void* other, void* out,
                               void* scratch, int* place_of,
                               const int64_t* desc,
                               const int64_t* gemm, int dtype, int cross_pos,
                               int64_t numel, int n_levels, int n_extras,
                               int path, int bm, int bn, int nct,
                               int stages, int blocks, int grid, int phases,
                               void* stream) {
  chain::Chain c;
  igemm::Args a = {};
  if (numel < 0 || (cross_pos != 0 && cross_pos != 1) ||
      !chain::parse(desc, n_levels, n_extras, &c) ||
      !igemm::parse_gemm(gemm, &a.g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.x = cross_pos == 0 ? scratch : other;
  a.w = cross_pos == 1 ? scratch : other;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PROLOGUE_DTYPE(code, T)                                            \
  case code:                                                               \
    return dispatch<T>(a, c, src, scratch, place_of, numel, path, bm, bn,  \
                       nct, stages, blocks, grid, phases, s);
  switch (dtype) {
    PROLOGUE_DTYPE(chain::kInt8, int8_t)
    PROLOGUE_DTYPE(chain::kInt32, int32_t)
    PROLOGUE_DTYPE(chain::kBf16, __nv_bfloat16)
    PROLOGUE_DTYPE(chain::kF32, float)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROLOGUE_DTYPE
}

// Blocks an SM holds of the prologue kernel for (dtype, bn, nct) at `threads`
// threads and `smem` bytes of dynamic shared memory, or the negated CUDA
// error: the host plan's occupancy input.
extern "C" int xchain_prologue_blocks(int dtype, int bn, int nct, int threads,
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
