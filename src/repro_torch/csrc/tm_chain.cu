// Forwarding-chain megakernel for Hopper (sm_90a): a producer->consumer run
// of coarse TM instructions in ONE launch.
//
// Replaces the JAX package's Pallas kernel in
// src/repro/kernels/tm_affine/chain.py: _chain_executable (body
// _chain_kernel).  The host (kernels/tm_affine/chain.py) pulls every link
// of the chain back onto the final output: a flat index j into the chain
// input, and per level a validity mask, a fill, and for a link with an
// element-wise epilogue the flat index p of its operand.  A terminal
// multi-band Route adds "extra" bands, each a flat index into its own
// source with its own mask and fill.
//
// Bound on an H100: bytes over HBM bandwidth (3.35 TB/s).  The function
// must read the chain input, every epilogue operand and every Route band
// source once and write the output once; the intermediates of the chain
// never reach device memory.
//
// Design: one thread per output element in a grid-stride loop, so the
// output, j, p, idx and the masks are read and written coalesced; the
// chain input and the operands are gathered.  Each thread computes exactly
// what _chain_kernel computes for its element: the walk of chain_desc.cuh.
// The levels and extras are runtime data: a descriptor table passed by
// value as a __grid_constant__ kernel parameter, so it sits in the constant
// bank, is read by every thread at the same address (a broadcast), and
// costs no copy of its own per call.  The index arrays are uploaded once
// per chain and device; the table holds their pointers beside the operand
// pointers of this call.
//
// This simple design streams 4 bytes of index (and 1 of mask) per element
// per array, as the Pallas kernel does; generating the addresses from the
// maps' registers, as the gather kernel in tm_affine.cu does, is later
// work.
//
// Element types: int8, int32, bf16, f32.  EW epilogue: add, sub, mul, max.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_desc.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const T* __restrict__ x, T* __restrict__ out,
             const __grid_constant__ chain::Chain c, int64_t numel) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < numel; i += stride) {
    out[i] = chain::eval<T>(x, c, i);
  }
}

inline unsigned grid_for(int64_t numel) {
  const int64_t blocks = (numel + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 32;  // enough blocks in flight; the loop strides
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

template <typename T>
void launch_typed(const void* x, void* out, const chain::Chain& c,
                  int64_t numel, cudaStream_t stream) {
  chain_kernel<T><<<grid_for(numel), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c, numel);
}

}  // namespace

extern "C" int tm_chain(const void* x, void* out, const int64_t* desc,
                        int dtype, int64_t numel, int n_levels, int n_extras,
                        void* stream) {
  chain::Chain c;
  if (numel <= 0 || !chain::parse(desc, n_levels, n_extras, &c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case chain::kInt8: launch_typed<int8_t>(x, out, c, numel, s); break;
    case chain::kInt32: launch_typed<int32_t>(x, out, c, numel, s); break;
    case chain::kBf16: launch_typed<__nv_bfloat16>(x, out, c, numel, s); break;
    case chain::kF32: launch_typed<float>(x, out, c, numel, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
