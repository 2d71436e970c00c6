// Cross entropy for Hopper (sm_90a): the loss's row statistics and its
// gradient, each one pass over the logits.
//
// Replaces no Pallas kernel: the JAX package's loss (src/repro/models/
// layers.py, softmax_xent) is jnp, which XLA fuses.  The port's plain
// version (repro_torch/kernels/xent.py, nll_plain) is an eager chain: the
// logits widened to f32, amax, a broadcast subtract, exp, a sum and a
// gather, then autograd's backward of each, 18 ops each way.  At the train
// cell's (4096, 151936) bf16 logits that is about 65 GB of traffic a step.
//
// Bound on an H100: bytes.  xent_rows reads each row once; xent_grad reads
// it once more and writes the gradient in the logits' dtype (20 bytes a
// row besides each way: the label and three floats).  At 4096 rows of 151936 bf16 logits: 3 x 1.245 GB =
// 3.73 GB, 1.11 ms at 3.35 TB/s.  One exp and a few operations an element
// each way are far below the card's rates.
//
// Design: one block a row, streaming.
//
//  * Rows are whole 16-byte vectors: V a multiple of 8 and every row (and
//    the gradient's row) 16-byte aligned, which the entry points check.
//    Every vocabulary the port builds is padded to a multiple of 128, and
//    so is each rank's share of one split over up to 16 ranks.
//  * The block's width follows V (threads_for): about 4 vectors of 8
//    elements a thread, 32 to 512 threads.  A thread reads 8 elements at
//    once (bf16: one 16-byte load, f32: two); kUnroll vectors are loaded
//    before any is used.  Offsets are 64-bit.  Loads carry the evict-first
//    hint: the rows are far larger than L2.
//  * xent_rows keeps an online max and sum: each thread a pair (m, s), s =
//    sum exp(x - m), rescaled when m grows; the pairs combine in a shuffle
//    tree, then the warps in order.  No atomics: the same bits on every run.
//    It writes the row's max m, its sum s, and nll = (m + log s) - x[gold],
//    the plain version's lse = m + log(s), nll = lse - gold, at gold =
//    clamp(label, 0).
//  * A block of columns: the logits may be the columns [col0, col0 + V) of
//    a vocabulary of `vocab` (a rank's share where a mesh splits it).
//    Labels are columns of the whole vocabulary.  xent_rows then writes
//    each row's gold logit where this block holds it, else 0, for the
//    caller to combine (m, s, gold) over the blocks; xent_grad takes the
//    combined max and sum and subtracts dnll only at a gold column it holds.
//  * xent_grad writes, per element, (dnll / s) * exp(x - m), less dnll at
//    gold, each step rounded as the plain version's eager kernels round it
//    (log's backward divides, exp's multiplies, the gather's -dnll is added)
//    and the result once to the logits' dtype.  The plain version's amax
//    branch adds dnll - sum (dnll / s) exp(x - m) at the row's max, zero up
//    to the rounding of that sum, which the kernel leaves out.  Saving m and
//    s rather than lse keeps exp(x - m) as exact as the plain version's:
//    exp(x - lse) would carry lse's rounding, u |lse|, into every element.
//    A row whose dnll is 0 (an ignored position) writes zeros and reads no
//    logit.
//  * A label at or past the vocabulary gives a NaN nll and a NaN gradient
//    row instead of a read out of bounds (the plain version's gather
//    raises).
//
// Every entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a shape or an alignment it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;          // elements a thread reads at once
constexpr int kUnroll = 4;       // vectors loaded before any is used
constexpr int kMaxThreads = 512;
constexpr int kVecsPerThread = 4;

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

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

// --- the row's max and sum -------------------------------------------------

struct Stat {
  float m;  // the max so far
  float s;  // sum of exp(x - m) so far
};

// The pair of a and b together.  Symmetric bit for bit (the sum of two
// products commutes), so both lanes of a shuffle hold the same result.
__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return Stat{m, 0.0f};  // neither has a finite element
  return Stat{m, __fadd_rn(__fmul_rn(a.s, expf(__fsub_rn(a.m, m))),
                           __fmul_rn(b.s, expf(__fsub_rn(b.m, m))))};
}

__device__ __forceinline__ void absorb(Stat& st, const float (&x)[kVec]) {
  float vm = x[0];
#pragma unroll
  for (int k = 1; k < kVec; ++k) vm = fmaxf(vm, x[k]);
  if (vm > st.m) {
    st.s = __fmul_rn(st.s, expf(__fsub_rn(st.m, vm)));
    st.m = vm;
  }
  if (st.m == -INFINITY) return;  // all -inf so far: nothing to add
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    acc = __fadd_rn(acc, expf(__fsub_rn(x[k], st.m)));
  }
  st.s = __fadd_rn(st.s, acc);
}

// The block's pair, in every thread: a shuffle tree in each warp, then the
// warps in order.  smem holds a pair a warp.
__device__ __forceinline__ Stat block_stat(Stat st, Stat* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Stat other{__shfl_xor_sync(0xffffffffu, st.m, o),
                     __shfl_xor_sync(0xffffffffu, st.s, o)};
    st = merge(st, other);
  }
  if (threadIdx.x % 32 == 0) smem[threadIdx.x / 32] = st;
  __syncthreads();
  Stat total = smem[0];
  for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) {
    total = merge(total, smem[w]);
  }
  return total;
}

// The gold column of a row in a block of columns starting at col0: its
// offset there (outside [0, V) where another block holds it).
__device__ __forceinline__ int64_t gold_col(int64_t label, int64_t col0) {
  return (label < 0 ? 0 : label) - col0;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rows_kernel(const T* __restrict__ x, int64_t ld, int64_t V, int64_t col0,
            int64_t vocab, const int64_t* __restrict__ labels,
            float* __restrict__ nll, float* __restrict__ mx,
            float* __restrict__ sm, float* __restrict__ gold) {
  __shared__ Stat smem[kMaxThreads / 32];
  const int64_t row = blockIdx.x;
  const T* r = x + row * ld;
  const int64_t nt = blockDim.x;
  const int64_t nvec = V / kVec;
  Stat st{-INFINITY, 0.0f};
  int64_t j = threadIdx.x;
  for (; j + (kUnroll - 1) * nt < nvec; j += kUnroll * nt) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load8(r + (j + u * nt) * kVec, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) absorb(st, v[u]);
  }
  for (; j < nvec; j += nt) {
    float v[kVec];
    load8(r + j * kVec, v);
    absorb(st, v);
  }
  st = block_stat(st, smem);
  if (threadIdx.x == 0) {
    const int64_t label = labels[row];
    const int64_t c = gold_col(label, col0);
    float g = 0.0f;  // another block holds the gold column
    if (label >= vocab) {
      g = __int_as_float(0x7fc00000);  // NaN: a label past the vocabulary
    } else if (c >= 0 && c < V) {
      g = to_float(r[c]);
    }
    if (nll != nullptr) nll[row] = __fsub_rn(__fadd_rn(st.m, logf(st.s)), g);
    if (gold != nullptr) gold[row] = g;
    mx[row] = st.m;
    sm[row] = st.s;
  }
}

// The gradient of 8 elements x, which start at column c0 of a row whose
// gold column is gi: (dnll / s) * exp(x - m), less dnll at gi.
__device__ __forceinline__ void grad_of(float (&x)[kVec], int64_t c0,
                                        int64_t gi, float t, float m,
                                        float d) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    float g = __fmul_rn(t, expf(__fsub_rn(x[k], m)));
    if (c0 + k == gi) g = __fsub_rn(g, d);
    x[k] = g;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
grad_kernel(const T* __restrict__ x, int64_t ld, int64_t V, int64_t col0,
            int64_t vocab, const int64_t* __restrict__ labels,
            const float* __restrict__ mx, const float* __restrict__ sm,
            const float* __restrict__ dnll, T* __restrict__ out,
            int64_t ld_out) {
  const int64_t row = blockIdx.x;
  const T* r = x + row * ld;
  T* o = out + row * ld_out;
  const int64_t nt = blockDim.x;
  const int64_t nvec = V / kVec;
  const float d = dnll[row];
  const int64_t label = labels[row];
  const int64_t gi = gold_col(label, col0);
  const float m = mx[row];
  // the division of log's backward, once a row; NaN for a label past the
  // vocabulary
  const float t = label < vocab ? __fdiv_rn(d, sm[row])
                                : __int_as_float(0x7fc00000);
  int64_t j = threadIdx.x;
  if (d == 0.0f) {
    const float z[kVec] = {};
    for (; j < nvec; j += nt) store8(o + j * kVec, z);
    return;
  }
  for (; j + (kUnroll - 1) * nt < nvec; j += kUnroll * nt) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load8(r + (j + u * nt) * kVec, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      grad_of(v[u], (j + u * nt) * kVec, gi, t, m, d);
      store8(o + (j + u * nt) * kVec, v[u]);
    }
  }
  for (; j < nvec; j += nt) {
    float v[kVec];
    load8(r + j * kVec, v);
    grad_of(v, j * kVec, gi, t, m, d);
    store8(o + j * kVec, v);
  }
}

// --- host ------------------------------------------------------------------

// The block's width for rows of V elements: about kVecsPerThread vectors a
// thread, a whole number of warps, 32 to kMaxThreads.
int threads_for(int64_t V) {
  const int64_t per = kVec * kVecsPerThread;
  int64_t warps = ((V + per - 1) / per + 31) / 32;
  if (warps < 1) warps = 1;
  if (warps > kMaxThreads / 32) warps = kMaxThreads / 32;
  return static_cast<int>(warps * 32);
}

// Whether n_rows rows of V elements, row r at p + r * ld, are whole
// 16-byte vectors, columns [col0, col0 + V) of a vocabulary of `vocab`.
bool rows_ok(const void* p, int64_t n_rows, int64_t V, int64_t ld, int bf16,
             int64_t col0, int64_t vocab) {
  const int64_t per16 = bf16 ? 8 : 4;  // elements in 16 bytes
  return n_rows >= 0 && n_rows <= 0x7fffffff && V >= kVec &&
         V % kVec == 0 && ld >= V && ld % per16 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0 && col0 >= 0 &&
         col0 + V <= vocab;
}

}  // namespace

// Row statistics of the n_rows x V logits x (bf16 where bf16 != 0, else
// f32; row r at x + r * ld elements), the columns [col0, col0 + V) of a
// vocabulary of `vocab`, with labels (int64, one a row, columns of the
// whole vocabulary): each row's max and sum of exp(x - max), and its gold
// logit where x holds it, else 0, f32, one a row.  nll (where not null)
// gets max + log(sum) - gold, the row's nll where x is the whole row; gold
// may be null.
extern "C" int xent_rows(const void* x, int64_t n_rows, int64_t V, int64_t ld,
                         int bf16, int64_t col0, int64_t vocab,
                         const void* labels, void* nll, void* mx, void* sm,
                         void* gold, void* stream) {
  if (!rows_ok(x, n_rows, V, ld, bf16, col0, vocab)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(V);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  float* n = static_cast<float*>(nll);
  float* m = static_cast<float*>(mx);
  float* z = static_cast<float*>(sm);
  float* g = static_cast<float*>(gold);
  if (bf16) {
    rows_kernel<__nv_bfloat16><<<static_cast<unsigned>(n_rows), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ld, V, col0, vocab, lab, n, m,
        z, g);
  } else {
    rows_kernel<float><<<static_cast<unsigned>(n_rows), threads, 0, s>>>(
        static_cast<const float*>(x), ld, V, col0, vocab, lab, n, m, z, g);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradient of the nll with respect to the logits x (as in xent_rows),
// from the rows' max and sum over the whole vocabulary and the incoming
// gradient dnll (f32, one a row), written in x's dtype into out (row r at
// out + r * ld_out elements).
extern "C" int xent_grad(const void* x, int64_t n_rows, int64_t V, int64_t ld,
                         int bf16, int64_t col0, int64_t vocab,
                         const void* labels, const void* mx, const void* sm,
                         const void* dnll, void* out, int64_t ld_out,
                         void* stream) {
  if (!rows_ok(x, n_rows, V, ld, bf16, col0, vocab) ||
      !rows_ok(out, n_rows, V, ld_out, bf16, col0, vocab)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(V);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  const float* m = static_cast<const float*>(mx);
  const float* z = static_cast<const float*>(sm);
  const float* d = static_cast<const float*>(dnll);
  if (bf16) {
    grad_kernel<__nv_bfloat16><<<static_cast<unsigned>(n_rows), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ld, V, col0, vocab, lab, m, z,
        d, static_cast<__nv_bfloat16*>(out), ld_out);
  } else {
    grad_kernel<float><<<static_cast<unsigned>(n_rows), threads, 0, s>>>(
        static_cast<const float*>(x), ld, V, col0, vocab, lab, m, z, d,
        static_cast<float*>(out), ld_out);
  }
  return static_cast<int>(cudaGetLastError());
}
