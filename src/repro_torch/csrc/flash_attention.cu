// Online-softmax attention for Hopper (sm_90a): prefill and one-token decode.
//
// Replaces the two Pallas kernels of the JAX package's
// src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_fwd     flash_attention (body _fa_fwd_kernel): causal or
//                           non-causal attention of S queries over Sk keys;
//   flash_attention_decode  flash_decode (body _fa_decode_kernel): one query
//                           per head against a KV cache whose positions
//                           >= length are masked, length a runtime operand;
//   flash_attention_decode_partial  the same over one block of a cache
//                           whose rows are spread over ranks: (o, lse) in
//                           f32 for a combine across the blocks, in place
//                           of the normalised out (GSPMD's distributed
//                           flash decode of the Pallas kernel).
//
// What all of them compute is the Pallas body, step for step:
//   s = (q . k in f32) * scale; masked entries are -1e30;
//   m_new = max(m, rowmax s); p = exp(s - m_new); alpha = exp(m - m_new);
//   l = l * alpha + sum p;  acc = acc * alpha + (p rounded to V's type) . V;
//   out = acc / max(l, 1e-30), rounded to q's type.
// Causal masking is top-left: query i sees key j iff i >= j, also when
// S != Sk.  With length <= 0 every decode score is -1e30, so p = 1 for every
// row and the result is the mean of all rows of V, as in the Pallas kernel.
//
// Layout: q is (B, S, H, D) and k, v are (B, Sk, KV, D), each given by its
// strides in elements with the last one 1; query head h reads KV head
// h / G, G = H / KV (the GQA repeat composed into the addressing, never
// materialized).  The Pallas layout (BH, S, D) is B = BH, H = KV = 1.
// Element types f32 and bf16 (q, k, v and out of one type); D a multiple
// of 8 up to 256.
//
// Bounds on an H100 and what the designs do about them:
//
//   prefill is bound by operations: 4 B H D (S^2 + S) / 2 for causal
//   attention (twice that non-causal).  The kernel is chosen by the element
//   type alone, never by a failure:
//
//   bf16 -> fwd_tc_kernel, on the tensor cores (989 TFLOP/s).  Work
//     items are (tile of 128 / G query positions, KV head, batch), the
//     tiles in reverse order so that the long causal rows start first; an
//     item's 128 rows are those positions for each of the G query heads
//     that read the KV head (one TMA box of G heads x 128 / G positions),
//     so each K/V tile is copied once for all of them.  One persistent
//     block per SM walks items i, i + grid, ...: two consumer warpgroups
//     own 64 rows each; one producer warp issues every copy with TMA
//     (cp.async.bulk.tensor, one 4-d tensor map per operand, completion on
//     an mbarrier), so no consumer thread spends an instruction on an
//     address, and it runs ahead into the next item.  The Q tile and a
//     ring of K/V stages (64 keys each; 4 stages at D <= 128, 2 at D =
//     256; the ring runs on across items) sit in shared memory in TMA's
//     128-byte swizzle, 64 columns per swizzle block; the head dim is
//     padded to DP in {64, 128, 256} by the tensor map's zero fill (TMA
//     fills the ragged edge past S, Sk and D with zeros), so every head dim
//     runs on the tensor cores.  S = Q K^T is wgmma.m64n64k16 with both
//     operands from shared memory (K stored [key][d] is K-major for B) and
//     f32 accumulation; the
//     online softmax runs on the accumulator fragment in registers (row max
//     and sum over the 4 lanes of a quad), masking only on tiles that cross
//     the diagonal or the edge, exp2 on the special-function unit; p is
//     rounded to bf16 in registers (the Pallas cast), which is exactly
//     wgmma's A-register layout, so P V is wgmma.m64n64k16 with A from
//     registers and V from shared memory, MN-major through the
//     descriptor's transpose bit.  Key tiles past the causal limit are
//     never requested.  out = acc / max(l, 1e-30) is stored from
//     registers.  The wrapper takes G <= 128 (a tile holds one position).
//
//   f32 -> fwd_kernel, FMA outside the tensor cores (67 TFLOP/s): TF32
//     would round q and k to 10 bits and break the f32 tolerance.  One
//     block of 256 threads per (64-query tile, head, batch), tiles in
//     reverse order.  The Q tile and one K or V tile at a time sit in
//     shared memory (rows padded by 4 words: conflict-free float4 reads),
//     the scores of a 64 x 64 tile in registers, 4 rows x 4 columns per
//     thread; m, l and the 64 x D accumulator stay in registers.  Key tiles
//     past the causal limit are never loaded.
//
//   decode is bound by bytes: K and V rows < length of every (batch, KV
//   head), plus q and out, over 3.35 TB/s.  Two kernels per call, counted
//   as one wrapper call: a split kernel over row splits of the cache, one
//   block per (KV head, chunk of its G query heads, split, batch), so each
//   K and V row is read once for the heads that share it and the grid
//   fills the SMs (the wrapper picks the split from T and the grid, never
//   from length, so a captured decode step stays valid at every position);
//   then decode_combine_kernel, which rescales and sums the splits'
//   partials (m, l, acc[D]) of each (batch, head) into out
//   (flash-decoding: another summation order than Pallas's one running
//   state).  A split wholly at or past length writes m = -1e30, l = 0,
//   acc = 0, which weighs nothing once a row is unmasked; with length <= 0
//   every split covers its rows at p = 1.  Both split kernels copy their
//   rows 64 at a time into shared memory with cp.async, K and V in flight
//   together, and read length from a device int32, so the host never
//   waits.  By element type:
//
//   bf16 -> decode_mma_kernel: 4 warps, chunks of up to 16 query heads
//     (mma's M).  Warp w scores rows 16 w .. 16 w + 15 of a tile for all
//     heads at once (mma.m16n8k16, K through ldmatrix), runs the online
//     softmax on the accumulator fragment, rounds p to bf16 in registers
//     (the Pallas cast, and the A fragment of P V) and adds P V (V through
//     ldmatrix.trans); the warps' running states meet once, at the end.
//
//   f32 -> decode_split_kernel: chunks of up to 4 query heads; thread
//     (head, row) scores a row with FMA, the tile's max and sum per head
//     come from warp shuffles, and thread d accumulates column d of p . V.
//
// Every entry point returns cudaGetLastError() after its launches (or
// cudaErrorInvalidValue for an operand it refuses, before any launch).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Dtype { kBf16 = 2, kF32 = 3 };

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF
constexpr int kThreads = 256;
constexpr int kBQ = 64;            // query rows of an f32 prefill tile
constexpr int kBK = 64;            // key rows of an f32 prefill tile
constexpr int kPad = 4;            // shared-memory row padding, in words
constexpr int kGMax = 4;           // query heads a decode block serves
constexpr int kDecRows = 64;       // cache rows of a decode tile

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(v);
  } else {
    return v;
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// p cast to V's type and back: the Pallas kernels' p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// ---------------------------------------------------------------------------
// prefill, f32: FMA
// ---------------------------------------------------------------------------

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, Sk, H, G, D;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// rows [0, kBK) of one K or V tile into shared memory (f32, zero past Sk)
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t s_stride, int row0,
                                          int n_rows, int D, int ld) {
  for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int row = row0 + r;
    dst[r * ld + d] =
        row < n_rows ? to_f32(src[static_cast<int64_t>(row) * s_stride + d])
                     : 0.0f;
  }
}

// NJ: accumulator columns per thread, d = tx + 16 j for j < NJ (16 NJ >= D)
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const FwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D;
  const int ld = D + kPad;
  float* qs = smem;               // kBQ x ld: the query tile
  float* kvs = qs + kBQ * ld;     // kBK x ld: a K tile, then a V tile
  float* ps = kvs + kBK * ld;     // kBQ x (kBK + kPad): p in V's type
  const int lp = kBK + kPad;

  const int tx = threadIdx.x & 15;  // score columns tx + 16 j
  const int ty = threadIdx.x >> 4;  // score and accumulator rows ty + 16 i
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.G;
  const int q0 = qt * kBQ;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int row = q0 + r;
    qs[r * ld + d] =
        row < a.S ? to_f32(qg[static_cast<int64_t>(row) * a.q_ss + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  int nk = (a.Sk + kBK - 1) / kBK;
  if (a.causal) {  // key tiles wholly above the diagonal are skipped
    const int last_row = min(q0 + kBQ, a.S) - 1;
    nk = min(nk, last_row / kBK + 1);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous V tile is no longer read
    load_tile(kvs, kg, a.k_ss, k0, a.Sk, D, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * ld + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&kvs[(tx + 16 * j) * ld + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float sv = s[i][j] * a.scale;
        if (col >= a.Sk || (a.causal && col > row)) sv = kNegInf;
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
      // the 16 lanes of a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * lp + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the K tile is no longer read; p is in shared memory
    load_tile(kvs, vg, a.v_ss, k0, a.Sk, D, ld);
    __syncthreads();

    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * lp + c]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float v0 = kvs[(c + 0) * ld + d], v1 = kvs[(c + 1) * ld + d];
          const float v2 = kvs[(c + 2) * ld + d], v3 = kvs[(c + 3) * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j] = fmaf(pv[i].x, v0, acc[i][j]);
            acc[i][j] = fmaf(pv[i].y, v1, acc[i][j]);
            acc[i][j] = fmaf(pv[i].z, v2, acc[i][j]);
            acc[i][j] = fmaf(pv[i].w, v3, acc[i][j]);
          }
        }
      }
    }
  }

  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D)
        og[static_cast<int64_t>(row) * a.o_ss + d] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * ((kBQ + kBK) * (a.D + kPad) + kBQ * (kBK + kPad));
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  fwd_kernel<T, NJ><<<grid, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const FwdArgs& a, cudaStream_t s) {
  if (a.D <= 16) return launch_fwd<T, 1>(a, s);
  if (a.D <= 32) return launch_fwd<T, 2>(a, s);
  if (a.D <= 64) return launch_fwd<T, 4>(a, s);
  if (a.D <= 128) return launch_fwd<T, 8>(a, s);
  return launch_fwd<T, 16>(a, s);
}


// ---------------------------------------------------------------------------
// prefill, bf16: TMA and wgmma
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 128;                   // query rows of a block
constexpr int kTcBK = 64;                    // key rows of a stage
constexpr int kTcConsumers = 256;            // two warpgroups of 64 rows
constexpr int kTcThreads = kTcConsumers + 32;  // and one producer warp
constexpr int kSwRow = 128;  // bytes of a swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct TcShape {
  static constexpr int kCols = DP / 64;          // 64-column swizzle blocks
  static constexpr int kStages = DP > 128 ? 2 : 4;
  static constexpr int kQBlock = kTcBQ * kSwRow;  // one column block of Q
  static constexpr int kKBlock = kTcBK * kSwRow;  // one column block of K or V
  static constexpr int kQBytes = kCols * kQBlock;
  static constexpr int kKBytes = kCols * kKBlock;
  static constexpr int kStageBytes = 2 * kKBytes;  // K, then V
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + 8 * (2 + 2 * kStages) + 1024;
};

struct TcArgs {
  void* o;
  int S, Sk, H, G, D;
  int rq;  // query positions of a tile: its 128 rows are (position, head)
  int n_qt;  // tiles of positions
  int n_bh;  // B KV: work items are (tile, batch, KV head)
  int64_t o_sb, o_ss, o_sh;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
  int causal;
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
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

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand whose 8-row groups are
// 1024 bytes apart (SBO); LBO in 16-byte units is unused by a K-major
// operand and, at N = 64, by an MN-major one (it would step from one
// 64-column block to the next), so V passes 1024 bytes there too
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses of d across a wgmma fence or wait
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define WG_R32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64 f32) = or += A (64 x 16, shared) B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0
// (they weigh nothing against the row's largest p, which is 1)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator fragment of a 64 x 64 wgmma tile, per thread of a warpgroup
// (warp w, lane t): element 4 j + 2 i + c is row 16 w + t / 4 + 8 i, column
// 8 j + 2 (t % 4) + c.  Its 16-column slice kk, rounded to bf16 pairwise,
// is the A-register fragment of a 64 x 16 wgmma operand.
// Work item w: position tile n_qt - 1 - w / (B KV) (the long causal rows
// first) of KV head hk, batch b, w % (B KV) = b KV + hk.  Its rows m < G rq
// are query position q0 + m / G of head hk G + m % G: the G heads that read
// KV head hk share every K/V tile.
struct TcItem {
  int hk, b, q0, nk;
};

__device__ __forceinline__ TcItem tc_item(const TcArgs& a, int w) {
  const int KV = a.H / a.G;
  TcItem t;
  t.hk = (w % a.n_bh) % KV;
  t.b = (w % a.n_bh) / KV;
  t.q0 = (a.n_qt - 1 - w / a.n_bh) * a.rq;
  t.nk = (a.Sk + kTcBK - 1) / kTcBK;
  if (a.causal) t.nk = min(t.nk, (min(t.q0 + a.rq, a.S) - 1) / kTcBK + 1);
  return t;
}

// Persistent: block i takes items i, i + gridDim.x, ...  The K/V stages
// are a ring that runs on across items, so the next item's first tiles fly
// while this one is computed, and its Q tile as soon as this one's last
// Q K^T has completed.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const TcArgs a) {
  using Sh = TcShape<DP>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + Sh::kQBytes;
  const uint32_t q_full = q_s + Sh::kBarOffset;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full0 = q_empty + 8;               // full[st]: + 8 st
  const uint32_t empty0 = full0 + 8 * Sh::kStages;  // empty[st]: + 8 st
  const int m_end = a.G * a.rq;  // rows of a tile that hold a query

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kTcConsumers);
    for (int st = 0; st < Sh::kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {  // the producer warp: one lane copies
    if (threadIdx.x == kTcConsumers) {
      int it = 0;  // K/V tiles issued, across items: the ring position
      for (int w = blockIdx.x, n = 0; w < a.n_qt * a.n_bh;
           w += gridDim.x, ++n) {
        const TcItem t = tc_item(a, w);
        if (n > 0)  // item n - 1 no longer reads the Q tile
          mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect_tx(q_full, Sh::kCols * m_end * kSwRow);
        for (int c = 0; c < Sh::kCols; ++c)
          tma_load(q_s + c * Sh::kQBlock, &qmap, q_full, 64 * c, t.hk * a.G,
                   t.q0, t.b);
        for (int j = 0; j < t.nk; ++j, ++it) {
          const int st = it % Sh::kStages;
          if (it >= Sh::kStages)  // the consumers released tile it - kStages
            mbar_wait(empty0 + 8 * st, ((it / Sh::kStages) & 1) ^ 1);
          const uint32_t bar = full0 + 8 * st;
          const uint32_t k_dst = kv_s + st * Sh::kStageBytes;
          mbar_expect_tx(bar, Sh::kStageBytes);
          for (int c = 0; c < Sh::kCols; ++c) {
            tma_load(k_dst + c * Sh::kKBlock, &kmap, bar, 64 * c, t.hk,
                     j * kTcBK, t.b);
            tma_load(k_dst + Sh::kKBytes + c * Sh::kKBlock, &vmap, bar,
                     64 * c, t.hk, j * kTcBK, t.b);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: tile rows 64 wg .. 64 wg + 63; rows at or past
  // m_end (never written by TMA) compute garbage that stays in their own
  // rows and is never stored
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int m0 = 64 * wg + 16 * (tid >> 5) + ((tid & 31) >> 2);  // and + 8
  const int cq = 2 * (tid & 3);
  int it = 0;  // K/V tiles consumed, across items
  for (int w = blockIdx.x, n = 0; w < a.n_qt * a.n_bh; w += gridDim.x, ++n) {
    const TcItem t = tc_item(a, w);
    const int pos[2] = {t.q0 + m0 / a.G, t.q0 + (m0 + 8) / a.G};
    const int pos_lo = t.q0 + 64 * wg / a.G;
    const int pos_hi =
        min(t.q0 + (min(64 * wg + 64, m_end) - 1) / a.G, a.S - 1);
    int nk_w = 64 * wg < m_end && pos_lo < a.S ? t.nk : 0;  // tiles it reads
    if (a.causal && nk_w) nk_w = min(t.nk, pos_hi / kTcBK + 1);

    float acc[Sh::kCols][32];
#pragma unroll
    for (int c = 0; c < Sh::kCols; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    mbar_wait(q_full, n & 1);
    const uint32_t qa = q_s + wg * (64 * kSwRow);
    for (int j = 0; j < t.nk; ++j, ++it) {
      const int st = it % Sh::kStages;
      mbar_wait(full0 + 8 * st, (it / Sh::kStages) & 1);
      if (j < nk_w) {
        const uint32_t k_s = kv_s + st * Sh::kStageBytes;
        const uint32_t v_s = k_s + Sh::kKBytes;
        float s[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = 0.0f;
        reg_fence(s);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < Sh::kCols; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(s, sw128_desc(qa + c * Sh::kQBlock + 32 * kk, 1),
                     sw128_desc(k_s + c * Sh::kKBlock + 32 * kk, 1),
                     (c | kk) != 0);
        wgmma_commit();
        wgmma_wait();
        reg_fence(s);

        const int k0 = j * kTcBK;
        const bool edge =
            k0 + kTcBK > a.Sk || (a.causal && k0 + kTcBK - 1 > pos_lo);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 4 * jj + 2 * i + c;
              float sv = s[e] * a.scale_log2;
              if (edge) {
                const int key = k0 + 8 * jj + cq + c;
                if (key >= a.Sk || (a.causal && key > pos[i])) sv = kNegInf;
              }
              s[e] = sv;
              mx[i] = fmaxf(mx[i], sv);
            }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i]);
          alpha[i] = exp2_sfu(m[i] - m_new);
          m[i] = m_new;
        }
        uint32_t pa[16];
        float sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float p0 = exp2_sfu(s[4 * jj + 2 * i] - m[i]);
            const float p1 = exp2_sfu(s[4 * jj + 2 * i + 1] - m[i]);
            sum[i] += p0 + p1;
            pa[2 * jj + i] = pack_bf16(p0, p1);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
        for (int c = 0; c < Sh::kCols; ++c) {
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e >> 1) & 1];
          reg_fence(acc[c]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < Sh::kCols; ++c)
            wgmma_rs(acc[c], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                     pa[4 * kk + 3],
                     sw128_desc(v_s + c * Sh::kKBlock + 16 * kSwRow * kk,
                                1024 >> 4));
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int c = 0; c < Sh::kCols; ++c) reg_fence(acc[c]);
      }
      mbar_arrive(empty0 + 8 * st);  // this thread no longer reads stage st
    }
    mbar_arrive(q_empty);  // every wgmma that read Q has completed

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int mi = m0 + 8 * i;
      if (mi >= m_end || pos[i] >= a.S) continue;
      const float den = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o) + t.b * a.o_sb +
                            (t.hk * a.G + mi % a.G) * a.o_sh +
                            static_cast<int64_t>(pos[i]) * a.o_ss;
#pragma unroll
      for (int c = 0; c < Sh::kCols; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int d = 64 * c + 8 * jj + cq;
          if (d < a.D)
            *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                __floats2bfloat162_rn(acc[c][4 * jj + 2 * i] / den,
                                      acc[c][4 * jj + 2 * i + 1] / den);
        }
    }
  }
}

// cuTensorMapEncodeTiled through cudart's driver entry point, so that the
// library links no libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (D, heads, rows, B) with the strides in elements, boxes of 64 columns x
// box_heads heads x box_rows rows x one batch, 128-byte swizzle, zero fill
bool tensor_map(CUtensorMap* map, const void* base, int D, int heads,
                int rows, int B, int64_t s_head, int64_t s_row, int64_t s_b,
                int box_heads, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_tc(const FwdArgs& a, cudaStream_t s) {
  const int rq = kTcBQ / a.G;  // positions a block covers, all G heads each
  CUtensorMap qm, km, vm;
  if (rq < 1 ||
      !tensor_map(&qm, a.q, a.D, a.H, a.S, a.B, a.q_sh, a.q_ss, a.q_sb, a.G,
                  rq) ||
      !tensor_map(&km, a.k, a.D, a.H / a.G, a.Sk, a.B, a.k_sh, a.k_ss, a.k_sb,
                  1, kTcBK) ||
      !tensor_map(&vm, a.v, a.D, a.H / a.G, a.Sk, a.B, a.v_sh, a.v_ss, a.v_sb,
                  1, kTcBK))
    return cudaErrorInvalidValue;
  const int smem = TcShape<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.S + rq - 1) / rq;
  const int64_t n_items = static_cast<int64_t>(n_qt) * a.B * (a.H / a.G);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (n_items > (int64_t{1} << 30)) return cudaErrorInvalidValue;
  const TcArgs t{a.o,    a.S,    a.Sk,   a.H,
                 a.G,    a.D,    rq,     n_qt,
                 a.B * (a.H / a.G),      a.o_sb,
                 a.o_ss, a.o_sh, a.scale * kLog2e, a.causal};
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  fwd_tc_kernel<DP><<<grid, kTcThreads, smem, s>>>(qm, km, vm, t);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const FwdArgs& a, cudaStream_t s) {
  if (a.D <= 64) return launch_tc<64>(a, s);
  if (a.D <= 128) return launch_tc<128>(a, s);
  return launch_tc<256>(a, s);
}

// ---------------------------------------------------------------------------
// decode: split over the cache rows, then combine
// ---------------------------------------------------------------------------

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* length;
  float* part;  // (B, H, splits, D + 2): each split's m, l, acc[D]
  void* o;
  int B, T, H, G, D;
  int splits;  // row splits of the cache
  int rows;    // rows of a split
  int64_t q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh;
  float scale;
  float* lse;  // (B, H), or null: the partial mode (see the combine)
};

// VEC elements of one 16-byte load, widened to f32
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = f[e];
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Shared memory of a decode block: K tile (rows padded by 16 bytes, so that
// the lanes of a warp, one row each, read distinct banks), V tile, q of the
// block's heads in f32, p rounded to V's type (4 heads per row), partials
// of the max and the sum (one per warp).
__host__ __device__ inline int decode_k_ld(int row_bytes) {
  return row_bytes + 16;
}
__host__ __device__ inline int decode_smem(int D, int elem) {
  const int row_bytes = D * elem;
  return kDecRows * (decode_k_ld(row_bytes) + row_bytes) + kGMax * D * 4 +
         kDecRows * 16 + 2 * (kThreads / 32) * 4;
}

// One block per (KV head, chunk of <= kGMax query heads, split, batch):
// the split's rows below length, kDecRows at a time, copied with cp.async
// (K and V of a tile in flight together); thread (g, r) scores row r for
// head g; the tile's max and sum per head come from warp shuffles and one
// partial per warp; thread d accumulates column d of every head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const DecodeArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) uint8_t dsm[];
  const int D = a.D;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int k_ld = decode_k_ld(row_bytes);
  const int chunks = row_bytes / 16;
  uint8_t* ks = dsm;
  const T* vs = reinterpret_cast<const T*>(dsm + kDecRows * k_ld);
  float* qs = reinterpret_cast<float*>(dsm + kDecRows * (k_ld + row_bytes));
  float* ps = qs + kGMax * D;               // kDecRows x kGMax
  float* red_max = ps + kDecRows * kGMax;   // one per warp
  float* red_sum = red_max + kThreads / 32;
  const uint32_t ks_s = smem_u32(ks), vs_s = smem_u32(vs);

  const int n_chunks = (a.G + kGMax - 1) / kGMax;
  const int hk = blockIdx.x / n_chunks;
  const int g0 = (blockIdx.x - hk * n_chunks) * kGMax;
  const int split = blockIdx.y, b = blockIdx.z;
  const int ng = min(kGMax, a.G - g0);
  const int h0 = hk * a.G + g0;
  const int stride = D + 2;
  float* part = a.part +
                (static_cast<int64_t>(b) * a.H + h0) * a.splits * stride +
                static_cast<int64_t>(split) * stride;  // + g splits * stride

  const int len = *a.length;
  const bool all_masked = len <= 0;  // every score -1e30: p = 1 everywhere
  const int n = all_masked ? a.T : min(len, a.T);
  const int t_begin = split * a.rows;
  const int t_end = min(t_begin + a.rows, n);
  if (t_begin >= t_end) {  // wholly at or past length: weight 0
    for (int g = 0; g < ng; ++g)
      for (int e = threadIdx.x; e < stride; e += kThreads)
        part[g * a.splits * stride + e] = e == 0 ? kNegInf : 0.0f;
    return;
  }

  for (int e = threadIdx.x; e < kGMax * D; e += kThreads) {
    const int g = e / D;
    qs[e] = g < ng ? to_f32(static_cast<const T*>(a.q)[
                         b * a.q_sb + (h0 + g) * a.q_sh + (e - g * D)])
                   : 0.0f;
  }

  const char* kg = static_cast<const char*>(a.k) +
                   (b * a.k_sb + hk * a.k_sh) * int64_t(sizeof(T));
  const char* vg = static_cast<const char*>(a.v) +
                   (b * a.v_sb + hk * a.v_sh) * int64_t(sizeof(T));
  const int64_t k_row = a.k_st * static_cast<int64_t>(sizeof(T));
  const int64_t v_row = a.v_st * static_cast<int64_t>(sizeof(T));
  const int g = threadIdx.x / kDecRows, r = threadIdx.x % kDecRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float m_run[kGMax], l_run[kGMax], acc[kGMax];
#pragma unroll
  for (int h = 0; h < kGMax; ++h) {
    m_run[h] = kNegInf;
    l_run[h] = 0.0f;
    acc[h] = 0.0f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += kDecRows) {
    const int rows = min(kDecRows, t_end - t0);
    for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
      const int rr = e / chunks, c = e - rr * chunks;
      cp_async16(ks_s + rr * k_ld + 16 * c, kg + (t0 + rr) * k_row + 16 * c);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
      const int rr = e / chunks, c = e - rr * chunks;
      cp_async16(vs_s + rr * row_bytes + 16 * c,
                 vg + (t0 + rr) * v_row + 16 * c);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // this tile's K
    __syncthreads();

    const bool valid = g < ng && r < rows;
    float s = kNegInf;
    if (valid && !all_masked) {
      const T* krow = reinterpret_cast<const T*>(ks + r * k_ld);
      const float* qg = qs + g * D;
      float dot[VEC] = {};  // one chain per vector lane
      for (int c = 0; c < chunks; ++c) {
        float kf[VEC];
        load_vec(krow + c * VEC, kf);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dot[e] = fmaf(qg[c * VEC + e], kf[e], dot[e]);
      }
#pragma unroll
      for (int e = 1; e < VEC; ++e) dot[0] += dot[e];
      s = dot[0] * a.scale;
    }
    float mx = s;  // -1e30 where not valid: never above a valid score
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red_max[warp] = mx;
    __syncthreads();

    // head h's rows are warps 2h and 2h + 1
    float m_new[kGMax], alpha[kGMax], m_own = kNegInf;
#pragma unroll
    for (int h = 0; h < kGMax; ++h) {
      m_new[h] = fmaxf(m_run[h], fmaxf(red_max[2 * h], red_max[2 * h + 1]));
      alpha[h] = expf(m_run[h] - m_new[h]);
      if (h == g) m_own = m_new[h];
    }
    const float p = valid ? expf(s - m_own) : 0.0f;
    ps[r * kGMax + g] = round_to<T>(p);
    float sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) red_sum[warp] = sum;
    asm volatile("cp.async.wait_group 0;" ::: "memory");  // this tile's V
    __syncthreads();

#pragma unroll
    for (int h = 0; h < kGMax; ++h) {
      l_run[h] = l_run[h] * alpha[h] + red_sum[2 * h] + red_sum[2 * h + 1];
      m_run[h] = m_new[h];
      acc[h] *= alpha[h];
    }
    if (threadIdx.x < D) {
      const T* vcol = vs + threadIdx.x;
#pragma unroll 4
      for (int rr = 0; rr < rows; ++rr) {
        const float vv = to_f32(vcol[rr * D]);
        const float4 p4 = *reinterpret_cast<const float4*>(ps + rr * kGMax);
        acc[0] = fmaf(p4.x, vv, acc[0]);
        acc[1] = fmaf(p4.y, vv, acc[1]);
        acc[2] = fmaf(p4.z, vv, acc[2]);
        acc[3] = fmaf(p4.w, vv, acc[3]);
      }
    }
    __syncthreads();  // the tile's buffers are free for the next copies
  }

#pragma unroll
  for (int h = 0; h < kGMax; ++h) {
    if (h >= ng) break;
    float* ph = part + h * a.splits * stride;
    if (threadIdx.x < D) ph[2 + threadIdx.x] = acc[h];
    if (threadIdx.x == 0) {
      ph[0] = m_run[h];
      ph[1] = l_run[h];
    }
  }
}

// out[b, h] = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30), w_s = exp(m_s - M):
// one block per (head, batch); the splits' weights are staged in shared
// memory first, so the column sums issue their loads independently.  In
// the partial mode (a.lse set, T = float) it writes the same out in f32
// and lse[b, h] = M + log(sum_s l_s w_s), the pair a block of cache rows
// gives for a combine across blocks; with length <= 0 there is no row to
// attend to, and it writes out = 0, lse = -inf.
template <typename T>
__global__ void decode_combine_kernel(const DecodeArgs a) {
  extern __shared__ float w[];  // splits <= 12288: 48 KB
  __shared__ float red[32];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int stride = a.D + 2;
  const float* part =
      a.part + (static_cast<int64_t>(b) * a.H + h) * a.splits * stride;
  float mx = kNegInf;
  for (int s = threadIdx.x; s < a.splits; s += blockDim.x)
    mx = fmaxf(mx, part[s * stride]);
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
  for (int r = 1; r < n_warps; ++r) mx = fmaxf(mx, red[r]);
  float lsum = 0.0f;
  for (int s = threadIdx.x; s < a.splits; s += blockDim.x) {
    const float ws = expf(part[s * stride] - mx);
    w[s] = ws;
    lsum = fmaf(part[s * stride + 1], ws, lsum);
  }
  for (int off = 16; off > 0; off >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  __syncthreads();  // every warp has read red's maxima
  if (lane == 0) red[warp] = lsum;
  __syncthreads();
  lsum = 0.0f;
  for (int r = 0; r < n_warps; ++r) lsum += red[r];
  if (d >= a.D) return;
  float asum = 0.0f;
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s)
    asum = fmaf(part[s * stride + 2 + d], w[s], asum);
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  if (a.lse != nullptr && *a.length <= 0) {
    og[d] = from_f32<T>(0.0f);
    if (d == 0) a.lse[b * a.H + h] = __int_as_float(0xff800000);  // -inf
    return;
  }
  og[d] = from_f32<T>(asum / fmaxf(lsum, 1e-30f));
  if (a.lse != nullptr && d == 0) a.lse[b * a.H + h] = mx + logf(lsum);
}

// The combine after a split kernel: into out in the element type T, or,
// in the partial mode, into f32 (o, lse)
template <typename T>
cudaError_t launch_combine(const DecodeArgs& a, cudaStream_t s) {
  const dim3 grid(a.H, a.B);
  const int threads = (a.D + 31) / 32 * 32;
  const size_t smem = a.splits * sizeof(float);
  if (a.lse != nullptr)
    decode_combine_kernel<float><<<grid, threads, smem, s>>>(a);
  else
    decode_combine_kernel<T><<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode, bf16: mma.sync on 16 query heads x 64-row tiles
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;              // 16 cache rows of a tile each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaHeads = 16;             // query heads of a block: mma's M

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8 f32) += a (16 x 16 bf16) b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of a bf16 decode block, rows of DP + 8 elements (the 16
// bytes of padding keep ldmatrix's 8 rows on distinct banks): 16 query
// heads, then a K and a V tile of kDecRows rows, which at the end hold the
// warps' accumulators (kMmaWarps x 16 x DP f32); then their m and l.
template <int DP>
struct MmaSmem {
  static constexpr int kLd = 2 * DP + 16;  // bytes of a row
  static constexpr int kQ = kMmaHeads * kLd;
  static constexpr int kTile = kDecRows * kLd;
  static constexpr int kAcc = kMmaWarps * kMmaHeads * DP * 4;
  static constexpr int kBody = 2 * kTile > kAcc ? 2 * kTile : kAcc;
  static constexpr int kBytes = kQ + kBody + 2 * kMmaWarps * kMmaHeads * 4;
};

// One block of 4 warps per (KV head, chunk of <= 16 query heads, split,
// batch): the split's rows below length, kDecRows at a time, copied with
// cp.async; warp w scores rows 16 w .. 16 w + 15 of a tile for all 16 heads
// at once (S = Q K^T by mma.m16n8k16, K through ldmatrix), runs the online
// softmax on the accumulator fragment, rounds p to bf16 in registers (the
// A fragment of P V) and adds P V (V through ldmatrix.trans).  Each warp
// keeps its own running (m, l, acc) over its rows; the four are combined
// into the split's partial at the end.  D is padded to DP with zeros.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
decode_mma_kernel(const DecodeArgs a) {
  using Sm = MmaSmem<DP>;
  constexpr int KS = DP / 16;  // k-steps of Q K^T, column pairs of P V
  extern __shared__ __align__(16) uint8_t dsm[];
  uint8_t* qs = dsm;
  uint8_t* ks = dsm + Sm::kQ;
  uint8_t* vs = ks + Sm::kTile;
  float* acc_s = reinterpret_cast<float*>(ks);  // after the last tile
  float* m_s = reinterpret_cast<float*>(dsm + Sm::kQ + Sm::kBody);
  float* l_s = m_s + kMmaWarps * kMmaHeads;
  const uint32_t qs_s = smem_u32(qs), ks_s = smem_u32(ks),
                 vs_s = smem_u32(vs);

  const int D = a.D;
  const int n_chunks = (a.G + kMmaHeads - 1) / kMmaHeads;
  const int hk = blockIdx.x / n_chunks;
  const int g0 = (blockIdx.x - hk * n_chunks) * kMmaHeads;
  const int split = blockIdx.y, b = blockIdx.z;
  const int ng = min(kMmaHeads, a.G - g0);
  const int h0 = hk * a.G + g0;
  const int stride = D + 2;
  float* part = a.part +
                (static_cast<int64_t>(b) * a.H + h0) * a.splits * stride +
                static_cast<int64_t>(split) * stride;  // + g splits * stride

  const int len = *a.length;
  const bool all_masked = len <= 0;  // every score -1e30: p = 1 everywhere
  const int n = all_masked ? a.T : min(len, a.T);
  const int t_begin = split * a.rows;
  const int t_end = min(t_begin + a.rows, n);
  if (t_begin >= t_end) {  // wholly at or past length: weight 0
    for (int g = 0; g < ng; ++g)
      for (int e = threadIdx.x; e < stride; e += kMmaThreads)
        part[g * a.splits * stride + e] = e == 0 ? kNegInf : 0.0f;
    return;
  }

  // q of the chunk's heads, zero past ng and past D; K and V padding zero
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.q_sb + h0 * a.q_sh;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int e = threadIdx.x; e < kMmaHeads * DP; e += kMmaThreads) {
    const int g = e / DP, d = e - g * DP;
    reinterpret_cast<__nv_bfloat16*>(qs + g * Sm::kLd)[d] =
        g < ng && d < D ? qg[g * a.q_sh + d] : zero;
  }
  if (D < DP)
    for (int e = threadIdx.x; e < 2 * kDecRows * (DP - D);
         e += kMmaThreads) {
      const int r = e / (DP - D), d = D + e - r * (DP - D);
      reinterpret_cast<__nv_bfloat16*>(ks + r * Sm::kLd)[d] = zero;
    }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lm = lane >> 3, li = lane & 7;  // ldmatrix: matrix, row
  const int quad = lane & 3;
  const char* kg = reinterpret_cast<const char*>(
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh);
  const char* vg = reinterpret_cast<const char*>(
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh);
  const int64_t k_row = a.k_st * 2, v_row = a.v_st * 2;
  const int chunks = D * 2 / 16;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
  __syncthreads();  // q is in shared memory
  uint32_t qa[KS][4];  // Q's A fragments, k-step kk
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qa[kk], qs_s + ((lm & 1) * 8 + li) * Sm::kLd +
                        (16 * kk + (lm >> 1) * 8) * 2);

  for (int t0 = t_begin; t0 < t_end; t0 += kDecRows) {
    const int rows = min(kDecRows, t_end - t0);
    for (int e = threadIdx.x; e < rows * chunks; e += kMmaThreads) {
      const int r = e / chunks, c = e - r * chunks;
      cp_async16(ks_s + r * Sm::kLd + 16 * c, kg + (t0 + r) * k_row + 16 * c);
      cp_async16(vs_s + r * Sm::kLd + 16 * c, vg + (t0 + r) * v_row + 16 * c);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    // rows past the split: zero, so that p = 0 never meets a NaN
    for (int e = threadIdx.x; e < (kDecRows - rows) * chunks;
         e += kMmaThreads) {
      const int r = rows + e / chunks, c = e % chunks;
      const uint4 z = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(ks + r * Sm::kLd + 16 * c) = z;
      *reinterpret_cast<uint4*>(vs + r * Sm::kLd + 16 * c) = z;
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();

    // S (16 heads x 16 rows) = Q K_w^T
    float s[2][4] = {};
    const int r0 = 16 * warp;  // this warp's first row of the tile
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, ks_s + (r0 + (lm >> 1) * 8 + li) * Sm::kLd +
                      (16 * kk + (lm & 1) * 8) * 2);
      mma_bf16(s[0], qa[kk], kb[0], kb[1]);
      mma_bf16(s[1], qa[kk], kb[2], kb[3]);
    }
    // element (nt, c): head lane / 4 + 8 (c >> 1), row r0 + 8 nt + 2 quad
    // + (c & 1) of the tile
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + 8 * nt + 2 * quad + (c & 1);
        float v = all_masked ? kNegInf : s[nt][c] * a.scale;
        if (r >= rows) v = kNegInf;
        s[nt][c] = v;
        mx[c >> 1] = fmaxf(mx[c >> 1], v);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    float p[2][4], fresh[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + 8 * nt + 2 * quad + (c & 1);
        p[nt][c] = r < rows ? expf(s[nt][c] - m[c >> 1]) : 0.0f;
        fresh[c >> 1] += p[nt][c];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + fresh[i];
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] *= alpha[c >> 1];
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                            pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]),
                            pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {  // columns 16 kk .. 16 kk + 15
      uint32_t vb[4];
      ldsm_x4_trans(vb, vs_s + (r0 + (lm & 1) * 8 + li) * Sm::kLd +
                             (16 * kk + (lm >> 1) * 8) * 2);
      mma_bf16(acc[2 * kk], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * kk + 1], pa, vb[2], vb[3]);
    }
    __syncthreads();  // the tile's buffers are free for the next copies
  }

  // the four warps' states into the split's partial
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int hrow = lane >> 2;
  if (quad == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_s[warp * kMmaHeads + hrow + 8 * i] = m[i];
      l_s[warp * kMmaHeads + hrow + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc_s[(warp * kMmaHeads + hrow + 8 * (c >> 1)) * DP + 8 * j +
            2 * quad + (c & 1)] = acc[j][c];
  __syncthreads();
  for (int e = threadIdx.x; e < ng * D; e += kMmaThreads) {
    const int g = e / D, d = e - g * D;
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) mw = fmaxf(mw, m_s[w * kMmaHeads + g]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float wt = expf(m_s[w * kMmaHeads + g] - mw);
      lsum = fmaf(l_s[w * kMmaHeads + g], wt, lsum);
      asum = fmaf(acc_s[(w * kMmaHeads + g) * DP + d], wt, asum);
    }
    float* ph = part + g * a.splits * stride;
    ph[2 + d] = asum;
    if (d == 0) {
      ph[0] = mw;
      ph[1] = lsum;
    }
  }
}

template <int DP>
cudaError_t launch_decode_mma(const DecodeArgs& a, cudaStream_t s) {
  const int smem = MmaSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H / a.G * ((a.G + kMmaHeads - 1) / kMmaHeads), a.splits,
                  a.B);
  decode_mma_kernel<DP><<<grid, kMmaThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<__nv_bfloat16>(a, s);
}

cudaError_t dispatch_decode_mma(const DecodeArgs& a, cudaStream_t s) {
  if (a.D <= 32) return launch_decode_mma<32>(a, s);
  if (a.D <= 64) return launch_decode_mma<64>(a, s);
  if (a.D <= 128) return launch_decode_mma<128>(a, s);
  return launch_decode_mma<256>(a, s);
}

template <typename T>
cudaError_t launch_decode(const DecodeArgs& a, cudaStream_t s) {
  const int smem = decode_smem(a.D, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H / a.G * ((a.G + kGMax - 1) / kGMax), a.splits, a.B);
  decode_split_kernel<T><<<grid, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<T>(a, s);
}

}  // namespace

extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int Sk, int H, int KV, int D, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || D <= 0 ||
      D % 8 != 0 || D > 256 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdArgs a{q, k, v, o, B, S, Sk, H, H / KV, D,
                  q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                  o_sb, o_ss, o_sh, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {  // the element type alone picks the kernel
    case kBf16: return static_cast<int>(dispatch_tc(a, s));
    case kF32: return static_cast<int>(dispatch_fwd<float>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

int decode_entry(const void* q, const void* k, const void* v,
                 const void* length, void* part, void* o, float* lse,
                 int dtype, int B, int T, int H, int KV, int D, int splits,
                 int rows, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                 int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                 int64_t v_sh, int64_t o_sb, int64_t o_sh, float scale,
                 void* stream) {
  if (B <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D % 8 != 0 ||
      D > 256 || B > 65535 || splits <= 0 || splits > 12288 || rows <= 0 ||
      static_cast<int64_t>(splits) * rows < T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DecodeArgs a{q, k, v, static_cast<const int32_t*>(length),
                     static_cast<float*>(part), o, B, T, H, H / KV, D,
                     splits, rows, q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                     v_sh, o_sb, o_sh, scale, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {  // the element type alone picks the kernel
    case kBf16: return static_cast<int>(dispatch_decode_mma(a, s));
    case kF32: return static_cast<int>(launch_decode<float>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_decode(
    const void* q, const void* k, const void* v, const void* length,
    void* part, void* o, int dtype, int B, int T, int H, int KV, int D,
    int splits, int rows, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
    int64_t o_sb, int64_t o_sh, float scale, void* stream) {
  return decode_entry(q, k, v, length, part, o, nullptr, dtype, B, T, H, KV,
                      D, splits, rows, q_sb, q_sh, k_sb, k_st, k_sh, v_sb,
                      v_st, v_sh, o_sb, o_sh, scale, stream);
}

// The partial mode: o (f32, strides o_sb, o_sh) and lse (f32, (B, H)
// contiguous) of the rows < length, for a combine across row blocks
extern "C" int flash_attention_decode_partial(
    const void* q, const void* k, const void* v, const void* length,
    void* part, void* o, void* lse, int dtype, int B, int T, int H, int KV,
    int D, int splits, int rows, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
    int64_t o_sb, int64_t o_sh, float scale, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return decode_entry(q, k, v, length, part, o, static_cast<float*>(lse),
                      dtype, B, T, H, KV, D, splits, rows, q_sb, q_sh, k_sb,
                      k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh, scale,
                      stream);
}
