// Online-softmax attention for Hopper (sm_90a): prefill and one-token decode.
//
// Replaces the two Pallas kernels of the JAX package's
// src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_fwd     flash_attention (body _fa_fwd_kernel): causal or
//                           non-causal attention of S queries over Sk keys;
//   flash_attention_decode  flash_decode (body _fa_decode_kernel): one query
//                           per head against a KV cache whose positions
//                           >= length are masked, length a runtime operand.
//
// What both compute is the Pallas body, step for step:
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
// Bounds on an H100 and what the design does about them:
//   prefill is bound by operations: 4 B H D (S^2 + S) / 2 for causal
//   attention (twice that non-causal), over 989 TFLOP/s in bf16 on the
//   tensor cores, or 67 TFLOP/s for f32 FMA outside them, which is the
//   rate this first kernel can reach.  One block of 256 threads per
//   (64-query tile, head, batch), tiles in reverse order so that the long
//   causal rows start first.  The Q tile and one K or V tile at a time sit
//   in shared memory as f32 (rows padded by 4 words: conflict-free float4
//   reads), the scores of a 64 x 64 tile in registers, 4 rows x 4 columns
//   per thread; m, l and the 64 x D accumulator stay in registers, a
//   thread's accumulator rows being its score rows, so alpha and l never
//   leave the thread.  Key tiles past the causal limit are never loaded.
//   Products are FMA; mma/wgmma and TMA are later work.
//
//   decode is bound by bytes: K and V rows < length of every (batch, KV
//   head), plus q and out, over 3.35 TB/s.  One block per (KV head, chunk
//   of at most 4 of its G query heads, batch), so each K and V row is read
//   once for the heads that share it.  A group of lanes covers one row with
//   16-byte loads; the block's 8 warps hold 8 x (32 / lanes per row)
//   independent running (m, l, acc) states over interleaved rows, combined
//   at the end (flash-decoding inside one block: another summation order
//   than Pallas's one running state).  The loop stops at length, read from
//   a device int32, so the host never waits and a captured decode step
//   stays valid at every position.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Dtype { kBf16 = 2, kF32 = 3 };

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF
constexpr int kThreads = 256;
constexpr int kBQ = 64;            // query rows of a prefill tile
constexpr int kBK = 64;            // key rows of a prefill tile
constexpr int kPad = 4;            // shared-memory row padding, in words
constexpr int kGMax = 4;           // query heads a decode block serves

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
// prefill
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
// decode
// ---------------------------------------------------------------------------

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* length;
  void* o;
  int B, T, H, G, D;
  int lanes;  // lanes per cache row: a power of two <= 32
  int64_t q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_sh;
  float scale;
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

// NV: 16-byte vectors per lane and row (1, or 2 for f32 rows of D > 128)
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const DecodeArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int E = NV * VEC;  // elements a lane holds of one row
  __shared__ float sm_m[kThreads];
  __shared__ float sm_l[kThreads];
  __shared__ float sm_acc[kThreads * 8];  // streams x D <= 256 E = 2048

  const int lanes = a.lanes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (lanes - 1);      // lane within its row group
  const int rows_per_warp = 32 / lanes;
  const int stream = threadIdx.x / lanes;  // this group's running state
  const int n_streams = kThreads / lanes;
  const int hk = blockIdx.x, g0 = blockIdx.y * kGMax, b = blockIdx.z;
  const int ng = min(kGMax, a.G - g0);

  const int len = *a.length;
  const bool all_masked = len <= 0;  // every score -1e30: p = 1 everywhere
  const int n = all_masked ? a.T : min(len, a.T);

  bool has[NV];
  int col[NV];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    col[u] = (sub + lanes * u) * VEC;
    has[u] = col[u] < a.D;
  }

  float q[kGMax][E];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    const T* qg = static_cast<const T*>(a.q) + b * a.q_sb +
                  (hk * a.G + g0 + min(g, ng - 1)) * a.q_sh;
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        q[g][u * VEC + e] = has[u] ? to_f32(qg[col[u] + e]) : 0.0f;
  }

  float m[kGMax], l[kGMax], acc[kGMax][E];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  }

  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  // every lane of a warp runs the same iterations (the shuffles need them)
  for (int t0 = warp * rows_per_warp; t0 < n; t0 += n_streams) {
    const int t = t0 + lane / lanes;
    const bool valid = t < n;
    float kf[E], vf[E];
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      if (valid && has[u]) {
        load_vec(kg + static_cast<int64_t>(t) * a.k_st + col[u], kf + u * VEC);
        load_vec(vg + static_cast<int64_t>(t) * a.v_st + col[u], vf + u * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[u * VEC + e] = vf[u * VEC + e] = 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g >= ng) break;
      float dot = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(q[g][e], kf[e], dot);
      for (int off = lanes >> 1; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (!valid) continue;
      const float s = all_masked ? kNegInf : dot * a.scale;
      const float m_new = fmaxf(m[g], s);
      const float p = expf(s - m_new);
      const float alpha = expf(m[g] - m_new);
      l[g] = l[g] * alpha + p;
      const float pc = round_to<T>(p);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pc, vf[e], acc[g][e] * alpha);
      m[g] = m_new;
    }
  }

  // combine the block's running states, one head at a time (unrolled, so
  // that m, l and acc stay in registers; ng is the same in the whole block)
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g >= ng) break;
    if (sub == 0) {
      sm_m[stream] = m[g];
      sm_l[stream] = l[g];
    }
#pragma unroll
    for (int u = 0; u < NV; ++u)
      if (has[u])
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[stream * a.D + col[u] + e] = acc[g][u * VEC + e];
    __syncthreads();
    if (threadIdx.x < a.D) {
      const int d = threadIdx.x;
      float mx = kNegInf;
      for (int r = 0; r < n_streams; ++r) mx = fmaxf(mx, sm_m[r]);
      float lsum = 0.0f, asum = 0.0f;
      for (int r = 0; r < n_streams; ++r) {
        const float w = expf(sm_m[r] - mx);
        lsum = fmaf(sm_l[r], w, lsum);
        asum = fmaf(sm_acc[r * a.D + d], w, asum);
      }
      T* og = static_cast<T*>(a.o) + b * a.o_sb + (hk * a.G + g0 + g) * a.o_sh;
      og[d] = from_f32<T>(asum / fmaxf(lsum, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int NV>
cudaError_t launch_decode(const DecodeArgs& a, cudaStream_t s) {
  const dim3 grid(a.H / a.G, (a.G + kGMax - 1) / kGMax, a.B);
  decode_kernel<T, NV><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
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
  switch (dtype) {
    case kBf16: return static_cast<int>(dispatch_fwd<__nv_bfloat16>(a, s));
    case kF32: return static_cast<int>(dispatch_fwd<float>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_decode(
    const void* q, const void* k, const void* v, const void* length, void* o,
    int dtype, int B, int T, int H, int KV, int D, int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
    int64_t v_sh, int64_t o_sb, int64_t o_sh, float scale, void* stream) {
  if (B <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || D % 8 != 0 ||
      D > 256 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DecodeArgs a{q, k, v, static_cast<const int32_t*>(length), o, B, T, H,
               H / KV, D, 0, q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
               o_sb, o_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == kBf16 ? 8 : 4;
  const int nv = (D / vec + 31) / 32;  // 1, or 2 for f32 rows of D > 128
  a.lanes = pow2_at_least((D / vec + nv - 1) / nv);
  switch (dtype) {
    case kBf16:
      return static_cast<int>(launch_decode<__nv_bfloat16, 1>(a, s));
    case kF32:
      return static_cast<int>(nv == 1 ? launch_decode<float, 1>(a, s)
                                      : launch_decode<float, 2>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
