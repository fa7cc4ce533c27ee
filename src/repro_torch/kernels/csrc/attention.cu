// Flash attention (forward, online softmax) for Hopper (sm_90a).
//
// Replaces repro/kernels/attention_kernel.py: flash_attention (_flash_body)
// and flash_attention_gqa. What it computes is _flash_body's: q scaled by
// 1/sqrt(hd) in float32 before the dot; keys at or past Sk masked; with
// causal, key j visible to query i iff j <= i, counted from index 0 (top
// left); the running max, sum and float32 accumulator updated tile by tile,
// a -inf running max made safe as m_safe is; out = acc / max(l, 1e-30), so
// a row with no visible key returns 0; cast to q's dtype.
//
// The TPU kernel walked (BQ=128, BK=512) float32 tiles through VMEM, the KV
// axis the sequential grid axis carrying (m, l, acc) in scratch. At hd=128
// those tiles (64 KiB of Q, 256 KiB each of K and V) exceed an SM's shared
// memory. Here one CTA of 256 threads owns 64 query rows of one (b, h) and
// streams 64-row K/V tiles through shared memory in a loop (the sequential
// grid axis), with (m, l, acc) in registers: thread (ty, tx) = (tid / 16,
// tid % 16) holds rows 4 ty .. 4 ty + 3, score columns tx + 16 j (j < 4)
// and output columns tx + 16 c (c < hd / 16). A row's max and sum fold over
// the 16 threads of its half-warp by shuffles. Every product is an IEEE
// float32 fma on the CUDA cores (no TF32, no __expf); bfloat16 operands are
// widened on load. Query rows past Sq and key rows past Sk are masked by
// index (nothing is padded in memory); causal tiles wholly above the
// diagonal are skipped, which changes nothing (their p is 0 and corr 1).
//
// GQA: head h reads KV head h / (H / KV) through its strides; nothing is
// repeated. Operands are addressed by (b, h, s) element strides with the
// head dimension contiguous, so (BH, S, hd) and (B, S, H, hd) layouts both
// go in without a copy.
//
// Bound: operations at prefill shapes (4 BH Sq Sk hd flops, half of it
// under the causal mask, over the card's float32 rate), bytes (q, k, v read
// once, out written once) at decode shapes.

#include "ak_common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

struct Args {
  long long H, KV, Sq, Sk;
  long long qb, qh, qs;  // element strides of (b, h, s); the head dim is 1
  long long kb, kh, ks;
  long long vb, vh, vs;
  long long ob, oh, os;
  float scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q [BQ][HD] (scaled), K [BK][HD + 1] (padded: a warp reads 16 rows at
  // one column), V [BK][HD], P [BQ][BK]
  return sizeof(float) *
         ((size_t)BQ * HD + (size_t)BK * (HD + 1) + (size_t)BK * HD +
          (size_t)BQ * BK);
}

__device__ __forceinline__ float row_max16(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, Args a) {
  constexpr int KS = HD + 1;
  constexpr int CW = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * HD;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * HD;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long bh = blockIdx.x;
  const long long b = bh / a.H, h = bh % a.H;
  const long long kvh = h / (a.H / a.KV);
  const long long q0 = (long long)blockIdx.y * BQ;
  const T* qp = q + b * a.qb + h * a.qh;
  const T* kp = k + b * a.kb + kvh * a.kh;
  const T* vp = v + b * a.vb + kvh * a.vh;
  T* op = out + b * a.ob + h * a.oh;
  const float NEG_INF = __int_as_float(0xff800000);

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    const long long pos = q0 + r;
    Qs[i] = pos < a.Sq ? ak_to_float(qp[pos * a.qs + c]) * a.scale : 0.f;
  }

  float acc[4][CW];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  long long kend = a.Sk;
  if (a.causal) {
    const long long last = (q0 + BQ < a.Sq ? q0 + BQ : a.Sq) - 1;
    if (last + 1 < kend) kend = last + 1;
  }
  const long long ntiles = (kend + BK - 1) / BK;

  for (long long t = 0; t < ntiles; ++t) {
    const long long k0 = t * BK;
    __syncthreads();  // Q written; the previous tile's K, V, P read
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, c = i % HD;
      const long long pos = k0 + r;
      const bool ok = pos < a.Sk;
      Ks[r * KS + c] = ok ? ak_to_float(kp[pos * a.ks + c]) : 0.f;
      Vs[i] = ok ? ak_to_float(vp[pos * a.vs + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q0 + ty * 4 + i;
      bool valid[4];
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k0 + tx + 16 * j;
        valid[j] = kpos < a.Sk && (!a.causal || kpos <= qpos);
        if (!valid[j]) s[i][j] = NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = row_max16(rmax);
      const float m_new = fmaxf(m[i], rmax);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_safe) : 0.f;
        Ps[(ty * 4 + i) * BK + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P written

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * BK + c];
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) {
        const float vv = Vs[c * HD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long qpos = q0 + ty * 4 + i;
    if (qpos >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CW; ++c)
      op[qpos * a.os + tx + 16 * c] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           long long BH, const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned int)BH, (unsigned int)((a.Sq + BQ - 1) / BQ));
  flash_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(long long hd, const void* q, const void* k, const void* v,
                void* out, long long BH, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, BH, a, s);
    case 32: return launch<T, 32>(q, k, v, out, BH, a, s);
    case 64: return launch<T, 64>(q, k, v, out, BH, a, s);
    case 128: return launch<T, 128>(q, k, v, out, BH, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: B x H heads of Sq rows, k and v: B x KV heads of Sk rows, out like q;
// each addressed by element strides of (b, head, row) with the head dim
// contiguous. dtype: AK_F32 or AK_BF16 for all four. hd in {16, 32, 64,
// 128}; H a multiple of KV.
AK_EXPORT int ak_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype,
    long long B, long long H, long long KV, long long Sq, long long Sk,
    long long hd, long long qb, long long qh, long long qs, long long kb,
    long long kh, long long ks, long long vb, long long vh, long long vs,
    long long ob, long long oh, long long os, float scale, int causal,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  const Args a{H, KV, Sq, Sk, qb, qh, qs, kb, kh, ks,
               vb, vh, vs, ob, oh, os, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == AK_F32)
    return dispatch_hd<float>(hd, q, k, v, out, B * H, a, s);
  if (dtype == AK_BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B * H, a, s);
  return (int)cudaErrorInvalidValue;
}
