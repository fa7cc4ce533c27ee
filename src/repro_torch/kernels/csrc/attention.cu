// Flash attention (forward, online softmax) for Hopper (sm_90a): three
// kernels, one per path of attention_kernel.attention_path.
//
// Replaces repro/kernels/attention_kernel.py: flash_attention (_flash_body)
// and flash_attention_gqa. What each computes is _flash_body's: q scaled by
// 1/sqrt(hd) in float32; keys at or past Sk masked; with causal, key j
// visible to query i iff j <= i, counted from index 0 (top left); the
// running max, sum and float32 accumulator updated tile by tile, a -inf
// running max made safe as m_safe is; out = acc / max(l, 1e-30), so a row
// with no visible key returns 0; cast to q's dtype. Operands are addressed
// by (b, head, row) element strides with the head dimension contiguous, so
// (BH, S, hd) and (B, S, H, hd) layouts both go in without a copy; GQA
// head h reads KV head h / (H / KV) through its strides, nothing repeated.
// Query rows past Sq and key rows past Sk are masked by index: nothing is
// padded in memory.
//
// 1. simt_kernel (path "simt": float32 operands, or bfloat16 with hd not a
//    multiple of 16). The TPU kernel walked (BQ=128, BK=512) float32 tiles
//    through VMEM, the KV axis the sequential grid axis carrying (m, l, acc)
//    in scratch; at hd=128 those tiles exceed an SM's shared memory. Here
//    one CTA of 256 threads owns 64 query rows of one (b, h) and streams
//    64-row K/V tiles through shared memory in a loop, (m, l, acc) in
//    registers: thread (ty, tx) = (tid / 16, tid % 16) holds rows 4 ty ..
//    4 ty + 3, score columns tx + 16 j (j < 4) and output columns tx + 16 c
//    (c < HDP / 16). HDP is hd rounded up to 16, 32, 64, 128, 192 or 256;
//    the columns past hd load as 0 and are not stored. Above 256 (CHUNK)
//    the grid's z axis walks the output columns in slices of 256: each CTA
//    accumulates S = Q K^T over the whole head dim, staging Q and K through
//    the same shared memory 256 columns at a time (the fma chain runs over
//    d in order, as below 256), then applies the online softmax and
//    accumulates P V for its own 256 output columns only; every slice's CTA
//    recomputes the same S. Every product is an IEEE float32 fma on the
//    CUDA cores (TF32's 10-bit mantissa cannot hold rtol 2e-4). Bound:
//    operations (4 BH Sq Sk hd flops, half of it under the causal mask,
//    over the card's 67 TFLOP/s float32 rate).
//
// 2. decode_kernel (path "decode": G * Sq <= 16 rows share a KV head, any
//    dtype and hd). The 64-row CTA of the simt kernel would leave all but
//    G * Sq rows idle and walk every key serially. Here one CTA takes
//    (split, KV head, b): its rows are the G query heads x Sq queries of
//    that KV head, and it walks `tps` 64-key tiles (one, up to 256 splits;
//    16-byte loads where rows are aligned), (m, l) per row in shared memory
//    and its share of acc in registers. It writes a partial (m, l, acc) in
//    float32 to scratch; the last CTA of each (b, KV head) to finish (a
//    ticket taken after __threadfence, as reduce.cu does) merges the
//    partials by log-sum-exp, a split whose m is -inf weighing 0, and sets
//    the ticket back to 0. One launch; CTAs = B * KV * nsplit
//    (attention_kernel.decode_split). Bound: bytes (K and V read once).
//
// 3. tc_kernel (path "wgmma": bfloat16 with hd a multiple of 16, hd <= 256).
//    Tensor-core prefill. A CTA is NWG consumer warpgroups of 64 query rows
//    (NWG = 2 for hd <= 128, 1 above) and one producer warp. The producer's
//    one lane brings Q once and the K/V tiles (64 keys x 64 columns per TMA
//    box, 128-byte swizzle, zero fill past Sk and past hd) into a 2-stage
//    ring of shared-memory buffers, each stage with a full and an empty
//    mbarrier. Each consumer warpgroup issues wgmma m64n64k16 (bf16
//    operands, float32 accumulators): S = Q K^T with A and B from shared
//    memory, then the online softmax on S in registers in float32 (exp2 of
//    log2(e)-scaled scores), then O += P V with P from registers and V^T
//    read MN-major from the same swizzled tiles. (Issuing the next tile's S
//    before this tile's softmax, with 3 stages, measured slower: 1.21 ms
//    against 1.05 at the 1 x 8192 prefill, chip_smoke.py, NVIDIA H100 80GB
//    HBM3, 700.00 W.) Causal tiles wholly above
//    the diagonal are skipped; the diagonal tiles are masked by index. hd is
//    padded to HDP = 64 * NC columns by TMA's zero fill only (nothing in
//    memory), and columns past hd are not stored.
//    Numerics against the float32 reference: bf16 x bf16 products are exact
//    in float32, so S differs only by where the scale is applied (one f32
//    rounding) and by summation order. P in [0, 1] is not bf16: it enters
//    P V as two bf16 products, P_hi = bf16(P) and P_lo = bf16(P - P_hi)
//    (P - P_hi is exact in f32), so |P - P_hi - P_lo| <= 2^-16 P (two
//    bf16 roundings of 2^-8 each) and each output is off the exact
//    float32 P V / l by at most 2^-16 sum_j p_j |v_j| / l plus the float32
//    summation error; l sums the float32 P. (split_p = 0 runs P_hi alone:
//    2^-8 P, outside the tolerance; only benchmarks_torch/attention_paths.py
//    passes it, as a note.) Bound: operations at prefill shapes
//    (over the 989 TFLOP/s bf16 tensor-core rate), bytes at short ones.

#include <cuda.h>

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
  int hd;
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// ---------------------------------------------------------------------------
// 1. The CUDA-core kernel
// ---------------------------------------------------------------------------

template <int HDP>
constexpr size_t simt_smem_bytes() {
  // Q [BQ][HDP] (scaled), K [BK][HDP + 1] (padded: a warp reads 16 rows at
  // one column), V [BK][HDP], P [BQ][BK]
  return sizeof(float) *
         ((size_t)BQ * HDP + (size_t)BK * (HDP + 1) + (size_t)BK * HDP +
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

// CHUNK (hd > 256, HDP = 256): this CTA stores output columns
// [256 z, 256 z + 256) and stages Q and K in 256-column slices.
template <typename T, int HDP, bool CHUNK>
__global__ void __launch_bounds__(THREADS, HDP <= 128 ? 2 : 1)
simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, Args a) {
  constexpr int KS = HDP + 1;
  constexpr int CW = HDP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * HDP;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * HDP;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int hd = a.hd;
  const long long bh = blockIdx.x;
  const long long b = bh / a.H, h = bh % a.H;
  const long long kvh = h / (a.H / a.KV);
  const long long q0 = (long long)blockIdx.y * BQ;
  const int c0 = CHUNK ? (int)blockIdx.z * HDP : 0;  // first output column
  const T* qp = q + b * a.qb + h * a.qh;
  const T* kp = k + b * a.kb + kvh * a.kh;
  const T* vp = v + b * a.vb + kvh * a.vh;
  T* op = out + b * a.ob + h * a.oh;
  const float NEG_INF = neg_inf();

  // Q's columns [d0, d0 + HDP), scaled; zero past Sq and past hd
  auto stage_q = [&](int d0) {
    for (int i = tid; i < BQ * HDP; i += THREADS) {
      const int r = i / HDP, c = d0 + i % HDP;
      const long long pos = q0 + r;
      Qs[i] = pos < a.Sq && c < hd
                  ? ak_to_float(qp[pos * a.qs + c]) * a.scale : 0.f;
    }
  };
  if (!CHUNK) stage_q(0);

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
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    // one slice of HDP columns below 256; hd / 256 rounded up above
    for (int d0 = 0; d0 < (CHUNK ? hd : 1); d0 += HDP) {
      __syncthreads();  // Q written; the previous slice's or tile's Q, K,
                        // V, P read
      if (CHUNK) stage_q(d0);
      for (int i = tid; i < BK * HDP; i += THREADS) {
        const int r = i / HDP, c = i % HDP;
        const long long pos = k0 + r;
        Ks[r * KS + c] = pos < a.Sk && d0 + c < hd
                             ? ak_to_float(kp[pos * a.ks + d0 + c]) : 0.f;
        if (d0 == 0)  // V: this CTA's output columns
          Vs[i] = pos < a.Sk && c0 + c < hd
                      ? ak_to_float(vp[pos * a.vs + c0 + c]) : 0.f;
      }
      __syncthreads();

#pragma unroll 8
      for (int d = 0; d < HDP; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * HDP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
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
        const float vv = Vs[c * HDP + tx + 16 * cc];
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
    for (int c = 0; c < CW; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < hd) op[qpos * a.os + col] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int HDP, bool CHUNK = false>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                long long BH, const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = simt_smem_bytes<HDP>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        simt_kernel<T, HDP, CHUNK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned int)BH, (unsigned int)((a.Sq + BQ - 1) / BQ),
                  CHUNK ? (unsigned int)((a.hd + HDP - 1) / HDP) : 1u);
  simt_kernel<T, HDP, CHUNK><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_simt(const void* q, const void* k, const void* v, void* out,
                  long long BH, const Args& a, cudaStream_t s) {
  const int hd = a.hd;
  if (hd <= 16) return launch_simt<T, 16>(q, k, v, out, BH, a, s);
  if (hd <= 32) return launch_simt<T, 32>(q, k, v, out, BH, a, s);
  if (hd <= 64) return launch_simt<T, 64>(q, k, v, out, BH, a, s);
  if (hd <= 128) return launch_simt<T, 128>(q, k, v, out, BH, a, s);
  if (hd <= 192) return launch_simt<T, 192>(q, k, v, out, BH, a, s);
  if (hd <= 256) return launch_simt<T, 256>(q, k, v, out, BH, a, s);
  return launch_simt<T, 256, true>(q, k, v, out, BH, a, s);
}

// ---------------------------------------------------------------------------
// 2. The split-K decode kernel
// ---------------------------------------------------------------------------

constexpr int DEC_ROWS = 16;                       // G * Sq at most
constexpr int DEC_ACC = DEC_ROWS * 256 / THREADS;  // acc elements a thread
constexpr int DEC_MAX_SPLIT = 256;

struct DecodeArgs {
  int G, R, nsplit, tps;
  int vec;           // K and V rows take 16-byte loads
  float* part_acc;   // [B * KV][nsplit][R][hd]
  float* part_ml;    // [B * KV][nsplit][R][2]
  unsigned int* tickets;  // [B * KV], 0 on entry and on exit
};

// Row stride of K in shared memory: hd padded to 4 mod 32 words, so the 8
// keys x 4 column phases a warp reads in the score loop hit 32 banks.
__host__ __device__ __forceinline__ int decode_kstride(int hd) {
  return hd + (((4 - hd) % 32) + 32) % 32;
}

// Sized by the call's rows and splits, so that a small call keeps three
// CTAs an SM resident (one wave for the decode shape's 320 CTAs).
size_t decode_smem_bytes(int hd, int R, int nsplit) {
  // Q [R][hd], K [BK][kstride], V [BK][hd], P [R][BK], m / l / corr /
  // total [R], the merge's weights [nsplit][R]
  return sizeof(float) *
         ((size_t)R * hd + (size_t)BK * decode_kstride(hd) + (size_t)BK * hd +
          (size_t)R * BK + 4 * (size_t)R + (size_t)nsplit * R);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, Args a,
              DecodeArgs d) {
  extern __shared__ float smem[];
  const int hd = a.hd, R = d.R, KS = decode_kstride(hd);
  float* Qs = smem;                       // [R][hd]
  float* Ks = Qs + R * hd;                // [BK][KS]
  float* Vs = Ks + BK * KS;               // [BK][hd]
  float* Ps = Vs + BK * hd;               // [R][BK]
  float* Ms = Ps + R * BK;
  float* Ls = Ms + R;
  float* Cs = Ls + R;
  float* Tot = Cs + R;
  float* Wt = Tot + R;                    // [nsplit][R]
  __shared__ bool is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x;
  const long long kvh = blockIdx.y, b = blockIdx.z;
  const long long bk = b * a.KV + kvh;
  const float NEG_INF = neg_inf();
  const long long Sq = a.Sq;

  for (int i = tid; i < R * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    const long long h = kvh * d.G + r / Sq, qi = r % Sq;
    Qs[i] = ak_to_float(q[b * a.qb + h * a.qh + qi * a.qs + c]) * a.scale;
  }
  if (tid < R) {
    Ms[tid] = NEG_INF;
    Ls[tid] = 0.f;
  }
  float acc[DEC_ACC];
#pragma unroll
  for (int i = 0; i < DEC_ACC; ++i) acc[i] = 0.f;

  const T* kp = k + b * a.kb + kvh * a.kh;
  const T* vp = v + b * a.vb + kvh * a.vh;
  long long kend = a.Sk;
  if (a.causal && Sq < kend) kend = Sq;
  const long long t_lo = (long long)split * d.tps;
  long long t_hi = t_lo + d.tps;
  const long long ntiles = (kend + BK - 1) / BK;
  if (t_hi > ntiles) t_hi = ntiles;

  constexpr int E = 16 / sizeof(T);  // elements of one 16-byte load
  for (long long t = t_lo; t < t_hi; ++t) {
    const long long k0 = t * BK;
    __syncthreads();  // Q, m, l written; the previous tile's K, V, P read
    if (d.vec) {
      // 16-byte loads: rows of hd elements, hd a multiple of E, aligned
      const int vpr = hd / E;
      for (int i = tid; i < BK * vpr; i += THREADS) {
        const int r = i / vpr, c = (i % vpr) * E;
        const long long pos = k0 + r;
        union { uint4 u; T x[E]; } kv4, vv4;
        if (pos < a.Sk) {
          kv4.u = *reinterpret_cast<const uint4*>(kp + pos * a.ks + c);
          vv4.u = *reinterpret_cast<const uint4*>(vp + pos * a.vs + c);
        } else {
          kv4.u = make_uint4(0, 0, 0, 0);
          vv4.u = make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          Ks[r * KS + c + e] = ak_to_float(kv4.x[e]);
          Vs[r * hd + c + e] = ak_to_float(vv4.x[e]);
        }
      }
    } else {
      for (int i = tid; i < BK * hd; i += THREADS) {
        const int r = i / hd, c = i % hd;
        const long long pos = k0 + r;
        const bool ok = pos < a.Sk;
        Ks[r * KS + c] = ok ? ak_to_float(kp[pos * a.ks + c]) : 0.f;
        Vs[i] = ok ? ak_to_float(vp[pos * a.vs + c]) : 0.f;
      }
    }
    __syncthreads();
    // scores: four neighbouring threads share a dot, thread phase p taking
    // the columns c = p mod 4, then two shuffles
    for (int i = tid; i < R * BK * 4; i += THREADS) {
      const int dot = i >> 2, p = i & 3;
      const int r = dot / BK, j = dot % BK;
      float s = 0.f;
      for (int c = p; c < hd; c += 4)
        s = fmaf(Qs[r * hd + c], Ks[j * KS + c], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const long long kpos = k0 + j, qi = r % Sq;
      const bool ok = kpos < a.Sk && (!a.causal || kpos <= qi);
      if (p == 0) Ps[dot] = ok ? s : NEG_INF;
    }
    __syncthreads();
    for (int r = warp; r < R; r += THREADS / 32) {
      const float s0 = Ps[r * BK + lane], s1 = Ps[r * BK + lane + 32];
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m_old) ? expf(m_old - m_safe) : 0.f;
      const float p0 = s0 == NEG_INF ? 0.f : expf(s0 - m_safe);
      const float p1 = s1 == NEG_INF ? 0.f : expf(s1 - m_safe);
      Ps[r * BK + lane] = p0;
      Ps[r * BK + lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        Ls[r] = Ls[r] * corr + psum;
        Ms[r] = m_new;
        Cs[r] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DEC_ACC; ++i) {
      const int e = tid + i * THREADS;
      if (e < R * hd) {
        const int r = e / hd, c = e % hd;
        float x = acc[i] * Cs[r];
        for (int j = 0; j < BK; ++j)
          x = fmaf(Ps[r * BK + j], Vs[j * hd + c], x);
        acc[i] = x;
      }
    }
  }
  __syncthreads();

  // this split's partial
  float* pa = d.part_acc + ((bk * d.nsplit + split) * R) * hd;
  float* pm = d.part_ml + ((bk * d.nsplit + split) * R) * 2;
#pragma unroll
  for (int i = 0; i < DEC_ACC; ++i) {
    const int e = tid + i * THREADS;
    if (e < R * hd) pa[e] = acc[i];
  }
  if (tid < R) {
    pm[2 * tid] = Ms[tid];
    pm[2 * tid + 1] = Ls[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(d.tickets + bk, 1u) == (unsigned)d.nsplit - 1;
  __syncthreads();
  if (!is_last) return;

  // Last CTA of (b, KV head): every partial is visible (fence + ticket).
  // Row r's weights exp(m_s - M) (0 where m_s is -inf) and total
  // sum_s w_s l_s, then out = sum_s w_s acc_s / max(total, 1e-30).
  const float* ga = d.part_acc + (bk * d.nsplit) * R * hd;
  const float* gm = d.part_ml + (bk * d.nsplit) * R * 2;
  for (int r = warp; r < R; r += THREADS / 32) {
    float mx = NEG_INF;
    for (int s = lane; s < d.nsplit; s += 32)
      mx = fmaxf(mx, __ldcg(gm + (s * R + r) * 2));
    mx = warp_max(mx);
    const float m_safe = isfinite(mx) ? mx : 0.f;
    float tot = 0.f;
    for (int s = lane; s < d.nsplit; s += 32) {
      const float ms = __ldcg(gm + (s * R + r) * 2);
      const float w = isfinite(ms) ? expf(ms - m_safe) : 0.f;
      Wt[s * R + r] = w;
      tot += w * __ldcg(gm + (s * R + r) * 2 + 1);
    }
    tot = warp_sum(tot);
    if (lane == 0) Tot[r] = fmaxf(tot, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < R * hd; e += THREADS) {
    const int r = e / hd, c = e % hd;
    float x = 0.f;
    for (int s = 0; s < d.nsplit; ++s)
      x = fmaf(Wt[s * R + r], __ldcg(ga + (s * R + r) * hd + c), x);
    const long long h = kvh * d.G + r / Sq, qi = r % Sq;
    out[b * a.ob + h * a.oh + qi * a.os + c] = from_float<T>(x / Tot[r]);
  }
  if (tid == 0) d.tickets[bk] = 0;  // ready for the next call
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, void* out,
                  long long B, const Args& a, const DecodeArgs& d,
                  cudaStream_t stream) {
  if (d.R < 1 || d.R > DEC_ROWS || d.nsplit < 1 ||
      d.nsplit > DEC_MAX_SPLIT || a.hd > 256)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = decode_smem_bytes(a.hd, d.R, d.nsplit);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)decode_smem_bytes(256, DEC_ROWS, DEC_MAX_SPLIT));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned int)d.nsplit, (unsigned int)a.KV,
                  (unsigned int)B);
  decode_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), a, d);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3. The tensor-core prefill kernel (wgmma + TMA + mbarrier ring)
// ---------------------------------------------------------------------------

constexpr int TC_STAGES = 2;
constexpr int TILE_BYTES = 64 * 64 * 2;  // one 64 x 64 bf16 TMA box

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem,
// K-major: 64 rows of K); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16 bf16, registers) * B (16 x 64, smem,
// MN-major: 16 rows of V, each 64 contiguous columns).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct TcArgs {
  long long H, KV, Sq, Sk;
  long long ob, oh, os;
  float scale_log2;  // log2(e) / sqrt(hd)
  int causal, hd, split_p;
};

// Accumulator layout of wgmma m64nN (f32), thread t of the warpgroup, warp
// w = t / 32, lane l: d[4 i + 2 h + e] holds row 16 w + l / 4 + 8 h, column
// 8 i + 2 (l % 4) + e. The A fragment of an m64k16 product from registers
// takes, for k-step kk, rows 16 w + l / 4 (+8) and columns 16 kk + 2 (l % 4)
// (+1, +8, +9): the same registers, d[8 kk .. 8 kk + 7], packed in pairs.
template <int NWG, int NC>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
tc_kernel(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          __nv_bfloat16* __restrict__ out, TcArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[TC_STAGES], empty[TC_STAGES], qbar;
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = base;                                  // [NWG][NC] boxes
  uint8_t* Ks = Qs + NWG * NC * TILE_BYTES;            // [STAGES][NC]
  uint8_t* Vs = Ks + TC_STAGES * NC * TILE_BYTES;      // [STAGES][NC]

  const int tid = threadIdx.x;
  const int nqt = gridDim.x;
  const int qt = a.causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = (int)(h / (a.H / a.KV));
  const long long q0 = (long long)qt * (NWG * 64);
  long long kend = a.Sk;
  if (a.causal && q0 + NWG * 64 < kend) kend = q0 + NWG * 64;
  const int ntiles = (int)((kend + BK - 1) / BK);

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == NWG) {
    // producer warp: one lane issues every TMA copy
    if (tid == NWG * 128) {
      mbar_expect_tx(&qbar, NWG * NC * TILE_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load_4d(Qs + (w * NC + c) * TILE_BYTES, &qmap, &qbar, c * 64,
                      (int)(q0 + w * 64), h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % TC_STAGES, r = t / TC_STAGES;
        if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
        mbar_expect_tx(&full[s], 2 * NC * TILE_BYTES);
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(Ks + (s * NC + c) * TILE_BYTES, &kmap, &full[s], c * 64,
                      t * BK, kvh, b);
          tma_load_4d(Vs + (s * NC + c) * TILE_BYTES, &vmap, &full[s], c * 64,
                      t * BK, kvh, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  const int lt = tid % 128, warp = lt / 32, lane = lt % 32;
  const long long row0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const long long row1 = row0 + 8;
  const int cq = 2 * (lane % 4);
  const float NEG_INF = neg_inf();
  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(&qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % TC_STAGES;
    mbar_wait(&full[s], (t / TC_STAGES) & 1);

    // S = Q K^T over HDP = 64 NC columns, 16 at a time
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NC * 4; ++kk) {
      const int c = kk / 4, off = (kk % 4) * 32;
      const uint64_t da = sw128_desc(Qs + (wg * NC + c) * TILE_BYTES + off,
                                     16, 1024);
      const uint64_t db = sw128_desc(Ks + (s * NC + c) * TILE_BYTES + off,
                                     16, 1024);
      wgmma_ss(sc, da, db, kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(sc);

    // mask, then the online softmax in base 2 (scores times log2(e))
    const long long k0 = (long long)t * BK;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long kpos = k0 + 8 * i + cq + e;
        const bool ok0 = kpos < a.Sk && (!a.causal || kpos <= row0);
        const bool ok1 = kpos < a.Sk && (!a.causal || kpos <= row1);
        sc[4 * i + e] = ok0 ? sc[4 * i + e] * a.scale_log2 : NEG_INF;
        sc[4 * i + 2 + e] = ok1 ? sc[4 * i + 2 + e] * a.scale_log2 : NEG_INF;
        mx0 = fmaxf(mx0, sc[4 * i + e]);
        mx1 = fmaxf(mx1, sc[4 * i + 2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float s0 = isfinite(n0) ? n0 : 0.f, s1 = isfinite(n1) ? n1 : 0.f;
    const float corr0 = isfinite(m0) ? exp2f(m0 - s0) : 0.f;
    const float corr1 = isfinite(m1) ? exp2f(m1 - s1) : 0.f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2f(sc[4 * i + e] - s0);      // 0 where masked
        const float p1 = exp2f(sc[4 * i + 2 + e] - s1);
        sc[4 * i + e] = p0;
        sc[4 * i + 2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[c][4 * i] *= corr0;
        o[c][4 * i + 1] *= corr0;
        o[c][4 * i + 2] *= corr1;
        o[c][4 * i + 3] *= corr1;
      }

    // P as bf16 A fragments: hi = bf16(P), lo = bf16(P - hi)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[kk][r] = pack_bf16(x - __low2float(hi), y - __high2float(hi));
      }
    }

    // O += P V: output columns 64 c .. 64 c + 63 from V box c, 16 keys a step
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = sw128_desc(
            Vs + (s * NC + c) * TILE_BYTES + kk * 16 * 128, 8192, 1024);
        wgmma_rs(o[c], ph[kk], db);
        if (a.split_p) wgmma_rs(o[c], pl[kk], db);
      }
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    if (lt == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: out = acc / max(l, 1e-30), bf16 pairs straight from registers
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + (long long)b * a.ob + (long long)h * a.oh;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = c * 64 + 8 * i + cq;
      if (col >= a.hd) continue;
      if (row0 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * a.os + col) =
            __floats2bfloat162_rn(o[c][4 * i] / d0, o[c][4 * i + 1] / d0);
      if (row1 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row1 * a.os + col) =
            __floats2bfloat162_rn(o[c][4 * i + 2] / d1, o[c][4 * i + 3] / d1);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-d bf16 map of (hd, S, heads, B) with element strides (1, s, h, b):
// 64 x 64 boxes, 128-byte swizzle, zero fill out of bounds. A dimension of
// extent 1 takes a harmless stride (the row stride times S).
int make_map(CUtensorMap* map, const void* ptr, long long hd, long long S,
             long long heads, long long B, long long sb, long long sh,
             long long ss) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const long long filler = ss * (S > 0 ? S : 1);
  if (heads == 1) sh = filler;
  if (B == 1) sb = filler;
  cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)(S > 0 ? S : 1),
                        (cuuint64_t)heads, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                           (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {64, 64, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NWG, int NC>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              long long B, const Args& a, int split_p, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, a.hd, a.Sq, a.H, B, a.qb, a.qh, a.qs);
  if (err) return err;
  err = make_map(&km, k, a.hd, a.Sk, a.KV, B, a.kb, a.kh, a.ks);
  if (err) return err;
  err = make_map(&vm, v, a.hd, a.Sk, a.KV, B, a.vb, a.vh, a.vs);
  if (err) return err;
  const size_t bytes =
      (size_t)(NWG * NC + 2 * TC_STAGES * NC) * TILE_BYTES + 1024;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        tc_kernel<NWG, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const TcArgs t{a.H, a.KV, a.Sq, a.Sk, a.ob, a.oh, a.os,
                 a.scale * 1.4426950408889634f, a.causal, a.hd, split_p};
  const dim3 grid((unsigned int)((a.Sq + NWG * 64 - 1) / (NWG * 64)),
                  (unsigned int)a.H, (unsigned int)B);
  tc_kernel<NWG, NC><<<grid, NWG * 128 + 32, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), t);
  return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v, void* out,
                long long B, const Args& a, int split_p, cudaStream_t s) {
  if (a.hd % 16 != 0) return (int)cudaErrorInvalidValue;
  switch ((a.hd + 63) / 64) {
    case 1: return launch_tc<2, 1>(q, k, v, out, B, a, split_p, s);
    case 2: return launch_tc<2, 2>(q, k, v, out, B, a, split_p, s);
    case 3: return launch_tc<1, 3>(q, k, v, out, B, a, split_p, s);
    case 4: return launch_tc<1, 4>(q, k, v, out, B, a, split_p, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q: B x H heads of Sq rows, k and v: B x KV heads of Sk rows, out like q;
// each addressed by element strides of (b, head, row) with the head dim
// contiguous. dtype: AK_F32 or AK_BF16 for all four; hd >= 1 (at most 256
// on paths 1 and 2); H a multiple of KV. path: 0 the CUDA-core kernel (any
// hd), 1 the split-K decode kernel
// (G * Sq <= 16 rows; nsplit CTAs per (b, KV head) of tps 64-key tiles
// each; part_acc, part_ml scratch of B * KV * nsplit * G * Sq * (hd, 2)
// floats; tickets B * KV zeros, zeros again on exit), 2 the tensor-core
// kernel (bf16, hd a multiple of 16, 16-byte aligned operands and strides;
// split_p 0 drops the P_lo product).
AK_EXPORT int ak_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int path, long long B, long long H, long long KV, long long Sq,
    long long Sk, long long hd, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long vb, long long vh,
    long long vs, long long ob, long long oh, long long os, float scale,
    int causal, int nsplit, int tps, void* part_acc, void* part_ml,
    void* tickets, int split_p, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (hd < 1 || (path != 0 && hd > 256) || KV <= 0 || H % KV)
    return (int)cudaErrorInvalidValue;
  const Args a{H, KV, Sq, Sk, qb, qh, qs, kb, kh, ks,
               vb, vh, vs, ob, oh, os, scale, causal, (int)hd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    if (dtype != AK_BF16) return (int)cudaErrorInvalidValue;
    return dispatch_tc(q, k, v, out, B, a, split_p, s);
  }
  if (path == 1) {
    const int G = (int)(H / KV);
    const int E = dtype == AK_F32 ? 4 : 8;
    const bool vec =
        hd % E == 0 && ks % E == 0 && vs % E == 0 && kb % E == 0 &&
        kh % E == 0 && vb % E == 0 && vh % E == 0 &&
        reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(v) % 16 == 0;
    const DecodeArgs d{G, (int)(G * Sq), nsplit, tps, vec ? 1 : 0,
                       static_cast<float*>(part_acc),
                       static_cast<float*>(part_ml),
                       static_cast<unsigned int*>(tickets)};
    if (dtype == AK_F32) return launch_decode<float>(q, k, v, out, B, a, d, s);
    if (dtype == AK_BF16)
      return launch_decode<__nv_bfloat16>(q, k, v, out, B, a, d, s);
    return (int)cudaErrorInvalidValue;
  }
  if (path == 0) {
    if (dtype == AK_F32) return dispatch_simt<float>(q, k, v, out, B * H, a, s);
    if (dtype == AK_BF16)
      return dispatch_simt<__nv_bfloat16>(q, k, v, out, B * H, a, s);
  }
  return (int)cudaErrorInvalidValue;
}
