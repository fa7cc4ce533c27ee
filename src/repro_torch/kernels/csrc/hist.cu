// One-pass min/max + fixed-bin histogram for Hopper (sm_90a).
//
// Replaces repro/kernels/hist_kernel.py: minmax_histogram_blocks
// (_hist_body). The TPU kernel ranked each chunk against the bin ids with
// a one-hot compare matrix because it had no atomics; here the bins are
// counted with shared-memory int atomics (integer counts are exact in any
// order). Binning is bitwise the reference's:
//   width = max((hi - lo) / nbins, 1e-30f)       (f32, IEEE division)
//   b     = clamp(int_rz((float(x) - lo) / width), 0, nbins - 1)
// which is why this file must not be built with --use_fast_math (NaN bins
// to 0: the conversion of NaN gives 0).
//
// Bound: bytes -- one read of x. What the design does about it:
//   * wide loads, many in flight: the elements from the first 16-byte
//     boundary on are read as 16-byte vectors; a warp takes chunks of 32 x
//     kLoads vectors (lane l: vectors l, l + 32, ...), so each thread has
//     kLoads 16-byte loads (16 f32/i32 or 32 bf16 elements) in flight;
//     the misaligned head (a view may start at any element) and the tail
//     after the last whole vector are read by scalar loads in CTA 0;
//   * per-warp sub-histograms in shared memory (<= 1024 bins each), one
//     atomic an element; a CTA sums its warps' counts per bin and adds the
//     nonzero ones to the global histogram.
// Measured on an H100 (PERF.md): one atomic an element runs as fast on
// sorted keys, whose 32 lanes hit one address, as on shuffled ones, and
// faster than counting runs of equal bins in registers with one atomic a
// run (warp-aggregated with __match_any_sync): the run bookkeeping's
// branches cost more than the atomics it saves.
// Min and max: per thread, then warp shuffles, then a per-CTA partial;
// the last CTA to finish (a ticket counter after __threadfence) folds the
// partials. A NaN key makes both NaN, as in the plain version: PTX
// min.NaN / max.NaN, one instruction an end (a NaN test beside a compare
// cost 8-11 us more at 2^26 keys on an H100, PERF.md).

#include "ak_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;  // 16-byte loads a thread has in flight a chunk
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ int bin_of(T v, float lo, float width, int nbins) {
  const float q = __fdiv_rn(__fsub_rn(ak_to_float(v), lo), width);
  const int b = __float2int_rz(q);
  return b < 0 ? 0 : (b > nbins - 1 ? nbins - 1 : b);
}

__device__ __forceinline__ unsigned word(const uint4& r, int w) {
  return w == 0 ? r.x : (w == 1 ? r.y : (w == 2 ? r.z : r.w));
}

// Element j of a 16-byte vector.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static float at(const uint4& r, int j) {
    return __uint_as_float(word(r, j));
  }
};
template <> struct Vec<int32_t> {
  static constexpr int kN = 4;
  __device__ static int32_t at(const uint4& r, int j) {
    return (int32_t)word(r, j);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __nv_bfloat16 at(const uint4& r, int j) {
    return __ushort_as_bfloat16(
        (unsigned short)(word(r, j >> 1) >> (16 * (j & 1))));
  }
};

// min and max that return NaN when either operand is NaN, as torch.min/max
// and jnp.minimum/maximum do (one PTX min.NaN / max.NaN each, sm_80+).
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ __nv_bfloat16 nan_min(__nv_bfloat16 a,
                                                 __nv_bfloat16 b) {
  return __hmin_nan(a, b);
}
__device__ __forceinline__ __nv_bfloat16 nan_max(__nv_bfloat16 a,
                                                 __nv_bfloat16 b) {
  return __hmax_nan(a, b);
}
__device__ __forceinline__ int32_t nan_min(int32_t a, int32_t b) {
  return min(a, b);
}
__device__ __forceinline__ int32_t nan_max(int32_t a, int32_t b) {
  return max(a, b);
}

// Fold a (min, max) pair, or one key as (v, v), into (mn, mx); a NaN
// makes its end NaN for good.
template <typename T>
__device__ __forceinline__ void fold(T a, T b, T& mn, T& mx) {
  mn = nan_min(a, mn);
  mx = nan_max(b, mx);
}

template <typename T>
__device__ __forceinline__ T shfl_xor(T v, int d) {
  typedef AkBits<T> B;
  return B::from((typename B::T)__shfl_xor_sync(kFull, (unsigned)B::to(v), d));
}

// Min and max over the warp, then over the block (thread 0's result).
template <typename T>
__device__ void block_minmax(T& mn, T& mx, T* red_mn, T* red_mx) {
  for (int d = 16; d > 0; d >>= 1)
    fold(shfl_xor(mn, d), shfl_xor(mx, d), mn, mx);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_mn[warp] = mn;
    red_mx[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) fold(red_mn[w], red_mx[w], mn, mx);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    minmax_hist_kernel(const T* __restrict__ x, long long n, int nbins,
                       float lo, float hi, int* __restrict__ hist,
                       unsigned int* __restrict__ ticket,
                       typename AkBits<T>::T* part_mn,
                       typename AkBits<T>::T* part_mx, T* __restrict__ out) {
  typedef AkBits<T> B;
  constexpr int kVec = Vec<T>::kN;
  extern __shared__ int sub[];  // kWarps x nbins
  __shared__ T red_mn[kWarps];
  __shared__ T red_mx[kWarps];
  __shared__ bool is_last;
  for (int i = threadIdx.x; i < kWarps * nbins; i += kThreads) sub[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* h = sub + warp * nbins;
  const float width = fmaxf((hi - lo) / (float)nbins, 1e-30f);
  T mn = AkLimits<T>::max(), mx = AkLimits<T>::min();

  // [0, head) scalar, then nvec 16-byte vectors, then the scalar tail
  const long long head = min(
      n, (long long)(((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) /
                     sizeof(T)));
  const long long nvec = (n - head) / kVec;
  const long long tail0 = head + nvec * kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  const long long chunks = (nvec + 32 * kLoads - 1) / (32 * kLoads);
  for (long long c = (long long)blockIdx.x * kWarps + warp; c < chunks;
       c += (long long)gridDim.x * kWarps) {
    const long long v0 = c * (32 * kLoads) + lane;
    uint4 raw[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      raw[k] = v0 + 32 * k < nvec ? xv[v0 + 32 * k]
                                  : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (v0 + 32 * k >= nvec) continue;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const T v = Vec<T>::at(raw[k], j);
        atomicAdd(&h[bin_of(v, lo, width, nbins)], 1);
        fold(v, v, mn, mx);
      }
    }
  }
  if (blockIdx.x == 0 && warp == 0) {  // head and tail: < 2 * kVec elements
    const long long extra = head + (n - tail0);
    for (long long i = lane; i < extra; i += 32) {
      const T v = x[i < head ? i : tail0 + (i - head)];
      atomicAdd(&h[bin_of(v, lo, width, nbins)], 1);
      fold(v, v, mn, mx);
    }
  }
  block_minmax(mn, mx, red_mn, red_mx);
  __syncthreads();  // every warp's sub-histogram complete
  for (int i = threadIdx.x; i < nbins; i += kThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sub[w * nbins + i];
    if (s) atomicAdd(&hist[i], s);
  }
  if (threadIdx.x == 0) {
    part_mn[blockIdx.x] = B::to(mn);
    part_mx[blockIdx.x] = B::to(mx);
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // Last CTA: every other CTA's partials are visible (fence + ticket).
  mn = AkLimits<T>::max();
  mx = AkLimits<T>::min();
  volatile typename B::T* vmn = part_mn;
  volatile typename B::T* vmx = part_mx;
  for (unsigned int i = threadIdx.x; i < gridDim.x; i += kThreads) {
    fold(B::from(vmn[i]), B::from(vmx[i]), mn, mx);
  }
  __syncthreads();  // red_mn / red_mx are reused
  block_minmax(mn, mx, red_mn, red_mx);
  if (threadIdx.x == 0) {
    out[0] = mn;
    out[1] = mx;
  }
}

template <typename T>
int launch(const void* x, long long n, int nbins, float lo, float hi,
           int* hist, unsigned int* ticket, void* partials, int grid,
           void* out, cudaStream_t stream) {
  typedef typename AkBits<T>::T Bits;
  Bits* pmn = static_cast<Bits*>(partials);
  Bits* pmx = pmn + grid;
  minmax_hist_kernel<T><<<grid, kThreads, kWarps * nbins * sizeof(int),
                          stream>>>(
      static_cast<const T*>(x), n, nbins, lo, hi, hist, ticket, pmn, pmx,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// hist[nbins] and *ticket must be zero on entry. partials holds 2 * grid
// key-sized words; out receives (min, max) in the key dtype.
AK_EXPORT int ak_minmax_histogram(const void* x, int dtype, long long n,
                                  int nbins, float lo, float hi, void* hist,
                                  void* ticket, void* partials, int grid,
                                  void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* h = static_cast<int*>(hist);
  unsigned int* t = static_cast<unsigned int*>(ticket);
  switch (dtype) {
    case AK_F32: return launch<float>(x, n, nbins, lo, hi, h, t, partials, grid, out, s);
    case AK_I32: return launch<int32_t>(x, n, nbins, lo, hi, h, t, partials, grid, out, s);
    case AK_BF16: return launch<__nv_bfloat16>(x, n, nbins, lo, hi, h, t, partials, grid, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Threads per CTA and elements a thread reads a chunk (elements of
// `elsize` bytes), for the wrapper's grid sizing.
AK_EXPORT int ak_minmax_histogram_threads() { return kThreads; }
AK_EXPORT int ak_minmax_histogram_elems(int elsize) {
  return kLoads * 16 / elsize;
}
