// Bitonic sorting network for Hopper (sm_90a): the in-block kernel and the
// cross-stage kernel.
//
// Replaces repro/kernels/sort_kernel.py: _inblock_body (run by
// _run_inblock) and _hyper_body (run by _run_hyper) in the unfused
// sort_hyper=0 layout. The network, its padding and its stage sequence are
// the reference's, so the two agree bitwise, including the order of
// equal-key pairs. Direction of every compare-exchange:
// ((global index of the low element) & k) == 0, as _cx computes it. The
// payload V is int32, float32 or bfloat16; with the tie-break on, equal
// keys are ordered by `av > bv` in the payload's own type, as the
// reference's _cx/_swap_blocks compare them (so -0.0 and 0.0 are equal and
// keep the network's order).
//
// Rows: the keys may hold R rows of `row` keys each (a power of two), laid
// end to end; every row is one network (the reference vmaps the 1-D network
// over the rows). Compare-exchange pairs never straddle a row, because each
// stage's 2j-groups are aligned and 2j <= k <= row; only the direction of
// the last phase (k == row) would see the row index, so it is taken as
// ((low index) & k & (row - 1)) == 0. A 1-D sort is the case R = 1. One
// launch set then sorts the whole batch: launches do not grow with R.
//
// Bound: bytes. Each cross stage streams the whole array once (read and
// write) through device memory; the in-block kernel reads and writes each
// block once and runs all its stages in shared memory (8192 keys = 32 KiB,
// 64 KiB with a 4-byte payload). A sort of n = 2^m keys with 2^13-key
// blocks makes (m-13)(m-12)/2 cross passes, so at 2^28 keys the network
// moves ~120 times the bytes a single read-write pass would.

#include "ak_stream.cuh"

namespace {

template <typename K, typename V, bool KV, bool TIE>
__device__ __forceinline__ void compare_exchange(K& ka, K& kb, V& va, V& vb,
                                                 bool asc, bool& swapped) {
  bool gt = ak_lt(kb, ka);
  if (TIE) gt = gt || (ak_eq(ka, kb) && ak_lt(vb, va));
  swapped = asc ? gt : !gt;
  if (swapped) {
    K t = ka; ka = kb; kb = t;
    if (KV) { V u = va; va = vb; vb = u; }
  }
}

// One CTA per block of `block` keys (a power of two). Runs every stage
// (k, j) for k = k_lo, 2 k_lo, ..., k_hi and j = min(k/2, block/2), ..., 1
// on the block held in dynamic shared memory, then writes it back.
template <typename K, typename V, bool KV, bool TIE>
__global__ void inblock_kernel(K* __restrict__ keys, V* __restrict__ vals,
                               int block, long long k_lo, long long k_hi,
                               long long rmask) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  V* sv = reinterpret_cast<V*>(smem + (size_t)block * sizeof(K));
  const long long base = (long long)blockIdx.x * block;
  K* gk = keys + base;
  V* gv = KV ? vals + base : nullptr;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    sk[i] = gk[i];
    if (KV) sv[i] = gv[i];
  }
  __syncthreads();
  const int half = block >> 1;
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    int j = (int)((k >> 1) < half ? (k >> 1) : half);
    for (; j >= 1; j >>= 1) {
      const int lj = __ffs(j) - 1;
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int lo = ((p >> lj) << (lj + 1)) | (p & (j - 1));
        const int hi = lo + j;
        const bool asc = ((base + lo) & k & rmask) == 0;
        K ka = sk[lo], kb = sk[hi];
        V va{}, vb{};
        if (KV) { va = sv[lo]; vb = sv[hi]; }
        bool swapped;
        compare_exchange<K, V, KV, TIE>(ka, kb, va, vb, asc, swapped);
        if (swapped) {
          sk[lo] = ka; sk[hi] = kb;
          if (KV) { sv[lo] = va; sv[hi] = vb; }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    gk[i] = sk[i];
    if (KV) gv[i] = sv[i];
  }
}

// One thread per compare-exchange pair of a cross stage (k, j), j >= block,
// in device memory: the reference's one-launch-per-stage layout.
template <typename K, typename V, bool KV, bool TIE>
__global__ void cross_kernel(K* __restrict__ keys, V* __restrict__ vals,
                             long long npairs, long long k, long long j,
                             int lj, long long rmask) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npairs) return;
  const long long lo = ((p >> lj) << (lj + 1)) | (p & (j - 1));
  const long long hi = lo + j;
  const bool asc = (lo & k & rmask) == 0;
  K ka = keys[lo], kb = keys[hi];
  V va{}, vb{};
  if (KV) { va = vals[lo]; vb = vals[hi]; }
  bool swapped;
  compare_exchange<K, V, KV, TIE>(ka, kb, va, vb, asc, swapped);
  if (swapped) {
    keys[lo] = ka; keys[hi] = kb;
    if (KV) { vals[lo] = va; vals[hi] = vb; }
  }
}

template <typename K, typename V, bool KV, bool TIE>
int launch_inblock(void* keys, void* vals, long long total, int block,
                   long long k_lo, long long k_hi, long long rmask,
                   cudaStream_t stream) {
  const size_t smem = (size_t)block * (sizeof(K) + (KV ? sizeof(V) : 0));
  auto kern = inblock_kernel<K, V, KV, TIE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = block / 2 < 1024 ? block / 2 : 1024;
  const long long nblocks = total / block;
  kern<<<(unsigned int)nblocks, threads, smem, stream>>>(
      static_cast<K*>(keys), static_cast<V*>(vals), block, k_lo, k_hi, rmask);
  return (int)cudaGetLastError();
}

template <typename K, typename V, bool KV, bool TIE>
int launch_cross(void* keys, void* vals, long long total, long long k,
                 long long j, long long rmask, cudaStream_t stream) {
  const long long npairs = total / 2;
  const int threads = 256;
  const long long grid = (npairs + threads - 1) / threads;
  const int lj = __builtin_ctzll((unsigned long long)j);
  cross_kernel<K, V, KV, TIE><<<(unsigned int)grid, threads, 0, stream>>>(
      static_cast<K*>(keys), static_cast<V*>(vals), npairs, k, j, lj, rmask);
  return (int)cudaGetLastError();
}

template <typename K, typename V>
int dispatch_inblock(void* keys, void* vals, int tie, long long total,
                     int block, long long k_lo, long long k_hi,
                     long long rmask, cudaStream_t s) {
  if (vals == nullptr) return launch_inblock<K, int32_t, false, false>(keys, vals, total, block, k_lo, k_hi, rmask, s);
  if (tie) return launch_inblock<K, V, true, true>(keys, vals, total, block, k_lo, k_hi, rmask, s);
  return launch_inblock<K, V, true, false>(keys, vals, total, block, k_lo, k_hi, rmask, s);
}

template <typename K, typename V>
int dispatch_cross(void* keys, void* vals, int tie, long long total,
                   long long k, long long j, long long rmask,
                   cudaStream_t s) {
  if (vals == nullptr) return launch_cross<K, int32_t, false, false>(keys, vals, total, k, j, rmask, s);
  if (tie) return launch_cross<K, V, true, true>(keys, vals, total, k, j, rmask, s);
  return launch_cross<K, V, true, false>(keys, vals, total, k, j, rmask, s);
}

// Calls f(TypeTag<K>, TypeTag<V>) for key and payload dtype codes (the
// payload code is ignored, as int32, when there is no payload).
template <typename F>
int with_types(int kdtype, int vdtype, bool kv, F&& f) {
  auto pick_v = [&](auto kt) {
    switch (kv ? vdtype : AK_I32) {
      case AK_F32: return f(kt, AkTypeTag<float>{});
      case AK_I32: return f(kt, AkTypeTag<int32_t>{});
      case AK_BF16: return f(kt, AkTypeTag<__nv_bfloat16>{});
    }
    return (int)cudaErrorInvalidValue;
  };
  switch (kdtype) {
    case AK_F32: return pick_v(AkTypeTag<float>{});
    case AK_I32: return pick_v(AkTypeTag<int32_t>{});
    case AK_BF16: return pick_v(AkTypeTag<__nv_bfloat16>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// In place on keys[total] (and vals[total] when not null), rows of
// rmask + 1 keys: every in-block stage of phases k_lo..k_hi on each block
// of `block` keys.
AK_EXPORT int ak_bitonic_inblock(void* keys, void* vals, int dtype,
                                 int vdtype, int tie_break, long long total,
                                 int block, long long k_lo, long long k_hi,
                                 long long rmask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(dtype, vdtype, vals != nullptr, [&](auto kt, auto vt) {
    typedef typename decltype(kt)::type K;
    typedef typename decltype(vt)::type V;
    return dispatch_inblock<K, V>(keys, vals, tie_break, total, block, k_lo,
                                  k_hi, rmask, s);
  });
}

// In place: one cross stage (k, j) over keys[total] (and vals[total]),
// rows of rmask + 1 keys.
AK_EXPORT int ak_bitonic_cross(void* keys, void* vals, int dtype, int vdtype,
                               int tie_break, long long total, long long k,
                               long long j, long long rmask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(dtype, vdtype, vals != nullptr, [&](auto kt, auto vt) {
    typedef typename decltype(kt)::type K;
    typedef typename decltype(vt)::type V;
    return dispatch_cross<K, V>(keys, vals, tie_break, total, k, j, rmask, s);
  });
}
