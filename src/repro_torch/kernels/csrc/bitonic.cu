// Bitonic sorting network for Hopper (sm_90a): the in-block kernel, the
// fused cross-stage window kernel and the unfused cross-stage kernel.
//
// Replaces repro/kernels/sort_kernel.py: _inblock_body (run by
// _run_inblock) and _hyper_body (run by _run_hyper). The network, its
// padding and its stage sequence are the reference's, so the two agree
// bitwise, including the order of equal-key pairs. Direction of every
// compare-exchange: ((global index of the low element) & k) == 0, as _cx
// computes it. The payload V is int32, float32 or bfloat16; with the
// tie-break on, equal keys are ordered by `av > bv` in the payload's own
// type, as the reference's _cx/_swap_blocks compare them (so -0.0 and 0.0
// are equal and keep the network's order).
//
// Rows: the keys may hold R rows of `row` keys each (a power of two), laid
// end to end; every row is one network (the reference vmaps the 1-D network
// over the rows). Compare-exchange pairs never straddle a row, because each
// stage's 2j-groups are aligned and 2j <= k <= row; only the direction of
// the last phase (k == row) would see the row index, so it is taken as
// ((low index) & k & (row - 1)) == 0. A 1-D sort is the case R = 1. One
// launch set then sorts the whole batch: launches do not grow with R.
//
// Bound: bytes. Each cross pass streams the whole array once (read and
// write) through device memory; the in-block kernel reads and writes each
// block once and runs all its stages in shared memory (8192 keys = 32 KiB,
// 64 KiB with a 4-byte payload). A sort of n = 2^m keys with 2^13-key
// blocks has (m-13)(m-12)/2 cross stages. The window kernel runs up to W
// consecutive ones in one pass (W = sort_hyper): the stages j >= block of
// one window only ever pair element x with x ^ j, so the 2^W elements
// base + t * jlow (t < 2^W, jlow the window's smallest distance) form a
// group closed under the whole window, and all share one direction bit
// (the window's bits lie below log2 k). The reference held 2^W whole
// 8192-key blocks in VMEM per grid step; at W = 3 that is 256 KiB of
// float32 keys, more than a CTA's 227 KB of shared memory. Here one thread
// holds one group in registers instead: thread e of a warp takes offset e
// in every member block, so each of its 2^W loads is one coalesced warp
// access, runs the W-stage butterfly in registers and stores the group
// back. A pass moves the bytes of one unfused pass, so cross passes drop
// from sum(i) to sum(ceil(i / W)) per sort. At W = 6 a thread holds 64 keys
// and 64 payloads (128 32-bit registers; bfloat16 takes one register per
// element too): ptxas's report for window_kernel is kept in
// build/kernels/libbitonic-*.log (chip_smoke.py copies its spill lines).
// The in-block finish (j < block) of each phase stays its own in-block
// launch: a window's lane slice does not hold whole blocks.

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

// One thread per group of a fused window of W cross stages of phase k:
// distances jtop, jtop/2, ..., jlow = jtop >> (W-1), all >= block. Group g
// (g < total / 2^W) is the 2^W elements base + t * jlow, base being g with
// W zero bits inserted at bit log2(jlow). Member t pairs with t | s at stage
// distance s * jlow, largest distance first, as the unfused stages run.
template <typename K, typename V, bool KV, bool TIE, int W>
__global__ void __launch_bounds__(256)
window_kernel(K* __restrict__ keys, V* __restrict__ vals, long long ngroups,
              long long k, int llow, long long rmask) {
  constexpr int H = 1 << W;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= ngroups) return;
  const long long jlow = 1ll << llow;
  const long long base = ((g >> llow) << (llow + W)) | (g & (jlow - 1));
  const bool asc = (base & k & rmask) == 0;
  K kk[H];
  V vv[H];
#pragma unroll
  for (int t = 0; t < H; ++t) {
    kk[t] = keys[base + t * jlow];
    if (KV) vv[t] = vals[base + t * jlow];
  }
  // bit t: member t moved (only moved members are stored, as the unfused
  // kernel stores only swapped pairs)
  unsigned long long moved = 0;
#pragma unroll
  for (int s = H >> 1; s >= 1; s >>= 1) {
#pragma unroll
    for (int t = 0; t < H; ++t) {
      if (t & s) continue;
      bool swapped;
      compare_exchange<K, V, KV, TIE>(kk[t], kk[t | s], vv[t], vv[t | s],
                                      asc, swapped);
      if (swapped) moved |= (1ull << t) | (1ull << (t | s));
    }
  }
  // The store addresses are recomputed from an opaque copy of the base:
  // kept live across the butterfly, 2^W 64-bit addresses would spill.
  long long sbase;
  asm volatile("mov.b64 %0, %1;" : "=l"(sbase) : "l"(base));
#pragma unroll
  for (int t = 0; t < H; ++t) {
    if (!((moved >> t) & 1)) continue;
    keys[sbase + t * jlow] = kk[t];
    if (KV) vals[sbase + t * jlow] = vv[t];
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

template <typename K, typename V, bool KV, bool TIE>
int launch_window(void* keys, void* vals, long long total, long long k,
                  long long jtop, int w, long long rmask,
                  cudaStream_t stream) {
  const long long ngroups = total >> w;
  const int threads = 256;
  const long long grid = (ngroups + threads - 1) / threads;
  const int llow = __builtin_ctzll((unsigned long long)jtop) - (w - 1);
  K* kp = static_cast<K*>(keys);
  V* vp = static_cast<V*>(vals);
  const unsigned int gr = (unsigned int)grid;
  switch (w) {
    case 1: window_kernel<K, V, KV, TIE, 1><<<gr, threads, 0, stream>>>(kp, vp, ngroups, k, llow, rmask); break;
    case 2: window_kernel<K, V, KV, TIE, 2><<<gr, threads, 0, stream>>>(kp, vp, ngroups, k, llow, rmask); break;
    case 3: window_kernel<K, V, KV, TIE, 3><<<gr, threads, 0, stream>>>(kp, vp, ngroups, k, llow, rmask); break;
    case 4: window_kernel<K, V, KV, TIE, 4><<<gr, threads, 0, stream>>>(kp, vp, ngroups, k, llow, rmask); break;
    case 5: window_kernel<K, V, KV, TIE, 5><<<gr, threads, 0, stream>>>(kp, vp, ngroups, k, llow, rmask); break;
    case 6: window_kernel<K, V, KV, TIE, 6><<<gr, threads, 0, stream>>>(kp, vp, ngroups, k, llow, rmask); break;
    default: return (int)cudaErrorInvalidValue;
  }
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

template <typename K, typename V>
int dispatch_window(void* keys, void* vals, int tie, long long total,
                    long long k, long long jtop, int w, long long rmask,
                    cudaStream_t s) {
  if (vals == nullptr) return launch_window<K, int32_t, false, false>(keys, vals, total, k, jtop, w, rmask, s);
  if (tie) return launch_window<K, V, true, true>(keys, vals, total, k, jtop, w, rmask, s);
  return launch_window<K, V, true, false>(keys, vals, total, k, jtop, w, rmask, s);
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

// In place: one fused window of w (1..6) cross stages of phase k, at
// distances jtop, jtop/2, ..., jtop >> (w-1) (each >= block), over
// keys[total] (and vals[total]), rows of rmask + 1 keys.
AK_EXPORT int ak_bitonic_window(void* keys, void* vals, int dtype,
                                int vdtype, int tie_break, long long total,
                                long long k, long long jtop, int w,
                                long long rmask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w < 1 || w > 6 || (total >> w) <= 0) return (int)cudaErrorInvalidValue;
  return with_types(dtype, vdtype, vals != nullptr, [&](auto kt, auto vt) {
    typedef typename decltype(kt)::type K;
    typedef typename decltype(vt)::type V;
    return dispatch_window<K, V>(keys, vals, tie_break, total, k, jtop, w,
                                 rmask, s);
  });
}
