// Insertion indices of queries into a sorted haystack, for Hopper (sm_90a).
//
// Replaces repro/kernels/search_kernel.py: searchsorted_blocks
// (_search_body). The TPU kernel counted #{h < q} ('left') or #{h <= q}
// ('right') with tiled compare matrices because its vector unit has no
// per-lane gather. A GPU lane can gather, so the count comes from a search
// over the sorted haystack; on a sorted, NaN-free haystack the predicate
// (h < q, or h <= q) holds on a prefix, and the insertion index is the
// length of that prefix, duplicates and type-max keys included.
//
// Bound: latency. SIHSort asks for 3 queries into a 2^26-key shard that
// lies outside L2, so a call is one launch plus the round trips of its
// dependent loads; bytes and operations are negligible. A binary search
// makes log2(n) dependent loads (26 at 2^26). search_warp_kernel gives a
// query a warp instead, which searches 32-ary: each round lane l probes
// lo + (l+1)*m/33 of the m unknown positions [lo, hi), the 32 loads are
// independent (one round trip), and the ballot of the predicate is a
// prefix of lanes whose length k picks one of the 33 sub-intervals. 2^26
// keys take 5 such rounds and a last one over the <= 32 positions left.
// search_thread_kernel keeps one thread per query for many queries, where
// the card is full and the binary search's 26 loads a query beat the warp's
// 32 a round (the wrapper picks by the query count).

#include "ak_common.cuh"

namespace {

// True when key h lies before the insertion point of v.
template <typename T, bool RIGHT>
__device__ __forceinline__ bool ak_before(T h, T v) {
  return RIGHT ? !ak_lt(v, h) : ak_lt(h, v);
}

template <typename T, bool RIGHT>
__global__ void search_thread_kernel(const T* __restrict__ hay, long long n,
                                     const T* __restrict__ q, long long nq,
                                     int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const T v = q[i];
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ak_before<T, RIGHT>(hay[mid], v)) lo = mid + 1; else hi = mid;
  }
  out[i] = (int)lo;
}

template <typename T, bool RIGHT>
__global__ void search_warp_kernel(const T* __restrict__ hay, long long n,
                                   const T* __restrict__ q, long long nq,
                                   int* __restrict__ out) {
  // one warp per query; w is uniform over the warp, so whole warps leave
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= nq) return;
  const T v = q[w];
  // the insertion index c lies in [lo, hi]: hay[lo-1] is before v (or
  // lo == 0) and hay[hi] is not (or hi == n)
  long long lo = 0, hi = n;
  while (hi - lo > 32) {
    const long long m = hi - lo;
    const long long p = lo + (lane + 1) * m / 33;  // strictly rising in l
    const int k = __popc(__ballot_sync(0xffffffffu,
                                       ak_before<T, RIGHT>(hay[p], v)));
    // lanes 0..k-1 hold; c > probe k-1 and c <= probe k
    const long long base = lo;
    if (k < 32) hi = base + (k + 1) * m / 33;
    if (k > 0) lo = base + k * m / 33 + 1;
  }
  const bool hit = lo + lane < hi && ak_before<T, RIGHT>(hay[lo + lane], v);
  const int k = __popc(__ballot_sync(0xffffffffu, hit));
  if (lane == 0) out[w] = (int)(lo + k);
}

template <typename T, bool RIGHT>
void launch(const T* hay, long long n, const T* q, long long nq, int* out,
            int warp, cudaStream_t stream) {
  const int threads = 128;
  if (warp) {
    const long long grid = (nq * 32 + threads - 1) / threads;
    search_warp_kernel<T, RIGHT><<<(unsigned int)grid, threads, 0, stream>>>(
        hay, n, q, nq, out);
  } else {
    const long long grid = (nq + threads - 1) / threads;
    search_thread_kernel<T, RIGHT><<<(unsigned int)grid, threads, 0,
                                     stream>>>(hay, n, q, nq, out);
  }
}

template <typename T>
int launch_side(const void* hay, long long n, const void* q, long long nq,
                int right, int* out, int warp, cudaStream_t stream) {
  const T* h = static_cast<const T*>(hay);
  const T* v = static_cast<const T*>(q);
  if (right) launch<T, true>(h, n, v, nq, out, warp, stream);
  else launch<T, false>(h, n, v, nq, out, warp, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// out[nq] = insertion index of each query into hay[n] (0-based, int32);
// warp != 0 searches one query per warp (32-ary), else one per thread.
AK_EXPORT int ak_searchsorted(const void* hay, long long n, const void* q,
                              long long nq, int dtype, int right, int warp,
                              void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  switch (dtype) {
    case AK_F32: return launch_side<float>(hay, n, q, nq, right, o, warp, s);
    case AK_I32: return launch_side<int32_t>(hay, n, q, nq, right, o, warp, s);
    case AK_BF16:
      return launch_side<__nv_bfloat16>(hay, n, q, nq, right, o, warp, s);
  }
  return (int)cudaErrorInvalidValue;
}
