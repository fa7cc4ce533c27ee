// Binary search per query for Hopper (sm_90a).
//
// Replaces repro/kernels/search_kernel.py: searchsorted_blocks
// (_search_body). The TPU kernel counted #{h < q} ('left') or #{h <= q}
// ('right') with tiled compare matrices because its vector unit has no
// per-lane gather; a GPU thread can gather, so this is AK's own form again:
// one thread per query, a binary search over the sorted haystack. On a
// sorted, NaN-free haystack the insertion index equals the reference's
// count, duplicates and type-max keys included.
//
// Bound: latency. Each query makes log2(n) dependent loads; SIHSort asks
// for a handful of queries per call, so a call costs about one launch plus
// ~26 round trips to L2/device memory, far above its byte count.

#include "ak_common.cuh"

namespace {

template <typename T, bool RIGHT>
__global__ void search_kernel(const T* __restrict__ hay, long long n,
                              const T* __restrict__ q, long long nq,
                              int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const T v = q[i];
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const T h = hay[mid];
    // left: first index with h >= v; right: first index with h > v
    const bool go_right = RIGHT ? !ak_lt(v, h) : ak_lt(h, v);
    if (go_right) lo = mid + 1; else hi = mid;
  }
  out[i] = (int)lo;
}

template <typename T>
int launch(const void* hay, long long n, const void* q, long long nq,
           int right, int* out, cudaStream_t stream) {
  const int threads = 128;
  const long long grid = (nq + threads - 1) / threads;
  if (right)
    search_kernel<T, true><<<(unsigned int)grid, threads, 0, stream>>>(
        static_cast<const T*>(hay), n, static_cast<const T*>(q), nq, out);
  else
    search_kernel<T, false><<<(unsigned int)grid, threads, 0, stream>>>(
        static_cast<const T*>(hay), n, static_cast<const T*>(q), nq, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out[nq] = insertion index of each query into hay[n] (0-based, int32).
AK_EXPORT int ak_searchsorted(const void* hay, long long n, const void* q,
                              long long nq, int dtype, int right, void* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  switch (dtype) {
    case AK_F32: return launch<float>(hay, n, q, nq, right, o, s);
    case AK_I32: return launch<int32_t>(hay, n, q, nq, right, o, s);
    case AK_BF16: return launch<__nv_bfloat16>(hay, n, q, nq, right, o, s);
  }
  return (int)cudaErrorInvalidValue;
}
