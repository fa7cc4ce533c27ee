// One-pass min/max + fixed-bin histogram for Hopper (sm_90a).
//
// Replaces repro/kernels/hist_kernel.py: minmax_histogram_blocks
// (_hist_body). The TPU kernel ranked each chunk against the bin ids with
// a one-hot compare matrix because it had no atomics; here each CTA bins
// its grid-stride share of the elements with int atomics into a
// shared-memory histogram (<= 1024 bins), then merges it into the global
// one with atomicAdd (integer counts are exact in any order). Min and max
// are a two-level reduction: a shared-memory tree per CTA, then the last
// CTA to finish (a ticket counter after __threadfence) reduces the
// per-CTA partials. Binning is bitwise the reference's:
//   width = max((hi - lo) / nbins, 1e-30f)       (f32, IEEE division)
//   b     = clamp(int_rz((float(x) - lo) / width), 0, nbins - 1)
// which is why this file must not be built with --use_fast_math.
//
// Bound: bytes -- one read of x; the bins stay in shared memory.

#include "ak_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void minmax_hist_kernel(const T* __restrict__ x, long long n,
                                   int nbins, float lo, float hi,
                                   int* __restrict__ hist,
                                   unsigned int* __restrict__ ticket,
                                   typename AkBits<T>::T* part_mn,
                                   typename AkBits<T>::T* part_mx,
                                   T* __restrict__ out) {
  typedef AkBits<T> B;
  extern __shared__ int sh_hist[];
  __shared__ T red_mn[kThreads];
  __shared__ T red_mx[kThreads];
  __shared__ bool is_last;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) sh_hist[i] = 0;
  __syncthreads();

  const float width = fmaxf((hi - lo) / (float)nbins, 1e-30f);
  T mn = AkLimits<T>::max(), mx = AkLimits<T>::min();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T v = x[i];
    const float q = __fdiv_rn(__fsub_rn(ak_to_float(v), lo), width);
    int b = __float2int_rz(q);
    b = b < 0 ? 0 : (b > nbins - 1 ? nbins - 1 : b);
    atomicAdd(&sh_hist[b], 1);
    if (ak_lt(v, mn)) mn = v;
    if (ak_lt(mx, v)) mx = v;
  }
  red_mn[threadIdx.x] = mn;
  red_mx[threadIdx.x] = mx;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      if (ak_lt(red_mn[threadIdx.x + s], red_mn[threadIdx.x]))
        red_mn[threadIdx.x] = red_mn[threadIdx.x + s];
      if (ak_lt(red_mx[threadIdx.x], red_mx[threadIdx.x + s]))
        red_mx[threadIdx.x] = red_mx[threadIdx.x + s];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nbins; i += blockDim.x)
    if (sh_hist[i]) atomicAdd(&hist[i], sh_hist[i]);
  if (threadIdx.x == 0) {
    part_mn[blockIdx.x] = B::to(red_mn[0]);
    part_mx[blockIdx.x] = B::to(red_mx[0]);
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
  for (unsigned int i = threadIdx.x; i < gridDim.x; i += blockDim.x) {
    const T a = B::from(vmn[i]);
    const T b = B::from(vmx[i]);
    if (ak_lt(a, mn)) mn = a;
    if (ak_lt(mx, b)) mx = b;
  }
  red_mn[threadIdx.x] = mn;
  red_mx[threadIdx.x] = mx;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      if (ak_lt(red_mn[threadIdx.x + s], red_mn[threadIdx.x]))
        red_mn[threadIdx.x] = red_mn[threadIdx.x + s];
      if (ak_lt(red_mx[threadIdx.x], red_mx[threadIdx.x + s]))
        red_mx[threadIdx.x] = red_mx[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = red_mn[0];
    out[1] = red_mx[0];
  }
}

template <typename T>
int launch(const void* x, long long n, int nbins, float lo, float hi,
           int* hist, unsigned int* ticket, void* partials, int grid,
           void* out, cudaStream_t stream) {
  typedef typename AkBits<T>::T Bits;
  Bits* pmn = static_cast<Bits*>(partials);
  Bits* pmx = pmn + grid;
  minmax_hist_kernel<T><<<grid, kThreads, nbins * sizeof(int), stream>>>(
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

// Threads per CTA, for the wrapper's grid sizing.
AK_EXPORT int ak_minmax_histogram_threads() { return kThreads; }
