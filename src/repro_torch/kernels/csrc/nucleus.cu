// Nucleus (top-p) keep mask from rows already sorted by the bitonic
// network, for Hopper (sm_90a).
//
// Replaces repro/kernels/nucleus_kernel.py: nucleus_mask_blocks' fused
// launch, _nucleus_body -> _mask_from_sorted (softmax over the descending
// row, inclusive prefix sum, cut = #{cum < top_p}, keep ranks <= cut,
// scatter back through the permutation). The sort before it is the batched
// bitonic network of bitonic.cu, run on -x ascending with an index
// tie-break, so this kernel reads the NEGATED descending row: s = -neg[l].
//
// The TPU kernel held a (rows, vocab) block in VMEM. One row here is
// 2^17 keys + 2^17 int32 ranks at full vocabulary width (1 MiB), far more
// than one CTA's shared memory, so one CTA per row streams it from device
// memory (the row stays in the 50 MB L2 between sweeps):
//   1. max of s over the valid lanes (block reduction);
//   2. sum of exp(s - max) over the valid lanes;
//   3. tiles of blockDim lanes: a block inclusive scan of exp(s - max) / sum
//      plus the running carry gives cum; count the lanes with cum < top_p.
//      cum never decreases from one tile to the next (each tile adds a sum
//      of non-negative terms to the carry, and rounding is monotone), so
//      once the carry reaches top_p no later lane can count: stop there;
//   4. keep[perm[l]] = (l <= cut) for every valid lane l < n.
// Padded lanes (l >= n) carry perm >= n and are never written. The sums run
// in another order than jnp.cumsum's, so kernel and reference agree on the
// mask except where a cum lies within rounding of top_p.
//
// Bound: bytes. Each row is read twice and a half in the worst case (s in
// sweeps 1-3, perm in sweep 4) and the mask written once; its compulsory
// traffic is one read of s and perm and one write of the mask.

#include "ak_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the block reductions fold one value per warp");

template <typename T, typename Op>
__device__ T block_reduce(T v, T* scratch, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = scratch[lane];
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

// Inclusive scan of one value per thread across the block.
__device__ float block_scan(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  __syncthreads();
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = scratch[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += scratch[warp - 1];
  return v;
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct AddF {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct AddI {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// neg: (rows, row) negated descending keys; perm: (rows, row) their
// original columns; keep: (rows, n) bool.
__global__ void nucleus_kernel(const float* __restrict__ neg,
                               const int32_t* __restrict__ perm,
                               bool* __restrict__ keep, int n, int row,
                               float top_p) {
  __shared__ float fscratch[kWarps];
  __shared__ int iscratch[kWarps];
  __shared__ float tile_end;
  const float* s = neg + (long long)blockIdx.x * row;
  const int32_t* p = perm + (long long)blockIdx.x * row;
  bool* out = keep + (long long)blockIdx.x * n;

  float m = AkLimits<float>::min();
  for (int l = threadIdx.x; l < n; l += kThreads) m = fmaxf(m, -s[l]);
  m = block_reduce(m, fscratch, MaxOp());

  float z = 0.0f;
  for (int l = threadIdx.x; l < n; l += kThreads) z += expf(-s[l] - m);
  z = block_reduce(z, fscratch, AddF());

  float carry = 0.0f;
  int below = 0;
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int l = t0 + threadIdx.x;
    const float prob = l < n ? expf(-s[l] - m) / z : 0.0f;
    const float cum = carry + block_scan(prob, fscratch);
    below += (l < n && cum < top_p) ? 1 : 0;
    // the last thread's cum is the tile's running total
    if (threadIdx.x == kThreads - 1) tile_end = cum;
    __syncthreads();
    carry = tile_end;
    __syncthreads();
    if (!(carry < top_p)) break;
  }
  const int cut = block_reduce(below, iscratch, AddI());

  for (int l = threadIdx.x; l < n; l += kThreads) out[p[l]] = l <= cut;
}

}  // namespace

// neg, perm: (rows, row) with row >= n; keep: (rows, n).
AK_EXPORT int ak_nucleus_mask(const void* neg, const void* perm, void* keep,
                              int rows, int n, int row, float top_p,
                              void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  nucleus_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(neg), static_cast<const int32_t*>(perm),
      static_cast<bool*>(keep), n, row, top_p);
  return (int)cudaGetLastError();
}
