// Nucleus (top-p) keep mask from rows already sorted by the bitonic
// network, for Hopper (sm_90a): one thread-block cluster a row.
//
// Replaces repro/kernels/nucleus_kernel.py: nucleus_mask_blocks' fused
// launch, _nucleus_body -> _mask_from_sorted (softmax over the descending
// row, inclusive prefix sum, cut = #{cum < top_p}, keep ranks <= cut,
// scatter back through the permutation). The sort before it is the batched
// bitonic network of bitonic.cu, run on -x ascending with an index
// tie-break, so this kernel reads the NEGATED descending row: s = -neg[l].
//
// The TPU kernel held a (rows, vocab) block in VMEM. Here a row (~94k
// lanes at full vocabulary width) is split over a cluster of Cc CTAs
// (1..16; the grid is rows x Cc), which exchange their partial sums through
// distributed shared memory:
//   1. m = -neg[0]: the row is sorted, so its first lane holds the max;
//   2. CTA c reads its contiguous lane slice [lo, hi) once, 16 lanes a
//      thread in registers (16-byte loads, all in flight), takes
//      e = exp(s - m), scans each thread's run in order, then the runs'
//      totals across the block (warp Hillis-Steele, then the warps'
//      totals), zeroes its own contiguous column slice of the mask with
//      16-byte stores (the cluster barriers below order these stores
//      before any set) and publishes its slice total E_c;
//   3. cluster barrier; every CTA folds E_0 .. E_{Cc-1} in rank order into
//      z (so z is the same bits in every CTA) and takes its carry
//      E_0 + ... + E_{c-1}, the same left fold's prefix: the carry of CTA
//      c + 1 is exactly carry_c + E_c;
//   4. cum = (carry + (thread offset + run)) / z; the CTA counts its lanes
//      with cum < top_p and publishes the count. Every cum of CTA c is
//      >= carry_c / z (non-negative terms, monotone rounding), so a CTA
//      whose carry_c / z >= top_p counts nothing and skips the pass;
//   5. cluster barrier; cut = the sum of the counts; the CTAs split the
//      ranks l <= cut evenly and set keep[perm[l]], reading perm for those
//      ranks only, a thread's 16 ranks at once. A last split barrier keeps
//      every CTA's shared memory alive until the others have read it.
// A slice larger than one tile (blockDim x 16 lanes: n above 16 x 16384)
// is walked in tiles; the count pass then reads its tiles again (from L2).
// The kernel uses no global scratch, ticket or memset, so its launch can be
// captured in a CUDA graph. The scan runs in another order than
// torch.cumsum (and divides the running sum of e by z rather than summing
// e / z), so kernel and plain version agree on the mask except where a
// cum lies within rounding of top_p. expf and the division are IEEE: no
// --use_fast_math.
//
// Bound: bytes. What these inputs need: neg read once and the mask written
// once (5 bytes a lane), plus perm for the ranks <= cut.

#include "ak_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRun = 16;          // lanes a thread holds in registers
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Exclusive scan of one value a thread across the block; *total receives
// the block's sum. Warp Hillis-Steele scans (lane l takes lane l - d's
// partial on its left, d = 1 .. 16), then warp 0 scans the warps' totals
// the same way (warps past the block's last add 0).
__device__ float block_excl_scan(float v, float* scratch, float* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const float u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = u + incl;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  __syncthreads();  // scratch may still be read from the last call
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = lane < warps ? scratch[lane] : 0.0f;
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = u + w;
    }
    float we = __shfl_up_sync(kFull, w, 1);
    scratch[lane] = lane == 0 ? 0.0f : we;
    if (lane == 31) scratch[32] = w;
  }
  __syncthreads();
  *total = scratch[32];
  return scratch[warp] + excl;
}

// Zero `count` mask bytes from p: bytes up to a 16-byte boundary, 16-byte
// stores, then the tail.
__device__ void zero_bytes(bool* p, int count) {
  const int head =
      min(count, (int)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15));
  for (int i = threadIdx.x; i < head; i += blockDim.x) p[i] = false;
  const int vecs = (count - head) / 16;
  uint4* v = reinterpret_cast<uint4*>(p + head);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x)
    v[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = head + vecs * 16 + threadIdx.x; i < count; i += blockDim.x)
    p[i] = false;
}

// One tile of the slice: thread t holds lanes base + t*kRun .. + kRun - 1
// (lanes >= hi hold e = 0); run[i] = e[0] + ... + e[i] in order, *toff =
// the exclusive scan of the runs' totals, *tile_total = their sum.
__device__ __forceinline__ void scan_tile(const float* __restrict__ s, int t0,
                                          int hi, float m, bool vec,
                                          float* run, float* toff,
                                          float* tile_total, float* scratch) {
  const int base = t0 + threadIdx.x * kRun;
  float v[kRun];
  if (vec && base < hi) {
    const float4* p = reinterpret_cast<const float4*>(s + base);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      const float4 f = p[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) v[i] = base + i < hi ? s[base + i] : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const float e = base + i < hi ? expf(-v[i] - m) : 0.0f;
    acc = acc + e;
    run[i] = acc;
  }
  *toff = block_excl_scan(acc, scratch, tile_total);
}

// neg: (rows, row) negated descending keys; perm: (rows, row) their
// original columns; keep: (rows, n) bool. CTA c of a row's cluster owns
// lanes and mask columns [c * slice, (c + 1) * slice) of [0, n).
__global__ void __launch_bounds__(kMaxThreads)
    nucleus_kernel(const float* __restrict__ neg,
                   const int32_t* __restrict__ perm, bool* __restrict__ keep,
                   int n, int row, int slice, float top_p, bool vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.x / cc;
  __shared__ float scratch[33];
  __shared__ float part_e;   // published: this slice's sum of e
  __shared__ int part_cnt;   // published: this slice's lanes below top_p
  __shared__ float all_e[kMaxCluster];
  __shared__ int cut_sh;
  const float* s = neg + (long long)r * row;
  const int32_t* p = perm + (long long)r * row;
  bool* out = keep + (long long)r * n;
  const int lo = min(rank * slice, n), hi = min(lo + slice, n);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    part_cnt = 0;
    cut_sh = 0;
  }

  const float m = -s[0];
  const int tile = blockDim.x * kRun;
  const int tiles = (hi - lo + tile - 1) / tile;  // 0 for an empty slice
  float run[kRun];
  float toff = 0.0f, tile_total = 0.0f, total = 0.0f;
  for (int j = 0; j < tiles; ++j) {
    scan_tile(s, lo + j * tile, hi, m, vec, run, &toff, &tile_total,
              scratch);
    total = total + tile_total;
  }
  zero_bytes(out + lo, hi - lo);
  if (threadIdx.x == 0) part_e = total;
  cluster.sync();  // (1) every E_c published; the zero stores released

  if ((int)threadIdx.x < cc)
    all_e[threadIdx.x] = *cluster.map_shared_rank(&part_e, threadIdx.x);
  __syncthreads();
  float z = 0.0f, carry = 0.0f;
  for (int q = 0; q < cc; ++q) {
    if (q == rank) carry = z;
    z = z + all_e[q];
  }

  int below = 0;
  for (int j = 0; j < tiles; ++j) {
    if (!(__fdiv_rn(carry, z) < top_p)) break;  // every later cum >= top_p
    if (tiles > 1)
      scan_tile(s, lo + j * tile, hi, m, vec, run, &toff, &tile_total,
                scratch);
    const int base = lo + j * tile + threadIdx.x * kRun;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const float cum = __fdiv_rn(carry + (toff + run[i]), z);
      below += (base + i < hi && cum < top_p) ? 1 : 0;
    }
    carry = carry + tile_total;
  }
  below = __reduce_add_sync(kFull, below);
  if (lane == 0 && below) atomicAdd(&part_cnt, below);
  __syncthreads();
  cluster.sync();  // (2) every count published

  if (threadIdx.x < 32) {
    int c = (int)threadIdx.x < cc
                ? *cluster.map_shared_rank(&part_cnt, threadIdx.x)
                : 0;
    c = __reduce_add_sync(kFull, c);
    if (threadIdx.x == 0) cut_sh = c;
  }
  __syncthreads();
  const int cut = cut_sh;
  cluster_arrive();  // (3) done reading the others' shared memory
  // ranks 0 .. min(n, cut + 1) - 1, split evenly over the cluster (not by
  // slice: a deep cut would leave the scattered stores to the first CTAs);
  // a thread reads the ranks of its run at once (16-byte loads where the
  // run is whole), then sets their columns
  const int kept = min(n, cut + 1);
  const int share = ((kept + cc - 1) / cc + kRun - 1) / kRun * kRun;
  const int start = min(rank * share, kept), end = min(start + share, kept);
  for (int t0 = start; t0 < end; t0 += tile) {
    const int base = t0 + threadIdx.x * kRun;
    if (base >= end) break;
    int col[kRun];
    if (vec && base + kRun <= end) {
      const int4* q = reinterpret_cast<const int4*>(p + base);
#pragma unroll
      for (int k = 0; k < kRun / 4; ++k) {
        const int4 f = q[k];
        col[4 * k] = f.x;
        col[4 * k + 1] = f.y;
        col[4 * k + 2] = f.z;
        col[4 * k + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i) col[i] = base + i < end ? p[base + i] : 0;
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (base + i < end) out[col[i]] = true;
  }
  cluster_wait();
}

// The kernel's geometry for n lanes over a cluster of cc CTAs: lanes a
// CTA (a multiple of 16, so that every run starts on a 16-byte boundary)
// and threads a CTA (a multiple of 32, enough for one tile if it fits).
void geometry(int n, int cc, int* slice, int* threads) {
  const int per = (n + cc - 1) / cc;
  *slice = (per + 15) / 16 * 16;
  const int t = ((*slice + kRun - 1) / kRun + 31) / 32 * 32;
  *threads = t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

cudaError_t allow_large_clusters() {
  static cudaError_t err = cudaFuncSetAttribute(
      nucleus_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int grid, int threads, int cc, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = 0;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cc;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// neg, perm: (rows, row) with row >= n; keep: (rows, n); one cluster of
// `cluster` CTAs (1..16) a row.
AK_EXPORT int ak_nucleus_mask(const void* neg, const void* perm, void* keep,
                              int rows, int n, int row, float top_p,
                              int cluster, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n <= 0) return 0;
  cudaError_t err = allow_large_clusters();
  if (err != cudaSuccess) return (int)err;
  int slice, threads;
  geometry(n, cluster, &slice, &threads);
  const bool vec = ((reinterpret_cast<uintptr_t>(neg) |
                     reinterpret_cast<uintptr_t>(perm)) & 15) == 0 &&
                   row % 16 == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, rows * cluster, threads, cluster,
                 static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, nucleus_kernel,
                           static_cast<const float*>(neg),
                           static_cast<const int32_t*>(perm),
                           static_cast<bool*>(keep), n, row, slice, top_p,
                           vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs, at the block size n lanes take, the
// card can hold at once (cudaOccupancyMaxActiveClusters) -> *out.
AK_EXPORT int ak_nucleus_max_clusters(int n, int cluster, int* out) {
  if (cluster < 1 || cluster > kMaxCluster || n <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_large_clusters();
  if (err != cudaSuccess) return (int)err;
  int slice, threads;
  geometry(n, cluster, &slice, &threads);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, cluster, threads, cluster, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, nucleus_kernel, &cfg);
}
