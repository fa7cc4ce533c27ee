// accumulate and the segmented scan for Hopper (sm_90a): reduce-then-scan.
//
// Replaces repro/kernels/scan_kernel.py: scan_blocks (_scan_body, _row_scan)
// and repro/kernels/segment_kernel.py: segmented_scan_blocks
// (_segscan_body, _segscan_block, _flagged_row_scan). The TPU kernels
// carried the running prefix in VMEM from one grid step to the next, which
// works because a TensorCore runs its grid in order. CTAs run in no order,
// so here the carry is computed, not carried, in three passes over tiles of
// kTile elements:
//   1. AGG:  each CTA folds one tile into its aggregate;
//   2. one CTA scans the aggregates (exclusive, seeded with init), walking
//      them in chunks of kTile with a running carry;
//   3. each CTA scans its tile again, seeded with its tile's prefix.
// An input of at most one tile takes pass 3 alone, seeded with init. No CTA
// waits on another, so there is no spin and no forward-progress hazard, and
// the order of every operation is fixed by n: the result is deterministic.
//
// Within a tile, staged through shared memory (coalesced rows in and out),
// thread t owns kItems consecutive elements and scans them sequentially in
// registers; the threads' totals are scanned across each warp by shuffles
// (a Hillis-Steele tree over the lanes) and the warps' totals by warp 0.
//
// Segmented (SEG): every element carries a head flag (1 at the first
// element of each non-empty segment) and the operator is the flagged
// monoid (fa, va) + (fb, vb) = (fa | fb, fb ? vb : op(va, vb)), carried
// through all three passes (the tile aggregates keep their flag). init is
// folded in once per segment, at its head (op(init, x_head)), and once
// globally as the seed, so out = op(init, x_0 .. x_i) per segment.
//
// Bound: bytes. Passes 1 and 3 each read the input (pass 3 also writes the
// output); pass 2 touches n / kTile aggregates. A single-pass decoupled
// look-back scan that reads the input once is the next step.

#include "ak_stream.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 8192

enum ScanMode { kIncl = 0, kExcl = 1, kExclSeg = 2, kAgg = 3 };

// Inclusive scan of (flag, value) pairs across the lanes of a warp.
template <int OP, bool SEG, typename A>
__device__ __forceinline__ void warp_scan(A& v, int& f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const A pv = __shfl_up_sync(kAkFullMask, v, d);
    const int pf = SEG ? __shfl_up_sync(kAkFullMask, f, d) : 0;
    if (lane >= d) {
      if (!SEG || !f) v = AkOpF<OP>::apply(pv, v);
      if (SEG) f |= pf;
    }
  }
}

// Shared-memory slot of tile element i: one pad word per 32 words, so that
// both a warp's coalesced row (32 consecutive i) and the element j of the
// warp's 32 runs (i = 16 lane + j) fall in 32 distinct banks.
__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

// In = Out = the element type for passes 1 and 3, the accumulator type for
// pass 2. A CTA scans tiles_per_cta consecutive tiles, seeded with
// prefix[blockIdx.x] (or `seed` when prefix is null). Per tile: the tile is
// staged through shared memory so that thread t owns the kItems
// consecutive elements [t * kItems, (t + 1) * kItems), scans them
// sequentially in registers, and joins the others through one warp scan
// of the threads' totals and one scan of the warps' totals by warp 0.
template <typename In, int OP, bool SEG>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const In* __restrict__ x, const uint8_t* __restrict__ flags,
            long long n, int tiles_per_cta,
            const typename AkAcc<In>::type* __restrict__ prefix,
            double seed_d, double ident_d, double init_d, int mode,
            int transform, In* __restrict__ out,
            typename AkAcc<In>::type* __restrict__ agg_v,
            uint8_t* __restrict__ agg_f) {
  typedef typename AkAcc<In>::type A;
  __shared__ A sh[kTile + kTile / 32];
  __shared__ __align__(16) uint8_t sh_f[SEG ? kTile : 16];
  __shared__ A sh_wv[kWarps];
  __shared__ int sh_wf[kWarps];
  __shared__ A sh_pre[kWarps];
  __shared__ A sh_seed;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const A ident = ak_from_double<A>(ident_d);
  const A init = ak_from_double<A>(init_d);
  A seed = prefix ? prefix[blockIdx.x] : ak_from_double<A>(seed_d);

  for (int t = 0; t < tiles_per_cta; ++t) {
    const long long tile = (long long)blockIdx.x * tiles_per_cta + t;
    const long long base = tile * kTile;
    if (base >= n) break;  // uniform across the CTA

    // stage the tile: coalesced rows in, padding past n with the identity
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + tid;
      const long long g = base + i;
      sh[slot(i)] = g < n ? ak_cast<A, In>(x[g]) : ident;
      if (SEG) sh_f[i] = g < n ? flags[g] : 0;
    }
    __syncthreads();

    // this thread's run, scanned in registers
    A v[kItems];
    unsigned own = 0, acc = 0;  // bit j: own head flag, accumulated flag
    if (SEG) {
      const uint4 fw = reinterpret_cast<const uint4*>(sh_f)[tid];
      const uint8_t* fb = reinterpret_cast<const uint8_t*>(&fw);
#pragma unroll
      for (int j = 0; j < kItems; ++j) own |= (unsigned)(fb[j] != 0) << j;
    }
    A run = ident;
    int rf = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      A e = sh[slot(tid * kItems + j)];
      if (SEG && ((own >> j) & 1)) {
        run = transform ? AkOpF<OP>::apply(init, e) : e;
        rf = 1;
      } else {
        run = AkOpF<OP>::apply(run, e);
      }
      v[j] = run;
      if (SEG) acc |= (unsigned)rf << j;
    }

    // exclusive prefix of this thread within its warp
    A tv = run;
    int tf = rf;
    warp_scan<OP, SEG>(tv, tf);
    A ev = __shfl_up_sync(kAkFullMask, tv, 1);
    int ef = SEG ? __shfl_up_sync(kAkFullMask, tf, 1) : 0;
    if (lane == 0) {
      ev = ident;
      ef = 0;
    }
    if (lane == 31) {
      sh_wv[warp] = tv;
      sh_wf[warp] = tf;
    }
    __syncthreads();
    if (warp == 0) {
      A wv = lane < kWarps ? sh_wv[lane] : ident;
      int wf = lane < kWarps ? sh_wf[lane] : 0;
      warp_scan<OP, SEG>(wv, wf);
      A pv = __shfl_up_sync(kAkFullMask, wv, 1);
      int pf = SEG ? __shfl_up_sync(kAkFullMask, wf, 1) : 0;
      if (lane == 0) {
        pv = ident;
        pf = 0;
      }
      if (lane < kWarps)
        sh_pre[lane] = (SEG && pf) ? pv : AkOpF<OP>::apply(seed, pv);
      const A tot_v = __shfl_sync(kAkFullMask, wv, kWarps - 1);
      const int tot_f = SEG ? __shfl_sync(kAkFullMask, wf, kWarps - 1) : 0;
      if (lane == 0) {
        if (mode == kAgg) {
          agg_v[tile] = tot_v;
          if (SEG) agg_f[tile] = (uint8_t)tot_f;
        }
        sh_seed = (SEG && tot_f) ? tot_v : AkOpF<OP>::apply(seed, tot_v);
      }
    }
    __syncthreads();

    if (mode != kAgg) {
      // p: the inclusive value of the element before this thread's run
      const A pw = sh_pre[warp];
      const A p = (SEG && ef) ? ev : AkOpF<OP>::apply(pw, ev);
      A last = p;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const A inc = (SEG && ((acc >> j) & 1)) ? v[j]
                                                : AkOpF<OP>::apply(p, v[j]);
        A o = mode == kIncl ? inc : last;
        if (SEG && mode == kExclSeg && ((own >> j) & 1)) o = init;
        last = inc;
        sh[slot(tid * kItems + j)] = o;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int i = k * kThreads + tid;
        const long long g = base + i;
        if (g < n) out[g] = ak_cast<In, A>(sh[slot(i)]);
      }
    }
    seed = sh_seed;
    __syncthreads();
  }
}

template <typename In, int OP>
int launch(const void* x, const void* flags, long long n, int grid,
           int tiles_per_cta, const void* prefix, double seed, double ident,
           double init, int mode, int transform, void* out, void* agg_v,
           void* agg_f, cudaStream_t s) {
  typedef typename AkAcc<In>::type A;
  if (flags) {
    scan_kernel<In, OP, true><<<grid, kThreads, 0, s>>>(
        static_cast<const In*>(x), static_cast<const uint8_t*>(flags), n,
        tiles_per_cta, static_cast<const A*>(prefix), seed, ident, init,
        mode, transform, static_cast<In*>(out), static_cast<A*>(agg_v),
        static_cast<uint8_t*>(agg_f));
  } else {
    scan_kernel<In, OP, false><<<grid, kThreads, 0, s>>>(
        static_cast<const In*>(x), nullptr, n, tiles_per_cta,
        static_cast<const A*>(prefix), seed, ident, init, mode, transform,
        static_cast<In*>(out), static_cast<A*>(agg_v), nullptr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One pass of the scan over x[n] (dtype), flags[n] (uint8, null for the
// dense scan). mode: 0 inclusive, 1 exclusive, 2 exclusive with heads set
// to init (segmented), 3 tile aggregates into agg_v/agg_f (accumulator
// type; float for bfloat16). transform: fold init into each head element.
AK_EXPORT int ak_scan_pass(const void* x, const void* flags, int dtype,
                           int op, long long n, int grid, int tiles_per_cta,
                           const void* prefix, double seed, double ident,
                           double init, int mode, int transform, void* out,
                           void* agg_v, void* agg_f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ak_with_type(dtype, [&](auto tt) {
    typedef typename decltype(tt)::type T;
    switch (op) {
      case AK_ADD: return launch<T, AK_ADD>(x, flags, n, grid, tiles_per_cta, prefix, seed, ident, init, mode, transform, out, agg_v, agg_f, s);
      case AK_MUL: return launch<T, AK_MUL>(x, flags, n, grid, tiles_per_cta, prefix, seed, ident, init, mode, transform, out, agg_v, agg_f, s);
      case AK_MIN: return launch<T, AK_MIN>(x, flags, n, grid, tiles_per_cta, prefix, seed, ident, init, mode, transform, out, agg_v, agg_f, s);
      case AK_MAX: return launch<T, AK_MAX>(x, flags, n, grid, tiles_per_cta, prefix, seed, ident, init, mode, transform, out, agg_v, agg_f, s);
    }
    return (int)cudaErrorInvalidValue;
  });
}

// Elements per tile (one CTA's share in passes 1 and 3).
AK_EXPORT int ak_scan_tile() { return kTile; }
