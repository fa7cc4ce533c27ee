// accumulate and the segmented scan for Hopper (sm_90a).
//
// Replaces repro/kernels/scan_kernel.py: scan_blocks (_scan_body, _row_scan)
// and repro/kernels/segment_kernel.py: segmented_scan_blocks
// (_segscan_body, _segscan_block, _flagged_row_scan). The TPU kernels
// carried the running prefix in VMEM from one grid step to the next, which
// works because a TensorCore runs its grid in order. CTAs run in no order.
//
// Bound: bytes. The input is read once and the output written once.
//
// The dense scan over more than one tile (onepass_kernel) is AK.jl's own
// single pass (Merrill and Garland's decoupled look-back), with an
// association that does not depend on timing. A CTA takes the next tile id
// from an atomic counter, so it waits only on tiles that started before it
// (forward progress; the CTA that takes the last id sets the counter back
// to 0). It scans its tile locally, publishes the tile's aggregate in a
// status word, and then needs the inclusive value before its tile. Tiles
// form groups of kGroup; tile p of group g takes
//   seed = op(E_g, fold of the aggregates of tiles (g, 0 .. p-1)),
// the fold a fixed tree (kSlots aggregates a lane in order, then a warp
// fold), and E_0 = init. The group's last tile publishes
//   E_{g+1} = op(its seed, its aggregate).
// Classic look-back would fold predecessors' aggregates back to whichever
// tile had already published its inclusive prefix, so a float sum would
// change from run to run; here every seed is the same function of the
// input whatever the timing, and results repeat bitwise. Only the E chain
// is serial, one hop a group: a group carries kGroup tiles (4 MiB of
// float32 in, 4 MiB out), more than the card streams during one hop.
// Status words are 64 bits, written and read whole: the value (32 bits:
// float32, int32, or float32 for bf16) and the call's epoch, which the
// wrapper counts up per call, so a word of an earlier call never reads as
// published and no memset precedes a call.
//
// An input of at most one tile, and every pass of the segmented scan, run
// scan_kernel, which reads no status: seeded with init (one tile), or in
// three passes over tiles of kTile elements (segmented):
//   1. AGG:  each CTA folds one tile into its aggregate;
//   2. one CTA scans the aggregates (exclusive, seeded with init), walking
//      them in chunks of kTile with a running carry;
//   3. each CTA scans its tile again, seeded with its tile's prefix.
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

#include "ak_stream.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 8192
constexpr int kGroup = 128;               // tiles of a look-back group
constexpr int kSlots = kGroup / 32;       // group aggregates a lane folds
constexpr int kOnepassCtasPerSm = 4;      // 2048 threads: the SM's limit

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

// Shared memory of one tile's scan.
template <typename A, bool SEG>
struct TileShared {
  A v[kTile + kTile / 32];
  __align__(16) uint8_t f[SEG ? kTile : 16];
  A wv[kWarps];    // warps' inclusive totals
  int wf[kWarps];
  A pre[kWarps];   // exclusive scan of the warps' totals (no seed)
  int pf[kWarps];
  A tot;           // the tile's aggregate (no seed)
  int totf;
};

// What a thread keeps from the tile's local scan to its output. Its run's
// inclusive values stay in registers (REGS), or wait in its own slots of
// TileShared::v, which frees the registers, and so lets an SM hold more
// CTAs, for the single pass's wait on the seed.
template <typename A, bool REGS>
struct ThreadRun {
  A v[REGS ? kItems : 1];
  unsigned own;    // bit j: head flag of element j
  unsigned acc;    // bit j: a head at or before element j in the run
  A ev;            // exclusive prefix of this thread within its warp
  int ef;
};

// The local scan of the tile at base (identity past n): stage, scan each
// thread's run in registers (keeping its inclusive values as ThreadRun
// says), scan the runs' totals across the warp and the warps' totals in
// warp 0.
// Leaves s.pre/pf and s.tot/totf; ends synchronised.
template <typename In, int OP, bool SEG, typename A, bool REGS>
__device__ __forceinline__ void tile_scan(
    const In* __restrict__ x, const uint8_t* __restrict__ flags, long long n,
    long long base, A ident, A init, int transform, TileShared<A, SEG>& s,
    ThreadRun<A, REGS>& r) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // stage the tile: coalesced rows in, padding past n with the identity
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    const long long g = base + i;
    s.v[slot(i)] = g < n ? ak_cast<A, In>(x[g]) : ident;
    if (SEG) s.f[i] = g < n ? flags[g] : 0;
  }
  __syncthreads();

  // this thread's run, scanned in registers
  r.own = 0;
  r.acc = 0;
  if (SEG) {
    const uint4 fw = reinterpret_cast<const uint4*>(s.f)[tid];
    const uint8_t* fb = reinterpret_cast<const uint8_t*>(&fw);
#pragma unroll
    for (int j = 0; j < kItems; ++j) r.own |= (unsigned)(fb[j] != 0) << j;
  }
  A run = ident;
  int rf = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = slot(tid * kItems + j);
    A e = s.v[k];
    if (SEG && ((r.own >> j) & 1)) {
      run = transform ? AkOpF<OP>::apply(init, e) : e;
      rf = 1;
    } else {
      run = AkOpF<OP>::apply(run, e);
    }
    if constexpr (REGS)
      r.v[j] = run;
    else
      s.v[k] = run;
    if (SEG) r.acc |= (unsigned)rf << j;
  }

  // exclusive prefix of this thread within its warp
  A tv = run;
  int tf = rf;
  warp_scan<OP, SEG>(tv, tf);
  r.ev = __shfl_up_sync(kAkFullMask, tv, 1);
  r.ef = SEG ? __shfl_up_sync(kAkFullMask, tf, 1) : 0;
  if (lane == 0) {
    r.ev = ident;
    r.ef = 0;
  }
  if (lane == 31) {
    s.wv[warp] = tv;
    s.wf[warp] = tf;
  }
  __syncthreads();
  if (warp == 0) {
    A wv = lane < kWarps ? s.wv[lane] : ident;
    int wf = lane < kWarps ? s.wf[lane] : 0;
    warp_scan<OP, SEG>(wv, wf);
    A pv = __shfl_up_sync(kAkFullMask, wv, 1);
    int pf = SEG ? __shfl_up_sync(kAkFullMask, wf, 1) : 0;
    if (lane == 0) {
      pv = ident;
      pf = 0;
    }
    if (lane < kWarps) {
      s.pre[lane] = pv;
      s.pf[lane] = pf;
    }
    const A tot_v = __shfl_sync(kAkFullMask, wv, kWarps - 1);
    const int tot_f = SEG ? __shfl_sync(kAkFullMask, wf, kWarps - 1) : 0;
    if (lane == 0) {
      s.tot = tot_v;
      s.totf = tot_f;
    }
  }
  __syncthreads();
}

// The tile's output (mode kIncl, kExcl or kExclSeg), seeded with seed: the
// inclusive value before the tile. Staged back through shared memory and
// written in coalesced rows.
template <typename In, int OP, bool SEG, typename A, bool REGS>
__device__ __forceinline__ void tile_store(
    In* __restrict__ out, long long n, long long base, A seed, A init,
    int mode, TileShared<A, SEG>& s, const ThreadRun<A, REGS>& r) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const A pw = (SEG && s.pf[warp]) ? s.pre[warp]
                                   : AkOpF<OP>::apply(seed, s.pre[warp]);
  // p: the inclusive value of the element before this thread's run
  const A p = (SEG && r.ef) ? r.ev : AkOpF<OP>::apply(pw, r.ev);
  A last = p;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = slot(tid * kItems + j);
    A v;
    if constexpr (REGS)
      v = r.v[j];
    else
      v = s.v[k];
    const A inc = (SEG && ((r.acc >> j) & 1)) ? v : AkOpF<OP>::apply(p, v);
    A o = mode == kIncl ? inc : last;
    if (SEG && mode == kExclSeg && ((r.own >> j) & 1)) o = init;
    last = inc;
    s.v[k] = o;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    const long long g = base + i;
    if (g < n) out[g] = ak_cast<In, A>(s.v[slot(i)]);
  }
}

// In = Out = the element type for passes 1 and 3, the accumulator type for
// pass 2. A CTA scans tiles_per_cta consecutive tiles, seeded with
// prefix[blockIdx.x] (or `seed` when prefix is null).
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
  __shared__ TileShared<A, SEG> s;
  const A ident = ak_from_double<A>(ident_d);
  const A init = ak_from_double<A>(init_d);
  A seed = prefix ? prefix[blockIdx.x] : ak_from_double<A>(seed_d);

  for (int t = 0; t < tiles_per_cta; ++t) {
    const long long tile = (long long)blockIdx.x * tiles_per_cta + t;
    const long long base = tile * kTile;
    if (base >= n) break;  // uniform across the CTA
    ThreadRun<A, true> r;
    tile_scan<In, OP, SEG>(x, flags, n, base, ident, init, transform, s, r);
    if (mode == kAgg) {
      if (threadIdx.x == 0) {
        agg_v[tile] = s.tot;
        if (SEG) agg_f[tile] = (uint8_t)s.totf;
      }
    } else {
      tile_store<In, OP, SEG>(out, n, base, seed, init, mode, s, r);
    }
    seed = (SEG && s.totf) ? s.tot : AkOpF<OP>::apply(seed, s.tot);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The single pass: status words
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(w) : "memory");
}

template <typename A>
__device__ __forceinline__ unsigned long long pack(A v, unsigned epoch) {
  unsigned bits;
  if constexpr (std::is_same<A, float>::value) bits = __float_as_uint(v);
  else bits = (unsigned)v;
  return ((unsigned long long)epoch << 32) | bits;
}

template <typename A>
__device__ __forceinline__ A unpack(unsigned long long w) {
  if constexpr (std::is_same<A, float>::value)
    return __uint_as_float((unsigned)w);
  else
    return (A)(unsigned)w;
}

// The word at p once this call (epoch) has published it. Every word a
// tile waits on belongs to a tile that started before it, so the wait
// ends; should it not (a fault elsewhere), the kernel traps after some
// 2^24 polls (seconds) and the launch fails instead of holding the card.
__device__ __forceinline__ unsigned long long wait_status(
    const unsigned long long* p, unsigned epoch) {
  unsigned long long w = ld_status(p);
  for (unsigned polls = 0; (unsigned)(w >> 32) != epoch; ++polls) {
    if (polls == (1u << 24)) __trap();
    __nanosleep(32);
    w = ld_status(p);
  }
  return w;
}

// status: [counter (low 32 bits), aggregate of each of `tiles` tiles, E_g
// of each group g >= 1 (at index g of the last block)]. Four CTAs an SM
// (32 registers a thread; the runs wait in shared memory): a tile's
// look-back is latency with no bytes in flight, and only more tiles
// resident at once keep the memory busy meanwhile (PERF.md has the times
// at two CTAs an SM and at four).
template <typename In, int OP>
__global__ void __launch_bounds__(kThreads, kOnepassCtasPerSm)
onepass_kernel(const In* __restrict__ x, long long n, long long tiles,
               double ident_d, double init_d, int mode,
               In* __restrict__ out, unsigned long long* status,
               unsigned epoch) {
  typedef typename AkAcc<In>::type A;
  __shared__ TileShared<A, false> s;
  __shared__ long long sh_tile;
  __shared__ A sh_seed;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const A ident = ak_from_double<A>(ident_d);
  const A init = ak_from_double<A>(init_d);
  unsigned int* counter = reinterpret_cast<unsigned int*>(status);
  unsigned long long* agg = status + 1;
  unsigned long long* grp = agg + tiles;

  if (tid == 0) {
    const unsigned int t = atomicAdd(counter, 1u);
    if (t == tiles - 1) *counter = 0;  // every CTA has taken its id
    sh_tile = t;
  }
  __syncthreads();
  const long long tile = sh_tile, base = tile * kTile;
  ThreadRun<A, false> r;
  tile_scan<In, OP, false>(x, nullptr, n, base, ident, init, 0, s, r);

  if (warp == 0) {
    const A tot = s.tot;
    if (lane == 0) st_status(agg + tile, pack(tot, epoch));
    const long long g = tile / kGroup;
    const int p = (int)(tile % kGroup);
    const unsigned long long* ga = agg + g * kGroup;
    unsigned long long w[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int k = lane * kSlots + i;
      w[i] = k < p ? ld_status(ga + k) : 0ull;
    }
    A a = ident;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int k = lane * kSlots + i;
      A v = ident;
      if (k < p) {
        if ((unsigned)(w[i] >> 32) != epoch) w[i] = wait_status(ga + k, epoch);
        v = unpack<A>(w[i]);
      }
      a = AkOpF<OP>::apply(a, v);
    }
    a = ak_warp_fold<OP>(a);
    if (lane == 0) {
      const A e = g == 0 ? init : unpack<A>(wait_status(grp + g, epoch));
      const A seed = AkOpF<OP>::apply(e, a);
      if (p == kGroup - 1 && tile + 1 < tiles)
        st_status(grp + g + 1, pack(AkOpF<OP>::apply(seed, tot), epoch));
      sh_seed = seed;
    }
  }
  __syncthreads();
  tile_store<In, OP, false>(out, n, base, sh_seed, init, mode, s, r);
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

template <typename In, int OP>
int launch_onepass(const void* x, long long n, double ident, double init,
                   int mode, void* out, void* status, unsigned epoch,
                   cudaStream_t s) {
  const long long tiles = (n + kTile - 1) / kTile;
  onepass_kernel<In, OP><<<(unsigned int)tiles, kThreads, 0, s>>>(
      static_cast<const In*>(x), n, tiles, ident, init, mode,
      static_cast<In*>(out), static_cast<unsigned long long*>(status),
      epoch);
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

// The dense scan of x[n] (dtype; n > one tile) in one launch. mode: 0
// inclusive, 1 exclusive. status: at least 1 + tiles + groups words of 64
// bits (tiles = n / kTile, groups = tiles / kGroup, both rounded up), its
// first word 0 on entry (0 again on exit; zeros at first use); epoch: nonzero, and differs from that of every earlier call on
// this buffer that a word may still hold.
AK_EXPORT int ak_scan_onepass(const void* x, int dtype, int op, long long n,
                              double ident, double init, int mode, void* out,
                              void* status, unsigned int epoch,
                              void* stream) {
  if (n <= 0 || epoch == 0 || (mode != kIncl && mode != kExcl))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ak_with_type(dtype, [&](auto tt) {
    typedef typename decltype(tt)::type T;
    switch (op) {
      case AK_ADD: return launch_onepass<T, AK_ADD>(x, n, ident, init, mode, out, status, epoch, s);
      case AK_MUL: return launch_onepass<T, AK_MUL>(x, n, ident, init, mode, out, status, epoch, s);
      case AK_MIN: return launch_onepass<T, AK_MIN>(x, n, ident, init, mode, out, status, epoch, s);
      case AK_MAX: return launch_onepass<T, AK_MAX>(x, n, ident, init, mode, out, status, epoch, s);
    }
    return (int)cudaErrorInvalidValue;
  });
}

// Elements per tile (one CTA's share in passes 1 and 3).
AK_EXPORT int ak_scan_tile() { return kTile; }
// Tiles of a look-back group of the single pass.
AK_EXPORT int ak_scan_group() { return kGroup; }
