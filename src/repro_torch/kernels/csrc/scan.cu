// accumulate and the segmented scan for Hopper (sm_90a).
//
// Replaces repro/kernels/scan_kernel.py: scan_blocks (_scan_body, _row_scan)
// and repro/kernels/segment_kernel.py: segmented_scan_blocks
// (_segscan_body, _segscan_block, _flagged_row_scan). The TPU kernels
// carried the running prefix in VMEM from one grid step to the next, which
// works because a TensorCore runs its grid in order. CTAs run in no order.
//
// Bound: bytes. The input (and the head flags) is read once and the output
// written once.
//
// One kernel, onepass_kernel, scans the dense and the segmented input:
// AK.jl's own single pass (Merrill and Garland's decoupled look-back), with
// an association that does not depend on timing. A CTA takes the next tile
// id from an atomic counter, so it waits only on tiles that started before
// it (forward progress; the CTA that takes the last id sets the counter
// back to 0). It scans its tile locally, publishes the tile's aggregate in
// a status word, and then needs the inclusive value before its tile. Tiles
// form groups of kGroup; tile p of group g takes
//   seed = E_g + (fold of the aggregates of tiles (g, 0 .. p-1)),
// the fold a fixed tree (kSlots aggregates a lane in order, then a warp
// fold that keeps the lanes in order where the operator needs it), and
// E_0 = init. The group's last tile publishes
//   E_{g+1} = seed + its aggregate.
// Classic look-back would fold predecessors' aggregates back to whichever
// tile had already published its inclusive prefix, so a float sum would
// change from run to run; here every seed is the same function of the
// input whatever the timing, and results repeat bitwise. Only the E chain
// is serial, one hop a group: a group carries kGroup tiles (4 MiB of
// float32 in, 4 MiB out), more than the card streams during one hop. An
// input of one tile is seeded with init alone.
//
// Segmented (SEG): every element carries a head flag (1 at the first
// element of each non-empty segment) and "+" above is the flagged monoid
// (fa, va) + (fb, vb) = (fa | fb, fb ? vb : op(va, vb)), which is
// associative, so the fixed association carries over unchanged: a tile
// aggregate keeps its flag, the fold combines flags, and a seed or E_{g+1}
// is the later operand's value where that holds a head. E needs no flag:
// it only ever stands on the left. init is folded in once per segment, at
// its head (op(init, x_head)), and once globally as E_0, so out =
// op(init, x_0 .. x_i) per segment.
//
// Status words are 64 bits, written and read whole: the value in the low
// 32 bits (float32, int32, or float32 for bf16) and above it the call's
// epoch (dense: 32 bits), or the flag and a 31-bit epoch (segmented: bit
// 32 the flag, bits 33..63 the epoch). The wrapper counts the epoch up per
// call on a buffer of its own for each mode, so a word of an earlier call
// never reads as published and no memset precedes a call.
//
// Within a tile, staged through shared memory (coalesced rows in and out),
// thread t owns kItems consecutive elements and scans them sequentially in
// registers; the threads' totals are scanned across each warp by shuffles
// (a Hillis-Steele tree over the lanes) and the warps' totals by warp 0.
// A thread's run waits in shared memory for the seed, which keeps a
// thread to 32 registers and four CTAs on an SM (three segmented): a
// tile's look-back is latency with no bytes in flight, and only more tiles
// resident at once keep the memory busy meanwhile.

#include "ak_stream.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 8192
constexpr int kGroup = 128;               // tiles of a look-back group
constexpr int kSlots = kGroup / 32;       // group aggregates a lane folds
// CTAs an SM: 4 dense (2048 threads, the SM's limit; 32 registers a
// thread), 3 segmented (the flags' bookkeeping needs up to 40 registers)
template <bool SEG>
constexpr int kOnepassCtasPerSm = SEG ? 3 : 4;

enum ScanMode { kIncl = 0, kExcl = 1, kExclSeg = 2 };

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
  A wv[kWarps];    // warps' inclusive totals
  int wf[kWarps];
  A pre[kWarps];   // exclusive scan of the warps' totals (no seed)
  int pf[kWarps];
  A tot;           // the tile's aggregate (no seed)
  int totf;
};

// What a thread keeps from the tile's local scan to its output. Its run's
// inclusive values wait in its own slots of TileShared::v, which frees the
// registers for more CTAs on an SM (the note at the top of the file).
template <typename A>
struct ThreadRun {
  unsigned own;    // bit j: head flag of element j
  A ev;            // exclusive prefix of this thread within its warp
  int ef;
};

// The local scan of the tile at base (identity past n): stage, scan each
// thread's run in registers (its inclusive values back to its slots), scan
// the runs' totals across the warp and the warps' totals in warp 0. SEG
// folds init into each head element; a thread reads its run's 16 flags
// straight from device memory, as one 16-byte load where fvec (flags
// 16-byte aligned) and the tile is whole.
// Leaves s.pre/pf and s.tot/totf; ends synchronised.
template <typename In, int OP, bool SEG, typename A>
__device__ __forceinline__ void tile_scan(
    const In* __restrict__ x, const uint8_t* __restrict__ flags, long long n,
    long long base, A ident, A init, int fvec, TileShared<A, SEG>& s,
    ThreadRun<A>& r) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's head flags (issued before the tile's values)
  r.own = 0;
  if (SEG) {
    uint4 fw;
    uint8_t* fb = reinterpret_cast<uint8_t*>(&fw);
    const long long first = base + (long long)tid * kItems;
    if (fvec && base + kTile <= n) {
      fw = reinterpret_cast<const uint4*>(flags + base)[tid];
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        fb[j] = first + j < n ? flags[first + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) r.own |= (unsigned)(fb[j] != 0) << j;
  }
  // stage the tile: coalesced rows in, padding past n with the identity
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    const long long g = base + i;
    s.v[slot(i)] = g < n ? ak_cast<A, In>(x[g]) : ident;
  }
  __syncthreads();

  // this thread's run, scanned in registers
  A run = ident;
  int rf = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = slot(tid * kItems + j);
    A e = s.v[k];
    if (SEG && ((r.own >> j) & 1)) {
      run = AkOpF<OP>::apply(init, e);
      rf = 1;
    } else {
      run = AkOpF<OP>::apply(run, e);
    }
    s.v[k] = run;
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
template <typename In, int OP, bool SEG, typename A>
__device__ __forceinline__ void tile_store(
    In* __restrict__ out, long long n, long long base, A seed, A init,
    int mode, TileShared<A, SEG>& s, const ThreadRun<A>& r) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const A pw = (SEG && s.pf[warp]) ? s.pre[warp]
                                   : AkOpF<OP>::apply(seed, s.pre[warp]);
  // p: the inclusive value of the element before this thread's run
  const A p = (SEG && r.ef) ? r.ev : AkOpF<OP>::apply(pw, r.ev);
  A last = p;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int k = slot(tid * kItems + j);
    const A v = s.v[k];
    // a head at or before element j of the run: v holds no seed
    const bool acc = SEG && (r.own & ((2u << j) - 1)) != 0;
    const A inc = acc ? v : AkOpF<OP>::apply(p, v);
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

// (fa, va) + (fb, vb) into (fa, va): the flagged monoid under SEG, op
// alone otherwise.
template <int OP, bool SEG, typename A>
__device__ __forceinline__ void combine(A& va, int& fa, A vb, int fb) {
  va = (SEG && fb) ? vb : AkOpF<OP>::apply(va, vb);
  if (SEG) fa |= fb;
}

// ---------------------------------------------------------------------------
// Status words
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

// The epoch a word carries: bits 32..63 (dense) or 33..63 (segmented).
template <bool SEG>
__device__ __forceinline__ unsigned epoch_of(unsigned long long w) {
  return (unsigned)(w >> (SEG ? 33 : 32));
}

template <bool SEG, typename A>
__device__ __forceinline__ unsigned long long pack(A v, int f,
                                                   unsigned epoch) {
  unsigned bits;
  if constexpr (std::is_same<A, float>::value) bits = __float_as_uint(v);
  else bits = (unsigned)v;
  const unsigned long long hi =
      SEG ? ((unsigned long long)epoch << 1) | (unsigned)(f != 0) : epoch;
  return (hi << 32) | bits;
}

template <typename A>
__device__ __forceinline__ A unpack(unsigned long long w) {
  if constexpr (std::is_same<A, float>::value)
    return __uint_as_float((unsigned)w);
  else
    return (A)(unsigned)w;
}

__device__ __forceinline__ int unpack_flag(unsigned long long w) {
  return (int)((w >> 32) & 1);
}

// The word at p once this call (epoch) has published it. Every word a
// tile waits on belongs to a tile that started before it, so the wait
// ends; should it not (a fault elsewhere), the kernel traps after some
// 2^24 polls (seconds) and the launch fails instead of holding the card.
template <bool SEG>
__device__ __forceinline__ unsigned long long wait_status(
    const unsigned long long* p, unsigned epoch) {
  unsigned long long w = ld_status(p);
  for (unsigned polls = 0; epoch_of<SEG>(w) != epoch; ++polls) {
    if (polls == (1u << 24)) __trap();
    __nanosleep(32);
    w = ld_status(p);
  }
  return w;
}

// ---------------------------------------------------------------------------
// The single pass
// ---------------------------------------------------------------------------

// status: [counter (low 32 bits), aggregate of each of `tiles` tiles, E_g
// of each group g >= 1 (at index g of the last block)]. flags: the head
// flags under SEG (else unused).
template <typename In, int OP, bool SEG>
__global__ void __launch_bounds__(kThreads, kOnepassCtasPerSm<SEG>)
onepass_kernel(const In* __restrict__ x, const uint8_t* __restrict__ flags,
               long long n, long long tiles, double ident_d, double init_d,
               int mode, int fvec, In* __restrict__ out,
               unsigned long long* status, unsigned epoch) {
  typedef typename AkAcc<In>::type A;
  __shared__ TileShared<A, SEG> s;
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
  ThreadRun<A> r;
  tile_scan<In, OP, SEG>(x, flags, n, base, ident, init, fvec, s, r);

  if (warp == 0) {
    const A tot = s.tot;
    const int totf = SEG ? s.totf : 0;
    if (lane == 0) st_status(agg + tile, pack<SEG>(tot, totf, epoch));
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
    int af = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int k = lane * kSlots + i;
      A v = ident;
      int vf = 0;
      if (k < p) {
        if (epoch_of<SEG>(w[i]) != epoch)
          w[i] = wait_status<SEG>(ga + k, epoch);
        v = unpack<A>(w[i]);
        vf = SEG ? unpack_flag(w[i]) : 0;
      }
      combine<OP, SEG>(a, af, v, vf);
    }
    // fold of the 32 lanes into lane 0, a fixed shuffle-down tree: at
    // distances 16 .. 1 (dense, as ak_warp_fold), or 1 .. 16 under SEG,
    // which keeps the lanes in order (the flagged monoid does not commute)
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int d = SEG ? 1 << i : 16 >> i;
      const A pv = __shfl_down_sync(kAkFullMask, a, d);
      const int pf = SEG ? __shfl_down_sync(kAkFullMask, af, d) : 0;
      combine<OP, SEG>(a, af, pv, pf);
    }
    if (lane == 0) {
      A seed = init;
      if (tiles > 1) {
        seed = g == 0 ? init
                      : unpack<A>(wait_status<SEG>(grp + g, epoch));
        int sf = 0;
        combine<OP, SEG>(seed, sf, a, af);
      }
      if (p == kGroup - 1 && tile + 1 < tiles) {
        A e = seed;
        int ef = 0;
        combine<OP, SEG>(e, ef, tot, totf);
        st_status(grp + g + 1, pack<SEG>(e, 0, epoch));
      }
      sh_seed = seed;
    }
  }
  __syncthreads();
  tile_store<In, OP, SEG>(out, n, base, sh_seed, init, mode, s, r);
}

template <typename In, int OP>
int launch_onepass(const void* x, const void* flags, long long n,
                   double ident, double init, int mode, void* out,
                   void* status, unsigned epoch, cudaStream_t s) {
  const long long tiles = (n + kTile - 1) / kTile;
  const unsigned int grid = (unsigned int)tiles;
  unsigned long long* st = static_cast<unsigned long long*>(status);
  if (flags) {
    const int fvec = (reinterpret_cast<uintptr_t>(flags) & 15) == 0;
    onepass_kernel<In, OP, true><<<grid, kThreads, 0, s>>>(
        static_cast<const In*>(x), static_cast<const uint8_t*>(flags), n,
        tiles, ident, init, mode, fvec, static_cast<In*>(out), st, epoch);
  } else {
    onepass_kernel<In, OP, false><<<grid, kThreads, 0, s>>>(
        static_cast<const In*>(x), nullptr, n, tiles, ident, init, mode, 0,
        static_cast<In*>(out), st, epoch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The scan of x[n] (dtype; n > 0) in one launch: dense when flags is null,
// else segmented by the uint8 head flags[n]. mode: 0 inclusive, 1
// exclusive, 2 exclusive with heads set to init (segmented only). status:
// at least 1 + tiles + groups words of 64 bits (tiles = n / kTile, groups
// = tiles / kGroup, both rounded up), its first word 0 on entry (0 again
// on exit; zeros at first use), used by calls of one mode only; epoch:
// nonzero, below 2^31 when segmented, and different from that of every
// earlier call on this buffer that a word may still hold.
AK_EXPORT int ak_scan_onepass(const void* x, const void* flags, int dtype,
                              int op, long long n, double ident, double init,
                              int mode, void* out, void* status,
                              unsigned int epoch, void* stream) {
  if (n <= 0 || epoch == 0 || mode < kIncl || mode > kExclSeg ||
      (mode == kExclSeg && !flags) || (flags && epoch >= (1u << 31)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ak_with_type(dtype, [&](auto tt) {
    typedef typename decltype(tt)::type T;
    switch (op) {
      case AK_ADD: return launch_onepass<T, AK_ADD>(x, flags, n, ident, init, mode, out, status, epoch, s);
      case AK_MUL: return launch_onepass<T, AK_MUL>(x, flags, n, ident, init, mode, out, status, epoch, s);
      case AK_MIN: return launch_onepass<T, AK_MIN>(x, flags, n, ident, init, mode, out, status, epoch, s);
      case AK_MAX: return launch_onepass<T, AK_MAX>(x, flags, n, ident, init, mode, out, status, epoch, s);
    }
    return (int)cudaErrorInvalidValue;
  });
}

// Elements per tile (one CTA's share).
AK_EXPORT int ak_scan_tile() { return kTile; }
// Tiles of a look-back group of the single pass.
AK_EXPORT int ak_scan_group() { return kGroup; }
