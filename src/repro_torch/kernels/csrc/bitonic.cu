// Bitonic sorting network for Hopper (sm_90a): the in-block kernel and the
// fused cross-stage window kernel.
//
// Replaces repro/kernels/sort_kernel.py: _inblock_body (run by
// _run_inblock) and _hyper_body (run by _run_hyper). The network, its
// padding and its stage sequence are the reference's, so the two agree
// bitwise, including the order of equal-key pairs. Direction of every
// compare-exchange: ((global index of the low element) & k) == 0, as _cx
// computes it. The payload V is int32, float32 or bfloat16; with the
// tie-break on, equal keys are ordered by `av > bv` in the payload's own
// type, as the reference's _cx/_swap_blocks compare them (so -0.0 and 0.0
// are equal and keep the network's order). Every compare-exchange swaps a
// pair only where ak_lt says the later key is smaller (or, descending, not
// smaller), so the output is a permutation of the input whatever it holds:
// NaN and -0.0 are moved, never duplicated or rewritten.
//
// Rows: the keys may hold R rows of `row` keys each (a power of two), laid
// end to end; every row is one network (the reference vmaps the 1-D network
// over the rows). Compare-exchange pairs never straddle a row, because each
// stage's 2j-groups are aligned and 2j <= k <= row; only the direction of
// the last phase (k == row) would see the row index, so it is taken as
// ((low index) & k & (row - 1)) == 0. A 1-D sort is the case R = 1. One
// launch set then sorts the whole batch: launches do not grow with R.
//
// The in-block kernel (stages j < block) holds one block of 2^lb keys a
// CTA and runs its stages in registers. Each thread holds kSlots = 16 keys
// (and payloads) of the block; the 4 bits of a key's index that tell the
// 16 apart are the thread's register bits, [c, c + 4) for a layout c, the
// other index bits name the thread. A stage at distance 2^p with p in
// [c, c + 4) pairs two of a thread's own keys, so consecutive stages whose
// bits lie in one window run in registers with no shared-memory traffic and
// no barrier: a run. Between runs the block goes through shared memory
// once (each thread stores its 16 keys, one __syncthreads(), each thread
// loads the 16 keys of the next layout): a transpose. A run starts at the
// top stage p of a phase with c = max(p - 3, 0) and lasts while the stage
// bits stay in [c, c + 4); runs at c = 0 carry on into the next phase while
// its top bit is below 4, so phases k <= 16 are one run straight after the
// load. The initial sort of an 8192-key block (phases 2 .. 8192, 91
// stages) takes 25 runs and 24 transposes; a phase's finish (13 stages) 4
// runs and 3 transposes, against one shared-memory pass and one barrier a
// stage before. Shared memory is addressed through an XOR swizzle within
// each row of 32 elements (swz below) under which no two lanes of a warp
// touch two different words of one bank, in every layout, for 4-byte and
// 2-byte elements alike (tests/torch_inblock_model.py checks it).
// The last run of a launch always has c = 0, so a thread stores its 16
// consecutive keys as 16-byte vectors; the first run loads them so where
// it has c = 0 (every initial sort), else as 16 scalar loads of which each
// warp instruction reads 32 consecutive elements (a finish's first run
// has c = lb - 4: the top bits). A CTA has 128 or 256 threads (64
// registers a thread), each holding several groups of 16 keys ("virtual
// threads") in turn, whatever the block (2^10 .. 2^16 keys). What the
// measurements taught (PERF.md, Findings), each a step of the initial launch
// of 2^28 keys from 9.9 ms down: the compare-exchange is written as
// selects (a branch on the data cost 13% keys alone, 42% with a payload);
// the 16 shared-memory offsets of a layout cost one XOR each in Gray-code
// order (swz is linear) instead of a swizzle a slot; a stage whose
// direction is a register bit knows it at compile time and any other has
// one direction for all of a thread's pairs; a run within one phase is
// unrolled, with no dispatch a stage.
//
// Bound: the in-block kernel reads and writes each block once; with its
// 91 stages it is bound by the compare-exchanges and the shared-memory
// transposes, not by bytes. The window kernel runs up to W consecutive
// cross stages (j >= block) of one phase in one pass (W = sort_hyper; at
// sort_hyper = 0, W = 1: one stage a launch): the stages j >= block of one
// window only ever pair element x with x ^ j, so the 2^W elements base + t
// * jlow (t < 2^W, jlow the window's smallest distance) form a group closed
// under the whole window, and all share one direction bit (the window's
// bits lie below log2 k). The reference held 2^W whole 8192-key blocks in
// VMEM per grid step; at W = 3 that is 256 KiB of float32 keys, more than
// a CTA's 227 KB of shared memory. Here one thread holds one group in
// registers instead: thread e of a warp takes offset e in every member
// block, so each of its 2^W loads is one coalesced warp access, runs the
// W-stage butterfly in registers and stores the group back. A pass moves
// the bytes of one unfused pass, so cross passes drop from sum(i) to
// sum(ceil(i / W)) per sort. At W = 6 a thread holds 64 keys and 64
// payloads (128 32-bit registers; bfloat16 takes one register per element
// too). ptxas's report for both kernels is kept in
// build/kernels/libbitonic-*.log (chip_smoke.py lists registers and
// spills). The in-block finish (j < block) of each phase stays its own
// in-block launch: a window's lane slice does not hold whole blocks.

#include "ak_stream.cuh"

namespace {

// Swaps (ka, va) and (kb, vb) where ak_lt(kb, ka) (or, with the
// tie-break, equal keys and ak_lt(vb, va)) ascending, where not
// descending; written as selects, so a warp never branches on the data.
template <typename K, typename V, bool KV, bool TIE>
__device__ __forceinline__ void compare_exchange(K& ka, K& kb, V& va, V& vb,
                                                 bool asc, bool& swapped) {
  bool gt = ak_lt(kb, ka);
  if (TIE) gt = gt | (ak_eq(ka, kb) & ak_lt(vb, va));
  swapped = gt == asc;
  const K a = ka, b = kb;
  ka = swapped ? b : a;
  kb = swapped ? a : b;
  if (KV) {
    const V x = va, y = vb;
    va = swapped ? y : x;
    vb = swapped ? x : y;
  }
}

// ---------------------------------------------------------------------------
// The in-block kernel
// ---------------------------------------------------------------------------

constexpr int kSlotBits = 4;                // index bits a thread holds
constexpr int kSlots = 1 << kSlotBits;      // keys (and payloads) a thread
constexpr int kInblockThreads = 256;        // most threads of a CTA
constexpr int kInblockCtasPerSm = 4;        // 64 registers a thread
static_assert(kSlotBits == 4, "run_stage and run_down dispatch 4 bits");

// Shared-memory slot of block element i: i with its low 5 bits XORed by
// u ^ (u << 1), u = i >> 5 (a permutation of each 32-element row). The map
// is linear over XOR, so swz(a | b) = swz(a) ^ swz(b) for disjoint bits.
__device__ __forceinline__ int swz(int i) {
  const int u = i >> 5;
  return i ^ ((u ^ (u << 1)) & 31);
}

// The top stage bit of phase k in a block of 2^lb keys: log2(min(k, 2^lb)) - 1.
__device__ __forceinline__ int top_bit(long long k, int lb) {
  const int q = 63 - __clzll(k);
  return (q < lb ? q : lb) - 1;
}

// Direction of phase k for virtual thread vt under layout c: the bit
// log2(k & rmask) of a pair's global index, which is a block bit (per
// CTA), a thread bit (per virtual thread) or a register bit (per slot).
// Returns that register bit in the last case; else -1, with desc set where
// the pairs sort descending.
__device__ __forceinline__ int direction(long long k, long long rmask,
                                         long long base, int lb, int c,
                                         int vt, bool& desc) {
  const long long kk = k & rmask;
  desc = false;
  if (kk == 0) return -1;
  const int q = 63 - __clzll(kk);
  if (q >= lb) {
    desc = (base >> q) & 1;
    return -1;
  }
  if (q >= c && q < c + kSlotBits) return q - c;
  desc = ((q < c ? vt >> q : vt >> (q - kSlotBits)) & 1) != 0;
  return -1;
}

// One stage at register bit R: slot s against slot s | 2^R, for every s
// with bit R clear. The pair sorts descending where bit RQ of s is set
// (RQ >= 0: a direction known at compile time), else where desc is.
template <int R, int RQ, typename K, typename V, bool KV, bool TIE>
__device__ __forceinline__ void register_stage(K (&kk)[kSlots],
                                               V (&vv)[kSlots], bool desc) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (s & (1 << R)) continue;
    const bool d = RQ >= 0 ? ((s >> (RQ > 0 ? RQ : 0)) & 1) != 0 : desc;
    bool swapped;
    compare_exchange<K, V, KV, TIE>(kk[s], kk[s | (1 << R)], vv[s],
                                    vv[s | (1 << R)], !d, swapped);
  }
}

// The stage at register bit r with the direction of direction(): rq, the
// direction's register bit (always above r) or -1, and desc.
template <typename K, typename V, bool KV, bool TIE>
__device__ __forceinline__ void run_stage(int r, int rq, K (&kk)[kSlots],
                                          V (&vv)[kSlots], bool desc) {
#define AK_STAGE(R, RQ) \
  case R * 8 + RQ + 1: \
    register_stage<R, RQ, K, V, KV, TIE>(kk, vv, desc); \
    break;
  switch (r * 8 + rq + 1) {
    AK_STAGE(0, -1) AK_STAGE(0, 1) AK_STAGE(0, 2) AK_STAGE(0, 3)
    AK_STAGE(1, -1) AK_STAGE(1, 2) AK_STAGE(1, 3)
    AK_STAGE(2, -1) AK_STAGE(2, 3)
    AK_STAGE(3, -1)
  }
#undef AK_STAGE
}

// The stages at register bits TOP, TOP - 1, ..., 0, all with one
// direction for all of a thread's pairs (desc): a whole run within one
// phase, unrolled (no dispatch a stage).
template <int TOP, typename K, typename V, bool KV, bool TIE>
__device__ __forceinline__ void register_run(K (&kk)[kSlots],
                                             V (&vv)[kSlots], bool desc) {
  register_stage<TOP, -1, K, V, KV, TIE>(kk, vv, desc);
  if constexpr (TOP > 0) register_run<TOP - 1, K, V, KV, TIE>(kk, vv, desc);
}

template <typename K, typename V, bool KV, bool TIE>
__device__ __forceinline__ void run_down(int top, K (&kk)[kSlots],
                                         V (&vv)[kSlots], bool desc) {
  switch (top) {
    case 0: register_run<0, K, V, KV, TIE>(kk, vv, desc); break;
    case 1: register_run<1, K, V, KV, TIE>(kk, vv, desc); break;
    case 2: register_run<2, K, V, KV, TIE>(kk, vv, desc); break;
    default: register_run<3, K, V, KV, TIE>(kk, vv, desc); break;
  }
}

__host__ __device__ constexpr int lowest_bit(int s) {
  return (s & 1) ? 0 : 1 + lowest_bit(s >> 1);
}

// A virtual thread's keys (and payloads) to or from shared memory under the
// layout whose register bits have swizzled slots d, its thread bits at
// swizzled slot p. By linearity slot s sits at p XORed with d of each bit
// of s; the slots are visited in Gray-code order, so each next offset is
// the last one XORed with one d.
template <typename T, bool STORE>
__device__ __forceinline__ void shared_walk(unsigned char* base, int p,
                                            const int (&d)[kSlotBits],
                                            T (&r)[kSlots]) {
  int o = p * (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i) o ^= d[lowest_bit(i)] * (int)sizeof(T);
    T* a = reinterpret_cast<T*>(base + o);
    const int s = i ^ (i >> 1);
    if (STORE) *a = r[s];
    else r[s] = *a;
  }
}

template <typename K, typename V, bool KV, bool STORE>
__device__ __forceinline__ void shared_slots(unsigned char* sk,
                                             unsigned char* sv, int p,
                                             const int (&d)[kSlotBits],
                                             K (&kk)[kSlots],
                                             V (&vv)[kSlots]) {
  shared_walk<K, STORE>(sk, p, d, kk);
  if (KV) shared_walk<V, STORE>(sv, p, d, vv);
}

// The 16 consecutive elements at p (16-byte aligned) to or from registers,
// as 16-byte vectors.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         T (&r)[kSlots]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < kSlots / kPer; ++q) {
    const uint4 w = reinterpret_cast<const uint4*>(p)[q];
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < kPer; ++i) r[q * kPer + i] = e[i];
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const T (&r)[kSlots]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < kSlots / kPer; ++q) {
    uint4 w;
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int i = 0; i < kPer; ++i) e[i] = r[q * kPer + i];
    reinterpret_cast<uint4*>(p)[q] = w;
  }
}

// One CTA per block of 2^lb keys: every stage (k, j) for k = k_lo, 2 k_lo,
// ..., k_hi and j = min(k/2, block/2), ..., 1, in runs of register stages
// between shared-memory transposes (the note at the top of the file). vec:
// keys (and vals) are 16-byte aligned, so a run at c = 0 moves them to and
// from device memory as vectors.
template <typename K, typename V, bool KV, bool TIE>
__global__ void __launch_bounds__(kInblockThreads, kInblockCtasPerSm)
inblock_kernel(K* __restrict__ keys, V* __restrict__ vals, int lb,
               long long k_lo, long long k_hi, long long rmask, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int block = 1 << lb;
  unsigned char* sk = smem;
  unsigned char* sv = smem + (size_t)block * sizeof(K);
  const long long base = (long long)blockIdx.x << lb;
  K* gk = keys + base;
  V* gv = KV ? vals + base : nullptr;
  const int nvt = block >> kSlotBits;  // virtual threads of the block

  long long k = k_lo;
  int p = top_bit(k, lb);
  bool first = true;
  while (k <= k_hi) {
    // the run: stages (k, p) onwards while the stage bit is in [c, c + 4)
    const int c = p - kSlotBits + 1 > 0 ? p - kSlotBits + 1 : 0;
    long long k_end = k;
    int p_end = p, stages = 0;
    while (k_end <= k_hi && p_end >= c) {
      ++stages;
      if (p_end > 0) {
        --p_end;
      } else {
        k_end <<= 1;
        p_end = top_bit(k_end, lb);
        if (p_end >= c + kSlotBits) break;
      }
    }
    const bool last = k_end > k_hi;
    // swizzled slots of the register bits: slot s of a virtual thread is
    // at swz(its thread bits) ^ (XOR of d[r] over the bits r of s)
    int d[kSlotBits];
#pragma unroll
    for (int r = 0; r < kSlotBits; ++r) d[r] = swz(1 << (c + r));
    const int lowmask = (1 << c) - 1;

    for (int vt = threadIdx.x; vt < nvt; vt += blockDim.x) {
      const int tbits = ((vt >> c) << (c + kSlotBits)) | (vt & lowmask);
      const int pbase = swz(tbits);
      K kk[kSlots];
      V vv[kSlots];
      if (!first) {
        shared_slots<K, V, KV, false>(sk, sv, pbase, d, kk, vv);
      } else if (c == 0 && vec) {
        load_vec(gk + tbits, kk);
        if (KV) load_vec(gv + tbits, vv);
      } else {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          kk[s] = gk[tbits | (s << c)];
          if (KV) vv[s] = gv[tbits | (s << c)];
        }
      }

      long long kq = k;
      int pq = p;
      bool desc;
      int rq = direction(kq, rmask, base, lb, c, vt, desc);
      if (stages == p - c + 1 && rq < 0) {
        // the run is one phase's stages p .. c, one direction a thread
        run_down<K, V, KV, TIE>(p - c, kk, vv, desc);
      } else {
        for (int i = 0; i < stages; ++i) {
          run_stage<K, V, KV, TIE>(pq - c, rq, kk, vv, desc);
          if (pq > 0) {
            --pq;
          } else {
            kq <<= 1;
            pq = top_bit(kq, lb);
            rq = direction(kq, rmask, base, lb, c, vt, desc);
          }
        }
      }

      if (!last) {
        shared_slots<K, V, KV, true>(sk, sv, pbase, d, kk, vv);
      } else if (c == 0 && vec) {
        store_vec(gk + tbits, kk);
        if (KV) store_vec(gv + tbits, vv);
      } else {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          gk[tbits | (s << c)] = kk[s];
          if (KV) gv[tbits | (s << c)] = vv[s];
        }
      }
    }
    if (!last) __syncthreads();
    first = false;
    k = k_end;
    p = p_end;
  }
}

// ---------------------------------------------------------------------------
// The window kernel
// ---------------------------------------------------------------------------

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
  // bit t: member t moved (only moved members are stored)
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
int launch_inblock(void* keys, void* vals, long long total, int lb,
                   long long k_lo, long long k_hi, long long rmask,
                   cudaStream_t stream) {
  const long long block = 1ll << lb;
  const size_t smem = (size_t)block * (sizeof(K) + (KV ? sizeof(V) : 0));
  auto kern = inblock_kernel<K, V, KV, TIE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 128 threads a CTA where its shared memory lets seven CTAs share an SM
  // (keys alone at 8192), else 256 (three CTAs an SM with a 4-byte
  // payload): enough warps an SM either way, and small CTAs where many fit
  // (measured, PERF.md)
  const long long nvt = block >> kSlotBits;
  const long long cap = smem <= 32768 ? 128 : kInblockThreads;
  const int threads = (int)(nvt < cap ? nvt : cap);
  const int vec = ((reinterpret_cast<uintptr_t>(keys) |
                    reinterpret_cast<uintptr_t>(vals)) & 15) == 0;
  kern<<<(unsigned int)(total >> lb), threads, smem, stream>>>(
      static_cast<K*>(keys), static_cast<V*>(vals), lb, k_lo, k_hi, rmask,
      vec);
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
                     int lb, long long k_lo, long long k_hi,
                     long long rmask, cudaStream_t s) {
  if (vals == nullptr) return launch_inblock<K, int32_t, false, false>(keys, vals, total, lb, k_lo, k_hi, rmask, s);
  if (tie) return launch_inblock<K, V, true, true>(keys, vals, total, lb, k_lo, k_hi, rmask, s);
  return launch_inblock<K, V, true, false>(keys, vals, total, lb, k_lo, k_hi, rmask, s);
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
// rmask + 1 keys: every in-block stage of phases k_lo..k_hi (powers of two,
// 2 <= k_lo) on each block of `block` keys (a power of two in 2^9 ..
// 2^16 dividing total).
AK_EXPORT int ak_bitonic_inblock(void* keys, void* vals, int dtype,
                                 int vdtype, int tie_break, long long total,
                                 int block, long long k_lo, long long k_hi,
                                 long long rmask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block < 512 || block > 65536 || (block & (block - 1)) ||
      total % block || k_lo < 2 || (k_lo & (k_lo - 1)))
    return (int)cudaErrorInvalidValue;
  const int lb = __builtin_ctz((unsigned)block);
  return with_types(dtype, vdtype, vals != nullptr, [&](auto kt, auto vt) {
    typedef typename decltype(kt)::type K;
    typedef typename decltype(vt)::type V;
    return dispatch_inblock<K, V>(keys, vals, tie_break, total, lb, k_lo,
                                  k_hi, rmask, s);
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
