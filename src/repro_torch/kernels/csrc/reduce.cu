// mapreduce / reduce for Hopper (sm_90a): a body from the catalogue
// folded under an operator from the catalogue, in one launch.
//
// Replaces repro/kernels/reduce_kernel.py: reduce_blocks (_reduce_body).
// The TPU kernel relied on its grid running in order and carried an
// (8, 128) accumulator in VMEM from step to step. CTAs here run in no
// order, so the reduction has two levels inside the same launch: each CTA
// folds its grid-stride share in registers (a fixed per-thread order), then
// across its warps with shuffles and shared memory, and writes one partial;
// the last CTA to finish (a ticket taken after __threadfence, as hist.cu
// does) folds the partials in index order and applies init once:
// out = op(init, fold(body(x))). The grid depends on n alone, so the order
// of every operation, and the result, is the same from run to run.
//
// Bound: bytes -- one read of every operand; the partials are a few KiB.

#include "ak_stream.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

// Fold of a CTA's values into thread 0: warps by shuffles, then warp 0
// over the warps' results (a fixed tree: deterministic).
template <int OP, typename A>
__device__ A block_fold(A v, A* sh, A ident) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = ak_warp_fold<OP>(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) v = ak_warp_fold<OP>(lane < kWarps ? sh[lane] : ident);
  __syncthreads();
  return v;
}

template <int BODY, typename T, typename Out, int OP>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(AkOperands ops, long long n, AkParams prm, double ident_d,
              double init_d, typename AkAcc<Out>::type* partials,
              unsigned int* ticket, Out* __restrict__ out) {
  typedef typename AkAcc<Out>::type A;
  __shared__ A sh[kWarps];
  __shared__ bool is_last;
  const A ident = ak_from_double<A>(ident_d);
  A acc = ident;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = AkBodyF<BODY>::template apply<T>(ops, i + u * stride, prm);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      acc = AkOpF<OP>::apply(acc, ak_cast<A, Out>(ak_cast<Out, T>(v[u])));
  }
  for (; i < n; i += stride)
    acc = AkOpF<OP>::apply(acc, ak_cast<A, Out>(ak_cast<Out, T>(
        AkBodyF<BODY>::template apply<T>(ops, i, prm))));
  acc = block_fold<OP>(acc, sh, ident);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // Last CTA: every partial is visible (fence + ticket). Fold them with the
  // same fixed tree: thread t takes partials t, t + kThreads, ... in order.
  volatile A* vp = partials;
  acc = ident;
  for (unsigned int k = threadIdx.x; k < gridDim.x; k += blockDim.x)
    acc = AkOpF<OP>::apply(acc, (A)vp[k]);
  acc = block_fold<OP>(acc, sh, ident);
  if (threadIdx.x == 0) {
    const A init = ak_cast<A, Out>(ak_cast<Out, A>(ak_from_double<A>(init_d)));
    out[0] = ak_cast<Out, A>(AkOpF<OP>::apply(init, acc));
    *ticket = 0;  // every CTA has taken its ticket: ready for the next call
  }
}

template <int OP, int BODY, typename T, typename Out>
int launch(const AkOperands& ops, long long n, const AkParams& prm,
           double ident, double init, void* partials, void* ticket, int grid,
           void* out, cudaStream_t s) {
  typedef typename AkAcc<Out>::type A;
  reduce_kernel<BODY, T, Out, OP><<<grid, kThreads, 0, s>>>(
      ops, n, prm, ident, init, static_cast<A*>(partials),
      static_cast<unsigned int*>(ticket), static_cast<Out*>(out));
  return (int)cudaGetLastError();
}

// ak_with_body, plus int8 operands through the identity and square bodies.
template <typename F>
int with_operand(int body, int dtype, F&& f) {
  if (dtype == AK_I8) {
    if (body == AK_IDENTITY) return f(AkBodyTag<AK_IDENTITY>{}, AkTypeTag<int8_t>{});
    if (body == AK_SQUARE) return f(AkBodyTag<AK_SQUARE>{}, AkTypeTag<int8_t>{});
    return (int)cudaErrorInvalidValue;
  }
  return ak_with_body(body, dtype, f);
}

}  // namespace

// out[0] = op(init, fold_op(body(operands))). For add/mul/min/max
// out_dtype is any of float32, int32 and bfloat16: each body value (in the
// operands' type) is cast to it and folded in AkAcc<out>, as the
// reference's reduce_ref does (it folds a bfloat16 output in bfloat16);
// and/or fold into AK_BOOL.
// partials holds grid accumulators (4 bytes each); *ticket must be 0 on
// entry, and is 0 again when the kernel ends, so one ticket serves every
// call on a stream.
AK_EXPORT int ak_reduce(const void* a0, const void* a1, const void* a2,
                        const void* a3, const void* a4, const void* a5,
                        int body, int dtype, int out_dtype, int op,
                        long long n, float p0, float p1, float p2, float p3,
                        float p4, float p5, double ident, double init,
                        void* partials, void* ticket, int grid, void* out,
                        void* stream) {
  const AkOperands ops = {{a0, a1, a2, a3, a4, a5}};
  const AkParams prm = {{p0, p1, p2, p3, p4, p5}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_operand(body, dtype, [&](auto bt, auto tt) {
    constexpr int B = decltype(bt)::value;
    typedef typename decltype(tt)::type T;
    if (out_dtype == AK_BOOL) {
      // and/or read the bodies' own dtypes only (no int8 instantiation)
      if constexpr (!std::is_same<T, int8_t>::value) {
        switch (op) {
          case AK_AND: return launch<AK_AND, B, T, bool>(ops, n, prm, ident, init, partials, ticket, grid, out, s);
          case AK_OR: return launch<AK_OR, B, T, bool>(ops, n, prm, ident, init, partials, ticket, grid, out, s);
        }
      }
      return (int)cudaErrorInvalidValue;
    }
    return ak_with_type(out_dtype, [&](auto ot) {
      typedef typename decltype(ot)::type Out;
      switch (op) {
        case AK_ADD: return launch<AK_ADD, B, T, Out>(ops, n, prm, ident, init, partials, ticket, grid, out, s);
        case AK_MUL: return launch<AK_MUL, B, T, Out>(ops, n, prm, ident, init, partials, ticket, grid, out, s);
        case AK_MIN: return launch<AK_MIN, B, T, Out>(ops, n, prm, ident, init, partials, ticket, grid, out, s);
        case AK_MAX: return launch<AK_MAX, B, T, Out>(ops, n, prm, ident, init, partials, ticket, grid, out, s);
      }
      return (int)cudaErrorInvalidValue;
    });
  });
}

// Elements one CTA takes per grid-stride step (threads x unroll).
AK_EXPORT int ak_reduce_cta_elems() { return kThreads * kUnroll; }
