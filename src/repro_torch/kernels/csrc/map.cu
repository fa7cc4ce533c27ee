// foreachindex / map_elements for Hopper (sm_90a): an elementwise body over
// up to six same-shape operands.
//
// Replaces repro/kernels/map_kernel.py: map_blocks (_map_body). The TPU
// kernel walked (8, 1024) VMEM blocks in order and applied a traced
// closure to whole vector registers; here one grid-stride kernel applies a
// body from the catalogue (ak_stream.cuh) to one element per thread and
// iteration, four iterations in flight per thread so that each thread
// keeps several loads outstanding.
//
// Bound: bytes. Every operand is read once and the output written once
// (RBF: 3 reads + 1 write of 4 bytes per point; LJG: 6 + 1); the bodies do
// 10-25 float operations per point, far under the card's rate.

#include "ak_stream.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <int BODY, typename T, typename Out>
__global__ void __launch_bounds__(kThreads)
map_kernel(AkOperands ops, long long n, AkParams prm, Out* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = AkBodyF<BODY>::template apply<T>(ops, i + u * stride, prm);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      out[i + u * stride] = ak_cast<Out, T>(v[u]);
  }
  for (; i < n; i += stride)
    out[i] = ak_cast<Out, T>(AkBodyF<BODY>::template apply<T>(ops, i, prm));
}

}  // namespace

// out[i] = body(operands)[i] for i < n, converted to out_dtype; grid CTAs,
// grid-stride.
AK_EXPORT int ak_map(const void* a0, const void* a1, const void* a2,
                     const void* a3, const void* a4, const void* a5,
                     int body, int dtype, int out_dtype, long long n,
                     float p0, float p1, float p2, float p3, float p4,
                     float p5, int grid, void* out, void* stream) {
  const AkOperands ops = {{a0, a1, a2, a3, a4, a5}};
  const AkParams prm = {{p0, p1, p2, p3, p4, p5}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ak_with_body(body, dtype, [&](auto bt, auto tt) {
    constexpr int B = decltype(bt)::value;
    typedef typename decltype(tt)::type T;
    return ak_with_type(out_dtype, [&](auto ot) {
      typedef typename decltype(ot)::type Out;
      map_kernel<B, T, Out><<<grid, kThreads, 0, s>>>(
          ops, n, prm, static_cast<Out*>(out));
      return (int)cudaGetLastError();
    });
  });
}

// Elements one CTA takes per grid-stride step (threads x unroll).
AK_EXPORT int ak_map_cta_elems() { return kThreads * kUnroll; }
