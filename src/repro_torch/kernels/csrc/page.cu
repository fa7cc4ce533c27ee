// Paged KV-cache gather for Hopper (sm_90a).
//
// Replaces repro/kernels/page_kernel.py: page_gather_blocks / _gather_body.
// On the TPU the block table was a scalar-prefetch operand whose index_map
// chose the page each grid step DMAs into VMEM. Here one CTA per (b, t)
// table slot reads its page id itself and copies the whole page
// pages[table[b, t]] (page_bytes bytes) to out[b, t], neighbouring threads
// on neighbouring 16-byte chunks (uint4 loads and stores), or narrower
// chunks when the page size is not a multiple of 16 bytes.
//
// Bound: bytes. Every output byte is written once and every gathered page
// byte read once; there is no arithmetic. A table entry outside [0, P) is
// not a page: the CTA writes zeros there instead of reading out of bounds
// (callers clamp or mask such entries first, as the serving engine does).

#include "ak_common.cuh"

namespace {

template <typename W>
__global__ void page_gather_kernel(const W* __restrict__ pages,
                                   const int32_t* __restrict__ table,
                                   W* __restrict__ out, long long num_pages,
                                   long long chunks) {
  const long long slot = blockIdx.x;  // b * T + t
  const long long pid = table[slot];
  W* dst = out + slot * chunks;
  if (pid < 0 || pid >= num_pages) {
    for (long long c = threadIdx.x; c < chunks; c += blockDim.x) dst[c] = W{};
    return;
  }
  const W* src = pages + pid * chunks;
  for (long long c = threadIdx.x; c < chunks; c += blockDim.x) dst[c] = src[c];
}

template <typename W>
int launch(const void* pages, const int32_t* table, void* out,
           long long num_pages, long long slots, long long page_bytes,
           cudaStream_t stream) {
  const long long chunks = page_bytes / (long long)sizeof(W);
  const int threads = chunks >= 256 ? 256 : (int)((chunks + 31) / 32 * 32);
  page_gather_kernel<W><<<(unsigned int)slots, threads, 0, stream>>>(
      static_cast<const W*>(pages), table, static_cast<W*>(out), num_pages,
      chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// pages: num_pages pages of page_bytes bytes each; table: slots int32 page
// ids; out: slots pages. All three contiguous.
AK_EXPORT int ak_page_gather(const void* pages, const void* table, void* out,
                             long long num_pages, long long slots,
                             long long page_bytes, void* stream) {
  if (slots <= 0 || page_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(table);
  if (page_bytes % 16 == 0) return launch<uint4>(pages, t, out, num_pages, slots, page_bytes, s);
  if (page_bytes % 8 == 0) return launch<uint2>(pages, t, out, num_pages, slots, page_bytes, s);
  if (page_bytes % 4 == 0) return launch<uint32_t>(pages, t, out, num_pages, slots, page_bytes, s);
  if (page_bytes % 2 == 0) return launch<uint16_t>(pages, t, out, num_pages, slots, page_bytes, s);
  return launch<uint8_t>(pages, t, out, num_pages, slots, page_bytes, s);
}
