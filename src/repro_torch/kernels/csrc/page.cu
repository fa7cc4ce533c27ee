// Paged KV-cache gather for Hopper (sm_90a).
//
// Replaces repro/kernels/page_kernel.py: page_gather_blocks / _gather_body.
// On the TPU the block table was a scalar-prefetch operand whose index_map
// chose the page each grid step DMAs into VMEM. Here the grid is (slot,
// pool): one CTA per (b, t) table slot and per pool of a K/V pair that
// shares the table, so a layer's K and V come in one launch. A CTA reads
// its page id itself and copies the whole page pools[pool][table[b, t]]
// (page_bytes bytes) to out[pool, b, t], neighbouring threads on
// neighbouring 16-byte chunks (uint4), or narrower chunks when the page
// size or a base address is not a multiple of 16 bytes.
//
// Bound: bytes. Every output byte is written once and every gathered page
// byte read once; there is no arithmetic. A decode step's pages (16 KiB,
// 8 x 40 slots) are small, so a CTA lives for one round trip: each thread
// starts UNROLL loads before its first store, which keeps UNROLL x 16
// bytes a thread in flight (a 16 KiB page in one pass of 256 threads).
// A table entry outside [0, P) is not a page: the CTA writes zeros there
// instead of reading out of bounds (callers clamp or mask such entries
// first, as the serving engine does).

#include "ak_common.cuh"

namespace {

constexpr int UNROLL = 4;

template <typename W>
__global__ void __launch_bounds__(256)
page_gather_kernel(const W* __restrict__ pool0, const W* __restrict__ pool1,
                   const int32_t* __restrict__ table, W* __restrict__ out,
                   long long num_pages, long long slots, long long chunks) {
  const long long slot = blockIdx.x;  // b * T + t
  const int pool = blockIdx.y;
  const long long pid = table[slot];
  W* dst = out + ((long long)pool * slots + slot) * chunks;
  if (pid < 0 || pid >= num_pages) {
    for (long long c = threadIdx.x; c < chunks; c += blockDim.x) dst[c] = W{};
    return;
  }
  const W* src = (pool ? pool1 : pool0) + pid * chunks;
  const long long step = (long long)UNROLL * blockDim.x;
  for (long long c0 = threadIdx.x; c0 < chunks; c0 += step) {
    W r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long c = c0 + (long long)u * blockDim.x;
      if (c < chunks) r[u] = src[c];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long c = c0 + (long long)u * blockDim.x;
      if (c < chunks) dst[c] = r[u];
    }
  }
}

template <typename W>
int launch(const void* pool0, const void* pool1, int npools,
           const int32_t* table, void* out, long long num_pages,
           long long slots, long long page_bytes, cudaStream_t stream) {
  const long long chunks = page_bytes / (long long)sizeof(W);
  const long long per_thread = (chunks + UNROLL - 1) / UNROLL;
  const int threads =
      per_thread >= 256 ? 256 : (int)((per_thread + 31) / 32 * 32);
  const dim3 grid((unsigned int)slots, (unsigned int)npools);
  page_gather_kernel<W><<<grid, threads, 0, stream>>>(
      static_cast<const W*>(pool0), static_cast<const W*>(pool1), table,
      static_cast<W*>(out), num_pages, slots, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// pool0, pool1: npools (1 or 2) pools of num_pages pages of page_bytes
// bytes each (pool1 unread when npools is 1); table: slots int32 page ids;
// out: npools x slots pages. All contiguous.
AK_EXPORT int ak_page_gather(const void* pool0, const void* pool1,
                             int npools, const void* table, void* out,
                             long long num_pages, long long slots,
                             long long page_bytes, void* stream) {
  if (slots <= 0 || page_bytes <= 0) return 0;
  if (npools < 1 || npools > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* t = static_cast<const int32_t*>(table);
  // the widest chunk that divides the page and every base address
  const unsigned long long a = (unsigned long long)page_bytes |
      (unsigned long long)pool0 | (unsigned long long)out |
      (npools > 1 ? (unsigned long long)pool1 : 0ull);
  if (a % 16 == 0)
    return launch<uint4>(pool0, pool1, npools, t, out, num_pages, slots, page_bytes, s);
  if (a % 8 == 0)
    return launch<uint2>(pool0, pool1, npools, t, out, num_pages, slots, page_bytes, s);
  if (a % 4 == 0)
    return launch<uint32_t>(pool0, pool1, npools, t, out, num_pages, slots, page_bytes, s);
  if (a % 2 == 0)
    return launch<uint16_t>(pool0, pool1, npools, t, out, num_pages, slots, page_bytes, s);
  return launch<uint8_t>(pool0, pool1, npools, t, out, num_pages, slots, page_bytes, s);
}
