// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention, body _kernel): one query token per sequence attends over
// that sequence's block-table pages, GQA grouped as (KV, G, hd), optional
// tanh softcap, mask tpos < length, exact zeros for length-0 rows.
//
// One thread block per (sequence, kv head) holds that kv head's G query
// heads in shared memory and walks the sequence's ceil(length / page) pages
// through its own block-table row (no scalar prefetch), keeping the online
// softmax in f32 (paged_attention_common.cuh). There is no hd/KV padding:
// the TPU kernel padded to its (8, 128) tiles; here any hd <= 256 and any
// G <= 16 run as they are.
//
// Bound on an H100: bytes. Each live K/V row is read once, and the work per
// byte (about 2 G flops per bf16 element) is far below the card's ~295
// flops/byte balance point. What the design does about it: K/V rows stream
// in 16-byte cp.async copies, double-buffered so the next tile is in flight
// during this tile's math; each byte of K/V is touched by one block only;
// steps past the last live page are never issued; the output is written
// once. For hd 64 and 128 the G heads form one 16-row tensor-core tile
// (mma.sync, paged_attention_mma.cuh) and each tile's 64 keys split over
// the block's 4 warps, whose partial softmax states merge at the end, so
// the per-tile latency chain is short; other head dims take the f32-FMA
// path. Not yet done: splitting the page axis over blocks
// (flash-decoding), without which a small batch keeps only B * KV SMs
// busy.
#include "paged_attention_mma.cuh"

namespace {

// f32-FMA path (any hd <= 256)
constexpr int NT = 256;     // threads per block
constexpr int MAXR = 4;     // >= ceil(16 / (NT / TILE))
constexpr int MAXACC = 8;   // >= ceil(16 * 256 / 2 / NT)

// tensor-core path (hd 64 and 128): one 16-key slice of each tile per warp
constexpr int MMA_WARPS = pa::TILE / 16;

__global__ void __launch_bounds__(NT)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ block_table,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, pa::Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int len = lengths[b];
  const size_t row = (size_t)b * g.H * g.hd;
  pa::attend<NT, MAXR, MAXACC>(q + row, k_pages, v_pages,
                               block_table + (size_t)b * g.maxp, out + row, g,
                               kvh, /*q0=*/0, /*nq=*/1,
                               /*n_valid=*/len > 0 ? 1 : 0,
                               /*q_start=*/len - 1, /*total=*/len, smem);
}

template <int HD>
__global__ void __launch_bounds__(MMA_WARPS * 32)
paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pages,
                        const __nv_bfloat16* __restrict__ v_pages,
                        const int* __restrict__ block_table,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, pa::Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const size_t row = (size_t)b * g.H * HD;
  pa::attend_mma_decode<HD, MMA_WARPS>(q + row, k_pages, v_pages,
                                       block_table + (size_t)b * g.maxp,
                                       out + row, g, kvh, lengths[b], smem);
}

template <typename K>
cudaError_t launch(K kernel, int threads, size_t smem, int B,
                   const pa::Geometry& g, cudaStream_t stream, const void* q,
                   const void* k_pages, const void* v_pages,
                   const void* block_table, const void* lengths, void* out) {
  cudaError_t err = pa::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, g.KV), threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)block_table,
      (const int*)lengths, (__nv_bfloat16*)out, g);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, hd) bf16; k_pages/v_pages (P, page_size, KV, hd) bf16;
// block_table (B, maxp) int32; lengths (B,) int32; out (B, H, hd) bf16.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_table,
                                      const void* lengths, void* out, int B,
                                      int H, int KV, int hd, int page_size,
                                      int maxp, float softcap, void* stream) {
  if (pa::check_geometry(H, KV, hd, page_size, maxp) || B <= 0)
    return (int)cudaErrorInvalidValue;
  const pa::Geometry g = pa::make_geometry(H, KV, hd, page_size, maxp, softcap);
  const cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64 || hd == 128) {
    auto kernel = hd == 64 ? paged_decode_mma_kernel<64>
                           : paged_decode_mma_kernel<128>;
    return (int)launch(kernel, MMA_WARPS * 32,
                       pa::mma_decode_smem_bytes(g, hd, MMA_WARPS), B, g, s,
                       q, k_pages, v_pages, block_table, lengths, out);
  }
  return (int)launch(paged_decode_kernel, NT, pa::smem_bytes(g.G, g), B, g, s,
                     q, k_pages, v_pages, block_table, lengths, out);
}
