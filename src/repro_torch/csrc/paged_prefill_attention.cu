// Paged chunked-prefill flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_prefill_attention.py
// (paged_prefill_attention, body _kernel): each sequence's right-padded chunk
// of Sq queries, at global positions q_start[b] .. q_start[b] + new_lens[b],
// attends causally over that sequence's block-table pages (which already
// hold the chunk's own K/V) under the mask tpos <= qpos && tpos < total;
// GQA; optional tanh softcap; padding queries and padding rows are exact
// zeros.
//
// One thread block per (sequence, kv head, tile of BQ queries): its BQ * G
// query rows (the G heads that share the kv head) attend together, so each
// K/V byte a block reads serves all of them, while the block walks the
// sequence's keys through its own staged block-table row. The walk stops
// at the last key the tile's last real query can see, so a tile of early
// queries reads only the pages before it, and a tile of padding queries
// reads none.
//
// Bound on an H100: at the serving shapes (hd 128, chunks of hundreds of
// queries) the QK^T and PV products do more operations per K/V byte than the
// card's balance point, so the bound is bf16 tensor-core operations. For
// hd 64 and 128 the products run on the tensor cores (mma.sync m16n8k16,
// paged_attention_mma.cuh: 4 warps x 16 rows, BQ = 64 / G queries); the
// next tile's K/V stream in by cp.async during this tile's math. Other head
// dims (any hd <= 256) take the f32-FMA path of paged_attention_common.cuh.
// Not yet: wgmma and TMA, and keeping more than one tile in flight.
#include "paged_attention_mma.cuh"

namespace {

// f32-FMA path
constexpr int NT = 256;              // threads per block
constexpr int MAX_ROWS = 128;        // BQ * G
constexpr int MAX_ROW_ELEMS = 12288; // BQ * G * hdp
constexpr int MAXR = MAX_ROWS / (NT / pa::TILE);    // 32
constexpr int MAXACC = MAX_ROW_ELEMS / 2 / NT;      // 24

// tensor-core path
constexpr int MMA_WARPS = 4;
constexpr int MMA_ROWS = 16 * MMA_WARPS;

__global__ void __launch_bounds__(NT)
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k_pages,
                     const __nv_bfloat16* __restrict__ v_pages,
                     const int* __restrict__ block_table,
                     const int* __restrict__ q_start,
                     const int* __restrict__ new_lens,
                     __nv_bfloat16* __restrict__ out, pa::Geometry g, int Sq,
                     int BQ) {
  extern __shared__ __align__(16) float smem[];
  const int qt = blockIdx.x, b = blockIdx.y, kvh = blockIdx.z;
  const int q0 = qt * BQ;
  const int nq = min(BQ, Sq - q0);
  const int qs = q_start[b];
  const int nl = new_lens[b];
  const size_t row = (size_t)b * Sq * g.H * g.hd;
  pa::attend<NT, MAXR, MAXACC>(q + row, k_pages, v_pages,
                               block_table + (size_t)b * g.maxp, out + row, g,
                               kvh, q0, nq, /*n_valid=*/nl, /*q_start=*/qs,
                               /*total=*/qs + nl, smem);
}

template <int HD>
__global__ void __launch_bounds__(MMA_WARPS * 32)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_pages,
                         const __nv_bfloat16* __restrict__ v_pages,
                         const int* __restrict__ block_table,
                         const int* __restrict__ q_start,
                         const int* __restrict__ new_lens,
                         __nv_bfloat16* __restrict__ out, pa::Geometry g,
                         int Sq, int BQ) {
  extern __shared__ __align__(16) float smem[];
  const int qt = blockIdx.x, b = blockIdx.y, kvh = blockIdx.z;
  const int q0 = qt * BQ;
  const int nq = min(BQ, Sq - q0);
  const int qs = q_start[b];
  const int nl = new_lens[b];
  const size_t row = (size_t)b * Sq * g.H * HD;
  pa::attend_mma<HD, MMA_WARPS>(q + row, k_pages, v_pages,
                                block_table + (size_t)b * g.maxp, out + row,
                                g, kvh, q0, nq, /*n_valid=*/nl,
                                /*q_start=*/qs, /*total=*/qs + nl, smem);
}

// Queries per block of the FMA path: the (BQ * G, hd) f32 accumulator
// fits the block's registers.
int fma_block_queries(int G, int hd) {
  const int hdp = (hd + 1) & ~1;
  int bq = MAX_ROW_ELEMS / (G * hdp);
  bq = min(bq, MAX_ROWS / G);
  bq = min(bq, 64);
  return max(bq, 1);
}

template <typename K>
cudaError_t launch(K kernel, int threads, size_t smem, int BQ, int B,
                   const pa::Geometry& g, int Sq, cudaStream_t stream,
                   const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* q_start,
                   const void* new_lens, void* out) {
  cudaError_t err = pa::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B, g.KV);
  kernel<<<grid, threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)block_table,
      (const int*)q_start, (const int*)new_lens, (__nv_bfloat16*)out, g, Sq,
      BQ);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd) bf16; k_pages/v_pages (P, page_size, KV, hd) bf16;
// block_table (B, maxp) int32; q_start/new_lens (B,) int32;
// out (B, Sq, H, hd) bf16. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* q_start, const void* new_lens,
    void* out, int B, int Sq, int H, int KV, int hd, int page_size, int maxp,
    float softcap, void* stream) {
  if (pa::check_geometry(H, KV, hd, page_size, maxp) || B <= 0 || Sq <= 0)
    return (int)cudaErrorInvalidValue;
  const pa::Geometry g = pa::make_geometry(H, KV, hd, page_size, maxp, softcap);
  const cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64 || hd == 128) {
    const int BQ = min(MMA_ROWS / g.G, Sq);
    const size_t smem = pa::mma_smem_bytes(g);
    auto kernel = hd == 64 ? paged_prefill_mma_kernel<64>
                           : paged_prefill_mma_kernel<128>;
    return (int)launch(kernel, MMA_WARPS * 32, smem, BQ, B, g, Sq, s, q,
                       k_pages, v_pages, block_table, q_start, new_lens, out);
  }
  const int BQ = min(fma_block_queries(g.G, hd), Sq);
  return (int)launch(paged_prefill_kernel, NT, pa::smem_bytes(BQ * g.G, g),
                     BQ, B, g, Sq, s, q, k_pages, v_pages, block_table,
                     q_start, new_lens, out);
}
