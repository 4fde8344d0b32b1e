// Paged decode attention for Hopper (sm_90a), split over keys
// (flash-decoding).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention, body _kernel): one query token per sequence attends over
// that sequence's block-table pages, GQA grouped as (KV, G, hd), optional
// tanh softcap, mask tpos < length, exact zeros for length-0 rows. There is
// no hd/KV padding: the TPU kernel padded to its (8, 128) tiles; here any
// hd <= 256 and any G <= 16 run as they are.
//
// Bound on an H100: bytes. Each live K/V row is read once, and the work per
// byte (about 2 G flops per bf16 element) is far below the card's ~295
// flops/byte balance point. A block per (sequence, kv head) walking its
// row's pages in order would keep only B * KV SMs busy (32 of 132 at
// qwen2-vl's B = 16, KV = 2) and take as long as the longest row's serial
// walk. So the grid is (B, KV, n_split): the host plans n_split page-aligned
// slices of the widest row the block table can hold (the lengths stay on
// the device), enough that B * KV * n_split reaches about two blocks per
// SM, each slice at least four 64-key tiles. Block (b, kvh, s) stages the
// table entries of its own slice in shared memory and walks the keys of
// the slice below the row's length; a slice that starts at or past the
// length writes an empty partial and exits. The walk (decode_split.cuh):
// the G heads form one 16-row mma.sync tile, each 64-key tile is split over
// the block's 4 warps, and K/V stream through a ring of RING = 3 cp.async
// buffers, so two tiles are in flight during a tile's math (on an H100 SXM
// at 700 W, B = 16, three ran ~6% faster than two; a 3-tile ring at hd 128
// is 104 KB, so two blocks still fit an SM). With n_split > 1 the
// blocks write f32 partial states (m, l, O) and a second small launch
// (combine_kernel) merges each row's slices into bf16; with n_split == 1
// the blocks write the output themselves. Head dims other than 64 and 128
// take the f32-FMA path of paged_attention_common.cuh over the same
// slices.
#include "decode_split.cuh"

namespace {

constexpr int RING = 3;     // depth of the tensor-core path's cp.async ring

// f32-FMA path (any hd <= 256)
constexpr int NT = 256;     // threads per block
constexpr int MAXR = 4;     // >= ceil(16 / (NT / TILE))
constexpr int MAXACC = 8;   // >= ceil(16 * 256 / 2 / NT)

__global__ void __launch_bounds__(NT)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ block_table,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                    pa::Geometry g, int n_split, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z;
  const int len = lengths[b];
  const int k_lo = s * chunk;
  const size_t row = (size_t)b * g.H * g.hd;
  float* rec = part == nullptr
                   ? nullptr
                   : part + ((size_t)(b * g.KV + kvh) * n_split + s) * g.G *
                                pa::split::record_floats(g.hd);
  pa::attend<NT, MAXR, MAXACC>(q + row, k_pages, v_pages,
                               block_table + (size_t)b * g.maxp, out + row, g,
                               kvh, /*q0=*/0, /*nq=*/1,
                               /*n_valid=*/len > 0 ? 1 : 0,
                               /*q_start=*/len - 1,
                               /*total=*/min(len, k_lo + chunk), smem, k_lo,
                               rec);
}

// Tensor-core path (hd 64 and 128): keys [s * chunk, min(len, (s + 1) *
// chunk)) of row b, kv head kvh.
template <int HD>
__global__ void __launch_bounds__(pa::split::NT)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_pages,
                   const __nv_bfloat16* __restrict__ v_pages,
                   const int* __restrict__ block_table,
                   const int* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                   pa::Geometry g, int n_split, int chunk, int tab_words) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z;
  const int len = min(lengths[b], g.maxp * g.page_size);
  const int k0 = s * chunk, k1 = min(len, k0 + chunk);
  const int p0 = k0 / g.page_size;
  int* tab = reinterpret_cast<int*>(smem);
  if (k1 > k0) {   // this slice's pages, staged once: one coalesced load
    const int n_tab = (k1 - 1) / g.page_size - p0 + 1;
    const int* trow = block_table + (size_t)b * g.maxp + p0;
    for (int i = threadIdx.x; i < n_tab; i += pa::split::NT)
      tab[i] = __ldg(trow + i);
  }
  __syncthreads();
  const pa::split::PagedRows kv{k_pages, v_pages, tab, p0, g.page_size,
                                g.KV * HD, kvh * HD};
  const size_t seq = (size_t)b * g.H * HD;
  float* rec = part == nullptr
                   ? nullptr
                   : part + ((size_t)(b * g.KV + kvh) * n_split + s) * g.G *
                                (HD + 2);
  pa::split::attend<HD, RING>(q + seq, out + seq, rec, kv,
                              pa::split::AllVisible{}, g.H, g.G, kvh, g.G,
                              k0, k1, -INFINITY, g.sm_scale, g.softcap,
                              smem + tab_words);
}

template <typename K>
cudaError_t launch(K kernel, int threads, size_t smem, int B, int n_split,
                   const pa::Geometry& g, cudaStream_t stream, const void* q,
                   const void* k_pages, const void* v_pages,
                   const void* block_table, const void* lengths, void* out,
                   void* part, int chunk) {
  cudaError_t err = pa::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, g.KV, n_split), threads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)block_table,
      (const int*)lengths, (__nv_bfloat16*)out, (float*)part, g, n_split,
      chunk);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(int B, int n_split, int chunk, const pa::Geometry& g,
                       cudaStream_t stream, const void* q,
                       const void* k_pages, const void* v_pages,
                       const void* block_table, const void* lengths,
                       void* out, void* part) {
  auto kernel = paged_split_kernel<HD>;
  const int tab_words = ((chunk + g.page_size - 1) / g.page_size + 1 + 3) & ~3;
  const size_t smem =
      (size_t)tab_words * 4 + pa::split::smem_bytes<HD, RING>();
  cudaError_t err = pa::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, g.KV, n_split), pa::split::NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)block_table,
      (const int*)lengths, (__nv_bfloat16*)out, (float*)part, g, n_split,
      chunk, tab_words);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, hd) bf16; k_pages/v_pages (P, page_size, KV, hd) bf16;
// block_table (B, maxp) int32; lengths (B,) int32; out (B, H, hd) bf16.
// The keys split into n_split slices of `chunk` keys (n_split * chunk >=
// maxp * page_size; chunk a multiple of page_size); with n_split > 1, part
// is f32 scratch of B * KV * n_split * H / KV records of (hd rounded up to
// even) + 2 floats. Launches on `stream` and returns cudaGetLastError() (0
// on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_table,
                                      const void* lengths, void* out,
                                      void* part, int B, int H, int KV,
                                      int hd, int page_size, int maxp,
                                      float softcap, int n_split, int chunk,
                                      void* stream) {
  if (pa::check_geometry(H, KV, hd, page_size, maxp) || B <= 0 ||
      n_split <= 0 || n_split > 65535 || chunk <= 0 ||
      chunk % page_size != 0 ||
      (long long)n_split * chunk < (long long)maxp * page_size ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const pa::Geometry g = pa::make_geometry(H, KV, hd, page_size, maxp, softcap);
  const cudaStream_t s = (cudaStream_t)stream;
  void* p = n_split > 1 ? part : nullptr;
  cudaError_t err;
  if (hd == 64)
    err = launch_mma<64>(B, n_split, chunk, g, s, q, k_pages, v_pages,
                         block_table, lengths, out, p);
  else if (hd == 128)
    err = launch_mma<128>(B, n_split, chunk, g, s, q, k_pages, v_pages,
                          block_table, lengths, out, p);
  else
    err = launch(paged_decode_kernel, NT, pa::smem_bytes(g.G, g), B, n_split,
                 g, s, q, k_pages, v_pages, block_table, lengths, out, p,
                 chunk);
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return (int)launch_combine((const float*)part, (__nv_bfloat16*)out, B, KV,
                             n_split, /*R=*/g.G, g.G, H, /*Sq=*/1, hd, s);
}
