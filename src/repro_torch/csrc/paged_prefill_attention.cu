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
// Bound on an H100: bf16 tensor-core operations (at the serving shapes,
// hd 128 and chunks of hundreds of queries, the QK^T and PV products do
// more operations per K/V byte than the card's balance point).
//
// For hd 64 and 128 the walk is prefill_wgmma.cuh's: a block owns up to
// 128 query rows of one (sequence, kv head) (BQ = 128 / G queries times
// the G heads that share the kv head, so each K/V byte staged serves all
// of them); two consumer warpgroups run wgmma on K/V tiles of 128 keys
// that a producer warpgroup copies with cp.async through the sequence's
// block-table row into a 3-tile ring (any page size; the mbarriers track
// the copies). The walk stops at the last key the tile's last real query
// can see, so a tile of early queries reads only the pages before it, and
// a tile of padding queries writes zeros and reads no page. The tiles
// late in each chunk (the longest walks) are launched first.
//
// Other head dims (any hd <= 256) take the f32-FMA path of
// paged_attention_common.cuh: one block per (sequence, kv head, tile of
// queries), a cp.async double buffer, the same stopping rule.
#include "prefill_wgmma.cuh"

namespace {

// f32-FMA path
constexpr int NT = 256;              // threads per block
constexpr int MAX_ROWS = 128;        // BQ * G
constexpr int MAX_ROW_ELEMS = 12288; // BQ * G * hdp
constexpr int MAXR = MAX_ROWS / (NT / pa::TILE);    // 32
constexpr int MAXACC = MAX_ROW_ELEMS / 2 / NT;      // 24

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

// K/V through the sequence's block-table row, copied by the producer
// warpgroup with cp.async into the swizzled tiles (each thread looks up a
// page once per page it copies from); Q likewise (padding queries as
// zeros).
template <int HD>
struct PagedSrc {
  static constexpr int LOADERS = 128;
  static constexpr bool GENERIC_WRITES = true;
  static constexpr bool FINITE_MASK = false;
  static constexpr int NV = HD / 8;   // 16-byte chunks of a row
  const __nv_bfloat16* q;             // the sequence's (Sq, H, HD) slab
  const __nv_bfloat16* k_pages;
  const __nv_bfloat16* v_pages;
  const int* table;                   // the sequence's block-table row
  __nv_bfloat16* out;                 // the sequence's output slab
  int H, KV, G, page, kvh, q0, n_valid, q_start;
  float sm_scale, softcap;
  int R, k0, n_tiles, k_end;

  // chunk c of row r lands at 16-byte slot (c % 8) ^ (r % 8) of the
  // row's 128 bytes in half c / 8: the 128-byte swizzle
  __device__ static uint32_t slot(int r, int c, int half_bytes) {
    return (c >> 3) * half_bytes + r * pa::wg::ROW_BYTES +
           (((c & 7) ^ (r & 7)) << 4);
  }
  __device__ void load_q(uint32_t dst, int q_half, int rows, uint32_t bar,
                         int ptid) const {
    for (int idx = ptid; idx < rows * NV; idx += 128) {
      const int r = idx / NV, c = idx - r * NV;
      const int qi = r / G, gi = r - qi * G;
      const bool ok = r < R && q0 + qi < n_valid;
      const __nv_bfloat16* src =
          ok ? q + ((size_t)(q0 + qi) * H + kvh * G + gi) * HD + c * 8 : q;
      pa::wg::cp_async16(dst + slot(r, c, q_half), src, ok);
    }
    pa::wg::cp_async_arrive(bar);
  }
  __device__ void load_kv(int t0, uint32_t k_dst, uint32_t v_dst,
                          uint32_t bar, int ptid) const {
    // this thread's chunk c of rows t, t + STEP, ...: the row's place in
    // its page steps on (one division a tile)
    constexpr int STEP = 128 / NV;
    const int c = ptid % NV;
    int t = ptid / NV;
    int tpos = t0 + t;
    int pi = tpos / page, in_page = tpos - pi * page;
    const uint32_t swz = (c >> 3) * (pa::wg::KN * pa::wg::ROW_BYTES) +
                         (((c & 7) ^ (t & 7)) << 4);   // t & 7 is fixed
#pragma unroll 4
    for (; t < pa::wg::KN; t += STEP, tpos += STEP) {
      const bool ok = tpos < k_end;   // zeros past the walk: P is 0 there
      const size_t row =
          ok ? ((size_t)__ldg(table + pi) * page + in_page) * KV + kvh : 0;
      const uint32_t off = swz + t * pa::wg::ROW_BYTES;
      pa::wg::cp_async16(k_dst + off, k_pages + row * HD + c * 8, ok);
      pa::wg::cp_async16(v_dst + off, v_pages + row * HD + c * 8, ok);
      for (in_page += STEP; in_page >= page; in_page -= page) ++pi;
    }
    pa::wg::cp_async_arrive(bar);
  }
  __device__ void finish(int) const {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __device__ bool row_ok(int r) const { return q0 + r / G < n_valid; }
  __device__ int qpos(int r) const { return q_start + q0 + r / G; }
  __device__ bool sees(int tpos, int qpos) const { return tpos <= qpos; }
  __device__ bool tile_clear(int t0, int n) const {
    return t0 + n <= k_end && t0 + n - 1 <= q_start + q0;
  }
  __device__ __nv_bfloat16* out_row(int r) const {
    return out + ((size_t)(q0 + r / G) * H + kvh * G + r % G) * HD;
  }
};

template <int HD>
__global__ void __launch_bounds__(pa::wg::THREADS, 1)
paged_prefill_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k_pages,
                           const __nv_bfloat16* __restrict__ v_pages,
                           const int* __restrict__ block_table,
                           const int* __restrict__ q_start,
                           const int* __restrict__ new_lens,
                           __nv_bfloat16* __restrict__ out, pa::Geometry g,
                           int B, int Sq, int BQ, int n_qt) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  int qt, b, kvh;
  pa::wg::block_coords(n_qt, B, g.KV, qt, b, kvh);
  const int q0 = qt * BQ;
  const int nq = min(BQ, Sq - q0);
  const int qs = q_start[b], nl = new_lens[b];
  const int G = g.G, R = nq * G;
  const size_t slab = (size_t)b * Sq * g.H * HD;
  const int last_q = min(q0 + nq, nl) - 1;   // last real query of the tile
  if (last_q < q0) {
    // every query of the tile is padding (or the row is empty): zeros
    for (int idx = threadIdx.x; idx < R * HD / 2; idx += blockDim.x) {
      const int r = idx / (HD / 2), d = 2 * (idx - r * (HD / 2));
      pa::store_pair(out + slab + ((size_t)(q0 + r / G) * g.H + kvh * G +
                                   r % G) * HD,
                     d, HD, 0.0f, 0.0f);
    }
    return;
  }
  // keys this tile can see: up to its last real query's position
  const int kv_end = min(min(qs + nl, qs + last_q + 1), g.maxp * g.page_size);
  uint8_t* base = pa::wg::align1024(smem_raw);
  PagedSrc<HD> src;
  src.q = q + slab;
  src.k_pages = k_pages;
  src.v_pages = v_pages;
  src.table = block_table + (size_t)b * g.maxp;
  src.out = out + slab;
  src.H = g.H;
  src.KV = g.KV;
  src.G = G;
  src.page = g.page_size;
  src.kvh = kvh;
  src.q0 = q0;
  src.n_valid = nl;
  src.q_start = qs;
  src.sm_scale = g.sm_scale;
  src.softcap = g.softcap;
  src.R = R;
  src.k0 = 0;
  src.n_tiles = (kv_end + pa::wg::KN - 1) / pa::wg::KN;
  src.k_end = kv_end;
  pa::wg::attend<HD>(src, base);
}

template <int HD>
cudaError_t launch_wgmma(const pa::Geometry& g, int B, int Sq, int BQ,
                         int n_qt, cudaStream_t stream, const void* q,
                         const void* k_pages, const void* v_pages,
                         const void* block_table, const void* q_start,
                         const void* new_lens, void* out) {
  auto kernel = paged_prefill_wgmma_kernel<HD>;
  const size_t smem = pa::wg::Smem<HD>::bytes();
  cudaError_t err = pa::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)n_qt * B * g.KV),
           pa::wg::THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)block_table,
      (const int*)q_start, (const int*)new_lens, (__nv_bfloat16*)out, g, B,
      Sq, BQ, n_qt);
  return cudaGetLastError();
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
// out (B, Sq, H, hd) bf16. BQ and n_qt are the host's tile plan for the
// tensor-core path (hd 64 and 128; kernels/tiles.py): BQ queries a block,
// BQ * G <= 128 rows, n_qt tiles covering Sq. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int paged_prefill_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* q_start, const void* new_lens,
    void* out, int B, int Sq, int H, int KV, int hd, int page_size, int maxp,
    int BQ, int n_qt, float softcap, void* stream) {
  if (pa::check_geometry(H, KV, hd, page_size, maxp) || B <= 0 || Sq <= 0)
    return (int)cudaErrorInvalidValue;
  const pa::Geometry g = pa::make_geometry(H, KV, hd, page_size, maxp, softcap);
  const cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64 || hd == 128) {
    if (!pa::wg::plan_ok(Sq, g.G, BQ, n_qt) ||
        (long long)n_qt * B * KV > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const auto f = hd == 64 ? launch_wgmma<64> : launch_wgmma<128>;
    return (int)f(g, B, Sq, BQ, n_qt, s, q, k_pages, v_pages, block_table,
                  q_start, new_lens, out);
  }
  const int fq = min(fma_block_queries(g.G, hd), Sq);
  return (int)launch(paged_prefill_kernel, NT, pa::smem_bytes(fq * g.G, g),
                     fq, B, g, Sq, s, q, k_pages, v_pages, block_table,
                     q_start, new_lens, out);
}
