// Dense chunked-prefill flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/prefill_attention.py
// (prefill_attention, body _kernel): a chunk of Sq queries at global
// positions q_start .. q_start + Sq - 1 attends over contiguous K/V rows
// 0 .. n_keys - 1 under the mask kpos <= qpos and, with a sliding window W,
// kpos > qpos - W; GQA (query head h reads kv head h / G, no repeat);
// optional tanh softcap; f32 online softmax. Masked logits are the
// reference's finite -1e30, so a row that sees no key at all (a decode
// past the end of the buffer by more than the window) averages V over
// every key, as the reference does.
//
// K and V come in as strided views (the prefix of a (B, Smax, KV, hd) slot
// buffer, or the k/v columns of a fused QKV activation): the kernel takes
// each one's batch and token strides and reads only the rows it needs.
//
// Every route walks only the keys [lo, hi) its queries can see (key_range):
// from the first key inside the first query's window to the last key the
// last query can see (every key when the last query sees none).
//
// Chunk route (Sq * G > 16; bound on an H100 by bf16 tensor-core
// operations: at serving chunks, hundreds of queries at hd 128, the two
// products do more operations per K/V byte than the card's balance point).
// For hd 64 and 128 and 16-byte aligned views the walk is
// prefill_wgmma.cuh's: a block owns up to 128 query rows of one
// (sequence, kv head) (BQ = 128 / G queries times the G heads of the kv
// head, so each K/V byte staged serves all of them), two consumer
// warpgroups run wgmma, and a producer thread keeps a 3-tile ring of
// 128-key tiles filled by TMA over the strided view (4-D tensor maps
// (hd, KV, n_keys, B) with the view's strides; coordinates past n_keys
// read as zeros). The tensor maps (Q, K, V) are encoded per call in the C
// launcher: the pointers change per layer. cuTensorMapEncodeTiled is
// looked up in libcuda (already loaded by the CUDA runtime) with
// cudaGetDriverEntryPoint, so the library links nothing beyond the CUDA
// runtime. The tiles late in the chunk (the longest walks) are launched
// first.
//
// Decode route (Sq * G <= 16, hd 64 or 128, 16-byte aligned views: every
// decode step of the dense-slot path; bound by bytes, each visible K/V row
// read once at about 2 G flops per bf16 element). A block per (sequence,
// kv head) would run B * KV blocks (16 at gemma3's B = 1) with one warp of
// four busy. Instead the Sq * G rows form one m16 tile, the 4 warps split
// the keys of each 64-key tile, and the grid (B, KV, n_split) splits
// [lo, hi) into tile-aligned slices planned on the host; the blocks write
// f32 partial states and combine_kernel merges them (decode_split.cuh, the
// same walk and combine as the paged decode kernel, with strided
// addressing and the finite mask). Its cp.async ring is RING = 2 tiles: on
// an H100 SXM at 700 W gemma3's decode over 2048 keys ran ~4% faster with
// two than with three (the slices are four tiles long).
//
// Other head dims (any hd <= 256) and unaligned views take a warp-per-row
// f32-FMA path.
#include "decode_split.cuh"
#include "prefill_wgmma.cuh"

namespace {

constexpr float MASKED = -1e30f;  // the reference's finite mask value
constexpr int RING = 2;           // depth of the decode route's cp.async ring

// f32-FMA path: one warp per (sequence, query, head) row
constexpr int FMA_WARPS = 4;
constexpr int FMA_DIMS = 8;  // output dims per lane: 8 * 32 = 256 >= hd

struct Dense {
  int B, Sq, H, KV, G, hd, n_keys;
  long long k_sb, k_st, v_sb, v_st;  // batch and token strides, elements
  int q_start, window;
  float sm_scale, softcap;
};

// Keys [lo, hi) that queries q_first .. q_last of the chunk can see. When
// the last query sees none (its window starts past the last key) every key
// is walked: such rows take the reference's uniform average over all keys.
__device__ __forceinline__ void key_range(const Dense& d, int q_first,
                                          int q_last, int& lo, int& hi) {
  const int p_last = d.q_start + q_last;
  hi = min(d.n_keys, p_last + 1);
  lo = d.window > 0 ? max(0, d.q_start + q_first - d.window + 1) : 0;
  if (d.window > 0 && p_last - d.window + 1 >= d.n_keys) {
    lo = 0;
    hi = d.n_keys;
  }
}

__device__ __forceinline__ float scale_cap(const Dense& d, float s) {
  s *= d.sm_scale;
  if (d.softcap > 0.0f) s = tanhf(s / d.softcap) * d.softcap;
  return s;
}

// Q, K and V by TMA from one producer thread: Q as one (64, G, BQ) box
// per 64-dim half (rows r = qi * G + gi land 128 bytes apart), K and V as
// (64, 1, KN) boxes of KN keys per half.
struct DenseMaps {
  CUtensorMap q, k, v;
};

template <int HD>
struct DenseSrc {
  static constexpr int LOADERS = 1;
  static constexpr bool GENERIC_WRITES = false;
  static constexpr bool FINITE_MASK = true;
  const DenseMaps* maps;   // the kernel's parameter (param space)
  __nv_bfloat16* out;
  int H, G, Sq, b, kvh, q0, bq;
  int q_first, q_last, window;   // global positions of the block's queries
  float sm_scale, softcap;
  int R, k0, n_tiles, k_end;

  __device__ void load_q(uint32_t dst, int q_half, int, uint32_t bar,
                         int) const {
    pa::wg::mbar_expect_tx(bar, HD / 64 * pa::wg::ROW_BYTES * G * bq);
    for (int h = 0; h < HD / 64; ++h)
      pa::wg::tma_load_4d(dst + h * q_half, &maps->q, bar, h * 64, kvh * G,
                          q0, b);
  }
  __device__ void load_kv(int t0, uint32_t k_dst, uint32_t v_dst,
                          uint32_t bar, int) const {
    constexpr int HALF = pa::wg::KN * pa::wg::ROW_BYTES;
    pa::wg::mbar_expect_tx(bar, 2 * HD / 64 * HALF);
    for (int h = 0; h < HD / 64; ++h) {
      pa::wg::tma_load_4d(k_dst + h * HALF, &maps->k, bar, h * 64, kvh, t0, b);
      pa::wg::tma_load_4d(v_dst + h * HALF, &maps->v, bar, h * 64, kvh, t0, b);
    }
  }
  __device__ void finish(int) const {}
  __device__ bool row_ok(int) const { return true; }
  __device__ int qpos(int r) const { return q_first + r / G; }
  __device__ bool sees(int tpos, int qpos) const {
    return tpos <= qpos && (window <= 0 || tpos > qpos - window);
  }
  __device__ bool tile_clear(int t0, int n) const {
    return t0 + n <= k_end && t0 + n - 1 <= q_first &&
           (window <= 0 || t0 > q_last - window);
  }
  __device__ __nv_bfloat16* out_row(int r) const {
    return out + (((size_t)b * Sq + q0 + r / G) * H + kvh * G + r % G) * HD;
  }
};

template <int HD>
__global__ void __launch_bounds__(pa::wg::THREADS, 1)
dense_wgmma_kernel(const __grid_constant__ DenseMaps maps,
                   __nv_bfloat16* __restrict__ out, const Dense d, int BQ,
                   int n_qt) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  int qt, b, kvh;
  pa::wg::block_coords(n_qt, d.B, d.KV, qt, b, kvh);
  DenseSrc<HD> src;
  src.maps = &maps;
  src.out = out;
  src.H = d.H;
  src.G = d.G;
  src.Sq = d.Sq;
  src.b = b;
  src.kvh = kvh;
  src.q0 = qt * BQ;
  src.bq = BQ;
  const int nq = min(BQ, d.Sq - src.q0);
  src.q_first = d.q_start + src.q0;
  src.q_last = src.q_first + nq - 1;
  src.window = d.window;
  src.sm_scale = d.sm_scale;
  src.softcap = d.softcap;
  int lo, hi;
  key_range(d, src.q0, src.q0 + nq - 1, lo, hi);
  src.R = nq * d.G;
  src.k0 = lo;
  src.n_tiles = (hi - lo + pa::wg::KN - 1) / pa::wg::KN;
  src.k_end = hi;
  pa::wg::attend<HD>(src, pa::wg::align1024(smem_raw));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda the runtime loaded.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map (dims innermost first, byte strides of dims 1..3), box
// `box`, 128-byte swizzle, zeros out of bounds.
bool encode4(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
             const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, const Dense& d, int BQ, int n_qt,
                         cudaStream_t stream) {
  DenseMaps maps;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  // a batch stride of one sequence is never stepped: give it a legal value
  const long long k_sb = d.B > 1 ? d.k_sb : (long long)d.n_keys * d.k_st;
  const long long v_sb = d.B > 1 ? d.v_sb : (long long)d.n_keys * d.v_st;
  const cuuint64_t kv_dims[4] = {(cuuint64_t)HD, (cuuint64_t)d.KV,
                                 (cuuint64_t)d.n_keys, (cuuint64_t)d.B};
  const cuuint32_t kv_box[4] = {64, 1, pa::wg::KN, 1};
  const cuuint64_t q_dims[4] = {(cuuint64_t)HD, (cuuint64_t)d.H,
                                (cuuint64_t)d.Sq, (cuuint64_t)d.B};
  const cuuint64_t q_strides[3] = {HD * e, (cuuint64_t)d.H * HD * e,
                                   (cuuint64_t)d.Sq * d.H * HD * e};
  const cuuint32_t q_box[4] = {64, (cuuint32_t)d.G, (cuuint32_t)BQ, 1};
  const cuuint64_t k_strides[3] = {HD * e, (cuuint64_t)d.k_st * e,
                                   (cuuint64_t)k_sb * e};
  const cuuint64_t v_strides[3] = {HD * e, (cuuint64_t)d.v_st * e,
                                   (cuuint64_t)v_sb * e};
  if (!encode4(&maps.q, q, q_dims, q_strides, q_box) ||
      !encode4(&maps.k, k, kv_dims, k_strides, kv_box) ||
      !encode4(&maps.v, v, kv_dims, v_strides, kv_box))
    return cudaErrorInvalidValue;
  auto kernel = dense_wgmma_kernel<HD>;
  const size_t smem = pa::wg::Smem<HD>::bytes();
  cudaError_t err = pa::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)n_qt * d.B * d.KV),
           pa::wg::THREADS, smem, stream>>>(
      maps, (__nv_bfloat16*)out, d, BQ, n_qt);
  return cudaGetLastError();
}

// Decode route: keys [lo + s * chunk, min(hi, lo + (s + 1) * chunk)) of
// sequence b, kv head kvh, for its Sq * G <= 16 query rows.
template <int HD>
__global__ void __launch_bounds__(pa::split::NT)
dense_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                   Dense d, int lo, int hi, int n_split, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z;
  const int k0 = lo + s * chunk, k1 = min(hi, k0 + chunk);
  const pa::split::StridedRows kv{
      k + (long long)b * d.k_sb + (long long)kvh * HD,
      v + (long long)b * d.v_sb + (long long)kvh * HD, d.k_st, d.v_st};
  const pa::split::CausalWindow vis{d.q_start, d.window, d.G};
  const int R = d.Sq * d.G;
  const size_t seq = (size_t)b * d.Sq * d.H * HD;
  float* rec = part == nullptr
                   ? nullptr
                   : part + ((size_t)(b * d.KV + kvh) * n_split + s) * R *
                                (HD + 2);
  pa::split::attend<HD, RING>(q + seq, out + seq, rec, kv, vis, d.H, d.G,
                              kvh, R, k0, k1, MASKED, d.sm_scale, d.softcap,
                              smem);
}

template <int HD>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         void* out, void* part, const Dense& d, int lo, int hi,
                         int n_split, int chunk, cudaStream_t stream) {
  auto kernel = dense_split_kernel<HD>;
  const size_t smem = pa::split::smem_bytes<HD, RING>();
  cudaError_t err = pa::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(d.B, d.KV, n_split), pa::split::NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)part, d, lo, hi,
      n_split, chunk);
  return cudaGetLastError();
}

// One warp per (sequence, query, head) row: each lane scores one key of a
// 32-key step against the row (q in shared memory), the warp updates the
// online softmax, and each lane accumulates its hd / 32 output dims.
__global__ void __launch_bounds__(FMA_WARPS * 32)
dense_fma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, Dense d) {
  __shared__ float q_s[FMA_WARPS][FMA_DIMS * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * FMA_WARPS + warp;
  if (row >= (long long)d.B * d.Sq * d.H) return;  // no block barriers below
  const int h = (int)(row % d.H);
  const long long bi = row / d.H;
  const int i = (int)(bi % d.Sq);
  const int b = (int)(bi / d.Sq);
  const int kvh = h / d.G;
  const int qpos = d.q_start + i;
  int lo, hi;
  key_range(d, i, i, lo, hi);
  // no key in this row's window: the reference's uniform average
  const bool none_visible = d.window > 0 && qpos - d.window + 1 >= d.n_keys;

  const __nv_bfloat16* qr = q + row * d.hd;
  for (int dd = lane; dd < d.hd; dd += 32)
    q_s[warp][dd] = __bfloat162float(qr[dd]);
  __syncwarp();
  const __nv_bfloat16* kb = k + (long long)b * d.k_sb + (long long)kvh * d.hd;
  const __nv_bfloat16* vb = v + (long long)b * d.v_sb + (long long)kvh * d.hd;

  float m = -INFINITY, l = 0.0f;
  float acc[FMA_DIMS];
#pragma unroll
  for (int j = 0; j < FMA_DIMS; ++j) acc[j] = 0.0f;
  for (int t0 = lo; t0 < hi; t0 += 32) {
    const int t = t0 + lane;
    const bool ok = t < hi;
    float s = -INFINITY;
    if (ok) {
      const __nv_bfloat16* kr = kb + (long long)t * d.k_st;
      float dot = 0.0f;
      for (int dd = 0; dd < d.hd; ++dd)
        dot = fmaf(q_s[warp][dd], __bfloat162float(kr[dd]), dot);
      s = none_visible ? MASKED : scale_cap(d, dot);
    }
    const float m_new = fmaxf(m, pa::warp_max(s));  // finite: lane 0 is ok
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(s - m_new) : 0.0f;
    l = l * alpha + pa::warp_sum(p);
#pragma unroll
    for (int j = 0; j < FMA_DIMS; ++j) acc[j] *= alpha;
    const int n = min(32, hi - t0);
    for (int u = 0; u < n; ++u) {
      const float pu = __shfl_sync(0xffffffffu, p, u);
      const __nv_bfloat16* vr = vb + (long long)(t0 + u) * d.v_st;
#pragma unroll
      for (int j = 0; j < FMA_DIMS; ++j) {
        const int dd = lane + 32 * j;
        if (dd < d.hd) acc[j] = fmaf(pu, __bfloat162float(vr[dd]), acc[j]);
      }
    }
    m = m_new;
  }
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
  __nv_bfloat16* orow = out + row * d.hd;
#pragma unroll
  for (int j = 0; j < FMA_DIMS; ++j) {
    const int dd = lane + 32 * j;
    if (dd < d.hd) orow[dd] = __float2bfloat16(acc[j] * inv);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// q (B, Sq, H, hd) bf16, contiguous; k and v bf16 views whose (KV, hd)
// rows are contiguous, key t of sequence b at element b * sb + t * st;
// n_keys >= 1 keys; out (B, Sq, H, hd) bf16. n_split > 0 takes the decode
// route over keys [lo, hi) (key_range's), cut into n_split slices of
// `chunk` keys; with n_split > 1, part is f32 scratch of
// B * KV * n_split * Sq * H / KV records of hd + 2 floats. n_split == 0
// takes the chunk route (or the FMA path); BQ and n_qt are the chunk
// route's tile plan (kernels/tiles.py): BQ queries a block, BQ * G <= 128
// rows, n_qt tiles covering Sq. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int prefill_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* part,
    int B, int Sq, int H, int KV, int hd, int n_keys, long long k_sb,
    long long k_st, long long v_sb, long long v_st, int q_start, int window,
    float softcap, int n_split, int chunk, int lo, int hi, int BQ, int n_qt,
    void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > 16 || hd <= 0 || hd > FMA_DIMS * 32 || n_keys <= 0 ||
      q_start < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  Dense d;
  d.B = B;
  d.Sq = Sq;
  d.H = H;
  d.KV = KV;
  d.G = H / KV;
  d.hd = hd;
  d.n_keys = n_keys;
  d.k_sb = k_sb;
  d.k_st = k_st;
  d.v_sb = v_sb;
  d.v_st = v_st;
  d.q_start = q_start;
  d.window = window;
  d.sm_scale = 1.0f / sqrtf((float)hd);
  d.softcap = softcap;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = aligned16(k) && aligned16(v) && k_sb % 8 == 0 &&
                   k_st % 8 == 0 && v_sb % 8 == 0 && v_st % 8 == 0;
  if (n_split > 0) {
    if (!(hd == 64 || hd == 128) || !vec || Sq * d.G > 16 || lo < 0 ||
        hi > n_keys || lo >= hi || chunk <= 0 || n_split > 65535 ||
        (long long)n_split * chunk < hi - lo ||
        (n_split > 1 && part == nullptr))
      return (int)cudaErrorInvalidValue;
    void* p = n_split > 1 ? part : nullptr;
    const cudaError_t err =
        hd == 64 ? launch_split<64>(q, k, v, out, p, d, lo, hi, n_split,
                                    chunk, s)
                 : launch_split<128>(q, k, v, out, p, d, lo, hi, n_split,
                                     chunk, s);
    if (err != cudaSuccess || n_split == 1) return (int)err;
    return (int)launch_combine((const float*)part, (__nv_bfloat16*)out, B,
                               KV, n_split, /*R=*/Sq * d.G, d.G, H, Sq, hd,
                               s);
  }
  if ((hd == 64 || hd == 128) && vec && aligned16(q)) {
    if (!pa::wg::plan_ok(Sq, d.G, BQ, n_qt) ||
        (long long)n_qt * B * KV > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const auto f = hd == 64 ? launch_wgmma<64> : launch_wgmma<128>;
    return (int)f(q, k, v, out, d, BQ, n_qt, s);
  }
  const long long rows = (long long)B * Sq * H;
  const unsigned blocks = (unsigned)((rows + FMA_WARPS - 1) / FMA_WARPS);
  dense_fma_kernel<<<blocks, FMA_WARPS * 32, 0, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, d);
  return (int)cudaGetLastError();
}
