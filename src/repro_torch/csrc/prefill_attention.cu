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
// One thread block per (sequence, kv head, tile of BQ queries): the tile's
// BQ * G query rows attend together, so each K/V byte a block reads serves
// all of them. For hd 64 and 128 the products run on the tensor cores
// (mma.sync m16n8k16, 4 warps x 16 rows, Q fragments in registers, K/V by
// ldmatrix from cp.async double-buffered tiles), with the fragment helpers
// of paged_attention_mma.cuh. Not yet: wgmma with TMA.
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

namespace {

constexpr float MASKED = -1e30f;  // the reference's finite mask value
constexpr int RING = 2;           // depth of the decode route's cp.async ring

// tensor-core path
constexpr int MMA_WARPS = 4;
constexpr int MMA_ROWS = 16 * MMA_WARPS;

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

__device__ __forceinline__ bool visible(const Dense& d, int tpos, int qpos) {
  return tpos <= qpos && (d.window <= 0 || tpos > qpos - d.window);
}

__device__ __forceinline__ float scale_cap(const Dense& d, float s) {
  s *= d.sm_scale;
  if (d.softcap > 0.0f) s = tanhf(s / d.softcap) * d.softcap;
  return s;
}

// Start copying keys [t0, t0 + tn) of one (sequence, kv head) into a
// (TILE, HD + 8) tile; rows past tn come out zero. ``base`` points at key 0
// of that sequence and kv head.
template <int HD, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ base,
                                          long long st, int t0, int tn) {
  constexpr int NV = HD / 8;
  constexpr int RS = HD + 8;
  for (int idx = threadIdx.x; idx < pa::TILE * NV; idx += NT) {
    const int t = idx / NV, c = idx - t * NV;
    const bool ok = t < tn;
    const __nv_bfloat16* src = ok ? base + (long long)(t0 + t) * st + c * 8
                                  : base;
    pa::cp_async16(dst + t * RS + c * 8, src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(MMA_WARPS * 32)
dense_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, Dense d, int BQ) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NT = MMA_WARPS * 32;
  constexpr int KS = HD / 16;        // k-steps of Q K^T
  constexpr int NS = pa::TILE / 8;   // n-tiles of S (keys)
  constexpr int NO = HD / 8;         // n-tiles of O (dims)
  constexpr int RS = HD + 8;         // shared-memory row stride, bf16
  constexpr int TILE_ELEMS = pa::TILE * RS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y, kvh = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, d.Sq - q0);
  const int G = d.G;
  const int R = nq * G;

  int lo, hi;
  key_range(d, q0, q0 + nq - 1, lo, hi);
  const __nv_bfloat16* kb = k + (long long)b * d.k_sb + (long long)kvh * HD;
  const __nv_bfloat16* vb = v + (long long)b * d.v_sb + (long long)kvh * HD;
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem);
  {
    const int tn = min(pa::TILE, hi - lo);
    load_tile<HD, NT>(kv_s, kb, d.k_st, lo, tn);
    load_tile<HD, NT>(kv_s + TILE_ELEMS, vb, d.v_st, lo, tn);
    pa::cp_async_commit();
  }

  // this thread's two rows (gq and gq + 8 of the warp's 16)
  int row_q[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    row_ok[h] = r < R;
    row_q[h] = d.q_start + q0 + r / G;
  }

  // Q fragments, kept in registers for the whole key walk
  uint32_t qa[KS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    const int qi = r / G, gi = r - qi * G;
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + (((long long)b * d.Sq + q0 + qi) * d.H + kvh * G + gi) * HD);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][h] = row_ok[h] ? __ldg(qrow + kk * 8 + t4) : 0u;
      qa[kk][2 + h] = row_ok[h] ? __ldg(qrow + kk * 8 + 4 + t4) : 0u;
    }
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.0f, 0.0f};  // this thread's partial row sums

  int stage = 0;
  for (int t0 = lo; t0 < hi; t0 += pa::TILE, stage ^= 1) {
    const __nv_bfloat16* k_s = kv_s + (2 * stage) * TILE_ELEMS;
    const __nv_bfloat16* v_s = kv_s + (2 * stage + 1) * TILE_ELEMS;
    if (t0 + pa::TILE < hi) {
      // next tile into the other stage; its last readers finished before
      // the closing barrier of the previous iteration
      const int tn2 = min(pa::TILE, hi - t0 - pa::TILE);
      __nv_bfloat16* k2 = kv_s + (2 * (stage ^ 1)) * TILE_ELEMS;
      load_tile<HD, NT>(k2, kb, d.k_st, t0 + pa::TILE, tn2);
      load_tile<HD, NT>(k2 + TILE_ELEMS, vb, d.v_st, t0 + pa::TILE, tn2);
      pa::cp_async_commit();
      pa::cp_async_wait<1>();
    } else {
      pa::cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bf[4];
        const int key = j * 8 + (lane & 7) + ((lane >> 4) << 3);
        const int dim = kk * 16 + ((lane >> 3) & 1) * 8;
        pa::ldmatrix_x4(bf, k_s + key * RS + dim);
        pa::mma_bf16(s[j], qa[kk], bf[0], bf[1]);
        pa::mma_bf16(s[j + 1], qa[kk], bf[2], bf[3]);
      }
    }

    // scale, softcap, mask; online softmax per row. Keys past the walk and
    // rows past the tile are -inf (they weigh nothing); keys a row may not
    // see are the reference's finite -1e30: a row's first visible key
    // rescales anything they added by exp(-1e30 - m) = 0
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int tpos = t0 + j * 8 + 2 * t4 + (e & 1);
        float x = scale_cap(d, s[j][e]);
        if (!row_ok[h] || tpos >= hi)
          x = -INFINITY;
        else if (!visible(d, tpos, row_q[h]))
          x = MASKED;
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_row[h], mx[h]);
      alpha[h] = m_new == -INFINITY ? 1.0f : expf(m_row[h] - m_new);
      m_row[h] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = m_row[h] == -INFINITY ? 0.0f
                                              : expf(s[j][e] - m_row[h]);
        s[j][e] = p;
        sum[h] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_row[h] = l_row[h] * alpha[h] + sum[h];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: S fragments of key tiles 2kk, 2kk+1 form P's A fragment
#pragma unroll
    for (int kk = 0; kk < pa::TILE / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pa::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pa::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pa::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pa::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bf[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int dim = n * 8 + (lane >> 4) * 8;
        pa::ldmatrix_x4_trans(bf, v_s + key * RS + dim);
        pa::mma_bf16(o[n], pf, bf[0], bf[1]);
        pa::mma_bf16(o[n + 1], pf, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }

  // epilogue: full row sums across the quad; normalise; write bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 1);
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    if (r >= R) continue;
    const int qi = r / G, gi = r - qi * G;
    const float inv = l_row[h] > 0.0f ? 1.0f / l_row[h] : 0.0f;
    __nv_bfloat16* orow =
        out + (((long long)b * d.Sq + q0 + qi) * d.H + kvh * G + gi) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      pa::store_pair(orow, n * 8 + 2 * t4, HD, o[n][2 * h] * inv,
                     o[n][2 * h + 1] * inv);
  }
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
// takes the chunk route (or the FMA path). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int prefill_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* part,
    int B, int Sq, int H, int KV, int hd, int n_keys, long long k_sb,
    long long k_st, long long v_sb, long long v_st, int q_start, int window,
    float softcap, int n_split, int chunk, int lo, int hi, void* stream) {
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
  if ((hd == 64 || hd == 128) && vec) {
    const int BQ = min(MMA_ROWS / d.G, Sq);
    const size_t smem =
        (size_t)4 * pa::TILE * (hd + 8) * sizeof(__nv_bfloat16);
    auto kernel = hd == 64 ? dense_mma_kernel<64> : dense_mma_kernel<128>;
    cudaError_t err = pa::set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, B, KV);
    kernel<<<grid, MMA_WARPS * 32, smem, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, d, BQ);
    return (int)cudaGetLastError();
  }
  const long long rows = (long long)B * Sq * H;
  const unsigned blocks = (unsigned)((rows + FMA_WARPS - 1) / FMA_WARPS);
  dense_fma_kernel<<<blocks, FMA_WARPS * 32, 0, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, d);
  return (int)cudaGetLastError();
}
