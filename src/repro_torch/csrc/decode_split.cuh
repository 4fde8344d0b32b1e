// Decode attention split over keys (flash-decoding), shared by the paged
// decode kernel (paged_attention.cu) and the decode route of the dense
// kernel (prefill_attention.cu).
//
// A decode step has one query (or a few) per sequence, so a block per
// (sequence, kv head) would leave most of the card idle and walk a long
// context one tile after another. Instead each row's key range is cut into
// n_split slices, planned on the host; block (sequence, kv head, split)
// walks one slice and either writes the final bf16 output (n_split == 1)
// or its partial softmax state per query row, (m, l, O) in f32, O not yet
// divided by l. A second small launch, combine_kernel, merges a row's
// partials:
//   M = max m_s over splits with l_s > 0,
//   out = sum_s exp(m_s - M) O_s / sum_s exp(m_s - M) l_s,
// and writes 0 when no split saw a key. A split with l_s == 0 is skipped,
// never weighted, so its unwritten O and its m = -inf cannot make a NaN.
//
// Inside a block: the R <= 16 query rows (row r = query r / G, head r % G
// of the kv head's group) form one m16 tensor-core tile (mma.sync
// m16n8k16, bf16 in, f32 out), and each 64-key tile of the slice is split
// over the 4 warps, 16 keys each, so the latency chain per tile is a
// quarter of a tile; each warp keeps its own online softmax, and the warps
// merge through shared memory at the end. K/V tiles stream through a ring
// of STAGES cp.async buffers (16-byte copies), so STAGES - 1 tiles are in
// flight during a tile's math; each kernel fixes its depth at compile time
// (paged 3, dense 2: the faster on an H100, PERF.md). TMA is not used: the
// copies are bytes-bound either way, and cp.async needs no tensor map for
// the paged or strided addressing.
//
// Masking: keys past the slice and rows past R are -inf (they weigh
// nothing). A key inside the slice that a row may not see gets ``masked``:
// -inf for the paged kernel (rows of length 0 stay exact zeros), the
// reference's finite -1e30 for the dense kernel, so a row that sees no key
// averages V over every key of the range (every split then has m = -1e30
// and the combine weights the splits by their l).
#pragma once

#include "paged_attention_mma.cuh"

namespace pa {
namespace split {

constexpr int NW = TILE / 16;  // warps; warp w takes keys 16w..16w+15
constexpr int NT = NW * 32;
constexpr int COMBINE_THREADS = 64;

// floats per partial record: O[hdp], m, l
__host__ __device__ inline int record_floats(int hd) {
  return ((hd + 1) & ~1) + 2;
}

// Shared memory of attend(): the K/V ring, reused for the warps' merge.
template <int HD, int STAGES>
inline size_t smem_bytes() {
  const size_t ring = (size_t)STAGES * 2 * TILE * (HD + 8) * 2;
  const size_t merge = (size_t)NW * 16 * (HD + 2) * sizeof(float);
  return ring > merge ? ring : merge;
}

// K/V rows through a block-table slice staged in shared memory (tab[i] is
// the page of keys (p0 + i) * page ..).
struct PagedRows {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* tab;
  int p0, page, row_stride, off;   // row_stride = KV * hd, off = kvh * hd
  __device__ __forceinline__ size_t row(int t) const {
    const int pi = t / page;
    return ((size_t)tab[pi - p0] * page + (t - pi * page)) * row_stride + off;
  }
  __device__ __forceinline__ const __nv_bfloat16* k_row(int t) const {
    return k + row(t);
  }
  __device__ __forceinline__ const __nv_bfloat16* v_row(int t) const {
    return v + row(t);
  }
};

// K/V rows of a strided view: key t at base + t * stride.
struct StridedRows {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long k_st, v_st;
  __device__ __forceinline__ const __nv_bfloat16* k_row(int t) const {
    return k + (long long)t * k_st;
  }
  __device__ __forceinline__ const __nv_bfloat16* v_row(int t) const {
    return v + (long long)t * v_st;
  }
};

// Every key of the slice is visible to every row (paged decode: the slice
// already stops at the row's length).
struct AllVisible {
  __device__ __forceinline__ bool operator()(int, int) const { return true; }
};

// Causal with an optional sliding window; row r is query r / G at global
// position q_start + r / G.
struct CausalWindow {
  int q_start, window, G;
  __device__ __forceinline__ bool operator()(int t, int r) const {
    const int qpos = q_start + r / G;
    return t <= qpos && (window <= 0 || t > qpos - window);
  }
};

// Start copying keys [t0, t0 + tn) into one ring slot (K at ks, V at vs);
// rows past tn come out zero.
template <int HD, class Rows>
__device__ __forceinline__ void load_kv(__nv_bfloat16* __restrict__ ks,
                                        __nv_bfloat16* __restrict__ vs,
                                        const Rows& kv, int t0, int tn) {
  constexpr int NV = HD / 8;
  constexpr int RS = HD + 8;
  for (int idx = threadIdx.x; idx < TILE * NV; idx += NT) {
    const int t = idx / NV, c = idx - t * NV;
    const bool ok = t < tn;
    const __nv_bfloat16* kp = ok ? kv.k_row(t0 + t) + c * 8 : kv.k;
    const __nv_bfloat16* vp = ok ? kv.v_row(t0 + t) + c * 8 : kv.v;
    cp_async16(ks + t * RS + c * 8, kp, ok);
    cp_async16(vs + t * RS + c * 8, vp, ok);
  }
}

// One block: rows 0..R-1 (R <= 16) of one (sequence, kv head) over keys
// [k0, k1). q and out point at the sequence's (Sq, H, HD) slab; row r is
// query r / G, head kvh * G + r % G. With part == nullptr the block writes
// the normalised bf16 output (zeros for a row that saw no key); otherwise
// it writes R records of record_floats(HD) floats at part: O unnormalised,
// then m, then l (m = -inf, l = 0 when the slice is empty). NT threads.
template <int HD, int STAGES, class Rows, class Vis>
__device__ __forceinline__ void attend(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, const Rows& kv, const Vis& vis, int H, int G,
    int kvh, int R, int k0, int k1, float masked, float sm_scale,
    float softcap, float* smem) {
  static_assert(TILE == 16 * NW, "one 16-key slice of each tile per warp");
  static_assert(STAGES >= 2, "a ring of at least two tiles");
  constexpr int KS = HD / 16;
  constexpr int NO = HD / 8;
  constexpr int RS = HD + 8;
  constexpr int TE = TILE * RS;       // bf16 elements of one K or V tile
  constexpr int REC = HD + 2;         // record_floats(HD), HD even
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;

  if (k0 >= k1) {   // nothing to see: zeros, or an empty partial
    if (part == nullptr) {
      for (int idx = tid; idx < R * HD / 2; idx += NT) {
        const int r = idx / (HD / 2), d = 2 * (idx - r * (HD / 2));
        store_pair(out + ((size_t)(r / G) * H + kvh * G + r % G) * HD, d, HD,
                   0.0f, 0.0f);
      }
    } else {
      for (int r = tid; r < R; r += NT) {
        part[r * REC + HD] = -INFINITY;
        part[r * REC + HD + 1] = 0.0f;
      }
    }
    return;
  }

  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int n_tiles = (k1 - k0 + TILE - 1) / TILE;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) {
      const int t0 = k0 + i * TILE;
      load_kv<HD>(ring + 2 * i * TE, ring + (2 * i + 1) * TE, kv, t0,
                  min(TILE, k1 - t0));
    }
    cp_async_commit();
  }

  // rows gq and gq + 8 of the m16 tile
  const int r0 = gq, r1 = gq + 8;
  const bool ok0 = r0 < R, ok1 = r1 < R;
  uint32_t qa[KS][4];
  {
    const uint32_t* q0p = reinterpret_cast<const uint32_t*>(
        q + ((size_t)(r0 / G) * H + kvh * G + r0 % G) * HD);
    const uint32_t* q1p = reinterpret_cast<const uint32_t*>(
        q + ((size_t)(r1 / G) * H + kvh * G + r1 % G) * HD);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][0] = ok0 ? __ldg(q0p + kk * 8 + t4) : 0u;
      qa[kk][1] = ok1 ? __ldg(q1p + kk * 8 + t4) : 0u;
      qa[kk][2] = ok0 ? __ldg(q0p + kk * 8 + 4 + t4) : 0u;
      qa[kk][3] = ok1 ? __ldg(q1p + kk * 8 + 4 + t4) : 0u;
    }
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.0f, 0.0f};   // this thread's partial row sums

  for (int i = 0; i < n_tiles; ++i) {
    {
      // tile i + STAGES - 1 into the slot tile i - 1 left; its readers
      // finished before the closing barrier of the previous iteration
      const int j = i + STAGES - 1;
      if (j < n_tiles) {
        const int slot = j % STAGES, t0 = k0 + j * TILE;
        load_kv<HD>(ring + 2 * slot * TE, ring + (2 * slot + 1) * TE, kv, t0,
                    min(TILE, k1 - t0));
      }
      cp_async_commit();            // an empty group past the last tile
      cp_async_wait<STAGES - 1>();  // tile i has landed
    }
    __syncthreads();
    const int slot = i % STAGES;
    const __nv_bfloat16* k_s = ring + 2 * slot * TE;
    const __nv_bfloat16* v_s = ring + (2 * slot + 1) * TE;
    const int t0 = k0 + i * TILE;
    const int kbase = warp * 16;   // this warp's 16 keys of the tile
    if (t0 + kbase < k1) {
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        const int key = kbase + (lane & 7) + ((lane >> 4) << 3);
        const int dim = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b, k_s + key * RS + dim);
        mma_bf16(s[0], qa[kk], b[0], b[1]);
        mma_bf16(s[1], qa[kk], b[2], b[3]);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int tpos = t0 + kbase + j * 8 + 2 * t4 + (e & 1);
          float x = s[j][e] * sm_scale;
          if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
          if (!(h ? ok1 : ok0) || tpos >= k1)
            x = -INFINITY;
          else if (!vis(tpos, h ? r1 : r0))
            x = masked;
          s[j][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_row[h], mx[h]);
        alpha[h] = m_new == -INFINITY ? 1.0f : expf(m_row[h] - m_new);
        m_row[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
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
      uint32_t pf[4];
      pf[0] = pack_bf16(s[0][0], s[0][1]);
      pf[1] = pack_bf16(s[0][2], s[0][3]);
      pf[2] = pack_bf16(s[1][0], s[1][1]);
      pf[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
        o[n + 1][0] *= alpha[0];
        o[n + 1][1] *= alpha[0];
        o[n + 1][2] *= alpha[1];
        o[n + 1][3] *= alpha[1];
        uint32_t b[4];
        const int key = kbase + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int dim = n * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, v_s + key * RS + dim);
        mma_bf16(o[n], pf, b[0], b[1]);
        mma_bf16(o[n + 1], pf, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();   // only empty groups remain; the ring is free

  // merge the warps' states through shared memory: per warp 16 rows of
  // O[HD], m, l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 1);
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 2);
  }
  constexpr int MS = HD + 2;
  float* mine = smem + warp * 16 * MS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = mine + (gq + 8 * h) * MS;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      row[n * 8 + 2 * t4] = o[n][2 * h];
      row[n * 8 + 2 * t4 + 1] = o[n][2 * h + 1];
    }
    if (t4 == 0) {
      row[HD] = m_row[h];
      row[HD + 1] = l_row[h];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * HD / 2; idx += NT) {
    const int r = idx / (HD / 2), d = 2 * (idx - r * (HD / 2));
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, smem[(w * 16 + r) * MS + HD]);
    float l = 0.0f, x = 0.0f, y = 0.0f;
    if (m != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float* row = smem + (w * 16 + r) * MS;
        const float c = expf(row[HD] - m);   // 0 for a warp that saw nothing
        l += c * row[HD + 1];
        x += c * row[d];
        y += c * row[d + 1];
      }
    }
    if (part == nullptr) {
      const float inv = l > 0.0f ? 1.0f / l : 0.0f;
      store_pair(out + ((size_t)(r / G) * H + kvh * G + r % G) * HD, d, HD,
                 x * inv, y * inv);
    } else {
      float* rec = part + r * REC;
      rec[d] = x;
      rec[d + 1] = y;
      if (d == 0) {
        rec[HD] = m;
        rec[HD + 1] = l;
      }
    }
  }
}

}  // namespace split
}  // namespace pa

namespace {

// Merge the n_split partial records of each (sequence, kv head, row) into
// the bf16 output. part holds records [(b * KV + kvh) * n_split + s][r] of
// record_floats(hd) floats; out is (B, Sq, H, hd) with row r at query
// r / G, head kvh * G + r % G. One block per (sequence, kv head, row).
__global__ void __launch_bounds__(pa::split::COMBINE_THREADS)
combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
               int n_split, int R, int G, int H, int KV, int Sq, int hd) {
  const int r = blockIdx.x % R;
  const int bk = blockIdx.x / R;   // b * KV + kvh
  const int kvh = bk % KV, b = bk / KV;
  const int rec = pa::split::record_floats(hd), hdp = rec - 2;
  const float* p0 = part + ((size_t)bk * n_split * R + r) * rec;
  const size_t step = (size_t)R * rec;   // from one split to the next
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) {
    const float* p = p0 + s * step;
    if (p[hdp + 1] > 0.0f) M = fmaxf(M, p[hdp]);
  }
  __nv_bfloat16* orow =
      out + (((size_t)b * Sq + r / G) * H + kvh * G + r % G) * hd;
  for (int d = 2 * threadIdx.x; d < hd; d += 2 * blockDim.x) {
    float l = 0.0f, x = 0.0f, y = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float* p = p0 + s * step;
      const float ls = p[hdp + 1];
      if (ls > 0.0f) {   // an empty split is skipped, never weighted
        const float c = expf(p[hdp] - M);
        l += c * ls;
        x += c * p[d];
        y += c * p[d + 1];
      }
    }
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;
    pa::store_pair(orow, d, hd, x * inv, y * inv);
  }
}

// Launch combine_kernel for B sequences on `stream`.
inline cudaError_t launch_combine(const float* part, __nv_bfloat16* out,
                                  int B, int KV, int n_split, int R, int G,
                                  int H, int Sq, int hd, cudaStream_t stream) {
  combine_kernel<<<(unsigned)((long long)B * KV * R),
                   pa::split::COMBINE_THREADS, 0, stream>>>(
      part, out, n_split, R, G, H, KV, Sq, hd);
  return cudaGetLastError();
}

}  // namespace
