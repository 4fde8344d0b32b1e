// Block-level paged attention over a block table, shared by the decode
// kernel (paged_attention.cu) and the chunked-prefill kernel
// (paged_prefill_attention.cu).
//
// One thread block owns R = nq * G query rows: nq consecutive queries of one
// sequence times the G query heads that share one kv head. It walks that
// sequence's keys in tiles of TILE tokens, each token found through the
// block table (page = table[t / page_size], slot = t % page_size), and keeps
// a flash-style online softmax in f32: a running max and sum per row in
// shared memory and an (R, hd) accumulator in registers. Nothing is carried
// between blocks, so no second pass is needed.
//
// Per tile: (1) the K and V rows of the *next* tile are already in flight
// into the other half of a double buffer (cp.async, 16 bytes per copy, no
// registers held), so memory latency overlaps this tile's math; (2) each
// thread scores one key against several rows, keeping its K chunk in
// registers; (3) one warp per row updates the running max/sum and turns
// scores into probabilities; (4) each thread rescales and accumulates its
// (row, hd-pair) outputs, reusing each V pair across its rows.
// Masked logits are -inf and a row with no visible key ends with sum 0, so
// padding queries, length-0 rows and fully masked rows come out as exact
// zeros without a 0 * NaN hazard.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pa {

constexpr int TILE = 64;  // key tokens per shared-memory tile

struct Geometry {
  int H, KV, G, hd;
  int hdp;        // hd rounded up to even (pairs of bf16)
  int rs;         // shared-memory row stride of K/V tiles, bf16 elements
  int page_size, maxp;
  float sm_scale, softcap;
  int vec;        // 1 when hd % 8 == 0: rows move as 16-byte chunks
};

inline Geometry make_geometry(int H, int KV, int hd, int page_size, int maxp,
                              float softcap) {
  Geometry g;
  g.H = H;
  g.KV = KV;
  g.G = H / KV;
  g.hd = hd;
  g.hdp = (hd + 1) & ~1;
  g.vec = (hd % 8) == 0;
  // vec: +8 bf16 keeps rows 16-byte aligned for cp.async, and 16-byte
  // reads by 8 consecutive rows fall in 8 distinct bank groups; scalar:
  // +2 bf16 (one word) puts consecutive rows in consecutive banks
  g.rs = g.vec ? hd + 8 : g.hdp + 2;
  g.page_size = page_size;
  g.maxp = maxp;
  g.sm_scale = 1.0f / sqrtf((float)hd);
  g.softcap = softcap;
  return g;
}

// Block-table entries a block stages in shared memory (the host refuses
// wider tables).
constexpr int MAX_TABLE = 8192;

// 32-bit words before the K/V buffers: q, scores, max/sum/alpha (f32),
// then the block-table row (int32), rounded to 16 bytes.
__host__ __device__ inline int word_offset_kv(int R, int hdp, int maxp) {
  return (R * hdp + R * TILE + 3 * R + maxp + 3) & ~3;
}

// Dynamic shared memory for R rows: the words above, then two stages of
// K and V tiles (bf16).
inline size_t smem_bytes(int R, const Geometry& g) {
  return (size_t)word_offset_kv(R, g.hdp, g.maxp) * 4 +
         (size_t)4 * TILE * g.rs * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying keys [t0, t0 + tn) of one kv head into a (TILE, rs) tile;
// rows past tn come out zero. ``table`` is the block-table row staged in
// shared memory, so issuing a copy never waits on a global load. The vec
// path is asynchronous (cp.async, one commit group per call); the scalar
// path (hd % 8 != 0) copies through registers.
template <int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ pages,
                                          const int* __restrict__ table,
                                          const Geometry& g, int kvh, int t0,
                                          int tn) {
  const int tid = threadIdx.x;
  if (g.vec) {
    const int nv = g.hd / 8;
    for (int idx = tid; idx < TILE * nv; idx += NT) {
      const int t = idx / nv, c = idx - t * nv;
      const __nv_bfloat16* src = pages;
      if (t < tn) {
        const int tpos = t0 + t;
        const int pi = tpos / g.page_size;
        const int page = table[pi];
        const int slot = tpos - pi * g.page_size;
        const size_t row = ((size_t)page * g.page_size + slot) * g.KV + kvh;
        src = pages + row * g.hd + c * 8;
      }
      cp_async16(dst + t * g.rs + c * 8, src, t < tn);
    }
  } else {
    for (int idx = tid; idx < TILE * g.hdp; idx += NT) {
      const int t = idx / g.hdp, d = idx - t * g.hdp;
      __nv_bfloat16 val = __float2bfloat16(0.0f);
      if (t < tn && d < g.hd) {
        const int tpos = t0 + t;
        const int page = table[tpos / g.page_size];
        const int slot = tpos % g.page_size;
        const size_t row = ((size_t)page * g.page_size + slot) * g.KV + kvh;
        val = pages[row * g.hd + d];
      }
      dst[t * g.rs + d] = val;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, int d, int hd,
                                           float x, float y) {
  // d is even; with hd even every row starts 4-byte aligned
  if ((hd & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(x, y);
  } else {
    dst[d] = __float2bfloat16(x);
    if (d + 1 < hd) dst[d + 1] = __float2bfloat16(y);
  }
}

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// Attention for one block: queries q0 .. q0+nq-1 of one sequence, kv head
// kvh. q and out point at that sequence's (Sq, H, hd) slab; table at its
// block-table row. Query i is real when i < n_valid and sits at global
// position q_start + i; it sees keys tpos <= its position and tpos < total.
// NT threads; MAXR >= ceil(R / (NT / TILE)); MAXACC >= ceil(R * hdp/2 / NT).
template <int NT, int MAXR, int MAXACC>
__device__ __forceinline__ void attend(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ table, __nv_bfloat16* __restrict__ out,
    const Geometry& g, int kvh, int q0, int nq, int n_valid, int q_start,
    int total, float* smem) {
  static_assert(NT % TILE == 0 && NT % 32 == 0, "block shape");
  constexpr int NG = NT / TILE;  // row groups in the score phase
  constexpr int NW = NT / 32;
  const int tid = threadIdx.x;
  const int G = g.G, hdp = g.hdp, npairs = g.hdp / 2;
  const int R = nq * G;

  const int last_q = min(q0 + nq, n_valid) - 1;  // last real query of tile
  if (last_q < q0) {
    // every query of the tile is padding (or the row is empty): zeros
    for (int idx = tid; idx < R * npairs; idx += NT) {
      const int r = idx / npairs, dp = idx - r * npairs;
      const int qi = r / G, gi = r - qi * G;
      store_pair(out + ((size_t)(q0 + qi) * g.H + kvh * G + gi) * g.hd, 2 * dp,
                 g.hd, 0.0f, 0.0f);
    }
    return;
  }
  // keys this tile can see: up to its last real query's position
  int kv_end = min(total, q_start + last_q + 1);
  kv_end = min(kv_end, g.maxp * g.page_size);

  float* q_s = smem;
  float* s_s = q_s + R * hdp;
  float* m_s = s_s + R * TILE;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  int* tab_s = reinterpret_cast<int*>(a_s + R);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(
      smem + word_offset_kv(R, hdp, g.maxp));
  const int tile_elems = TILE * g.rs;  // K(stage) at 2*stage, V at 2*stage+1

  // the pages this block reads, staged once: one coalesced load
  const int n_tab = (kv_end + g.page_size - 1) / g.page_size;
  for (int i = tid; i < n_tab; i += NT) tab_s[i] = __ldg(table + i);
  __syncthreads();

  // first tile in flight before anything else
  if (kv_end > 0) {
    const int tn = min(TILE, kv_end);
    load_tile<NT>(kv_s, k_pages, tab_s, g, kvh, 0, tn);
    load_tile<NT>(kv_s + tile_elems, v_pages, tab_s, g, kvh, 0, tn);
    cp_async_commit();
  }

  for (int idx = tid; idx < R * hdp; idx += NT) {
    const int r = idx / hdp, d = idx - r * hdp;
    const int qi = r / G, gi = r - qi * G;
    float val = 0.0f;
    if (d < g.hd && q0 + qi < n_valid)
      val = __bfloat162float(
          q[((size_t)(q0 + qi) * g.H + kvh * G + gi) * g.hd + d]);
    q_s[idx] = val;
  }
  for (int r = tid; r < R; r += NT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }
  float2 acc[MAXACC];
#pragma unroll
  for (int i = 0; i < MAXACC; ++i) acc[i] = make_float2(0.0f, 0.0f);

  int stage = 0;
  for (int t0 = 0; t0 < kv_end; t0 += TILE, stage ^= 1) {
    const int tn = min(TILE, kv_end - t0);
    const __nv_bfloat16* k_s = kv_s + (2 * stage) * tile_elems;
    const __nv_bfloat16* v_s = kv_s + (2 * stage + 1) * tile_elems;
    if (t0 + TILE < kv_end) {
      // next tile into the other stage; its last readers finished before
      // the closing barrier of the previous iteration
      const int tn2 = min(TILE, kv_end - t0 - TILE);
      __nv_bfloat16* k2 = kv_s + (2 * (stage ^ 1)) * tile_elems;
      load_tile<NT>(k2, k_pages, tab_s, g, kvh, t0 + TILE, tn2);
      load_tile<NT>(k2 + tile_elems, v_pages, tab_s, g, kvh, t0 + TILE, tn2);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // (2) scores: thread -> one key t, rows rg, rg+NG, ...
    {
      const int t = tid % TILE, rg = tid / TILE;
      float sacc[MAXR];
#pragma unroll
      for (int j = 0; j < MAXR; ++j) sacc[j] = 0.0f;
      if (g.vec) {
        const uint4* krow = reinterpret_cast<const uint4*>(k_s + t * g.rs);
        for (int c = 0; c < g.hd / 8; ++c) {
          const uint4 kw = krow[c];
          const float2 k0 = bf2(kw.x), k1 = bf2(kw.y), k2 = bf2(kw.z),
                       k3 = bf2(kw.w);
#pragma unroll
          for (int j = 0; j < MAXR; ++j) {
            const int r = rg + j * NG;
            if (r < R) {
              const float4* qr =
                  reinterpret_cast<const float4*>(q_s + r * hdp + c * 8);
              const float4 qa = qr[0], qb = qr[1];
              float s = sacc[j];
              s = fmaf(qa.x, k0.x, s);
              s = fmaf(qa.y, k0.y, s);
              s = fmaf(qa.z, k1.x, s);
              s = fmaf(qa.w, k1.y, s);
              s = fmaf(qb.x, k2.x, s);
              s = fmaf(qb.y, k2.y, s);
              s = fmaf(qb.z, k3.x, s);
              s = fmaf(qb.w, k3.y, s);
              sacc[j] = s;
            }
          }
        }
      } else {
        const __nv_bfloat162* krow =
            reinterpret_cast<const __nv_bfloat162*>(k_s + t * g.rs);
        for (int dp = 0; dp < npairs; ++dp) {
          const float2 kf = __bfloat1622float2(krow[dp]);
#pragma unroll
          for (int j = 0; j < MAXR; ++j) {
            const int r = rg + j * NG;
            if (r < R) {
              const float2 qf =
                  reinterpret_cast<const float2*>(q_s + r * hdp)[dp];
              sacc[j] = fmaf(qf.x, kf.x, fmaf(qf.y, kf.y, sacc[j]));
            }
          }
        }
      }
      const int tpos = t0 + t;
#pragma unroll
      for (int j = 0; j < MAXR; ++j) {
        const int r = rg + j * NG;
        if (r < R) {
          const int qi = r / G;
          const int qpos = q_start + q0 + qi;
          float s = sacc[j] * g.sm_scale;
          if (g.softcap > 0.0f) s = tanhf(s / g.softcap) * g.softcap;
          const bool ok = t < tn && tpos <= qpos && tpos < total &&
                          q0 + qi < n_valid;
          s_s[r * TILE + t] = ok ? s : -INFINITY;
        }
      }
    }
    __syncthreads();

    // (3) online softmax: one warp per row
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int r = warp; r < R; r += NW) {
        float* srow = s_s + r * TILE;
        float mx = -INFINITY;
        for (int t = lane; t < TILE; t += 32) mx = fmaxf(mx, srow[t]);
        mx = warp_max(mx);
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        float alpha = 1.0f, sum = 0.0f;
        if (m_new == -INFINITY) {
          for (int t = lane; t < TILE; t += 32) srow[t] = 0.0f;
        } else {
          alpha = expf(m_old - m_new);
          for (int t = lane; t < TILE; t += 32) {
            const float p = expf(srow[t] - m_new);
            srow[t] = p;
            sum += p;
          }
        }
        sum = warp_sum(sum);
        __syncwarp();
        if (lane == 0) {
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
          a_s[r] = alpha;
        }
      }
    }
    __syncthreads();

    // (4) accumulate P @ V into this thread's (row, hd-pair) outputs:
    // output idx = tid + i * NT is row idx / npairs, pair idx % npairs
    const int rs2 = g.rs / 2;
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(v_s);
    if (NT % npairs == 0) {
      // every i shares this thread's pair column: load each V pair once
      // and reuse it across the thread's rows
      const int dp = tid % npairs, r0 = tid / npairs, rstep = NT / npairs;
#pragma unroll
      for (int i = 0; i < MAXACC; ++i) {
        const int r = r0 + i * rstep;
        if (r < R) {
          const float a = a_s[r];
          acc[i].x *= a;
          acc[i].y *= a;
        }
      }
      for (int t = 0; t < tn; ++t) {
        const float2 vf = __bfloat1622float2(v2[t * rs2 + dp]);
#pragma unroll
        for (int i = 0; i < MAXACC; ++i) {
          const int r = r0 + i * rstep;
          if (r < R) {
            const float pt = s_s[r * TILE + t];
            acc[i].x = fmaf(pt, vf.x, acc[i].x);
            acc[i].y = fmaf(pt, vf.y, acc[i].y);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < MAXACC; ++i) {
        const int idx = tid + i * NT;
        if (idx < R * npairs) {
          const int r = idx / npairs, dp = idx - r * npairs;
          const float a = a_s[r];
          float2 o = acc[i];
          o.x *= a;
          o.y *= a;
          const float* p = s_s + r * TILE;
          for (int t = 0; t < tn; ++t) {
            const float pt = p[t];
            const float2 vf = __bfloat1622float2(v2[t * rs2 + dp]);
            o.x = fmaf(pt, vf.x, o.x);
            o.y = fmaf(pt, vf.y, o.y);
          }
          acc[i] = o;
        }
      }
    }
    __syncthreads();
  }

  __syncthreads();  // l_s written by other threads when no tile ran
  // epilogue: normalise; rows with no visible key and padding queries -> 0
#pragma unroll
  for (int i = 0; i < MAXACC; ++i) {
    const int idx = tid + i * NT;
    if (idx < R * npairs) {
      const int r = idx / npairs, dp = idx - r * npairs;
      const int qi = r / G, gi = r - qi * G;
      const float l = l_s[r];
      const float inv = (q0 + qi < n_valid && l > 0.0f) ? 1.0f / l : 0.0f;
      store_pair(out + ((size_t)(q0 + qi) * g.H + kvh * G + gi) * g.hd, 2 * dp,
                 g.hd, acc[i].x * inv, acc[i].y * inv);
    }
  }
}

// Shared host-side checks; 0 when the geometry is one the kernels take.
inline int check_geometry(int H, int KV, int hd, int page_size, int maxp) {
  if (H <= 0 || KV <= 0 || H % KV != 0) return 1;
  if (H / KV > 16) return 1;
  if (hd <= 0 || hd > 256) return 1;
  if (page_size <= 0 || maxp <= 0 || maxp > MAX_TABLE) return 1;
  return 0;
}

template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace pa
