// Tensor-core paged attention for one thread block (bf16 mma.sync,
// m16n8k16, f32 accumulation), used by the chunked-prefill kernel for
// head dims 64 and 128; its fragment helpers also serve the split decode
// (decode_split.cuh) and the dense kernel.
//
// The block owns R <= 16 * NW query rows (rows r = qi * G + gi: query qi of
// the tile, head gi of the kv head's group); warp w owns rows 16w..16w+15.
// Keys stream through the same double-buffered shared-memory tiles as the
// FMA path (paged_attention_common.cuh: cp.async copies through the staged
// block-table row). Per key tile each warp computes S = Q K^T (its Q
// fragments stay in registers for the whole walk, K fragments come from
// ldmatrix), masks and updates a flash-style online softmax on the S
// fragments, packs P to bf16 A fragments in registers (the S accumulator
// layout is the A operand layout) and accumulates O += P V (V fragments
// from ldmatrix.trans). Masked logits are -inf and rows with no visible
// key end with sum 0, so padding queries come out as exact zeros.
#pragma once

#include "paged_attention_common.cuh"

namespace pa {

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of attend_mma: the staged table row, then two stages of K
// and V tiles.
inline size_t mma_smem_bytes(const Geometry& g) {
  return (size_t)((g.maxp + 3) & ~3) * 4 +
         (size_t)4 * TILE * g.rs * sizeof(__nv_bfloat16);
}

// Same contract as attend() (paged_attention_common.cuh) for hd == HD,
// HD % 16 == 0, g.vec; NW warps; R = nq * G <= 16 * NW.
template <int HD, int NW>
__device__ __forceinline__ void attend_mma(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ table, __nv_bfloat16* __restrict__ out,
    const Geometry& g, int kvh, int q0, int nq, int n_valid, int q_start,
    int total, float* smem) {
  constexpr int NT = NW * 32;
  constexpr int KS = HD / 16;   // k-steps of Q K^T
  constexpr int NS = TILE / 8;  // n-tiles of S (keys)
  constexpr int NO = HD / 8;    // n-tiles of O (dims)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int G = g.G;
  const int R = nq * G;

  const int last_q = min(q0 + nq, n_valid) - 1;
  if (last_q < q0) {
    // every query of the tile is padding (or the row is empty): zeros
    const int npairs = HD / 2;
    for (int idx = tid; idx < R * npairs; idx += NT) {
      const int r = idx / npairs, dp = idx - r * npairs;
      const int qi = r / G, gi = r - qi * G;
      store_pair(out + ((size_t)(q0 + qi) * g.H + kvh * G + gi) * HD, 2 * dp,
                 HD, 0.0f, 0.0f);
    }
    return;
  }
  int kv_end = min(total, q_start + last_q + 1);
  kv_end = min(kv_end, g.maxp * g.page_size);

  int* tab_s = reinterpret_cast<int*>(smem);
  __nv_bfloat16* kv_s =
      reinterpret_cast<__nv_bfloat16*>(smem + ((g.maxp + 3) & ~3));
  const int tile_elems = TILE * g.rs;
  const int n_tab = (kv_end + g.page_size - 1) / g.page_size;
  for (int i = tid; i < n_tab; i += NT) tab_s[i] = __ldg(table + i);
  __syncthreads();
  {
    const int tn = min(TILE, kv_end);
    load_tile<NT>(kv_s, k_pages, tab_s, g, kvh, 0, tn);
    load_tile<NT>(kv_s + tile_elems, v_pages, tab_s, g, kvh, 0, tn);
    cp_async_commit();
  }

  // this thread's two rows (gq and gq + 8 of the warp's 16)
  int row_q[2];        // global position of the row's query, or -1
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    const int qi = r / G;
    row_ok[h] = r < R && q0 + qi < n_valid;
    row_q[h] = row_ok[h] ? q_start + q0 + qi : -1;
  }

  // Q fragments, kept in registers for the whole key walk
  uint32_t qa[KS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    const int qi = r / G, gi = r - qi * G;
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + ((size_t)(q0 + qi) * g.H + kvh * G + gi) * HD);
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
  float l_row[2] = {0.0f, 0.0f};   // this thread's partial row sums

  int stage = 0;
  for (int t0 = 0; t0 < kv_end; t0 += TILE, stage ^= 1) {
    const __nv_bfloat16* k_s = kv_s + (2 * stage) * tile_elems;
    const __nv_bfloat16* v_s = kv_s + (2 * stage + 1) * tile_elems;
    if (t0 + TILE < kv_end) {
      const int tn2 = min(TILE, kv_end - t0 - TILE);
      __nv_bfloat16* k2 = kv_s + (2 * (stage ^ 1)) * tile_elems;
      load_tile<NT>(k2, k_pages, tab_s, g, kvh, t0 + TILE, tn2);
      load_tile<NT>(k2 + tile_elems, v_pages, tab_s, g, kvh, t0 + TILE, tn2);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
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
        uint32_t b[4];
        const int key = j * 8 + (lane & 7) + ((lane >> 4) << 3);
        const int dim = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b, k_s + key * g.rs + dim);
        mma_bf16(s[j], qa[kk], b[0], b[1]);
        mma_bf16(s[j + 1], qa[kk], b[2], b[3]);
      }
    }

    // scale, softcap, mask; online softmax per row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int tpos = t0 + j * 8 + 2 * t4 + (e & 1);
        float v = s[j][e] * g.sm_scale;
        if (g.softcap > 0.0f) v = tanhf(v / g.softcap) * g.softcap;
        const bool ok = tpos <= row_q[h] && tpos < total && tpos < kv_end;
        v = ok ? v : -INFINITY;
        s[j][e] = v;
        mx[h] = fmaxf(mx[h], v);
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
    for (int kk = 0; kk < TILE / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int dim = n * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b, v_s + key * g.rs + dim);
        mma_bf16(o[n], pa, b[0], b[1]);
        mma_bf16(o[n + 1], pa, b[2], b[3]);
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
    const float inv = (row_ok[h] && l_row[h] > 0.0f) ? 1.0f / l_row[h] : 0.0f;
    __nv_bfloat16* orow = out + ((size_t)(q0 + qi) * g.H + kvh * G + gi) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store_pair(orow, n * 8 + 2 * t4, HD, o[n][2 * h] * inv,
                 o[n][2 * h + 1] * inv);
  }
}

}  // namespace pa
