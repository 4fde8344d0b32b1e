// Chunked-prefill attention on Hopper's warpgroup products (wgmma) with
// K/V tiles loaded asynchronously by a producer warpgroup, for head dims
// 64 and 128. One walk serves the chunk route of the dense kernel
// (prefill_attention.cu) and the paged prefill kernel
// (paged_prefill_attention.cu); each kernel supplies a Src: where Q, K and V
// come from, which rows are live and which keys each row sees.
//
// Bound on an H100: bf16 tensor-core operations. A serving chunk (hundreds
// of queries at hd 128) does more operations per K/V byte than the card's
// balance point; wgmma is the only way to the card's full tensor-core rate,
// and each K/V byte a block stages should serve as many query rows as it
// can. So:
//
// - Rows. A block owns up to 128 query rows (two consumer warpgroups, 64
//   rows each: the M of wgmma.m64nNk16) of one (sequence, kv head): row
//   r = qi * G + gi is query qi of the block's BQ queries and head gi of
//   the kv head's group, so the G heads share every K/V tile.
// - Products. S = Q K^T is wgmma over KN = 128 keys with Q and K in
//   shared memory, K-major, 128-byte swizzle (hd 128 is two 64-element
//   swizzle atoms). O += P V takes P from registers (S's accumulator
//   layout is the A fragment layout, packed to bf16) and V from shared
//   memory, MN-major (the transpose bit).
// - Softmax. Online, in f32 on the accumulator fragments (each thread
//   holds two rows of S and O), in base 2 with log2(e) folded into the
//   scale: the max is taken on the raw logits and each p is one FFMA and
//   one ex2. Tiles that every row of the block sees whole skip the mask,
//   and O is rescaled only when some row's max moved. These per-element
//   instructions, not the products, set a tile's time (PERF.md).
// - Loads. A producer warpgroup, its registers cut to 56 with setmaxnreg
//   so the consumers get more, fills a ring of 3 K/V tiles; mbarriers say
//   when a tile has landed (full) and when every consumer warp's products
//   that read it have completed (empty). The consumers never copy. The
//   dense Src loads with TMA over the strided K/V view; the paged Src with
//   cp.async through the block-table row (any page size), which the
//   mbarrier tracks (cp.async.mbarrier.arrive).
// - Order. Block ranks map to query tiles in reverse: the tiles late in a
//   chunk see the most keys and start first.
//
// Keys past the walk (k_end) and rows past the block's live rows are -inf
// and weigh nothing; a key a row may not see (the Src's sees()) gets the
// Src's mask value (-inf paged, the reference's finite -1e30 dense). A row
// whose max stays -inf ends with sum 0 and writes zeros.
#pragma once

#include <cuda.h>   // CUtensorMap (the types only: nothing links libcuda)

#include "paged_attention_mma.cuh"

namespace pa {
namespace wg {

constexpr int ROW_BYTES = 128;   // one swizzled row: 64 bf16
constexpr int KN = 128;          // keys per K/V tile: the N of S = Q K^T
constexpr int PRODUCER_REGS = 56;
constexpr float LOG2E = 1.4426950408889634f;

// Two consumer warpgroups and a producer warpgroup; a block of 64 rows or
// fewer leaves the second consumer idle. The ring holds 3 tiles, so two
// are in flight while the consumers work on one (192 KB at hd 128; on an
// H100 SXM at 700 W a 2-tile ring timed the same, and 64-key tiles in a
// 4-tile ring 5-10% slower). One block an SM: its registers at launch
// (65536 / THREADS, rounded down to 8: 168) less the producer's, over the
// consumers, are what setmaxnreg.inc can take from what .dec gave back.
constexpr int ROWS = 128;
constexpr int THREADS = 3 * 128;
constexpr int STAGES = 3;
constexpr int CONSUMER_REGS = 224;

// Shared memory from a 1024-byte aligned base: Q (HD / 64 halves of ROWS
// swizzled rows), the ring (per stage K then V, each HD / 64 halves of KN
// keys), then the mbarriers.
template <int HD>
struct Smem {
  static constexpr int HALVES = HD / 64;
  static constexpr int Q_HALF = ROWS * ROW_BYTES;
  static constexpr int Q = HALVES * Q_HALF;
  static constexpr int KV_HALF = KN * ROW_BYTES;
  static constexpr int K = HALVES * KV_HALF;
  static constexpr int STAGE = 2 * K;
  static constexpr int BARS = Q + STAGES * STAGE;
  static size_t bytes() { return 1024 + BARS + 64; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// never ends (a broken ring) traps, so the launch fails instead of
// holding the card: every wait of a healthy walk ends in microseconds.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 28)) asm volatile("trap;");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (the arrival counts against the barrier's initial count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// 16 bytes global -> shared, zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory writes of the generic proxy (cp.async) made visible to
// the async proxy (wgmma) of this thread.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x on the special-function unit (ex2.approx, ftz: 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous product's start or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 at bits 62-63.
// K-major: the stride offset steps 8 rows (1024 bytes), the leading one is
// unused; MN-major: the leading offset steps one 64-element atom along
// M/N, the stride offset 8 rows along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D (64 x 128, f32) = A B^T (+ D when scale_d != 0): A 64 x 16 and B
// 128 x 16, both bf16 in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A B: A 64 x 16 bf16 in registers (a product's
// accumulator layout, packed in pairs), B 16 x 64 bf16 in shared memory,
// MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A B: A 64 x 16 bf16 in registers (a product's
// accumulator layout, packed in pairs), B 16 x 128 bf16 in shared memory,
// MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The consumer warpgroups: warpgroup w owns rows 64w .. 64w + 63; this
// thread holds rows r0 and r0 + 8 (the accumulator layout: warp wq of the
// group rows 16wq .. 16wq + 15, lane rows lane / 4 and lane / 4 + 8,
// columns 8j + 2 (lane % 4) + {0, 1} of every 8-column group j).
template <int HD, class Src>
__device__ __forceinline__ void consume(const Src& src, uint32_t q_s,
                                        uint32_t ring, uint32_t bars) {
  using M = Smem<HD>;
  constexpr int KS = HD / 16;   // k-steps of Q K^T
  constexpr int NO = HD / 2;    // O accumulator registers
  constexpr int NS = KN / 2;    // S accumulator registers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = warp >> 2;
  if (w * 64 >= src.R) return;   // no live rows: takes no part in the ring
  const int gq = lane >> 2, t4 = lane & 3;
  const int r0 = w * 64 + (warp & 3) * 16 + gq;
  bool ok[2];
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    ok[h] = r < src.R && src.row_ok(r);
    qp[h] = ok[h] ? src.qpos(r) : 0;
  }
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.0f, 0.0f};   // this thread's partial row sums

  const uint32_t q_w = q_s + w * 64 * ROW_BYTES;
  mbar_wait(bars + 16 * STAGES, 0);
  for (int i = 0; i < src.n_tiles; ++i) {
    const int st = i % STAGES;
    mbar_wait(bars + 8 * st, (i / STAGES) & 1);
    if (Src::GENERIC_WRITES) fence_proxy_async();
    const uint32_t k_s = ring + st * M::STAGE, v_s = k_s + M::K;

    // S = Q K^T: 64 rows x KN keys
    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk & 3) * 32;   // 16 dims of a swizzle atom
      const uint64_t dq =
          sw128_desc(q_w + (kk >> 2) * M::Q_HALF + off, 16, 1024);
      const uint64_t dk =
          sw128_desc(k_s + (kk >> 2) * M::KV_HALF + off, 16, 1024);
      wgmma_ss(s, dq, dk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // softcap, mask; online softmax per row. The max is taken on the raw
    // logits and each p is one FFMA and one ex2: exp2(s * mul - m * mul),
    // base 2 with log2(e) folded into mul. A tile whose every key each
    // row sees needs no mask: its dead rows (past R, padding queries) are
    // never written.
    const int t0 = src.k0 + i * KN;
    if (src.softcap > 0.0f) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
        s[j] = tanhf(s[j] * src.sm_scale / src.softcap) * src.softcap;
    }
    const float mul = src.softcap > 0.0f ? LOG2E : src.sm_scale * LOG2E;
    float mx[2] = {-INFINITY, -INFINITY};
    const bool clear = src.tile_clear(t0, KN);
    if (clear) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int h = (j >> 1) & 1;
        const int tpos = t0 + (j >> 2) * 8 + 2 * t4 + (j & 1);
        const float x = (!ok[h] || tpos >= src.k_end) ? -INFINITY
                        : src.sees(tpos, qp[h])      ? s[j]
                        : Src::FINITE_MASK           ? -1e30f
                                                     : -INFINITY;
        s[j] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2], sum[2] = {0.0f, 0.0f}, mm[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_row[h], mx[h]);
      alpha[h] = m_new == -INFINITY ? 1.0f
                                    : ex2((m_row[h] - m_new) * mul);
      m_row[h] = m_new;
      mm[h] = m_new == -INFINITY ? 0.0f : m_new;
    }
    if (clear) {
#pragma unroll
      for (int h = 0; h < 2; ++h) mm[h] *= mul;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int h = (j >> 1) & 1;
        const float p = ex2(fmaf(s[j], mul, -mm[h]));
        s[j] = p;
        sum[h] += p;
      }
    } else {
      // subtract first: a row whose keys are all the finite mask has
      // s == m, and p must be exactly 1 (exp2(-inf) = 0 for -inf masks)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int h = (j >> 1) & 1;
        const float p = ex2((s[j] - mm[h]) * mul);
        s[j] = p;
        sum[h] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_row[h] = l_row[h] * alpha[h] + sum[h];
    // once the row maxima settle, most tiles leave them alone
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] *= alpha[(j >> 1) & 1];
    }
    // P as bf16 A fragments: key columns 16kk .. 16kk + 15 are the
    // accumulator groups 2kk and 2kk + 1
    uint32_t pf[KN / 16][4];
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pf[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    }

    // O += P V: 16 keys a step, V MN-major (dims contiguous)
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      const uint64_t dv = sw128_desc(v_s + kk * 16 * ROW_BYTES, M::KV_HALF,
                                     1024);
      wgmma_rs(o, pf[kk], dv);   // N = HD, by the size of o
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + st));   // stage free
  }

  // epilogue: full row sums across the quad; normalise; write bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 1);
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= src.R) continue;
    const float inv = (ok[h] && l_row[h] > 0.0f) ? 1.0f / l_row[h] : 0.0f;
    __nv_bfloat16* orow = src.out_row(r);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store_pair(orow, j * 8 + 2 * t4, HD, o[4 * j + 2 * h] * inv,
                 o[4 * j + 2 * h + 1] * inv);
  }
}

// The block's whole walk. `base` is 1024-byte aligned shared memory of
// Smem<HD>::bytes() - 1024 bytes. Src provides:
//   LOADERS          producer threads that load (and arrive on a full
//                    barrier: 1 for TMA, 128 for cp.async);
//   GENERIC_WRITES   loads land through the generic proxy (cp.async);
//   R, k0, n_tiles, k_end   live rows; tile i holds keys k0 + KN i ..;
//                    keys >= k_end are past the walk;
//   sm_scale, softcap   the logits' scale and tanh cap (0: none);
//   FINITE_MASK      a key a row may not see is -1e30 (else -inf);
//   load_q(dst, q_half, rows, bar, ptid), load_kv(t0, k_dst, v_dst, bar,
//                    ptid)   start the copies, arrange the arrival;
//   finish(ptid)     a loader's last act;
//   row_ok(r), qpos(r), sees(tpos, qpos), out_row(r);
//   tile_clear(t0, n)  every key t0 .. t0 + n - 1 is before k_end and seen by
//                    every row of the block (no mask needed).
template <int HD, class Src>
__device__ __forceinline__ void attend(const Src& src, uint8_t* base) {
  using M = Smem<HD>;
  static_assert(HD == 64 || HD == 128, "wgmma walk: hd 64 or 128");
  const uint32_t q_s = smem_u32(base), ring = q_s + M::Q,
                 bars = q_s + M::BARS;
  // bars: full[0, STAGES), empty[STAGES, 2 STAGES), then Q's
  if (threadIdx.x == 0) {
    const int nc = (src.R + 63) / 64;   // consumer warpgroups with rows
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, Src::LOADERS);
      mbar_init(bars + 8 * (STAGES + s), 4 * nc);
    }
    mbar_init(bars + 16 * STAGES, Src::LOADERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    // producer warpgroup: its paths never rejoin the consumers'
    setmaxnreg_dec<PRODUCER_REGS>();
    const int ptid = threadIdx.x - 256;
    if (ptid >= Src::LOADERS) return;
    src.load_q(q_s, M::Q_HALF, ROWS, bars + 16 * STAGES, ptid);
    for (int i = 0; i < src.n_tiles; ++i) {
      const int st = i % STAGES;
      mbar_wait(bars + 8 * (STAGES + st), ((i / STAGES) & 1) ^ 1);
      const uint32_t k_s = ring + st * M::STAGE;
      src.load_kv(src.k0 + i * KN, k_s, k_s + M::K, bars + 8 * st, ptid);
    }
    src.finish(ptid);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<HD>(src, q_s, ring, bars);
  }
}

// Host check of a tile plan (kernels/tiles.py): BQ queries a block, at
// most 128 rows, and n_qt tiles that cover the Sq queries.
inline bool plan_ok(int Sq, int G, int BQ, int n_qt) {
  return BQ >= 1 && BQ * G <= 128 && n_qt >= 1 &&
         (long long)n_qt * BQ >= Sq && (long long)(n_qt - 1) * BQ < Sq;
}

// Block rank -> (query tile, sequence, kv head), the last tile first.
__device__ __forceinline__ void block_coords(int n_qt, int B, int KV, int& qt,
                                             int& b, int& kvh) {
  const int idx = blockIdx.x;
  kvh = idx % KV;
  b = (idx / KV) % B;
  qt = n_qt - 1 - idx / (KV * B);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

}  // namespace wg
}  // namespace pa
