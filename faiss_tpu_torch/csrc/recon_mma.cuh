// The tensor-core scan shared by the recon kernels K2 (ivf_recon.cu) and
// K7 (recon_floor.cu): the keys
//     key(r, s) = n2[s] - 2 * q_r . (y_hi[:, s] + y_lo[:, s])  (+ pen)
// of a block's BM = 64 float32 queries against a walk of column tiles of a
// transposed bf16 store (one plane, or hi and lo), handed tile by tile to
// an epilogue policy: K2 offers them to the exact top-128 select of
// tile_select.cuh (TopK), K7 keeps per-lane running minima (recon_floor.cu).
// K1 (ivf_recon_dyn.cu) has its own scan, on wgmma (recon_wgmma.cuh), and
// takes from here the worklist walk (dyn_block, ListWalk, shared with K5),
// the launch's operands and TMA descriptors, and the barrier helpers.
//
// Arithmetic: the TPU kernels' (faiss_tpu/ops/pallas_knn.py:920-946). The
// prologue splits each float32 query into bf16 hi = bf16(q) and lo =
// bf16(q - hi), and the products run on the tensor cores in bf16 with
// float32 accumulators: qh.yh + ql.yh + qh.yl with two planes (the ql.yl
// term, below 2^-16 |q| |y|, is dropped), qh.y + ql.y with one.
//
// Data flow. One producer warp streams the store's tiles, [KC = 64 dims,
// BN = 64 columns] of each plane, by TMA into a ring of STAGES stages (the
// 128-byte swizzle: chunk c of row r at c ^ (r & 7), which ldmatrix reads
// without bank conflicts), with each tile's n2 beside its last stage; a
// "full" mbarrier per stage says the bytes landed, an "empty" one that the 8
// consumer warps are done with them, so the consumers are never held at a
// block-wide barrier and drift by up to STAGES - 1 stages. The queries' hi
// and lo planes stay in shared memory (128 dims at a time; a wider d_pad
// reloads its next 128 dims per tile, the one point where the consumers
// meet). Consumer warp w owns query rows 16 (w % 4) .. + 16 and columns
// 32 (w / 4) .. + 32 of a tile: per 16 dims one ldmatrix of each query
// plane, ldmatrix.trans of the store (it is MN-major: columns contiguous)
// and mma.sync.m16n8k16 bf16 products into 16 float32 accumulators a
// thread, at the places acc_row() and acc_col() name. Columns past the
// walk's valid range arrive as zeros and their n2 counts as +inf; query
// rows past the block's are zero and never reported.
//
// The epilogue policy. scan() is a template on a class Epi that owns what
// follows the products: its shared memory (Epi::kBytes, placed after the
// query planes), init() by every thread before the first tile, tile() by
// each consumer thread on its accumulators once a tile's last stage is in
// them, and finish() by the consumer threads after the last tile. A policy
// rather than a second scan, so that the ring, the mbarriers, the
// producer, the query reloads and the products exist once for both
// kernels.
// TopK: the epilogue adds n2 and, with a penalty, the bias term; a key
// below the query's threshold goes to the select, which the two warps of
// the rows compact between tiles (a 64-thread named barrier), never the
// block.
//
// Why mma.sync and not wgmma, for K2 and K7 only: a block holds 64
// queries' selects (128 KB) beside the queries and the ring, so one block
// runs per SM, and between the products its warps run the epilogue and the
// select. A wgmma tile is 64 rows by a warpgroup; with one warpgroup, its 4
// warps run the epilogue and select alone, and on the H100 that was slower
// than 8 warps of mma.sync, whose epilogues and selects overlap the other
// warps' products. K1 took the other way out (recon_wgmma.cuh): two
// warpgroups on the same 64 rows, taking alternate tiles, so that one's
// products overlap the other's epilogue; 2.1-2.5x faster at Deep10M's
// shape on the H100 (PERF.md). K2 and K7 could follow it; K7 runs two
// blocks an SM on its lane minima, which that design does not allow.
//
// Shared memory per block (bytes): the ring 4 stages x 8,192 per plane
// (65,536 with two planes, 32,768 with one) and 4 x 256 of n2; the queries
// 2 planes x 64 x 128 x 2 = 32,768; the policy's (TopK: the select, 64
// queries x 256 pairs x 8 = 131,072 + 512 for counts and thresholds, 2 KB
// per query; K7: its lane minima, 34,816); 8 mbarriers. With TopK 230,976
// / 198,208 in all, of the 232,448 a block may have: one block of 9 warps
// per SM; K7 101,440, two blocks per SM.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <stdio.h>

#include "tile_select.cuh"

namespace recon_mma {

constexpr int K = 128;        // top-K width of the contract
constexpr int BM = 64;        // queries per block
constexpr int BN = 64;        // columns per tile
constexpr int KC = 64;        // dims per ring stage
constexpr int QSEG = 128;     // query dims resident in shared memory
constexpr int STAGES = 4;     // ring depth
constexpr int WN = 2;         // consumer warps per 16 query rows
constexpr int CONSUMERS = 32 * 4 * WN;  // 8 consumer warps
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int NT = BN / WN / 8;  // 8-column mma tiles of a warp
constexpr int CAP = 256;      // select pairs per query

using Select = tile_select::Select<BM, CAP, BN>;

constexpr int kQPlane = BM * QSEG * 2;   // one query plane, bf16
constexpr int kYPlane = KC * BN * 2;     // one store plane of a stage, bf16

// Shared memory, in this order: the ring's store planes (STAGES x planes x
// kYPlane, each 1024-byte aligned for the 128-byte swizzle), the ring's n2
// (STAGES x BN floats), the query planes, the epilogue policy's bytes
// (TopK's select by default), the full and empty mbarriers.
__host__ __device__ constexpr int ring_bytes(bool hilo) {
  return STAGES * (hilo ? 2 : 1) * kYPlane;
}

__host__ __device__ constexpr int smem_bytes(bool hilo, int epi_bytes = Select::kBytes) {
  return ring_bytes(hilo) + STAGES * BN * 4 + 2 * kQPlane + epi_bytes +
         2 * STAGES * 8;
}

// The TMA descriptors of a launch: the store planes as 2-D tensors [d_pad
// rows, S columns] (row stride ld), boxes of KC rows x BN columns with the
// 128-byte swizzle, and n2 as a 2-D tensor [1, S] in boxes of BN. Columns
// past S arrive as zeros. A kernel parameter (__grid_constant__).
struct alignas(64) Maps {
  CUtensorMap hi, lo, n2;
};

// The operands of one launch. okey/oslot are the rows' outputs (or a
// split's part of the scratch); ofloor is null for a split's part. K7
// writes its lane minima to okey and reads no other output or bias.
struct Args {
  const float* xq;             // [nq, d_pad] float32
  const float* biasg;          // [nq, nbias] or null
  const int* lid;              // [S] or null
  float* okey;
  int* oslot;
  float* ofloor;
  int d_pad;
  int nbias;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// The barrier completes its phase when `bytes` have arrived by TMA.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One of the barrier's arrivals (the empty barriers count the consumers).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the barrier's phase `parity`; a wait that never ends (a copy
// that never lands) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  for (unsigned spins = 0;; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// TMA: the box of `map` at (c0 innermost, c1) into shared memory at dst,
// completing on barrier bar.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Dims [k0, k0 + QSEG) of the block's `rows` queries from row q0, split into
// bf16 hi and lo planes [BM][QSEG] (chunk c of row r at c ^ (r & 7)), by
// the first `nthreads` threads; rows past `rows` are zero.
__device__ void load_queries(const Args& a, long long q0, int rows, int k0,
                             unsigned char* qs, int nthreads) {
  constexpr int CH = QSEG / 8;  // 16-byte chunks of a plane row
  for (int i = threadIdx.x; i < BM * CH; i += nthreads) {
    const int r = i / CH, c = i % CH;
    float x[8];
    if (r < rows) {
      const float4* src = reinterpret_cast<const float4*>(
          a.xq + (q0 + r) * a.d_pad + k0 + c * 8);
      const float4 u = src[0], v = src[1];
      x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
      x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    uint4 hi, lo;
    uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 hb = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
      const float2 hf = __bfloat1622float2(hb);
      h[e] = *reinterpret_cast<const uint32_t*>(&hb);
      l[e] = pack_bf16(x[2 * e] - hf.x, x[2 * e + 1] - hf.y);
    }
    const int off = r * (QSEG * 2) + ((c ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(qs + off) = hi;
    *reinterpret_cast<uint4*>(qs + kQPlane + off) = lo;
  }
}

// Where products() puts a thread's accumulators: acc[nt][2 h + e] is query
// row acc_row() + 8 h of the block and column acc_col() + 8 nt + e of the
// tile (PTX's m16n8 accumulator layout: lane l holds row l / 4 and columns
// 2 (l % 4) + {0, 1} of its n-tile, elements 2 and 3 eight rows below).
__device__ __forceinline__ int acc_row() {
  return 16 * ((threadIdx.x >> 5) % 4) + ((threadIdx.x & 31) >> 2);
}

__device__ __forceinline__ int acc_col() {
  return ((threadIdx.x >> 5) / 4) * (BN / WN) + 2 * (threadIdx.x & 3);
}

// Ring stage of unit u = (tile u / nkc, dims (u % nkc) * KC), by one
// thread: one TMA box per plane (row r of the box at r * 128 bytes, its
// 16-byte chunk c at c ^ (r & 7)), and with the tile's last unit its n2.
template <bool HILO, class Walk>
__device__ __forceinline__ void issue(const Maps& maps, const Walk& w, int u,
                                      int nkc, unsigned char* stage,
                                      unsigned char* n2s, uint32_t bar) {
  const int t = u / nkc, kc = u % nkc;
  const int col = static_cast<int>(w.col(t));
  const bool last = kc == nkc - 1;
  mbar_expect(bar, (HILO ? 2 : 1) * kYPlane + (last ? BN * 4 : 0));
  tma_2d(smem_u32(stage), &maps.hi, col, kc * KC, bar);
  if constexpr (HILO) tma_2d(smem_u32(stage + kYPlane), &maps.lo, col, kc * KC, bar);
  if (last) tma_2d(smem_u32(n2s), &maps.n2, col, 0, bar);
}

// The warp's 16 rows x BN / WN columns over the stage's KC dims; kq0 is the
// stage's first dim within the resident query segment.
template <bool HILO>
__device__ __forceinline__ void products(const unsigned char* qs,
                                         const unsigned char* stage, int kq0,
                                         float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = lane >> 3;  // the 8x8 matrix this lane addresses
  const int arow = 16 * (warp % 4) + ((m & 1) << 3) + (lane & 7);
  const int nt0 = (warp / 4) * NT;  // the warp's first 8-column tile
  const uint32_t qh = smem_u32(qs), yh = smem_u32(stage);
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    uint32_t ah[4], al[4];
    const int ac = ((kq0 + kk) >> 3) + (m >> 1);
    const uint32_t aoff = arow * (QSEG * 2) + ((ac ^ (arow & 7)) << 4);
    ldsm_x4(qh + aoff, ah);
    ldsm_x4(qh + kQPlane + aoff, al);
    const int br = kk + ((m & 1) << 3) + (lane & 7);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      const int bc = nt0 + 2 * p + (m >> 1);
      const uint32_t boff = br * (BN * 2) + ((bc ^ (br & 7)) << 4);
      uint32_t bh[4];
      ldsm_x4_t(yh + boff, bh);
      mma(acc[2 * p], ah, bh[0], bh[1]);
      mma(acc[2 * p + 1], ah, bh[2], bh[3]);
      mma(acc[2 * p], al, bh[0], bh[1]);
      mma(acc[2 * p + 1], al, bh[2], bh[3]);
      if constexpr (HILO) {
        uint32_t bl[4];
        ldsm_x4_t(yh + kYPlane + boff, bl);
        mma(acc[2 * p], ah, bl[0], bl[1]);
        mma(acc[2 * p + 1], ah, bl[2], bl[3]);
      }
    }
  }
}

// The smallest bias of rows q0 + r0 and q0 + r0 + 8 in column group `grp`
// (128 columns), by the 4 lanes of a quad; +inf for rows past `rows`.
__device__ __forceinline__ void bias_floor(const Args& a, long long q0,
                                           int rows, int r0, int grp,
                                           float (&pmin)[2]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    float v = CUDART_INF_F;
    if (r < rows) {
      const float4* b = reinterpret_cast<const float4*>(
          a.biasg + (q0 + r) * a.nbias + static_cast<long long>(grp) * K + tq * 32);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x = b[i];
        v = fminf(v, fminf(fminf(x.x, x.y), fminf(x.z, x.w)));
      }
    }
    v = fminf(v, __shfl_xor_sync(tile_select::kFull, v, 1));
    v = fminf(v, __shfl_xor_sync(tile_select::kFull, v, 2));
    pmin[h] = v;
  }
}

// Keys of the warp's rows over its columns of tile t, offered to the
// select; then the two warps of the rows make room in their queues for the
// next tile. Two 64-thread barriers of the rows' warps keep offers and
// compactions apart. A row whose smallest key misses its threshold offers
// nothing. With PEN (tiles hold BN valid columns there), where the warp's
// columns all belong to one list, each row's bias is read once; otherwise
// a key whose bias-free value plus the row's smallest bias in the tile's
// group already misses the threshold is dropped before its bias is read:
// the rounded sum is monotone in the bias, so both are exact.
template <bool PEN, class Walk>
__device__ __forceinline__ void epilogue(const Args& a, const Walk& w, int t,
                                         const float* n2s, Select& sel,
                                         const float (&acc)[NT][4], long long q0,
                                         int rows, int& grp, float (&pmin)[2]) {
  const int warp = threadIdx.x >> 5;
  const int r0 = acc_row();
  const int c0 = acc_col();  // the thread's first column
  const long long col = w.col(t);
  const int nval = w.valid(t);
  // the other warp of these rows is done compacting after the last tile
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + warp % 4), "n"(32 * WN));
  int lids[2 * NT];
  bool one_list = false;
  float pen[2] = {0.f, 0.f};
  if constexpr (PEN) {
    const int g = w.group(t);
    if (g != grp) {
      bias_floor(a, q0, rows, r0, g, pmin);
      grp = g;
    }
    bool same = true;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int2 l = __ldg(reinterpret_cast<const int2*>(a.lid + col + c0 + nt * 8));
      lids[2 * nt] = l.x;
      lids[2 * nt + 1] = l.y;
    }
    const int first = __shfl_sync(tile_select::kFull, lids[0], 0);
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) same = same && lids[i] == first;
    one_list = __all_sync(tile_select::kFull, same);
    if (one_list) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        pen[h] = r < rows ? a.biasg[(q0 + r) * a.nbias +
                                    static_cast<long long>(grp) * K + first]
                          : 0.f;
      }
    }
  }
  float n2v[2 * NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 nn = *reinterpret_cast<const float2*>(n2s + c0 + nt * 8);
    n2v[2 * nt] = c0 + nt * 8 < nval ? nn.x : CUDART_INF_F;
    n2v[2 * nt + 1] = c0 + nt * 8 + 1 < nval ? nn.y : CUDART_INF_F;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const float thr = r < rows ? sel.thr[r] : -CUDART_INF_F;
    const float gate = one_list ? pen[h] : pmin[h];  // 0 without PEN
    float k[2 * NT];
    float kmin = CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {
      k[i] = n2v[i] - 2.f * acc[i / 2][2 * h + i % 2];
      kmin = fminf(kmin, k[i]);
    }
    if (PEN ? !(kmin + gate < thr) : !(kmin < thr)) continue;
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {
      const int s = static_cast<int>(col + c0 + (i / 2) * 8 + i % 2);
      float key = k[i];
      if constexpr (PEN) {
        if (one_list) {
          key += pen[h];
        } else {
          if (!(key + pmin[h] < thr)) continue;
          key += a.biasg[(q0 + r) * a.nbias + static_cast<long long>(grp) * K +
                         lids[i]];
        }
      }
      if (key < thr) sel.offer(r, key, s);
    }
  }
  // both warps of these rows have offered: each compacts 16 / WN of them
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + warp % 4), "n"(32 * WN));
  sel.make_room(16 * (warp % 4) + (warp / 4) * (16 / WN), 16 / WN);
}

// The exact top-128 (K2): the epilogue policy that offers each tile's
// keys to the select and writes each query's top-128 to row q0 + r of
// okey/oslot (and ofloor). PEN: the masked mode.
template <bool PEN>
struct TopK {
  static constexpr int kBytes = Select::kBytes;
  Select sel;
  int grp = -1;                // the bias group pmin holds
  float pmin[2] = {0.f, 0.f};  // the rows' smallest bias in it
  __device__ explicit TopK(unsigned char* smem) : sel(smem) {}
  __device__ void init() { sel.init(THREADS); }
  template <class Walk>
  __device__ __forceinline__ void tile(const Args& a, const Walk& w, int t,
                                       const float* n2s, const float (&acc)[NT][4],
                                       long long q0, int rows) {
    epilogue<PEN>(a, w, t, n2s, sel, acc, q0, rows, grp, pmin);
  }
  // each warp's rows took their last offers before the pair's last barrier
  __device__ void finish(const Args& a, long long q0, int rows) {
    const int warp = threadIdx.x >> 5;
    for (int i = 0; i < 16 / WN; ++i) {
      const int r = 16 * (warp % 4) + (warp / 4) * (16 / WN) + i;
      if (r >= rows) break;
      float k[4];
      int s[4];
      sel.result(r, k, s);
      const long long o = (q0 + r) * K;
      tile_select::write_row(k, s, a.okey + o, a.oslot + o,
                             a.ofloor ? a.ofloor + o : nullptr);
    }
  }
};

// The block's scan: `rows` queries from row q0 over the walk's tiles, each
// tile's accumulators handed to the epilogue policy Epi (see the top of
// this file), then Epi's finish. Walk: ntiles, col(t), valid(t) and, for
// a penalized TopK, group(t). Every thread of the block enters; the
// producer warp returns once it has issued the last tile.
template <bool HILO, class Epi, class Walk>
__device__ void scan(const Args& a, const Maps& maps, const Walk& w,
                     long long q0, int rows) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* n2ring = ring + ring_bytes(HILO);
  unsigned char* qs = n2ring + STAGES * BN * 4;
  Epi epi(qs + 2 * kQPlane);
  const uint32_t full = smem_u32(qs + 2 * kQPlane + Epi::kBytes);
  const uint32_t empty = full + 8 * STAGES;
  constexpr int SB = (HILO ? 2 : 1) * kYPlane;
  const int nkc = a.d_pad / KC;
  constexpr int kps = QSEG / KC;  // stages per resident query segment
  const bool reload = a.d_pad > QSEG;
  const int n = w.ntiles * nkc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * WN);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  epi.init();
  if (!reload) load_queries(a, q0, rows, 0, qs, THREADS);
  __syncthreads();

  if (warp == 4 * WN) {  // the producer
    if (lane == 0) {
      for (int u = 0; u < n; ++u) {
        const int slot = u % STAGES;
        if (u >= STAGES) mbar_wait(empty + 8 * slot, (u / STAGES - 1) & 1);
        issue<HILO>(maps, w, u, nkc, ring + slot * SB, n2ring + slot * BN * 4,
                    full + 8 * slot);
      }
    }
    return;
  }
  float acc[NT][4];
  for (int u = 0; u < n; ++u) {
    const int slot = u % STAGES;
    const int kc = u % nkc;
    if (reload && kc % kps == 0) {  // every consumer is past the old dims
      asm volatile("bar.sync 5, %0;\n" ::"n"(CONSUMERS));
      load_queries(a, q0, rows, kc * KC, qs, CONSUMERS);
      asm volatile("bar.sync 5, %0;\n" ::"n"(CONSUMERS));
    }
    mbar_wait(full + 8 * slot, (u / STAGES) & 1);
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    products<HILO>(qs, ring + slot * SB, (kc % kps) * KC, acc);
    if (kc == nkc - 1) {
      epi.tile(a, w, u / nkc, reinterpret_cast<const float*>(n2ring + slot * BN * 4),
               acc, q0, rows);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  }
  epi.finish(a, q0, rows);
}

// A block of a worklist scan (K1, and K5 in adc_mma.cuh): block b is
// sub-block b % subs (bm queries each) of query tile (b / subs) % ntq,
// over split b / (subs * ntq) of the tile's worklist steps. A worklist
// lists its tile's probed chunks and fills the steps after them with the
// PAD chunk, the store's last chunk, whose n2 is +inf: its keys are never
// kept. So the block first finds the tile's last step that is not the PAD
// chunk (reduced by the whole block through the int at `slot` in shared
// memory, free again on return) and splits only the steps up to it; the
// first block of a tile counts the steps skipped into `skipped` when given.
struct DynBlock {
  const int* work;  // the tile's worklist
  int s0, s1;       // the split's steps [s0, s1)
  long long q0;     // the block's first query row
  int rows;         // its queries: bm, fewer in a tile of qt < bm
  int p;            // its split
};

__device__ DynBlock dyn_block(const int* cmap, int msteps, int qt, int pad_chunk,
                              int subs, int ntq, int bm, int* slot,
                              unsigned long long* skipped) {
  DynBlock b;
  const int sub = blockIdx.x % subs;
  const int tile = (blockIdx.x / subs) % ntq;
  const int splits = gridDim.x / (subs * ntq);
  b.p = blockIdx.x / (subs * ntq);
  b.work = cmap + static_cast<long long>(tile) * msteps;
  if (threadIdx.x == 0) *slot = -1;
  __syncthreads();
  int mine = -1;
  for (int j = threadIdx.x; j < msteps; j += blockDim.x) {
    if (__ldg(b.work + j) != pad_chunk) mine = j;
  }
  if (mine >= 0) atomicMax(slot, mine);
  __syncthreads();
  const int real = *slot + 1;  // steps up to the last non-PAD one
  __syncthreads();
  if (skipped != nullptr && b.p == 0 && sub == 0 && threadIdx.x == 0) {
    atomicAdd(skipped, static_cast<unsigned long long>(msteps - real));
  }
  b.s0 = static_cast<int>(static_cast<long long>(real) * b.p / splits);
  b.s1 = static_cast<int>(static_cast<long long>(real) * (b.p + 1) / splits);
  b.q0 = static_cast<long long>(tile) * qt + sub * bm;
  b.rows = qt - sub * bm < bm ? qt - sub * bm : bm;
  return b;
}

// The tiles of a block's worklist steps [s0, s0 + ntiles / tpc), tpc tiles
// of TBN columns a chunk of ct (K1: recon_wgmma's BN; K5: adc_mma's).
template <int TBN>
struct ListWalk {
  const int* work;
  const int* cgroup;
  int s0, ntiles, tpc, ct;
  __device__ ListWalk(const DynBlock& b, const int* cg, int chunk_cols)
      : work(b.work), cgroup(cg), s0(b.s0), ntiles((b.s1 - b.s0) * (chunk_cols / TBN)),
        tpc(chunk_cols / TBN), ct(chunk_cols) {}
  __device__ int chunk(int t) const { return __ldg(work + s0 + t / tpc); }
  __device__ long long col(int t) const {
    return static_cast<long long>(chunk(t)) * ct + (t % tpc) * TBN;
  }
  __device__ int valid(int) const { return TBN; }
  __device__ int group(int t) const { return __ldg(cgroup + chunk(t)); }
};

// Host: the launch's TMA descriptors (yT_lo may be null). Returns 0 or a
// CUDA error code.
inline int make_maps(Maps* m, const void* yT, const void* yT_lo, long long ld,
                     const void* n2, long long S, int d_pad) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || fn == nullptr) {
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorNotSupported);
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(d_pad)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {BN, KC};
  const cuuint32_t one[2] = {1, 1};
  const void* planes[2] = {yT, yT_lo != nullptr ? yT_lo : yT};
  CUtensorMap* maps[2] = {&m->hi, &m->lo};
  for (int i = 0; i < 2; ++i) {
    const CUresult r = encode(
        maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(planes[i]),
        dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) {
      fprintf(stderr, "recon_mma: TMA descriptor of store plane %d: error %d\n", i,
              static_cast<int>(r));
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cuuint64_t n2dim[2] = {static_cast<cuuint64_t>(S), 1};
  const cuuint64_t n2stride[1] = {static_cast<cuuint64_t>((S * 4 + 15) / 16 * 16)};
  const cuuint32_t n2box[2] = {BN, 1};
  const CUresult r = encode(
      &m->n2, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(n2), n2dim,
      n2stride, n2box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "recon_mma: TMA descriptor of n2: error %d\n", static_cast<int>(r));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace recon_mma
