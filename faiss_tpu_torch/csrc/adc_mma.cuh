// The 4-bit ADC scan on the tensor cores, for sm_90a: K4 and K5
// (ivfpq_adc.cu) and K6 (ivfpq_v3.cu, over the codes its decode pass reads
// from the one-hot). For every query row r the EXACT top-128 of, by mode,
//     MODE_K4:      key(s) = (lsum(r, s) + n2[s]) + bias(r, s)
//     MODE_V3:      key(s) = lsum(r, s) + (bias(r, s) + n2[s])
//     MODE_V3_INT8: key(s) = (a * isum(r, s) + c) + (bias(r, s) + n2[s])
// with lsum the float32 sum of the bf16 entries luts[r, m * ksub +
// codesT[m, s]] over m, isum the int32 sum of the int8 entries, (a, c) the
// row's meta at the slot's lane s % 128, and bias(r, s) = biasg[r, g * 128
// + lid[s]], g = min(chunk / cpg, G - 1) (K6's groups, chunk / cpg with
// nchunks a multiple of G, are the same), over one split of the columns,
// offered to the select of tile_select.cuh. K5 runs MODE_K4 over the chunks
// of each query tile's worklist instead, with g = cgroup[chunk]: the scan
// is a template on its Walk (ntiles, col(t), group(t)), Walk below for K4
// and K6, recon_mma::ListWalk for K5 (ivfpq_adc.cu), whose blocks split
// each tile's worklist steps as K1's do (recon_mma::dyn_block: the trailing
// PAD steps skipped, the splits merged by tile_select::merge_splits).
//
// Arithmetic: the TPU kernels' (faiss_tpu/ops/pallas_knn.py:373-380 for
// K4, :713-732 for K6). The LUT sum is a contraction of the LUTs with a
// one-hot of the codes. bf16: per sub-quantizer m one
// mma.sync.m16n8k16 bf16 k-step, whose 16 k rows are the 16 entries of m
// (zero past ksub, which no code < ksub selects), into float32
// accumulators. Every product is a bf16 LUT entry times 1 or 0, so each
// k-step adds exactly one entry: the sum is the float32 sum of the M
// entries in the order m = 0, 1, ..., as the plain versions' products
// compute it up to the order of their additions. Then n2 and the coarse
// bias (one float per query and list) are added in float32 in the mode's
// order: K4 the TPU kernel's ip + n2 + bias (the TPU adds the bias through
// a second contraction as bf16 hi + lo, which this port does not need), K6
// its ip + (bias + n2). int8 (K6): per pair of sub-quantizers (2m, 2m + 1)
// one mma.sync.m16n8k32 s8 k-step, whose 32 k rows are the 16 entries of
// each (a zero sub-quantizer after an odd M), into int32 accumulators: the
// sum is exact. Right after a tile's products each thread dequantizes its
// 64 sums once, a * float(acc) and + c rounded on their own (no fused
// multiply-add), as the plain version does; the epilogue then adds (bias +
// n2) as for bf16. (Dequantizing per key in the gates and offers, with a
// per-key test for rows whose (a, c) vary by lane, made int8 slower than
// bf16 on the H100.)
//
// Operands of a k-step. A (16 queries x 16 bf16 or 32 int8 entries) comes
// from the block's LUT rows in shared memory by ldmatrix: an 8 x 8 b16
// matrix is 8 rows of 16 bytes either way, so the lane addresses are the
// same in both modes. B (the one-hot of 8 slots' codes, 16 or 32 x 8) is
// built in registers. bf16: in the m16n8k16 B fragment lane l holds column
// n = l / 4 at k rows 2 (l % 4) + {0, 1} (register b0) and 2 (l % 4) +
// {8, 9} (b1), each register two packed bf16, the lower k in the low half.
// With c the column's code and d = 16 (c - 2 (l % 4)), b0 = 0x3F80 << d and
// b1 = 0x3F80 << (d - 128) as unsigned shifts, which PTX clamps at 32 (the
// result is 0 unless the code is one of the lane's two rows; 0x3F80 is bf16
// 1.0): one byte permute, two multiply-adds and two shifts per fragment
// register pair. int8: in the m16n8k32 s8 B fragment lane l holds column
// l / 4 at k rows 4 (l % 4) + {0..3} (b0, the entries of sub-quantizer 2m)
// and 16 + 4 (l % 4) + {0..3} (b1, of 2m + 1), four bytes each, so b0 =
// 1 << (8 c_2m - 32 (l % 4)) and b1 likewise from c_2m+1, PTX's clamped
// shift again: one byte permute and one shift per register.
//
// Layout. A block serves BM = 64 queries with two teams of 4 warps, which
// take turns at the 128-column tiles (team k takes tiles t = k mod 2), so
// that each SM sub-partition runs one warp of each and one team's products
// overlap the other's epilogue. A warp owns all 64 query rows (4 row blocks
// of 16) and 32 columns (4 mma n-tiles) of its team's tile, so a one-hot
// fragment, built once, feeds the mmas of 4 row blocks, and an ldmatrix of
// the LUTs feeds 4 n-tiles: per k-step a warp runs 16 mmas on 4
// ldmatrix.x4 (2 KB of shared memory, 128 bytes an mma), 4 fragment builds
// and one (int8: two) 32-bit loads of codes; the other team's warp on the
// same sub-partition covers their latency (loading the next k-step's
// fragments ahead, in registers, was no faster). The columns of n-tile t
// are the slots 4 n + t (n < 8) of the warp's 32, so lane l's codes for
// its 4 n-tiles are the 4 bytes of one word (slots 4 (l / 4) .. + 4), and
// its accumulators hold 8 consecutive slots, 8 (l % 4) .. + 8, of each of
// its 8 query rows. A LUT row is 32 bytes a k-step plus 16 bytes of pad,
// an odd number of 16-byte chunks, so the 8 rows an ldmatrix matrix reads
// fall in 8 different bank groups. PQ32x4fs takes 32 bf16 k-steps a tile,
// or 16 int8 k-steps, each at up to twice the bf16 rate.
//
// Data flow: a tile's codes [M, BN], n2 [BN] and lid [BN] are M + 8 bytes
// a slot, read by every query block, mostly from L2. They arrive by TMA in a
// ring of STAGES stages, each with a "full" mbarrier that completes when its
// three boxes landed; one thread issues a tile's three boxes, so no thread
// spends instructions on addresses (the pattern of recon_mma.cuh, whose
// helpers this header uses). There is no producer warp: the first thread
// fills the ring, and once a team has passed its first barrier in a tile's
// epilogue every one of its warps is done with the stage, so its first
// thread refills it with tile t + STAGES. A ninth warp would cost
// registers: the register file is split per sub-partition, and 3 warps on
// one would cap every thread at 168 registers, below the ~225 the products
// and epilogue hold.
//
// Epilogue and select. ct is a multiple of BN on every caller, so a tile
// lies in one chunk and its bias group g is one value. When a tile arrives a
// thread reads its 8 columns' n2 and list ids and, where they lie in one
// list (lists average ~256 slots), each of its rows' bias for that list, so
// the loads from global memory complete under the products; otherwise a key
// takes its bias from biasg in the epilogue, and the row's gate uses its
// smallest bias in g. Two lower bounds gate a row before any key is
// offered: the row's LUT floor plus the smallest n2 and the gate's bias,
// and then its smallest key with the gate's bias in the place of each
// key's (where the 8 columns share a list, the smallest key itself), each
// summed in the mode's order. The LUT floor is, for bf16, the smallest
// entry of each sub-quantizer, summed, less a margin for rounding
// (computed once per block), and for int8 the exact int32 sum of the
// smallest entries, dequantized as a key is: a > 0, so a * floor + c
// bounds a * acc + c. A row whose bound misses its threshold offers
// nothing: every rounded sum is monotone in its terms, so the gates are
// exact. On K4's paths the bias is 1e9 on every unprobed list, so once a
// row's threshold falls below those keys the LUT floor alone closes it.
//
// int8 meta. The contract reads (a, c) at each slot's lane, but 64 rows x
// 256 floats do not fit beside the select. So the prologue marks a row
// uniform when its 128 a's are equal, its 128 c's are equal and a is
// positive and finite, as quantize_luts_int8 makes every row; a uniform
// row keeps its (a, c) in shared memory (512 bytes a block) and is gated.
// Any other row reads a and c at each key's lane from device memory and is
// never gated: slow, but exact.
//
// The select is tile_select::Select<64, 256, 64> (2 KB a query). A team
// offers a tile in two phases of 64 columns (its warps 0-1, then 2-3), each
// followed by its compactions (make_room, one warp per 16 rows), so a queue
// is compacted once per 64 queued pairs; with one phase of 128 columns it
// would be compacted after every tile that offered it a key, which made
// unmasked scans several times slower. One barrier of the team
// (bar.red.or) tells its warps whether any row may offer; when none may, as
// on most masked tiles, the phases and their three other barriers are
// skipped. A pair of barriers passes the select from one team to the other.
//
// Why mma.sync and not wgmma: the one-hot is built in registers, and
// wgmma takes registers for A only, so the slots are its 64 rows, the LUTs
// its B operand in shared memory and 64 queries its N; then a thread's
// accumulators hold 4 slots of 16 queries, and the epilogue's per-row work
// is spread over 4 keys instead of 8. Such a variant was built and measured
// on the H100: its products alone ran faster than these, but the whole
// kernel was no faster, at the register limit.
//
// What bounds it: the products, 1,024 bf16 (or int8) operations a key for
// M = 32 at mma.sync's rate, which the fragment builds, the code loads and
// the tile's barriers beside them keep below what a loop of mma.sync and
// ldmatrix alone reaches; the epilogue costs little on masked keys.
// Every key is scored, masked or not: skipping the tiles whose lists no
// query of a block probes is later work.
//
// Shared memory per block (bytes): the ring STAGES x (M x 128 + 1,024); the
// LUT rows 64 x lut_row_bytes (bf16, M x 32 + 16) or lut8_row_bytes (int8,
// ceil(M / 2) x 32 + 16); the select 131,584; the LUT floors 256; with int8
// the rows' (a, c) 512; 4 mbarriers: 218,912 at M = 32 bf16, 186,656 at
// M = 32 int8. M <= 37 (bf16) and M <= 61 (int8) fit the 232,448 a block
// may have (smem_bytes). One block of 8 warps per SM.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

#include "recon_mma.cuh"
#include "tile_select.cuh"

namespace adc_mma {

constexpr int K = 128;          // top-K width; bias columns per group
constexpr int BM = 64;          // queries per block
constexpr int BN = 128;         // columns per tile
constexpr int WCOLS = 32;       // columns per consumer warp
constexpr int NT = WCOLS / 8;   // mma n-tiles per warp
constexpr int RB = BM / 16;     // mma row blocks per warp
constexpr int TEAM = 32 * BN / WCOLS;  // 4 warps a team, 128 threads
constexpr int THREADS = 2 * TEAM;      // two teams, taking turns at tiles
constexpr int STAGES = 4;              // ring depth
constexpr int CAP = 256;        // select pairs per query
constexpr int PHASE = BN / 2;   // columns a phase offers (2 warps)
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have
// the modes (the key's order and the LUT type; see the top of this file)
constexpr int MODE_K4 = 0;
constexpr int MODE_V3 = 1;
constexpr int MODE_V3_INT8 = 2;

static_assert(NT == 4, "a lane's codes for its n-tiles are one 32-bit word");

using Select = tile_select::Select<BM, CAP, PHASE>;

// One ring stage: codes [M][BN] bytes, then n2 [BN] f32 and lid [BN] i32.
__host__ __device__ constexpr int stage_bytes(int M) { return M * BN + BN * 8; }

// Bytes between two queries' LUT rows: M * 16 bf16 and 16 bytes of pad.
__host__ __device__ constexpr int lut_row_bytes(int M) { return M * 32 + 16; }

// int8: the sub-quantizers in pairs of 16 entries each (a zero one after an
// odd M), then 16 bytes of pad.
__host__ __device__ constexpr int lut8_row_bytes(int M) { return (M + 1) / 2 * 32 + 16; }

__host__ __device__ constexpr int lut_stride(int mode, int M) {
  return mode == MODE_V3_INT8 ? lut8_row_bytes(M) : lut_row_bytes(M);
}

// Shared memory, in this order: the ring, the LUT rows, the select, each
// query's LUT floor (lut_floor), with int8 each query's a and c, the full
// mbarriers.
__host__ __device__ constexpr int smem_bytes(int M, int mode = MODE_K4) {
  return STAGES * stage_bytes(M) + BM * lut_stride(mode, M) + Select::kBytes +
         BM * 4 + (mode == MODE_V3_INT8 ? BM * 8 : 0) + STAGES * 8;
}

// The TMA descriptors of a launch: codesT as a 2-D tensor [M rows, S
// columns] of bytes in boxes of M x BN, n2 and lid as [1, S] in boxes of BN.
struct alignas(64) Maps {
  CUtensorMap codes, n2, lid;
};

// The operands of one launch. okey/oslot are the rows' outputs (or a
// split's part of the scratch); ofloor is null for a split's part.
struct Args {
  const float* biasg;           // [nq, nbias]
  const void* luts;             // [nq, M * ksub] bf16, or int8 (MODE_V3_INT8)
  const float* meta;            // [nq, 256]: a, then c (MODE_V3_INT8)
  float* okey;
  int* oslot;
  float* ofloor;
  int nbias, M, ksub;
};

// Tiles [c0 + t * BN, ...) of one split, whole tiles inside [c0, c1); the
// group of a tile is that of its chunk (K4, K6).
struct Walk {
  long long c0;
  int ntiles;
  int ct, cpg, gmax;
  __device__ long long col(int t) const {
    return c0 + static_cast<long long>(t) * BN;
  }
  __device__ int group(int t) const {
    const long long g = col(t) / ct / cpg;
    return g < gmax ? static_cast<int>(g) : gmax;
  }
};

// PTX shl clamps the shift at 32: 0 for any shift of 32 or more.
__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t n) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(r) : "r"(x), "r"(n));
  return r;
}

// The one-hot B fragment (b0, b1) of a column of code c, for the lane
// whose first k row times 16 is kb16 = 32 (lane % 4).
__device__ __forceinline__ void onehot(uint32_t c, uint32_t kb16,
                                       uint32_t& b0, uint32_t& b1) {
  const uint32_t d = c * 16u - kb16;
  b0 = shl(0x3F80u, d);
  b1 = shl(0x3F80u, d - 128u);
}

// One register of the m16n8k32 s8 one-hot B fragment: the lane's four k
// rows 4 (lane % 4) + {0..3} of a sub-quantizer of code c, for the same
// kb16 = 32 (lane % 4), now the bit offset of the lane's first k row
// (8 bits an entry); int8 1 in the byte of the code, else 0.
__device__ __forceinline__ uint32_t onehot8(uint32_t c, uint32_t kb16) {
  return shl(1u, c * 8u - kb16);
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  recon_mma::mma(c, a, b0, b1);
}

// c += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 accumulate.
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's `rows` LUT rows from row q0 into shared memory as [BM][mp *
// 16] entries of T (bf16 bits, or int8) with row stride `stride` bytes,
// entries past ksub, sub-quantizers past M and rows past `rows` zero, by
// every thread.
template <typename T>
__device__ void load_luts(const Args& a, long long q0, int rows, int mp,
                          int stride, unsigned char* lut) {
  const int n = mp * 16;
  const int mk = a.M * a.ksub;
  const T* src = static_cast<const T*>(a.luts);
  for (int i = threadIdx.x; i < BM * n; i += THREADS) {
    const int r = i / n, e = i % n, m = e >> 4, k = e & 15;
    T v = 0;
    if (r < rows && m < a.M && k < a.ksub) v = src[(q0 + r) * mk + m * a.ksub + k];
    *reinterpret_cast<T*>(lut + r * stride + e * sizeof(T)) = v;
  }
}

// A lower bound of every LUT sum of query q (< rows; 0 for the other
// rows), by one thread, from the LUT rows in shared memory: the smallest
// entry of each sub-quantizer, summed in the mmas' order, less 2^-16 of the
// sum of the entries' magnitudes, a margin far above the rounding that the
// tensor cores' additions may differ by from this float32 sum.
__device__ float lut_floor(const Args& a, const unsigned char* lut, int q, int rows) {
  if (q >= rows) return 0.f;
  const __nv_bfloat16* row = reinterpret_cast<const __nv_bfloat16*>(lut + q * lut_row_bytes(a.M));
  float lo = 0.f, mag = 0.f;
  for (int m = 0; m < a.M; ++m) {
    float mn = CUDART_INF_F, mx = 0.f;
    for (int k = 0; k < a.ksub; ++k) {
      const float v = __bfloat162float(row[m * 16 + k]);
      mn = fminf(mn, v);
      mx = fmaxf(mx, fabsf(v));
    }
    lo += mn;
    mag += mx;
  }
  return lo - mag * (1.f / 65536.f);
}

// a * acc + c as the key rounds it: the product, then the sum.
__device__ __forceinline__ float dequant(int acc, float a, float c) {
  return __fadd_rn(__fmul_rn(a, static_cast<float>(acc)), c);
}

// int8: the (a, c) of each of the block's rows, read from meta [nq, 256],
// by warp w for rows w, w + 8, ...: am[r] = a where the row is uniform (its
// 128 a's equal, its 128 c's equal, a > 0 and finite), else 0; cm[r] = c.
__device__ void load_meta(const Args& a, long long q0, int rows, float* am, float* cm) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < BM; r += THREADS / 32) {
    bool same = true;
    float a0 = 0.f, c0 = 0.f;
    if (r < rows) {
      const float* row = a.meta + (q0 + r) * (2 * K);
      a0 = row[0];
      c0 = row[K];
#pragma unroll
      for (int i = 0; i < K / 32; ++i) {
        same = same && row[lane + 32 * i] == a0 && row[K + lane + 32 * i] == c0;
      }
    }
    same = __all_sync(tile_select::kFull, same) && r < rows && a0 > 0.f && isfinite(a0);
    if (lane == 0) {
      am[r] = same ? a0 : 0.f;
      cm[r] = c0;
    }
  }
}

// int8: the dequantized LUT floor of query q (< rows), by one thread: the
// int32 sum of the smallest entry of each sub-quantizer (exact; a lower
// bound of every acc), as a key dequantizes it; -inf where the row is not
// uniform (never read: such a row is not gated).
__device__ float lut_floor8(const Args& a, const unsigned char* lut, int q, int rows,
                            const float* am, const float* cm) {
  if (q >= rows || !(am[q] > 0.f)) return -CUDART_INF_F;
  const signed char* row = reinterpret_cast<const signed char*>(lut + q * lut8_row_bytes(a.M));
  int lo = 0;
  for (int m = 0; m < a.M; ++m) {
    int mn = 127;
    for (int k = 0; k < a.ksub; ++k) mn = min(mn, static_cast<int>(row[m * 16 + k]));
    lo += mn;
  }
  return dequant(lo, am[q], cm[q]);
}

// The warp's 64 rows x 32 columns of the stage's tile: acc[rb][nt] is the
// m16n8 accumulator of row block rb and n-tile nt. Per k-step m the 4
// one-hot fragments are built from the code word of sub-quantizer m (bf16)
// or the words of 2m and 2m + 1 (int8), and each ldmatrix of a row block's
// LUT fragment feeds the mmas of the 4 n-tiles.
template <int MODE, typename Acc>
__device__ __forceinline__ void products(int M, const unsigned char* codes,
                                         uint32_t lut_lane, int row16,
                                         Acc (&acc)[RB][NT][4]) {
  const int lane = threadIdx.x & 31, tw = (threadIdx.x >> 5) % 4;
  const uint32_t kb16 = (lane & 3) * 32;
  const uint32_t* cw = reinterpret_cast<const uint32_t*>(
      codes + tw * WCOLS + 4 * (lane >> 2));
  const int nk = MODE == MODE_V3_INT8 ? (M + 1) / 2 : M;  // k-steps
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll 2
  for (int m = 0; m < nk; ++m) {
    uint32_t b[NT][2];
    if constexpr (MODE == MODE_V3_INT8) {
      const uint32_t w = cw[2 * m * (BN / 4)];
      // an odd M's last pair: code 0 of the zero sub-quantizer
      const uint32_t w1 = 2 * m + 1 < M ? cw[(2 * m + 1) * (BN / 4)] : 0u;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b[nt][0] = onehot8(__byte_perm(w, 0u, 0x4440u | nt), kb16);
        b[nt][1] = onehot8(__byte_perm(w1, 0u, 0x4440u | nt), kb16);
      }
    } else {
      const uint32_t w = cw[m * (BN / 4)];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) onehot(__byte_perm(w, 0u, 0x4440u | nt), kb16, b[nt][0], b[nt][1]);
    }
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      uint32_t a[4];
      recon_mma::ldsm_x4(lut_lane + rb * row16 + m * 32, a);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[rb][nt], a, b[nt][0], b[nt][1]);
    }
  }
}

// The smallest bias of each of the thread's 8 rows (16 rb + 8 h + lane / 4)
// in group g, by the 4 lanes of a quad; +inf for rows past `rows`.
__device__ __forceinline__ void bias_floor(const Args& a, long long q0,
                                           int rows, int g, float (&pmin)[2 * RB]) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * RB; ++j) {
    const int r = 16 * (j >> 1) + 8 * (j & 1) + (lane >> 2);
    float v = CUDART_INF_F;
    if (r < rows) {
      const float4* b = reinterpret_cast<const float4*>(
          a.biasg + (q0 + r) * a.nbias + static_cast<long long>(g) * K + tq * 32);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x = b[i];
        v = fminf(v, fminf(fminf(x.x, x.y), fminf(x.z, x.w)));
      }
    }
    v = fminf(v, __shfl_xor_sync(tile_select::kFull, v, 1));
    v = fminf(v, __shfl_xor_sync(tile_select::kFull, v, 2));
    pmin[j] = v;
  }
}

// The ring: STAGES stages of SB bytes, stage t % STAGES holding tile t, and
// a "full" mbarrier per stage that completes when its three boxes landed.
struct Ring {
  unsigned char* base;
  uint32_t full;  // shared address of the first mbarrier
  int SB;
  // Tile t into its stage, by one thread.
  template <class Walk>
  __device__ __forceinline__ void issue(const Maps& maps, const Walk& w, int t,
                                        int M) const {
    unsigned char* st = base + (t % STAGES) * SB;
    const uint32_t bar = full + 8 * (t % STAGES);
    const int c = static_cast<int>(w.col(t));
    recon_mma::mbar_expect(bar, SB);
    recon_mma::tma_2d(recon_mma::smem_u32(st), &maps.codes, c, 0, bar);
    recon_mma::tma_2d(recon_mma::smem_u32(st + M * BN), &maps.n2, c, 0, bar);
    recon_mma::tma_2d(recon_mma::smem_u32(st + M * BN + BN * 4), &maps.lid, c, 0, bar);
  }
};

// What a thread needs of its 8 columns (slots s0 .. s0 + 8 of the tile) and
// of its 8 rows' bias, read when the tile arrives so that the bias loads
// from global memory complete under the products: n2 and its smallest
// value, the list ids and, where the 8 columns lie in one list, each row's
// bias for it (else the row's smallest bias in the tile's group).
struct Cols {
  float n2[8];
  int lid[8];
  float n2min;  // the smallest of n2
  bool one;     // the thread's 8 slots lie in one list
  float pen[8];
};

template <class Walk>
__device__ __forceinline__ void load_cols(const Args& a, const Walk& w, int t,
                                          const unsigned char* stage, long long q0,
                                          int rows, int& grp, float (&pmin)[2 * RB],
                                          Cols& c) {
  const int lane = threadIdx.x & 31, tw = (threadIdx.x >> 5) % 4;
  const int s0 = tw * WCOLS + 8 * (lane & 3);
  const float* n2s = reinterpret_cast<const float*>(stage + a.M * BN);
  const int* lids = reinterpret_cast<const int*>(n2s + BN);
  const float4 na = *reinterpret_cast<const float4*>(n2s + s0);
  const float4 nb = *reinterpret_cast<const float4*>(n2s + s0 + 4);
  const int4 la = *reinterpret_cast<const int4*>(lids + s0);
  const int4 lb = *reinterpret_cast<const int4*>(lids + s0 + 4);
  c.n2[0] = na.x; c.n2[1] = na.y; c.n2[2] = na.z; c.n2[3] = na.w;
  c.n2[4] = nb.x; c.n2[5] = nb.y; c.n2[6] = nb.z; c.n2[7] = nb.w;
  c.lid[0] = la.x; c.lid[1] = la.y; c.lid[2] = la.z; c.lid[3] = la.w;
  c.lid[4] = lb.x; c.lid[5] = lb.y; c.lid[6] = lb.z; c.lid[7] = lb.w;
  c.one = true;
  c.n2min = c.n2[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    c.one = c.one && c.lid[i] == c.lid[0];
    c.n2min = fminf(c.n2min, c.n2[i]);
  }
  const int g = w.group(t);
  if (g != grp) {
    bias_floor(a, q0, rows, g, pmin);
    grp = g;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = 16 * (j >> 1) + 8 * (j & 1) + (lane >> 2);
    c.pen[j] = c.one && r < rows
                   ? a.biasg[(q0 + r) * a.nbias + static_cast<long long>(g) * K + c.lid[0]]
                   : pmin[j];
  }
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A barrier of n threads that returns whether v held for any of them.
__device__ __forceinline__ bool bar_any(int id, int n, bool v) {
  int r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.s32 q, %1, 0;\n"
      "bar.red.or.pred p, %2, %3, q;\nselp.s32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"(static_cast<int>(v)), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

// Per-query state of the block in shared memory beside the select: the LUT
// floor, and with int8 the rows' (a, c) (am 0 on a row that is not
// uniform).
struct Rows {
  const float* lfloor;
  const float* am;
  const float* cm;
};

// int8: the LUT terms a * acc + c of the thread's keys, once per tile,
// into lut (the same places as acc): with the row's (a, c) on a uniform
// row (and on the rows past `rows`, never offered), with the slot's lane's
// from meta on any other.
__device__ __forceinline__ void dequant_rows(const Args& a, const Rows& rs,
                                             const int (&acc)[RB][NT][4],
                                             float (&lut)[RB][NT][4],
                                             long long q0, int rows) {
  const int lane = threadIdx.x & 31, tw = (threadIdx.x >> 5) % 4;
  const int s0 = tw * WCOLS + 8 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = 16 * (j >> 1) + 8 * (j & 1) + (lane >> 2);
    const float am = rs.am[r], cm = rs.cm[r];
    if (am > 0.f || r >= rows) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        lut[j >> 1][i & 3][2 * (j & 1) + (i >> 2)] =
            dequant(acc[j >> 1][i & 3][2 * (j & 1) + (i >> 2)], am, cm);
      }
    } else {  // (a, c) at the slot's lane, s0 + i
      const float* mrow = a.meta + (q0 + r) * (2 * K) + s0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        lut[j >> 1][i & 3][2 * (j & 1) + (i >> 2)] =
            dequant(acc[j >> 1][i & 3][2 * (j & 1) + (i >> 2)], mrow[i], mrow[K + i]);
      }
    }
  }
}

// Keys of the warp's rows over its columns of tile t, offered to the
// select; acc holds the LUT sums (K4, bf16) or terms (int8, dequant_rows). The team first waits for the other team to leave the select
// (barrier 3 + team, both teams' 256 threads). Then one barrier of the team
// (id 1 + team, 128 threads) finds whether any of its rows passed the
// gates, and after it every warp of the team is done with the tile's stage,
// so the team's first thread refills it with tile t + STAGES. If a row
// passed, the offers follow in two phases of 64 columns (the team's warps
// 0-1, then 2-3), each followed by the team's compactions (make_room: every
// row whose queue could not take another 64 offers, one warp per 16 rows),
// the team's barrier separating offers from compactions. Last the team
// lets the other team in.
template <int MODE, class Walk>
__device__ __forceinline__ void epilogue(const Args& a, const Maps& maps,
                                         const Ring& ring, const Walk& w, int t,
                                         const Cols& c, Select& sel,
                                         const Rows& rs,
                                         const float (&acc)[RB][NT][4],
                                         long long q0, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp / 4, tw = warp % 4;
  const int s0 = tw * WCOLS + 8 * (lane & 3);  // the thread's first column
  const long long col = w.col(t);
  const long long gcol = static_cast<long long>(w.group(t)) * K;
  const float* lfloor = rs.lfloor;
  if (t > 0) bar_sync(3 + team, 2 * TEAM);  // the other team has left
  // rows that may offer: the row's LUT floor plus the smallest n2, then
  // its smallest bias-free key, plus the gate's bias (each rounded sum
  // monotone in its terms) is a lower bound on every key of the row
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = 16 * (j >> 1) + 8 * (j & 1) + (lane >> 2);
    if (r >= rows) continue;
    const float thr = sel.thr[r];
    if constexpr (MODE == MODE_K4) {
      if (!((lfloor[r] + c.n2min) + c.pen[j] < thr)) continue;
      float xmin = CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 8; ++i) xmin = fminf(xmin, acc[j >> 1][i & 3][2 * (j & 1) + (i >> 2)] + c.n2[i]);
      if (xmin + c.pen[j] < thr) live |= 1u << j;
    } else {
      // K6's order, lut + (bias + n2), with the gate's bias; an int8 row
      // whose (a, c) vary by lane is never gated
      if (MODE == MODE_V3_INT8 && !(rs.am[r] > 0.f)) {
        live |= 1u << j;
        continue;
      }
      if (!(lfloor[r] + (c.pen[j] + c.n2min) < thr)) continue;
      float xmin = CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float rest = c.pen[j] + c.n2[i];
        xmin = fminf(xmin, acc[j >> 1][i & 3][2 * (j & 1) + (i >> 2)] + rest);
      }
      if (xmin < thr) live |= 1u << j;
    }
  }
  // one barrier of the team: every warp is done with the stage (its first
  // thread refills it) and says whether any of its rows may offer
  const bool any = bar_any(1 + team, TEAM, live != 0);
  if (tw == 0 && lane == 0 && t + STAGES < w.ntiles) ring.issue(maps, w, t + STAGES, a.M);
#pragma unroll
  for (int phase = 0; phase < 2 && any; ++phase) {
    if (tw / 2 == phase && live) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!(live >> j & 1)) continue;
        const int r = 16 * (j >> 1) + 8 * (j & 1) + (lane >> 2);
        const float thr = sel.thr[r];
        float bias[8];
        const float* brow = a.biasg + (q0 + r) * a.nbias + gcol;
#pragma unroll
        for (int i = 0; i < 8; ++i) bias[i] = c.one ? c.pen[j] : brow[c.lid[i]];
        if constexpr (MODE == MODE_K4) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float key = (acc[j >> 1][i & 3][2 * (j & 1) + (i >> 2)] + c.n2[i]) + bias[i];
            if (key < thr) sel.offer(r, key, static_cast<int>(col + s0 + i));
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float rest = bias[i] + c.n2[i];
            const float key = acc[j >> 1][i & 3][2 * (j & 1) + (i >> 2)] + rest;
            if (key < thr) sel.offer(r, key, static_cast<int>(col + s0 + i));
          }
        }
      }
    }
    bar_sync(1 + team, TEAM);  // the phase's offers are in
    sel.make_room(16 * tw, 16);
    if (phase == 0) bar_sync(1 + team, TEAM);  // compactions done
  }
  if (t + 1 < w.ntiles) bar_arrive(4 - team, 2 * TEAM);  // the other team's turn
}

// The block's scan: `rows` queries from row q0 over the walk's tiles, then
// each query's top-128 written to row q0 + r of okey/oslot (and ofloor).
// Team k takes tiles t = k mod 2; the first thread fills the ring's
// stages before the first tile.
template <int MODE, class Walk>
__device__ void scan(const Args& a, const Maps& maps, const Walk& w,
                     long long q0, int rows) {
  constexpr bool INT8 = MODE == MODE_V3_INT8;
  using Acc = typename std::conditional<INT8, int, float>::type;
  extern __shared__ __align__(1024) unsigned char adc_smem[];
  const int row_bytes = lut_stride(MODE, a.M);
  Ring ring;
  ring.SB = stage_bytes(a.M);
  ring.base = adc_smem;
  unsigned char* lut = ring.base + STAGES * ring.SB;
  Select sel(lut + BM * row_bytes);
  float* lfloor = reinterpret_cast<float*>(lut + BM * row_bytes + Select::kBytes);
  float* am = lfloor + BM;  // int8 only: the rows' a (0: not uniform), then c
  float* cm = am + BM;
  ring.full = recon_mma::smem_u32(lfloor + (INT8 ? 3 : 1) * BM);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) recon_mma::mbar_init(ring.full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  sel.init(THREADS);
  if constexpr (INT8) {
    load_luts<signed char>(a, q0, rows, (a.M + 1) / 2 * 2, row_bytes, lut);
    load_meta(a, q0, rows, am, cm);
  } else {
    load_luts<unsigned short>(a, q0, rows, a.M, row_bytes, lut);
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    lfloor[threadIdx.x] = INT8 ? lut_floor8(a, lut, threadIdx.x, rows, am, cm)
                               : lut_floor(a, lut, threadIdx.x, rows);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 0; t < STAGES && t < w.ntiles; ++t) ring.issue(maps, w, t, a.M);
  }
  const int team = warp / 4;
  const int row16 = 16 * row_bytes;  // bytes between row blocks
  // ldmatrix.x4: lane l addresses row l % 8 (+ 8 for matrices 1 and 3) of
  // the A fragment, 16-byte column l / 16 of the k-step
  const uint32_t lut_lane = recon_mma::smem_u32(lut) +
                            ((lane & 7) + ((lane >> 3) & 1) * 8) * row_bytes +
                            (lane >> 4) * 16;
  const Rows rs{lfloor, am, cm};
  Acc acc[RB][NT][4];
  int grp = -1;
  float pmin[2 * RB];
  for (int t = team; t < w.ntiles; t += 2) {
    const int slot = t % STAGES;
    recon_mma::mbar_wait(ring.full + 8 * slot, (t / STAGES) & 1);
    const unsigned char* st = ring.base + slot * ring.SB;
    Cols c;
    load_cols(a, w, t, st, q0, rows, grp, pmin, c);
    products<MODE>(a.M, st, lut_lane, row16, acc);
    if constexpr (INT8) {
      float lut[RB][NT][4];
      dequant_rows(a, rs, acc, lut, q0, rows);
      epilogue<MODE>(a, maps, ring, w, t, c, sel, rs, lut, q0, rows);
    } else {
      epilogue<MODE>(a, maps, ring, w, t, c, sel, rs, acc, q0, rows);
    }
  }
  bar_sync(5, THREADS);  // every offer and compaction is done
  for (int i = 0; i < BM / (THREADS / 32); ++i) {
    const int r = BM / (THREADS / 32) * warp + i;
    if (r >= rows) break;
    float k[4];
    int s[4];
    sel.result(r, k, s);
    const long long o = (q0 + r) * K;
    tile_select::write_row(k, s, a.okey + o, a.oslot + o,
                           a.ofloor ? a.ofloor + o : nullptr);
  }
}

// Block b: query block b % qblocks of column split b / qblocks.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
adc_mma_kernel(Args a, const __grid_constant__ Maps maps, long long nq, long long S,
               int qblocks, long long split_cols, int ct, int cpg, int gmax,
               float* part_key, int* part_slot) {
  const int qb = blockIdx.x % qblocks, p = blockIdx.x / qblocks;
  const long long q0 = static_cast<long long>(qb) * BM;
  const int rows = static_cast<int>(nq - q0 < BM ? nq - q0 : BM);
  Walk w;
  w.c0 = p * split_cols;
  const long long c1 = w.c0 + split_cols < S ? w.c0 + split_cols : S;
  w.ntiles = c1 > w.c0 ? static_cast<int>((c1 - w.c0) / BN) : 0;
  w.ct = ct;
  w.cpg = cpg;
  w.gmax = gmax;
  if (part_key != nullptr) {  // a split's top-128s go to the scratch
    a.okey = part_key + p * nq * K;
    a.oslot = part_slot + p * nq * K;
    a.ofloor = nullptr;
  }
  scan<MODE>(a, maps, w, q0, rows);
}

// Host: the launch's TMA descriptors. Returns 0 or a CUDA error code.
inline int make_maps(Maps* m, const void* codesT, const void* n2,
                     const void* lid, long long S, int M) {
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
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t cdims[2] = {static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(M)};
  const cuuint64_t cstride[1] = {static_cast<cuuint64_t>(S)};
  const cuuint32_t cbox[2] = {BN, static_cast<cuuint32_t>(M)};
  const cuuint64_t rdims[2] = {static_cast<cuuint64_t>(S), 1};
  const cuuint64_t rstride[1] = {static_cast<cuuint64_t>(S) * 4};
  const cuuint32_t rbox[2] = {BN, 1};
  struct {
    CUtensorMap* map;
    CUtensorMapDataType type;
    const void* ptr;
    const cuuint64_t* dims;
    const cuuint64_t* stride;
    const cuuint32_t* box;
    const char* what;
  } const specs[3] = {
      {&m->codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, codesT, cdims, cstride, cbox, "codesT"},
      {&m->n2, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, n2, rdims, rstride, rbox, "n2"},
      {&m->lid, CU_TENSOR_MAP_DATA_TYPE_INT32, lid, rdims, rstride, rbox, "lid"},
  };
  for (const auto& s : specs) {
    const CUresult r = encode(
        s.map, s.type, 2, const_cast<void*>(s.ptr), s.dims, s.stride, s.box, one,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) {
      fprintf(stderr, "adc_mma: TMA descriptor of %s: error %d\n", s.what,
              static_cast<int>(r));
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return 0;
}

// Host: after a launch of `splits` splits, the check of the launch and,
// with more than one, the merge of the splits' top-128s into a's outputs.
inline int merge(const Args& a, float* part_key, int* part_slot, int nq,
                 int splits, cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  tile_select::merge_splits<<<(nq + 3) / 4, 128, 0, stream>>>(
      part_key, part_slot, splits, nq, a.okey, a.oslot, a.ofloor);
  return static_cast<int>(cudaGetLastError());
}

// Host: one launch of the scan in MODE over codesT [M, S], n2 and lid [S],
// for a's nq rows, its columns in `splits` ranges of whole tiles (with
// more than one, part_key / part_slot [splits][nq][128] hold the splits'
// top-128s until tile_select::merge_splits joins them into a's outputs).
// The caller has checked the shape and the 16-byte alignment TMA needs.
template <int MODE>
int launch(const Args& a, const void* codesT, const void* n2, const void* lid,
           void* part_key, void* part_slot, int nq, long long S, int ct,
           int splits, cudaStream_t stream) {
  Maps maps;
  if (const int e = make_maps(&maps, codesT, n2, lid, S, a.M)) return e;
  const int smem = smem_bytes(a.M, MODE);
  const int G = a.nbias / K;
  const int cpg = max(1, static_cast<int>(S / ct) / G);
  const long long tiles = S / BN;
  const long long split_cols = (tiles + splits - 1) / splits * BN;
  const int qblocks = (nq + BM - 1) / BM;
  cudaError_t err = cudaFuncSetAttribute(
      adc_mma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* pk = static_cast<float*>(part_key);
  int* ps = static_cast<int*>(part_slot);
  adc_mma_kernel<MODE><<<qblocks * splits, THREADS, smem, stream>>>(
      a, maps, nq, S, qblocks, split_cols, ct, cpg, G - 1, pk, ps);
  return merge(a, pk, ps, nq, splits, stream);
}

}  // namespace adc_mma
