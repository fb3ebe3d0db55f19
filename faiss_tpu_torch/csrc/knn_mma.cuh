// K3's product passes on the tensor cores (knn_fused.cu): the keys
//     L2:  key(r, s) = n2[s] - 2 * q_r . y_s
//     IP:  key(r, s) = -q_r . y_s
// of a block's BM = 64 float32 queries against a walk of 256-column tiles of
// the transposed float32 store yT [d, ld], at float32 accuracy, and the two
// epilogues of K3's exact threshold select:
//   MIN     the smallest key of each (query, bucket) to minima [rows][ldm],
//           a bucket being the W = 32 consecutive columns of one warp's
//           part of a tile;
//   APPEND  every key below the row's threshold theta, with its column, to
//           the row's lt region of the candidate buffer, and every key equal
//           to theta to its eq region (k_lanes pairs; later ones are
//           dropped), each by an atomic counter of the row.
// Both passes run the same products in the same order, so pass 2 sees
// bitwise the keys that pass 1 saw; the key is one rounding of
// fma(-2, ip, n2), never left to the compiler's contraction.
//
// Arithmetic: 3xTF32, the float32-accurate product of the TPU kernel's
// Precision.HIGHEST. Each float32 operand a is split into big = tf32(a)
// (cvt.rna: round to nearest, ties away, to 10 mantissa bits) and small =
// tf32(a - big) (the subtraction is exact), and each product is
// small_q.big_y + big_q.small_y + big_q.big_y, in that order, as
// mma.sync.m16n8k8 TF32 products into float32 accumulators. The dropped
// small.small term is below 2^-22 |q| |y|.
//
// Data flow (the producer pattern of recon_mma.cuh, whose mbarrier and TMA
// helpers it uses). One producer warp streams the store's tiles, [KC = 32
// dims, BN = 256 columns], by TMA into a ring of STAGES = 3 stages, as eight
// boxes of 32 columns (128 bytes, the 128-byte swizzle: chunk c of row r at
// c ^ (r & 7)); dims past d arrive as zeros. The queries' big and small
// planes stay in shared memory (QSEG = 128 dims at a time; a wider d
// reloads its next 128 dims per tile, the one point where the consumers
// meet), stored in the order of the mma's A fragments, so a lane reads its
// four A registers of a row block with one 16-byte load. Consumer warp w
// owns all 64 query rows (four 16-row blocks) and the 32 columns of box w
// (one bucket): per 8 dims it reads its 2 x 4 store values from the box,
// splits them in registers, once, and runs 48 mma.sync, whose three
// products of an accumulator issue 15 other products apart. (On the H100,
// 64 x 32 warp tiles ran the products 1.3x faster than 32 x 32 tiles with
// each store value split by two warps; 128 queries a block, with 16 warps,
// spilled.)
//
// The k order inside an 8-dim step is permuted, the same for A and B: the
// fragment's k = t and t + 4 (t = lane % 4) are dims 2t and 2t + 1 of the
// step. So a lane's A values of one row are adjacent dims, and the B reads
// of rows 2t (+1), columns 8 nt + g (g = lane / 4) fall in 32 different
// banks under the swizzle.
//
// Shared memory per block (bytes): the ring 3 x 32,768; the query planes
// 2 x 64 x 128 x 4 = 65,536; 6 mbarriers: 163,888, one block of 9 warps per
// SM. No per-query state: the select lives in device memory (knn_fused.cu).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <stdio.h>

#include "recon_mma.cuh"

namespace knn_mma {

constexpr int BM = 64;       // queries per block
constexpr int BN = 256;      // columns per tile
constexpr int BOX = 32;      // columns per TMA box (128 bytes)
constexpr int W = 32;        // columns per bucket: one warp's box of a tile
constexpr int KC = 32;       // dims per ring stage
constexpr int QSEG = 128;    // query dims resident in shared memory
constexpr int STAGES = 3;    // ring depth
constexpr int WM = 1;        // consumer warps along the rows
constexpr int WN = BN / W;   // consumer warps along the columns
constexpr int CONSUMERS = 32 * WM * WN;  // 8 consumer warps
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int RB = BM / 16 / WM;         // 16-row blocks of a warp
constexpr int NT = W / 8;                // 8-column mma tiles of a warp
constexpr int KSEG = QSEG / 8;           // 8-dim k-steps of a query segment

constexpr int kBox = KC * BOX * 4;       // one box of a stage
constexpr int kStage = KC * BN * 4;      // one ring stage
constexpr int kQPlane = BM * QSEG * 4;   // one query plane (big or small)

__host__ __device__ constexpr int smem_bytes() {
  return STAGES * kStage + 2 * kQPlane + 2 * STAGES * 8;
}

enum Mode { MIN = 0, APPEND = 1 };

// The operands of one launch of a product pass.
struct Args {
  const float* x;       // [nq, d] queries of the launch
  const float* n2;      // [>= tiles * BN] column norms (L2)
  float* minima;        // [nq][ldm] (MIN)
  const float* theta;   // [nq] (APPEND)
  int* counts;          // [nq][2]: lt, eq (APPEND)
  int2* cand;           // [nq][lt_cap + k_lanes] (APPEND)
  long long nb;         // scored columns
  long long ldm;        // row stride of minima
  int nq, d, d_pad;     // d_pad: d rounded up to KC
  int metric_l2;
  int k_lanes;
  int lt_cap;           // (k_lanes - 1) * W
  int ntiles;           // tiles of BN columns over nb
  int splits;           // column splits of the grid
};

// cvt.rna.tf32.f32: a rounded to nearest (ties away from zero) at 10
// mantissa bits, the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = tf32(a);
  small = tf32(a - __uint_as_float(big));
}

// c += a (16 x 8, row) . b (8 x 8, col), TF32 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint4& a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Dims [k0, k0 + QSEG) of the block's `rows` queries from row q0, split
// into big and small planes in A-fragment order: entry (ks, rb, lane) of a
// plane holds the lane's registers a0..a3 of row block rb and k-step ks,
// element e being query row qrow and dim qdim; rows past `rows` and dims
// past d are zero. By the first `nthreads` threads.
__device__ void load_queries(const Args& a, long long q0, int rows, int k0,
                             unsigned char* qs, int nthreads) {
  uint4* big = reinterpret_cast<uint4*>(qs);
  uint4* small = reinterpret_cast<uint4*>(qs + kQPlane);
  for (int i = threadIdx.x; i < KSEG * (BM / 16) * 32; i += nthreads) {
    const int lane = i % 32, rb = (i / 32) % (BM / 16), ks = i / (32 * (BM / 16));
    uint32_t b[4], s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qrow = 16 * rb + (lane >> 2) + 8 * (e & 1);
      const int qdim = k0 + 8 * ks + 2 * (lane & 3) + (e >> 1);
      const float v = qrow < rows && qdim < a.d ? a.x[(q0 + qrow) * a.d + qdim] : 0.f;
      split(v, b[e], s[e]);
    }
    big[i] = make_uint4(b[0], b[1], b[2], b[3]);
    small[i] = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// The warp's 32 rows x 32 columns over the stage's KC dims; ks0 is the
// stage's first k-step within the resident query segment.
__device__ __forceinline__ void products(const unsigned char* qs,
                                         const unsigned char* stage, int ks0,
                                         float (&acc)[RB][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint4* qbig = reinterpret_cast<const uint4*>(qs);
  const uint4* qsmall = reinterpret_cast<const uint4*>(qs + kQPlane);
  const unsigned char* box = stage + (warp / WM) * kBox;
#pragma unroll
  for (int kk = 0; kk < KC / 8; ++kk) {
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 8 * kk + 2 * t + h;  // the box row (dim) of b_h
        const int n = 8 * nt + g;          // the box column
        const float y = *reinterpret_cast<const float*>(
            box + r * 128 + ((((n >> 2) ^ (r & 7)) << 4) | ((n & 3) << 2)));
        split(y, bb[nt][h], bs[nt][h]);
      }
    }
    uint4 ab[RB], as[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int frag = ((ks0 + kk) * (BM / 16) + (warp % WM) * RB + i) * 32 + lane;
      ab[i] = qbig[frag];
      as[i] = qsmall[frag];
    }
    // each accumulator takes its three products in this order; between two
    // of them the other RB * NT - 1 accumulators' products issue
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[i][nt], as[i], bb[nt][0], bb[nt][1]);
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[i][nt], ab[i], bs[nt][0], bs[nt][1]);
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[i][nt], ab[i], bb[nt][0], bb[nt][1]);
  }
}

__device__ __forceinline__ float key_of(int metric_l2, float ip, float n2) {
  return metric_l2 ? __fmaf_rn(-2.f, ip, n2) : -ip;
}

// The warp's keys of tile `tile`: accumulator acc[i][nt][e] is query row
// 16 (RB (warp % WM) + i) + g + 8 (e >> 1) and column col0 + 8 nt + 2 t +
// (e & 1) of the tile. Columns from nb on are never scored.
template <int MODE>
__device__ __forceinline__ void epilogue(const Args& a, long long q0, int rows,
                                         long long tile,
                                         const float (&acc)[RB][NT][4],
                                         const float (&thr)[RB][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const long long col0 = tile * BN + (warp / WM) * W;  // the bucket's first column
  if (col0 >= a.nb) return;  // warp-uniform: a bucket past the columns
  float n2v[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 v = a.metric_l2
        ? *reinterpret_cast<const float2*>(a.n2 + col0 + 8 * nt + 2 * t)
        : make_float2(0.f, 0.f);
    n2v[nt][0] = v.x;
    n2v[nt][1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * (RB * (warp % WM) + i) + (lane >> 2) + 8 * h;
      if constexpr (MODE == MIN) {
        float m = CUDART_INF_F;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const long long col = col0 + 8 * nt + 2 * t + c;
            const float key = key_of(a.metric_l2, acc[i][nt][2 * h + c], n2v[nt][c]);
            if (col < a.nb) m = fminf(m, key);
          }
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (t == 0 && row < rows) a.minima[(q0 + row) * a.ldm + col0 / W] = m;
      } else {
        const float th = thr[i][h];  // -inf for rows past `rows`
        float key[NT][2];
        float m = CUDART_INF_F;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            key[nt][c] = key_of(a.metric_l2, acc[i][nt][2 * h + c], n2v[nt][c]);
            m = fminf(m, key[nt][c]);
          }
        if (!(m <= th)) continue;  // the row takes none of these keys
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const long long col = col0 + 8 * nt + 2 * t + c;
            if (col < a.nb && key[nt][c] <= th) {
              const long long r = q0 + row;
              int2* out = a.cand + r * (a.lt_cap + a.k_lanes);
              const int2 pair = make_int2(__float_as_int(key[nt][c]), static_cast<int>(col));
              if (key[nt][c] < th) {
                const int p = atomicAdd(a.counts + 2 * r, 1);
                if (p < a.lt_cap) out[p] = pair;
              } else {
                const int p = atomicAdd(a.counts + 2 * r + 1, 1);
                if (p < a.k_lanes) out[a.lt_cap + p] = pair;
              }
            }
          }
      }
    }
  }
}

// One product pass of the block (qb, split): the block's BM queries from
// row qb * BM over the split's tiles. Block b is query block b % nqb of
// column split b / nqb, so the blocks resident together walk the same
// columns and share the store's tiles in L2. Every thread enters; the
// producer warp returns once it has issued the last unit.
template <int MODE>
__device__ void scan(const Args& a, const CUtensorMap* map) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* qs = ring + STAGES * kStage;
  const uint32_t full = recon_mma::smem_u32(qs + 2 * kQPlane);
  const uint32_t empty = full + 8 * STAGES;
  const int nqb = (a.nq + BM - 1) / BM;
  const int qb = blockIdx.x % nqb, sp = blockIdx.x / nqb;
  const long long q0 = static_cast<long long>(qb) * BM;
  const int rows = min(BM, a.nq - static_cast<int>(q0));
  const int per = (a.ntiles + a.splits - 1) / a.splits;
  const int t0 = sp * per, t1 = min(a.ntiles, t0 + per);
  const int nkc = a.d_pad / KC;
  constexpr int kps = QSEG / KC;  // stages per resident query segment
  const bool reload = a.d_pad > QSEG;
  const int n = max(0, t1 - t0) * nkc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      recon_mma::mbar_init(full + 8 * i, 1);
      recon_mma::mbar_init(empty + 8 * i, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!reload) load_queries(a, q0, rows, 0, qs, THREADS);
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      for (int u = 0; u < n; ++u) {
        const int slot = u % STAGES;
        if (u >= STAGES) recon_mma::mbar_wait(empty + 8 * slot, (u / STAGES - 1) & 1);
        const int col = (t0 + u / nkc) * BN, dim = (u % nkc) * KC;
        const uint32_t bar = full + 8 * slot;
        unsigned char* st = ring + slot * kStage;
        recon_mma::mbar_expect(bar, kStage);
        for (int b = 0; b < BN / BOX; ++b) {
          recon_mma::tma_2d(recon_mma::smem_u32(st + b * kBox), map, col + b * BOX,
                            dim, bar);
        }
      }
    }
    return;
  }
  float thr[RB][2];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * (RB * (warp % WM) + i) + (lane >> 2) + 8 * h;
      thr[i][h] = MODE == APPEND && row < rows ? a.theta[q0 + row] : -CUDART_INF_F;
    }
  float acc[RB][NT][4];
  for (int u = 0; u < n; ++u) {
    const int slot = u % STAGES;
    const int kc = u % nkc;
    if (reload && kc % kps == 0) {  // every consumer is past the old dims
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS));
      load_queries(a, q0, rows, kc * KC, qs, CONSUMERS);
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS));
    }
    recon_mma::mbar_wait(full + 8 * slot, (u / STAGES) & 1);
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
    }
    products(qs, ring + slot * kStage, (kc % kps) * (KC / 8), acc);
    __syncwarp();
    if (lane == 0) recon_mma::mbar_arrive(empty + 8 * slot);
    if (kc == nkc - 1) epilogue<MODE>(a, q0, rows, t0 + u / nkc, acc, thr);
  }
}

// Host: the store's TMA descriptor, a 2-D float32 tensor [d rows, ld
// columns] (row stride ld * 4 bytes, a multiple of 16), boxes of KC rows x
// BOX columns with the 128-byte swizzle; rows past d and columns past ld
// arrive as zeros. Returns 0 or a CUDA error code.
inline int make_map(CUtensorMap* m, const void* yT, long long ld, int d) {
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
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(d)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {BOX, KC};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(yT), dims, strides,
      box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "knn_mma: TMA descriptor of the store: error %d\n",
            static_cast<int>(r));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace knn_mma
