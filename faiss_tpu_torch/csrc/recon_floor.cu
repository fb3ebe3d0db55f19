// K7: the score-only floor of the recon scan, for sm_90a, on the tensor
// cores.
//
// Replaces the kernel ``noselect_kernel`` that ``floor_call`` hands to
// pl.pallas_call in benchs/archive/exp_r3c.py (:81, :106), the TPU's
// "MXU-only floor": K2's score producer with no select. For every query row
// r and lane l < 128 it returns
//     out[r, l] = min over the columns s with s % 128 == l of
//                 n2[s] - 2 * q_r . y[:, s]
// over every column of the store (+inf where n2 is +inf), so min over the
// lanes of a row is its best key, K2's first key on the same store.
//
// Arithmetic: the TPU kernel's (exp_r3c.py:89-100), which is K2's with one
// plane: the float32 query split into bf16 hi + lo, then qh.y + ql.y on the
// tensor cores in bf16 with float32 accumulators. The products are
// recon_mma.cuh's, the ones K2 runs, and the key n2 - 2 * acc is written
// as K2's epilogue writes it, so a key here is the key K2 offers to its
// select, and min over a row's lanes equals K2's first key.
//
// Design. recon_mma::scan with its ring, producer warp and products, and
// LaneMin (below) as its epilogue policy in place of the select: a thread
// holds 16 accumulators at fixed (row, tile column) places (acc_row,
// acc_col), and a tile of 64 columns that starts on a multiple of 64 covers
// lanes 64 (tile parity) .. + 63, so the thread owns 32 (row, lane) places,
// 16 per parity, and keeps their running minima; every (row, lane) of a
// block is held by exactly one thread, which writes it at the end: no
// reduction inside a block. The minima live in shared memory (34,816
// bytes), not in registers: with the select gone a block needs 101,440
// bytes, so BLOCKS_PER_SM = 2 blocks share an SM, 18 warps, at most 5 on a
// sub-partition, which caps a thread at 96 registers; 32 minima in
// registers spilled there, and one block per SM with them in registers
// was 20% slower on the H100 (PERF.md section 6). 2048 queries make 32 blocks
// of 64, so the columns split across blocks in ranges of whole 128-column
// lane groups, as K2 splits them, until the launch gives every block slot
// of the card a block; a second pass (floor_merge) takes each (row,
// lane)'s minimum over the splits.
//
// What bounds it: the two bf16 products of d_pad per key at mma.sync's rate
// (the store streams once per block of 64 queries, mostly from L2); the
// epilogue is one subtraction and one minimum a key.
//
// TMA computes the addresses into the store and n2; column coordinates are
// 32-bit (S < 2^31).

#include "recon_mma.cuh"

namespace {

using recon_mma::BM;
using recon_mma::BN;
using recon_mma::NT;
using recon_mma::THREADS;

constexpr int LANES = 128;        // output lanes
constexpr int BLOCKS_PER_SM = 2;  // K7's blocks an SM holds (launch bounds)

// The epilogue policy of recon_mma::scan for K7: the running minimum of
// each (row, lane) of the block in shared memory, m[r * kStride + l],
// initialised to +inf. A thread's accumulator for row acc_row() + 8 h and
// tile column acc_col() + 8 nt + e is the key of lane BN * par + that
// column, par the tile's parity, so each thread updates and at the end
// writes its own places, 32 of them, which no other thread touches: no
// barrier and no reduction. The row stride of 136 floats puts a warp's
// 8-byte accesses, 8 rows x 4 lanes of a quad, in distinct banks per half
// warp.
struct LaneMin {
  static constexpr int kStride = LANES + 8;
  static constexpr int kBytes = BM * kStride * 4;
  float* m;
  __device__ explicit LaneMin(unsigned char* smem) : m(reinterpret_cast<float*>(smem)) {}
  // by every thread, before the scan's first block-wide barrier
  __device__ void init() {
    for (int i = threadIdx.x; i < BM * kStride; i += THREADS) m[i] = CUDART_INF_F;
  }
  // n2 - 2 * acc, as K2's epilogue computes a key (+inf past the walk's
  // valid columns), into the minima of the tile's lanes
  template <class Walk>
  __device__ __forceinline__ void tile(const recon_mma::Args&, const Walk& w, int t,
                                       const float* n2s, const float (&acc)[NT][4],
                                       long long, int) {
    const int c0 = recon_mma::acc_col();
    const int nval = w.valid(t);
    const int par = static_cast<int>((w.col(t) / BN) & 1);
    float* row = m + recon_mma::acc_row() * kStride + BN * par + c0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 nn = *reinterpret_cast<const float2*>(n2s + c0 + nt * 8);
      const float n2x = c0 + nt * 8 < nval ? nn.x : CUDART_INF_F;
      const float n2y = c0 + nt * 8 + 1 < nval ? nn.y : CUDART_INF_F;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* mp = reinterpret_cast<float2*>(row + 8 * h * kStride + 8 * nt);
        float2 v = *mp;
        v.x = fminf(v.x, n2x - 2.f * acc[nt][2 * h]);
        v.y = fminf(v.y, n2y - 2.f * acc[nt][2 * h + 1]);
        *mp = v;
      }
    }
  }
  // the thread's own places of its rows, to okey [nq, 128] (or a split's
  // part)
  __device__ void finish(const recon_mma::Args& a, long long q0, int rows) {
    const int r0 = recon_mma::acc_row(), c0 = recon_mma::acc_col();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= rows) continue;
      float* o = a.okey + (q0 + r) * LANES + c0;
      const float* mr = m + r * kStride + c0;
#pragma unroll
      for (int par = 0; par < 2; ++par)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          *reinterpret_cast<float2*>(o + BN * par + 8 * nt) =
              *reinterpret_cast<const float2*>(mr + BN * par + 8 * nt);
        }
    }
  }
};

// Tiles [c0 + t * BN, ...) of one split, clipped at c1.
struct Walk {
  long long c0, c1;
  int ntiles;
  __device__ long long col(int t) const {
    return c0 + static_cast<long long>(t) * BN;
  }
  __device__ int valid(int t) const {
    const long long v = c1 - col(t);
    return v < BN ? static_cast<int>(v) : BN;
  }
};

// Block b: query block b % qblocks of column split b / qblocks.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
recon_floor_kernel(recon_mma::Args a, const __grid_constant__ recon_mma::Maps maps,
                   long long nq, long long S, int qblocks, long long split_cols,
                   float* part) {
  const int qb = blockIdx.x % qblocks, p = blockIdx.x / qblocks;
  const long long q0 = static_cast<long long>(qb) * BM;
  const int rows = static_cast<int>(nq - q0 < BM ? nq - q0 : BM);
  Walk w;
  w.c0 = p * split_cols;
  w.c1 = w.c0 + split_cols < S ? w.c0 + split_cols : S;
  w.ntiles = w.c1 > w.c0 ? static_cast<int>((w.c1 - w.c0 + BN - 1) / BN) : 0;
  if (part != nullptr) a.okey = part + p * nq * LANES;  // a split's minima
  recon_mma::scan<false, LaneMin>(a, maps, w, q0, rows);
}

// out = the minimum over the splits of part [splits][n4] (float4s).
__global__ void floor_merge(const float4* __restrict__ part, int splits,
                            long long n4, float4* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 v = part[i];
  for (int p = 1; p < splits; ++p) {
    const float4 u = part[p * n4 + i];
    v.x = fminf(v.x, u.x);
    v.y = fminf(v.y, u.y);
    v.z = fminf(v.z, u.z);
    v.w = fminf(v.w, u.w);
  }
  out[i] = v;
}

}  // namespace

// Dynamic shared memory of one block (the ring, the queries and the
// minima), for d_pad a multiple of 128; -1 for any other.
extern "C" long long recon_floor_smem_bytes(int d_pad) {
  if (d_pad <= 0 || d_pad % recon_mma::QSEG != 0) return -1;
  return recon_mma::smem_bytes(false, LaneMin::kBytes);
}

// xq [nq, d_pad] float32, yT [d_pad, S] bf16 (contiguous), n2 [1, S] float32,
// out [nq, 128] float32. qt and ct are the TPU kernel's tiles, checked for
// the contract only: nq a multiple of qt (itself a multiple of 8), S a
// multiple of ct, itself a multiple of 128. With splits > 1 the columns
// split into that many ranges of whole 128-column lane groups and part
// ([splits][nq][128]) holds their minima until the merge. The caller has
// checked the 16-byte alignment TMA needs.
extern "C" int recon_floor_launch(const void* xq, const void* yT,
                                  const void* n2, void* out, void* part, int nq,
                                  int d_pad, long long S, int qt, int ct,
                                  int splits, void* stream) {
  if (nq <= 0 || nq >= (1 << 24) || qt <= 0 || nq % qt != 0 || qt % 8 != 0 ||
      ct <= 0 || ct % LANES != 0 || S % ct != 0 || S >= (1LL << 31) ||
      d_pad <= 0 || d_pad % recon_mma::QSEG != 0 || splits < 1 ||
      (splits > 1) != (part != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  recon_mma::Args a{};
  a.xq = static_cast<const float*>(xq);
  a.okey = static_cast<float*>(out);
  a.d_pad = d_pad;
  recon_mma::Maps maps;
  if (const int e = recon_mma::make_maps(&maps, yT, nullptr, S, n2, S, d_pad)) {
    return e;
  }
  const int smem = recon_mma::smem_bytes(false, LaneMin::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      recon_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = S / LANES;
  const long long split_cols = (groups + splits - 1) / splits * LANES;
  const int qblocks = (nq + BM - 1) / BM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pk = static_cast<float*>(part);
  recon_floor_kernel<<<qblocks * splits, THREADS, smem, st>>>(
      a, maps, nq, S, qblocks, split_cols, pk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n4 = static_cast<long long>(nq) * LANES / 4;
  floor_merge<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(pk), splits, n4,
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* recon_floor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
