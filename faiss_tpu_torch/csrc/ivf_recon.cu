// K2: the exhaustive recon scan with an exact top-128, for sm_90a, on the
// tensor cores.
//
// Replaces faiss_tpu/ops/pallas_knn.py:ivf_recon_fused_pallas with one bf16
// store plane or two (hi and lo), unmasked or masked. For every query row r
// it returns the EXACT top-128 of
//     key(s) = n2[s] - 2 * q_r . (y_hi[:, s] + y_lo[:, s])  (+ pen)
// over every column s of the store, keys ascending (the query norm is not
// added), the column of each key (-1 where the key is +inf), and an all +inf
// eviction floor, since the select never evicts. The masked mode (strict
// probing over the whole store: IVF-PQ's decoded store, one plane, and
// IVF-Flat's vectors, hi and lo) adds pen = biasg[r, g * 128 + lid[s]] with
// the static group g = min((s / ct) / cpg, G - 1), 0 on the query's probed
// lists and 1e9 elsewhere, in float32 as given (the TPU kernel rounds it to
// bf16 first, which moves only the ~1e9 keys). The store may be a column
// slice of a wider one (a stripe of the striped large-k flat path): ``ld``
// is the row stride of both planes, so no stripe is copied.
//
// Design (recon_mma.cuh, tile_select.cuh). The products are the TPU
// kernel's: the float32 query split into bf16 hi + lo in the prologue, then
// qh.yh + ql.yh + qh.yl with two planes and qh.y + ql.y with one, on the
// tensor cores (mma.sync bf16, float32 accumulators; recon_mma.cuh says
// why not wgmma). That is the case the exact-flat certificate's delta
// (models/flat.py _screen_delta) was sized for. A block serves 64 queries
// and walks one split of the columns in tiles of 64, streamed by TMA; the
// grid is query blocks x column splits, the splits chosen by the wrapper so
// that the launch gives every SM a block, with the blocks of one split
// adjacent so that they run together and share its lines in L2. Each block
// keeps an exact top-128 per query; with more than one split a second pass
// (tile_select::merge_splits) merges each query's per-split top-128s. The
// masked mode reads each row's bias once where a warp's 32 columns hold one
// list, and otherwise looks a key up in biasg only when, with the smallest
// bias of its row and group, it would still beat the row's threshold.
//
// What bounds it (PERF.md): the mma.sync products and, beside them,
// the epilogue and select, partly hidden behind other warps' products; the
// store streams once per block of 64 queries, mostly from L2. Shared memory:
// 230,976 bytes with two planes, 198,208 with one; one block per SM.
//
// TMA computes the addresses into the planes and n2; column indices (the
// slots) are 32-bit (S < 2^31).

#include "recon_mma.cuh"

namespace {

using recon_mma::BM;
using recon_mma::BN;
using recon_mma::K;
using recon_mma::THREADS;

// Tiles [c0 + t * BN, ...) of one split, clipped at c1.
struct Walk {
  long long c0, c1;
  int ntiles;
  int ct, cpg, gmax;
  __device__ long long col(int t) const {
    return c0 + static_cast<long long>(t) * BN;
  }
  __device__ int valid(int t) const {
    const long long v = c1 - col(t);
    return v < BN ? static_cast<int>(v) : BN;
  }
  __device__ int group(int t) const {
    const long long g = col(t) / ct / cpg;
    return g < gmax ? static_cast<int>(g) : gmax;
  }
};

// Block b: query block b % qblocks of column split b / qblocks.
template <bool HILO, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
ivf_recon_kernel(recon_mma::Args a, const __grid_constant__ recon_mma::Maps maps, long long nq, long long S, int qblocks,
                 long long split_cols, int ct, int cpg, int gmax,
                 float* part_key, int* part_slot) {
  const int qb = blockIdx.x % qblocks, p = blockIdx.x / qblocks;
  const long long q0 = static_cast<long long>(qb) * BM;
  const int rows = static_cast<int>(nq - q0 < BM ? nq - q0 : BM);
  Walk w;
  w.c0 = p * split_cols;
  w.c1 = w.c0 + split_cols < S ? w.c0 + split_cols : S;
  w.ntiles = w.c1 > w.c0 ? static_cast<int>((w.c1 - w.c0 + BN - 1) / BN) : 0;
  w.ct = ct;
  w.cpg = cpg;
  w.gmax = gmax;
  if (part_key != nullptr) {  // a split's top-128s go to the scratch
    a.okey = part_key + p * nq * K;
    a.oslot = part_slot + p * nq * K;
    a.ofloor = nullptr;
  }
  recon_mma::scan<HILO, recon_mma::TopK<MASKED>>(a, maps, w, q0, rows);
}

template <bool HILO, bool MASKED>
int launch(const recon_mma::Args& a, const recon_mma::Maps& maps, long long nq, long long S, int splits,
           long long split_cols, int ct, int cpg, int gmax, float* part_key,
           int* part_slot, cudaStream_t stream) {
  constexpr int smem = recon_mma::smem_bytes(HILO);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_recon_kernel<HILO, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qblocks = static_cast<int>((nq + BM - 1) / BM);
  ivf_recon_kernel<HILO, MASKED><<<qblocks * splits, THREADS, smem, stream>>>(
      a, maps, nq, S, qblocks, split_cols, ct, cpg, gmax, part_key, part_slot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block, with two planes (hilo != 0) or one.
extern "C" long long ivf_recon_smem_bytes(int hilo) {
  return recon_mma::smem_bytes(hilo != 0);
}

// yT_lo may be null (one plane). biasg and lid null: unmasked; both given:
// masked, with nbias = G * 128 the row length of biasg. qt is the TPU
// kernel's query tile: a block here does not need it, and it is checked for
// the contract only (nq a multiple of qt, itself a multiple of 8); ct sets
// the chunks of the masked mode's static groups. With splits > 1 the
// columns split into that many ranges of whole tiles and part_key /
// part_slot ([splits][nq][128]) hold their top-128s until the merge.
extern "C" int ivf_recon_launch(const void* xq, const void* yT,
                                const void* yT_lo, long long ld,
                                const void* n2, const void* biasg,
                                const void* lid, void* out_key, void* out_slot,
                                void* out_floor, void* part_key,
                                void* part_slot, int nq, int d_pad,
                                long long S, int qt, int ct, int nbias,
                                int splits, void* stream) {
  const bool masked = biasg != nullptr;
  if (nq <= 0 || nq >= (1 << 24) || qt <= 0 || nq % qt != 0 || qt % 8 != 0 ||
      ct <= 0 ||
      ct % 2 != 0 || S % ct != 0 || d_pad <= 0 || d_pad % recon_mma::QSEG != 0 ||
      ld % 8 != 0 || ld < S || S >= (1LL << 31) ||
      masked != (lid != nullptr) || (masked && ct % BN != 0) ||
      (masked && (nbias <= 0 || nbias % K != 0)) || splits < 1 ||
      (splits > 1) != (part_key != nullptr) ||
      (part_key != nullptr) != (part_slot != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cpg = max(1, static_cast<int>(S / ct) / max(1, nbias / K));
  const long long tiles = (S + BN - 1) / BN;
  const long long split_cols = (tiles + splits - 1) / splits * BN;
  recon_mma::Args a;
  a.xq = static_cast<const float*>(xq);
  a.biasg = static_cast<const float*>(biasg);
  a.lid = static_cast<const int*>(lid);
  a.okey = static_cast<float*>(out_key);
  a.oslot = static_cast<int*>(out_slot);
  a.ofloor = static_cast<float*>(out_floor);
  a.d_pad = d_pad;
  a.nbias = nbias;
  const int gmax = masked ? nbias / K - 1 : 0;
  recon_mma::Maps maps;
  if (const int e = recon_mma::make_maps(&maps, yT, yT_lo, ld, n2, S, d_pad)) {
    return e;
  }
  float* pk = static_cast<float*>(part_key);
  int* ps = static_cast<int*>(part_slot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (masked && yT_lo != nullptr) {
    err = launch<true, true>(a, maps, nq, S, splits, split_cols, ct, cpg, gmax, pk, ps, st);
  } else if (masked) {
    err = launch<false, true>(a, maps, nq, S, splits, split_cols, ct, cpg, gmax, pk, ps, st);
  } else if (yT_lo != nullptr) {
    err = launch<true, false>(a, maps, nq, S, splits, split_cols, ct, cpg, gmax, pk, ps, st);
  } else {
    err = launch<false, false>(a, maps, nq, S, splits, split_cols, ct, cpg, gmax, pk, ps, st);
  }
  if (err != 0 || splits == 1) return err;
  tile_select::merge_splits<<<(nq + 3) / 4, 128, 0, st>>>(
      pk, ps, splits, nq, a.okey, a.oslot, a.ofloor);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ivf_recon_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
