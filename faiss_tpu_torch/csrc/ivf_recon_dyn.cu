// K1: the dynamic-chunk recon scan with an exact top-128, for sm_90a, on
// the tensor cores.
//
// Replaces faiss_tpu/ops/pallas_knn.py:ivf_recon_fused_dyn_pallas with one
// bf16 store plane (IVF-PQ's decoded store) or two (IVF-Flat's vectors as hi
// and lo), in its soft and its penalized mode. It computes what that kernel
// computes, not how: for every query row r it returns the EXACT top-128 of
//     key(s) = n2[s] - 2 * q_r . (yT[:, s] + yT_lo[:, s])  (+ pen)
// over all slots s of the chunks cmap[r / qt, :], keys ascending, slots as
// packed positions chunk * ct + col (-1 where the key is +inf), and an all
// +inf eviction floor, since an exact select never evicts. The penalized mode
// (strict probing) adds pen = biasg[r, cgroup[chunk] * 128 + lid[s]], 0 on the
// query's probed lists and 1e9 elsewhere, in float32 as given (the TPU kernel
// rounds it to bf16 first, which moves only the ~1e9 keys).
//
// Design (recon_mma.cuh, tile_select.cuh). The products are the TPU
// kernel's (pallas_knn.py:1155-1181): the float32 query split into bf16 hi +
// lo in the prologue, then qh.yh + ql.yh + qh.yl with the lo plane and
// qh.y + ql.y without, on the tensor cores (mma.sync bf16, float32
// accumulators; recon_mma.cuh says why not wgmma). A block serves 64
// queries of one qt-query tile (fewer when qt < 64) and walks a share of
// that tile's worklist, chunk by chunk in tiles of 64 slots streamed by
// TMA: the grid is tiles x 64-query blocks x worklist splits, chosen by the
// wrapper so that the launch gives every SM a block, with the blocks that
// read the same chunks adjacent. With more than one split a second pass
// (tile_select::merge_splits) merges each query's per-split top-128s.
//
// PAD steps. A worklist lists its tile's probed chunks and fills the steps
// after them with the PAD chunk, the store's last chunk, whose n2 is +inf:
// its keys never pass the select's `key < threshold` test. So a block first
// finds the tile's last step that is not the PAD chunk and splits only the
// steps up to it (a PAD step among them, which no worklist of the port has,
// would be scanned, with the same result). The skipped steps are counted
// once per tile into `skipped` when it is given. recon_mma::dyn_block and
// ListWalk do this, for K5 too.
//
// What bounds it (PERF.md): the mma.sync products and the epilogue
// and select beside them; the qt / 64 blocks of a tile read the same
// chunks, mostly from L2. The penalized mode reads each row's bias once
// where a warp's 32 columns hold one list, and otherwise only for keys that
// would beat the threshold with their row's smallest bias in the chunk's
// group. Shared memory: 230,976 bytes with two planes, 198,208 with one
// (recon_mma.cuh); one block per SM.
//
// TMA computes the addresses into the planes and n2; slots and column
// coordinates are 32-bit (S < 2^31).

#include "recon_mma.cuh"

namespace {

using recon_mma::BM;
using recon_mma::BN;
using recon_mma::K;
using recon_mma::THREADS;

// Block b: sub-block b % subs of query tile (b / subs) % ntq, worklist split
// b / (subs * ntq), its steps cut after the tile's last non-PAD one
// (recon_mma::dyn_block).
template <bool PEN, bool HILO>
__global__ void __launch_bounds__(THREADS, 1)
ivf_recon_dyn_kernel(recon_mma::Args a, const __grid_constant__ recon_mma::Maps maps, const int* cmap, const int* cgroup,
                     long long nq, int msteps, int qt, int ct, int pad_chunk,
                     int subs, int ntq, float* part_key, int* part_slot,
                     unsigned long long* skipped) {
  // the reduction's int lies in the query planes, loaded after it
  extern __shared__ __align__(1024) unsigned char smem[];
  int* slot = reinterpret_cast<int*>(
      smem + recon_mma::ring_bytes(HILO) + recon_mma::STAGES * BN * 4);
  const recon_mma::DynBlock b = recon_mma::dyn_block(
      cmap, msteps, qt, pad_chunk, subs, ntq, BM, slot, skipped);
  const recon_mma::ListWalk<BN> w(b, cgroup, ct);
  if (part_key != nullptr) {  // a split's top-128s go to the scratch
    a.okey = part_key + b.p * nq * K;
    a.oslot = part_slot + b.p * nq * K;
    a.ofloor = nullptr;
  }
  recon_mma::scan<HILO, recon_mma::TopK<PEN>>(a, maps, w, b.q0, b.rows);
}

template <bool PEN, bool HILO>
int launch(const recon_mma::Args& a, const recon_mma::Maps& maps, const int* cmap, const int* cgroup,
           long long nq, int msteps, int qt, int ct, int pad_chunk,
           int splits, float* part_key, int* part_slot,
           unsigned long long* skipped, cudaStream_t stream) {
  constexpr int smem = recon_mma::smem_bytes(HILO);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_recon_dyn_kernel<PEN, HILO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int subs = (qt + BM - 1) / BM;
  const int ntq = static_cast<int>(nq / qt);
  ivf_recon_dyn_kernel<PEN, HILO><<<subs * ntq * splits, THREADS, smem, stream>>>(
      a, maps, cmap, cgroup, nq, msteps, qt, ct, pad_chunk, subs, ntq, part_key,
      part_slot, skipped);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block, with two planes (hilo != 0) or one.
extern "C" long long ivf_recon_dyn_smem_bytes(int hilo) {
  return recon_mma::smem_bytes(hilo != 0);
}

// yT_lo may be null (one plane); given, it has yT's shape and layout. biasg,
// lid and cgroup null: the soft mode; all three given: the penalized mode,
// with nbias = G * 128 the row length of biasg. pad_chunk is the PAD chunk's
// id (S / ct - 1). With splits > 1 each tile's steps split into that many
// ranges and part_key / part_slot ([splits][nq][128]) hold their top-128s
// until the merge. skipped (may be null) accumulates the PAD steps skipped.
extern "C" int ivf_recon_dyn_launch(const void* xq, const void* yT,
                                    const void* yT_lo, const void* n2,
                                    const void* cmap, const void* biasg,
                                    const void* lid, const void* cgroup,
                                    void* out_key, void* out_slot,
                                    void* out_floor, void* part_key,
                                    void* part_slot, void* skipped, int nq,
                                    int d_pad, long long S, int msteps, int qt,
                                    int ct, int nbias, int pad_chunk,
                                    int splits, void* stream) {
  const bool pen = biasg != nullptr;
  if (nq <= 0 || nq >= (1 << 24) || qt <= 0 || nq % qt != 0 || qt % 8 != 0 ||
      ct <= 0 ||
      ct % BN != 0 || d_pad <= 0 || d_pad % recon_mma::QSEG != 0 ||
      S % ct != 0 || S >= (1LL << 31) || msteps <= 0 ||
      pad_chunk != S / ct - 1 || pen != (lid != nullptr) ||
      pen != (cgroup != nullptr) || (pen && (nbias <= 0 || nbias % K != 0)) ||
      splits < 1 || (splits > 1) != (part_key != nullptr) ||
      (part_key != nullptr) != (part_slot != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  recon_mma::Args a;
  a.xq = static_cast<const float*>(xq);
  a.biasg = static_cast<const float*>(biasg);
  a.lid = static_cast<const int*>(lid);
  a.okey = static_cast<float*>(out_key);
  a.oslot = static_cast<int*>(out_slot);
  a.ofloor = static_cast<float*>(out_floor);
  a.d_pad = d_pad;
  a.nbias = nbias;
  recon_mma::Maps maps;
  if (const int e = recon_mma::make_maps(&maps, yT, yT_lo, S, n2, S, d_pad)) {
    return e;
  }
  const int* cm = static_cast<const int*>(cmap);
  const int* cg = static_cast<const int*>(cgroup);
  float* pk = static_cast<float*>(part_key);
  int* ps = static_cast<int*>(part_slot);
  unsigned long long* sk = static_cast<unsigned long long*>(skipped);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (pen && yT_lo != nullptr) {
    err = launch<true, true>(a, maps, cm, cg, nq, msteps, qt, ct, pad_chunk, splits, pk, ps, sk, st);
  } else if (pen) {
    err = launch<true, false>(a, maps, cm, cg, nq, msteps, qt, ct, pad_chunk, splits, pk, ps, sk, st);
  } else if (yT_lo != nullptr) {
    err = launch<false, true>(a, maps, cm, cg, nq, msteps, qt, ct, pad_chunk, splits, pk, ps, sk, st);
  } else {
    err = launch<false, false>(a, maps, cm, cg, nq, msteps, qt, ct, pad_chunk, splits, pk, ps, sk, st);
  }
  if (err != 0 || splits == 1) return err;
  tile_select::merge_splits<<<(nq + 3) / 4, 128, 0, st>>>(
      pk, ps, splits, nq, a.okey, a.oslot, a.ofloor);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ivf_recon_dyn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
