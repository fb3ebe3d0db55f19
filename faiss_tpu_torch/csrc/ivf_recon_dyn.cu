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
// Design (recon_wgmma.cuh, tile_select.cuh). The products are the TPU
// kernel's (pallas_knn.py:1155-1181): the float32 query split into bf16 hi +
// lo, then qh.yh + ql.yh + qh.yl with the lo plane and qh.y + ql.y
// without, on the tensor cores as wgmma.m64n64k16 bf16 products into
// float32 accumulators. A block serves 64 queries of one qt-query tile
// (fewer when qt < 64) and walks a share of that tile's worklist, chunk by
// chunk in tiles of 64 slots streamed by TMA; two consumer warpgroups take
// alternate tiles, so that one's products run while the other offers its
// keys to the select (recon_wgmma.cuh says why, and what bounds the scan).
// The products cover the real dims d only (rounded up to 32, 64 at least),
// not d_pad: the rows skipped are zeros in the store and the queries. The
// grid is tiles x 64-query blocks x worklist splits, chosen by the wrapper
// so that the launch gives every SM a block, with the blocks that read the
// same chunks adjacent. With more than one split a second pass
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
// Why wgmma with two warpgroups now: the mma.sync scan re-read its
// fragments with ldmatrix per warp and ran products, epilogue and select
// one after another in each warp, ~3,500 cycles a tile at Deep10M's shape
// (d 96 padded to 128), ~1,140 of them issuing products; two warpgroups
// taking alternate tiles overlap one's wgmma products with the other's
// select, and the padding's quarter of the products goes: ~1,420 cycles a
// tile, 2.1-2.5x faster on the H100 (PERF.md). What bounds it now: each
// row group's turn at the select (~870 cycles a tile), which also holds
// its warpgroup's next products, since a wgmma waits for all 4 warps; at
// SIFT1M's shape the select's appends and compactions set the pace.
//
// The penalized mode reads each row's bias once where a warp's 64 columns
// hold one list, and otherwise only for keys that would beat the threshold
// with their row's smallest bias in the chunk's group. Shared memory:
// 230,704 bytes with two planes, 198,208 with one (recon_wgmma.cuh); one
// block per SM.
//
// TMA computes the addresses into the planes and n2; slots and column
// coordinates are 32-bit (S < 2^31).

#include "recon_mma.cuh"
#include "recon_wgmma.cuh"

namespace {

using recon_wgmma::BM;
using recon_wgmma::BN;
using recon_wgmma::THREADS;

// Block b: sub-block b % subs of query tile (b / subs) % ntq, worklist split
// b / (subs * ntq), its steps cut after the tile's last non-PAD one
// (recon_mma::dyn_block).
template <bool PEN, bool HILO, int NKS, bool RELOAD>
__global__ void __launch_bounds__(THREADS, 1)
ivf_recon_dyn_kernel(recon_mma::Args a, const __grid_constant__ recon_mma::Maps maps, const int* cmap, const int* cgroup,
                     long long nq, int msteps, int qt, int ct, int pad_chunk,
                     int subs, int ntq, int d_eff, float* part_key, int* part_slot,
                     unsigned long long* skipped) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int ST = recon_wgmma::stages(HILO);
  unsigned char* sel_bytes = smem + ST * (recon_wgmma::stage_bytes(HILO) + BN * 4);
  const uint32_t full = recon_mma::smem_u32(sel_bytes + recon_wgmma::Select::kBytes);
  // the reduction's int lies in the select, initialised after it
  const recon_mma::DynBlock b = recon_mma::dyn_block(
      cmap, msteps, qt, pad_chunk, subs, ntq, BM, reinterpret_cast<int*>(sel_bytes),
      skipped);
  const recon_mma::ListWalk<BN> w(b, cgroup, ct);
  if (part_key != nullptr) {  // a split's top-128s go to the scratch
    a.okey = part_key + b.p * nq * recon_mma::K;
    a.oslot = part_slot + b.p * nq * recon_mma::K;
    a.ofloor = nullptr;
  }
  recon_wgmma::Select sel(sel_bytes);
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      recon_mma::mbar_init(full + 8 * i, 1);
      recon_mma::mbar_init(full + 8 * (ST + i), 4);  // a warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  sel.init(THREADS);
  __syncthreads();
  recon_wgmma::scan<PEN, HILO, NKS, RELOAD>(a, maps, w, b.q0, b.rows, d_eff, smem,
                                            sel, full);
}

// One instance: the products' k-steps are a constant of the kernel.
template <bool PEN, bool HILO, int NKS, bool RELOAD>
int launch(const recon_mma::Args& a, const recon_mma::Maps& maps, const int* cmap, const int* cgroup,
           long long nq, int msteps, int qt, int ct, int pad_chunk, int d_eff,
           int splits, float* part_key, int* part_slot,
           unsigned long long* skipped, cudaStream_t stream) {
  constexpr int smem = recon_wgmma::smem_bytes(HILO);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_recon_dyn_kernel<PEN, HILO, NKS, RELOAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int subs = (qt + BM - 1) / BM;
  const int ntq = static_cast<int>(nq / qt);
  ivf_recon_dyn_kernel<PEN, HILO, NKS, RELOAD>
      <<<subs * ntq * splits, THREADS, smem, stream>>>(
          a, maps, cmap, cgroup, nq, msteps, qt, ct, pad_chunk, subs, ntq, d_eff,
          part_key, part_slot, skipped);
  return static_cast<int>(cudaGetLastError());
}

// The instance for d real dims: 4, 6 or 8 k-steps held in registers (d
// rounded up to 32, 64 at least), or d > 128 in whole reloaded segments of
// 128.
template <bool PEN, bool HILO>
int launch_d(const recon_mma::Args& a, const recon_mma::Maps& maps, const int* cmap,
             const int* cgroup, long long nq, int msteps, int qt, int ct, int pad_chunk,
             int d, int splits, float* part_key, int* part_slot,
             unsigned long long* skipped, cudaStream_t stream) {
#define K1_LAUNCH(NKS, RELOAD)                                                  \
  launch<PEN, HILO, NKS, RELOAD>(                                                \
      a, maps, cmap, cgroup, nq, msteps, qt, ct, pad_chunk,                      \
      recon_wgmma::scan_dims(d, NKS, RELOAD), splits, part_key, part_slot,       \
      skipped, stream)
  if (d > recon_wgmma::SEG) return K1_LAUNCH(8, true);
  switch ((d + 31) / 32) {
    case 1:
    case 2: return K1_LAUNCH(4, false);
    case 3: return K1_LAUNCH(6, false);
    default: return K1_LAUNCH(8, false);
  }
#undef K1_LAUNCH
}

// The dims the launch for d reads and multiplies (launch_d's choice).
int scan_dims_of(int d) {
  if (d > recon_wgmma::SEG) return recon_wgmma::scan_dims(d, 8, true);
  return recon_wgmma::scan_dims(d, d > 64 ? (d + 31) / 32 * 2 : 4, false);
}

}  // namespace

// Dynamic shared memory of one block, with two planes (hilo != 0) or one.
extern "C" long long ivf_recon_dyn_smem_bytes(int hilo) {
  return recon_wgmma::smem_bytes(hilo != 0);
}

// yT_lo may be null (one plane); given, it has yT's shape and layout. biasg,
// lid and cgroup null: the soft mode; all three given: the penalized mode,
// with nbias = G * 128 the row length of biasg. d (0 < d <= d_pad) is the
// queries' and the store's real dims: the rows from d on are zeros and are
// neither read past d rounded up to 32 (64 at least, 128s past 128) nor
// multiplied.
// pad_chunk is the PAD chunk's id (S / ct - 1). With splits > 1 each tile's
// steps split into that many ranges and part_key / part_slot
// ([splits][nq][128]) hold their top-128s until the merge. skipped (may be
// null) accumulates the PAD steps skipped.
extern "C" int ivf_recon_dyn_launch(const void* xq, const void* yT,
                                    const void* yT_lo, const void* n2,
                                    const void* cmap, const void* biasg,
                                    const void* lid, const void* cgroup,
                                    void* out_key, void* out_slot,
                                    void* out_floor, void* part_key,
                                    void* part_slot, void* skipped, int nq,
                                    int d_pad, int d, long long S, int msteps,
                                    int qt, int ct, int nbias, int pad_chunk,
                                    int splits, void* stream) {
  const bool pen = biasg != nullptr;
  if (nq <= 0 || nq >= (1 << 24) || qt <= 0 || nq % qt != 0 || qt % 8 != 0 ||
      ct <= 0 ||
      ct % BN != 0 || d_pad <= 0 || d_pad % recon_mma::QSEG != 0 || d <= 0 ||
      d > d_pad || S % ct != 0 || S >= (1LL << 31) || msteps <= 0 ||
      pad_chunk != S / ct - 1 || pen != (lid != nullptr) ||
      pen != (cgroup != nullptr) || (pen && (nbias <= 0 || nbias % recon_mma::K != 0)) ||
      splits < 1 || (splits > 1) != (part_key != nullptr) ||
      (part_key != nullptr) != (part_slot != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int d_eff = scan_dims_of(d);
  recon_mma::Args a;
  a.xq = static_cast<const float*>(xq);
  a.biasg = static_cast<const float*>(biasg);
  a.lid = static_cast<const int*>(lid);
  a.okey = static_cast<float*>(out_key);
  a.oslot = static_cast<int*>(out_slot);
  a.ofloor = static_cast<float*>(out_floor);
  a.d_pad = d_pad;
  a.nbias = nbias;
  // the planes' rows end at d_eff (at least one box): TMA zero-fills a
  // box's rows past it
  recon_mma::Maps maps;
  const int rows = d_eff > recon_wgmma::KC ? d_eff : recon_wgmma::KC;
  if (const int e = recon_mma::make_maps(&maps, yT, yT_lo, S, n2, S, rows)) {
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
    err = launch_d<true, true>(a, maps, cm, cg, nq, msteps, qt, ct, pad_chunk, d, splits, pk, ps, sk, st);
  } else if (pen) {
    err = launch_d<true, false>(a, maps, cm, cg, nq, msteps, qt, ct, pad_chunk, d, splits, pk, ps, sk, st);
  } else if (yT_lo != nullptr) {
    err = launch_d<false, true>(a, maps, cm, cg, nq, msteps, qt, ct, pad_chunk, d, splits, pk, ps, sk, st);
  } else {
    err = launch_d<false, false>(a, maps, cm, cg, nq, msteps, qt, ct, pad_chunk, d, splits, pk, ps, sk, st);
  }
  if (err != 0 || splits == 1) return err;
  tile_select::merge_splits<<<(nq + 3) / 4, 128, 0, st>>>(
      pk, ps, splits, nq, a.okey, a.oslot, a.ofloor);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ivf_recon_dyn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
