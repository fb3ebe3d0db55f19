// K4 and K5: the code-streaming IVF-PQ ADC scans with an exact top-128, for
// sm_90a.
//
// Replace faiss_tpu/ops/pallas_knn.py:ivfpq_fused_pallas (K4: every chunk in
// order) and ivfpq_fused_dyn_pallas (K5: the chunks of each query tile's
// worklist). For every query row r they return the EXACT top-128 of
//     key(s) = n2[s] + biasg[r, g * 128 + lid[s]]
//              + sum_m luts[r, m * ksub + codesT[m, s]]
// with g = min(chunk / cpg, G - 1) for K4 and g = cgroup[chunk] for K5, over
// bf16 LUTs.
//
// Both run on the tensor cores (adc_mma.cuh) in MODE_K4, the TPU kernels'
// order of additions (lsum + n2) + bias (pallas_knn.py:380 for K4, :515 for
// K5): the LUTs contracted with a one-hot of the codes built in registers,
// one mma.sync bf16 k-step per sub-quantizer, for 64 queries a block, into
// the exact select of tile_select.cuh, and a second pass
// (tile_select::merge_splits) merges the splits' top-128s. K4 splits the
// columns across blocks so that a launch gives every SM a block. K5 maps
// its blocks as K1 does (recon_mma::dyn_block): each 64-query sub-block of
// a qt-query tile walks a split of the tile's worklist steps, chunk by
// chunk in tiles of 128 slots (recon_mma::ListWalk), and stops at the
// tile's last step that is not the PAD chunk (the store's last chunk, all
// +inf n2), counting the steps it skipped.
//
// The tensor-core kernel takes ksub <= 16 and LUT rows that fit its shared
// memory (M <= 37; tc_takes); the wrapper asks ivfpq_adc_smem_bytes(M,
// ksub, 1) and sends any other shape, for K4 and K5 alike, to the
// shared-memory lookup scan of adc_scan.cuh, chosen by shape before the
// launch (tc = 0), never as a fallback: the LUT entries (bf16 values, exact
// in float32) looked up in shared memory and summed in float32, the bias
// added in float32 as given. What bounds that scan: the shared-memory
// lookups (adc_scan.cuh); what bounds the tensor-core one: its products and
// epilogue (adc_mma.cuh).

#include "adc_mma.cuh"
#include "adc_scan.cuh"

namespace {

using adc_mma::BM;
using adc_mma::BN;
using adc_mma::K;

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether the tensor-core kernel takes a shape: the 16 entries of a
// sub-quantizer are one bf16 k-step, and a block's shared memory holds 64
// LUT rows of M * 16 entries. The wrapper routes by this (through
// ivfpq_adc_smem_bytes), so the decision lives here alone.
bool tc_takes(int M, int ksub) {
  return M > 0 && ksub > 0 && ksub <= 16 && adc_mma::smem_bytes(M) <= adc_mma::MAX_SMEM;
}

// K5: block b is sub-block b % subs of query tile (b / subs) % ntq over
// split b / (subs * ntq) of the tile's worklist steps, those after its last
// non-PAD step skipped (recon_mma::dyn_block, as K1), in MODE_K4.
__global__ void __launch_bounds__(adc_mma::THREADS, 1)
adc_dyn_kernel(adc_mma::Args a, const __grid_constant__ adc_mma::Maps maps,
               const int* cmap, const int* cgroup, long long nq, int msteps,
               int qt, int ct, int pad_chunk, int subs, int ntq, float* part_key,
               int* part_slot, unsigned long long* skipped) {
  // the reduction's int lies in the LUT rows, loaded after it
  extern __shared__ __align__(1024) unsigned char adc_smem[];
  int* slot = reinterpret_cast<int*>(adc_smem + adc_mma::STAGES * adc_mma::stage_bytes(a.M));
  const recon_mma::DynBlock b = recon_mma::dyn_block(
      cmap, msteps, qt, pad_chunk, subs, ntq, BM, slot, skipped);
  const recon_mma::ListWalk<BN> w(b, cgroup, ct);
  if (part_key != nullptr) {  // a split's top-128s go to the scratch
    a.okey = part_key + b.p * nq * K;
    a.oslot = part_slot + b.p * nq * K;
    a.ofloor = nullptr;
  }
  adc_mma::scan<adc_mma::MODE_K4>(a, maps, w, b.q0, b.rows);
}

// K5 on the tensor cores over codesT [M, S], n2 and lid [S] for a's nq
// rows: tile t's chunks cmap[t, :msteps] with groups cgroup, the store's
// last chunk the PAD chunk, each tile's worklist steps in `splits` ranges
// (part_key / part_slot [splits][nq][128] their top-128s until the merge),
// the skipped PAD steps counted into `skipped` when given.
int launch_dyn(const adc_mma::Args& a, const void* codesT, const void* n2,
               const void* lid, const int* cmap, const int* cgroup,
               void* part_key, void* part_slot, unsigned long long* skipped,
               int nq, long long S, int msteps, int qt, int ct, int splits,
               cudaStream_t stream) {
  adc_mma::Maps maps;
  if (const int e = adc_mma::make_maps(&maps, codesT, n2, lid, S, a.M)) return e;
  const int smem = adc_mma::smem_bytes(a.M);
  cudaError_t err = cudaFuncSetAttribute(
      adc_dyn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int subs = (qt + BM - 1) / BM;
  const int ntq = nq / qt;
  float* pk = static_cast<float*>(part_key);
  int* ps = static_cast<int*>(part_slot);
  adc_dyn_kernel<<<subs * ntq * splits, adc_mma::THREADS, smem, stream>>>(
      a, maps, cmap, cgroup, nq, msteps, qt, ct, static_cast<int>(S / ct) - 1,
      subs, ntq, pk, ps, skipped);
  return adc_mma::merge(a, pk, ps, nq, splits, stream);
}

// K4 (cmap null) or K5 on the tensor cores; the caller has checked the
// common contract.
int launch_tc(const void* biasg, const void* luts, const void* codesT,
              const void* n2, const void* lid, const void* cmap,
              const void* cgroup, void* out_key, void* out_slot,
              void* out_floor, void* part_key, void* part_slot, void* skipped,
              int nq, int nbias, int M, int ksub, long long S, int msteps,
              int qt, int ct, int splits, cudaStream_t stream) {
  if (!tc_takes(M, ksub) || ct % BN != 0 || splits < 1 ||
      (splits > 1) != (part_key != nullptr) ||
      (part_key != nullptr) != (part_slot != nullptr) || !aligned16(biasg) ||
      !aligned16(codesT) || !aligned16(n2) || !aligned16(lid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  adc_mma::Args a;
  a.biasg = static_cast<const float*>(biasg);
  a.luts = luts;
  a.meta = nullptr;
  a.okey = static_cast<float*>(out_key);
  a.oslot = static_cast<int*>(out_slot);
  a.ofloor = static_cast<float*>(out_floor);
  a.nbias = nbias;
  a.M = M;
  a.ksub = ksub;
  if (cmap == nullptr) {
    return adc_mma::launch<adc_mma::MODE_K4>(a, codesT, n2, lid, part_key, part_slot,
                                             nq, S, ct, splits, stream);
  }
  return launch_dyn(a, codesT, n2, lid, static_cast<const int*>(cmap),
                    static_cast<const int*>(cgroup), part_key, part_slot,
                    static_cast<unsigned long long*>(skipped), nq, S, msteps, qt,
                    ct, splits, stream);
}

}  // namespace

// Dynamic shared memory of one block: of the tensor-core kernel (K4's and
// K5's) for M sub-quantizers of ksub entries (tc != 0), or of the lookup
// scan for M * ksub bf16 LUT entries per query; -1 where that instance does
// not take the shape, which is how the wrapper chooses the instance.
extern "C" long long ivfpq_adc_smem_bytes(int M, int ksub, int tc) {
  if (tc) return tc_takes(M, ksub) ? adc_mma::smem_bytes(M) : -1;
  const int row = adc_scan::lut_row(M * ksub);
  return row ? adc_scan::smem_bytes(false, row) : -1;
}

// cmap and cgroup null: K4 over every chunk (msteps unused); cmap and
// cgroup given: K5 over msteps worklist chunks per qt-query tile, the
// store's last chunk the PAD chunk. tc != 0: the tensor-core kernel, with
// `splits` splits of the columns (K4) or of each tile's worklist steps
// (K5), part_key / part_slot [splits][nq][128] their top-128s until the
// merge (null with one split), and K5's skipped PAD steps added to
// `skipped` (may be null); tc = 0: the lookup scan (splits 1, skipped
// unused). nbias = G * 128 is biasg's row length.
extern "C" int ivfpq_adc_launch(const void* biasg, const void* luts,
                                const void* codesT, const void* n2,
                                const void* lid, const void* cmap,
                                const void* cgroup, void* out_key,
                                void* out_slot, void* out_floor,
                                void* part_key, void* part_slot, void* skipped,
                                int nq, int nbias, int M, int ksub, long long S,
                                int msteps, int qt, int ct, int splits, int tc,
                                void* stream) {
  const bool dyn = cmap != nullptr;
  if (nq <= 0 || qt <= 0 || nq % qt != 0 ||
      qt % adc_scan::QB != 0 || ct <= 0 || ct % 2 != 0 || S % ct != 0 ||
      S >= (1LL << 31) || M <= 0 || ksub <= 0 || ksub > 256 ||
      adc_scan::lut_row(M * ksub) == 0 || nbias <= 0 ||
      nbias % adc_scan::K != 0 || dyn != (cgroup != nullptr) ||
      (dyn && msteps <= 0) ||
      (!tc && (splits != 1 || part_key != nullptr || part_slot != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc) {
    return launch_tc(biasg, luts, codesT, n2, lid, cmap, cgroup, out_key,
                     out_slot, out_floor, part_key, part_slot, skipped, nq,
                     nbias, M, ksub, S, msteps, qt, ct, splits, st);
  }
  const int nchunks = static_cast<int>(S / ct);
  const int G = nbias / adc_scan::K;
  const adc_scan::Args a{biasg, luts, nullptr, codesT, n2, lid, cmap, cgroup,
                         out_key, out_slot, out_floor, nq, nbias, M, ksub, S,
                         dyn ? msteps : nchunks, qt, ct,
                         max(1, nchunks / G), G};
  return dyn ? adc_scan::launch_row<true, false>(a, stream)
             : adc_scan::launch_row<false, false>(a, stream);
}

extern "C" const char* ivfpq_adc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
