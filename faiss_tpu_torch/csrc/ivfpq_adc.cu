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
// K4 runs on the tensor cores (adc_mma.cuh): the LUTs contracted with a
// one-hot of the codes built in registers, one mma.sync bf16 k-step per
// sub-quantizer, for 64 queries a block, into the exact select of
// tile_select.cuh; the columns split across blocks so that a launch gives
// every SM a block, and a second pass (tile_select::merge_splits) merges
// the splits' top-128s. It takes ksub <= 16 and LUT rows that fit its
// shared memory (M <= 37; tc_takes); the wrapper asks
// ivfpq_adc_smem_bytes(M, ksub, 1) and sends any other shape to the
// shared-memory lookup scan of adc_scan.cuh, chosen by shape before the
// launch (tc = 0), never as a fallback.
//
// K5 keeps the lookup scan of adc_scan.cuh, which K6 (ivfpq_v3.cu) shares
// for the shapes its tensor-core instances do not take: the LUT entries
// (bf16 values, exact in float32) looked up in shared memory and summed in
// float32, the bias added in float32 as given, closer to the float32 key
// than the TPU's hi + lo. What bounds it: the shared-memory lookups
// (adc_scan.cuh).

#include "adc_mma.cuh"
#include "adc_scan.cuh"

namespace {

using adc_mma::BN;

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether K4's tensor-core kernel takes a shape: the 16 entries of a
// sub-quantizer are one bf16 k-step, and a block's shared memory holds 64
// LUT rows of M * 16 entries. The wrapper routes by this (through
// ivfpq_adc_smem_bytes), so the decision lives here alone.
bool tc_takes(int M, int ksub) {
  return M > 0 && ksub > 0 && ksub <= 16 && adc_mma::smem_bytes(M) <= adc_mma::MAX_SMEM;
}

// K4 on the tensor cores; the caller has checked the common contract.
int launch_tc(const void* biasg, const void* luts, const void* codesT,
              const void* n2, const void* lid, void* out_key, void* out_slot,
              void* out_floor, void* part_key, void* part_slot, int nq,
              int nbias, int M, int ksub, long long S, int ct, int splits,
              cudaStream_t stream) {
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
  return adc_mma::launch<adc_mma::MODE_K4>(a, codesT, n2, lid, part_key, part_slot,
                                           nq, S, ct, splits, stream);
}

}  // namespace

// Dynamic shared memory of one block: of K4's tensor-core kernel for M
// sub-quantizers of ksub entries (tc != 0), or of the lookup scan for
// M * ksub bf16 LUT entries per query; -1 where that instance does not take
// the shape, which is how the wrapper chooses K4's instance.
extern "C" long long ivfpq_adc_smem_bytes(int M, int ksub, int tc) {
  if (tc) return tc_takes(M, ksub) ? adc_mma::smem_bytes(M) : -1;
  const int row = adc_scan::lut_row(M * ksub);
  return row ? adc_scan::smem_bytes(false, row) : -1;
}

// cmap and cgroup null: K4 over every chunk (msteps unused), on the tensor
// cores with tc != 0 (splits column splits, part_key / part_slot
// [splits][nq][128] their top-128s until the merge, null with one split),
// else by the lookup scan (splits 1); cmap and cgroup given: K5 over msteps
// worklist chunks per tile by the lookup scan (tc 0). nbias = G * 128 is
// biasg's row length.
extern "C" int ivfpq_adc_launch(const void* biasg, const void* luts,
                                const void* codesT, const void* n2,
                                const void* lid, const void* cmap,
                                const void* cgroup, void* out_key,
                                void* out_slot, void* out_floor,
                                void* part_key, void* part_slot, int nq,
                                int nbias, int M, int ksub, long long S,
                                int msteps, int qt, int ct, int splits, int tc,
                                void* stream) {
  const bool dyn = cmap != nullptr;
  if (nq <= 0 || qt <= 0 || nq % qt != 0 || qt % adc_scan::QB != 0 ||
      ct <= 0 || ct % 2 != 0 || S % ct != 0 || S >= (1LL << 31) || M <= 0 ||
      ksub <= 0 || ksub > 256 || adc_scan::lut_row(M * ksub) == 0 ||
      nbias <= 0 || nbias % adc_scan::K != 0 || dyn != (cgroup != nullptr) ||
      (dyn && msteps <= 0) || (tc && dyn) ||
      (!tc && (splits != 1 || part_key != nullptr || part_slot != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc) {
    return launch_tc(biasg, luts, codesT, n2, lid, out_key, out_slot, out_floor,
                     part_key, part_slot, nq, nbias, M, ksub, S, ct, splits, st);
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
