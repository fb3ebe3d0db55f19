// K4 and K5: the code-streaming IVF-PQ ADC scans with an exact top-128, for
// sm_90a.
//
// Replace faiss_tpu/ops/pallas_knn.py:ivfpq_fused_pallas (K4: every chunk in
// order) and ivfpq_fused_dyn_pallas (K5: the chunks of each query tile's
// worklist). They compute what those kernels compute, not how: for every
// query row r the EXACT top-128 of
//     key(s) = n2[s] + biasg[r, g * 128 + lid[s]]
//              + sum_m luts[r, m * ksub + codesT[m, s]]
// with g = min(chunk / cpg, G - 1) for K4 and g = cgroup[chunk] for K5, over
// bf16 LUTs. The scan itself, its arithmetic, design and bound are those of
// adc_scan.cuh, which K6 (ivfpq_v3.cu) shares.
//
// Arithmetic. The TPU kernel contracts the bf16 LUTs with a one-hot of the
// codes on its matrix unit, and the bias, split into bf16 hi + lo, with a
// one-hot of the list ids. Here the LUT entries (bf16 values, exact in
// float32) are looked up and summed in float32, and the bias is added in
// float32 as given: closer to the float32 key than the TPU's hi + lo.
//
// What bounds it: the shared-memory lookups (adc_scan.cuh). Packed 4-bit
// codes with LUTs in registers and byte permutes (faiss's FastScan) and
// skipping the chunks of masked groups are later work.

#include "adc_scan.cuh"

// Dynamic shared memory of one block for M * ksub bf16 LUT entries per query.
extern "C" long long ivfpq_adc_smem_bytes(int mk) {
  const int row = adc_scan::lut_row(mk);
  return row ? adc_scan::smem_bytes(false, row) : -1;
}

// cmap and cgroup null: K4 over every chunk (msteps unused); else K5 over
// msteps worklist chunks per tile. nbias = G * 128 is biasg's row length.
extern "C" int ivfpq_adc_launch(const void* biasg, const void* luts,
                                const void* codesT, const void* n2,
                                const void* lid, const void* cmap,
                                const void* cgroup, void* out_key,
                                void* out_slot, void* out_floor, int nq,
                                int nbias, int M, int ksub, long long S,
                                int msteps, int qt, int ct, void* stream) {
  const bool dyn = cmap != nullptr;
  if (nq <= 0 || qt <= 0 || nq % qt != 0 || qt % adc_scan::QB != 0 ||
      ct <= 0 || ct % 2 != 0 || S % ct != 0 || S >= (1LL << 31) || M <= 0 ||
      ksub <= 0 || ksub > 256 || adc_scan::lut_row(M * ksub) == 0 ||
      nbias <= 0 || nbias % adc_scan::K != 0 || dyn != (cgroup != nullptr) ||
      (dyn && msteps <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
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
