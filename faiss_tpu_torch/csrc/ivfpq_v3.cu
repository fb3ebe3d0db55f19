// K6: IVF-PQ ADC over a precomputed one-hot layout, with bf16 or int8 LUTs
// and an exact top-128, for sm_90a.
//
// Replaces faiss_tpu/ops/pallas_knn.py:ivfpq_fused_pallas_v3. Its input is
// the one-hot ohT [M * ksub + 128, S] (bf16 or int8; rows m * ksub + code of
// the PQ codes, then 128 rows of the local list ids, ops/quantize_lut.py
// expand_onehot), and for every query row r it returns the EXACT top-128 of
//     bf16 LUTs: key(s) = (luts_r . oh_pq[:, s]) + biasg_g . oh_list[:, s]
//                         + n2[s]
//     int8 LUTs: key(s) = a * (q8_r . oh_pq[:, s]) + c
//                         + (biasg_g . oh_list[:, s] + n2[s])
// with biasg_g the 128 bias columns of the chunk's static group
// g = chunk / cpg (nchunks a multiple of G), and (a, c) from meta at the
// slot's lane. With a valid one-hot the bf16 key is K4's key over the codes
// the one-hot encodes, and the int8 dot product picks one quantized entry
// per sub-quantizer: an exact int32 sum.
//
// Design. The TPU kernel contracts the one-hot on its matrix unit, so it
// streams the whole one-hot, (M * ksub + 128) entries per slot, 20-40x the
// bytes of the codes, for every tile of queries. Here a first pass reads the
// one-hot once per launch: each thread takes 16 bytes of columns (8 bf16 or
// 16 int8), walks the rows of each sub-quantizer's block with coalesced
// 16-byte loads, and writes the column's code [M, S] uint8 and local list id
// [1, S] int32 into scratch that the wrapper allocates. A column that is not
// a one-hot (an entry other than 0 and 1, or not exactly one 1 in a
// sub-quantizer's block of ksub rows or in the 128 list rows) is counted in
// ``bad``, which the wrapper reads after the launch and raises on. Then K4's
// scan (adc_scan.cuh) runs over the decoded codes, with the LUT type as its
// template argument: bf16 LUTs summed in float32, or int8 LUTs summed
// exactly in int32 and dequantized per query.
//
// What bounds it: the scan's shared-memory lookups (M + 1 per query and
// slot, adc_scan.cuh), as K4; the one-hot pass adds one read of ohT
// (0.4 ms at 3.35 TB/s for 640 x 2^20 bf16 entries). The tensor-core form,
// the literal contraction with wgmma (int8 at twice the bf16 rate), is
// later work.
//
// Offsets are 64-bit; slots are 32-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "adc_scan.cuh"

namespace {

constexpr int LIST_ROWS = 128;  // local list rows of the one-hot
constexpr int DECODE_THREADS = 256;

// 1 if e is a one, 0 if a zero (+0 or -0 for bf16), -1 otherwise; E is the
// raw element (bf16 bits or int8).
__device__ __forceinline__ int classify(unsigned short e) {
  return e == 0x3F80 ? 1 : (e & 0x7FFF) == 0 ? 0 : -1;
}
__device__ __forceinline__ int classify(signed char e) {
  return e == 1 ? 1 : e == 0 ? 0 : -1;
}

// Per thread V = 16 / sizeof(E) adjacent columns: scan the rows
// [row0, row0 + nrows) of ohT and return, per column, the offset of its one
// (in out) and whether the block of rows held exactly one 1 and 0s else.
template <typename E, int V>
__device__ __forceinline__ void decode_block(const E* __restrict__ ohT,
                                             long long S, long long s,
                                             int row0, int nrows,
                                             int (&out)[V], bool (&ok)[V]) {
  int cnt[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    cnt[v] = 0;
    out[v] = 0;
  }
#pragma unroll 4
  for (int j = 0; j < nrows; ++j) {
    const uint4 w =
        *reinterpret_cast<const uint4*>(ohT + (row0 + j) * S + s);
    const E* e = reinterpret_cast<const E*>(&w);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = classify(e[v]);
      if (c == 1) out[v] = j;
      cnt[v] += c == 1 ? 1 : c == 0 ? 0 : 2;  // a bad entry spoils the count
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) ok[v] = cnt[v] == 1;
}

template <typename E>
__global__ void __launch_bounds__(DECODE_THREADS)
onehot_decode_kernel(const E* __restrict__ ohT, long long S, int M, int ksub,
                     unsigned char* __restrict__ codes, int* __restrict__ lid,
                     int* __restrict__ bad) {
  constexpr int V = 16 / sizeof(E);
  const long long s =
      (static_cast<long long>(blockIdx.x) * DECODE_THREADS + threadIdx.x) * V;
  if (s >= S) return;
  bool col_ok[V];
#pragma unroll
  for (int v = 0; v < V; ++v) col_ok[v] = true;
  int at[V];
  bool ok[V];
  for (int m = 0; m < M; ++m) {
    decode_block<E, V>(ohT, S, s, m * ksub, ksub, at, ok);
    unsigned w[4] = {0u, 0u, 0u, 0u};  // the V code bytes, little-endian
#pragma unroll
    for (int v = 0; v < V; ++v) {
      w[v / 4] |= static_cast<unsigned>(at[v]) << (8 * (v % 4));
      col_ok[v] = col_ok[v] && ok[v];
    }
    // V bytes: 8 (one 8-byte store) or 16 (one 16-byte store)
    if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(codes + m * S + s) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint4*>(codes + m * S + s) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  decode_block<E, V>(ohT, S, s, M * ksub, LIST_ROWS, at, ok);
  int nbad = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    lid[s + v] = at[v];
    nbad += !(col_ok[v] && ok[v]);
  }
  if (nbad) atomicAdd(bad, nbad);
}

template <typename E>
int decode(const void* ohT, long long S, int M, int ksub, void* codes,
           void* lid, void* bad, void* stream) {
  constexpr int V = 16 / sizeof(E);
  const long long threads = S / V;
  const unsigned blocks =
      static_cast<unsigned>((threads + DECODE_THREADS - 1) / DECODE_THREADS);
  onehot_decode_kernel<E><<<blocks, DECODE_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(ohT), S, M, ksub,
      static_cast<unsigned char*>(codes), static_cast<int*>(lid),
      static_cast<int*>(bad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one scan block for M * ksub LUT entries per query
// (the one-hot pass uses none).
extern "C" long long ivfpq_v3_smem_bytes(int mk, int int8) {
  const int row = adc_scan::lut_row(mk);
  return row ? adc_scan::smem_bytes(int8 != 0, row) : -1;
}

// luts [nq, M * ksub] bf16 (int8 = 0) or int8 (int8 = 1, meta [nq, 256]
// float32 required), ohT [M * ksub + 128, S] of the same type, codes [M, S]
// uint8 and lid [S] int32 scratch, bad one int32 set to 0 by the caller.
// S is a multiple of ct, itself a multiple of 256, and nchunks = S / ct a
// multiple of G = nbias / 128.
extern "C" int ivfpq_v3_launch(const void* biasg, const void* luts,
                               const void* meta, const void* ohT,
                               const void* n2, void* codes, void* lid,
                               void* bad, void* out_key, void* out_slot,
                               void* out_floor, int nq, int nbias, int M,
                               int ksub, long long S, int qt, int ct,
                               int int8, void* stream) {
  if (nq <= 0 || qt <= 0 || nq % qt != 0 || qt % adc_scan::QB != 0 ||
      ct <= 0 || ct % 256 != 0 || S % ct != 0 || S >= (1LL << 31) ||
      M <= 0 || ksub <= 0 || ksub > 256 ||
      adc_scan::lut_row(M * ksub) == 0 || nbias <= 0 ||
      nbias % adc_scan::K != 0 || (S / ct) % (nbias / adc_scan::K) != 0 ||
      (int8 && meta == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = int8 ? decode<signed char>(ohT, S, M, ksub, codes, lid, bad,
                                             stream)
                       : decode<unsigned short>(ohT, S, M, ksub, codes, lid,
                                                bad, stream);
  if (err != 0) return err;
  const int nchunks = static_cast<int>(S / ct);
  const int G = nbias / adc_scan::K;
  const adc_scan::Args a{biasg, luts, meta, codes, n2, lid, nullptr, nullptr,
                         out_key, out_slot, out_floor, nq, nbias, M, ksub, S,
                         nchunks, qt, ct, nchunks / G, G};
  return int8 ? adc_scan::launch_row<false, true>(a, stream)
              : adc_scan::launch_row<false, false>(a, stream);
}

extern "C" const char* ivfpq_v3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
