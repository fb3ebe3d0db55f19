// K6: IVF-PQ ADC over a precomputed one-hot layout, with bf16 or int8 LUTs
// and an exact top-128, for sm_90a.
//
// Replaces faiss_tpu/ops/pallas_knn.py:ivfpq_fused_pallas_v3 (:778, kernel
// body :645). Its input is the one-hot ohT [M * ksub + 128, S] (bf16 or
// int8; rows m * ksub + code of the PQ codes, then 128 rows of the local
// list ids, ops/quantize_lut.py expand_onehot), and for every query row r
// it returns the EXACT top-128 of
//     bf16 LUTs: key(s) = (luts_r . oh_pq[:, s])
//                         + (biasg_g . oh_list[:, s] + n2[s])
//     int8 LUTs: key(s) = (a * (q8_r . oh_pq[:, s]) + c)
//                         + (biasg_g . oh_list[:, s] + n2[s])
// with biasg_g the 128 bias columns of the chunk's static group
// g = chunk / cpg (nchunks a multiple of G), and (a, c) from meta at the
// slot's lane. With a valid one-hot the bf16 key is K4's key over the codes
// the one-hot encodes (in another order of additions), and the int8 dot
// product picks one quantized entry per sub-quantizer: an exact int32 sum.
//
// Design. The TPU kernel contracts the one-hot on its matrix unit, so it
// streams the whole one-hot, (M * ksub + 128) entries per slot, 20-40x the
// bytes of the codes, for every tile of queries (it staged the one-hot
// because its vector unit could not build it fast enough). Fed to the
// tensor cores as their B operand, the one-hot would cost the same here: a
// 128-column tile is 160 KB of it against 4.6 KB of codes, n2 and list ids,
// and each of the 32 query blocks of a 2048-query batch would stream all of
// it (1.34 GB in bf16) past the 50 MB L2, some 43 GB. So a first pass reads
// the one-hot once per launch: each thread takes 8 columns (16 bytes of
// bf16 or 8 of int8 a row), walks the rows of each sub-quantizer's block
// with coalesced loads, and writes the columns' codes [M, S] uint8 and
// local list ids [1, S] int32 into scratch that the wrapper allocates. A
// column that is not a one-hot (an entry other than 0 and 1, or not exactly
// one 1 in a sub-quantizer's block of ksub rows or in the 128 list rows) is
// counted in ``bad``, which the wrapper reads after the launch and raises
// on. Then the products run on the tensor cores over the decoded codes,
// where K4 builds the one-hot in registers (adc_mma.cuh): bf16 LUTs one
// mma.sync m16n8k16 k-step per sub-quantizer into float32 (MODE_V3), int8
// LUTs one mma.sync m16n8k32 s8 k-step per pair of sub-quantizers into
// exact int32 sums (MODE_V3_INT8), each with K6's order of additions, 64
// queries a block, the columns split across blocks and the splits merged.
// The int8 rows' (a, c) are kept per row where a row's 128 lanes agree (as
// quantize_luts_int8 makes them), and read at each key's lane from device
// memory, ungated, where they do not (adc_mma.cuh, "int8 meta").
//
// Instances, chosen by shape before the launch (tc_takes; the wrapper asks
// ivfpq_v3_smem_bytes(M, ksub, int8, 1)): the tensor cores take ksub <= 16
// and LUT rows that fit a block's shared memory (M <= 37 bf16, M <= 61
// int8); any other shape runs K5's shared-memory lookup scan
// (adc_scan.cuh) over the decoded codes, M + 1 lookups per query and slot.
//
// What bounds it: the products, as K4's (one k-step of 16 mmas a warp per
// sub-quantizer, or per pair in int8, at mma.sync's rate) and the select;
// the one-hot pass adds one read of ohT, 640 x 2^20 entries at PQ32x4fs:
// 1.34 GB in bf16 (0.40 ms at 3.35 TB/s) or 0.67 GB in int8 (0.20 ms).
//
// Offsets are 64-bit; slots are 32-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "adc_mma.cuh"
#include "adc_scan.cuh"

namespace {

constexpr int LIST_ROWS = 128;  // local list rows of the one-hot
constexpr int DECODE_THREADS = 256;
constexpr int V = 8;  // columns a thread decodes

// 1 if e is a one, 0 if a zero (+0 or -0 for bf16), -1 otherwise; E is the
// raw element (bf16 bits or int8).
__device__ __forceinline__ int classify(unsigned short e) {
  return e == 0x3F80 ? 1 : (e & 0x7FFF) == 0 ? 0 : -1;
}
__device__ __forceinline__ int classify(signed char e) {
  return e == 1 ? 1 : e == 0 ? 0 : -1;
}

// V adjacent elements of E as one load: 16 bytes (bf16) or 8 (int8).
template <typename E>
struct Row;
template <>
struct Row<unsigned short> {
  using W = uint4;
};
template <>
struct Row<signed char> {
  using W = uint2;
};

// Per thread V adjacent columns: scan the rows [row0, row0 + nrows) of ohT
// and return, per column, the offset of its one (in out) and whether the
// block of rows held exactly one 1 and 0s else.
template <typename E>
__device__ __forceinline__ void decode_block(const E* __restrict__ ohT,
                                             long long S, long long s,
                                             int row0, int nrows,
                                             int (&out)[V], bool (&ok)[V]) {
  using W = typename Row<E>::W;
  int cnt[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    cnt[v] = 0;
    out[v] = 0;
  }
#pragma unroll 4
  for (int j = 0; j < nrows; ++j) {
    const W w = *reinterpret_cast<const W*>(ohT + (row0 + j) * S + s);
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
  const long long s =
      (static_cast<long long>(blockIdx.x) * DECODE_THREADS + threadIdx.x) * V;
  if (s >= S) return;
  bool col_ok[V];
#pragma unroll
  for (int v = 0; v < V; ++v) col_ok[v] = true;
  int at[V];
  bool ok[V];
  for (int m = 0; m < M; ++m) {
    decode_block<E>(ohT, S, s, m * ksub, ksub, at, ok);
    unsigned w[2] = {0u, 0u};  // the V code bytes, little-endian
#pragma unroll
    for (int v = 0; v < V; ++v) {
      w[v / 4] |= static_cast<unsigned>(at[v]) << (8 * (v % 4));
      col_ok[v] = col_ok[v] && ok[v];
    }
    *reinterpret_cast<uint2*>(codes + m * S + s) = make_uint2(w[0], w[1]);
  }
  decode_block<E>(ohT, S, s, M * ksub, LIST_ROWS, at, ok);
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
           void* lid, void* bad, cudaStream_t stream) {
  const long long threads = S / V;
  const unsigned blocks =
      static_cast<unsigned>((threads + DECODE_THREADS - 1) / DECODE_THREADS);
  onehot_decode_kernel<E><<<blocks, DECODE_THREADS, 0, stream>>>(
      static_cast<const E*>(ohT), S, M, ksub,
      static_cast<unsigned char*>(codes), static_cast<int*>(lid),
      static_cast<int*>(bad));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int tc_mode(int int8) { return int8 ? adc_mma::MODE_V3_INT8 : adc_mma::MODE_V3; }

// Whether a tensor-core instance takes a shape: the 16 entries of a
// sub-quantizer are one bf16 k-step (half an int8 one), and a block's
// shared memory holds 64 LUT rows. The wrapper routes by this (through
// ivfpq_v3_smem_bytes), so the decision lives here alone.
bool tc_takes(int M, int ksub, int int8) {
  return M > 0 && ksub > 0 && ksub <= 16 &&
         adc_mma::smem_bytes(M, tc_mode(int8)) <= adc_mma::MAX_SMEM;
}

}  // namespace

// Dynamic shared memory of one scan block for M sub-quantizers of ksub
// entries: of the tensor-core instance of the mode (tc != 0) or of the
// lookup scan; -1 where that instance does not take the shape, which is how
// the wrapper chooses K6's instance. The one-hot pass uses none.
extern "C" long long ivfpq_v3_smem_bytes(int M, int ksub, int int8, int tc) {
  if (tc) return tc_takes(M, ksub, int8) ? adc_mma::smem_bytes(M, tc_mode(int8)) : -1;
  const int row = adc_scan::lut_row(M * ksub);
  return row ? adc_scan::smem_bytes(int8 != 0, row) : -1;
}

// luts [nq, M * ksub] bf16 (int8 = 0) or int8 (int8 = 1, meta [nq, 256]
// float32 required), ohT [M * ksub + 128, S] of the same type, codes [M, S]
// uint8 and lid [S] int32 scratch, bad one int32 set to 0 by the caller.
// S is a multiple of ct, itself a multiple of 256, and nchunks = S / ct a
// multiple of G = nbias / 128. tc != 0: the tensor-core instance, with
// splits column splits (part_key / part_slot [splits][nq][128] their
// top-128s until the merge, null with one split) and biasg and n2 16-byte
// aligned; tc = 0: the lookup scan (splits 1).
extern "C" int ivfpq_v3_launch(const void* biasg, const void* luts,
                               const void* meta, const void* ohT,
                               const void* n2, void* codes, void* lid,
                               void* bad, void* out_key, void* out_slot,
                               void* out_floor, void* part_key,
                               void* part_slot, int nq, int nbias, int M,
                               int ksub, long long S, int qt, int ct,
                               int int8, int splits, int tc, void* stream) {
  if (nq <= 0 || qt <= 0 || nq % qt != 0 || qt % adc_scan::QB != 0 ||
      ct <= 0 || ct % 256 != 0 || S % ct != 0 || S >= (1LL << 31) ||
      M <= 0 || ksub <= 0 || ksub > 256 ||
      adc_scan::lut_row(M * ksub) == 0 || nbias <= 0 ||
      nbias % adc_scan::K != 0 || (S / ct) % (nbias / adc_scan::K) != 0 ||
      (int8 && meta == nullptr) || splits < 1 ||
      (splits > 1) != (part_key != nullptr) ||
      (part_key != nullptr) != (part_slot != nullptr) ||
      (!tc && splits != 1) ||
      (tc && (!tc_takes(M, ksub, int8) || ct % adc_mma::BN != 0 ||
              !aligned16(biasg) || !aligned16(n2) || !aligned16(codes) ||
              !aligned16(lid)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = int8 ? decode<signed char>(ohT, S, M, ksub, codes, lid, bad, st)
                       : decode<unsigned short>(ohT, S, M, ksub, codes, lid, bad, st);
  if (err != 0) return err;
  if (tc) {
    adc_mma::Args a;
    a.biasg = static_cast<const float*>(biasg);
    a.luts = luts;
    a.meta = static_cast<const float*>(meta);
    a.okey = static_cast<float*>(out_key);
    a.oslot = static_cast<int*>(out_slot);
    a.ofloor = static_cast<float*>(out_floor);
    a.nbias = nbias;
    a.M = M;
    a.ksub = ksub;
    return int8 ? adc_mma::launch<adc_mma::MODE_V3_INT8>(
                      a, codes, n2, lid, part_key, part_slot, nq, S, ct, splits, st)
                : adc_mma::launch<adc_mma::MODE_V3>(
                      a, codes, n2, lid, part_key, part_slot, nq, S, ct, splits, st);
  }
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
