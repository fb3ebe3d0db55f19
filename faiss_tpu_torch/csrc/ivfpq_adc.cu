// K4 and K5: the code-streaming IVF-PQ ADC scans with an exact top-128, for
// sm_90a.
//
// Replace faiss_tpu/ops/pallas_knn.py:ivfpq_fused_pallas (K4: every chunk in
// order) and ivfpq_fused_dyn_pallas (K5: the chunks of each query tile's
// worklist). They compute what those kernels compute, not how: for every
// query row r the EXACT top-128 of
//     key(s) = n2[s] + biasg[r, g * 128 + lid[s]]
//              + sum_m luts[r, m * ksub + codesT[m, s]]
// with g = min(chunk / cpg, G - 1) for K4 and g = cgroup[chunk] for K5,
// keys ascending (the query norm is not added), slots as packed positions
// chunk * ct + col (-1 where the key is +inf), and an all +inf eviction
// floor, since the select never evicts.
//
// Arithmetic. The TPU kernel contracts the bf16 LUTs with a one-hot of the
// codes on its matrix unit, and the bias, split into bf16 hi + lo, with a
// one-hot of the list ids. Here the LUT entries (bf16 values, exact in
// float32) are looked up and summed in float32, and the bias is added in
// float32 as given: closer to the float32 key than the TPU's hi + lo.
//
// Design. One block serves QB queries of one qt-query tile (for K5 they share
// the tile's worklist). It holds their LUT rows in shared memory as float32,
// [QB][ROW] with ROW >= M * ksub a compile-time stride, so a lookup is one
// shared load at a constant offset from its (m, code) index. For each chunk
// it loads the chunk's group of 128 bias columns of its QB queries into
// shared memory. Each thread scores two adjacent slots per step: per
// sub-quantizer m one 2-byte load of codesT[m, s:s+2], coalesced along s,
// then one lookup and one add per slot for each of the QB queries. Within a
// warp the lookups of one (query, m) fall in one row of ksub consecutive
// words, so random codes cost no bank conflicts (equal codes broadcast). The
// keys go through the exact select of exact_select.cuh.
//
// What bounds it: the shared-memory lookups, one per (query, slot,
// sub-quantizer), at one warp-wide 32-bit shared load per clock per SM, i.e.
// 32 lookups per clock; K4 scores every slot for every query, masked or not.
// Its bytes are few (M + 12 bytes per slot, read by every block, mostly from
// L2). Packed 4-bit codes with LUTs in registers and byte permutes (faiss's
// FastScan), int8 LUTs and skipping the chunks of masked groups are later
// work.
//
// Offsets are 64-bit; slots are 32-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "exact_select.cuh"

namespace {

constexpr int K = 128;            // top-K width; bias columns per group
constexpr int QB = 8;             // queries per block (QUERIES_PER_BLOCK)
constexpr int THREADS = 256;      // threads per block
constexpr int STEP = 2 * THREADS; // slots scored per block step
constexpr int CAP = 1024;         // per-query buffer of (key, slot) pairs

using Select = exact_select::Select<K, CAP, QB, THREADS, STEP>;

// DYN: K5 (worklist cmap of nsteps chunks per tile, groups cgroup); else K4
// (nsteps = every chunk, static groups).
template <bool DYN, int ROW>
__global__ void __launch_bounds__(THREADS)
ivfpq_adc_kernel(const float* __restrict__ biasg,
                 const __nv_bfloat16* __restrict__ luts,
                 const unsigned char* __restrict__ codesT,
                 const float* __restrict__ n2, const int* __restrict__ lid,
                 const int* __restrict__ cmap, const int* __restrict__ cgroup,
                 float* __restrict__ out_key, int* __restrict__ out_slot,
                 float* __restrict__ out_floor, int nbias, int M, int ksub,
                 long long S, int nsteps, int qt, int ct, int cpg, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);  // [QB][ROW]
  float* bias = lut + QB * ROW;                  // [QB][K]
  Select sel(reinterpret_cast<unsigned char*>(bias + QB * K));

  const int tid = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * QB;
  const int mk = M * ksub;
  for (int i = tid; i < QB * mk; i += THREADS) {
    const int qi = i / mk, j = i % mk;
    lut[qi * ROW + j] = __bfloat162float(luts[(q0 + qi) * mk + j]);
  }
  sel.init();

  const int* work = DYN ? cmap + (q0 / qt) * nsteps : nullptr;
  const long long row2 = S / 2;  // uchar2 stride between sub-quantizers
  for (int step = 0; step < nsteps; ++step) {
    const int chunk = DYN ? work[step] : step;
    const long long g = DYN ? cgroup[chunk] : min(chunk / cpg, G - 1);
    // the previous chunk's last step ended in a __syncthreads
    for (int i = tid; i < QB * K; i += THREADS) {
      bias[i] = biasg[(q0 + i / K) * nbias + g * K + i % K];
    }
    __syncthreads();
    const long long base = static_cast<long long>(chunk) * ct;
    for (int off = 0; off < ct; off += STEP) {
      sel.make_room();
      const int col = off + 2 * tid;
      if (col < ct) {
        const long long s = base + col;
        float acc0[QB], acc1[QB];
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) {
          acc0[qi] = 0.f;
          acc1[qi] = 0.f;
        }
        const uchar2* cp = reinterpret_cast<const uchar2*>(codesT + s);
#pragma unroll 4
        for (int m = 0; m < M; ++m) {
          const uchar2 c = cp[m * row2];
          const float* l0 = lut + m * ksub + c.x;
          const float* l1 = lut + m * ksub + c.y;
#pragma unroll
          for (int qi = 0; qi < QB; ++qi) {
            acc0[qi] += l0[qi * ROW];
            acc1[qi] += l1[qi * ROW];
          }
        }
        const float2 nn = *reinterpret_cast<const float2*>(n2 + s);
        const int2 l = *reinterpret_cast<const int2*>(lid + s);
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) {
          sel.offer(qi, nn.x + bias[qi * K + l.x] + acc0[qi],
                    static_cast<int>(s));
          sel.offer(qi, nn.y + bias[qi * K + l.y] + acc1[qi],
                    static_cast<int>(s + 1));
        }
      }
      __syncthreads();
    }
  }
  sel.finish();
  for (int i = tid; i < QB * K; i += THREADS) {
    const int qi = i / K, j = i % K;
    const float kv = sel.kth_key(qi, j);
    const long long o = (q0 + qi) * K + j;
    out_key[o] = kv;
    out_slot[o] = isinf(kv) ? -1 : sel.kth_slot(qi, j);
    out_floor[o] = CUDART_INF_F;
  }
}

// The LUT row stride for M * ksub entries: 512, 1024 or 2048 (0 if none).
int lut_row(int mk) {
  return mk <= 512 ? 512 : mk <= 1024 ? 1024 : mk <= 2048 ? 2048 : 0;
}

long long smem_bytes(int row) {
  return static_cast<long long>(sizeof(float)) * QB * (row + K) +
         Select::kBytes;
}

template <bool DYN, int ROW>
int launch(const void* biasg, const void* luts, const void* codesT,
           const void* n2, const void* lid, const void* cmap,
           const void* cgroup, void* out_key, void* out_slot, void* out_floor,
           int nq, int nbias, int M, int ksub, long long S, int nsteps, int qt,
           int ct, int cpg, int G, void* stream) {
  const long long smem = smem_bytes(ROW);
  cudaError_t err = cudaFuncSetAttribute(
      ivfpq_adc_kernel<DYN, ROW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ivfpq_adc_kernel<DYN, ROW><<<nq / QB, THREADS, static_cast<size_t>(smem),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(biasg),
      static_cast<const __nv_bfloat16*>(luts),
      static_cast<const unsigned char*>(codesT),
      static_cast<const float*>(n2), static_cast<const int*>(lid),
      static_cast<const int*>(cmap), static_cast<const int*>(cgroup),
      static_cast<float*>(out_key), static_cast<int*>(out_slot),
      static_cast<float*>(out_floor), nbias, M, ksub, S, nsteps, qt, ct, cpg,
      G);
  return static_cast<int>(cudaGetLastError());
}

template <bool DYN>
int launch_row(int row, const void* biasg, const void* luts,
               const void* codesT, const void* n2, const void* lid,
               const void* cmap, const void* cgroup, void* out_key,
               void* out_slot, void* out_floor, int nq, int nbias, int M,
               int ksub, long long S, int nsteps, int qt, int ct, int cpg,
               int G, void* stream) {
  if (row == 512) {
    return launch<DYN, 512>(biasg, luts, codesT, n2, lid, cmap, cgroup,
                            out_key, out_slot, out_floor, nq, nbias, M, ksub,
                            S, nsteps, qt, ct, cpg, G, stream);
  }
  if (row == 1024) {
    return launch<DYN, 1024>(biasg, luts, codesT, n2, lid, cmap, cgroup,
                             out_key, out_slot, out_floor, nq, nbias, M, ksub,
                             S, nsteps, qt, ct, cpg, G, stream);
  }
  return launch<DYN, 2048>(biasg, luts, codesT, n2, lid, cmap, cgroup,
                           out_key, out_slot, out_floor, nq, nbias, M, ksub, S,
                           nsteps, qt, ct, cpg, G, stream);
}

}  // namespace

// Dynamic shared memory of one block for M * ksub LUT entries per query:
// LUT rows, bias block, (key, slot) buffers, counts and thresholds.
extern "C" long long ivfpq_adc_smem_bytes(int mk) {
  const int row = lut_row(mk);
  return row ? smem_bytes(row) : -1;
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
  const int row = lut_row(M * ksub);
  if (nq <= 0 || qt <= 0 || nq % qt != 0 || qt % QB != 0 || ct <= 0 ||
      ct % 2 != 0 || S % ct != 0 || S >= (1LL << 31) || M <= 0 || ksub <= 0 ||
      ksub > 256 || row == 0 || nbias <= 0 || nbias % K != 0 ||
      dyn != (cgroup != nullptr) || (dyn && msteps <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nchunks = static_cast<int>(S / ct);
  const int G = nbias / K;
  const int cpg = max(1, nchunks / G);
  if (dyn) {
    return launch_row<true>(row, biasg, luts, codesT, n2, lid, cmap, cgroup,
                            out_key, out_slot, out_floor, nq, nbias, M, ksub,
                            S, msteps, qt, ct, cpg, G, stream);
  }
  return launch_row<false>(row, biasg, luts, codesT, n2, lid, cmap, cgroup,
                           out_key, out_slot, out_floor, nq, nbias, M, ksub, S,
                           nchunks, qt, ct, cpg, G, stream);
}

extern "C" const char* ivfpq_adc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
