// K2: the exhaustive recon scan with an exact top-128, for sm_90a.
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
// bf16 first, which moves only the ~1e9 keys). The penalty is read from
// global memory per (query, column): a block's QB rows of biasg stay in L1,
// and a list's columns are contiguous, so a warp mostly reads one word.
//
// Arithmetic (recon_step.cuh). The query stays float32. The bf16 planes are
// upcast and summed in float32, and the sum is multiplied by the query in
// float32 FMAs on the CUDA cores, with no TF32. The TPU kernel splits the
// query into bf16 hi and lo and drops the ql * yl term, so this product is
// closer to the float32 value than the one the exact-flat certificate's
// delta (faiss_tpu/models/flat.py:84-93) was sized for, and that delta stays
// sound here unchanged.
//
// Design. One block serves QB queries and walks all S columns in order, two
// adjacent columns per thread and step (recon_step::dot_pair). Blocks walk
// the columns in the same order, so blocks resident at the same time share
// the store's lines through L2. The keys go through the exact select of
// exact_select.cuh. The store may be a column slice of a wider one (a stripe
// of the striped large-k flat path): ``ld`` is the row stride of both
// planes, so no stripe is copied.
//
// What bounds it: with 8 queries per block every block streams the whole
// store (2 * 2 * d_pad bytes per column with two planes, about 2 FMAs per
// byte), from L2 where blocks stay in step and from HBM where they drift;
// and the float32 FMA rate of the CUDA cores. bf16 wgmma with a split query,
// TMA loads and more queries per block are later work.
//
// Offsets are 64-bit; column indices (the slots) are 32-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "exact_select.cuh"
#include "recon_step.cuh"

namespace {

constexpr int K = 128;            // top-K width of the contract
constexpr int QB = 8;             // queries per block (QUERIES_PER_BLOCK)
constexpr int THREADS = 256;      // threads per block
constexpr int STEP = 2 * THREADS; // columns scored per block step
constexpr int CAP = 1024;         // per-query buffer of (key, slot) pairs

using Select = exact_select::Select<K, CAP, QB, THREADS, STEP>;

template <bool HILO, bool MASKED>
__global__ void __launch_bounds__(THREADS)
ivf_recon_kernel(const float* __restrict__ xq,
                 const __nv_bfloat16* __restrict__ yT,
                 const __nv_bfloat16* __restrict__ yT_lo, long long ld,
                 const float* __restrict__ n2,
                 const float* __restrict__ biasg, const int* __restrict__ lid,
                 float* __restrict__ out_key, int* __restrict__ out_slot,
                 float* __restrict__ out_floor, int d_pad, long long S,
                 int ct, int cpg, int nbias) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [QB][d_pad]
  Select sel(smem + sizeof(float) * QB * d_pad);

  const int tid = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * QB;

  for (int i = tid; i < QB * d_pad; i += THREADS) qs[i] = xq[q0 * d_pad + i];
  sel.init();
  __syncthreads();

  for (long long off = 0; off < S; off += STEP) {
    sel.make_room();
    const long long s = off + 2 * tid;
    if (s < S) {  // S is even, so s + 1 < S too
      float acc0[QB], acc1[QB];
      recon_step::dot_pair<QB, HILO>(qs, d_pad, yT, yT_lo, ld, s, acc0, acc1);
      const float2 nn = *reinterpret_cast<const float2*>(n2 + s);
      // s and s + 1 lie in one chunk (s is even, ct is even)
      const float* pen = nullptr;
      int2 l = make_int2(0, 0);
      if constexpr (MASKED) {
        const long long g = min(s / ct / cpg, static_cast<long long>(
                                                  nbias / K - 1));
        pen = biasg + q0 * nbias + g * K;
        l = *reinterpret_cast<const int2*>(lid + s);
      }
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) {
        float k0 = nn.x - 2.f * acc0[qi];
        float k1 = nn.y - 2.f * acc1[qi];
        if constexpr (MASKED) {
          k0 += pen[static_cast<long long>(qi) * nbias + l.x];
          k1 += pen[static_cast<long long>(qi) * nbias + l.y];
        }
        sel.offer(qi, k0, static_cast<int>(s));
        sel.offer(qi, k1, static_cast<int>(s + 1));
      }
    }
    __syncthreads();
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

template <bool HILO, bool MASKED>
int launch(const void* xq, const void* yT, const void* yT_lo, long long ld,
           const void* n2, const void* biasg, const void* lid, void* out_key,
           void* out_slot, void* out_floor, int nq, int d_pad, long long S,
           int ct, int cpg, int nbias, long long smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ivf_recon_kernel<HILO, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_recon_kernel<HILO, MASKED><<<nq / QB, THREADS,
                                   static_cast<size_t>(smem),
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xq), static_cast<const __nv_bfloat16*>(yT),
      static_cast<const __nv_bfloat16*>(yT_lo), ld,
      static_cast<const float*>(n2), static_cast<const float*>(biasg),
      static_cast<const int*>(lid), static_cast<float*>(out_key),
      static_cast<int*>(out_slot), static_cast<float*>(out_floor), d_pad, S,
      ct, cpg, nbias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block: queries, (key, slot) buffers, counts
// and thresholds.
extern "C" long long ivf_recon_smem_bytes(int d_pad) {
  return static_cast<long long>(sizeof(float)) * QB * d_pad + Select::kBytes;
}

// yT_lo may be null (one plane). biasg and lid null: unmasked; both given:
// masked, with nbias = G * 128 the row length of biasg. qt is the TPU
// kernel's query tile: a block here does not need it, and it is checked for
// the contract only (nq a multiple of qt, itself a multiple of QB); ct sets
// the chunks of the masked mode's static groups.
extern "C" int ivf_recon_launch(const void* xq, const void* yT,
                                const void* yT_lo, long long ld,
                                const void* n2, const void* biasg,
                                const void* lid, void* out_key, void* out_slot,
                                void* out_floor, int nq, int d_pad,
                                long long S, int qt, int ct, int nbias,
                                void* stream) {
  const bool masked = biasg != nullptr;
  if (nq <= 0 || qt <= 0 || nq % qt != 0 || qt % QB != 0 || ct <= 0 ||
      ct % 2 != 0 || S % ct != 0 || d_pad % 4 != 0 || ld % 2 != 0 ||
      ld < S || S >= (1LL << 31) || masked != (lid != nullptr) ||
      (masked && (nbias <= 0 || nbias % K != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = ivf_recon_smem_bytes(d_pad);
  const int cpg = max(1, static_cast<int>(S / ct) / max(1, nbias / K));
  if (masked && yT_lo != nullptr) {
    return launch<true, true>(xq, yT, yT_lo, ld, n2, biasg, lid, out_key,
                              out_slot, out_floor, nq, d_pad, S, ct, cpg,
                              nbias, smem, stream);
  }
  if (masked) {
    return launch<false, true>(xq, yT, yT_lo, ld, n2, biasg, lid, out_key,
                               out_slot, out_floor, nq, d_pad, S, ct, cpg,
                               nbias, smem, stream);
  }
  if (yT_lo != nullptr) {
    return launch<true, false>(xq, yT, yT_lo, ld, n2, biasg, lid, out_key,
                               out_slot, out_floor, nq, d_pad, S, ct, cpg,
                               nbias, smem, stream);
  }
  return launch<false, false>(xq, yT, yT_lo, ld, n2, biasg, lid, out_key,
                              out_slot, out_floor, nq, d_pad, S, ct, cpg,
                              nbias, smem, stream);
}

extern "C" const char* ivf_recon_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
