// K1: the dynamic-chunk recon scan with an exact top-128, for sm_90a.
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
// rounds it to bf16 first, which moves only the ~1e9 keys). The penalty is
// read from global memory per (query, slot): a block's QB rows of biasg stay
// in L1, and a list's slots are contiguous, so a warp mostly reads one word.
//
// Design. One block serves QB queries of one qt-query tile, so they share the
// tile's worklist. The queries sit in shared memory in float32 (q is never
// rounded to bf16: the TPU kernel's hi/lo query split exists only to keep it
// f32 on the matrix unit). Each thread scores two adjacent slots per step for
// all QB queries (recon_step::dot_pair): one bf16x2 load of each plane per
// dimension, coalesced along s, summed in float32 and accumulated with FMAs
// on the CUDA cores. With the lo plane the product is the float32 query times
// the float32-faithful hi + lo, where the TPU kernel's three bf16 passes drop
// the ql * yl term. The keys go through the exact select of exact_select.cuh
// (a shared-memory buffer per query, appends below the running K-th key, a
// block-wide bitonic sort before a step could overflow it).
//
// What bounds it: every block re-reads the worklist's columns of the planes
// (the qt / QB blocks of a tile read the same chunks, mostly from L2), and
// the float32 FMA rate of the CUDA cores (d FMAs per query and slot). wgmma
// on bf16 tiles with the query split into bf16 hi + lo, TMA loads of the
// chunks and the tile sizes are later work.
//
// Offsets into the planes and n2 are 64-bit: d_pad * S passes 2^31 at 10M
// slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "exact_select.cuh"
#include "recon_step.cuh"

namespace {

constexpr int K = 128;            // top-K width of the contract
constexpr int QB = 8;             // queries per block (QUERIES_PER_BLOCK)
constexpr int THREADS = 256;      // threads per block
constexpr int STEP = 2 * THREADS; // slots scored per block step
constexpr int CAP = 1024;         // per-query buffer of (key, slot) pairs

using Select = exact_select::Select<K, CAP, QB, THREADS, STEP>;

template <bool PEN, bool HILO>
__global__ void __launch_bounds__(THREADS)
ivf_recon_dyn_kernel(const float* __restrict__ xq,
                     const __nv_bfloat16* __restrict__ yT,
                     const __nv_bfloat16* __restrict__ yT_lo,
                     const float* __restrict__ n2,
                     const int* __restrict__ cmap,
                     const float* __restrict__ biasg,
                     const int* __restrict__ lid,
                     const int* __restrict__ cgroup,
                     float* __restrict__ out_key, int* __restrict__ out_slot,
                     float* __restrict__ out_floor, int d_pad, long long S,
                     int msteps, int qt, int ct, int nbias) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [QB][d_pad]
  Select sel(smem + sizeof(float) * QB * d_pad);

  const int tid = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * QB;
  const long long tile = q0 / qt;

  for (int i = tid; i < QB * d_pad; i += THREADS) qs[i] = xq[q0 * d_pad + i];
  sel.init();
  __syncthreads();

  const int* work = cmap + tile * msteps;
  for (int step = 0; step < msteps; ++step) {
    const int chunk = work[step];
    const long long base = static_cast<long long>(chunk) * ct;
    // the QB rows of the penalty's group block for this chunk
    const float* pen =
        PEN ? biasg + q0 * nbias + static_cast<long long>(cgroup[chunk]) * K
            : nullptr;
    for (int off = 0; off < ct; off += STEP) {
      sel.make_room();
      const int col = off + 2 * tid;
      if (col < ct) {
        const long long s = base + col;
        float acc0[QB], acc1[QB];
        recon_step::dot_pair<QB, HILO>(qs, d_pad, yT, yT_lo, S, s, acc0,
                                       acc1);
        const float2 nn = *reinterpret_cast<const float2*>(n2 + s);
        int2 l = make_int2(0, 0);
        if constexpr (PEN) l = *reinterpret_cast<const int2*>(lid + s);
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) {
          float k0 = nn.x - 2.f * acc0[qi];
          float k1 = nn.y - 2.f * acc1[qi];
          if constexpr (PEN) {
            k0 += pen[static_cast<long long>(qi) * nbias + l.x];
            k1 += pen[static_cast<long long>(qi) * nbias + l.y];
          }
          sel.offer(qi, k0, static_cast<int>(s));
          sel.offer(qi, k1, static_cast<int>(s + 1));
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

template <bool PEN, bool HILO>
int launch(const void* xq, const void* yT, const void* yT_lo, const void* n2,
           const void* cmap, const void* biasg, const void* lid,
           const void* cgroup, void* out_key, void* out_slot, void* out_floor,
           int nq, int d_pad, long long S, int msteps, int qt, int ct,
           int nbias, long long smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ivf_recon_dyn_kernel<PEN, HILO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_recon_dyn_kernel<PEN, HILO><<<nq / QB, THREADS,
                                    static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xq), static_cast<const __nv_bfloat16*>(yT),
      static_cast<const __nv_bfloat16*>(yT_lo),
      static_cast<const float*>(n2), static_cast<const int*>(cmap),
      static_cast<const float*>(biasg), static_cast<const int*>(lid),
      static_cast<const int*>(cgroup), static_cast<float*>(out_key),
      static_cast<int*>(out_slot), static_cast<float*>(out_floor), d_pad, S,
      msteps, qt, ct, nbias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block: queries, (key, slot) buffers, counts
// and thresholds.
extern "C" long long ivf_recon_dyn_smem_bytes(int d_pad) {
  return static_cast<long long>(sizeof(float)) * QB * d_pad + Select::kBytes;
}

// yT_lo may be null (one plane); given, it has yT's shape and layout. biasg,
// lid and cgroup null: the soft mode; all three given: the penalized mode,
// with nbias = G * 128 the row length of biasg.
extern "C" int ivf_recon_dyn_launch(const void* xq, const void* yT,
                                    const void* yT_lo, const void* n2,
                                    const void* cmap, const void* biasg,
                                    const void* lid, const void* cgroup,
                                    void* out_key, void* out_slot,
                                    void* out_floor, int nq, int d_pad,
                                    long long S, int msteps, int qt, int ct,
                                    int nbias, void* stream) {
  const bool pen = biasg != nullptr;
  if (nq <= 0 || qt <= 0 || nq % qt != 0 || qt % QB != 0 || ct % 2 != 0 ||
      d_pad % 4 != 0 || S % ct != 0 || msteps <= 0 ||
      pen != (lid != nullptr) || pen != (cgroup != nullptr) ||
      (pen && (nbias <= 0 || nbias % K != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = ivf_recon_dyn_smem_bytes(d_pad);
  if (pen && yT_lo != nullptr) {
    return launch<true, true>(xq, yT, yT_lo, n2, cmap, biasg, lid, cgroup,
                              out_key, out_slot, out_floor, nq, d_pad, S,
                              msteps, qt, ct, nbias, smem, stream);
  }
  if (pen) {
    return launch<true, false>(xq, yT, yT_lo, n2, cmap, biasg, lid, cgroup,
                               out_key, out_slot, out_floor, nq, d_pad, S,
                               msteps, qt, ct, nbias, smem, stream);
  }
  if (yT_lo != nullptr) {
    return launch<false, true>(xq, yT, yT_lo, n2, cmap, biasg, lid, cgroup,
                               out_key, out_slot, out_floor, nq, d_pad, S,
                               msteps, qt, ct, nbias, smem, stream);
  }
  return launch<false, false>(xq, yT, yT_lo, n2, cmap, biasg, lid, cgroup,
                              out_key, out_slot, out_floor, nq, d_pad, S,
                              msteps, qt, ct, nbias, smem, stream);
}

extern "C" const char* ivf_recon_dyn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
