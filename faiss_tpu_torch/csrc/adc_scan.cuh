// The ADC scan with an exact top-128 shared by K4, K5 (ivfpq_adc.cu) and K6
// (ivfpq_v3.cu), for sm_90a, for the shapes their tensor-core kernels
// (adc_mma.cuh) do not take: ksub > 16, or LUT rows beyond a block's
// shared memory. The wrappers choose it by shape before the launch.
//
// For every query row r it returns the EXACT top-128 of
//     key(s) = n2[s] + biasg[r, g * 128 + lid[s]] + acc(r, s)
//     acc(r, s) = sum_m luts[r, m * ksub + codesT[m, s]]
// with g = min(chunk / cpg, G - 1) over every chunk (K4, K6) or
// g = cgroup[chunk] over the chunks of the query tile's worklist (K5), keys
// ascending (the query norm is not added), slots as packed positions
// chunk * ct + col (-1 where the key is +inf), and an all +inf eviction
// floor, since the select never evicts.
//
// Two LUT types. bf16 LUTs are upcast to float32 (exact) and summed in
// float32; the bias is added in float32 as given: key = (n2 + bias) + acc.
// int8 LUTs (K6's quantized mode, faiss's quantize_lut.h) are summed exactly
// in int32 and dequantized per query with the (a, c) of ``meta`` [nq, 256]
// (a in columns 0:128, c in 128:256, read at the slot's lane s % 128, as the
// TPU kernel reads them): key = (a * acc + c) + (bias + n2), each operation
// rounded on its own (no FMA contraction), in the TPU kernel's order.
//
// Design. One block serves QB queries of one qt-query tile (for K5 they share
// the tile's worklist). It holds their LUT rows in shared memory (float32 or
// int8), [QB][ROW] with ROW >= M * ksub a compile-time stride, so a lookup is
// one shared load at a constant offset from its (m, code) index. For each
// chunk it loads the chunk's group of 128 bias columns of its QB queries into
// shared memory. Each thread scores two adjacent slots per step: per
// sub-quantizer m one 2-byte load of codesT[m, s:s+2], coalesced along s,
// then one lookup and one add per slot for each of the QB queries. Within a
// warp the lookups of one (query, m) fall in one row of ksub consecutive
// entries, so random codes cost no bank conflicts (equal codes, and int8
// entries of one word, broadcast). The keys go through the exact select of
// exact_select.cuh.
//
// What bounds it: the shared-memory lookups, one per (query, slot,
// sub-quantizer), at one warp-wide shared load per clock per SM, i.e. 32
// lookups per clock, whatever the LUT type; every slot is scored for every
// query, masked or not. Its bytes are few (M + 12 bytes per slot, read by
// every block, mostly from L2).
//
// Offsets are 64-bit; slots are 32-bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "exact_select.cuh"

namespace adc_scan {

constexpr int K = 128;            // top-K width; bias columns per group
constexpr int QB = 8;             // queries per block (QUERIES_PER_BLOCK)
constexpr int THREADS = 256;      // threads per block
constexpr int STEP = 2 * THREADS; // slots scored per block step
constexpr int CAP = 1024;         // per-query buffer of (key, slot) pairs

using Select = exact_select::Select<K, CAP, QB, THREADS, STEP>;

// LUT entry types: as given (In), as held in shared memory (T), as summed
// (Acc).
template <bool INT8>
struct Lut {
  using In = __nv_bfloat16;
  using T = float;
  using Acc = float;
  static __device__ __forceinline__ T load(In v) { return __bfloat162float(v); }
};

template <>
struct Lut<true> {
  using In = signed char;
  using T = signed char;
  using Acc = int;
  static __device__ __forceinline__ T load(In v) { return v; }
};

// DYN: K5 (worklist cmap of nsteps chunks per tile, groups cgroup); else
// every chunk (nsteps of them) with static groups. INT8: quantized LUTs
// dequantized with meta; else bf16 LUTs (meta unused).
template <bool DYN, bool INT8, int ROW>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ biasg,
            const typename Lut<INT8>::In* __restrict__ luts,
            const float* __restrict__ meta,
            const unsigned char* __restrict__ codesT,
            const float* __restrict__ n2, const int* __restrict__ lid,
            const int* __restrict__ cmap, const int* __restrict__ cgroup,
            float* __restrict__ out_key, int* __restrict__ out_slot,
            float* __restrict__ out_floor, int nbias, int M, int ksub,
            long long S, int nsteps, int qt, int ct, int cpg, int G) {
  using T = typename Lut<INT8>::T;
  using Acc = typename Lut<INT8>::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bias = reinterpret_cast<float*>(smem);   // [QB][K]
  float* mt = bias + QB * K;                      // [QB][2K] (INT8 only)
  T* lut = reinterpret_cast<T*>(mt + (INT8 ? QB * 2 * K : 0));  // [QB][ROW]
  Select sel(reinterpret_cast<unsigned char*>(lut + QB * ROW));

  const int tid = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * QB;
  const int mk = M * ksub;
  for (int i = tid; i < QB * mk; i += THREADS) {
    const int qi = i / mk, j = i % mk;
    lut[qi * ROW + j] = Lut<INT8>::load(luts[(q0 + qi) * mk + j]);
  }
  if constexpr (INT8) {
    for (int i = tid; i < QB * 2 * K; i += THREADS) mt[i] = meta[q0 * 2 * K + i];
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
        Acc acc0[QB], acc1[QB];
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) {
          acc0[qi] = 0;
          acc1[qi] = 0;
        }
        const uchar2* cp = reinterpret_cast<const uchar2*>(codesT + s);
#pragma unroll 4
        for (int m = 0; m < M; ++m) {
          const uchar2 c = cp[m * row2];
          const T* l0 = lut + m * ksub + c.x;
          const T* l1 = lut + m * ksub + c.y;
#pragma unroll
          for (int qi = 0; qi < QB; ++qi) {
            acc0[qi] += l0[qi * ROW];
            acc1[qi] += l1[qi * ROW];
          }
        }
        const float2 nn = *reinterpret_cast<const float2*>(n2 + s);
        const int2 l = *reinterpret_cast<const int2*>(lid + s);
        const int lane = static_cast<int>(s % K);  // even: lane + 1 < K
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) {
          float k0, k1;
          if constexpr (INT8) {
            const float* a = mt + qi * 2 * K + lane;
            k0 = __fadd_rn(__fadd_rn(__fmul_rn(a[0], static_cast<float>(acc0[qi])),
                                     a[K]),
                           __fadd_rn(bias[qi * K + l.x], nn.x));
            k1 = __fadd_rn(__fadd_rn(__fmul_rn(a[1], static_cast<float>(acc1[qi])),
                                     a[K + 1]),
                           __fadd_rn(bias[qi * K + l.y], nn.y));
          } else {
            k0 = nn.x + bias[qi * K + l.x] + acc0[qi];
            k1 = nn.y + bias[qi * K + l.y] + acc1[qi];
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

// The LUT row stride for M * ksub entries: 512, 1024 or 2048 (0 if none).
inline int lut_row(int mk) {
  return mk <= 512 ? 512 : mk <= 1024 ? 1024 : mk <= 2048 ? 2048 : 0;
}

// Dynamic shared memory of one block: bias block, (a, c) rows with INT8,
// LUT rows, (key, slot) buffers, counts and thresholds.
inline long long smem_bytes(bool int8, int row) {
  return static_cast<long long>(sizeof(float)) * QB * K * (int8 ? 3 : 1) +
         static_cast<long long>(int8 ? 1 : sizeof(float)) * QB * row +
         Select::kBytes;
}

// The arguments of one scan: a bf16 or int8 LUT row per query, meta null
// with bf16; cmap and cgroup null for the static groups.
struct Args {
  const void* biasg;
  const void* luts;
  const void* meta;
  const void* codesT;
  const void* n2;
  const void* lid;
  const void* cmap;
  const void* cgroup;
  void* out_key;
  void* out_slot;
  void* out_floor;
  int nq, nbias, M, ksub;
  long long S;
  int nsteps, qt, ct, cpg, G;
};

template <bool DYN, bool INT8, int ROW>
int launch(const Args& a, void* stream) {
  const long long smem = smem_bytes(INT8, ROW);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<DYN, INT8, ROW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<DYN, INT8, ROW><<<a.nq / QB, THREADS, static_cast<size_t>(smem),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a.biasg),
      static_cast<const typename Lut<INT8>::In*>(a.luts),
      static_cast<const float*>(a.meta),
      static_cast<const unsigned char*>(a.codesT),
      static_cast<const float*>(a.n2), static_cast<const int*>(a.lid),
      static_cast<const int*>(a.cmap), static_cast<const int*>(a.cgroup),
      static_cast<float*>(a.out_key), static_cast<int*>(a.out_slot),
      static_cast<float*>(a.out_floor), a.nbias, a.M, a.ksub, a.S, a.nsteps,
      a.qt, a.ct, a.cpg, a.G);
  return static_cast<int>(cudaGetLastError());
}

// The instance for the LUT row stride of M * ksub (the caller checks that
// lut_row is not 0).
template <bool DYN, bool INT8>
int launch_row(const Args& a, void* stream) {
  const int row = lut_row(a.M * a.ksub);
  if (row == 512) return launch<DYN, INT8, 512>(a, stream);
  if (row == 1024) return launch<DYN, INT8, 1024>(a, stream);
  return launch<DYN, INT8, 2048>(a, stream);
}

}  // namespace adc_scan
