// The exact top-K select of the lookup scan of adc_scan.cuh, which serves
// K4, K5 and K6 only for the shapes their tensor-core kernels do not take
// (ksub > 16, or LUT rows beyond a block's shared memory).
//
// The TPU kernels keep an approximate top-K (per-lane insertion queues,
// bitonic flushes on a fixed schedule, an eviction floor) because a
// data-dependent branch stalls the TPU core. On Hopper a branch is cheap, so
// the select here is exact. One block serves QB queries. Per query, shared
// memory holds a buffer of CAP (key, slot) pairs whose first K entries are
// the running top-K in ascending order, a count and a threshold (the K-th
// key). A scored key below the threshold is appended with a shared-memory
// atomic. Before a step that could append more pairs than the buffer has
// room for, a block-wide bitonic sort of all CAP pairs keeps the best K and
// raises the threshold. Nothing is evicted unseen, so a kernel built on it
// reports an all-+inf eviction floor.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace exact_select {

// Ascending bitonic sort of CAP pairs by the whole block.
template <int CAP, int THREADS>
__device__ void sort_pairs(float* key, int* slot) {
  for (int size = 2; size <= CAP; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < CAP / 2; t += THREADS) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const float ki = key[i], kj = key[j];
        if ((ki > kj) == up) {
          key[i] = kj;
          key[j] = ki;
          const int s = slot[i];
          slot[i] = slot[j];
          slot[j] = s;
        }
      }
      __syncthreads();
    }
  }
}

// K: width of the result; CAP: pairs per query buffer; QB: queries per
// block; THREADS: threads per block; STEP: the most keys one query can be
// offered between two calls of make_room.
template <int K, int CAP, int QB, int THREADS, int STEP>
struct Select {
  static_assert(CAP >= K + STEP, "a step must fit after a compaction");
  static_assert((CAP & (CAP - 1)) == 0, "bitonic sort needs a power of two");

  // Shared memory of the select: (key, slot) buffers, counts, thresholds.
  static constexpr long long kBytes =
      static_cast<long long>(sizeof(float) + sizeof(int)) * QB * CAP +
      static_cast<long long>(sizeof(int) + sizeof(float)) * QB;

  float* key;  // [QB][CAP]
  int* slot;   // [QB][CAP]
  int* cnt;    // [QB]
  float* thr;  // [QB]

  __device__ explicit Select(unsigned char* smem)
      : key(reinterpret_cast<float*>(smem)),
        slot(reinterpret_cast<int*>(key + QB * CAP)),
        cnt(slot + QB * CAP),
        thr(reinterpret_cast<float*>(cnt + QB)) {}

  // Empty buffers. The caller synchronises before the first offer.
  __device__ void init() {
    for (int i = threadIdx.x; i < QB * CAP; i += THREADS) {
      key[i] = CUDART_INF_F;
      slot[i] = -1;
    }
    if (threadIdx.x < QB) {
      cnt[threadIdx.x] = K;  // the first K entries are the (empty) top-K
      thr[threadIdx.x] = CUDART_INF_F;
    }
  }

  // Keep the best K of query qi's buffer and set its threshold. Called by
  // every thread of the block with the same argument.
  __device__ void compact(int qi) {
    float* k = key + qi * CAP;
    int* s = slot + qi * CAP;
    const int c = cnt[qi];  // read by every thread before thread 0 rewrites it
    for (int i = c + threadIdx.x; i < CAP; i += THREADS) {
      k[i] = CUDART_INF_F;
      s[i] = -1;
    }
    __syncthreads();
    sort_pairs<CAP, THREADS>(k, s);
    if (threadIdx.x == 0) {
      cnt[qi] = K;
      thr[qi] = k[K - 1];
    }
    __syncthreads();
  }

  // Before each step, by every thread after a __syncthreads: compact every
  // buffer that the step could overflow (cnt changes only in compact, so
  // the condition is uniform across the block).
  __device__ void make_room() {
    for (int qi = 0; qi < QB; ++qi) {
      if (cnt[qi] > CAP - STEP) compact(qi);
    }
  }

  __device__ void offer(int qi, float k, int s) {
    if (k < thr[qi]) {
      const int p = atomicAdd(cnt + qi, 1);
      key[qi * CAP + p] = k;
      slot[qi * CAP + p] = s;
    }
  }

  // After the last step (after a __syncthreads): sort every buffer, so entry
  // j < K of query qi is its (j+1)-th smallest key.
  __device__ void finish() {
    for (int qi = 0; qi < QB; ++qi) compact(qi);
  }

  __device__ float kth_key(int qi, int j) const { return key[qi * CAP + j]; }
  __device__ int kth_slot(int qi, int j) const { return slot[qi * CAP + j]; }
};

}  // namespace exact_select
