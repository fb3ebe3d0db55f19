// Block-wide selects over float keys in device memory, shared by K3's two
// selects (knn_fused.cu): the threshold select (the k_lanes-th smallest of a
// row's bucket minima) and the final select (the k_lanes smallest of its
// candidates, sorted).
//
// A float key is compared by its order bits: the bit pattern with the sign
// bit flipped for a positive float and every bit flipped for a negative one,
// so that unsigned order is float order (-0 just below +0). kth() finds the
// rank-th smallest of n keys by a radix select: four passes over the keys,
// one per 8-bit digit from the top, each a histogram in shared memory of the
// keys that match the digits chosen so far, and one warp's scan of its 256
// bins. sort() is a bitonic sort of a power-of-two count of (order bits,
// id) pairs in shared memory, used on the <= 2048 winners only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radix_select {

constexpr int BINS = 256;

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

// Shared memory of kth(): the histogram and the chosen digit and rank.
struct Scratch {
  int hist[BINS];
  int digit, rank;
};

// The order bits of the rank-th smallest (0-based, rank < n) of the n keys
// key(i), i < n, by every thread of the block (blockDim.x >= 32).
template <class Key>
__device__ uint32_t kth(int n, int rank, Key key, Scratch& s) {
  uint32_t prefix = 0, mask = 0;
  const int lane = threadIdx.x & 31;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < BINS; i += blockDim.x) s.hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t u = key(i);
      if ((u & mask) == prefix) atomicAdd(&s.hist[(u >> shift) & (BINS - 1)], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // lane l scans bins 8 l .. 8 l + 7
      int c[BINS / 32], sum = 0;
#pragma unroll
      for (int j = 0; j < BINS / 32; ++j) {
        c[j] = s.hist[lane * (BINS / 32) + j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const int excl = incl - sum;
      if (excl <= rank && rank < incl) {
        int r = rank - excl;
        for (int j = 0; j < BINS / 32; ++j) {
          if (r < c[j]) {
            s.digit = lane * (BINS / 32) + j;
            s.rank = r;
            break;
          }
          r -= c[j];
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(s.digit) << shift;
    mask |= static_cast<uint32_t>(BINS - 1) << shift;
    rank = s.rank;
    // s is written again only after the next pass's two barriers
  }
  return prefix;
}

// Ascending bitonic sort of N (a power of two) pairs by key, by the block.
template <int N>
__device__ void sort(uint32_t* key, int* id) {
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < N / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const uint32_t ki = key[i], kj = key[j];
        if ((ki > kj) == up) {
          key[i] = kj;
          key[j] = ki;
          const int s = id[i];
          id[i] = id[j];
          id[j] = s;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace radix_select
