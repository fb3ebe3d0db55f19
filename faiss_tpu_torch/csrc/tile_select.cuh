// The exact top-128 select of the tensor-core recon kernels (K1, K2).
//
// One block serves BM queries. The few warps whose mma accumulators hold a
// query's row offer its keys, and one of them compacts it, so the select
// adds no block-wide barrier. Per query, shared memory holds CAP = 256
// (key, slot) pairs, 2 KB: entries [0, 128) are the running top-128 in
// ascending order, entries [128, cnt) an unsorted queue, and a threshold,
// the running 128th key. A scored key below the threshold is appended to
// the queue with a shared-memory atomic. After each tile of BN columns the
// compacting warp merges every query whose queue could not take another
// tile: it sorts the queue (at most 128 pairs, 4 per lane) in registers
// with a warp bitonic sort, takes the element-wise minimum of the running
// top-128 and the reversed sorted queue (a bitonic sequence holding the 128
// smallest of both), sorts that with a 7-stage bitonic merge, writes it back
// and raises the threshold. Nothing is evicted unseen, so a kernel built on
// it reports an all-+inf eviction floor. A key equal to the threshold is not
// admitted: it ties the running 128th key, so the result is still a top-128.
//
// The same register merge joins the per-split top-128s of a launch whose
// columns or worklist steps were split across blocks (merge_splits).
//
// Register layout of 128 pairs in a warp: element e = j * 32 + lane, j < 4.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace tile_select {

constexpr int K = 128;
constexpr unsigned kFull = 0xffffffffu;

// Compare-exchange of element j with the element `stride` lanes away
// (stride < 32): keep the smaller key when keep_min, else the larger. Both
// partners take the same decision, so no pair is lost or duplicated.
__device__ __forceinline__ void cas_lanes(float (&k)[4], int (&s)[4], int j,
                                          int stride, bool keep_min) {
  const float ok = __shfl_xor_sync(kFull, k[j], stride);
  const int os = __shfl_xor_sync(kFull, s[j], stride);
  if (keep_min ? ok < k[j] : ok > k[j]) {
    k[j] = ok;
    s[j] = os;
  }
}

// Compare-exchange of elements j0 < j1 of one lane: ascending puts the
// smaller key at j0.
__device__ __forceinline__ void cas_regs(float (&k)[4], int (&s)[4], int j0,
                                         int j1, bool ascending) {
  if (ascending ? k[j1] < k[j0] : k[j1] > k[j0]) {
    const float tk = k[j0];
    k[j0] = k[j1];
    k[j1] = tk;
    const int ts = s[j0];
    s[j0] = s[j1];
    s[j1] = ts;
  }
}

// Ascending bitonic sort of the warp's 128 pairs.
__device__ __forceinline__ void sort128(float (&k)[4], int (&s)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= K; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = (j << 5) | lane;
        const bool asc = (e & size) == 0;
        if (stride >= 32) {
          const int js = stride >> 5;
          if ((j & js) == 0) cas_regs(k, s, j, j | js, asc);
        } else {
          cas_lanes(k, s, j, stride, ((e & stride) == 0) == asc);
        }
      }
    }
  }
}

// a and b ascending: a becomes the 128 smallest pairs of a and b, ascending.
__device__ __forceinline__ void merge128(float (&ak)[4], int (&as)[4],
                                         const float (&bk)[4],
                                         const int (&bs)[4]) {
  const int lane = threadIdx.x & 31;
  // element e of reversed b is b[127 - e]: element 3 - j of lane 31 - lane
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float rk = __shfl_xor_sync(kFull, bk[3 - j], 31);
    const int rs = __shfl_xor_sync(kFull, bs[3 - j], 31);
    if (rk < ak[j]) {
      ak[j] = rk;
      as[j] = rs;
    }
  }
  cas_regs(ak, as, 0, 2, true);  // stride 64
  cas_regs(ak, as, 1, 3, true);
  cas_regs(ak, as, 0, 1, true);  // stride 32
  cas_regs(ak, as, 2, 3, true);
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) cas_lanes(ak, as, j, stride, (lane & stride) == 0);
  }
}

// BM queries per block, CAP pairs per query, at most BN keys offered to a
// query between two calls of make_room.
template <int BM, int CAP, int BN>
struct Select {
  static_assert(CAP == 2 * K, "the queue is sorted as 128 pairs in registers");
  static_assert(BN <= CAP - K, "a tile must fit after a compaction");

  // Shared memory: (key, slot) buffers, counts, thresholds.
  static constexpr int kBytes = (4 + 4) * BM * CAP + (4 + 4) * BM;

  float* key;  // [BM][CAP]
  int* slot;   // [BM][CAP]
  int* cnt;    // [BM]
  float* thr;  // [BM]

  __device__ explicit Select(unsigned char* smem)
      : key(reinterpret_cast<float*>(smem)),
        slot(reinterpret_cast<int*>(key + BM * CAP)),
        cnt(slot + BM * CAP),
        thr(reinterpret_cast<float*>(cnt + BM)) {}

  // Empty selects, by the whole block; the caller synchronises before the
  // first offer.
  __device__ void init(int threads) {
    for (int i = threadIdx.x; i < BM * K; i += threads) {
      const int q = i / K;
      key[q * CAP + i % K] = CUDART_INF_F;
      slot[q * CAP + i % K] = -1;
    }
    for (int q = threadIdx.x; q < BM; q += threads) {
      cnt[q] = K;
      thr[q] = CUDART_INF_F;
    }
  }

  __device__ __forceinline__ void offer(int q, float k, int s) {
    const int p = atomicAdd(cnt + q, 1);
    key[q * CAP + p] = k;
    slot[q * CAP + p] = s;
  }

  // Merge query q's queue into its running top-128, by its whole warp.
  __device__ void compact(int q) {
    const int lane = threadIdx.x & 31;
    float* kq = key + q * CAP;
    int* sq = slot + q * CAP;
    const int c = cnt[q];
    float bk[4], ak[4];
    int bs[4], as[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = K + (j << 5) + lane;
      bk[j] = i < c ? kq[i] : CUDART_INF_F;
      bs[j] = i < c ? sq[i] : -1;
      ak[j] = kq[(j << 5) + lane];
      as[j] = sq[(j << 5) + lane];
    }
    sort128(bk, bs);
    merge128(ak, as, bk, bs);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kq[(j << 5) + lane] = ak[j];
      sq[(j << 5) + lane] = as[j];
    }
    if (lane == 31) {
      thr[q] = ak[3];  // element 127
      cnt[q] = K;
    }
    __syncwarp();
  }

  // By one warp, after every offer to queries [q0, q0 + n) (n <= 32):
  // compact each of them whose queue could overflow during the next tile.
  __device__ void make_room(int q0, int n) {
    __syncwarp();
    const int lane = threadIdx.x & 31;
    unsigned need =
        __ballot_sync(kFull, lane < n && cnt[q0 + lane] > CAP - BN);
    while (need) {
      const int b = __ffs(need) - 1;
      need &= need - 1;
      compact(q0 + b);
    }
  }

  // Query q's top-128, ascending, into the warp's registers.
  __device__ void result(int q, float (&k)[4], int (&s)[4]) {
    __syncwarp();
    if (cnt[q] > K) compact(q);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      k[j] = key[q * CAP + (j << 5) + lane];
      s[j] = slot[q * CAP + (j << 5) + lane];
    }
  }
};

// One row of a top-128 result: keys ascending, -1 where the key is +inf,
// and the all-+inf floor when `floor` is given.
__device__ __forceinline__ void write_row(const float (&k)[4],
                                          const int (&s)[4], float* key,
                                          int* slot, float* floor) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = (j << 5) + lane;
    key[e] = k[j];
    slot[e] = isinf(k[j]) ? -1 : s[j];
    if (floor != nullptr) floor[e] = CUDART_INF_F;
  }
}

// The second pass of a split launch: per query row, the exact top-128 of
// its `splits` partial top-128s ([splits][nq][128], each ascending), one
// warp per row. 128 threads per block; nq * 128 < 2^31.
__global__ void __launch_bounds__(128)
merge_splits(const float* __restrict__ part_key,
             const int* __restrict__ part_slot, int splits, int nq,
             float* __restrict__ out_key, int* __restrict__ out_slot,
             float* __restrict__ out_floor) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= nq) return;
  const int o = row * K + (threadIdx.x & 31);
  float ak[4], bk[4];
  int as[4], bs[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ak[j] = part_key[o + (j << 5)];
    as[j] = part_slot[o + (j << 5)];
  }
#pragma unroll 1
  for (int p = 1; p < splits; ++p) {
    const long long po = static_cast<long long>(p) * nq * K + o;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = part_key[po + (j << 5)];
      bs[j] = part_slot[po + (j << 5)];
    }
    merge128(ak, as, bk, bs);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = o + (j << 5);
    out_key[e] = ak[j];
    out_slot[e] = isinf(ak[j]) ? -1 : as[j];
    out_floor[e] = CUDART_INF_F;
  }
}

}  // namespace tile_select
