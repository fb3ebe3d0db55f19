// K3: exact float32 brute-force k-NN with an exact top-k_lanes, for sm_90a.
//
// Replaces faiss_tpu/ops/pallas_knn.py:knn_fused_pallas. For every query row
// r it selects the k_lanes (a multiple of 128, at most 2048) smallest keys
//     L2:  key(s) = ||y_s||^2 - 2 * q_r . y_s
//     IP:  key(s) = -q_r . y_s
// over the columns s < nb of the transposed float32 store yT [d, ld] (the
// columns from nb to ld are zero pads and are never scored), and returns
// them best-first as the TPU kernel does after its final transform:
//     L2:  max(key + ||q_r||^2, 0), +inf where the id is -1;
//     IP:  -key = q_r . y_s (largest first), -inf where the id is -1;
// the column of each (-1 where none), and the eviction floor [nq, 128],
// +inf for L2 and -inf for IP, since the select never evicts.
//
// What bounds it on this card: the products. The float32-accurate product
// of 1,024 queries with a 1M x 128 store is 0.8 PFLOP in 3xTF32 (1.6 ms at
// the tensor cores' 495 TFLOP/s, 3.9 ms in float32 FMAs on the CUDA cores).
// An exact top-2048 per query is 16 KB of state, which leaves a block that
// keeps it in shared memory a handful of queries, each re-reading the whole
// 512 MB store. So the select keeps no per-query state in shared memory; a
// block serves 64 queries on the tensor cores, at the price of running the
// products twice:
//   PHASE_N2      n2[s] = ||y_s||^2 in float32 FMAs (L2 only), one pass over yT;
//   PHASE_MIN     pass 1 (knn_mma.cuh, epilogue MIN): each row's smallest key
//                 of every bucket of W = 32 consecutive columns;
//   PHASE_THETA   per row, theta = the k_lanes-th smallest bucket minimum
//                 (+inf with fewer than k_lanes buckets), by a radix select;
//                 the row's counters set to 0;
//   PHASE_APPEND  pass 2 (the same products, epilogue APPEND): every key
//                 below theta to the row's lt region, every key equal to it
//                 to its eq region (k_lanes pairs, the rest dropped);
//   PHASE_FINAL   per row, the k_lanes smallest of lt + eq (a radix select
//                 where lt holds more than k_lanes), sorted, transformed.
// Exact, in a buffer fixed in advance: the k_lanes buckets whose minima are
// <= theta hold k_lanes columns with keys <= theta, so the true k_lanes-th
// key is <= theta and every key of the true top-k_lanes lies in lt or eq; a
// key below theta lies in one of the < k_lanes buckets whose minimum is
// below theta, so lt never holds more than (k_lanes - 1) * W pairs; any
// k_lanes of the keys equal to theta are a valid choice among ties. This
// rests on pass 2 computing bitwise the keys of pass 1, which it does: the
// same code in the same order. The columns are split across blocks so that a
// launch fills the card; with no state carried across tiles, a split needs
// no merge.
//
// On the H100 each product pass runs near mma.sync's TF32 rate: without its
// products, a pass streams the store in under half its time, so the
// consumers' instruction stream (the operands' splits and the mma.sync)
// bounds it, not the feed. wgmma forms were tried and were no faster: with
// A (the store) from registers at 64 queries (m64n64k8), and slower at 128
// (m64n128k8), whose accumulators spill at the 168 registers a thread of a
// 384-thread block gets. The selects take a few per cent of the time.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_mma.cuh"
#include "radix_select.cuh"

namespace {

constexpr int PHASE_N2 = 1, PHASE_MIN = 2, PHASE_THETA = 4, PHASE_APPEND = 8,
              PHASE_FINAL = 16;
constexpr int SELECT_THREADS = 256;  // threads of a select block (one row)
constexpr int FLOOR_LANES = 128;     // width of the eviction floor

// n2[s] for s < ld, 0 from ld to ncols.
__global__ void norms_kernel(const float* __restrict__ yT, long long ld, int d,
                             long long ncols, float* __restrict__ n2) {
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= ncols) return;
  float n = 0.f;
  if (s < ld) {
    for (int k = 0; k < d; ++k) {
      const float y = yT[k * ld + s];
      n = fmaf(y, y, n);
    }
  }
  n2[s] = n;
}

template <int MODE>
__global__ void __launch_bounds__(knn_mma::THREADS, 1)
scan_kernel(const knn_mma::Args a, const __grid_constant__ CUtensorMap map) {
  knn_mma::scan<MODE>(a, &map);
}

// theta of row blockIdx.x: the k_lanes-th smallest of its nbk bucket minima,
// +inf where there are fewer than k_lanes; its counters set to 0.
__global__ void __launch_bounds__(SELECT_THREADS)
theta_kernel(const float* __restrict__ minima, long long ldm, int nbk,
             int k_lanes, float* __restrict__ theta, int* __restrict__ counts) {
  __shared__ radix_select::Scratch s;
  const long long row = blockIdx.x;
  if (threadIdx.x < 2) counts[2 * row + threadIdx.x] = 0;
  if (nbk < k_lanes) {
    if (threadIdx.x == 0) theta[row] = CUDART_INF_F;
    return;
  }
  const float* m = minima + row * ldm;
  const uint32_t kth = radix_select::kth(
      nbk, k_lanes - 1,
      [m](int i) { return radix_select::order_bits(m[i]); }, s);
  if (threadIdx.x == 0) theta[row] = radix_select::from_order_bits(kth);
}

// The final select of row blockIdx.x over its lt and eq regions, sorted
// (KP: the power of two >= k_lanes), transformed and written out with the
// floor.
template <int KP>
__global__ void __launch_bounds__(SELECT_THREADS)
final_kernel(const int2* __restrict__ cand, const int* __restrict__ counts,
             const float* __restrict__ x, int d, int k_lanes, int lt_cap,
             int metric_l2, float* __restrict__ out_v, int* __restrict__ out_i,
             float* __restrict__ out_ev) {
  __shared__ uint32_t key[KP];
  __shared__ int id[KP];
  __shared__ radix_select::Scratch s;
  __shared__ int fill;
  __shared__ float qpart[SELECT_THREADS / 32];
  const long long row = blockIdx.x;
  const int2* c = cand + row * (lt_cap + k_lanes);
  const int nlt = min(counts[2 * row], lt_cap);
  const int neq = min(counts[2 * row + 1], k_lanes);
  for (int i = threadIdx.x; i < KP; i += SELECT_THREADS) {
    key[i] = 0xffffffffu;  // after every key, +inf included
    id[i] = -1;
  }
  if (threadIdx.x == 0) fill = 0;
  __syncthreads();
  if (nlt > k_lanes) {  // every winner lies in lt: below its k_lanes-th, then ties
    const uint32_t kth = radix_select::kth(
        nlt, k_lanes - 1,
        [c](int i) { return radix_select::order_bits(__int_as_float(c[i].x)); }, s);
    for (int i = threadIdx.x; i < nlt; i += SELECT_THREADS) {
      const int2 p = c[i];
      const uint32_t u = radix_select::order_bits(__int_as_float(p.x));
      if (u < kth) {
        const int at = atomicAdd(&fill, 1);
        key[at] = u;
        id[at] = p.y;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nlt; i += SELECT_THREADS) {
      const int2 p = c[i];
      const uint32_t u = radix_select::order_bits(__int_as_float(p.x));
      if (u == kth) {
        const int at = atomicAdd(&fill, 1);
        if (at < k_lanes) {
          key[at] = u;
          id[at] = p.y;
        }
      }
    }
  } else {  // all of lt, then eq up to k_lanes
    const int take = min(neq, k_lanes - nlt);
    for (int i = threadIdx.x; i < nlt + take; i += SELECT_THREADS) {
      const int2 p = i < nlt ? c[i] : c[lt_cap + i - nlt];
      key[i] = radix_select::order_bits(__int_as_float(p.x));
      id[i] = p.y;
    }
  }
  __syncthreads();
  radix_select::sort<KP>(key, id);
  float qn = 0.f;  // ||q||^2
  if (metric_l2) {
    for (int k = threadIdx.x; k < d; k += SELECT_THREADS) {
      const float v = x[row * d + k];
      qn = fmaf(v, v, qn);
    }
    for (int off = 16; off > 0; off >>= 1) qn += __shfl_xor_sync(0xffffffffu, qn, off);
    if ((threadIdx.x & 31) == 0) qpart[threadIdx.x >> 5] = qn;
    __syncthreads();
    qn = 0.f;
    for (int w = 0; w < SELECT_THREADS / 32; ++w) qn += qpart[w];
  }
  for (int j = threadIdx.x; j < k_lanes; j += SELECT_THREADS) {
    const float kv = key[j] == 0xffffffffu ? CUDART_INF_F
                                           : radix_select::from_order_bits(key[j]);
    const int i = isinf(kv) ? -1 : id[j];
    float v;
    if (metric_l2) {
      v = i < 0 ? CUDART_INF_F : fmaxf(kv + qn, 0.f);
    } else {
      v = i < 0 ? -CUDART_INF_F : -kv;
    }
    out_v[row * k_lanes + j] = v;
    out_i[row * k_lanes + j] = i;
  }
  for (int j = threadIdx.x; j < FLOOR_LANES; j += SELECT_THREADS) {
    out_ev[row * FLOOR_LANES + j] = metric_l2 ? CUDART_INF_F : -CUDART_INF_F;
  }
}

template <int MODE>
int launch_scan(const knn_mma::Args& a, const CUtensorMap& map, cudaStream_t st) {
  constexpr int smem = knn_mma::smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nqb = (a.nq + knn_mma::BM - 1) / knn_mma::BM;
  scan_kernel<MODE><<<nqb * a.splits, knn_mma::THREADS, smem, st>>>(a, map);
  return static_cast<int>(cudaGetLastError());
}

template <int KP>
void launch_final(const knn_mma::Args& a, cudaStream_t st, float* out_v,
                  int* out_i, float* out_ev) {
  final_kernel<KP><<<a.nq, SELECT_THREADS, 0, st>>>(
      a.cand, a.counts, a.x, a.d, a.k_lanes, a.lt_cap, a.metric_l2, out_v,
      out_i, out_ev);
}

}  // namespace

// Dynamic shared memory of one block of a product pass (the selects use
// static shared memory only); d and k_lanes do not change it.
extern "C" long long knn_fused_smem_bytes(int d, int k_lanes) {
  (void)d;
  (void)k_lanes;
  return knn_mma::smem_bytes();
}

// ld: the row stride of yT (a multiple of 4, for TMA); nb <= ld: the true
// columns. qt and ct are the TPU kernel's tiles, checked for the contract
// only (nq a multiple of qt, itself a multiple of 8; ld a multiple of ct).
// Scratch: n2 [>= ceil(ld / BN) * BN], minima [nq, ldm] (ldm >= the
// buckets), theta [nq], counts [nq, 2], cand [nq, (k_lanes - 1) * W +
// k_lanes] (key bits, column) pairs. splits: column splits of the product
// passes; phases: the PHASE_* bits to run, in order.
extern "C" int knn_fused_launch(const void* x, const void* yT, long long ld,
                                long long nb, int metric_l2, void* out_v,
                                void* out_i, void* out_ev, int nq, int d,
                                int k_lanes, int qt, int ct, void* n2,
                                void* minima, long long ldm, void* theta,
                                void* counts, void* cand, int splits,
                                int phases, void* stream) {
  const long long nbk = (nb + knn_mma::W - 1) / knn_mma::W;
  if (nq <= 0 || qt <= 0 || nq % 8 != 0 || qt % 8 != 0 || ct <= 0 ||
      ld % ct != 0 || ld % 4 != 0 || nb < 0 || nb > ld || ld >= (1LL << 31) ||
      d <= 0 || k_lanes < 128 || k_lanes > 2048 || k_lanes % 128 != 0 ||
      ldm < nbk || splits < 1 || reinterpret_cast<uintptr_t>(yT) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  knn_mma::Args a;
  a.x = static_cast<const float*>(x);
  a.n2 = static_cast<const float*>(n2);
  a.minima = static_cast<float*>(minima);
  a.theta = static_cast<const float*>(theta);
  a.counts = static_cast<int*>(counts);
  a.cand = static_cast<int2*>(cand);
  a.nb = nb;
  a.ldm = ldm;
  a.nq = nq;
  a.d = d;
  a.d_pad = (d + knn_mma::KC - 1) / knn_mma::KC * knn_mma::KC;
  a.metric_l2 = metric_l2;
  a.k_lanes = k_lanes;
  a.lt_cap = (k_lanes - 1) * knn_mma::W;
  a.ntiles = static_cast<int>((nb + knn_mma::BN - 1) / knn_mma::BN);
  a.splits = splits;
  CUtensorMap map;
  if (phases & (PHASE_MIN | PHASE_APPEND)) {
    const int err = knn_mma::make_map(&map, yT, ld, d);
    if (err != 0) return err;
  }
  int err = 0;
  if ((phases & PHASE_N2) && metric_l2) {
    const long long ncols = (ld + knn_mma::BN - 1) / knn_mma::BN * knn_mma::BN;
    norms_kernel<<<static_cast<unsigned>((ncols + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(yT), ld, d, ncols, static_cast<float*>(n2));
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if ((phases & PHASE_MIN) && a.ntiles > 0) {
    err = launch_scan<knn_mma::MIN>(a, map, st);
    if (err != 0) return err;
  }
  if (phases & PHASE_THETA) {
    theta_kernel<<<nq, SELECT_THREADS, 0, st>>>(
        static_cast<const float*>(minima), ldm, static_cast<int>(nbk), k_lanes,
        static_cast<float*>(theta), static_cast<int*>(counts));
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if ((phases & PHASE_APPEND) && a.ntiles > 0) {
    err = launch_scan<knn_mma::APPEND>(a, map, st);
    if (err != 0) return err;
  }
  if (phases & PHASE_FINAL) {
    float* v = static_cast<float*>(out_v);
    int* i = static_cast<int*>(out_i);
    float* ev = static_cast<float*>(out_ev);
    if (k_lanes <= 128) launch_final<128>(a, st, v, i, ev);
    else if (k_lanes <= 256) launch_final<256>(a, st, v, i, ev);
    else if (k_lanes <= 512) launch_final<512>(a, st, v, i, ev);
    else if (k_lanes <= 1024) launch_final<1024>(a, st, v, i, ev);
    else launch_final<2048>(a, st, v, i, ev);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

extern "C" const char* knn_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
