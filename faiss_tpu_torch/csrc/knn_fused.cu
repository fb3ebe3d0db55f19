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
// Arithmetic: float32 FMAs on the CUDA cores, no TF32, matching the
// reference's Precision.HIGHEST. ||y||^2 is summed in the kernel from the
// same loads as the products.
//
// Design. One block serves QB queries and walks the columns in order, two
// adjacent columns per thread and step (one float2 load per dimension,
// coalesced along s). The keys go through the exact select of
// exact_select.cuh, instantiated for the power of two KP >= k_lanes. Its
// per-query buffer grows with KP (CAP pairs of 8 bytes, up to 32 KiB at KP =
// 2048), so the queries per block shrink to 4 at KP = 2048 to stay inside
// the 227 KiB a Hopper block may have.
//
// What bounds it: every block streams the whole float32 store (4 * d bytes
// per column, QB FMAs per loaded float, plus one for the norm), from L2 where
// blocks stay in step; and the float32 FMA rate of the CUDA cores. A
// tensor-core product (3xTF32 or a bf16 split) and more queries per block are
// later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "exact_select.cuh"

namespace {

constexpr int THREADS = 256;      // threads per block
constexpr int STEP = 2 * THREADS; // columns scored per block step
constexpr int FLOOR_LANES = 128;  // width of the eviction floor

// Per-query buffer: room for a step after a compaction, and enough slack
// that the late, rare appends do not compact at every step.
__host__ __device__ constexpr int cap_for(int kp) { return kp <= 256 ? 1024 : kp <= 1024 ? 2048 : 4096; }
__host__ __device__ constexpr int qb_for(int kp) { return kp >= 2048 ? 4 : 8; }

template <int KP>
using SelectFor =
    exact_select::Select<KP, cap_for(KP), qb_for(KP), THREADS, STEP>;

// Queries (zero-padded to dq, a multiple of 4), their norms, then the select.
template <int KP>
long long smem_bytes(int dq) {
  return static_cast<long long>(sizeof(float)) * qb_for(KP) * (dq + 1) +
         SelectFor<KP>::kBytes;
}

template <int KP>
__global__ void __launch_bounds__(THREADS)
knn_fused_kernel(const float* __restrict__ x, const float* __restrict__ yT,
                 long long ld, long long nb, int metric_l2,
                 float* __restrict__ out_v, int* __restrict__ out_i,
                 float* __restrict__ out_ev, int d, int dq, int k_lanes) {
  constexpr int QB = qb_for(KP);
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [QB][dq]
  float* qn = qs + QB * dq;                     // [QB]
  SelectFor<KP> sel(smem + sizeof(float) * QB * (dq + 1));

  const int tid = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * QB;

  for (int i = tid; i < QB * dq; i += THREADS) {
    const int r = i / dq, c = i % dq;
    qs[i] = c < d ? x[(q0 + r) * d + c] : 0.f;
  }
  sel.init();
  __syncthreads();

  const int d4 = d & ~3;
  for (long long off = 0; off < nb; off += STEP) {
    sel.make_room();
    const long long s = off + 2 * tid;
    if (s < nb) {  // s + 1 < ld always (ld is even); it is scored if < nb
      float acc0[QB], acc1[QB];
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) {
        acc0[qi] = 0.f;
        acc1[qi] = 0.f;
      }
      float n0 = 0.f, n1 = 0.f;
      const float* yp = yT + s;
      for (int k = 0; k < d4; k += 4) {
        float2 y[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          y[u] = *reinterpret_cast<const float2*>(yp + (k + u) * ld);
          n0 = fmaf(y[u].x, y[u].x, n0);
          n1 = fmaf(y[u].y, y[u].y, n1);
        }
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) {
          const float4 q = *reinterpret_cast<const float4*>(qs + qi * dq + k);
          acc0[qi] = fmaf(q.x, y[0].x, acc0[qi]);
          acc1[qi] = fmaf(q.x, y[0].y, acc1[qi]);
          acc0[qi] = fmaf(q.y, y[1].x, acc0[qi]);
          acc1[qi] = fmaf(q.y, y[1].y, acc1[qi]);
          acc0[qi] = fmaf(q.z, y[2].x, acc0[qi]);
          acc1[qi] = fmaf(q.z, y[2].y, acc1[qi]);
          acc0[qi] = fmaf(q.w, y[3].x, acc0[qi]);
          acc1[qi] = fmaf(q.w, y[3].y, acc1[qi]);
        }
      }
      for (int k = d4; k < d; ++k) {
        const float2 y = *reinterpret_cast<const float2*>(yp + k * ld);
        n0 = fmaf(y.x, y.x, n0);
        n1 = fmaf(y.y, y.y, n1);
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) {
          acc0[qi] = fmaf(qs[qi * dq + k], y.x, acc0[qi]);
          acc1[qi] = fmaf(qs[qi * dq + k], y.y, acc1[qi]);
        }
      }
      const bool second = s + 1 < nb;
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) {
        const float k0 = metric_l2 ? n0 - 2.f * acc0[qi] : -acc0[qi];
        const float k1 = metric_l2 ? n1 - 2.f * acc1[qi] : -acc1[qi];
        sel.offer(qi, k0, static_cast<int>(s));
        if (second) sel.offer(qi, k1, static_cast<int>(s + 1));
      }
    }
    __syncthreads();
  }
  sel.finish();
  if (tid < QB) {
    float n = 0.f;
    for (int k = 0; k < d; ++k) n = fmaf(qs[tid * dq + k], qs[tid * dq + k], n);
    qn[tid] = n;
  }
  __syncthreads();
  for (int i = tid; i < QB * k_lanes; i += THREADS) {
    const int qi = i / k_lanes, j = i % k_lanes;
    const float kv = sel.kth_key(qi, j);
    const int id = isinf(kv) ? -1 : sel.kth_slot(qi, j);
    float v;
    if (metric_l2) {
      v = id < 0 ? CUDART_INF_F : fmaxf(kv + qn[qi], 0.f);
    } else {
      v = id < 0 ? -CUDART_INF_F : -kv;
    }
    const long long o = (q0 + qi) * k_lanes + j;
    out_v[o] = v;
    out_i[o] = id;
  }
  for (int i = tid; i < QB * FLOOR_LANES; i += THREADS) {
    out_ev[q0 * FLOOR_LANES + i] = metric_l2 ? CUDART_INF_F : -CUDART_INF_F;
  }
}

template <int KP>
int launch(const void* x, const void* yT, long long ld, long long nb,
           int metric_l2, void* out_v, void* out_i, void* out_ev, int nq,
           int d, int dq, int k_lanes, void* stream) {
  const long long smem = smem_bytes<KP>(dq);
  cudaError_t err = cudaFuncSetAttribute(
      knn_fused_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_fused_kernel<KP><<<nq / qb_for(KP), THREADS, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(yT), ld, nb,
      metric_l2, static_cast<float*>(out_v), static_cast<int*>(out_i),
      static_cast<float*>(out_ev), d, dq, k_lanes);
  return static_cast<int>(cudaGetLastError());
}

int kp_for(int k_lanes) {
  int kp = 128;
  while (kp < k_lanes) kp <<= 1;
  return kp;
}

}  // namespace

// Dynamic shared memory of one block for d dimensions and k_lanes.
extern "C" long long knn_fused_smem_bytes(int d, int k_lanes) {
  const int dq = (d + 3) & ~3;
  switch (kp_for(k_lanes)) {
    case 128: return smem_bytes<128>(dq);
    case 256: return smem_bytes<256>(dq);
    case 512: return smem_bytes<512>(dq);
    case 1024: return smem_bytes<1024>(dq);
    default: return smem_bytes<2048>(dq);
  }
}

// ld: the padded store width (row stride of yT); nb <= ld: the true columns.
// qt and ct are the TPU kernel's tiles, checked for the contract only (nq a
// multiple of qt, itself a multiple of 8; ld a multiple of ct).
extern "C" int knn_fused_launch(const void* x, const void* yT, long long ld,
                                long long nb, int metric_l2, void* out_v,
                                void* out_i, void* out_ev, int nq, int d,
                                int k_lanes, int qt, int ct, void* stream) {
  if (nq <= 0 || qt <= 0 || nq % qt != 0 || qt % 8 != 0 || ct <= 0 ||
      ld % ct != 0 || ld % 2 != 0 || nb < 0 || nb > ld || ld >= (1LL << 31) ||
      d <= 0 || k_lanes < 128 || k_lanes > 2048 || k_lanes % 128 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dq = (d + 3) & ~3;
  switch (kp_for(k_lanes)) {
    case 128:
      return launch<128>(x, yT, ld, nb, metric_l2, out_v, out_i, out_ev, nq,
                         d, dq, k_lanes, stream);
    case 256:
      return launch<256>(x, yT, ld, nb, metric_l2, out_v, out_i, out_ev, nq,
                         d, dq, k_lanes, stream);
    case 512:
      return launch<512>(x, yT, ld, nb, metric_l2, out_v, out_i, out_ev, nq,
                         d, dq, k_lanes, stream);
    case 1024:
      return launch<1024>(x, yT, ld, nb, metric_l2, out_v, out_i, out_ev, nq,
                          d, dq, k_lanes, stream);
    default:
      return launch<2048>(x, yT, ld, nb, metric_l2, out_v, out_i, out_ev, nq,
                          d, dq, k_lanes, stream);
  }
}

extern "C" const char* knn_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
