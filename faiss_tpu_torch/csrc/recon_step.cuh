// The scan step shared by the recon kernels (K1, K2): the dot products of a
// block's QB float32 queries with two adjacent columns of a transposed bf16
// store, one bf16 plane or two (hi and lo).
//
// A thread scores columns s and s + 1 (s even, so the pair is one aligned
// bf16x2 word of each plane): per dimension one bf16x2 load of the hi plane
// and, with HILO, one of the lo plane, upcast and summed in float32 (exact:
// the lo plane holds the residual below hi's 8 mantissa bits), then QB
// float4 query loads from shared memory and float32 FMAs on the CUDA cores,
// with no TF32. The loads are coalesced along s across a warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace recon_step {

// Columns s and s + 1 of one dimension as float2: element i of the bf16x2
// view of the hi plane, plus that of the lo plane with HILO.
template <bool HILO>
__device__ __forceinline__ float2 load_pair(const __nv_bfloat162* hp,
                                            const __nv_bfloat162* lp,
                                            long long i) {
  float2 y = __bfloat1622float2(hp[i]);
  if constexpr (HILO) {
    const float2 lo = __bfloat1622float2(lp[i]);
    y.x += lo.x;
    y.y += lo.y;
  }
  return y;
}

// acc0[qi] = q_qi . y[:, s] and acc1[qi] = q_qi . y[:, s + 1] for the QB
// queries qs [QB][d_pad] in shared memory, y = yT (+ yT_lo) with row stride
// ld (even) in elements; d_pad is a multiple of 4.
template <int QB, bool HILO>
__device__ __forceinline__ void dot_pair(const float* qs, int d_pad,
                                         const __nv_bfloat16* yT,
                                         const __nv_bfloat16* yT_lo,
                                         long long ld, long long s,
                                         float (&acc0)[QB], float (&acc1)[QB]) {
#pragma unroll
  for (int qi = 0; qi < QB; ++qi) {
    acc0[qi] = 0.f;
    acc1[qi] = 0.f;
  }
  const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(yT + s);
  const __nv_bfloat162* lp =
      HILO ? reinterpret_cast<const __nv_bfloat162*>(yT_lo + s) : nullptr;
  const long long row2 = ld / 2;  // bf16x2 stride between dimensions
  for (int k = 0; k < d_pad; k += 4) {
    float2 y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) y[u] = load_pair<HILO>(hp, lp, (k + u) * row2);
#pragma unroll
    for (int qi = 0; qi < QB; ++qi) {
      const float4 q = *reinterpret_cast<const float4*>(qs + qi * d_pad + k);
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
}

}  // namespace recon_step
