// K7: the score-only floor of the recon scan, for sm_90a.
//
// Replaces the kernel ``noselect_kernel`` that ``floor_call`` hands to
// pl.pallas_call in benchs/archive/exp_r3c.py (:81, :106), the TPU's
// "MXU-only floor": K2's score producer with no select. For every query row
// r and lane l < 128 it returns
//     out[r, l] = min over the columns s with s % 128 == l of
//                 n2[s] - 2 * q_r . y[:, s]
// over every column of the store (+inf where n2 is +inf), so min over the
// lanes of a row is its best key, K2's first key on the same store.
//
// Arithmetic. The TPU scores q as bf16 hi + lo against the bf16 store on its
// matrix unit. Here the float32 query multiplies y upcast to float32 in
// float32 FMAs on the CUDA cores, through K2's own scan step
// (recon_step::dot_pair, one plane), so a key here is bit for bit the key K2
// offers to its select.
//
// Design. K2's block structure without its select: one block serves QB
// queries and walks all S columns in order, two adjacent columns per thread
// and step. Since a step covers 2 * THREADS columns, a multiple of 128, a
// thread always scores the same two lanes, and keeps their running minima
// for its QB queries in registers. At the end the THREADS / 64 threads that
// share a pair of lanes meet in shared memory, and the block writes its
// [QB, 128] rows. Blocks are independent: no reduction across blocks.
//
// What bounds it: the float32 FMA rate of the CUDA cores (d FMAs per query
// and column), as K2; with 8 queries per block every block streams the whole
// store, mostly from L2 where blocks stay in step. Timing it beside K2 on
// the same queries gives the share of K2's time that its select takes.
//
// Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "recon_step.cuh"

namespace {

constexpr int LANES = 128;        // output lanes
constexpr int QB = 8;             // queries per block (QUERIES_PER_BLOCK)
constexpr int THREADS = 256;      // threads per block
constexpr int STEP = 2 * THREADS; // columns scored per block step
constexpr int REPS = STEP / LANES;  // threads sharing a pair of lanes

static_assert(STEP % LANES == 0, "a thread must keep its lanes");

__global__ void __launch_bounds__(THREADS)
recon_floor_kernel(const float* __restrict__ xq,
                   const __nv_bfloat16* __restrict__ yT,
                   const float* __restrict__ n2, float* __restrict__ out,
                   int d_pad, long long S) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [QB][d_pad]
  float* part = qs + QB * d_pad;               // [REPS][QB][LANES]

  const int tid = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * QB;
  for (int i = tid; i < QB * d_pad; i += THREADS) qs[i] = xq[q0 * d_pad + i];
  __syncthreads();

  float m0[QB], m1[QB];
#pragma unroll
  for (int qi = 0; qi < QB; ++qi) {
    m0[qi] = CUDART_INF_F;
    m1[qi] = CUDART_INF_F;
  }
  for (long long off = 0; off < S; off += STEP) {
    const long long s = off + 2 * tid;
    if (s < S) {  // S is a multiple of 128, so s + 1 < S too
      float acc0[QB], acc1[QB];
      recon_step::dot_pair<QB, false>(qs, d_pad, yT, nullptr, S, s, acc0,
                                      acc1);
      const float2 nn = *reinterpret_cast<const float2*>(n2 + s);
#pragma unroll
      for (int qi = 0; qi < QB; ++qi) {
        m0[qi] = fminf(m0[qi], nn.x - 2.f * acc0[qi]);
        m1[qi] = fminf(m1[qi], nn.y - 2.f * acc1[qi]);
      }
    }
  }
  const int lane = (2 * tid) % LANES, rep = (2 * tid) / LANES;
#pragma unroll
  for (int qi = 0; qi < QB; ++qi) {
    part[(rep * QB + qi) * LANES + lane] = m0[qi];
    part[(rep * QB + qi) * LANES + lane + 1] = m1[qi];
  }
  __syncthreads();
  for (int i = tid; i < QB * LANES; i += THREADS) {
    float v = part[i];
#pragma unroll
    for (int r = 1; r < REPS; ++r) v = fminf(v, part[r * QB * LANES + i]);
    out[q0 * LANES + i] = v;
  }
}

}  // namespace

// Dynamic shared memory of one block: queries and the lanes' partial minima.
extern "C" long long recon_floor_smem_bytes(int d_pad) {
  return static_cast<long long>(sizeof(float)) * QB * (d_pad + REPS * LANES);
}

// xq [nq, d_pad] float32, yT [d_pad, S] bf16 (contiguous), n2 [1, S] float32,
// out [nq, 128] float32. qt and ct are the TPU kernel's tiles, checked for
// the contract only: nq a multiple of qt (itself a multiple of QB), S a
// multiple of ct, itself a multiple of 128.
extern "C" int recon_floor_launch(const void* xq, const void* yT,
                                  const void* n2, void* out, int nq, int d_pad,
                                  long long S, int qt, int ct, void* stream) {
  if (nq <= 0 || qt <= 0 || nq % qt != 0 || qt % QB != 0 || ct <= 0 ||
      ct % LANES != 0 || S % ct != 0 || d_pad <= 0 || d_pad % 4 != 0 ||
      S >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = recon_floor_smem_bytes(d_pad);
  cudaError_t err = cudaFuncSetAttribute(
      recon_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  recon_floor_kernel<<<nq / QB, THREADS, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xq), static_cast<const __nv_bfloat16*>(yT),
      static_cast<const float*>(n2), static_cast<float*>(out), d_pad, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* recon_floor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
