// K1's scan (ivf_recon_dyn.cu) on Hopper's warpgroup products: the keys
//     key(r, s) = n2[s] - 2 * q_r . (y_hi[:, s] + y_lo[:, s])  (+ pen)
// of a block's BM = 64 float32 queries over a worklist walk of 64-column
// tiles of the transposed bf16 store (one plane, or hi and lo), offered to
// the exact top-128 select of tile_select.cuh. The arithmetic is
// recon_mma.cuh's: each query split into bf16 hi = bf16(q) and lo =
// bf16(q - hi), then qh.yh + ql.yh + qh.yl with two planes, qh.y + ql.y
// with one, bf16 products summed in float32 into one set of accumulators.
//
// Why wgmma with two consumer warpgroups. The mma.sync scan
// (recon_mma.cuh) read each query fragment and store tile again per warp
// with ldmatrix, about 128 KB of shared memory a tile, and ran the
// products, the epilogue and the select one after another in each of its
// 8 warps: ~3,500 cycles a tile at Deep10M's shape on the H100, ~1,140 of
// them issuing products (PERF.md). Here two warpgroups of 4 warps share
// the block's 64 queries and take alternate column tiles (ping-pong):
// while one warpgroup's wgmma.m64n64k16 products of its tile are in
// flight, the other offers its own tile's keys to the select. One
// warpgroup alone was slower than the mma.sync scan, because its 4 warps
// ran the epilogue and select with no products beside them; the second
// warpgroup is what overlaps them.
//
// Data flow. A producer warp streams each tile's dims, up to 128 at a
// ring stage, as TMA boxes of [64 dims, 64 columns] per plane (the
// 128-byte swizzle) with the tile's n2, into a ring of stages(HILO) stages
// with full/empty mbarriers, in tile order; warpgroup g consumes the tiles
// t = g, g + 2, ... The store plane is the wgmma's B operand straight from
// shared memory (MN-major: columns contiguous, transposed in the
// descriptor). The queries are its A operand from registers: each thread
// splits its rows' fragments into hi and lo once, from the float32
// queries (per 128 dims and tile when d > 128), so no tile reads them
// again and no shared memory holds them. Only the real dims are loaded and
// multiplied: the wrapper passes d beside d_pad, and the kernel instance
// takes d rounded up to 32 (64 at least, 128s past 128) as a constant number of
// k-steps, a k-step under a branch serialising the wgmmas; the descriptors'
// rows end there (a box past them is not issued, a box across them is
// zero-filled by TMA without a read). The rows skipped are the store's and
// the queries' zero padding, which adds exact zeros to every sum, so the
// keys do not change; at d = 96 a quarter of the padded products and
// store bytes go. The producer's warpgroup gives its registers to the
// consumers' (setmaxnreg).
//
// The select. Warp w of either warpgroup holds query rows 16 w .. + 16
// (wgmma's m64 accumulator layout: lane l rows 16 w + l / 4 (+ 8) and
// columns 8 j + 2 (l % 4) + {0, 1}, the m16n8 layout of recon_mma.cuh per
// 8-column block j), so the same two warps share a row group's select, as
// the mma.sync scan's WN = 2 pair did. They take turns on it under the
// row group's two 64-thread named barriers: warp w computes tile t's keys
// and drops those above the rows' thresholds as last seen (a threshold
// only falls) before its turn, then in its turn appends the rest (at most
// BN = 64 a row), compacts the rows whose queues could not take another
// tile, and hands the turn to the other warpgroup's warp w for tile t + 1.
// The select's invariant (at most BN offers a row between two compactions)
// holds as before, and nothing waits at a block-wide barrier until the
// rows are written.
//
// What bounds it afterwards (PERF.md, clock64 stamps of a scratch build,
// Deep10M's first sub-batch): ~1,400 cycles a tile, ~2.5x fewer. A
// warpgroup's products take ~1,200 of its ~2,800 cycles a tile, far above
// their ~400 at the tensor cores' rate, because a wgmma waits for all 4
// warps of its warpgroup, and each warp's turn waits for its own row
// group's select; a turn takes ~900 (appends ~600, compactions ~300), the
// keys ~250 before it. Keeping the next tile's products in flight through
// a turn (a second set of accumulators) made ptxas serialise the wgmmas
// at 168 registers a thread. At the SIFT shape (d = 128, 2048 queries) the
// turns' selects, ~4,300 cycles a tile, set the pace.
//
// Shared memory per block (bytes): the ring, stages(HILO) stages of 128
// dims x 64 columns per plane (4 x 16,384 with one plane, 3 x 32,768 with
// two) and 256 of n2 each; the select, 64 queries x 2 KB + 512; the full
// and empty mbarriers: 198,208 with one plane, 230,704 with two, of the
// 232,448 a block may have: one block of 12 warps per SM.

#pragma once

#include "recon_mma.cuh"

namespace recon_wgmma {

using recon_mma::Args;
using recon_mma::K;
using recon_mma::Maps;
using recon_mma::mbar_arrive;
using recon_mma::mbar_expect;
using recon_mma::mbar_init;
using recon_mma::mbar_wait;
using recon_mma::smem_u32;
using recon_mma::tma_2d;

constexpr int BM = 64;                  // queries per block
constexpr int BN = 64;                  // columns per tile
constexpr int SEG = 128;                // dims per ring stage
constexpr int KC = 64;                  // dims per TMA box
constexpr int KSTEPS = SEG / 16;        // wgmma k-steps per stage
constexpr int CONSUMERS = 2 * 128;      // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + the producer's warpgroup
// Registers a thread after the rebalancing (setmaxnreg): the producer's
// warpgroup gives its 168 down to 40, the consumers take them up to 232
// (a wgmma kernel's registers are allocated by warpgroup, so 384 threads
// start at 168).
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int CAP = 256;                // select pairs per query
// Named barriers: 1 + rg hands row group rg's select from warpgroup 0 to
// warpgroup 1, 5 + rg back (one barrier each way, so that an arrival is
// never counted in the other direction's phase); BAR_ALL joins the
// consumers.
constexpr int BAR_ALL = 9;

using Select = tile_select::Select<BM, CAP, BN>;

constexpr int kBox = KC * BN * 2;    // one TMA box, bf16
constexpr int kPlane = SEG * BN * 2;  // one plane of a stage

__host__ __device__ constexpr int stages(bool hilo) { return hilo ? 3 : 4; }

__host__ __device__ constexpr int stage_bytes(bool hilo) {
  return (hilo ? 2 : 1) * kPlane;
}

// Shared memory, in this order: the ring's stages (each 1024-byte aligned
// for the swizzle), their n2, the select, the full and empty mbarriers.
__host__ __device__ constexpr int smem_bytes(bool hilo) {
  return stages(hilo) * (stage_bytes(hilo) + BN * 4) + Select::kBytes +
         2 * stages(hilo) * 8;
}

// The wgmma descriptor of a [16 dims, 64 columns] slice of a stage plane at
// shared address `addr`: MN-major with the 128-byte swizzle, 8-row groups
// of 128-byte rows 1,024 bytes apart (the stride byte offset); the leading
// byte offset spans 64 columns and is not used at n = 64.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kBox >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving the accumulators across the asynchronous
// products (before the fence and after the wait).
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a (64 x 16, registers) . b (16 x 64, shared memory, transposed),
// bf16 in, float32 accumulate; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The warp's row within the block's 64 and the thread's first column of
// each 8-column block: d[4 j + 2 h + e] is row a_row() + 8 h, column
// 8 j + a_col() + e of the tile.
__device__ __forceinline__ int a_row() {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}

__device__ __forceinline__ int a_col() { return 2 * (threadIdx.x & 3); }

// The thread's A fragments of dims [k0, k0 + 16 NKS) of its rows (wgmma's
// m64k16 register layout: fragment i holds row a_row() + 8 (i & 1) and
// dims 16 kk + a_col() + 8 (i >> 1) + {0, 1}), each float32 pair split into
// bf16 hi and lo as recon_mma::load_queries does; zero for rows past
// `rows`.
template <int NKS>
__device__ __forceinline__ void load_a(const Args& a, long long q0, int rows,
                                       int k0, uint32_t (&ah)[NKS][4],
                                       uint32_t (&al)[NKS][4]) {
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = a_row() + 8 * (i & 1);
      float2 x = make_float2(0.f, 0.f);
      if (r < rows) {
        x = *reinterpret_cast<const float2*>(
            a.xq + (q0 + r) * a.d_pad + k0 + 16 * kk + a_col() + 8 * (i >> 1));
      }
      const __nv_bfloat162 hb = __floats2bfloat162_rn(x.x, x.y);
      const float2 hf = __bfloat1622float2(hb);
      ah[kk][i] = *reinterpret_cast<const uint32_t*>(&hb);
      al[kk][i] = recon_mma::pack_bf16(x.x - hf.x, x.y - hf.y);
    }
  }
}

// The products of a stage's first NKS k-steps into d: qh.y + ql.y (+
// qh.y_lo), all in flight once issued; `first` overwrites d. NKS is a
// constant: a k-step under a branch would serialise the wgmmas.
template <bool HILO, int NKS>
__device__ __forceinline__ void products(uint32_t stage, bool first,
                                         const uint32_t (&ah)[NKS][4],
                                         const uint32_t (&al)[NKS][4],
                                         float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk) {
    const uint64_t bh = desc_b(stage + kk * 16 * BN * 2);
    wgmma(d, ah[kk], bh, first && kk == 0 ? 0 : 1);
    wgmma(d, al[kk], bh, 1);
    if constexpr (HILO) {
      wgmma(d, ah[kk], desc_b(stage + kPlane + kk * 16 * BN * 2), 1);
    }
  }
}

// The keys of the warp's 16 rows x 64 columns of tile t, in place of
// their products in d (d[4 j + 2 h + e]: row a_row() + 8 h, column 8 j +
// a_col() + e), and in keep[h] the bits of those below their row's
// threshold as last seen. Run before the row group's turn: a threshold
// only falls, so a key that misses it here misses it in the turn. A row
// whose smallest key misses offers nothing. With PEN, where the warp's
// columns all belong to one list, each row's bias is read once; otherwise
// a key whose bias-free value plus the row's smallest bias in the tile's
// group already misses is dropped before its bias is read (the rounded
// sum is monotone in the bias, so both are exact).
template <bool PEN, class Walk>
__device__ __forceinline__ void keys(const Args& a, const Walk& w, int t,
                                     const float (&n2v)[16], const Select& sel,
                                     float (&d)[32], long long q0, int rows,
                                     int& grp, float (&pmin)[2],
                                     unsigned (&keep)[2]) {
  const int r0 = a_row();
  const int c0 = a_col();
  int lids[16];
  bool one_list = false;
  float pen[2] = {0.f, 0.f};
  if constexpr (PEN) {
    const long long col = w.col(t);
    const int g = w.group(t);
    if (g != grp) {
      recon_mma::bias_floor(a, q0, rows, r0, g, pmin);
      grp = g;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 l = __ldg(reinterpret_cast<const int2*>(a.lid + col + c0 + 8 * j));
      lids[2 * j] = l.x;
      lids[2 * j + 1] = l.y;
    }
    const int first = __shfl_sync(tile_select::kFull, lids[0], 0);
    bool same = true;
#pragma unroll
    for (int i = 0; i < 16; ++i) same = same && lids[i] == first;
    one_list = __all_sync(tile_select::kFull, same);
    if (one_list) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        pen[h] = r < rows ? a.biasg[(q0 + r) * a.nbias +
                                    static_cast<long long>(grp) * K + first]
                          : 0.f;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    // the other warpgroup may be lowering it: read it once, as it is now
    const float thr = r < rows ? *static_cast<const volatile float*>(sel.thr + r)
                               : -CUDART_INF_F;
    const float gate = one_list ? pen[h] : pmin[h];  // 0 without PEN
    float kmin = CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float& k = d[4 * (i / 2) + 2 * h + i % 2];
      k = n2v[i] - 2.f * k;
      kmin = fminf(kmin, k);
    }
    keep[h] = 0;
    if (PEN ? kmin + gate < thr : kmin < thr) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float& k = d[4 * (i / 2) + 2 * h + i % 2];
        if constexpr (PEN) {
          if (one_list) {
            k += pen[h];
          } else if (k + pmin[h] < thr) {
            k += a.biasg[(q0 + r) * a.nbias + static_cast<long long>(grp) * K +
                         lids[i]];
          } else {
            continue;
          }
        }
        keep[h] |= (k < thr ? 1u : 0u) << i;
      }
    }
  }
}

// The row group's turn on tile t: the kept keys go to the select, then
// the rows' queues make room for the next tile. A key kept against a
// threshold that has fallen since is merged away by the next compaction,
// as a key equal to the threshold would be: the top-128 stays exact. A
// row's keys come from the 4 lanes of one quad, and no other warp offers
// to the row meanwhile: so the quad appends them at the queue's end, each
// lane at its prefix of the quad's count, and moves the count once, with
// no atomic.
template <class Walk>
__device__ __forceinline__ void offer(Select& sel, const Walk& w, int t,
                                      const float (&d)[32], int rows,
                                      const unsigned (&keep)[2]) {
  const int r0 = a_row();
  const int c0 = a_col();
  const int quad = threadIdx.x & 3;
  const long long col = w.col(t);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (!__any_sync(tile_select::kFull, keep[h] != 0)) continue;
    const int c = __popc(keep[h]);
    int end = c;  // the quad's inclusive prefix of the counts
    int x = __shfl_up_sync(tile_select::kFull, end, 1, 4);
    if (quad >= 1) end += x;
    x = __shfl_up_sync(tile_select::kFull, end, 2, 4);
    if (quad >= 2) end += x;
    const int cnt = r < rows ? sel.cnt[r] : 0;
    __syncwarp();
    if (quad == 3 && r < rows) sel.cnt[r] = cnt + end;
    int p = r * CAP + cnt + end - c;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (keep[h] >> i & 1u) {
        sel.key[p] = d[4 * (i / 2) + 2 * h + i % 2];
        sel.slot[p] = static_cast<int>(col + c0 + 8 * (i / 2) + i % 2);
        ++p;
      }
    }
  }
  sel.make_room(16 * ((threadIdx.x >> 5) & 3), 16);
}

// The dims a scan multiplies: NKS k-steps of 16 (d <= SEG), or whole SEGs
// (RELOAD, d > SEG), of the real d rounded up; the rest is zero padding.
__host__ __device__ constexpr int scan_dims(int d, int nks, bool reload) {
  return reload ? (d + SEG - 1) / SEG * SEG : 16 * nks;
}

// A consumer thread's part of the scan: its warpgroup g's tiles g, g + 2,
// ... of the walk, its query fragments, and its rows' bias group.
template <bool PEN, bool HILO, int NKS, bool RELOAD, class Walk>
struct Consumer {
  static constexpr int ST = stages(HILO);
  static constexpr int SB = stage_bytes(HILO);
  const Args& a;
  const Walk& w;
  Select& sel;
  unsigned char* ring;
  uint32_t full, empty;
  long long q0;
  int rows, nseg, g, rg, lane;
  uint32_t ah[NKS][4], al[NKS][4];
  int grp = -1;                // the bias group pmin holds
  float pmin[2] = {0.f, 0.f};  // the rows' smallest bias in it

  // Tile t's products into d, issued and committed stage by stage; with
  // RELOAD, whose fragments change per stage, each stage's but the last
  // also completed and its stage released.
  __device__ __forceinline__ void issue(int t, float (&d)[32]) {
    const int ns = RELOAD ? nseg : 1;
    for (int seg = 0; seg < ns; ++seg) {
      const int u = t * ns + seg;
      const int slot = u % ST;
      if (seg > 0) {
        wgmma_wait_all();
        fence_operands(d);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((u - 1) % ST));
      }
      if constexpr (RELOAD) load_a<NKS>(a, q0, rows, seg * SEG, ah, al);
      mbar_wait(full + 8 * slot, (u / ST) & 1);
      fence_operands(d);
      wgmma_fence();
      products<HILO, NKS>(smem_u32(ring + slot * SB), seg == 0, ah, al, d);
      wgmma_commit();
    }
  }

  // Tile t, its products complete in d: its n2 read and its stage
  // released, its keys in d and keep.
  __device__ __forceinline__ void prepare(int t, float (&d)[32], unsigned (&keep)[2]) {
    fence_operands(d);
    const int slot = ((t + 1) * (RELOAD ? nseg : 1) - 1) % ST;
    const float* n2s = reinterpret_cast<const float*>(ring + ST * SB + slot * BN * 4);
    const int nval = w.valid(t);
    float n2v[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = a_col() + 8 * j;
      const float2 nn = *reinterpret_cast<const float2*>(n2s + c);
      n2v[2 * j] = c < nval ? nn.x : CUDART_INF_F;
      n2v[2 * j + 1] = c + 1 < nval ? nn.y : CUDART_INF_F;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);
    keys<PEN>(a, w, t, n2v, sel, d, q0, rows, grp, pmin, keep);
  }

  // The row group's turn on tile t, after tile t - 1's (the other
  // warpgroup's): its keys offered.
  __device__ __forceinline__ void turn(int t, const float (&d)[32],
                                       const unsigned (&keep)[2]) {
    if (t > 0) asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg + 4 * (1 - g)) : "memory");
    offer(sel, w, t, d, rows, keep);
    if (t + 1 < w.ntiles) {
      asm volatile("bar.arrive %0, 64;\n" ::"r"(1 + rg + 4 * g) : "memory");
    }
  }
};

// The block's scan: `rows` queries from row q0 over the walk's tiles, the
// top-128 of each written to row q0 + r of a.okey / a.oslot (and a.ofloor).
// Walk: ntiles, col(t), valid(t) and, with PEN, group(t). The products
// cover d_eff = scan_dims(d, NKS, RELOAD) dims: NKS k-steps held in
// registers for the whole scan, or with RELOAD (NKS = KSTEPS) every SEG
// dims of a tile reloaded per stage. Every thread of the block enters;
// `sel` is initialised and the block synchronised after `full`'s barriers
// were initialised.
template <bool PEN, bool HILO, int NKS, bool RELOAD, class Walk>
__device__ void scan(const Args& a, const Maps& maps, const Walk& w,
                     long long q0, int rows, int d_eff, unsigned char* ring,
                     Select& sel, uint32_t full) {
  static_assert(NKS >= 1 && NKS <= KSTEPS && (!RELOAD || NKS == KSTEPS), "k-steps");
  constexpr int ST = stages(HILO);
  constexpr int SB = stage_bytes(HILO);
  const uint32_t empty = full + 8 * ST;
  const int nseg = RELOAD ? d_eff / SEG : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp >= CONSUMERS / 32) {  // the producer: tile by tile, in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS / 32 && lane == 0) {
      unsigned char* n2ring = ring + ST * SB;
      const int n = w.ntiles * nseg;
      for (int u = 0; u < n; ++u) {
        const int slot = u % ST;
        if (u >= ST) mbar_wait(empty + 8 * slot, (u / ST - 1) & 1);
        const int t = u / nseg, seg = u % nseg;
        const int col = static_cast<int>(w.col(t));
        const int k0 = seg * SEG;
        const int boxes = d_eff - k0 > KC ? 2 : 1;
        const bool last = seg == nseg - 1;
        const uint32_t bar = full + 8 * slot;
        const uint32_t stage = smem_u32(ring + slot * SB);
        mbar_expect(bar, boxes * kBox * (HILO ? 2 : 1) + (last ? BN * 4 : 0));
        for (int b = 0; b < boxes; ++b) {
          tma_2d(stage + b * kBox, &maps.hi, col, k0 + b * KC, bar);
          if constexpr (HILO) {
            tma_2d(stage + kPlane + b * kBox, &maps.lo, col, k0 + b * KC, bar);
          }
        }
        if (last) tma_2d(smem_u32(n2ring + slot * BN * 4), &maps.n2, col, 0, bar);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int g = warp >> 2;  // the warpgroup
  const int rg = warp & 3;  // the row group
  Consumer<PEN, HILO, NKS, RELOAD, Walk> c{a, w, sel, ring, full, empty, q0, rows,
                                           nseg, g, rg, lane};
  if constexpr (!RELOAD) load_a<NKS>(a, q0, rows, 0, c.ah, c.al);
  float d[32] = {};
  unsigned keep[2];
  for (int t = g; t < w.ntiles; t += 2) {
    c.issue(t, d);
    wgmma_wait_all();
    c.prepare(t, d, keep);
    c.turn(t, d, keep);
  }
  // every row's last offer is in: each warp writes 8 of its group's rows
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_ALL), "n"(CONSUMERS) : "memory");
  for (int i = 0; i < 8; ++i) {
    const int r = 16 * rg + 8 * g + i;
    if (r >= rows) break;
    float k[4];
    int s[4];
    sel.result(r, k, s);
    const long long o = (q0 + r) * K;
    tile_select::write_row(k, s, a.okey + o, a.oslot + o,
                           a.ofloor ? a.ofloor + o : nullptr);
  }
}

}  // namespace recon_wgmma
