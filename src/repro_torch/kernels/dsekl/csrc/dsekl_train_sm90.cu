// The fused training-step op of DSEKL, float32, on Hopper (sm_90a), in
// ONE launch that reads its rows by index:
//
//   f = f_scale * K(x[idx_i], x[idx_j]) @ alpha[idx_j];
//   v = loss_grad(f, y[idx_i]) (or v given);
//   g = K^T @ v (+ lam * alpha[idx_j]),
//
// with every K value evaluated ONCE and kept on chip.  Replaces two TPU
// kernels of src/repro/kernels/dsekl/block.py: train_pass_pallas (:432,
// the Alg.-1 step of every fit) and dual_pass_pallas (:330, v given,
// loss = NONE), for |J| <= MAX_J_WIDE (4,096); wider blocks take
// dsekl_train.cu (the wrapper, block.py, picks the route by shape:
// select_train_route).  Two kernels: train_sm90 for J <= MAX_J (1,024, K
// in registers: Algorithm 1's step) and train_sm90_wide past it (K in
// shared memory: Algorithm 2's step over the 4,096-column J union of four
// workers).  With null index pointers the rows are contiguous: x (I, D),
// z (J, D), a (J,), vy (I,), as the fp32 route takes them.
//
// Bound on this card.  At the main path's step (I = J = 1024, D = 54,
// RBF) the work is 2*I*J*D = 1.13e8 operations for the cross term, ~8 per
// (i, j) for the epilogue and 2 per (i, j) for g: ~1.24e8, or 1.85 us at
// the H100 SXM's 67 TFLOP/s fp32.  The function's own bytes (the gathered
// rows, a, y, f, g, the indices) are ~0.47 MB, 0.14 us at 3.35 TB/s.  So
// operations bound it; the fp32 route (dsekl_train.cu) spends ~26 us in
// six launches, an L2 round trip of its 4 MB K stash and the caller's
// gathers before it.  At Algorithm 2's step (J = 4,096) the work is four
// times that, ~5e8 operations or 7.4 us; the fp32 route took 52 us there.
//
// Design, and why.  The TPU kernel stashes the K row-block in VMEM on a
// sequential (ni, 2, nj) grid: sweep j for f, take v, replay the stash for
// g.  On the card the dependency f -> v -> g needs the complete f row
// before any g, and an 80-row K row-block at J = 1024 (320 KB) is over one
// block's shared memory.  Hopper's thread-block clusters carry it inside
// one launch:
//  * One cluster an 80-row block of I; its C <= 8 CTAs (8 is the portable
//    cluster size) split J into slices of two 64-column tiles: J <= 1,024.
//    80 rows, not 64: a CTA of 320 threads and 168 registers fills an SM,
//    and an H100 holds 15 clusters of 8 such CTAs at once
//    (dsekl_train_sm90_active_clusters), so the main shape's 13 row
//    blocks (104 CTAs) run in one wave, where 16 row blocks of 64 would
//    need two.
//  * A CTA loads its own 80 x rows and 128 z rows by index (a null index
//    means contiguous rows), with y (or v) and a, and stages them through
//    shared memory in 32-feature slices, transposed as dsekl_tile.cuh's
//    accumulate_tile does; the next slice's loads are in flight (in
//    registers) while the current one is multiplied.  A row of 54 floats
//    is only 8-byte aligned every other row, so the loads are 4-byte ones,
//    coalesced along the row.  An index outside [0, n) traps.
//  * Row norms are summed from the staged slices (fmaf in feature order,
//    as the cross term is: a row paired with itself gets d2 = 0 exactly),
//    so no row-norm launch precedes the kernel.
//  * The cross term runs on the fp32 cores, 4 x 4 micro-tiles a thread
//    (32 values); the epilogue (tile_value) turns it into K in the same
//    registers, masked to 0 past I and J, and K stays there.
//  * f: each CTA reduces its row partials of K @ a (a fixed shuffle tree)
//    into shared memory; after cluster.sync() every CTA reads the C
//    partials through distributed shared memory in rank order, so all of
//    them hold the same f and v for the 80 rows.  Rank 0 writes f.
//  * g: each CTA forms its columns' partial of K^T v from the K it still
//    holds (row groups summed in a fixed order through shared memory).
//    With one row block the partial is g.  Otherwise it goes to
//    g_parts[row block, j]; then the CTA's thread 0 bumps an integer
//    arrival counter for its column slice (an acquire-release atomic, as
//    CUTLASS's semaphores do), and the CTA that arrives last sums the
//    partials in row-block order into g and resets the counter to 0 for
//    the next launch.  The counters are the wrapper's, zeroed once at
//    allocation.  y and a are read in section 1 but first used in
//    section 3, so their loads are off the path to the products.
// No float atomics: every sum is taken in a fixed order, and a result is
// bit-stable from run to run.
//
// The wide variant (train_sm90_wide, 1,024 < J <= 4,096: Algorithm 2's
// step).  The same cluster of 8 CTAs an 80-row block; a CTA takes 128 * P
// columns, P = ceil(J / 1,024) pairs of 64-column tiles (up to 512
// columns; a ragged J leaves the last CTAs' slices short or empty,
// masked).  It computes one pair at a time, as above, and writes the
// pair's K values to dynamic shared memory, each thread's values in a
// layout of its own (value e of thread t at [e][t]: conflict-free) --
// 80 x 512 floats, 160 KB, beside the staged slices (56 KB, which g's
// partials reuse) and ~9 KB of static arrays, under the 227 KB a block
// may have.  f and v go through DSMEM after cluster.sync() as above; then
// each thread reads its K values back and forms g as the narrow kernel
// does from registers.  It differs from the narrow kernel where the card
// showed it losing time (dsekl/ablate.py):
//  * 640 threads, each half one tile of the pair, a thread 16 values: the
//    epilogue and the products are latency-bound, and twice the warps
//    hide it (smem, not registers, now limits a CTA to one an SM);
//  * slices of 64 features copied by cp.async (no staging registers), x's
//    kept for every pair when D <= 64;
//  * the z norms summed in the product loop by one warp a half, in the
//    cross term's order (a serial loop per slice stalled the barrier);
//  * the tile function evaluated unmasked, then selected (a mask around
//    it compiled to branches, and the values did not overlap).
// Recomputing K in the g sweep instead of storing it would double the
// cross term (4.5e8 -> 9e8 operations at J = 4,096) and evaluate K
// twice, where the TPU kernel keeps it in its VMEM stash.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dsekl_tile.cuh"

namespace {
namespace tsm90 {

namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 8;                 // the portable cluster size
constexpr int TILES = 2;                       // 64-column tiles a CTA holds
constexpr int W = TILES * BN;                  // columns a CTA: 128
constexpr int MAX_J = MAX_CLUSTER * W;         // 1,024
constexpr int GROUPS = 20;                     // row groups of TM rows
constexpr int ROWS = GROUPS * TM;              // rows of I a cluster: 80
constexpr int NT = GROUPS * TX;                // threads a CTA: 320
constexpr int WARPS = NT / 32;
constexpr int LDX = ROWS + 4;                  // padded x slice row
constexpr int XE = ROWS * BK / NT;             // x values a thread a slice
constexpr int ZE = (W * BK + NT - 1) / NT;     // z values, the last masked
constexpr int MAX_ROW_BLOCKS = 65535;          // gridDim.y
constexpr unsigned FULL = 0xffffffffu;
static_assert(ROWS * BK % NT == 0, "x staging must be exact");
static_assert(W <= NT, "a thread a column in the g pass");
static_assert(LDX % 4 == 0, "float4 reads of the x slice");
static_assert(WARPS * W <= TILES * BK * LDS, "g's partials fit the z slice");
// The wide variant: up to 4 pairs of tiles a CTA, K in shared memory.
constexpr int WIDE_TILES = 8;                  // 64-column tiles a CTA at most
constexpr int PAIRS = WIDE_TILES / TILES;      // pairs computed in turn: 4
constexpr int WIDE_W = WIDE_TILES * BN;        // columns a CTA at most: 512
constexpr int MAX_J_WIDE = MAX_CLUSTER * WIDE_W;   // 4,096
constexpr int WNT = TILES * NT;                // threads a CTA: 640, a tile
                                               // of the pair each half
constexpr int KV = TM * TN;                    // K values a thread a pair: 16
constexpr int BKW = 2 * BK;                    // features a staged slice: 64
constexpr int KS_FLOATS = PAIRS * KV * WNT;    // K: 160 KB
static_assert(WIDE_W <= WNT, "a thread a column in the g pass");
// Dynamic shared memory of the wide variant: K, then the x and z slices,
// whose room the warps' g partials take after the pairs.  With ~9 KB of
// static arrays it stays under the 227 KB (232,448 bytes) a block may
// have.
constexpr int WIDE_SMEM = static_cast<int>(
    sizeof(float) * (KS_FLOATS + BKW * LDX + TILES * BKW * LDS));
static_assert(WARPS * WIDE_W <= BKW * LDX + TILES * BKW * LDS,
              "g's partials fit the staged slices");
static_assert(WIDE_SMEM + 9 * 1024 <= 232448, "the wide variant's smem");
static_assert((KS_FLOATS * 4) % 16 == 0 && (BKW * LDX * 4) % 16 == 0,
              "float4 reads of the staged slices");

struct Args {
  const float* x;            // rows of I: x[idx_i[i]], or x[i] when null
  const long long* idx_i;
  int n_x;                   // rows of x (indices must lie in [0, n_x))
  const float* z;            // rows of J: z[idx_j[j]], or z[j] when null
  const long long* idx_j;
  int n_z;
  const float* a;            // indexed as the rows of J
  const float* vy;           // indexed as the rows of I: y, or v (NONE)
  float* f;                  // (I,)
  float* g;                  // (J,)
  float* g_parts;            // (row blocks, J) when there is more than one
  unsigned* counters;        // MAX_CLUSTER arrival counters, all 0
  int I, J, D;
  Params p;
  int loss;
  float f_scale;
  float lam;
};

// The source row of position `pos` of an index vector of length `len` (pos
// itself when idx is null); -1 past the end.  An index outside [0, n)
// traps: the kernel never reads outside its input.
__device__ __forceinline__ int source_row(const long long* idx, int pos,
                                          int len, int n) {
  if (pos >= len) return -1;
  if (idx == nullptr) return pos;
  const long long s = idx[pos];
  if (s < 0 || s >= n) __trap();
  return static_cast<int>(s);
}

// The split cluster barrier: arrive (release: this CTA's reads of the
// cluster's shared memory are done), later wait (before the CTA exits, so
// that no CTA's shared memory goes while another may still read it).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One arrival at a device-scope counter: thread 0 of a CTA calls it after a
// __syncthreads() that follows the CTA's stores; acquire-release, so the
// CTA that sees the last arrival (and syncs its threads after) reads every
// earlier CTA's stores.  Returns the count before.
__device__ __forceinline__ unsigned arrive_acq_rel(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// g_j from its sum over I: + lam * a_j, rounded as g + lam * a is in torch.
__device__ __forceinline__ float finish_g(float s, float a, float lam) {
  return lam != 0.0f ? __fadd_rn(s, __fmul_rn(lam, a)) : s;
}

template <int KIND>
__global__ void __launch_bounds__(NT) train_sm90(const Args args) {
  __shared__ __align__(16) float xs[BK][LDX];
  __shared__ __align__(16) float zs[TILES][BK][LDS];
  __shared__ int xrow[ROWS];
  __shared__ int zrow[W];
  __shared__ float xn_s[ROWS];
  __shared__ float zn_s[W];
  __shared__ float a_s[W];
  __shared__ float vy_s[ROWS];
  __shared__ float fpart[ROWS];                // read by the whole cluster
  __shared__ float v_s[ROWS];
  __shared__ int last_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;                 // the cluster spans gridDim.x
  const int n_rank = gridDim.x;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * ROWS;
  const int col0 = rank * W;
  const int I = args.I, J = args.J, D = args.D;

  // -- 1. This CTA's rows by index: 80 of I with y (or v), 128 of J with a
  //       (y and a land in registers meanwhile: first read in section 3).
  float vy_r = 0.0f, a_r = 0.0f;
  if (tid < ROWS) {
    const int r = source_row(args.idx_i, row0 + tid, I, args.n_x);
    xrow[tid] = r;
    if (r >= 0) vy_r = args.vy[r];
  }
  if (tid < W) {
    const int r = source_row(args.idx_j, col0 + tid, J, args.n_z);
    zrow[tid] = r;
    if (r >= 0) a_r = args.a[r];
  }
  __syncthreads();

  // -- 2. The cross term (or L1 sum) and the row norms, slice by slice;
  //       the next slice's loads in flight while one is multiplied.
  const float* __restrict__ x = args.x;
  const float* __restrict__ z = args.z;
  float xv[XE], zv[ZE];
  auto load = [&](int k0) {
#pragma unroll
    for (int it = 0; it < XE; ++it) {
      const int e = tid + it * NT;
      const int r = xrow[e / BK];
      const int k = k0 + e % BK;
      xv[it] = (r >= 0 && k < D) ? x[static_cast<size_t>(r) * D + k] : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < ZE; ++it) {
      const int e = tid + it * NT;
      const int r = e < W * BK ? zrow[e / BK] : -1;
      const int k = k0 + e % BK;
      zv[it] = (r >= 0 && k < D) ? z[static_cast<size_t>(r) * D + k] : 0.0f;
    }
  };
  float acc[TILES][TM][TN];
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[t][m][n] = 0.0f;
  float xn = 0.0f, zn = 0.0f;                  // row tid's, column tid's
  load(0);
  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int it = 0; it < XE; ++it) {
      const int e = tid + it * NT;
      xs[e % BK][e / BK] = xv[it];
    }
#pragma unroll
    for (int it = 0; it < ZE; ++it) {
      const int e = tid + it * NT;
      if (e < W * BK) zs[(e / BK) / BN][e % BK][(e / BK) % BN] = zv[it];
    }
    __syncthreads();
    if (k0 + BK < D) load(k0 + BK);
    const int kmax = min(BK, D - k0);
    if constexpr (euclidean(KIND)) {
      if (tid < ROWS)
        for (int c = 0; c < kmax; ++c) xn = fmaf(xs[c][tid], xs[c][tid], xn);
      if (tid < W)
        for (int c = 0; c < kmax; ++c) {
          const float v = zs[tid / BN][c][tid % BN];
          zn = fmaf(v, v, zn);
        }
    }
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 xq = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float xr[TM] = {xq.x, xq.y, xq.z, xq.w};
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        const float4 zq =
            *reinterpret_cast<const float4*>(&zs[t][kk][tx * TN]);
        const float zr[TN] = {zq.x, zq.y, zq.z, zq.w};
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            if constexpr (KIND == LAPLACIAN)
              acc[t][m][n] += fabsf(xr[m] - zr[n]);
            else
              acc[t][m][n] = fmaf(xr[m], zr[n], acc[t][m][n]);
          }
      }
    }
    __syncthreads();
  }
  if (tid < ROWS) {
    xn_s[tid] = xn;
    vy_s[tid] = vy_r;
  }
  if (tid < W) {
    zn_s[tid] = zn;
    a_s[tid] = a_r;
  }
  __syncthreads();

  // -- 3. K in place of the cross term, masked past I and J; the row
  //       partials of K @ a.
  float rowacc[TM];
  {
    float xnr[TM];
    bool rv[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      xnr[m] = xn_s[ty * TM + m];
      rv[m] = xrow[ty * TM + m] >= 0;
      rowacc[m] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int cl = t * BN + tx * TN + n;
        const bool cv = zrow[cl] >= 0;
        const float znj = zn_s[cl];
        const float aj = a_s[cl];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float k = (cv && rv[m])
              ? tile_value<KIND>(acc[t][m][n], xnr[m], znj, args.p) : 0.0f;
          acc[t][m][n] = k;
          rowacc[m] = fmaf(k, aj, rowacc[m]);
        }
      }
  }
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      rowacc[m] += __shfl_xor_sync(FULL, rowacc[m], off);
  if (tx == 0) {
#pragma unroll
    for (int m = 0; m < TM; ++m) fpart[ty * TM + m] = rowacc[m];
  }

  // -- 4. f and v: the cluster's C row partials, read in rank order.
  cluster.sync();
  if (tid < ROWS) {
    float part[MAX_CLUSTER];                   // all C reads in flight
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      part[q] = q < n_rank ? cluster.map_shared_rank(&fpart[0], q)[tid]
                           : 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < n_rank) s += part[q];
    const float fr = args.f_scale * s;
    const bool valid = xrow[tid] >= 0;
    const float v = args.loss == NONE ? vy_s[tid]
                                      : loss_grad(args.loss, fr, vy_s[tid]);
    v_s[tid] = valid ? v : 0.0f;
    if (rank == 0 && valid) args.f[row0 + tid] = fr;
  }
  cluster_arrive();
  __syncthreads();

  // -- 5. This CTA's columns' partial of K^T v over its 80 rows.
  float (*gred)[W] = reinterpret_cast<float (*)[W]>(&zs[0][0][0]);
  {
    const int warp = tid / 32;
    float vr[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) vr[m] = v_s[ty * TM + m];
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        float s = 0.0f;
#pragma unroll
        for (int m = 0; m < TM; ++m) s = fmaf(acc[t][m][n], vr[m], s);
        s += __shfl_xor_sync(FULL, s, 16);     // the warp's two row groups
        if (tid % 32 < 16) gred[warp][t * BN + tx * TN + n] = s;
      }
  }
  __syncthreads();
  const int j = col0 + tid;
  const bool jv = tid < W && j < J;
  float gsum = 0.0f;
  if (tid < W) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) gsum += gred[w][tid];
  }

  // -- 6. g: the row blocks' partials summed in row-block order.
  if (gridDim.y == 1) {
    if (jv) args.g[j] = finish_g(gsum, a_s[tid], args.lam);
  } else {
    if (jv) args.g_parts[static_cast<size_t>(blockIdx.y) * J + j] = gsum;
    __syncthreads();
    if (tid == 0)
      last_s = arrive_acq_rel(&args.counters[rank]) == gridDim.y - 1;
    __syncthreads();
    if (last_s) {
      if (jv) {                                // 8 partials' loads at once
        const int nb = gridDim.y;
        float s = 0.0f;
        for (int b0 = 0; b0 < nb; b0 += 8) {
          float part[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            part[q] = b0 + q < nb
                ? __ldcg(&args.g_parts[static_cast<size_t>(b0 + q) * J + j])
                : 0.0f;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (b0 + q < nb) s += part[q];
        }
        args.g[j] = finish_g(s, a_s[tid], args.lam);
      }
      if (tid == 0) args.counters[rank] = 0;
    }
  }
  // -- 7. End.
  cluster_wait();
}

// A 4-byte asynchronous copy from global to shared memory (cp.async), or
// a 0 stored in its place when !ok (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// g_j of the wide variant from the row blocks' partials g_parts[., j], in
// row-block order, 8 loads in flight.
__device__ __forceinline__ float sum_row_blocks(const float* g_parts, int nb,
                                                int J, int j) {
  float s = 0.0f;
  for (int b0 = 0; b0 < nb; b0 += 8) {
    float part[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      part[q] = b0 + q < nb
          ? __ldcg(&g_parts[static_cast<size_t>(b0 + q) * J + j]) : 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (b0 + q < nb) s += part[q];
  }
  return s;
}

// The wide variant (1,024 < J <= 4,096): as train_sm90, with a CTA's
// `cols` = 128 * pairs columns computed a pair of tiles at a time, by
// twice the threads (640: each half one tile of the pair, so that a
// thread holds 16 values, not 32, and twice the warps hide the latency),
// and their K kept in dynamic shared memory (WIDE_SMEM bytes) for the g
// pass.
template <int KIND>
__global__ void __launch_bounds__(WNT) train_sm90_wide(const Args args) {
  extern __shared__ __align__(16) float dyn[];
  // K value e of thread t for pair p at ks[(p * KV + e) * WNT + t]; then
  // the staged slices, whose room g's warp partials take after the pairs.
  float* const ks = dyn;
  float (*xs)[LDX] = reinterpret_cast<float (*)[LDX]>(dyn + KS_FLOATS);
  float (*zs)[BKW][LDS] =
      reinterpret_cast<float (*)[BKW][LDS]>(dyn + KS_FLOATS + BKW * LDX);
  float (*gred)[WIDE_W] =
      reinterpret_cast<float (*)[WIDE_W]>(dyn + KS_FLOATS);
  __shared__ int xrow[ROWS];
  __shared__ int zrow[WIDE_W];
  __shared__ float xn_s[ROWS];
  __shared__ float zn_s[WIDE_W];
  __shared__ float a_s[WIDE_W];
  __shared__ float vy_s[ROWS];
  __shared__ float fhalf[TILES][ROWS];         // each half's row partials
  __shared__ float fpart[ROWS];                // read by the whole cluster
  __shared__ float v_s[ROWS];
  __shared__ int last_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;                 // gridDim.x == MAX_CLUSTER
  const int tid = threadIdx.x;
  const int half = tid / NT;                   // the tile of the pair
  const int tx = tid % TX;
  const int ty = tid % NT / TX;
  const int row0 = blockIdx.y * ROWS;
  const int I = args.I, J = args.J, D = args.D;
  const int pairs = (J + MAX_CLUSTER * W - 1) / (MAX_CLUSTER * W);
  const int cols = pairs * W;
  const int col0 = rank * cols;

  // -- w1. This CTA's rows by index: 80 of I with y (or v), `cols` of J
  //        with a (y and a in registers until the first slice).
  float vy_r = 0.0f, a_r = 0.0f;
  if (tid < ROWS) {
    const int r = source_row(args.idx_i, row0 + tid, I, args.n_x);
    xrow[tid] = r;
    if (r >= 0) vy_r = args.vy[r];
  }
  if (tid < cols) {
    const int r = source_row(args.idx_j, col0 + tid, J, args.n_z);
    zrow[tid] = r;
    if (r >= 0) a_r = args.a[r];
  }
  __syncthreads();

  // -- w2. Pair by pair: the cross term (or L1 sum) of 128 columns and
  //        the row norms, in slices of 64 features copied asynchronously
  //        (cp.async, no registers held), transposed into xs and zs; the
  //        next pair's copies are issued once its K is formed (issued
  //        before, they slowed K's stores more than they hid).  With
  //        D <= 64 the x slice stays for every pair.
  const int nk = (D + BKW - 1) / BKW;
  auto stage = [&](int p, int k0, bool with_x) {
    if (with_x)
      for (int e = tid; e < ROWS * BKW; e += WNT) {
        const int r = xrow[e / BKW];
        const int k = k0 + e % BKW;
        const bool ok = r >= 0 && k < D;
        cp_async4(&xs[e % BKW][e / BKW],
                  ok ? args.x + static_cast<size_t>(r) * D + k : args.x, ok);
      }
    for (int e = tid; e < W * BKW; e += WNT) {
      const int c = e / BKW;
      const int r = zrow[p * W + c];
      const int k = k0 + e % BKW;
      const bool ok = r >= 0 && k < D;
      cp_async4(&zs[c / BN][e % BKW][c % BN],
                ok ? args.z + static_cast<size_t>(r) * D + k : args.z, ok);
    }
    cp_async_commit();
  };
  float rowacc[TM] = {0.0f, 0.0f, 0.0f, 0.0f};
  float xn = 0.0f;                             // row tid - NT's
  // -- w3. A pair's K in place of its cross term, masked past I and J:
  //        its K @ a folded into the row partials, its values to ks.
  auto pair_k = [&](float (&acc)[TM][TN], int p) {
    float xnr[TM];
    bool rv[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      xnr[m] = xn_s[ty * TM + m];
      rv[m] = xrow[ty * TM + m] >= 0;
    }
    float* const kp = ks + static_cast<size_t>(p) * KV * WNT + tid;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int cl = p * W + half * BN + tx * TN + n;
      const bool cv = zrow[cl] >= 0;
      const float znj = zn_s[cl];
      const float aj = a_s[cl];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        // Evaluated unmasked, then selected: a mask around the call would
        // branch, and the values would not overlap.
        const float kv = tile_value<KIND>(acc[m][n], xnr[m], znj, args.p);
        const float k = cv && rv[m] ? kv : 0.0f;
        rowacc[m] = fmaf(k, aj, rowacc[m]);
        kp[(n * TM + m) * WNT] = k;
      }
    }
  };
  // The z norms ride in the product loop of the first warp of each half
  // (its lanes hold the half's 64 columns; ty 0 keeps them), in the
  // cross term's order: a row paired with itself gets d2 = 0 exactly.
  const bool norm_warp = euclidean(KIND) && tid % NT < 32;
  float acc[TM][TN], zn[TN];
  auto products = [&](auto with_norms, int kmax) {
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 xq = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 zq =
          *reinterpret_cast<const float4*>(&zs[half][kk][tx * TN]);
      const float xr[TM] = {xq.x, xq.y, xq.z, xq.w};
      const float zr[TN] = {zq.x, zq.y, zq.z, zq.w};
      if constexpr (decltype(with_norms)::value)
#pragma unroll
        for (int n = 0; n < TN; ++n) zn[n] = fmaf(zr[n], zr[n], zn[n]);
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          if constexpr (KIND == LAPLACIAN)
            acc[m][n] += fabsf(xr[m] - zr[n]);
          else
            acc[m][n] = fmaf(xr[m], zr[n], acc[m][n]);
        }
    }
  };
  stage(0, 0, true);
#pragma unroll 1
  for (int p = 0; p < pairs; ++p) {
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      zn[n] = 0.0f;
#pragma unroll
      for (int m = 0; m < TM; ++m) acc[m][n] = 0.0f;
    }
    for (int s = 0; s < nk; ++s) {
      const int k0 = s * BKW;
      cp_async_wait_all();
      __syncthreads();                         // the slice is staged
      const int kmax = min(BKW, D - k0);
      // The x norms, once: the first 80 threads of the second half.
      if (euclidean(KIND) && p == 0 && tid >= NT && tid < NT + ROWS)
        for (int c = 0; c < kmax; ++c)
          xn = fmaf(xs[c][tid - NT], xs[c][tid - NT], xn);
      // Seen after the barrier below: y and a (loaded in w1), and the
      // norms after a pair's last slice.
      if (p == 0 && s == 0) {
        if (tid < ROWS) vy_s[tid] = vy_r;
        if (tid < cols) a_s[tid] = a_r;
      }
      if (norm_warp)
        products(std::true_type{}, kmax);
      else
        products(std::false_type{}, kmax);
      if (s == nk - 1) {
        if (norm_warp && ty == 0)
#pragma unroll
          for (int n = 0; n < TN; ++n)
            zn_s[p * W + half * BN + tx * TN + n] = zn[n];
        if (p == 0 && tid >= NT && tid < NT + ROWS) xn_s[tid - NT] = xn;
      }
      __syncthreads();                         // xs and zs are free
      if (s + 1 < nk) stage(p, k0 + BKW, true);
    }
    pair_k(acc, p);
    if (p + 1 < pairs) stage(p + 1, 0, nk > 1);
  }

  // -- w4. f and v: each half's row partials, then the cluster's 8, read
  //        in rank order.
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      rowacc[m] += __shfl_xor_sync(FULL, rowacc[m], off);
  if (tx == 0) {
#pragma unroll
    for (int m = 0; m < TM; ++m) fhalf[half][ty * TM + m] = rowacc[m];
  }
  __syncthreads();
  if (tid < ROWS) fpart[tid] = fhalf[0][tid] + fhalf[1][tid];
  cluster.sync();
  if (tid < ROWS) {
    float part[MAX_CLUSTER];                   // all 8 reads in flight
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      part[q] = cluster.map_shared_rank(&fpart[0], q)[tid];
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) s += part[q];
    const float fr = args.f_scale * s;
    const bool valid = xrow[tid] >= 0;
    const float v = args.loss == NONE ? vy_s[tid]
                                      : loss_grad(args.loss, fr, vy_s[tid]);
    v_s[tid] = valid ? v : 0.0f;
    if (rank == 0 && valid) args.f[row0 + tid] = fr;
  }
  cluster_arrive();
  __syncthreads();

  // -- w5. This CTA's columns' partials of K^T v over its 80 rows, from
  //        the K values each thread stored (row groups as in section 5;
  //        warps w and w + 10 hold the two tiles of a pair).
  {
    const int warp = tid / 32 % WARPS;
    float vr[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) vr[m] = v_s[ty * TM + m];
#pragma unroll 1
    for (int p = 0; p < pairs; ++p) {
      const float* const kp = ks + static_cast<size_t>(p) * KV * WNT + tid;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        float s = 0.0f;
#pragma unroll
        for (int m = 0; m < TM; ++m)
          s = fmaf(kp[(n * TM + m) * WNT], vr[m], s);
        s += __shfl_xor_sync(FULL, s, 16);     // the warp's two row groups
        if (tid % 32 < 16) gred[warp][p * W + half * BN + tx * TN + n] = s;
      }
    }
  }
  __syncthreads();
  const int j = col0 + tid;
  const bool jv = tid < cols && j < J;
  float gsum = 0.0f;
  if (tid < cols) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) gsum += gred[w][tid];
  }

  // -- w6. g: the row blocks' partials summed in row-block order.
  if (gridDim.y == 1) {
    if (jv) args.g[j] = finish_g(gsum, a_s[tid], args.lam);
  } else {
    if (jv) args.g_parts[static_cast<size_t>(blockIdx.y) * J + j] = gsum;
    __syncthreads();
    if (tid == 0)
      last_s = arrive_acq_rel(&args.counters[rank]) == gridDim.y - 1;
    __syncthreads();
    if (last_s) {
      if (jv)
        args.g[j] = finish_g(sum_row_blocks(args.g_parts, gridDim.y, J, j),
                             a_s[tid], args.lam);
      if (tid == 0) args.counters[rank] = 0;
    }
  }
  // -- w7. End.
  cluster_wait();
}

// The launch configuration of a cluster of `c` CTAs of `threads` along x,
// with `smem` bytes of dynamic shared memory a CTA.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  ClusterLaunch(int c, int row_blocks, cudaStream_t s, int smem,
                int threads) {
    cfg.gridDim = dim3(c, row_blocks, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// CTAs of the cluster that covers J columns (the wide variant's: 8), and
// the dynamic shared memory and threads of a CTA.
inline int cluster_for(int J) {
  return J > MAX_J ? MAX_CLUSTER : (J + W - 1) / W;
}
inline int smem_for(int J) { return J > MAX_J ? WIDE_SMEM : 0; }
inline int threads_for(int J) { return J > MAX_J ? WNT : NT; }

// The kernel for (KIND, J) in *fn: train_sm90_wide past MAX_J, after its
// dynamic shared memory is allowed.
template <int KIND>
cudaError_t kernel_for(int J, void (**fn)(Args)) {
  if (J <= MAX_J) {
    *fn = train_sm90<KIND>;
    return cudaSuccess;
  }
  *fn = train_sm90_wide<KIND>;
  return cudaFuncSetAttribute(train_sm90_wide<KIND>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              WIDE_SMEM);
}

}  // namespace tsm90
}  // namespace

extern "C" {

// The widest J one launch takes, and the number of arrival counters the
// caller provides.
int dsekl_train_sm90_max_j() { return tsm90::MAX_J_WIDE; }
int dsekl_train_sm90_counters() { return tsm90::MAX_CLUSTER; }

// Bytes of dynamic shared memory a CTA of the kernel for J takes: 0 for J
// <= 1,024 (train_sm90), WIDE_SMEM past it (train_sm90_wide).
int dsekl_train_sm90_smem_bytes(int J) { return tsm90::smem_for(J); }

// Rows of I a cluster (a row block) covers.
int dsekl_train_sm90_rows() { return tsm90::ROWS; }

// Floats of g_parts scratch for an (I, J) block: 0 for one row block.
long long dsekl_train_sm90_scratch_floats(int I, int J) {
  const long long nb = (static_cast<long long>(I) + tsm90::ROWS - 1) /
                       tsm90::ROWS;
  return nb > 1 ? nb * J : 0;
}

// (f, g) as above.  Device pointers: x (n_x, D) and z (n_z, D) float32
// row-major; idx_i (I,) and idx_j (J,) int64, or null for rows 0.. of x
// and z; a and vy float32, indexed as the rows of J and of I; f (I,), g
// (J,); g_parts (dsekl_train_sm90_scratch_floats(I, J)); counters
// (dsekl_train_sm90_counters() zeros, left zero).  loss -1 (NONE) takes vy
// as v.  Launches on `stream`, does not synchronise, allocates nothing.
// Returns 0 when launched, a cudaError_t, or -1 for a bad argument.
int dsekl_train_sm90(const float* x, const long long* idx_i, int n_x,
                     const float* z, const long long* idx_j, int n_z,
                     const float* a, const float* vy, float* f, float* g,
                     float* g_parts, unsigned* counters, int I, int J, int D,
                     int kind, float gamma, float coef0, float degree,
                     int int_degree, int degree_i, float length_scale,
                     int loss, float f_scale, float lam, void* stream) {
  const int row_blocks = (I + tsm90::ROWS - 1) / tsm90::ROWS;
  if (I <= 0 || J < 1 || J > tsm90::MAX_J_WIDE || D <= 0 || n_x <= 0 ||
      n_z <= 0 || row_blocks > tsm90::MAX_ROW_BLOCKS || loss < NONE ||
      loss > LOGISTIC || counters == nullptr ||
      (row_blocks > 1 && g_parts == nullptr))
    return -1;
  const tsm90::Args args{
      x, idx_i, n_x, z, idx_j, n_z, a, vy, f, g, g_parts, counters, I, J, D,
      Params{gamma, coef0, degree, length_scale, int_degree, degree_i}, loss,
      f_scale, lam};
  const tsm90::ClusterLaunch launch(tsm90::cluster_for(J), row_blocks,
                                    static_cast<cudaStream_t>(stream),
                                    tsm90::smem_for(J),
                                    tsm90::threads_for(J));
  cudaError_t err = cudaSuccess;
  const bool known = with_kind(kind, [&](auto k) {
    void (*fn)(tsm90::Args);
    err = tsm90::kernel_for<decltype(k)::value>(J, &fn);
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&launch.cfg, fn, args);
  });
  if (!known) return -1;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the kernel for (kind, J) that the card holds at once, with
// its dynamic shared memory: the row blocks of one wave.  -1 for a bad
// argument, another negative value for a CUDA error.
int dsekl_train_sm90_active_clusters(int kind, int J) {
  if (J < 1 || J > tsm90::MAX_J_WIDE) return -1;
  const tsm90::ClusterLaunch launch(tsm90::cluster_for(J), 1, nullptr,
                                    tsm90::smem_for(J),
                                    tsm90::threads_for(J));
  int n = -1;
  with_kind(kind, [&](auto k) {
    void (*fn)(tsm90::Args);
    cudaError_t err = tsm90::kernel_for<decltype(k)::value>(J, &fn);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, fn, &launch.cfg);
    if (err != cudaSuccess) n = -static_cast<int>(err);
  });
  return n;
}

const char* dsekl_train_sm90_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
