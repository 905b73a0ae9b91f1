// f = K(x, z) @ a on Hopper (sm_90a) for the six DSEKL kernels whose
// tile is a function of the cross term x.z (rbf, linear, polynomial,
// sigmoid, matern32, matern52) at D > 64: the cross term on the TF32
// tensor cores through wgmma, split three ways so that it keeps float32's
// function, in a loop over D.
//
// Replaces the TPU kernel src/repro/kernels/dsekl/block.py:252
// (kernel_matvec_pallas, tiles TILE_FNS at :186) on those kinds at D > 64,
// where the route was the fp32-core kernel of dsekl_matvec.cu (the
// wrapper, block.py, picks the route by shape: select_matvec_route).  D <=
// 64 stays with dsekl_matvec_sm90.cu, whose query rows live in registers
// for the whole call, and the Laplacian (an L1 sum, no product) with
// dsekl_matvec.cu.  With its operands swapped the same library computes
// g = K(x, z)^T @ v (kernel_vecmat_cuda), as the other two do.  K is never
// written to memory.
//
// Bound on this card: operations.  At MNIST's serving launch (I = 1,024
// queries, J = 32,768 padded support rows, D = 784) the function's
// products are 2 I J D = 5.26e10, 0.106 ms at the dense TF32 peak of 494.5
// TFLOP/s; the row norms and the epilogue (~8 an (i, j)) add 0.005 ms at
// the fp32 peak, against 106 MB of traffic (0.032 ms).  The split's three
// products make 0.319 ms of tensor-core time: that is the floor this
// design aims at, and the fp32 route's SIMT products, 0.79 ms at the fp32
// peak, the ceiling it has to beat.  At lm-readout's decision (2,048,
// 2,048, D 1,536) the products are 1.29e10 (0.026 ms; 0.078 with the
// split).
//
// Precision.  As in dsekl_matvec_sm90.cu: each operand is split once, hi
// = tf32_rna(v), lo = tf32_rna(v - hi) (round to nearest, ties away), and
// each 32-feature slab's x_lo z_hi, then x_hi z_lo, then x_hi z_hi go to a
// fresh f32 accumulator, added into the tile's f32 total once a slab.  The
// tensor cores' own sums, chained over a whole D loop into one
// accumulator, read MNIST's answer gap at up to 1.0e-05 against its limit
// of 1.3e-05.  One TF32 product misses the float32 tolerance
// (tests/test_torch_matvec_route.py emulates both on the CPU, slab by
// slab, against the JAX oracle).
//
// Design.  The accumulator tile is transposed: support rows are wgmma's M
// (A, from registers) and query rows its N (B, from shared memory).
//  * A pre-pass (split_queries) splits the query rows into hi and lo,
//    zero-padded to 128-row tiles and 32-feature slabs, each slab already
//    in the 128-byte-swizzled K-major layout that wgmma reads, in the
//    call's scratch.  It splits at most CHUNK_TILES query tiles (16,384
//    rows) at a time, and the launcher runs the pre-pass, the kernel and
//    sum_partials once a chunk, reusing the copy, so the copy is bounded
//    whatever I: 2 x 16,384 x 32 ceil(D / 32) floats, 100 MiB at D 784
//    and 192 MiB at D 1,536 (6.6 MB at MNIST's launch, one chunk).  The
//    vecmat swaps the operands, so there the support set is split, one
//    chunk at a time.  A chunk of 128 tiles is one wave at one block an
//    SM on a 132-SM card, so a call of many tiles (KPCA's vecmat, 512)
//    takes as many waves as one launch would.  Every row's partials come
//    from the same block in the same order, chunked or not.
//  * One block of 384 threads per (128 query rows, range of 128-row
//    support tiles): warpgroups 0 and 1 are consumers of 64 support rows
//    each, warpgroup 2 the producer; setmaxnreg moves registers from the
//    producer (40) to the consumers (232).  One block an SM.
//  * The producer's one thread streams the query tile's slabs, hi and lo
//    (32 KB), by one bulk copy each (TMA without a tensor map) into a ring
//    of 6 stages, once for every support tile: a D-long query tile does
//    not fit on chip, and the slabs are read from L2.
//  * A consumer loads its support rows' 16 floats of the next slab
//    straight from device memory into registers (any D, any alignment;
//    masked past J and D), splits them there and keeps them as the A
//    fragments of wgmma m64n128k8: the support set is read once per query
//    tile and split in registers, with no shared-memory traffic and no
//    producer work.  Slab s + 1's rows load (and slab s + 2's are
//    prefetched into L1) while slab s's twelve wgmmas run into the slab's
//    accumulator; the two consumers' products
//    interleave on the tensor cores, so each waits out its own slab
//    (wait_group 0), adds it into the total and splits the loaded rows
//    into its one fragment set.  Two accumulators of 64 registers, one
//    fragment set and the loading rows fit the consumer's 232 (a second
//    fragment set spilled ~33 registers).  A slab past D's last k-step
//    issues only the k-steps it has.
//  * Once a support tile's slabs are done, the fold applies the tile
//    function to the f32 total with the row norms (rbf:
//    exp2f of the distance pre-scaled by -gamma log2(e); every other kind:
//    dsekl_tile.cuh's tile_value), multiplies by a_j (zero past J), sums
//    each query column over the thread's two rows, then over the warp's
//    eight row pairs by a reduce-scatter across the lanes (three xor
//    steps, 28 shuffles a tile instead of 96, a fixed order), and adds
//    each lane's four columns into the warp's own row of column partials
//    in shared memory.  The tensor cores wait while both consumers fold.
//  * The support tiles are split over gridDim.y (block.split_support) to
//    fill one wave; blockIdx.x is fastest, so a batch's query tiles read
//    one support range together and their re-reads hit L2.  Each block
//    adds its eight warps' partials in a fixed order and writes its
//    (split, query) partials once; sum_partials adds them in a fixed
//    order: no float atomics, so a result is bit-stable from run to run.
//  * Row norms come from dsekl_tile.cuh's row_norms pass, as in the other
//    two routes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dsekl_tile.cuh"

namespace {
namespace wide {

constexpr int BQ = 128;                    // query rows a block: wgmma's N
constexpr int BS = 128;                    // support rows a tile: 2 x M 64
constexpr int SLAB = 32;                   // features a slab: 128 bytes
constexpr int KSTEPS = SLAB / 8;           // wgmma k-steps a slab
constexpr int STAGES = 6;                  // query slabs in flight
constexpr int CHUNK_TILES = 128;           // query tiles split a launch
constexpr int CONSUMERS = 2;               // warpgroups of 64 support rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;         // 128 x 40 + 256 x 232 = 384 x 168
constexpr int SLAB_FLOATS = BQ * SLAB;     // hi (or lo) of one query slab
constexpr int ACC = BQ / 2;                // accumulator registers a thread
constexpr int HALF_BYTES = SLAB_FLOATS * 4;
constexpr int STAGE_BYTES = 2 * HALF_BYTES;           // hi, then lo
constexpr int SLOTS = CONSUMERS * 4;       // column partials: one row a warp
constexpr int COL_OFF = STAGES * STAGE_BYTES;
constexpr int XN_OFF = COL_OFF + SLOTS * BQ * 4;
// mbarriers: per stage full (the producer's bulk copy) and empty (every
// consumer thread).
constexpr int BAR_OFF = XN_OFF + BQ * 4;
constexpr int SMEM_ALLOC = BAR_OFF + 2 * STAGES * 8 + 1024;   // + alignment
constexpr int BAR_CONSUMERS = 1;           // named barrier: both consumers
constexpr float LOG2E = 1.4426950408889634f;
static_assert(SMEM_ALLOC <= 232448, "over a block's shared memory");
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 168 * THREADS,
              "setmaxnreg budget exceeds the launch's registers");

// Errors beside cudaError_t's values.
constexpr int ERR_KIND = 10001;            // no sm90_wide kernel for this kind

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// ``bytes`` (a multiple of 16) from 16-byte-aligned global ``src`` to
// shared ``dst``, completing on ``bar`` (TMA, no tensor map).
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// v rounded to TF32 (10 mantissa bits), to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds: half of the 13 dropped bits' range added to
// the magnitude's bits, then cleared.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// A wgmma shared-memory descriptor for a 128-byte swizzled K-major
// operand: start address, leading offset 16 (unused by this layout),
// stride 1024 bytes (8 rows), layout 1.  The empty asm hides the base from
// the compiler, which would otherwise hoist the descriptors of every stage
// out of the loop and spill them.
__device__ __forceinline__ uint64_t opaque_desc(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Pin the registers' accesses to this point: reads stay below a wait,
// writes above the wgmma fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The A fragments of one slab: [hi, lo][k-step][register].
using Frags = uint32_t[2][KSTEPS][4];

__device__ __forceinline__ void fence_frags(Frags& b) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(b[h][kk][e])::"memory");
}

// D (64 x 128, f32) = [D +] A (64 x 8, tf32, registers) * B (128 x 8, tf32,
// shared memory, K-major); ACCUMULATE false: D is overwritten, and its old
// values are dead to the compiler (it need not keep them across the code
// before the slab's first product).
template <bool ACCUMULATE>
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
#define DSEKL_WGMMA_N128(C)                                               \
  asm volatile(                                                          \
      "{\n.reg .pred p;\n"                                               \
      "setp.ne.b32 p, %69, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                         \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                         \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                         \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                         \
      "%56, %57, %58, %59, %60, %61, %62, %63"                           \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"                      \
      : C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]),   \
        C(d[7]), C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]),         \
        C(d[13]), C(d[14]), C(d[15]), C(d[16]), C(d[17]), C(d[18]),      \
        C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), C(d[24]),      \
        C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]),      \
        C(d[31]), C(d[32]), C(d[33]), C(d[34]), C(d[35]), C(d[36]),      \
        C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]), C(d[42]),      \
        C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]),      \
        C(d[49]), C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]),      \
        C(d[55]), C(d[56]), C(d[57]), C(d[58]), C(d[59]), C(d[60]),      \
        C(d[61]), C(d[62]), C(d[63])                                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),           \
        "r"(int{ACCUMULATE}))
  if constexpr (ACCUMULATE) {
    DSEKL_WGMMA_N128("+f");
  } else {
    DSEKL_WGMMA_N128("=f");
  }
#undef DSEKL_WGMMA_N128
}

// Named barrier ``id`` over ``threads`` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

int n_slabs(int D) { return (D + SLAB - 1) / SLAB; }

// Floats of the split query rows of one chunk: (query tiles, at most
// CHUNK_TILES, x slabs) slabs of hi and lo.
long long split_floats(int I, int D) {
  const int tiles = (I + BQ - 1) / BQ;
  return static_cast<long long>(tiles < CHUNK_TILES ? tiles : CHUNK_TILES) *
         n_slabs(D) * 2 * SLAB_FLOATS;
}

// xs[((qt * n_slabs + s) * 2 + h) * SLAB_FLOATS ...]: query tile qt's
// slab s, hi (h = 0) or lo (h = 1), zero past I and past D, row r's
// 16-byte chunk c at r * 32 + (c ^ (r & 7)) * 4 floats: wgmma's 128-byte
// swizzle, so that a bulk copy lands it ready.  A thread a (row, chunk).
__global__ void split_queries(const float* __restrict__ x,
                              float* __restrict__ xs, int I, int D,
                              int slabs) {
  const int qt = blockIdx.x, s = blockIdx.y;
  float* hi = xs + (static_cast<size_t>(qt) * slabs + s) * 2 * SLAB_FLOATS;
  float* lo = hi + SLAB_FLOATS;
  for (int e = threadIdx.x; e < BQ * (SLAB / 4); e += blockDim.x) {
    const int row = e / (SLAB / 4), c = e % (SLAB / 4);
    const int i = qt * BQ + row;
    const int k = s * SLAB + 4 * c;
    float h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = (i < I && k + q < D)
                          ? x[static_cast<size_t>(i) * D + k + q]
                          : 0.0f;
      h[q] = __uint_as_float(tf32_rna(v));
      l[q] = __uint_as_float(tf32_rna(v - h[q]));
    }
    const int off = row * SLAB + ((c ^ (row & 7)) * 4);
    *reinterpret_cast<float4*>(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + off) = make_float4(l[0], l[1], l[2], l[3]);
  }
}

// part = x_lo z_hi + x_hi z_lo + x_hi z_hi over NK k-steps of a slab (the
// small products first, the first overwriting part); ``hi`` is the
// stage's shared address (x_hi, then x_lo).
template <int NK>
__device__ __forceinline__ void issue_products(float (&part)[ACC],
                                               const Frags& b, uint32_t hi) {
  const uint64_t dhi = opaque_desc(hi);
  const uint64_t dlo = opaque_desc(hi + HALF_BYTES);
  wgmma_tf32<false>(part, b[0][0], dlo);
#pragma unroll
  for (int kk = 1; kk < NK; ++kk)
    wgmma_tf32<true>(part, b[0][kk], dlo + 2 * kk);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) wgmma_tf32<true>(part, b[1][kk], dhi + 2 * kk);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) wgmma_tf32<true>(part, b[0][kk], dhi + 2 * kk);
}

// Every k-step of the slab, or the NK that reach D (a slab's k-steps past
// D read zeros on both sides).
__device__ __forceinline__ void issue_slab(float (&part)[ACC], const Frags& b,
                                           uint32_t hi, int nk) {
  switch (nk) {
    case 1: issue_products<1>(part, b, hi); break;
    case 2: issue_products<2>(part, b, hi); break;
    case 3: issue_products<3>(part, b, hi); break;
    default: issue_products<KSTEPS>(part, b, hi); break;
  }
}

// This thread's floats of support rows j and j + 8 of slab ``s``, in the
// A fragments' order (register e of k-step kk: row e & 1 ? j + 8 : j,
// feature 32 s + 8 kk + lane % 4 + 4 (e >> 1)), zero past J and D.
using Rows = float[KSTEPS][4];
__device__ __forceinline__ void load_rows(Rows& v,
                                          const float* __restrict__ z, int j,
                                          int s, int lane, int J, int D) {
  const int k = s * SLAB + lane % 4;
  const bool v0 = j < J, v1 = j + 8 < J;
  const float* z0 = z + static_cast<size_t>(v0 ? j : 0) * D + k;
  const float* z1 = z + static_cast<size_t>(v1 ? j + 8 : 0) * D + k;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = 8 * kk + 4 * (e >> 1);
      const bool ok = ((e & 1) ? v1 : v0) && k + off < D;
      v[kk][e] = ok ? ((e & 1) ? z1 : z0)[off] : 0.0f;
    }
}

// Into L1: the 128-byte run of slab ``s`` in support rows j and j + 8
// (lanes 0 and 1 of four: row j's first and last float; 2 and 3: row j +
// 8's), so that its load in the next step waits less.
__device__ __forceinline__ void prefetch_rows(const float* __restrict__ z,
                                              int j, int s, int lane, int J,
                                              int D) {
  const int row = j + ((lane & 2) ? 8 : 0);
  if (row < J) {
    const int k = min(s * SLAB + ((lane & 1) ? SLAB - 1 : 0), D - 1);
    asm volatile("prefetch.global.L1 [%0];" ::"l"(
        z + static_cast<size_t>(row) * D + k));
  }
}

// b[0], b[1] = hi, lo of the loaded floats v.
__device__ __forceinline__ void split_rows(Frags& b, const Rows& v) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t h = tf32_rna(v[kk][e]);
      b[0][kk][e] = h;
      b[1][kk][e] = tf32_rna(v[kk][e] - __uint_as_float(h));
    }
}

// k(x_i, z_j) from the accumulated cross term and the row norms (rbf:
// exp2f of the distance pre-scaled by -gamma log2(e); every other kind:
// dsekl_tile.cuh's tile_value).
template <int KIND>
__device__ __forceinline__ float k_value(float acc, float xn, float zn,
                                         const Params& p, float rbf_scale) {
  if constexpr (KIND == RBF) {
    return exp2f(rbf_scale * fmaxf(xn + zn - 2.0f * acc, 0.0f));
  } else {
    return tile_value<KIND>(acc, xn, zn, p);
  }
}

// Keep the N / 2 entries of v whose bit (N / 2) of the index is the lane's
// ``up``, plus the partner's (lane ^ mask) of the same index: one step of
// a reduce-scatter over the lanes.
template <int N>
__device__ __forceinline__ void halve(const float (&v)[N][2],
                                      float (&w)[N / 2][2], int mask,
                                      bool up) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float keep = up ? v[k + N / 2][c] : v[k][c];
      const float send = up ? v[k][c] : v[k + N / 2][c];
      w[k][c] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
}

// Fold a finished tile into the warp's row ``col`` of column partials.  A
// thread holds support rows j (acc 4 i + c) and j + 8 (acc 4 i + 2 + c) at
// query column 8 i + 2 (lane % 4) + c.  In chunks of eight i: k(x,
// z_j) a_j summed over the two rows (zero past J), then a reduce-scatter
// over the eight lanes of one lane % 4 (xor 16, 8, 4; a fixed order) that
// leaves lane g = lane / 4 the warp's sum at i = 8 chunk + g, added into
// col.
template <int KIND>
__device__ __forceinline__ void fold_tile(const float (&acc)[ACC],
                                          const float* xn, float* col,
                                          const float (&zn)[2],
                                          const float (&aj)[2],
                                          const bool (&ok)[2],
                                          const Params& p, float rbf_scale,
                                          int lane) {
  const int l = lane & 3;
#pragma unroll
  for (int q = 0; q < BQ / 64; ++q) {
    float v[8][2];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = 8 * q + k;
      const float2 xq = *reinterpret_cast<const float2*>(xn + 8 * i + 2 * l);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float xnq = c ? xq.y : xq.x;
        const float k0 =
            k_value<KIND>(acc[4 * i + c], xnq, zn[0], p, rbf_scale);
        const float k1 =
            k_value<KIND>(acc[4 * i + 2 + c], xnq, zn[1], p, rbf_scale);
        const float s = ok[0] ? k0 * aj[0] : 0.0f;
        v[k][c] = ok[1] ? fmaf(k1, aj[1], s) : s;
      }
    }
    float w[4][2], u[2][2], t[1][2];
    halve<8>(v, w, 16, lane & 16);
    halve<4>(w, u, 8, lane & 8);
    halve<2>(u, t, 4, lane & 4);
    float2* out =
        reinterpret_cast<float2*>(col + 8 * (8 * q + lane / 4) + 2 * l);
    float2 sum = *out;
    sum.x += t[0][0];
    sum.y += t[0][1];
    *out = sum;
  }
}

// partials[split, query] = sum over this block's support range of
// k(x_query, z_j) * a_j, for query rows [BQ blockIdx.x, + BQ).
template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
    matvec_sm90_wide(const float* __restrict__ xs,
                     const float* __restrict__ z, const float* __restrict__ a,
                     const float* __restrict__ xnorm,
                     const float* __restrict__ znorm,
                     float* __restrict__ partials, int I, int J, int D,
                     int slabs, int tiles_per_split, Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int q0 = blockIdx.x * BQ;
  const int n_all = (J + BS - 1) / BS;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int n_tiles =
      max(0, min(t_begin + tiles_per_split, n_all) - t_begin);
  const int n_iter = n_tiles * slabs;        // (tile, slab) steps

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == CONSUMERS) {
    // The producer: the query tile's slabs in order, once a support tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      const float* src =
          xs + static_cast<size_t>(blockIdx.x) * slabs * 2 * SLAB_FLOATS;
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, STAGE_BYTES);
        bulk_copy(base + s * STAGE_BYTES,
                  src + static_cast<size_t>(it % slabs) * 2 * SLAB_FLOATS,
                  STAGE_BYTES, bar_full + 8 * s);
      }
    }
  } else {
    // A consumer: support rows j and j + 8 of each tile, j = 64 wg + 16
    // warp + lane / 4.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(CONSUMER_REGS) : "memory");
    const int warp = threadIdx.x / 32;        // 0..7: this warp's row of col
    const int r = 64 * wg + 16 * (warp % 4) + lane / 4;
    float* const col = reinterpret_cast<float*>(smem + COL_OFF);
    float* const xn = reinterpret_cast<float*>(smem + XN_OFF);
    for (int e = threadIdx.x; e < SLOTS * BQ; e += CONSUMERS * 128)
      col[e] = 0.0f;
    for (int e = threadIdx.x; e < BQ; e += CONSUMERS * 128)
      xn[e] = (euclidean(KIND) && q0 + e < I) ? xnorm[q0 + e] : 0.0f;
    named_sync(BAR_CONSUMERS, CONSUMERS * 128);

    const float rbf_scale = -p.gamma * LOG2E;
    float total[ACC], part[ACC];
    Frags frag;                    // the slab's split A fragments
    Rows next;                     // the next slab's rows, loading
    float zn[2] = {0.0f, 0.0f}, aj[2] = {0.0f, 0.0f};
    bool ok[2] = {false, false};
    auto row_of = [&](int it) { return (t_begin + it / slabs) * BS + r; };

    // Step ``it``: slab it % slabs of tile it / slabs, whose split A
    // fragments are in frag.  Its products go to part, a fresh
    // accumulator, while step it + 1's rows load (prefetched a step
    // earlier) and step it + 2's are prefetched; then part is added into
    // the tile's total in float32 (the tensor cores' own sums of a long D
    // loop into one accumulator err several times more), the stage is
    // released, a tile's last slab folds the tile, and the next rows are
    // split into frag.
    auto step = [&](int it) {
      const int s = it % slabs;
      const int stage = it % STAGES;
      if (s == 0) {
        const int j = row_of(it);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ok[h] = j + 8 * h < J;
          aj[h] = ok[h] ? a[j + 8 * h] : 0.0f;
          zn[h] = (euclidean(KIND) && ok[h]) ? znorm[j + 8 * h] : 0.0f;
        }
      }
      mbar_wait(bar_full + 8 * stage, (it / STAGES) & 1);
      fence_frags(frag);
      wgmma_fence();
      issue_slab(part, frag, base + stage * STAGE_BYTES,
                 min(KSTEPS, (D - s * SLAB + 7) / 8));
      wgmma_commit();
      if (it + 1 < n_iter)
        load_rows(next, z, row_of(it + 1), (it + 1) % slabs, lane, J, D);
      if (it + 2 < n_iter)
        prefetch_rows(z, row_of(it + 2), (it + 2) % slabs, lane, J, D);
      wgmma_wait<0>();
      fence_regs(part);
      fence_frags(frag);
      mbar_arrive(bar_empty + 8 * stage);
      if (s == 0) {
#pragma unroll
        for (int e = 0; e < ACC; ++e) total[e] = part[e];
      } else {
#pragma unroll
        for (int e = 0; e < ACC; ++e) total[e] += part[e];
      }
      if (s == slabs - 1)
        fold_tile<KIND>(total, xn, col + warp * BQ, zn, aj, ok, p, rbf_scale,
                        lane);
      if (it + 1 < n_iter) split_rows(frag, next);
    };
    if (n_iter > 0) {
      load_rows(next, z, row_of(0), 0, lane, J, D);
      split_rows(frag, next);
    }
    for (int it = 0; it < n_iter; ++it) step(it);

    // Each query's column partials, its eight warps' in a fixed order.
    named_sync(BAR_CONSUMERS, CONSUMERS * 128);
    for (int c = threadIdx.x; c < BQ; c += CONSUMERS * 128) {
      if (q0 + c < I) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < SLOTS; ++w) sum += col[w * BQ + c];
        partials[static_cast<size_t>(blockIdx.y) * I + q0 + c] = sum;
      }
    }
  }
}

// Calls f(kernel) with the kernel for ``kind`` and returns its result;
// ERR_KIND for the Laplacian (no product) or an unknown kind.
template <typename F>
int with_kernel(int kind, F&& f) {
  int err = ERR_KIND;
  with_kind(kind, [&](auto k) {
    constexpr int K = decltype(k)::value;
    if constexpr (K != LAPLACIAN) err = f(matvec_sm90_wide<K>);
  });
  return err;
}

}  // namespace wide
}  // namespace

extern "C" {

// Floats of the scratch that dsekl_matvec_sm90_wide takes: the split query
// rows of one chunk, then n_split * I partials, I + J row norms.
long long dsekl_matvec_sm90_wide_scratch_floats(int I, int J, int D,
                                                int n_split) {
  if (I < 0 || J < 0 || D < 1 || n_split < 1) return -1;
  return wide::split_floats(I, D) + static_cast<long long>(n_split) * I + I +
         J;
}

// f = K(x, z) @ a on the tensor cores.  All pointers are device pointers to
// contiguous float32: x (I, D), z (J, D), a (J,), out (I,), scratch (16-byte
// aligned, dsekl_matvec_sm90_wide_scratch_floats(I, J, D, n_split)).  kind
// is one of the six cross-term kinds, D >= 1; the support tiles are split
// into n_split contiguous ranges of tiles_per_split 128-row tiles.
// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// 0 when launched, a cudaError_t, ERR_KIND, or -1 for a bad argument.
int dsekl_matvec_sm90_wide(const float* x, const float* z, const float* a,
                           float* out, float* scratch, int I, int J, int D,
                           int kind, float gamma, float coef0, float degree,
                           int int_degree, int degree_i, float length_scale,
                           int n_split, int tiles_per_split, void* stream) {
  if (I <= 0 || J < 0 || D < 1 || n_split <= 0 || tiles_per_split < 0 ||
      n_split > 65535 ||
      static_cast<long long>(n_split) * tiles_per_split * wide::BS <
          static_cast<long long>(J) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return -1;
  if (kind == LAPLACIAN || kind < 0 || kind > MATERN52) return wide::ERR_KIND;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{gamma, coef0, degree, length_scale, int_degree, degree_i};
  const int slabs = wide::n_slabs(D);
  float* xs = scratch;
  float* partials = scratch + wide::split_floats(I, D);
  float* xn = partials + static_cast<size_t>(n_split) * I;
  float* zn = xn + I;
  if (euclidean(kind)) {
    launch_row_norms(x, I, D, xn, s);
    if (J > 0) launch_row_norms(z, J, D, zn, s);
  }
  // One chunk of query rows [r0, r0 + rows) a pass, in stream order, so
  // the next pass's split waits for this one's kernel; its partials are
  // (n_split, rows) from n_split * r0 on.
  constexpr int CHUNK_ROWS = wide::CHUNK_TILES * wide::BQ;
  return wide::with_kernel(kind, [&](auto kernel) -> int {
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wide::SMEM_ALLOC);
    if (set != cudaSuccess) return set;
    for (int r0 = 0; r0 < I; r0 += CHUNK_ROWS) {
      const int rows = I - r0 < CHUNK_ROWS ? I - r0 : CHUNK_ROWS;
      const int q_tiles = (rows + wide::BQ - 1) / wide::BQ;
      float* part = partials + static_cast<size_t>(n_split) * r0;
      wide::split_queries<<<dim3(q_tiles, slabs), 256, 0, s>>>(
          x + static_cast<size_t>(r0) * D, xs, rows, D, slabs);
      kernel<<<dim3(q_tiles, n_split), wide::THREADS, wide::SMEM_ALLOC, s>>>(
          xs, z, a, xn + r0, zn, part, rows, J, D, slabs, tiles_per_split, p);
      sum_partials<<<(rows + 255) / 256, 256, 0, s>>>(part, n_split, rows,
                                                       out + r0);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// Blocks of the ``kind`` kernel that fit on one SM at once (1: its shared
// memory), so the caller can size the grid to one wave; -1 on a bad kind
// or a CUDA error.  One kernel serves every width.
int dsekl_matvec_sm90_wide_blocks_per_sm(int kind) {
  int n = -1;
  const int err = wide::with_kernel(kind, [&](auto kernel) -> int {
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wide::SMEM_ALLOC);
    if (set != cudaSuccess) return set;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, wide::THREADS, wide::SMEM_ALLOC);
  });
  return err == 0 ? n : -1;
}

const char* dsekl_matvec_sm90_wide_error_string(int code) {
  switch (code) {
    case wide::ERR_KIND:
      return "no sm90_wide kernel for this kind (the Laplacian has no "
             "product)";
    default:
      return error_string(code);
  }
}

}  // extern "C"
