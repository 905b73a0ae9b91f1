// f = K(x, z) @ a on Hopper (sm_90a) for the six DSEKL kernels whose
// tile is a function of the cross term x.z (rbf, linear, polynomial,
// sigmoid, matern32, matern52), D <= 64: the cross term on the TF32 tensor
// cores through wgmma, split three ways so that it keeps float32's
// function.
//
// Replaces the TPU kernel src/repro/kernels/dsekl/block.py:252
// (kernel_matvec_pallas, tiles TILE_FNS at :186) on those kinds and
// widths; the Laplacian (an L1 sum, no product) and D > 64 go to the
// fp32-core kernel of dsekl_matvec.cu (the wrapper, block.py, picks the
// route by shape: select_matvec_route).  With its operands swapped the
// same library also computes g = K(x, z)^T @ v (kernel_vecmat_cuda), as
// the fp32 kernel does.  K is never written to memory.
//
// Bound on this card: operations.  At the serving shape (I = 1024 queries,
// J = 282,624 padded support rows, D = 54) the function's products are
// 2 I J D = 3.13e10 at the dense TF32 peak of 494.5 TFLOP/s (0.063 ms),
// and the rest (row norms 2 D (I + J), about 8 an (i, j) for the
// epilogue) 2.35e9 at the fp32 67 TFLOP/s (0.035 ms): 0.098 ms, against
// 62 MB of traffic (0.019 ms).  The split's three products are not
// counted: they are the price of the precision, not the function's work.
//
// Precision.  One TF32 product keeps 11 significant bits of each operand:
// at covertype-like data (|x|^2 ~ 16.6, gamma 1) it errs ~8e-3 on the
// squared distance, far outside the float32 tolerance (rtol 2e-4, atol
// 1e-5 x max(1, |oracle|_inf)).  So each operand is split once,
// hi = tf32_rna(v) and lo = tf32_rna(v - hi) (round to nearest, ties away,
// as cvt.rna.tf32.f32; v - hi is exact), and the cross term is
// x_lo z_hi + x_hi z_lo + x_hi z_hi: each product exact in the tensor
// core, the dropped x_lo z_lo and lo's rounding ~2^-21 relative.  The two
// small products are issued before the large one, so that they are summed
// while the accumulator is still small.  tests/test_torch_matvec_route.py
// emulates these numerics on the CPU against the JAX oracle, and shows
// one TF32 product failing it.
//
// Design.
//  * One block of 384 threads per (128 query rows, range of support
//    tiles): warpgroups 0 and 1 are consumers of 64 query rows each,
//    warpgroup 2 the producer; setmaxnreg moves registers from the
//    producer (56) to the consumers (224).  One block an SM.
//  * A consumer loads its query rows once, straight from device memory,
//    splits them in registers and keeps them as the A fragments of
//    wgmma m64n128k8 (A from registers: only the support tile is read from
//    shared memory, 4 KB a k-step, half the traffic of A and B both from
//    shared memory).
//  * The producer streams 128-row support tiles.  A tile is one
//    contiguous run of 128 D floats, so one thread copies it, and its runs
//    of a_j and |z_j|^2, with three 1-D cp.async.bulk (TMA without a tensor
//    map; a 2-D map cannot take a 216-byte row stride) into a raw ring,
//    rounded out to the 16-byte chunks that hold each run: any
//    4-byte-aligned input and any J, the offset of the first float kept.
//    The ring holds as many slots as fit beside the stages at this D (3 at
//    D = 54, up to 4), so that copies stay in flight while a tile is split.
//    (Copied 4 bytes a lane with cp.async, the same tile took more of the
//    kernel's time than the products and the fold.)
//    The 128 threads then split the landed tile, hi = tf32_rna(v) and lo,
//    into a ring of 2 hi/lo stages in the 128-byte-swizzled K-major layout
//    that wgmma reads (each lane one feature column of 32 rows:
//    conflict-free reads and writes), zero past J and past D, write the
//    (a, |z|^2) float4 of each column pair into a ring of 4 slots (the
//    fold reads a slot after its stage is released), and publish the
//    stage (fence.proxy.async, then the full mbarrier).  No packed copy of
//    the support set is made outside the call.
//  * The fold is not small next to the products (about 10 instructions
//    an (i, j)), so each consumer keeps two accumulators: it issues the
//    products of tile t + 1 before it folds tile t, and the tensor cores
//    run them meanwhile.  The fold applies the tile function to the f32
//    accumulator with the row norms (rbf: exp2f of the distance
//    pre-scaled by -gamma log2(e); every other kind: dsekl_tile.cuh's
//    tile_value), multiplies by a_j and adds into two per-row partials in
//    registers kept across the whole support range; a ragged last tile
//    is masked.
//  * The support tiles are split over gridDim.y (block.split_support) to
//    fill one wave; blockIdx.x is fastest, so the 8 query tiles of a
//    1024-query batch read one support range together and their re-reads
//    hit L2.  Each block writes its (split, row) partials once and
//    sum_partials adds them in a fixed order: no float atomics, so a
//    result is bit-stable from run to run.
//  * The number of k-steps (8 features each) is a template parameter,
//    4, 7 or 8 (D <= 32, 56, 64): a k-step past D reads zeros.
//  * Row norms come from dsekl_tile.cuh's row_norms pass, as in the fp32
//    kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dsekl_tile.cuh"

namespace {
namespace sm90 {

constexpr int BM = 128;                    // query rows a block
constexpr int BN = 128;                    // support rows a tile
constexpr int STAGES = 2;                  // split (hi/lo) tiles in flight
constexpr int MAX_RAW = 4;                 // raw tiles in flight, at most
constexpr int AZ_SLOTS = 4;                // (a, |z|^2) tiles in flight
constexpr int CONSUMERS = 2;               // warpgroups of 64 query rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;         // 128 x 56 + 256 x 224 = 384 x 168
constexpr int MAX_D = 64;
constexpr int ROW_BYTES = 128;             // one swizzled row: 32 floats
constexpr int PANEL_BYTES = BN * ROW_BYTES;
constexpr int HALF_BYTES = (MAX_D / 32) * PANEL_BYTES;   // hi or lo of a tile
constexpr int STAGE_BYTES = 2 * HALF_BYTES;
constexpr int AZ_BYTES = BN / 2 * 16;      // a float4 a column pair
// A run of BN floats (a_j or |z_j|^2) rounded out to 16-byte chunks.
constexpr int VEC_RUN_BYTES = 640;
constexpr int Z_OFF = 0;
constexpr int AZ_OFF = Z_OFF + STAGES * STAGE_BYTES;
// mbarriers: per stage full (producer threads) and empty (consumers), per
// raw slot landed (the bulk copies' bytes).
constexpr int BAR_OFF = AZ_OFF + AZ_SLOTS * AZ_BYTES;
constexpr int RAW_OFF = BAR_OFF + 128;
constexpr int SMEM_ALLOC = 232448;         // the most a block may have
// The raw ring: as many slots as fit at this D (raw_slot_bytes), up to
// MAX_RAW, after 1024 bytes kept to align the base.
constexpr int RAW_REGION = SMEM_ALLOC - 1024 - RAW_OFF;
static_assert(8 * (2 * STAGES + MAX_RAW) <= 128, "barriers overflow");
constexpr int BAR_PRODUCER = 1;            // named barrier: the producer WG
constexpr float LOG2E = 1.4426950408889634f;

// Errors beside cudaError_t's values.
constexpr int ERR_KIND = 10001;            // no sm90 kernel for this kind
constexpr int ERR_WIDTH = 10002;           // D outside 1..MAX_D
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 168 * THREADS,
              "setmaxnreg budget exceeds the launch's registers");

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
// as cvt.rna.tf32.f32 rounds (which compiles to four instructions): half
// of the 13 dropped bits' range added to the magnitude's bits, then
// cleared.  Finite values and infinities round as cvt.rna does; a NaN
// whose payload lies in the low 13 bits becomes an infinity.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// A wgmma shared-memory descriptor for a 128-byte swizzled K-major
// operand: start address, leading offset 16 (unused by this layout),
// stride 1024 bytes (8 rows), layout 1.  The empty asm hides the base from
// the compiler, which would otherwise hoist the descriptors of every stage
// out of the tile loop and spill them.
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
// Pin the accumulator's accesses to this point: reads stay below the
// wait, writes above the wgmma fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, f32) {+}= A (64 x 8, tf32, registers) * B (128 x 8, tf32,
// shared memory, K-major).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// Named barrier ``id`` over ``threads`` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The 16-byte chunks that hold the floats [begin, end) of v: the first
// chunk's address and the bytes.  A chunk never straddles a page, so the
// bytes read around the run are mapped.
struct Run {
  const float* src;
  uint32_t bytes;
};
__device__ __forceinline__ Run chunk_run(const float* v, size_t begin,
                                         size_t end) {
  const uint64_t b = reinterpret_cast<uint64_t>(v + begin);
  const uint64_t e = reinterpret_cast<uint64_t>(v + end);
  const uint64_t b16 = b & ~uint64_t{15};
  return {reinterpret_cast<const float*>(b16),
          static_cast<uint32_t>(((e + 15) & ~uint64_t{15}) - b16)};
}

// The offset, in floats, of v within its 16-byte chunk.
__device__ __forceinline__ int chunk_off(const float* v) {
  return static_cast<int>((reinterpret_cast<uint64_t>(v) & 15) / 4);
}

// Bytes of a raw slot at width D: the tile's BN rows of D floats and its
// runs of a_j and |z_j|^2, each rounded out to 16-byte chunks and padded to
// 128 bytes.
__host__ __device__ constexpr int raw_slot_bytes(int D) {
  return (BN * D * 4 + 32 + 127) / 128 * 128 + 2 * VEC_RUN_BYTES;
}

// Tile ``g0``'s support rows [g0, g0 + BN) of z (J rows of D floats), and
// their a_j and (with_norms) |z_j|^2, by one thread: three bulk copies into
// the raw slot at ``slot``, landing on ``bar``.
__device__ __forceinline__ void copy_tile(uint32_t slot, uint32_t bar,
                                          const float* __restrict__ z,
                                          const float* __restrict__ a,
                                          const float* __restrict__ zn,
                                          bool with_norms, int g0, int J,
                                          int D) {
  const int g1 = min(g0 + BN, J);
  const Run rz = chunk_run(z, static_cast<size_t>(g0) * D,
                           static_cast<size_t>(g1) * D);
  const Run ra = chunk_run(a, g0, g1);
  const Run rn = chunk_run(zn, g0, g1);
  const uint32_t vec = slot + raw_slot_bytes(D) - 2 * VEC_RUN_BYTES;
  mbar_expect_tx(bar, rz.bytes + ra.bytes + (with_norms ? rn.bytes : 0));
  bulk_copy(slot, rz.src, rz.bytes, bar);
  bulk_copy(vec, ra.src, ra.bytes, bar);
  if (with_norms) bulk_copy(vec + VEC_RUN_BYTES, rn.src, rn.bytes, bar);
}

// The landed a_j and |z_j|^2 runs of a raw slot (``vec``: a's run, then
// |z|^2's) as the float4s (a_j, a_j+1, |z_j|^2, |z_j+1|^2) of the tile's
// column pairs into the slot at ``az``: one column pair a producer
// thread, zero past ``cols`` (and |z|^2 zero without norms).
__device__ __forceinline__ void scatter_az(float4* az, const float* vec,
                                           int off_a, int off_n,
                                           bool with_norms, int cols, int q) {
  if (q < BN / 2) {
    const float* va = vec + off_a;
    const float* vn = vec + VEC_RUN_BYTES / 4 + off_n;
    const bool c0 = 2 * q < cols, c1 = 2 * q + 1 < cols;
    az[q] = make_float4(c0 ? va[2 * q] : 0.0f, c1 ? va[2 * q + 1] : 0.0f,
                        with_norms && c0 ? vn[2 * q] : 0.0f,
                        with_norms && c1 ? vn[2 * q + 1] : 0.0f);
  }
}

// Split rows pw, pw + 4, ... of a landed raw tile (``src``: this lane's
// float of row pw; rows 4 D floats apart) into a panel of the stage (``dst``
// and ``dst + HALF_BYTES``: this lane's word of row pw), hi = tf32_rna(v),
// lo = tf32_rna(v - hi), zero where ``kval`` is false or the row is past
// ``rows``.  Row pw + 4 i's word is 512 i bytes on, its 16-byte chunk
// XORed with (i & 1) * 4 (``flip``).  Eight rows are loaded before any is
// stored: the compiler cannot tell the raw slot from the stage, and would
// otherwise wait out each load's latency in turn.
template <bool RAGGED>
__device__ __forceinline__ void split_panel(uint8_t* dst, const float* src,
                                            int stride, bool kval, int rows,
                                            int pw, int flip) {
  constexpr int BATCH = 8;
#pragma unroll 1
  for (int i0 = 0; i0 < BN / 4; i0 += BATCH) {
    float v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      v[b] = src[stride * b];
      if (!kval || (RAGGED && pw + 4 * (i0 + b) >= rows)) v[b] = 0.0f;
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const uint32_t hb = tf32_rna(v[b]);
      float* h = reinterpret_cast<float*>(
          dst + b * 4 * ROW_BYTES + ((b & 1) ? flip : 0));
      *h = __uint_as_float(hb);
      h[HALF_BYTES / 4] =
          __uint_as_float(tf32_rna(v[b] - __uint_as_float(hb)));
    }
    src += stride * BATCH;
    dst += BATCH * 4 * ROW_BYTES;
  }
}

// Split a landed raw tile (``raw``: its floats from ``off``, rows of D)
// into the stage at ``tile``: lane ``lane`` of warp ``pw`` takes feature
// k = 32 p + lane of rows pw, pw + 4, ... in panel p.  Row r's feature k
// sits at r * 128 + ((k / 4) ^ (r & 7)) * 16 + (k % 4) * 4 of a panel, and
// r & 7 is pw or pw + 4.  A lane past D reads a float of its own row (in
// the slot) and writes zeros.
template <int PANELS>
__device__ __forceinline__ void split_tile(uint8_t* tile, const float* raw,
                                           int off, int rows, int D, int pw,
                                           int lane) {
#pragma unroll
  for (int p = 0; p < PANELS; ++p) {
    const int k = 32 * p + lane;
    const bool kval = k < D;
    const float* src = raw + off + pw * D + (kval ? k : 0);
    const uint32_t chunk = ((lane >> 2) ^ pw) & 7;
    uint8_t* dst = tile + p * PANEL_BYTES + pw * ROW_BYTES + (lane & 3) * 4 +
                   (chunk << 4);
    const int flip = static_cast<int>((chunk ^ 4) << 4) -
                     static_cast<int>(chunk << 4);
    if (rows == BN)
      split_panel<false>(dst, src, 4 * D, kval, rows, pw, flip);
    else
      split_panel<true>(dst, src, 4 * D, kval, rows, pw, flip);
  }
}

// The descriptor offset (16-byte units) of k-step kk of 8 features: 32
// bytes within a 128-byte panel, four to a panel.
__device__ __forceinline__ uint64_t kstep(int kk) {
  return static_cast<uint64_t>((kk / 4) * PANEL_BYTES + (kk % 4) * 32) >>
         4;
}

// Part PART of acc (64 x 128) = x_lo z_hi + x_hi z_lo + x_hi z_hi over KS
// k-steps (part 0 the first, and so on: the small products first);
// ``tile`` is a stage's shared address (z_hi, then z_lo).
template <int PART, int KS>
__device__ __forceinline__ void issue_products(float (&acc)[64],
                                               const uint32_t (&xh)[KS][4],
                                               const uint32_t (&xl)[KS][4],
                                               uint32_t tile) {
  const uint64_t desc = opaque_desc(tile + (PART == 1 ? HALF_BYTES : 0));
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (PART == 0)
      wgmma_tf32(acc, xl[kk], desc + kstep(kk), kk > 0);
    else
      wgmma_tf32(acc, xh[kk], desc + kstep(kk), 1);
  }
}

// k(x_i, z_j) from the accumulated cross term and the row norms.
template <int KIND>
__device__ __forceinline__ float k_value(float acc, float xn, float zn,
                                         const Params& p, float rbf_scale) {
  if constexpr (KIND == RBF) {
    const float d2 = fmaxf(xn + zn - 2.0f * acc, 0.0f);
    return exp2f(rbf_scale * d2);
  } else {
    return tile_value<KIND>(acc, xn, zn, p);
  }
}

// rowacc[j] += sum over the tile's columns of k(x_row_j, z_col) * a_col
// (accumulator register 4 i + 2 j + c: row 8 j of this thread's pair,
// column 8 i + 2 (lane % 4) + c; column pair 4 i + lane % 4 in ``az``).
// Column groups i in [I0, I1) of the tile's 16; MASK: only columns below
// ncols add.
template <int KIND, bool MASK, int I0 = 0, int I1 = BN / 8>
__device__ __forceinline__ void fold_tile(const float (&acc)[64],
                                          const float4* az,
                                          const float (&xn)[2],
                                          float (&rowacc)[2], const Params& p,
                                          float rbf_scale, int lane,
                                          int ncols) {
  const int lim = ncols - 2 * (lane & 3);
#pragma unroll
  for (int i = I0; i < I1; ++i) {
    const float4 v = az[4 * i + (lane & 3)];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float aj = c ? v.y : v.x;
      const float znj = c ? v.w : v.z;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float kv =
            k_value<KIND>(acc[4 * i + 2 * j + c], xn[j], znj, p, rbf_scale);
        if (MASK) kv = 8 * i + c < lim ? kv : 0.0f;
        rowacc[j] = fmaf(kv, aj, rowacc[j]);
      }
    }
  }
}

// Wait for tile ``it``'s stage and open a wgmma pipeline stage on
// ``acc``; returns the stage's shared address.  The caller issues the
// products, commits, and retires them with wgmma_wait<0> and
// ``retire_products``.
__device__ __forceinline__ uint32_t open_tile(float (&acc)[64], int it,
                                              uint32_t base,
                                              uint32_t bar_full) {
  const int s = it % STAGES;
  mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
  fence_regs(acc);
  wgmma_fence();
  return base + Z_OFF + s * STAGE_BYTES;
}

// After wgmma_wait<0>: tile ``it``'s products are in ``acc``; its stage is
// released.
__device__ __forceinline__ void retire_products(float (&acc)[64], int it,
                                                uint32_t bar_empty) {
  fence_regs(acc);
  mbar_arrive(bar_empty + 8 * (it % STAGES));
}

// partials[split, row] = sum over this block's support range of
// k(x_row, z_j) * a_j.
template <int KIND, int KS>
__global__ void __launch_bounds__(THREADS, 1)
    matvec_sm90(const float* __restrict__ x, const float* __restrict__ z,
                const float* __restrict__ a, const float* __restrict__ xnorm,
                const float* __restrict__ znorm, float* __restrict__ partials,
                int I, int J, int D, int tiles_per_split, Params p) {
  constexpr int PANELS = (8 * KS + 31) / 32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_raw = bar_empty + 8 * STAGES;

  const int row0 = blockIdx.x * BM;
  const int n_all = (J + BN - 1) / BN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int n_tiles =
      max(0, min(t_begin + tiles_per_split, n_all) - t_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 128);
      mbar_init(bar_empty + 8 * s, CONSUMERS * 128);
    }
    for (int r = 0; r < MAX_RAW; ++r) mbar_init(bar_raw + 8 * r, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == CONSUMERS) {
    // The producer: raw tiles n_raw ahead by bulk copy, split into the
    // stages as the consumers release them.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(PRODUCER_REGS) : "memory");
    const int ptid = threadIdx.x % 128;
    const int pw = ptid / 32;
    const bool with_norms = euclidean(KIND);
    const int slot_bytes = raw_slot_bytes(D);
    const int n_raw = min(MAX_RAW, RAW_REGION / slot_bytes);
    auto copy = [&](int it) {
      const int r = it % n_raw;
      copy_tile(base + RAW_OFF + r * slot_bytes, bar_raw + 8 * r, z, a,
                znorm, with_norms, (t_begin + it) * BN, J, D);
    };
    if (ptid == 0)
      for (int it = 0; it < min(n_raw, n_tiles); ++it) copy(it);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const int r = it % n_raw;
      const int g0 = (t_begin + it) * BN;
      const float* slot =
          reinterpret_cast<const float*>(smem + RAW_OFF + r * slot_bytes);
      mbar_wait(bar_raw + 8 * r, (it / n_raw) & 1);
      mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
      split_tile<PANELS>(smem + Z_OFF + s * STAGE_BYTES, slot,
                         chunk_off(z + static_cast<size_t>(g0) * D),
                         min(BN, J - g0), D, pw, lane);
      scatter_az(reinterpret_cast<float4*>(smem + AZ_OFF +
                                           (it % AZ_SLOTS) * AZ_BYTES),
                 slot + (slot_bytes - 2 * VEC_RUN_BYTES) / 4,
                 chunk_off(a + g0), chunk_off(znorm + g0), with_norms,
                 min(BN, J - g0), ptid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(bar_full + 8 * s);
      named_sync(BAR_PRODUCER, 128);        // every thread has read slot r
      if (ptid == 0 && it + n_raw < n_tiles) copy(it + n_raw);
    }
  } else {
    // A consumer: query rows [row0 + 64 wg, + 64), two a thread (ra, rb).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(CONSUMER_REGS) : "memory");
    const int warp = (threadIdx.x % 128) / 32;
    const int ra = row0 + 64 * wg + 16 * warp + lane / 4;
    const int rb = ra + 8;
    // A fragments (k-step kk, register e): row e & 1 ? rb : ra, feature
    // 8 kk + lane % 4 + 4 (e >> 1).
    uint32_t xh[KS][4], xl[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e & 1) ? rb : ra;
        const int k = 8 * kk + lane % 4 + 4 * (e >> 1);
        const float v = (r < I && k < D) ? x[static_cast<size_t>(r) * D + k]
                                         : 0.0f;
        xh[kk][e] = tf32_rna(v);
        xl[kk][e] = tf32_rna(v - __uint_as_float(xh[kk][e]));
      }
    const float xn[2] = {
        (euclidean(KIND) && ra < I) ? xnorm[ra] : 0.0f,
        (euclidean(KIND) && rb < I) ? xnorm[rb] : 0.0f};
    const float rbf_scale = -p.gamma * LOG2E;
    float rowacc[2] = {0.0f, 0.0f};
    float acc0[64], acc1[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc0[e] = acc1[e] = 0.0f;

    // Tile it + 1's products run while tile it is folded; every commit
    // group is retired in the step that issues it.  Only a block's last
    // tile can be ragged.
    auto az_slot = [&](int it) {
      return reinterpret_cast<const float4*>(smem + AZ_OFF +
                                             (it % AZ_SLOTS) * AZ_BYTES);
    };
    auto fold_last = [&](const float (&acc)[64], int it) {
      const int ncols = min(BN, J - (t_begin + it) * BN);
      if (ncols == BN)
        fold_tile<KIND, false>(acc, az_slot(it), xn, rowacc, p, rbf_scale,
                               lane, BN);
      else
        fold_tile<KIND, true>(acc, az_slot(it), xn, rowacc, p, rbf_scale,
                              lane, ncols);
    };
    // Tile it is in cur: issue tile it + 1's three products into nxt, each
    // followed by a third of tile it's fold (a warp that issued all 21
    // wgmmas at once would wait on them before it could fold), then
    // retire tile it + 1.
    auto step = [&](float (&cur)[64], float (&nxt)[64], int it) {
      const float4* az = az_slot(it);
      const uint32_t tile = open_tile(nxt, it + 1, base, bar_full);
      issue_products<0, KS>(nxt, xh, xl, tile);
      fold_tile<KIND, false, 0, 6>(cur, az, xn, rowacc, p, rbf_scale, lane,
                                   BN);
      wgmma_fence();
      issue_products<1, KS>(nxt, xh, xl, tile);
      fold_tile<KIND, false, 6, 11>(cur, az, xn, rowacc, p, rbf_scale, lane,
                                    BN);
      wgmma_fence();
      issue_products<2, KS>(nxt, xh, xl, tile);
      wgmma_commit();
      fold_tile<KIND, false, 11, 16>(cur, az, xn, rowacc, p, rbf_scale,
                                     lane, BN);
      wgmma_wait<0>();
      retire_products(nxt, it + 1, bar_empty);
    };
    if (n_tiles > 0) {
      const uint32_t tile = open_tile(acc0, 0, base, bar_full);
      issue_products<0, KS>(acc0, xh, xl, tile);
      issue_products<1, KS>(acc0, xh, xl, tile);
      issue_products<2, KS>(acc0, xh, xl, tile);
      wgmma_commit();
      wgmma_wait<0>();
      retire_products(acc0, 0, bar_empty);
      int it = 0;
      for (; it + 2 < n_tiles; it += 2) {
        step(acc0, acc1, it);
        step(acc1, acc0, it + 1);
      }
      if (it + 1 < n_tiles) {
        step(acc0, acc1, it);
        fold_last(acc1, it + 1);
      } else {
        fold_last(acc0, it);
      }
    }

    // The four lanes of a row pair hold its columns: sum them in a fixed
    // order.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      rowacc[j] += __shfl_xor_sync(0xffffffffu, rowacc[j], 1);
      rowacc[j] += __shfl_xor_sync(0xffffffffu, rowacc[j], 2);
    }
    if (lane % 4 == 0) {
      float* out = partials + static_cast<size_t>(blockIdx.y) * I;
      if (ra < I) out[ra] = rowacc[0];
      if (rb < I) out[rb] = rowacc[1];
    }
  }
}

// k-steps of 8 features for width D: 4, 7 or 8.
int ksteps(int D) { return D <= 32 ? 4 : D <= 56 ? 7 : 8; }

// Calls f(kernel) with the kernel for (kind, D) and returns its result;
// ERR_KIND for the Laplacian (no product) or an unknown kind.
template <typename F>
int with_kernel(int kind, int D, F&& f) {
  int err = ERR_KIND;
  with_kind(kind, [&](auto k) {
    constexpr int K = decltype(k)::value;
    if constexpr (K != LAPLACIAN) {
      switch (ksteps(D)) {
        case 4: err = f(matvec_sm90<K, 4>); break;
        case 7: err = f(matvec_sm90<K, 7>); break;
        default: err = f(matvec_sm90<K, 8>); break;
      }
    }
  });
  return err;
}

}  // namespace sm90
}  // namespace

extern "C" {

// f = K(x, z) @ a on the tensor cores.  All pointers are device pointers to
// contiguous float32: x (I, D), z (J, D), a (J,), out (I,), scratch
// (n_split * I + I + J).  kind is one of the six cross-term kinds, 1 <= D
// <= 64; the support tiles are split into n_split contiguous ranges of
// tiles_per_split 128-row tiles.  Launches on `stream`, does not
// synchronise, allocates nothing.  Returns 0 when launched, a cudaError_t,
// one of the ERR_* codes, or -1 for a bad argument.
int dsekl_matvec_sm90(const float* x, const float* z, const float* a,
                      float* out, float* scratch, int I, int J, int D,
                      int kind, float gamma, float coef0, float degree,
                      int int_degree, int degree_i, float length_scale,
                      int n_split, int tiles_per_split, void* stream) {
  if (I <= 0 || J < 0 || n_split <= 0 || tiles_per_split < 0 ||
      static_cast<long long>(n_split) * tiles_per_split * sm90::BN <
          static_cast<long long>(J))
    return -1;
  if (D < 1 || D > sm90::MAX_D) return sm90::ERR_WIDTH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{gamma, coef0, degree, length_scale, int_degree, degree_i};
  float* partials = scratch;
  float* xn = scratch + static_cast<size_t>(n_split) * I;
  float* zn = xn + I;
  if (kind == LAPLACIAN || kind < 0 || kind > MATERN52)
    return sm90::ERR_KIND;
  if (euclidean(kind)) {
    launch_row_norms(x, I, D, xn, s);
    if (J > 0) launch_row_norms(z, J, D, zn, s);
  }
  const dim3 grid((I + sm90::BM - 1) / sm90::BM, n_split);
  const int err = sm90::with_kernel(kind, D, [&](auto kernel) -> int {
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::SMEM_ALLOC);
    if (set != cudaSuccess) return set;
    kernel<<<grid, sm90::THREADS, sm90::SMEM_ALLOC, s>>>(
        x, z, a, xn, zn, partials, I, J, D, tiles_per_split, p);
    return 0;
  });
  if (err != 0) return err;
  sum_partials<<<(I + 255) / 256, 256, 0, s>>>(partials, n_split, I, out);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the (kind, D) kernel that fit on one SM at once (1: its shared
// memory), so the caller can size the grid to one wave; -1 on a bad kind
// or width or a CUDA error.
int dsekl_matvec_sm90_blocks_per_sm(int kind, int D) {
  if (D < 1 || D > sm90::MAX_D) return -1;
  int n = -1;
  const int err = sm90::with_kernel(kind, D, [&](auto kernel) -> int {
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::SMEM_ALLOC);
    if (set != cudaSuccess) return set;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, sm90::THREADS, sm90::SMEM_ALLOC);
  });
  return err == 0 ? n : -1;
}

// The widest D this kernel takes.
int dsekl_matvec_sm90_max_d() { return sm90::MAX_D; }

const char* dsekl_matvec_sm90_error_string(int code) {
  switch (code) {
    case sm90::ERR_KIND:
      return "no sm90 kernel for this kind (the Laplacian has no product)";
    case sm90::ERR_WIDTH:
      return "D is outside 1..64";
    default:
      return error_string(code);
  }
}

}  // extern "C"
