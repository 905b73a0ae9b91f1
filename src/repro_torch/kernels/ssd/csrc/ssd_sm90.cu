// Mamba-2 SSD chunked scan (forward) on Hopper (sm_90a) for bfloat16
// inputs: TMA-fed, on the bf16 tensor cores through wgmma.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py:74 (ssd_pallas)
// for bf16 x, dt, B, C with head dim 64, a state n that is a multiple of 16
// up to 128 and a chunk that is a multiple of 64 up to 256 (jamba's n 16
// and mamba2-780m's n 128, chunk 256); everything else goes to the fp32-core
// kernel of ssd.cu (the wrapper, kernel.py, picks the route by shape).  Per
// (batch, head) and per chunk of Q positions, with cum = cumsum(dt * a):
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//         + exp(cum_i) C_i . state                                  (inter)
//   state = state exp(cum_last) + sum_j x_j (B_j exp(cum_last - cum_j) dt_j)
// the (hd, n) state carried across the chunks from zero; inputs converted
// to float32 at load, y written in bf16, the final state (B, nh, hd, n) in
// float32.  A last chunk may be partial: its rows past S are zero-filled by
// TMA and its dt past S is 0, so they add nothing.
//
// Layout: the model's, read in place: x (B, S, nh, hd) by a 4-D tensor map
// (hd, nh, S, B) with box (64, 1, Q, 1), 128-byte swizzled; B and C
// (B, S, g, n) by maps (n, g, S, B) with boxes (16, 1, Q, 1), 32-byte
// swizzled (n / 16 panels of Q rows x 32 bytes), head h reading group
// h / (nh / g); dt (B, S, nh) by plain loads (one head's dt is 2 bytes a
// position, under TMA's 16-byte box minimum).
//
// Bound on this card: bytes.  At the served shape (B * nh = 512, S = 2048,
// hd 64, n 16, chunk 256) the function reads and writes 0.27 GB (0.08 ms at
// 3.35 TB/s) and needs ~2.6e10 products (0.03 ms on the bf16 tensor cores,
// 0.39 ms on the fp32 cores that ssd.cu uses); the decay, ~1.7e8 exps and
// their products, runs on the fp32 cores beside them.
//
// Keeping float32's function on bf16 tensor cores.  x, B, C and dt are bf16
// values, and a product of two bf16 values is exact in float32, so x, B and
// C stay the unsplit operand and every float32 factor goes into the other
// one, split into bf16 terms:
//   * S = C B^T: one product (exact);
//   * P = S o exp(cum_i - cum_j) o dt_j, masked j <= i, formed in float32
//     on the accumulator; y += P_hi x + P_mid x + P_lo x, P from registers
//     in three bf16 terms that sum to it exactly (each takes the next 8
//     significant bits);
//   * inter: y = C (state_hi + state_lo)^T (hi = bf16(v), lo = bf16(v -
//     hi): 16 bits), scaled by exp(cum_i) in registers before the intra
//     products add in;
//   * state += x^T (W_hi + W_lo), W = B o w, w_j = exp(cum_last - cum_j)
//     dt_j with cum_last - cum_j taken as a suffix sum (no cancellation).
// A CPU emulation of these roundings (tests/test_torch_ssd_route.py) shows
// each split is needed: one bf16 term for P, W or the state misses the
// bf16 check on y or the float32 check on the final state.  P in two terms
// (16 bits) meets the check but rounds several times as many bf16 outputs
// of y differently from the plain version's float32 (ablate.py prints the
// share for each variant), and on the jamba prefill those flips re-routed
// enough tokens in the random MoE to fail chip_smoke's logits gate; in
// three terms y rounds as the fp32 route's does.
//
// Design:
//   * one block of 128 threads (one warpgroup) per (b, h), two blocks an
//     SM at n <= 64 (up to 255 registers a thread); the chunks of a (b, h)
//     run in order;
//   * shared memory: a ring of chunk stages (x, B and C of Q positions;
//     two stages when two blocks still fit an SM, else one) with a full
//     mbarrier each (TMA bytes); as chunk c starts, thread 0 loads chunk
//     c + stages - 1 into the stage chunk c - 1 has left; one (64 x n) bf16
//     hi/lo tile that holds the state for the inter product and then, 64
//     rows at a time, W for the state update; cum, dt and w of the chunk;
//   * a chunk: the threads scan dt a (warp shuffles, forward and backward,
//     dt loaded one chunk ahead), write the state tile from their state
//     registers, then walk the row blocks of 64 positions: inter (C .
//     state) issued with the first S tile, then for each column block
//     j <= i the S tile of step u issued together with step u - 1's P x
//     (12 wgmma m64n64k16: 4 k-steps x 3 terms, alternating between two
//     accumulators so that no chain of adds waits on itself), P formed
//     while that P x is on the tensor cores (the flash kernel's schedule);
//     only the lower-triangle tiles are visited; below the diagonal one
//     exp serves two rows (form_p); y is stored in bf16 straight from
//     registers;
//   * the state update: the state registers (the (hd, n) accumulator of
//     wgmma m64n16k16, one per 16 columns of n) are decayed, then take
//     x^T W a block of 64 rows at a time, x^T read from the x stage
//     through the transpose bit;
//   * every commit group is retired in the step that issues it, and every
//     wgmma descriptor is formed next to its wgmma from a base the
//     compiler cannot hoist.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;                    // head dim: one 128-byte x row
constexpr int BM = 64;                    // rows of a block (wgmma M)
constexpr int THREADS = 128;              // one warpgroup
constexpr int MAX_CHUNK = 256;
constexpr int X_ROW = 128;                // bytes of an x row
constexpr int P_ROW = 32;                 // bytes of a 16-column panel row
constexpr int BLOCK_PANEL = BM * P_ROW;   // one 64-row panel: 2048 bytes
constexpr int SEGMENTS = 8;               // 32-position scan segments
constexpr int BAR_WG = 1;                 // named barrier of the block
// Two blocks an SM: 228 KB of shared memory, 1 KB reserved a block.
constexpr int SMEM_TWO_BLOCKS = 115712;
constexpr int SMEM_MAX = 232448;

// Errors of the host side, beside cudaError_t's values.
constexpr int ERR_NO_ENCODE = 10001;      // no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 10002;         // a tensor map was refused
constexpr int ERR_SHAPE = 10003;          // hd, n or chunk not taken
constexpr int ERR_SMEM = 10004;           // the plan does not fit

// Shared memory of one block, in bytes from a 1024-aligned base.  A stage
// is the x tile (Q rows of 128 bytes), then n / 16 B panels and n / 16 C
// panels (Q rows of 32 bytes each); every region starts on 2048 bytes, so
// a 32-byte-swizzled panel and the W block written over the tile share one
// swizzle phase.
struct Plan {
  int x_bytes, p_bytes, stage_bytes, tile_off, vec_off, seg_off, bar_off,
      alloc;
};

__host__ __device__ __forceinline__ Plan make_plan(int q, int n, int stages) {
  Plan p;
  p.x_bytes = q * X_ROW;
  p.p_bytes = q * P_ROW;
  p.stage_bytes = p.x_bytes + 2 * (n / 16) * p.p_bytes;
  p.tile_off = stages * p.stage_bytes;
  // The tile: n / 16 hi panels, then n / 16 lo panels, of 64 rows.
  p.vec_off = p.tile_off + 2 * (n / 16) * BLOCK_PANEL;  // cum, dt, w: q floats
  p.seg_off = p.vec_off + 3 * q * 4;
  p.bar_off = p.seg_off + SEGMENTS * 4;               // full: one a stage
  p.alloc = p.bar_off + 8 * stages + 1024;            // room to align
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Named barrier ``id`` (0 is __syncthreads) over ``threads`` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (in 16-byte units), and the swizzle (1: 128 bytes, 3: 32 bytes).
constexpr uint64_t SW128 = 1;
constexpr uint64_t SW32 = 3;

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (swizzle << 62);
}

// A descriptor whose base the compiler cannot see through: hoisted out of
// the loops, the descriptors of every block and stage would spill.  The
// steps add their offsets (in 16-byte units) to it.
__device__ __forceinline__ uint64_t opaque_desc(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo,
                                                uint64_t swizzle) {
  asm volatile("" : "+r"(addr));
  return make_desc(addr, lbo, sbo, swizzle);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of this warpgroup's wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Pin a register array's accesses to this point: accumulator reads stay
// below the wait, and writes of wgmma operands above the wgmma fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int A, int N>
__device__ __forceinline__ void fence_regs(float (&r)[A][N]) {
#pragma unroll
  for (int a = 0; a < A; ++a) fence_regs(r[a]);
}
template <int T, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[T][N][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[t][i][e])::"memory");
}

// wgmma with the shapes this kernel issues (bf16 inputs, f32 accumulators).
// D (64 x 64) {+}= A (64 x 16, smem) * B (64 x 16, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 16) += A (64 x 16, smem, MN-major) * B (16 x 16, smem, MN-major).
__device__ __forceinline__ void wgmma_ss_n16_tt(float (&d)[8], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  union {
    __nv_bfloat162 b;
    uint32_t u;
  } cvt;
  cvt.b = v;
  return cvt.u;
}

// (a, b) as two bf16 pairs: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// (a, b) as three bf16 pairs that sum to (a, b) exactly: hi = v with its
// low 16 bits cleared (a bf16 value), mid likewise of the exact rest v -
// hi, lo = v - hi - mid (at most 8 significant bits, a bf16 value); each
// pair is the high halves of two floats, by one byte permute.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  constexpr uint32_t TOP = 0xFFFF0000u;
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  const float ra = a - __uint_as_float(ua & TOP);
  const float rb = b - __uint_as_float(ub & TOP);
  const uint32_t ura = __float_as_uint(ra), urb = __float_as_uint(rb);
  const float la = ra - __uint_as_float(ura & TOP);
  const float lb = rb - __uint_as_float(urb & TOP);
  hi = __byte_perm(ua, ub, 0x7632);
  mid = __byte_perm(ura, urb, 0x7632);
  lo = __byte_perm(__float_as_uint(la), __float_as_uint(lb), 0x7632);
}

__device__ __forceinline__ float2 bf16x2_float2(uint32_t u) {
  union {
    uint32_t u;
    __nv_bfloat162 b;
  } cvt;
  cvt.u = u;
  return __bfloat1622float2(cvt.b);
}

// The accumulator fragment of wgmma m64nN: register 4 i + 2 j + c holds row
// row0 + 8 j, column 8 i + col0 + c, with row0 = 16 warp + lane / 4 and
// col0 = 2 (lane % 4).

// S (64 x 64) = C_i B_j^T over k = n, n / 16 steps of k16, one 32-byte
// panel each; both K-major.
template <int NP>
__device__ __forceinline__ void issue_s(float (&s)[32], uint32_t c_rows,
                                        uint32_t b_rows, uint32_t p_bytes) {
  const uint64_t dc = opaque_desc(c_rows, 16, 8 * P_ROW, SW32);
  const uint64_t db = opaque_desc(b_rows, 16, 8 * P_ROW, SW32);
#pragma unroll
  for (int kk = 0; kk < NP; ++kk)
    wgmma_ss_n64(s, dc + ((kk * p_bytes) >> 4), db + ((kk * p_bytes) >> 4),
                 kk > 0);
}

// y (64 x 64) = C_i state_hi^T + C_i state_lo^T: the state tile holds n / 16
// hi panels then n / 16 lo panels of 64 rows (hd) x 32 bytes (16 of n).
template <int NP>
__device__ __forceinline__ void issue_inter(float (&y)[32], uint32_t c_rows,
                                            uint32_t tile, uint32_t p_bytes) {
  const uint64_t dc = opaque_desc(c_rows, 16, 8 * P_ROW, SW32);
  const uint64_t ds = opaque_desc(tile, 16, 8 * P_ROW, SW32);
#pragma unroll
  for (int kk = 0; kk < NP; ++kk) {
    const uint64_t a = dc + ((kk * p_bytes) >> 4);
    wgmma_ss_n64(y, a, ds + ((kk * BLOCK_PANEL) >> 4), kk > 0);
    wgmma_ss_n64(y, a, ds + (((NP + kk) * BLOCK_PANEL) >> 4), 1);
  }
}

// y (64 x 64) += P_hi x_j + P_mid x_j + P_lo x_j for the 64 positions j
// of the x rows from x_rows: x is MN-major (hd contiguous); a k16 step is
// 16 rows.  The 12 products alternate between two accumulators, y and y2
// (summed after the row block): one chain of 12 small wgmmas into one
// accumulator waits on each add in turn.
__device__ __forceinline__ void issue_px(float (&y)[32], float (&y2)[32],
                                         const uint32_t (&p)[3][4][4],
                                         uint32_t x_rows) {
  const uint64_t dx = opaque_desc(x_rows, MAX_CHUNK * X_ROW, 8 * X_ROW, SW128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = dx + ((kk * 16 * X_ROW) >> 4);
    if (kk % 2 == 0) {
      wgmma_rs_n64(y, p[2][kk], b);
      wgmma_rs_n64(y2, p[1][kk], b);
      wgmma_rs_n64(y, p[0][kk], b);
    } else {
      wgmma_rs_n64(y2, p[2][kk], b);
      wgmma_rs_n64(y, p[1][kk], b);
      wgmma_rs_n64(y2, p[0][kk], b);
    }
  }
}

// state (hd x n) += x_j^T (W_hi + W_lo) for the 64 positions j of the x rows
// from x_rows and of the W block in the tile: A = x^T (MN-major through the
// transpose bit), B = W (MN-major, n contiguous, one wgmma n16 a panel).
template <int NP>
__device__ __forceinline__ void issue_state(float (&st)[NP][8],
                                            uint32_t x_rows, uint32_t tile) {
  const uint64_t dx = opaque_desc(x_rows, MAX_CHUNK * X_ROW, 8 * X_ROW, SW128);
  const uint64_t dw = opaque_desc(tile, BLOCK_PANEL, 8 * P_ROW, SW32);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t a = dx + ((kk * 16 * X_ROW) >> 4);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      const uint32_t w = np * BLOCK_PANEL + kk * 16 * P_ROW;
      wgmma_ss_n16_tt(st[np], a, dw + (w >> 4));
      wgmma_ss_n16_tt(st[np], a, dw + ((w + NP * BLOCK_PANEL) >> 4));
    }
  }
}

// The decay exp(cum_i - cum_j) of P.
__device__ __forceinline__ float decay_exp(float x) { return expf(x); }

// P = S o exp(cum_i - cum_j) o dt_j on the S accumulator, in place, for the
// 64 columns whose cum and dt start at cum_j and dt_j.  A thread holds rows
// r and r + 8.  Below the diagonal (every j < i) row r + 8's decay is row
// r's times f = exp(cum_{r+8} - cum_r) <= 1: one exp for two entries, and
// no exp there can overflow.  On a diagonal tile each entry takes its own
// exp and the pairs j > i are 0 (a select: their exp may overflow).
template <bool DIAG>
__device__ __forceinline__ void form_p(float (&s)[32], const float (&ci)[2],
                                       float f, const float* cum_j,
                                       const float* dt_j, int row0,
                                       int col0) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 cj = *reinterpret_cast<const float2*>(cum_j + 8 * i + col0);
    const float2 dj = *reinterpret_cast<const float2*>(dt_j + 8 * i + col0);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float cc = c ? cj.y : cj.x;
      const float d = c ? dj.y : dj.x;
      if (DIAG) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v = s[4 * i + 2 * r + c] * (decay_exp(ci[r] - cc) * d);
          s[4 * i + 2 * r + c] = 8 * i + col0 + c <= row0 + 8 * r ? v : 0.f;
        }
      } else {
        const float w = decay_exp(ci[0] - cc) * d;
        s[4 * i + c] *= w;
        s[4 * i + 2 + c] *= w * f;
      }
    }
  }
}

// P as the A fragments of P x, in three terms (hi, mid, lo): the fragment
// of positions [16 kk, +16) is registers 8 kk .. 8 kk + 7 of the S
// accumulator, in pairs.
__device__ __forceinline__ void split_tile(const float (&p)[32],
                                           uint32_t (&t)[3][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split3(p[8 * kk + 2 * e], p[8 * kk + 2 * e + 1], t[0][kk][e],
             t[1][kk][e], t[2][kk][e]);
}

// The state registers into the tile as hi and lo bf16, K-major for the
// inter product: panel np holds n columns [16 np, +16) of the 64 rows (hd),
// 32-byte swizzled (a row's two 16-byte halves swap on rows 4..7 of 8).
template <int NP>
__device__ __forceinline__ void write_state(uint8_t* tile,
                                            const float (&st)[NP][8], int row0,
                                            int col0) {
#pragma unroll
  for (int np = 0; np < NP; ++np)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = row0 + 8 * j;
        const int off = np * BLOCK_PANEL + row * P_ROW +
                        ((i ^ ((row >> 2) & 1)) << 4) + col0 * 2;
        uint32_t hi, lo;
        split2(st[np][4 * i + 2 * j], st[np][4 * i + 2 * j + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(tile + off) = hi;
        *reinterpret_cast<uint32_t*>(tile + off + NP * BLOCK_PANEL) = lo;
      }
}

// W = B o w for the 64 rows of a block into the tile as hi and lo bf16.
// The B panels and the W panels share one layout and swizzle phase (16
// columns of n, rows of 32 bytes, the swizzle moves 16-byte halves within
// a row), so each thread maps one 16-byte half of each panel in place.
template <int NP>
__device__ __forceinline__ void form_w(uint8_t* tile, const uint8_t* b_rows,
                                       uint32_t p_bytes, const float* w,
                                       int tid) {
  const float wr = w[tid >> 1];
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    const uint4 v = *reinterpret_cast<const uint4*>(b_rows + np * p_bytes +
                                                    tid * 16);
    const uint32_t in[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = bf16x2_float2(in[e]);
      split2(f.x * wr, f.y * wr, hi[e], lo[e]);
    }
    *reinterpret_cast<uint4*>(tile + np * BLOCK_PANEL + tid * 16) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(tile + (NP + np) * BLOCK_PANEL + tid * 16) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// This thread's dt at positions tid and tid + 128 of the chunk from c0
// (0 past the chunk or past S).
__device__ __forceinline__ void load_dt(float (&v)[2],
                                        const __nv_bfloat16* dtb, int c0,
                                        int q, int S, int nh, int tid) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = 128 * r + tid;
    v[r] = (pos < q && c0 + pos < S)
               ? __bfloat162float(dtb[static_cast<size_t>(c0 + pos) * nh])
               : 0.f;
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, N <= 64 ? 2 : 1)
    ssd_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap b_map,
                    const __grid_constant__ CUtensorMap c_map,
                    const __nv_bfloat16* __restrict__ dt,
                    const float* __restrict__ a,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ final_state, int S, int nh, int g,
                    int Q, int stages) {
  constexpr int NP = N / 16;          // 16-column panels of B, C, state, W
  const Plan L = make_plan(Q, N, stages);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + L.bar_off;
  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int grp = h / (nh / g);
  const int n_chunks = (S + Q - 1) / Q;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // Thread 0 loads chunk c into stage c % stages: the first stages - 1
  // chunks here, then each chunk c + stages - 1 as chunk c starts, once
  // every thread is done with its stage (chunk c - 1's).
  const auto load_chunk = [&](int c) {
    const int s = c % stages;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t stage = base + s * L.stage_bytes;
    mbar_expect_tx(full, L.stage_bytes);
    tma_load(stage, &x_map, full, 0, h, c * Q, b);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load(stage + L.x_bytes + p * L.p_bytes, &b_map, full, 16 * p, grp,
               c * Q, b);
      tma_load(stage + L.x_bytes + (NP + p) * L.p_bytes, &c_map, full,
               16 * p, grp, c * Q, b);
    }
  };
  if (tid == 0)
    for (int c = 0; c < min(stages - 1, n_chunks); ++c) load_chunk(c);

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float a_h = a[h];
  const __nv_bfloat16* dtb = dt + static_cast<size_t>(b) * S * nh + h;
  float* const cum = reinterpret_cast<float*>(smem + L.vec_off);
  float* const dts = cum + Q;
  float* const wj = dts + Q;
  float* const seg = reinterpret_cast<float*>(smem + L.seg_off);
  const uint32_t tile = base + L.tile_off;
  uint8_t* const tile_p = smem + L.tile_off;

  float st[NP][8];                    // the state (hd x n), fp32
#pragma unroll
  for (int np = 0; np < NP; ++np)
#pragma unroll
    for (int e = 0; e < 8; ++e) st[np][e] = 0.f;
  float acc[32], acc2[32], sacc[32];   // y (two parts) and S (or P)
  uint32_t pt[3][4][4];                // P of the previous step, 3 terms
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = acc2[e] = sacc[e] = 0.f;
  float dtv[2];
  load_dt(dtv, dtb, 0, Q, S, nh, tid);

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * Q;
    const int len = min(Q, S - c0);
    const int s = c % stages;
    // cum = inclusive prefix sum of dt a, and the exclusive suffix sum for
    // w: within each warp's 32 positions by shuffles, then across the 8
    // segments (position 128 r + 32 warp + lane is segment 4 r + warp).
    const float dcur[2] = {dtv[0], dtv[1]};
    if (c + 1 < n_chunks) load_dt(dtv, dtb, c0 + Q, Q, S, nh, tid);
    float da[2], fw[2], bw[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      da[r] = dcur[r] * a_h;
      fw[r] = bw[r] = da[r];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, fw[r], off);
        const float down = __shfl_down_sync(0xffffffffu, bw[r], off);
        if (lane >= off) fw[r] += up;
        if (lane + off < 32) bw[r] += down;
      }
      if (lane == 31) seg[4 * r + warp] = fw[r];
    }
    named_sync(BAR_WG, THREADS);
    if (tid == 0 && c + stages - 1 < n_chunks) load_chunk(c + stages - 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int own = 4 * r + warp;
      float before = 0.f, after = 0.f;
      for (int k = 0; k < own; ++k) before += seg[k];
      for (int k = SEGMENTS - 1; k > own; --k) after += seg[k];
      const int pos = 128 * r + tid;
      if (pos < Q) {
        cum[pos] = fw[r] + before;
        dts[pos] = dcur[r];
        wj[pos] = expf(bw[r] - da[r] + after) * dcur[r];
      }
    }
    write_state(tile_p, st, row0, col0);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(BAR_WG, THREADS);

    mbar_wait(bar_full + 8 * s, (c / stages) & 1);
    const uint32_t xs = base + s * L.stage_bytes;
    const uint32_t bs = xs + L.x_bytes;
    const uint32_t cs = bs + NP * L.p_bytes;
    const int n_blocks = (len + BM - 1) / BM;

    for (int rb = 0; rb < n_blocks; ++rb) {
      // Row block rb: inter, then the intra products of column blocks
      // 0..rb.  Step u issues S_u with P_{u-1} x; P_u is formed while that
      // P x runs.
      const float ci[2] = {cum[rb * BM + row0], cum[rb * BM + row0 + 8]};
      const float f = expf(ci[1] - ci[0]);
      const uint32_t c_rows = cs + rb * BLOCK_PANEL;
#pragma unroll
      for (int e = 0; e < 32; ++e) acc2[e] = 0.f;
      fence_regs(acc);
      fence_regs(sacc);
      wgmma_fence();
      issue_inter<NP>(acc, c_rows, tile, L.p_bytes);
      wgmma_commit();
      issue_s<NP>(sacc, c_rows, bs, L.p_bytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(sacc);
      {
        const float ei[2] = {expf(ci[0]), expf(ci[1])};
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] *= ei[(e >> 1) & 1];
      }
      if (rb == 0)
        form_p<true>(sacc, ci, f, cum, dts, row0, col0);
      else
        form_p<false>(sacc, ci, f, cum, dts, row0, col0);
      split_tile(sacc, pt);
      for (int u = 1; u <= rb; ++u) {
        fence_regs(sacc);
        fence_regs(acc);
        fence_regs(acc2);
        fence_regs(pt);
        wgmma_fence();
        issue_s<NP>(sacc, c_rows, bs + u * BLOCK_PANEL, L.p_bytes);
        wgmma_commit();
        issue_px(acc, acc2, pt, xs + (u - 1) * BM * X_ROW);
        wgmma_commit();
        wgmma_wait<1>();   // S_u done; P_{u-1} x may still run
        fence_regs(sacc);
        if (u == rb)
          form_p<true>(sacc, ci, f, cum + u * BM, dts + u * BM, row0, col0);
        else
          form_p<false>(sacc, ci, f, cum + u * BM, dts + u * BM, row0, col0);
        fence_regs(sacc);  // P_u is formed before the wait, beside P_{u-1} x
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(acc2);
        fence_regs(pt);
        split_tile(sacc, pt);
      }
      fence_regs(acc);
      fence_regs(acc2);
      fence_regs(pt);
      wgmma_fence();
      issue_px(acc, acc2, pt, xs + rb * BM * X_ROW);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(acc2);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = rb * BM + row0 + 8 * j;
        if (i < len) {
          __nv_bfloat16* yr =
              y + (static_cast<size_t>(b) * S + c0 + i) * nh * HD +
              static_cast<size_t>(h) * HD;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            *reinterpret_cast<__nv_bfloat162*>(yr + 8 * k + col0) =
                __floats2bfloat162_rn(acc[4 * k + 2 * j] + acc2[4 * k + 2 * j],
                                      acc[4 * k + 2 * j + 1] +
                                          acc2[4 * k + 2 * j + 1]);
        }
      }
    }

    // The state update: decay to the chunk's end, then x^T W a block of 64
    // rows at a time, W written over the tile (every inter product and
    // every earlier block's update has been waited for by then).
    const float decay = expf(cum[Q - 1]);
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
      for (int e = 0; e < 8; ++e) st[np][e] *= decay;
    for (int jb = 0; jb < n_blocks; ++jb) {
      named_sync(BAR_WG, THREADS);
      form_w<NP>(tile_p, smem + (bs - base) + jb * BLOCK_PANEL, L.p_bytes,
                 wj + jb * BM, tid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(BAR_WG, THREADS);
      fence_regs(st);
      wgmma_fence();
      issue_state(st, xs + jb * BM * X_ROW, tile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
    }
  }

  // The final state (B, nh, hd, n) from the state registers.
  float* const fb =
      final_state + (static_cast<size_t>(b) * nh + h) * HD * N;
#pragma unroll
  for (int np = 0; np < NP; ++np)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float2*>(fb + (row0 + 8 * j) * N + 16 * np +
                                   8 * i + col0) =
            make_float2(st[np][4 * i + 2 * j], st[np][4 * i + 2 * j + 1]);
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 4-D map (inner, heads, rows, B) of a contiguous bf16 (B, rows, heads,
// inner) tensor, read in boxes of (box_inner, 1, box_rows, 1); rows past
// ``rows`` read as zeros.
int encode_map(CUtensorMap* map, const void* ptr, int inner, int heads,
               int rows, int B, int box_inner, int box_rows,
               CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(inner) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_inner), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int N>
int launch(const void* x, const void* dt, const float* a, const void* bm,
           const void* cm, void* y, float* fs, int B, int S, int nh, int g,
           int chunk, cudaStream_t stream) {
  const int stages =
      make_plan(chunk, N, 2).alloc <= SMEM_TWO_BLOCKS ? 2 : 1;
  const Plan L = make_plan(chunk, N, stages);
  if (L.alloc > SMEM_MAX) return ERR_SMEM;
  CUtensorMap xm, bmm, cmm;
  int err = encode_map(&xm, x, HD, nh, S, B, HD, chunk,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_map(&bmm, bm, N, g, S, B, 16, chunk,
                     CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == 0)
    err = encode_map(&cmm, cm, N, g, S, B, 16, chunk,
                     CU_TENSOR_MAP_SWIZZLE_32B);
  if (err != 0) return err;
  auto kernel = ssd_sm90_kernel<N>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.alloc);
  if (set != cudaSuccess) return set;
  kernel<<<B * nh, THREADS, L.alloc, stream>>>(
      xm, bmm, cmm, static_cast<const __nv_bfloat16*>(dt), a,
      static_cast<__nv_bfloat16*>(y), fs, S, nh, g, chunk, stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, nh, hd), dt (B, S, nh), bm/cm (B, S, g, n), y (B, S, nh, hd):
// contiguous bfloat16, x, bm, cm 16-byte aligned; a (nh,) and final (B, nh,
// hd, n) float32.  hd = 64, n in {16, 32, ..., 128}, chunk in {64, 128,
// 192, 256}, nh % g == 0, S >= 1, B * nh < 2**31 (the wrapper checks).
// Returns 0 when launched, else a cudaError_t or one of the ERR_* codes.
int ssd_sm90_fwd(const void* x, const void* dt, const float* a, const void* bm,
                 const void* cm, void* y, float* final_state, int B, int S,
                 int nh, int hd, int g, int n, int chunk, void* stream) {
  if (hd != HD || chunk < BM || chunk > MAX_CHUNK || chunk % BM)
    return ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 16:
      return launch<16>(x, dt, a, bm, cm, y, final_state, B, S, nh, g, chunk,
                        st);
    case 32:
      return launch<32>(x, dt, a, bm, cm, y, final_state, B, S, nh, g, chunk,
                        st);
    case 48:
      return launch<48>(x, dt, a, bm, cm, y, final_state, B, S, nh, g, chunk,
                        st);
    case 64:
      return launch<64>(x, dt, a, bm, cm, y, final_state, B, S, nh, g, chunk,
                        st);
    case 80:
      return launch<80>(x, dt, a, bm, cm, y, final_state, B, S, nh, g, chunk,
                        st);
    case 96:
      return launch<96>(x, dt, a, bm, cm, y, final_state, B, S, nh, g, chunk,
                        st);
    case 112:
      return launch<112>(x, dt, a, bm, cm, y, final_state, B, S, nh, g,
                         chunk, st);
    case 128:
      return launch<128>(x, dt, a, bm, cm, y, final_state, B, S, nh, g,
                         chunk, st);
    default:
      return ERR_SHAPE;
  }
}

const char* ssd_sm90_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODE:
      return "cuTensorMapEncodeTiled is not available from the driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_SHAPE:
      return "hd must be 64, n a multiple of 16 up to 128 and chunk a "
             "multiple of 64 up to 256";
    case ERR_SMEM:
      return "the shared-memory plan does not fit a block";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
