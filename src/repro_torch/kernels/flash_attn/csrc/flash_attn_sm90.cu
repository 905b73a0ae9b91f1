// Flash-attention forward on Hopper (sm_90a) for bfloat16 inputs: TMA-fed,
// warp-specialised, on the bf16 tensor cores through wgmma.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py:72
// (flash_attention_pallas) for bf16 q, k, v with head dim D in {64, 128};
// every other dtype or D goes to the fp32-core kernel of flash_attn.cu (the
// wrapper, kernel.py, picks the route by shape).  It computes what the TPU
// kernel computes: softmax(q k^T / sqrt(D), masked) @ v with q, k, v as
// float32 values, an online softmax, the (S, T) scores never in device
// memory.  Key kpos is valid for query qpos when (qpos - kpos) < window and,
// if causal, kpos <= qpos; a masked score is -1e30, so a row with no valid
// key gets the mean of v over all T keys; a tail column (kpos >= T) gives
// p = 0; l = 0 divides by 1; o is written in bf16.
//
// Layout: the model's (B, S, H, D) for q and o and (B, T, KV, D) for k and
// v, read in place by 4-D TMA tensor maps (D, H, S, B) and (D, KV, T, B):
// query head h reads kv head h / (H / KV), and rows past S or T in a last
// tile are zero-filled by the hardware (a flattened (B * S) map would read
// the next batch's rows instead).
//
// Bound on this card: operations.  At the served shape (B 4, H 32, KV 8,
// S = T = 2048, D 128, causal) the valid pairs need 4 D products each,
// 1.375e11 at the bf16 tensor peak of 989 TFLOP/s: 0.14 ms, against 0.13 GB
// of traffic (0.04 ms).  The fp32 kernel spends 2.06 ms on those products
// alone at 67 TFLOP/s, so this one moves them to the tensor cores.
//
// Where P is rounded.  The TPU kernel forms p and p @ v in float32.  A
// kernel that rounds p to bf16 before the P @ V product computes another
// function: on causal rows whose output is near 0 it misses the port's
// check (rtol 8e-3, atol 1e-5 x max(1, |want|_inf)) by far.  So P is split
// into two bf16 terms, P_hi = bf16(p) and P_lo = bf16(p - P_hi), and
// O += P_hi V + P_lo V: about 16 significant bits of p, at 1.5 times the
// tensor-core products of Q K^T + P V.  The row sum l adds the float32 p.
//
// Design:
//   * one block of 384 threads per (128 query rows, b * H + h), longest
//     causal rows first; warpgroups 0 and 1 are consumers (64 query rows
//     each), warpgroup 2 the producer, of which one thread issues TMA;
//     setmaxnreg moves registers from the producer (24) to the consumers
//     (240);
//   * shared memory, 128-byte swizzled as wgmma reads it: the Q tile, loaded
//     once, and a ring of 2 stages of (K tile, V tile) of BK = 128 keys with
//     full (TMA bytes) and empty (consumer arrivals) mbarriers: 160 KB at
//     D = 128, one block an SM;
//   * a consumer walks the tiles in steps of BN = 64 keys.  Step u issues
//     S_u = Q K_u^T (wgmma m64n64k16, Q and K from shared memory, both
//     K-major) together with step u - 1's O += P V, and runs step u's
//     softmax while that P V is on the tensor cores.  At 64 keys a step the
//     registers in flight (S 32, P_hi and P_lo 32, O 64 at D = 128) leave
//     room; at 128 keys (S 64, P 64) ptxas serialised every wgmma;
//   * the softmax on the f32 accumulator fragment in registers: scale, mask
//     (only on a step holding a masked pair or a tail column), row max over
//     the quad by shuffles, alpha = expf(m_old - m_new), p = expf(s - m_new)
//     (no fast math);
//   * O += P V: wgmma m64nDk16 with A (P_hi, then P_lo) from registers (the
//     accumulator's fragment is the A fragment's layout) and B (V) from
//     shared memory, MN-major (the transpose bit);
//   * every wgmma descriptor is formed next to its wgmma from a base the
//     compiler cannot hoist: hoisted out of the loop, the descriptors of
//     all stages spilled;
//   * a block whose every row has a valid key visits only the key tiles
//     holding a valid pair (causal: up to the diagonal; window: from the
//     window's first tile), which changes no bit; a block holding a row with
//     no valid key visits every tile, which yields the mean-of-v rows;
//   * epilogue: o = acc / (l == 0 ? 1 : l), rounded to bf16 into the
//     warpgroup's part of the Q tile, swizzled, and stored by TMA (the map
//     clips rows past S).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                   // query rows a block
constexpr int BK = 128;                   // keys a TMA tile
constexpr int BN = 64;                    // keys a compute step (sub-tile)
constexpr int STAGES = 2;                 // (K, V) tiles in flight
constexpr int CONSUMERS = 2;              // warpgroups of 64 query rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int ROW_BYTES = 128;            // one swizzled row: 64 bf16
constexpr float NEG_INF = -1e30f;

// Errors of the host side, beside cudaError_t's values.
constexpr int ERR_NO_ENCODE = 10001;      // no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 10002;         // a tensor map was refused
constexpr int ERR_HEAD_DIM = 10003;       // D is not 64 or 128

// Shared memory of one block, in bytes from a 1024-aligned base (the
// 128-byte swizzle repeats every 8 rows = 1024 bytes).  A tile of R rows is
// D / 64 panels of R x 128 bytes.
template <int D>
struct Layout {
  static constexpr int PANELS = D / 64;
  static constexpr int Q_PANEL = BQ * ROW_BYTES;
  static constexpr int KV_PANEL = BK * ROW_BYTES;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // mbarriers: Q full, then per stage K full, V full, empty.
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;   // room to align the base
};

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

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
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
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// wgmma with the shapes this kernel issues (bf16 inputs, f32 accumulators).
// D (64 x 64, f32) {+}= A (64 x 16, smem) * B (64 x 16, smem), both K-major.
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

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
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

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  union {
    __nv_bfloat162 b;
    uint32_t u;
  } cvt;
  cvt.b = v;
  return cvt.u;
}

// p (a, b) as two bf16 pairs: hi = bf16(p), lo = bf16(p - hi).
__device__ __forceinline__ void split_p(float a, float b, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n64(o, a, db);
  }
}

// Whether query row q has a valid key in [0, T).
__device__ __forceinline__ bool row_has_key(int q, int T, bool causal,
                                            int window) {
  const int lo = max(0, q - window + 1);
  const int hi = causal ? min(q, T - 1) : T - 1;
  return lo <= hi;
}

// The key tiles [j0, j1) that the block of query rows [q0, q1) visits.  A
// row's valid keys are [max(0, q - window + 1), causal ? min(q, T - 1) :
// T - 1]; their length is concave in q, so if the first and the last row
// have a valid key every row has, and the rows' ranges join into one
// interval: the tiles it touches hold a valid pair and no other tile does.
// Otherwise every tile is visited, as the TPU kernel does.
__device__ __forceinline__ void key_tiles(int q0, int q1, int T, bool causal,
                                          int window, int& j0, int& j1) {
  if (row_has_key(q0, T, causal, window) &&
      row_has_key(q1 - 1, T, causal, window)) {
    j0 = max(0, q0 - window + 1) / BK;
    j1 = (causal ? min(q1 - 1, T - 1) : T - 1) / BK + 1;
  } else {
    j0 = 0;
    j1 = (T + BK - 1) / BK;
  }
}

// Named barrier ``id`` (0 is __syncthreads) over ``threads`` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A descriptor whose base the compiler cannot see through: without it,
// ptxas hoists every descriptor of every stage out of the tile loop and
// spills them.  The k-steps add their offsets to it.
__device__ __forceinline__ uint64_t opaque_desc(uint32_t addr, uint32_t lbo) {
  asm volatile("" : "+r"(addr));
  return sw128_desc(addr, lbo, 1024);
}

// S (64 x BN) = Q K^T for the BN keys from k_base (a row of a K tile): D /
// 16 steps of k16, four to a 128-byte panel; Q and K both K-major.
// Offsets add to the descriptor's address field (in 16-byte units; shared
// addresses fit its 14 bits).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t q_base,
                                         uint32_t k_base) {
  const uint64_t dq = opaque_desc(q_base, 16);
  const uint64_t dk = opaque_desc(k_base, 16);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qoff = (kk / 4) * (BQ * ROW_BYTES) + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * (BK * ROW_BYTES) + (kk % 4) * 32;
    wgmma_ss_n64(s, dq + (qoff >> 4), dk + (koff >> 4), kk > 0);
  }
}

// O (64 x D) += P_hi V + P_lo V for the BN keys from v_base (a row of a
// V tile).  V is MN-major (D contiguous): the descriptor's leading offset
// steps the 64-column panels, its stride the 8-key groups; a k16 step is
// 16 rows.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&hi)[BN / 16][4],
                                         const uint32_t (&lo)[BN / 16][4],
                                         uint32_t v_base) {
  const uint64_t dv = opaque_desc(v_base, BK * ROW_BYTES);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    wgmma_pv<D>(o, hi[kk], dv + ((kk * 16 * ROW_BYTES) >> 4));
    wgmma_pv<D>(o, lo[kk], dv + ((kk * 16 * ROW_BYTES) >> 4));
  }
}

// Whether every pair of the 64 query rows from r_first and the BN keys
// from k0 is valid, so that the sub-tile needs no mask.
__device__ __forceinline__ bool tile_is_full(int k0, int r_first, int T,
                                             bool causal, int window) {
  return k0 + BN <= T && (!causal || k0 + BN - 1 <= r_first) &&
         r_first + 63 - k0 < window;
}

// The online softmax of one step on the S accumulator (register 4 i + 2 j
// + c: row qpos0 + 8 j, key k0 + 8 i + col0 + c): scale, mask (only where
// the tile holds a masked pair or a tail column), the row max over the
// quad, alpha = expf(m_old - m_new); s becomes p = expf(s - m_new) in
// float32, and l = l alpha + (this thread's part of) the row sum of p.
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool full, int k0, int qpos0,
                                             int col0, int T, bool causal,
                                             int window, float scale) {
  if (full) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) s[e] *= scale;
  } else {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * i + col0 + (e & 1);
        const int qpos = qpos0 + 8 * (e >> 1);
        const bool valid =
            ((qpos - kpos) < window) & (!causal | (kpos <= qpos));
        const float v = valid ? s[4 * i + e] * scale : NEG_INF;
        s[4 * i + e] = kpos < T ? v : -CUDART_INF_F;  // tail: no key at all
      }
    }
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int e = 0; e < BN / 2; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    const float m_new = fmaxf(m[j], mx[j]);
    alpha[j] = expf(m[j] - m_new);
    m[j] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) {
    const int j = (e >> 1) & 1;
    s[e] = expf(s[e] - m[j]);
    rs[j] += s[e];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];
}

// P as the A fragments of P V: the fragment of keys [16 kk, 16 kk + 16) is
// registers 8 kk .. 8 kk + 7 of the S accumulator, in pairs.
__device__ __forceinline__ void split_tile(const float (&p)[BN / 2],
                                           uint32_t (&hi)[BN / 16][4],
                                           uint32_t (&lo)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_p(p[8 * kk + 2 * e], p[8 * kk + 2 * e + 1], hi[kk][e], lo[kk][e]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int e = 0; e < N; ++e) o[e] *= alpha[(e >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap o_map, int S,
                          int T, int H, int KV, int causal_flag, int window,
                          float scale) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_k = bar_q + 8;                  // + 8 s: K full
  const uint32_t bar_v = bar_k + 8 * STAGES;         // + 8 s: V full
  const uint32_t bar_empty = bar_v + 8 * STAGES;     // + 8 s: consumed

  const bool causal = causal_flag != 0;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int q1 = min(q0 + BQ, S);
  int j0, j1;
  key_tiles(q0, q1, T, causal, window, j0, j1);
  const int n_tiles = j1 - j0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // The producer: one thread keeps the ring of K and V tiles full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p)
        tma_load(base + L::Q_OFF + p * L::Q_PANEL, &q_map, bar_q, 64 * p, h,
                 q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t round = it / STAGES;
        const int k0 = (j0 + it) * BK;
        mbar_wait(bar_empty + 8 * s, (round & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p)
          tma_load(base + L::K_OFF + s * L::KV_BYTES + p * L::KV_PANEL,
                   &k_map, bar_k + 8 * s, 64 * p, kvh, k0, b);
        mbar_expect_tx(bar_v + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p)
          tma_load(base + L::V_OFF + s * L::KV_BYTES + p * L::KV_PANEL,
                   &v_map, bar_v + 8 * s, 64 * p, kvh, k0, b);
      }
    }
  } else {
    // A consumer: query rows [r_first, r_first + 64) of the block, in
    // steps of BN keys.  Step u's S = Q K^T is issued with step u - 1's
    // O += P V, so the softmax of step u runs while that P V is on the
    // tensor cores.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    // This thread's accumulator entries (S and O alike): register
    // 4 i + 2 j + c holds row row0 + 8 j, column 8 i + col0 + c.
    const int row0 = 16 * warp + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    const int r_first = q0 + 64 * wg;
    const int qpos0 = r_first + row0;
    const uint32_t q_base = base + L::Q_OFF + wg * 64 * ROW_BYTES;

    float o[D / 2];
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];   // the previous step's P
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};   // this thread's columns; the quad sums them
    float alpha[2];
    // Step u covers keys [j0 BK + u BN, + BN): row (u % 2) BN of the K and
    // V tiles of stage (u / 2) % STAGES.
    constexpr int STEPS = BK / BN;
    const int n_steps = n_tiles * STEPS;
    const uint32_t sub = BN * ROW_BYTES;

    mbar_wait(bar_q, 0);
    {  // The first step: S only.
      const int k0 = j0 * BK;
      mbar_wait(bar_k, 0);
      fence_regs(s);
      wgmma_fence();
      issue_qk<D>(s, q_base, base + L::K_OFF);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, m, l, alpha, tile_is_full(k0, r_first, T, causal, window),
                   k0, qpos0, col0, T, causal, window, scale);
      split_tile(s, p_hi, p_lo);
    }
    for (int u = 1; u < n_steps; ++u) {
      const int it = u / STEPS;
      const int st = it % STAGES;
      const int pit = (u - 1) / STEPS;
      const int pst = pit % STAGES;
      const int k0 = j0 * BK + u * BN;
      mbar_wait(bar_k + 8 * st, (it / STAGES) & 1);
      mbar_wait(bar_v + 8 * pst, (pit / STAGES) & 1);
      fence_regs(s);
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
      issue_qk<D>(s, q_base,
                  base + L::K_OFF + st * L::KV_BYTES + (u % STEPS) * sub);
      wgmma_commit();
      issue_pv<D>(o, p_hi, p_lo,
                  base + L::V_OFF + pst * L::KV_BYTES + ((u - 1) % STEPS) * sub);
      wgmma_commit();
      wgmma_wait<1>();   // S done; P V may still run
      fence_regs(s);
      softmax_tile(s, m, l, alpha, tile_is_full(k0, r_first, T, causal, window),
                   k0, qpos0, col0, T, causal, window, scale);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      if ((u - 1) % STEPS == STEPS - 1)
        mbar_arrive(bar_empty + 8 * pst);   // tile pit's K and V are read
      rescale(o, alpha);
      split_tile(s, p_hi, p_lo);
    }
    {  // The last step's P V.
      const int pit = n_tiles - 1;
      const int pst = pit % STAGES;
      mbar_wait(bar_v + 8 * pst, (pit / STAGES) & 1);
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
      issue_pv<D>(o, p_hi, p_lo,
                  base + L::V_OFF + pst * L::KV_BYTES + (STEPS - 1) * sub);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(bar_empty + 8 * pst);
    }

    // Epilogue: o / l in bf16 into this warpgroup's rows of the Q tile (no
    // longer read), swizzled as the O map expects, then one TMA store a
    // panel; the map clips rows past S.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
      if (l[j] == 0.f) l[j] = 1.f;
    }
    uint8_t* const o_tile = smem + L::Q_OFF + wg * 64 * ROW_BYTES;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = row0 + 8 * j;
        const int off = (i / 8) * L::Q_PANEL + row * ROW_BYTES +
                        (((i % 8) ^ (row & 7)) << 4) + col0 * 2;
        // __fdividef: an IEEE division would call its slow path, and a
        // call serialises every wgmma of the kernel; l is at most T.
        const __nv_bfloat162 val =
            __floats2bfloat162_rn(__fdividef(o[4 * i + 2 * j], l[j]),
                                  __fdividef(o[4 * i + 2 * j + 1], l[j]));
        *reinterpret_cast<uint32_t*>(o_tile + off) = bf16x2_bits(val);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + wg, 128);
    if (tid == 0 && r_first < S) {
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p)
        tma_store(&o_map, q_base + p * L::Q_PANEL, 64 * p, h, r_first, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
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

// A 4-D map (D, heads, rows, B) of a contiguous bf16 (B, rows, heads, D)
// tensor, read or written in boxes of (64, 1, box_rows, 1), 128-byte
// swizzled; rows past ``rows`` read as zeros and are not written.
int encode_map(CUtensorMap* map, const void* ptr, int D, int heads, int rows,
               int B, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * rows};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T, int H, int KV, int causal, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  int err = encode_map(&qm, q, D, H, S, B, BQ);
  if (err == 0) err = encode_map(&km, k, D, KV, T, B, BK);
  if (err == 0) err = encode_map(&vm, v, D, KV, T, B, BK);
  if (err == 0) err = encode_map(&om, o, D, H, S, B, 64);
  if (err != 0) return err;
  auto kernel = flash_fwd_sm90_kernel<D>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::ALLOC);
  if (set != cudaSuccess) return set;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  kernel<<<grid, THREADS, Layout<D>::ALLOC, stream>>>(
      qm, km, vm, om, S, T, H, KV, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, D), k/v (B, T, KV, D), o (B, S, H, D): contiguous bfloat16,
// 16-byte aligned; D in {64, 128}, H % KV == 0, S, T >= 1, B * H < 2**31,
// ceil(S / 128) < 65536 and S + T < 2**30 (the wrapper checks).  Returns 0
// when launched, else a cudaError_t or one of the ERR_* codes above.
int flash_attn_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KV, int D, int causal,
                        long long window, float scale, void* stream) {
  // Clamped to [-T, S + T]: the same mask, in int range.
  if (window > static_cast<long long>(S) + T) window = S + T;
  if (window < -static_cast<long long>(T)) window = -T;
  const int w = static_cast<int>(window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, o, B, S, T, H, KV, causal, w, scale, st);
  if (D == 64)
    return launch<64>(q, k, v, o, B, S, T, H, KV, causal, w, scale, st);
  return ERR_HEAD_DIM;
}

const char* flash_attn_sm90_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODE:
      return "cuTensorMapEncodeTiled is not available from the driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_HEAD_DIM:
      return "head dim must be 64 or 128";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
