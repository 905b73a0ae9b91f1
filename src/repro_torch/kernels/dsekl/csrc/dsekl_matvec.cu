// f = K(x, z) @ a for the seven DSEKL kernels, float32, on Hopper (sm_90a):
// the matvec's "fp32" route.
//
// Replaces the TPU kernel src/repro/kernels/dsekl/block.py::kernel_matvec_pallas
// (with its tile evaluators TILE_FNS): x (I, D) queries, z (J, D) support
// rows, a (J,) dual weights -> f (I,).  K is never written to memory.
// With its operands swapped it also replaces kernel_vecmat_pallas (the
// last bullet below).  The wrapper (block.py::select_matvec_route) sends
// it the Laplacian and D > 64; the six cross-term kinds at D <= 64 go to
// the tensor-core kernel of dsekl_matvec_sm90.cu.
//
// Bound on this card.  The work is 2*I*J*D fp32 operations for the cross
// term (or the L1 sum of the Laplacian kernel) plus about eight per (i, j)
// for the epilogue; the bytes that must move are x, z, a and f once.  At
// the serving shape (I = 1024 queries, J ~ 283k padded support rows,
// D = 54) that is ~3.4e10 operations (0.50 ms at the H100 SXM's 67 TFLOP/s
// fp32) against ~62 MB (0.02 ms at 3.35 TB/s), so the kernel is bound by
// fp32 throughput on the CUDA cores, not by memory.  (One TF32 product
// would break the f32 tolerance; three, on split operands, keep it:
// dsekl_matvec_sm90.cu.)  The support set is re-read once per
// 64-row query tile, but blocks that run together share one support
// range, so the re-reads are served from L2.
//
// Design.
//  * Each block owns a BM-row query tile and a contiguous range of BN-row
//    support tiles.  x and z are staged through shared memory in BK-wide
//    slices of D (any D: masked at the edge), and each of the 256 threads
//    keeps a TM x TN register micro-tile of partial dot products (or L1
//    sums), accumulated with fp32 FMA.
//  * The epilogue applies the tile function from the row norms exactly as
//    block.py's _sq_dists_tile does (|x|^2 + |z|^2 - 2 x.z, clamped at 0),
//    multiplies by a_j and folds into per-row partials kept in registers
//    across the whole support range.  The kernel kind is a template
//    parameter: seven instantiations, no branching in the inner loop.
//  * The TPU grid walks the support set in order into one revisited output
//    block.  Here a 1024-query batch gives only 16 row tiles for 132 SMs,
//    so the support rows are split over gridDim.y until the grid fills one
//    whole wave of resident blocks (dsekl_blocks_per_sm).  Each block
//    writes its (split, row) partials once, and a second small pass sums
//    them in a fixed order: no float atomics, so a result is bit-stable
//    from run to run.
//  * Ragged edges are masked in the kernel: a support row past J adds
//    exactly 0, a query row past I is not stored.
//  * Row norms come from a first small pass (one warp per row).
//  * The tile machinery (kinds, epilogues, staging loop, row norms) lives
//    in dsekl_tile.cuh, shared with dsekl_train.cu.
//  * The same kernel computes g = K(x, z)^T @ v (block.py's
//    kernel_vecmat_cuda, replacing kernel_vecmat_pallas) with the operands
//    swapped: every registry kernel is symmetric and this epilogue is
//    bit-symmetric (xn + zn is a commutative add, the fmaf chain runs in
//    the same k order, |x - z| == |z - x|), so K(x, z)^T v == K(z, x) v bit
//    for bit, and the support split becomes a split over x's rows.  At
//    the two-pass training step's shape (I = J = 1024, D = 54) either
//    product is ~1.2e8 operations, 1.8 us at 67 TFLOP/s, against 0.23 MB
//    of bytes: the launches, not the card, set its time there.
#include "dsekl_tile.cuh"

namespace {

// partials[split, row] = sum over this block's support range of
// k(x_row, z_j) * a_j.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
matvec_tiles(const float* __restrict__ x, const float* __restrict__ z,
             const float* __restrict__ a, const float* __restrict__ xnorm,
             const float* __restrict__ znorm, float* __restrict__ partials,
             int I, int J, int D, int tiles_per_split, Params p) {
  __shared__ __align__(16) float xs[BK][LDS];
  __shared__ __align__(16) float zs[BK][LDS];
  // Per-tile a_j and |z_j|^2, double-buffered by tile parity: tile t
  // writes its half before its first barrier while a slower thread may
  // still read tile t-1's half in its epilogue.
  __shared__ float zn_s[2][BN];
  __shared__ float a_s[2][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;                       // column group
  const int ty = tid / TX;                       // row group
  const int row0 = blockIdx.x * BM;
  const int n_tiles = (J + BN - 1) / BN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  float xn[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = row0 + ty * TM + m;
    xn[m] = (euclidean(KIND) && r < I) ? xnorm[r] : 0.0f;
  }
  float rowacc[TM] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * BN;
    const int buf = t & 1;
    float acc[TM][TN];
    accumulate_tile<KIND>(x, z, I, J, D, row0, col0, xs, zs, acc, [&] {
      if (tid < BN) {
        const int j = col0 + tid;
        a_s[buf][tid] = j < J ? a[j] : 0.0f;
        zn_s[buf][tid] = (euclidean(KIND) && j < J) ? znorm[j] : 0.0f;
      }
    });

    // Epilogue: fold this tile into the row partials.
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int cl = tx * TN + n;
      if (col0 + cl < J) {
        const float aj = a_s[buf][cl];
        const float znj = zn_s[buf][cl];
#pragma unroll
        for (int m = 0; m < TM; ++m)
          rowacc[m] += tile_value<KIND>(acc[m][n], xn[m], znj, p) * aj;
      }
    }
  }

  // Reduce the TX column groups of each row (lanes differing in the low
  // four bits of the lane id) in a fixed tree order.
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      rowacc[m] += __shfl_xor_sync(0xffffffffu, rowacc[m], off);
  if (tx == 0) {
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = row0 + ty * TM + m;
      if (r < I)
        partials[static_cast<size_t>(blockIdx.y) * I + r] = rowacc[m];
    }
  }
}

}  // namespace

extern "C" {

// f = K(x, z) @ a.  All pointers are device pointers to contiguous float32:
// x (I, D), z (J, D), a (J,), out (I,), scratch (n_split * I + I + J).
// The support tiles are split into n_split contiguous ranges of
// tiles_per_split 64-row tiles.  Launches on `stream`, does not
// synchronise, allocates nothing.  Returns the cudaGetLastError() code
// after the launches (0 = launched), or -1 for a bad argument.
int dsekl_kernel_matvec(const float* x, const float* z, const float* a,
                        float* out, float* scratch, int I, int J, int D,
                        int kind, float gamma, float coef0, float degree,
                        int int_degree, int degree_i, float length_scale,
                        int n_split, int tiles_per_split, void* stream) {
  if (I <= 0 || J < 0 || D <= 0 || n_split <= 0 || tiles_per_split < 0 ||
      static_cast<long long>(n_split) * tiles_per_split * BN <
          static_cast<long long>(J))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{gamma, coef0, degree, length_scale, int_degree, degree_i};
  float* partials = scratch;
  float* xn = scratch + static_cast<size_t>(n_split) * I;
  float* zn = xn + I;
  if (euclidean(kind)) {
    launch_row_norms(x, I, D, xn, s);
    if (J > 0) launch_row_norms(z, J, D, zn, s);
  }
  const dim3 grid((I + BM - 1) / BM, n_split);
  const bool known = with_kind(kind, [&](auto k) {
    matvec_tiles<decltype(k)::value><<<grid, THREADS, 0, s>>>(
        x, z, a, xn, zn, partials, I, J, D, tiles_per_split, p);
  });
  if (!known) return -1;
  sum_partials<<<(I + 255) / 256, 256, 0, s>>>(partials, n_split, I, out);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the `kind` tile kernel that fit on one SM at once (registers
// and shared memory), so the caller can size the grid to whole waves; -1 on
// a bad kind or a CUDA error.
int dsekl_blocks_per_sm(int kind) {
  int n = -1;
  cudaError_t e = cudaErrorInvalidValue;
  with_kind(kind, [&](auto k) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, matvec_tiles<decltype(k)::value>, THREADS, 0);
  });
  return e == cudaSuccess ? n : -1;
}

const char* dsekl_error_string(int code) { return error_string(code); }

}  // extern "C"
