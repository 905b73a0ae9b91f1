// The fused training-step op of DSEKL, float32, on Hopper (sm_90a):
//
//   f = f_scale * K(x, z) @ a;  v = loss_grad(f, y) (or v given);
//   g = K(x, z)^T @ v,
//
// with every K value evaluated ONCE.  Replaces two TPU kernels of
// src/repro/kernels/dsekl/block.py: train_pass_pallas (the loss gradient
// fused between the products; the Alg.-1 step of every fit) and
// dual_pass_pallas (v given, loss = NONE).  x (I, D) gradient rows,
// z (J, D) expansion rows, a (J,), y or v (I,) -> f (I,), g (J,).
//
// Bound on this card.  At the main path's step (I = J = 1024, D = 54,
// RBF) the work is 2*I*J*D = 1.13e8 operations for the cross term, ~8 per
// (i, j) for the epilogue and 2 per (i, j) for g: ~1.24e8, or 1.9 us at
// the H100 SXM's 67 TFLOP/s fp32.  The function's own bytes (x, z, a, y,
// f, g) are ~0.46 MB, 0.14 us at 3.35 TB/s.  So operations bound it, and
// at this size the launches (a few us each) take longer than either.
//
// Design, and why.  The TPU kernel keeps the K row-block in VMEM (up to
// 8 MiB) on a sequential (ni, 2, nj) grid: sweep j for f, take v, replay
// the stash for g.  None of that carries over: a 64-row K row-block at
// J = 1024 is 256 KB, over the 227 KB of shared memory a block may have;
// a block per row tile gives 16 blocks for 132 SMs; and splitting J over
// blocks, as the matvec does, breaks the dependency (v needs the complete
// f row before any g).  So the op is three passes on the caller's stream,
// with no float atomics and every sum in a fixed order (bit-stable):
//  1. Tile pass, a (row tiles x column tiles) grid of 64 x 64 tiles
//     (16 x 16 = 256 blocks at I = J = 1024).  The matvec's staging loop
//     and tile_value epilogue (dsekl_tile.cuh) give each K value once; it
//     is written to an (I, J) float32 stash (4 MB at 1024^2, which stays
//     in the 50 MB L2), and the tile's K @ a row partials go to
//     f_parts[column tile, i].
//  2. Row pass: f_i = f_scale * sum_t f_parts[t, i] in tile order, then
//     v_i = loss_grad(f_i, y_i) for the four losses of core/losses.py, or
//     the given v_i.  Ragged rows are masked, never padded: a row at or
//     past I has no f and no v.
//  3. Column pass: g_j = sum_i K[i, j] * v_i over the stash, rows cut into
//     fixed 128-row chunks, each chunk's 8 row-group partials summed in
//     order, and the chunk partials summed in chunk order by a last small
//     pass (skipped when there is one chunk).
// Row norms come first, as in the matvec, for the Euclidean kernels.  The
// stash is the wrapper's scratch: block.py's STASH_BUDGET bounds it, and
// ops.kernel_dual_pass falls back to matvec then vecmat above it.
#include "dsekl_tile.cuh"

namespace {

enum Loss : int {                 // repro_torch.core.losses.LOSS_CODES
  NONE = -1, HINGE = 0, SQUARED_HINGE = 1, SQUARE = 2, LOGISTIC = 3,
};

constexpr int COL_W = 32;         // column-pass columns per block (a warp)
constexpr int COL_H = 8;          // column-pass row groups per block
constexpr int ROW_CHUNK = 128;    // column-pass rows per block

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// d loss / d f, as core/losses.py computes it.
__device__ __forceinline__ float loss_grad(int loss, float f, float y) {
  switch (loss) {
    case HINGE: return (y * f < 1.0f) ? -y : 0.0f;           // strict <
    case SQUARED_HINGE: return -2.0f * y * fmaxf(0.0f, 1.0f - y * f);
    case SQUARE: return f - y;
    default:                                                 // LOGISTIC
      // -y * sigmoid(-y f), sigmoid(t) = 1 / (1 + exp(-t)).
      return -y * (1.0f / (1.0f + expf(y * f)));
  }
}

// Pass 1: stash[i, j] = k(x_i, z_j) for one 64 x 64 tile, and
// f_parts[blockIdx.y, i] = sum over the tile's columns of k(x_i, z_j) a_j.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
train_tiles(const float* __restrict__ x, const float* __restrict__ z,
            const float* __restrict__ a, const float* __restrict__ xnorm,
            const float* __restrict__ znorm, float* __restrict__ stash,
            float* __restrict__ f_parts, int I, int J, int D, Params p) {
  __shared__ __align__(16) float xs[BK][LDS];
  __shared__ __align__(16) float zs[BK][LDS];
  __shared__ float zn_s[BN];
  __shared__ float a_s[BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  float xn[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = row0 + ty * TM + m;
    xn[m] = (euclidean(KIND) && r < I) ? xnorm[r] : 0.0f;
  }
  float acc[TM][TN];
  accumulate_tile<KIND>(x, z, I, J, D, row0, col0, xs, zs, acc, [&] {
    if (tid < BN) {
      const int j = col0 + tid;
      a_s[tid] = j < J ? a[j] : 0.0f;
      zn_s[tid] = (euclidean(KIND) && j < J) ? znorm[j] : 0.0f;
    }
  });

  float rowacc[TM] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < TN; ++n) {
    const int cl = tx * TN + n;
    const int j = col0 + cl;
    if (j < J) {
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int r = row0 + ty * TM + m;
        const float k = tile_value<KIND>(acc[m][n], xn[m], zn_s[cl], p);
        rowacc[m] += k * a_s[cl];
        if (r < I) stash[static_cast<size_t>(r) * J + j] = k;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      rowacc[m] += __shfl_xor_sync(0xffffffffu, rowacc[m], off);
  if (tx == 0) {
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = row0 + ty * TM + m;
      if (r < I) f_parts[static_cast<size_t>(blockIdx.y) * I + r] = rowacc[m];
    }
  }
}

// Pass 2: f and v per row.
__global__ void train_rows(const float* __restrict__ f_parts, int n_col_tiles,
                           int I, float f_scale, const float* __restrict__ vy,
                           int loss, float* __restrict__ f,
                           float* __restrict__ v) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= I) return;
  float s = 0.0f;
  for (int t = 0; t < n_col_tiles; ++t)
    s += f_parts[static_cast<size_t>(t) * I + r];
  const float fr = f_scale * s;
  f[r] = fr;
  v[r] = loss == NONE ? vy[r] : loss_grad(loss, fr, vy[r]);
}

// Pass 3: g_parts[blockIdx.y, j] = sum over the block's row chunk of
// stash[i, j] * v_i; row group ty takes rows ty, ty + COL_H, ... in order.
__global__ void __launch_bounds__(COL_W * COL_H)
train_cols(const float* __restrict__ stash, const float* __restrict__ v,
           int I, int J, float* __restrict__ g_parts) {
  __shared__ float part[COL_H][COL_W + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int j = blockIdx.x * COL_W + tx;
  const int r0 = blockIdx.y * ROW_CHUNK;
  const int r1 = min(r0 + ROW_CHUNK, I);
  float s = 0.0f;
  if (j < J)
    for (int r = r0 + ty; r < r1; r += COL_H)
      s = fmaf(stash[static_cast<size_t>(r) * J + j], v[r], s);
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < J) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < COL_H; ++k) t += part[k][tx];
    g_parts[static_cast<size_t>(blockIdx.y) * J + j] = t;
  }
}

}  // namespace

extern "C" {

// Floats of scratch dsekl_train_pass needs for an (I, J) block: the stash,
// f_parts, v, the column-pass partials and the two row-norm vectors.
long long dsekl_train_scratch_floats(int I, int J) {
  const long long i = I, j = J;
  return i * j + cdiv(J, BN) * i + i + cdiv(I, ROW_CHUNK) * j + i + j;
}

// (f, g) as above.  All pointers are device pointers to contiguous float32:
// x (I, D), z (J, D), a (J,), vy (I,) (labels y for a loss, v for
// loss = -1), f (I,), g (J,), scratch (dsekl_train_scratch_floats(I, J)).
// Launches on `stream`, does not synchronise, allocates nothing.  Returns
// the cudaGetLastError() code after the launches (0 = launched), or -1 for
// a bad argument.
int dsekl_train_pass(const float* x, const float* z, const float* a,
                     const float* vy, float* f, float* g, float* scratch,
                     int I, int J, int D, int kind, float gamma, float coef0,
                     float degree, int int_degree, int degree_i,
                     float length_scale, int loss, float f_scale,
                     void* stream) {
  if (I <= 0 || J < 0 || D <= 0 || loss < NONE || loss > LOGISTIC)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p{gamma, coef0, degree, length_scale, int_degree, degree_i};
  const int n_ct = cdiv(J, BN);
  const int n_rc = cdiv(I, ROW_CHUNK);
  float* stash = scratch;
  float* f_parts = stash + static_cast<size_t>(I) * J;
  float* v = f_parts + static_cast<size_t>(n_ct) * I;
  float* g_parts = v + I;
  float* xn = g_parts + static_cast<size_t>(n_rc) * J;
  float* zn = xn + I;
  if (euclidean(kind)) {
    launch_row_norms(x, I, D, xn, s);
    if (J > 0) launch_row_norms(z, J, D, zn, s);
  }
  bool known = true;
  if (J > 0) {
    const dim3 grid(cdiv(I, BM), n_ct);
    known = with_kind(kind, [&](auto k) {
      train_tiles<decltype(k)::value><<<grid, THREADS, 0, s>>>(
          x, z, a, xn, zn, stash, f_parts, I, J, D, p);
    });
  }
  if (!known) return -1;
  train_rows<<<cdiv(I, 256), 256, 0, s>>>(f_parts, n_ct, I, f_scale, vy, loss,
                                           f, v);
  if (J > 0) {
    const dim3 grid(cdiv(J, COL_W), n_rc);
    train_cols<<<grid, dim3(COL_W, COL_H), 0, s>>>(
        stash, v, I, J, n_rc == 1 ? g : g_parts);
    if (n_rc > 1)
      sum_partials<<<cdiv(J, 256), 256, 0, s>>>(g_parts, n_rc, J, g);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dsekl_train_error_string(int code) { return error_string(code); }

}  // extern "C"
