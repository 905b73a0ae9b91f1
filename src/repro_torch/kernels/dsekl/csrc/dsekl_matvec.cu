// f = K(x, z) @ a for the seven DSEKL kernels, float32, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dsekl/block.py::kernel_matvec_pallas
// (with its tile evaluators TILE_FNS): x (I, D) queries, z (J, D) support
// rows, a (J,) dual weights -> f (I,).  K is never written to memory.
//
// Bound on this card.  The work is 2*I*J*D fp32 operations for the cross
// term (or the L1 sum of the Laplacian kernel) plus about eight per (i, j)
// for the epilogue; the bytes that must move are x, z, a and f once.  At
// the serving shape (I = 1024 queries, J ~ 283k padded support rows,
// D = 54) that is ~3.4e10 operations (0.50 ms at the H100 SXM's 67 TFLOP/s
// fp32) against ~62 MB (0.02 ms at 3.35 TB/s), so the kernel is bound by
// fp32 throughput on the CUDA cores (TF32 tensor cores would break the
// f32 tolerance), not by memory.  The support set is re-read once per
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
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int BM = 64;                         // query rows per block
constexpr int BN = 64;                         // support rows per tile
constexpr int BK = 32;                         // feature slice per stage
constexpr int TM = 4;                          // micro-tile rows per thread
constexpr int TN = 4;                          // micro-tile cols per thread
constexpr int TX = BN / TN;                    // 16 threads across columns
constexpr int THREADS = (BM / TM) * TX;        // 256
constexpr int LDS = BM + 4;                    // padded smem row (16B aligned)
static_assert(BM == BN, "staging assumes square tiles");
static_assert((BM * BK) % THREADS == 0, "staging loop must be exact");

enum Kind : int {
  RBF = 0, LAPLACIAN = 1, LINEAR = 2, POLYNOMIAL = 3, SIGMOID = 4,
  MATERN32 = 5, MATERN52 = 6,
};

struct Params {
  float gamma;
  float coef0;
  float degree;        // used by POLYNOMIAL when !int_degree
  float length_scale;
  int int_degree;      // nonzero: degree is integral, use repeated products
  int degree_i;        // the integral degree
};

__host__ __device__ constexpr bool euclidean(int k) {
  return k == RBF || k == MATERN32 || k == MATERN52;
}

// jax.lax.integer_pow: binary exponentiation in the same order, reciprocal
// for a negative exponent.  Defined for negative bases.
__device__ __forceinline__ float integer_pow(float x, int y) {
  if (y == 0) return 1.0f;
  const bool recip = y < 0;
  if (recip) y = -y;
  float acc = 0.0f;
  bool have = false;
  while (y > 0) {
    if (y & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = x * x;
  }
  return recip ? 1.0f / acc : acc;
}

// k(x_i, z_j) from the accumulated cross term (or L1 sum) and row norms.
template <int KIND>
__device__ __forceinline__ float tile_value(float acc, float xn, float zn,
                                            const Params& p) {
  if constexpr (KIND == LINEAR) {
    return acc;
  } else if constexpr (KIND == LAPLACIAN) {
    return expf(-p.gamma * acc);
  } else if constexpr (KIND == POLYNOMIAL) {
    const float b = p.gamma * acc + p.coef0;
    return p.int_degree ? integer_pow(b, p.degree_i) : powf(b, p.degree);
  } else if constexpr (KIND == SIGMOID) {
    return tanhf(p.gamma * acc + p.coef0);
  } else {
    const float d2 = fmaxf(xn + zn - 2.0f * acc, 0.0f);
    if constexpr (KIND == RBF) {
      return expf(-p.gamma * d2);
    } else {
      const float d = sqrtf(d2 + 1e-12f) / p.length_scale;
      if constexpr (KIND == MATERN32) {
        const float s = 1.7320508075688772f * d;     // f32(sqrt(3))
        return (1.0f + s) * expf(-s);
      } else {
        const float s = 2.2360679774997896f * d;     // f32(sqrt(5))
        return (1.0f + s + s * s / 3.0f) * expf(-s);
      }
    }
  }
}

// out[r] = sum_d v[r, d]^2, one warp per row, fixed shuffle order.
__global__ void row_norms(const float* __restrict__ v, int n, int d,
                          float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;
  const float* row = v + static_cast<size_t>(warp) * d;
  float s = 0.0f;
  for (int k = lane; k < d; k += 32) s = fmaf(row[k], row[k], s);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[warp] = s;
}

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
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][n] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      // Stage x[row0:+BM, k0:+BK] and z[col0:+BN, k0:+BK], transposed so
      // that a thread's TM rows / TN cols are one float4 each; zero-fill
      // past the edges.
#pragma unroll
      for (int it = 0; it < (BM * BK) / THREADS; ++it) {
        const int e = tid + it * THREADS;
        const int r = e / BK;
        const int c = e % BK;
        const int k = k0 + c;
        const int xr = row0 + r;
        const int zr = col0 + r;
        xs[c][r] = (xr < I && k < D) ? x[static_cast<size_t>(xr) * D + k] : 0.0f;
        zs[c][r] = (zr < J && k < D) ? z[static_cast<size_t>(zr) * D + k] : 0.0f;
      }
      if (k0 == 0 && tid < BN) {
        const int j = col0 + tid;
        a_s[buf][tid] = j < J ? a[j] : 0.0f;
        zn_s[buf][tid] = (euclidean(KIND) && j < J) ? znorm[j] : 0.0f;
      }
      __syncthreads();

      const int kmax = min(BK, D - k0);
#pragma unroll 8
      for (int kk = 0; kk < kmax; ++kk) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
        const float4 zv = *reinterpret_cast<const float4*>(&zs[kk][tx * TN]);
        const float xr[TM] = {xv.x, xv.y, xv.z, xv.w};
        const float zr[TN] = {zv.x, zv.y, zv.z, zv.w};
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
      __syncthreads();
    }

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

// out[r] = sum_s partials[s, r], in split order.
__global__ void sum_partials(const float* __restrict__ partials, int n_split,
                             int I, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= I) return;
  float s = 0.0f;
  for (int k = 0; k < n_split; ++k)
    s += partials[static_cast<size_t>(k) * I + r];
  out[r] = s;
}

// Calls f(std::integral_constant<int, KIND>{}) for a runtime kernel kind;
// false for an unknown kind.  The one place that maps kinds to templates.
template <typename F>
bool with_kind(int kind, F&& f) {
  switch (kind) {
    case RBF: f(std::integral_constant<int, RBF>{}); return true;
    case LAPLACIAN: f(std::integral_constant<int, LAPLACIAN>{}); return true;
    case LINEAR: f(std::integral_constant<int, LINEAR>{}); return true;
    case POLYNOMIAL: f(std::integral_constant<int, POLYNOMIAL>{}); return true;
    case SIGMOID: f(std::integral_constant<int, SIGMOID>{}); return true;
    case MATERN32: f(std::integral_constant<int, MATERN32>{}); return true;
    case MATERN52: f(std::integral_constant<int, MATERN52>{}); return true;
    default: return false;
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
    constexpr int NT = 256;                     // 8 rows per block
    row_norms<<<(I + NT / 32 - 1) / (NT / 32), NT, 0, s>>>(x, I, D, xn);
    if (J > 0)
      row_norms<<<(J + NT / 32 - 1) / (NT / 32), NT, 0, s>>>(z, J, D, zn);
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

const char* dsekl_error_string(int code) {
  return code < 0 ? "bad argument"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
