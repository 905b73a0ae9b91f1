// Shared tile machinery of the DSEKL kernels (dsekl_matvec.cu,
// dsekl_train.cu): the kernel kinds and their hyperparameters, the seven
// k(x_i, z_j) epilogues (the port's TILE_FNS on the card), the staging
// loop that accumulates a BM x BN tile's cross term (or L1 sum) in
// registers, the row-norm pass and the fixed-order partial sum.
//
// Everything here has internal linkage: each .cu is its own shared
// library, and each includes this header once.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int BM = 64;                         // x rows per tile
constexpr int BN = 64;                         // z rows per tile
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

// acc[m][n] = sum_d x[row0 + ty*TM + m, d] * z[col0 + tx*TN + n, d] (or the
// L1 sum |x - z| for the Laplacian), for the calling thread's TM x TN
// micro-tile of a THREADS-thread block.  x and z are staged through shared
// memory in BK-wide slices of D, transposed so that a thread's TM rows /
// TN cols are one float4 each, zero-filled past the edges.
// first_stage() runs once, after the first slice is staged and before its
// barrier: the caller stages its per-tile vectors there, and they are
// visible to the whole block when this returns (D > 0).
template <int KIND, typename F>
__device__ __forceinline__ void accumulate_tile(
    const float* __restrict__ x, const float* __restrict__ z, int I, int J,
    int D, int row0, int col0, float (&xs)[BK][LDS], float (&zs)[BK][LDS],
    float (&acc)[TM][TN], F&& first_stage) {
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
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
    if (k0 == 0) first_stage();
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

// Launches row_norms over the n rows of v (n > 0).
inline void launch_row_norms(const float* v, int n, int d, float* out,
                             cudaStream_t s) {
  constexpr int NT = 256;                       // 8 rows per block
  row_norms<<<(n + NT / 32 - 1) / (NT / 32), NT, 0, s>>>(v, n, d, out);
}

// out[r] = sum_s partials[s, r], in split order.
__global__ void sum_partials(const float* __restrict__ partials, int n_split,
                             int n, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float s = 0.0f;
  for (int k = 0; k < n_split; ++k)
    s += partials[static_cast<size_t>(k) * n + r];
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

const char* error_string(int code) {
  return code < 0 ? "bad argument"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace
