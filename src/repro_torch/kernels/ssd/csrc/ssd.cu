// Mamba-2 SSD chunked scan (forward) on Hopper (sm_90a), fp32 CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py:74 (ssd_pallas).
// Per (batch, head) and per chunk of Q positions, with cum = cumsum(dt * a)
// over the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x_j dt_j     (intra)
//         + exp(cum_i) C_i . state                                  (inter)
//   state = state * exp(cum_last) + sum_j B_j exp(cum_last - cum_j) x_j dt_j
// with the (n, hd) state carried across the chunks from zero.  The state at
// the end is returned too.
//
// Layout: the model's, read in place through strides: x (B, S, nh, hd),
// dt (B, S, nh), B and C (B, S, g, n) with head h reading group
// h / (nh / g) (no repeat), a (nh,) float32; y (B, S, nh, hd) in x's dtype
// and the final state (B, nh, hd, n) in float32.  x, dt, B, C are float32
// or bfloat16 (template T) and are converted to float32 at load, as the TPU
// kernel casts them.  hd <= 64, n <= 128, any chunk >= 1 and any S: the
// last chunk may be partial (models/ssm.ssd halves the chunk until it
// divides S instead; both compute the same function up to rounding).
//
// Design (simple first; no tensor cores yet): one block of 256 threads per
// (b, h) runs the chunks in sequence, the state in shared memory.  The
// (Q, Q) score tile does not fit at Q = 256 (256 KB in float32), so the
// intra-chunk product is tiled in 64 x 64 sub-blocks: for each row block,
// the lower-triangular column blocks are visited, their scores C B^T
// masked with the decay in shared memory, then multiplied into x dt.
// Shared memory is 48 KB at n = 16 and 134 KB at n = 128 (chunk 256).
// Grid: B * nh blocks (512 at the served jamba shape, on 132 SMs).
//
// Bound on this card: operations, at the served shape (B * nh = 512,
// S = 2048, hd = 64, n = 16, chunk 256) ~3e10 fp32 operations against
// 0.3 GB of traffic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SB = 64;      // sub-block rows and columns
constexpr int HDMAX = 64;   // head dim, padded
constexpr int LG = SB + 1;  // padded row of the score tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// NQ: state entries per thread, ceil(n * HDMAX / THREADS); 4 at n <= 16,
// 32 at n <= 128 (a register array: it sets the kernel's register count).
template <typename T, int NQ>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, T* __restrict__ y,
           float* __restrict__ final_state, int S, int nh, int hd, int g,
           int n, int chunk) {
  extern __shared__ float smem[];
  const int NP = n + 1;
  float* cum = smem;                 // chunk
  float* dts = cum + chunk;          // chunk
  float* st = dts + chunk;           // n x HDMAX
  float* cs = st + n * HDMAX;        // SB x NP
  float* bs = cs + SB * NP;          // SB x NP
  float* xs = bs + SB * NP;          // SB x HDMAX
  float* gs = xs + SB * HDMAX;       // SB x LG

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int grp = h / (nh / g);
  const float a_h = a[h];
  const long long x_pos = (long long)nh * hd;   // stride between positions
  const long long bc_pos = (long long)g * n;
  const T* xb = x + (long long)b * S * x_pos + (long long)h * hd;
  const T* dtb = dt + (long long)b * S * nh + h;
  const T* bb = bm + (long long)b * S * bc_pos + (long long)grp * n;
  const T* cb = cm + (long long)b * S * bc_pos + (long long)grp * n;
  T* yb = y + (long long)b * S * x_pos + (long long)h * hd;

  for (int e = tid; e < n * HDMAX; e += THREADS) st[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int L = min(chunk, S - c0);
    __syncthreads();  // the previous chunk is done with cum, dts, st
    for (int j = tid; j < L; j += THREADS) dts[j] = to_f32(dtb[(long long)(c0 + j) * nh]);
    __syncthreads();
    if (tid < 32) {   // cum = inclusive prefix sum of dt * a, one warp
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int j = base + tid;
        float val = j < L ? dts[j] * a_h : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(0xffffffffu, val, off);
          if (tid >= off) val += o;
        }
        val += carry;
        if (j < L) cum[j] = val;
        carry = __shfl_sync(0xffffffffu, val, 31);
      }
    }
    __syncthreads();

    const int n_sb = (L + SB - 1) / SB;
    for (int ib = 0; ib < n_sb; ++ib) {
      const int i0 = ib * SB;
      __syncthreads();  // cs, gs, xs of the previous row block are done
      for (int e = tid; e < SB * n; e += THREADS) {
        const int r = e / n, k = e % n;
        cs[r * NP + k] = i0 + r < L ? to_f32(cb[(long long)(c0 + i0 + r) * bc_pos + k]) : 0.f;
      }
      __syncthreads();

      // Inter-chunk term from the state before this chunk.
      float yacc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = ty * 4 + ii;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) yacc[ii][jj] = 0.f;
        for (int k = 0; k < n; ++k) {
          const float c = cs[r * NP + k];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            yacc[ii][jj] = fmaf(c, st[k * HDMAX + tx + 16 * jj], yacc[ii][jj]);
        }
        const float w = i0 + r < L ? expf(cum[i0 + r]) : 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) yacc[ii][jj] *= w;
      }

      // Intra-chunk term over the column blocks jb <= ib.
      for (int jb = 0; jb <= ib; ++jb) {
        const int j0 = jb * SB;
        __syncthreads();  // gs and xs of the previous column block are done
        for (int e = tid; e < SB * n; e += THREADS) {
          const int r = e / n, k = e % n;
          bs[r * NP + k] = j0 + r < L ? to_f32(bb[(long long)(c0 + j0 + r) * bc_pos + k]) : 0.f;
        }
        for (int e = tid; e < SB * HDMAX; e += THREADS) {
          const int r = e / HDMAX, p = e % HDMAX;
          float val = 0.f;
          if (j0 + r < L && p < hd)
            val = to_f32(xb[(long long)(c0 + j0 + r) * x_pos + p]) * dts[j0 + r];
          xs[r * HDMAX + p] = val;
        }
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = 0.f;
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) cv[ii] = cs[(ty * 4 + ii) * NP + k];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) bv[jj] = bs[(tx + 16 * jj) * NP + k];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = fmaf(cv[ii], bv[jj], sc[ii][jj]);
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = i0 + ty * 4 + ii;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = j0 + tx + 16 * jj;
            const float w = (j <= i && i < L) ? expf(cum[i] - cum[j]) : 0.f;
            gs[(ty * 4 + ii) * LG + tx + 16 * jj] = sc[ii][jj] * w;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < SB; ++c) {
          float xv[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) xv[jj] = xs[c * HDMAX + tx + 16 * jj];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float gv = gs[(ty * 4 + ii) * LG + c];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) yacc[ii][jj] = fmaf(gv, xv[jj], yacc[ii][jj]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + ty * 4 + ii;
        if (i >= L) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int p = tx + 16 * jj;
          if (p < hd) store_out(&yb[(long long)(c0 + i) * x_pos + p], yacc[ii][jj]);
        }
      }
    }

    // State update: decay to the chunk's end, absorb its outer sums.
    const float cum_last = cum[L - 1];
    float sacc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) sacc[q] = 0.f;
    for (int jb = 0; jb < n_sb; ++jb) {
      const int j0 = jb * SB;
      __syncthreads();  // every reader of bs, xs and st is done
      for (int e = tid; e < SB * n; e += THREADS) {
        const int r = e / n, k = e % n;
        bs[r * NP + k] = j0 + r < L ? to_f32(bb[(long long)(c0 + j0 + r) * bc_pos + k]) : 0.f;
      }
      for (int e = tid; e < SB * HDMAX; e += THREADS) {
        const int r = e / HDMAX, p = e % HDMAX;
        float val = 0.f;
        if (j0 + r < L && p < hd)
          val = to_f32(xb[(long long)(c0 + j0 + r) * x_pos + p]) * dts[j0 + r]
                * expf(cum_last - cum[j0 + r]);
        xs[r * HDMAX + p] = val;
      }
      __syncthreads();
      const int rows = min(SB, L - j0);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int e = tid + THREADS * q;
        if (e < n * HDMAX) {  // no break: keeps sacc in registers
          const int k = e / HDMAX, p = e % HDMAX;
          float s = sacc[q];
          for (int r = 0; r < rows; ++r) s = fmaf(bs[r * NP + k], xs[r * HDMAX + p], s);
          sacc[q] = s;
        }
      }
    }
    const float tot = expf(cum_last);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int e = tid + THREADS * q;
      if (e < n * HDMAX) st[e] = st[e] * tot + sacc[q];
    }
  }
  __syncthreads();
  float* fb = final_state + ((long long)b * nh + h) * hd * n;
  for (int e = tid; e < hd * n; e += THREADS) {
    const int p = e / n, k = e % n;
    fb[e] = st[k * HDMAX + p];
  }
}

template <typename T, int NQ>
cudaError_t launch(const void* x, const void* dt, const float* a,
                   const void* bm, const void* cm, void* y, float* fs, int B,
                   int S, int nh, int hd, int g, int n, int chunk,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * chunk + (size_t)n * HDMAX
                                       + (size_t)2 * SB * (n + 1)
                                       + (size_t)SB * HDMAX + (size_t)SB * LG);
  auto kernel = ssd_kernel<T, NQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * nh, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), fs, S, nh, hd, g, n, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, nh, hd), dt (B, S, nh), bm/cm (B, S, g, n), y (B, S, nh, hd): one
// dtype, 0 = float32 or 1 = bfloat16; a (nh,) and final (B, nh, hd, n)
// float32; all contiguous.  1 <= hd <= 64, 1 <= n <= 128, nh % g == 0,
// 1 <= chunk <= 4096 (the wrapper checks).  Returns a cudaError_t.
int ssd_fwd(const void* x, const void* dt, const float* a, const void* bm,
            const void* cm, void* y, float* final_state, int dtype, int B,
            int S, int nh, int hd, int g, int n, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return n <= 16 ? launch<float, 4>(x, dt, a, bm, cm, y, final_state, B, S,
                                      nh, hd, g, n, chunk, st)
                   : launch<float, 32>(x, dt, a, bm, cm, y, final_state, B,
                                       S, nh, hd, g, n, chunk, st);
  }
  return n <= 16 ? launch<__nv_bfloat16, 4>(x, dt, a, bm, cm, y, final_state,
                                            B, S, nh, hd, g, n, chunk, st)
                 : launch<__nv_bfloat16, 32>(x, dt, a, bm, cm, y,
                                             final_state, B, S, nh, hd, g, n,
                                             chunk, st);
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
