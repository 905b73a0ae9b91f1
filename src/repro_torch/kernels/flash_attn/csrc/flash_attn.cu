// Flash-attention forward on Hopper (sm_90a), fp32 CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py:72
// (flash_attention_pallas): softmax(q k^T / sqrt(D), masked) @ v with an
// online softmax, the (S, T) score matrix never in device memory.  The
// mask is built from absolute positions: key kpos is valid for query qpos
// when (qpos - kpos) < window and, if causal, kpos <= qpos.  A masked score
// is -1e30, as in the TPU kernel, so a row with no valid key gets the mean
// of v over all T keys (the TPU kernel's l > 0 there, not 0).
//
// Layout: the model's (B, S, H, D) for q and o and (B, T, KV, D) for k and
// v, read in place through strides: query head h reads kv head
// h / (H / KV) (GQA without repeating k and v).  Inputs are float32 or
// bfloat16 (template T), converted to float32 at load; o is written in q's
// dtype.  Any S and T: tail rows and columns are masked (a tail column is
// left out, p = 0; it is not a masked key).
//
// Design (simple first; no tensor cores, no TMA, no wgmma yet):
//   * one block of 256 threads per (64 query rows, b * H + h); it walks the
//     key tiles of 64 in order, as the TPU grid's innermost dimension did;
//   * shared memory: the Q tile, one K-or-V tile (K for the scores, then V
//     for p @ v) and the 64 x 64 probability tile, in float32: 82.7 KB at
//     D <= 128, so two blocks fit on an SM;
//   * each thread owns a 4 x 4 block of scores and a 4 x (DMAX / 16) block
//     of the output; the 16 threads of a row reduce max and sum with warp
//     shuffles;
//   * a key tile whose (query, key) rectangle holds no valid pair is
//     skipped, but only when every row of the block has a valid key
//     somewhere: a fully masked tile then contributes exp(-1e30 - m) = 0
//     once a valid tile has set m, and before that its sums are wiped by
//     alpha = exp(-1e30 - m) = 0, so skipping it changes no bit.  A block
//     holding a row with no valid key visits every tile, as the TPU does.
//
// Bound on this card: operations.  At the served shape (B 4, H 32, S = T =
// 2048, D 128, causal) the valid pairs need 4 D flops each: 1.4e11 fp32
// operations against 0.2 GB of traffic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Whether some (qpos, kpos) in [q0, q1) x [k0, k1) is a valid pair.  The
// differences qpos - kpos over the rectangle are the whole integer interval
// [q0 - (k1 - 1), (q1 - 1) - k0]; the mask allows [0 or -inf, window - 1].
__device__ __forceinline__ bool any_valid(long long q0, long long q1,
                                          long long k0, long long k1,
                                          bool causal, long long window) {
  long long lo = q0 - (k1 - 1);
  long long hi = (q1 - 1) - k0;
  if (causal && lo < 0) lo = 0;
  if (hi > window - 1) hi = window - 1;
  return lo <= hi;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int H, int KV, int D, bool causal, long long window,
                 float scale) {
  constexpr int LD = DMAX + 1;   // padded rows: no bank conflicts
  constexpr int LP = BK + 1;
  constexpr int DC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // BQ x LD
  float* kvs = qs + BQ * LD;     // BK x LD: K, then V
  float* ps = kvs + BK * LD;     // BQ x LP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int q1 = min(q0 + BQ, S);
  const long long q_stride = (long long)H * D;       // between positions
  const long long kv_stride = (long long)KV * D;
  const T* qb = q + (long long)b * S * q_stride + (long long)h * D;
  const T* kb = k + (long long)b * Tk * kv_stride + (long long)kvh * D;
  const T* vb = v + (long long)b * Tk * kv_stride + (long long)kvh * D;

  for (int e = tid; e < BQ * DMAX; e += THREADS) {
    const int r = e / DMAX, c = e % DMAX;
    float val = 0.f;
    if (q0 + r < S && c < D) val = to_f32(qb[(q0 + r) * q_stride + c]);
    qs[r * LD + c] = val;
  }
  bool rows_ok = true;
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < S && !any_valid(r, r + 1, 0, Tk, causal, window)) rows_ok = false;
  }
  const bool may_skip = __syncthreads_and(rows_ok);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (Tk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const int k1 = min(k0 + BK, Tk);
    if (may_skip && !any_valid(q0, q1, k0, k1, causal, window)) continue;
    __syncthreads();  // the previous tile's V is no longer read
    for (int e = tid; e < BK * DMAX; e += THREADS) {
      const int r = e / DMAX, c = e % DMAX;
      float val = 0.f;
      if (k0 + r < Tk && c < D) val = to_f32(kb[(k0 + r) * kv_stride + c]);
      kvs[r * LD + c] = val;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DMAX; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kvs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q0 + ty * 4 + i;
      float mc = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k0 + tx + 16 * j;
        float val;
        if (kpos >= Tk) {
          val = -CUDART_INF_F;  // a tail column: no key at all
        } else {
          const bool valid = (qpos - kpos) < window && (!causal || kpos <= qpos);
          val = valid ? s[i][j] * scale : NEG_INF;
        }
        s[i][j] = val;
        mc = fmaxf(mc, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the scores are done with K; P is written
    for (int e = tid; e < BK * DMAX; e += THREADS) {
      const int r = e / DMAX, c = e % DMAX;
      float val = 0.f;
      if (k0 + r < Tk && c < D) val = to_f32(vb[(k0 + r) * kv_stride + c]);
      kvs[r * LD + c] = val;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = kvs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * LP + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = o + (long long)b * S * q_stride + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store_out(&ob[r * q_stride + c], acc[i][j] / li);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int KV, int D, int causal,
                   long long window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * BQ * (DMAX + 1) + BQ * (BK + 1));
  auto kernel = flash_fwd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, KV, D,
      causal != 0, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, D), k/v (B, T, KV, D), o (B, S, H, D), contiguous, all of
// dtype 0 = float32 or 1 = bfloat16; 1 <= D <= 128, H % KV == 0, S, T >= 1,
// B * H < 2**31 and ceil(S / 64) < 65536 (the wrapper checks).  Returns a
// cudaError_t (0 = launched).
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   int dtype, int B, int S, int Tk, int H, int KV, int D,
                   int causal, long long window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return D <= 64 ? launch<float, 64>(q, k, v, o, B, S, Tk, H, KV, D, causal,
                                       window, scale, st)
                   : launch<float, 128>(q, k, v, o, B, S, Tk, H, KV, D,
                                        causal, window, scale, st);
  }
  return D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, S, Tk, H, KV, D,
                                             causal, window, scale, st)
                 : launch<__nv_bfloat16, 128>(q, k, v, o, B, S, Tk, H, KV, D,
                                              causal, window, scale, st);
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
