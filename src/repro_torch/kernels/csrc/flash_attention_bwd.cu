// Flash-attention backward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// The JAX package has no Pallas backward: in train mode it differentiates
// its jnp `blockwise_attention` (src/repro/models/layers.py:137) with
// `jax.grad`.  This kernel is the port's counterpart of that gradient for
// the forward in flash_attention.cu, over the mask menu training uses
// (causal, sliding window, prefix-LM, logit softcap; q_offset = 0, no cache
// fill level).  With x = cap * tanh(scale q.k / cap) (or scale q.k), the
// forward's row log-sum-exp lse and delta = rowsum(dO * O):
//
//   P  = exp(x - lse)          (0 where masked or where the row sees no key)
//   dV = P^T dO                dP = dO V^T
//   dX = P * (dP - delta)      dS = dX * (1 - (x / cap)^2)   (dS = dX uncapped)
//   dQ = scale * dS K          dK = scale * dS^T Q
//
// Layout (the JAX package's): q, o, dO, dq (B, Tq, KVH, G, D); k, v, dk, dv
// (B, Tk, KVH, D); lse, delta fp32 (B, Tq, KVH, G).  fp32 or bf16 in and out,
// fp32 arithmetic.  D <= 128, G <= 64.
//
// What bounds it on the card: five products of 2*D operations per visible
// (query, key) pair and query head, against the bytes of q, k, v, o, dO, lse
// and the three gradients: at the training shape (smollm-360m, B=2, T=512,
// KVH=5, G=3, D=64, fp32) ~1.6 GFLOP against ~12 MB, far above the 20 FLOP
// per byte where fp32 on the CUDA cores stops being memory-bound.  So the
// design spends shared memory on operand reuse, keeps every sum in registers
// and is deterministic (no atomics):
//   * bwd_preprocess: delta = rowsum(dO * O), one warp per row;
//   * bwd_dkdv: one CTA per (batch, kv head, 64-key tile) holds K, V and the
//     dK, dV accumulators, and loops over the query tiles that can see the
//     key tile.  A query tile holds 64 rows = positions x all G heads of the
//     kv head (the forward's GQA grouping), so each K/V tile serves G heads
//     and dK, dV sum over the group without a second pass;
//   * bwd_dq: one CTA per (batch, kv head, query tile) holds Q, dO and the dQ
//     accumulator, and loops over the key tiles the forward visited.
// Both recompute S and P from lse instead of storing the T x T matrix.  Like
// the forward, this first version multiplies on the CUDA cores (4x4 register
// tiles over padded shared memory); wgmma and TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;        // query rows per tile: (position, head) pairs
constexpr int kBlockK = 64;      // keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 scores each

struct Params {
  int B, Tq, Tk, KVH, G, D;
  int causal;
  int has_window, window;
  int has_prefix, prefix_len;
  int has_cap;
  float cap;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  bool ok = kp < p.Tk;
  if (p.causal) ok = ok && (kp <= qp || (p.has_prefix && kp < p.prefix_len));
  if (p.has_window) ok = ok && (qp - kp < p.window);
  return ok;
}

// Offset of query row r of the tile starting at position t0: (t0 + r/G, r%G).
__device__ __forceinline__ size_t q_row(const Params& p, int b, int h, int t0,
                                        int r) {
  return (((size_t)b * p.Tq + t0 + r / p.G) * p.KVH + h) * (size_t)p.G +
         (size_t)(r % p.G);
}

// Stage a query tile: q (pre-scaled), dO, lse and delta, zero past n_rows.
template <typename T, int DP>
__device__ __forceinline__ void load_q_tile(
    const Params& p, const T* q, const T* dout, const float* lse,
    const float* delta, int b, int h, int t0, int n_rows, float* q_s,
    float* do_s, float* lse_s, float* dl_s) {
  constexpr int LD = DP + 1;
  for (int idx = threadIdx.x; idx < kRows * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    float qx = 0.f, dx = 0.f;
    if (r < n_rows && d < p.D) {
      const size_t off = q_row(p, b, h, t0, r) * p.D + d;
      qx = to_float(q[off]) * p.scale;
      dx = to_float(dout[off]);
    }
    q_s[r * LD + d] = qx;
    do_s[r * LD + d] = dx;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const bool ok = r < n_rows;
    lse_s[r] = ok ? lse[q_row(p, b, h, t0, r)] : -INFINITY;
    dl_s[r] = ok ? delta[q_row(p, b, h, t0, r)] : 0.f;
  }
}

template <typename T, int DP>
__device__ __forceinline__ void load_kv_tile(const Params& p, const T* k,
                                             const T* v, int b, int h, int k0,
                                             float* k_s, float* v_s) {
  constexpr int LD = DP + 1;
  for (int idx = threadIdx.x; idx < kBlockK * DP; idx += kThreads) {
    const int c = idx / DP, d = idx % DP;
    float kx = 0.f, vx = 0.f;
    if (k0 + c < p.Tk && d < p.D) {
      const size_t off = (((size_t)b * p.Tk + k0 + c) * p.KVH + h) * p.D + d;
      kx = to_float(k[off]);
      vx = to_float(v[off]);
    }
    k_s[c * LD + d] = kx;
    v_s[c * LD + d] = vx;
  }
}

// For the staged tiles, P and dS of rows ty + 16 i, keys tx + 16 j into
// p_s (if given) and ds_s.
template <int DP>
__device__ __forceinline__ void scores(const Params& p, int t0, int n_rows,
                                       int k0, const float* q_s,
                                       const float* do_s, const float* k_s,
                                       const float* v_s, const float* lse_s,
                                       const float* dl_s, float* p_s,
                                       float* ds_s) {
  constexpr int LD = DP + 1;
  constexpr int LDS = kBlockK + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = q_s[(ty + 16 * i) * LD + d];
      oa[i] = do_s[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = k_s[(tx + 16 * j) * LD + d];
      vb[j] = v_s[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = t0 + r / p.G;
    const float lse = lse_s[r], dl = dl_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float x = s[i][j];
      if (p.has_cap) x = tanhf(x / p.cap) * p.cap;
      const bool ok = r < n_rows && lse != -INFINITY && visible(p, qp, k0 + c);
      const float pr = ok ? expf(x - lse) : 0.f;
      float ds = pr * (dp[i][j] - dl);
      if (p.has_cap) {
        const float t = x / p.cap;
        ds *= 1.f - t * t;
      }
      if (p_s != nullptr) p_s[r * LDS + c] = pr;
      ds_s[r * LDS + c] = ds;
    }
  }
}

// delta = rowsum(dO * O), one warp per row of D.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_preprocess(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ delta, long long rows, int D) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_float(o[row * D + d]), to_float(dout[row * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, Params p) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 1;
  constexpr int LDS = kBlockK + 1;
  constexpr int DJ = DP / 16;
  float* k_s = smem;                  // kBlockK x LD
  float* v_s = k_s + kBlockK * LD;    // kBlockK x LD
  float* q_s = v_s + kBlockK * LD;    // kRows x LD, pre-scaled
  float* do_s = q_s + kRows * LD;     // kRows x LD
  float* p_s = do_s + kRows * LD;     // kRows x LDS
  float* ds_s = p_s + kRows * LDS;    // kRows x LDS
  float* lse_s = ds_s + kRows * LDS;  // kRows
  float* dl_s = lse_s + kRows;        // kRows

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kBlockK;
  const int bq = kRows / p.G;
  load_kv_tile<T, DP>(p, k, v, b, h, k0, k_s, v_s);

  // query positions that see at least one key of this tile
  const int kmax = min(k0 + kBlockK, p.Tk) - 1;
  int qlo = 0, qhi = p.Tq;
  if (p.causal && !(p.has_prefix && k0 < p.prefix_len)) qlo = k0;
  if (p.has_window) qhi = min(qhi, kmax + p.window);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int qt = qlo / bq; qt * bq < qhi; ++qt) {
    const int t0 = qt * bq;
    const int n_rows = min(bq, p.Tq - t0) * p.G;
    __syncthreads();   // the previous tile's products are done with smem
    load_q_tile<T, DP>(p, q, dout, lse, delta, b, h, t0, n_rows, q_s, do_s,
                       lse_s, dl_s);
    __syncthreads();
    scores<DP>(p, t0, n_rows, k0, q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s);
    __syncthreads();
    // dV[c] += sum_r P[r][c] dO[r];  dK[c] += sum_r dS[r][c] (scale q)[r]
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float pa[4], sa[4], ob[DJ], qb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = p_s[r * LDS + ty + 16 * i];
        sa[i] = ds_s[r * LDS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ob[j] = do_s[r * LD + tx + 16 * j];
        qb[j] = q_s[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dva[i][j] = fmaf(pa[i], ob[j], dva[i][j]);
          dka[i][j] = fmaf(sa[i], qb[j], dka[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    if (k0 + c >= p.Tk) continue;
    const size_t row = (((size_t)b * p.Tk + k0 + c) * p.KVH + h) * p.D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) {
        store(dk + row + d, dka[i][j]);
        store(dv + row + d, dva[i][j]);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, Params p) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 1;
  constexpr int LDS = kBlockK + 1;
  constexpr int DJ = DP / 16;
  float* q_s = smem;                  // kRows x LD, pre-scaled
  float* do_s = q_s + kRows * LD;     // kRows x LD
  float* k_s = do_s + kRows * LD;     // kBlockK x LD
  float* v_s = k_s + kBlockK * LD;    // kBlockK x LD
  float* ds_s = v_s + kBlockK * LD;   // kRows x LDS
  float* lse_s = ds_s + kRows * LDS;  // kRows
  float* dl_s = lse_s + kRows;        // kRows

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bq = kRows / p.G;
  const int t0 = qt * bq;
  const int n_pos = min(bq, p.Tq - t0);
  const int n_rows = n_pos * p.G;
  load_q_tile<T, DP>(p, q, dout, lse, delta, b, h, t0, n_rows, q_s, do_s,
                     lse_s, dl_s);

  // the forward's key range for this tile
  int hi = p.Tk;
  if (p.causal) {
    int lim = t0 + n_pos;
    if (p.has_prefix) lim = max(lim, p.prefix_len);
    hi = min(hi, lim);
  }
  int lo = 0;
  if (p.has_window) lo = max(0, t0 - p.window + 1);
  lo = (lo / kBlockK) * kBlockK;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float dqa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqa[i][j] = 0.f;

  for (int k0 = lo; k0 < hi; k0 += kBlockK) {
    __syncthreads();   // the previous tile's dS K is done with smem
    load_kv_tile<T, DP>(p, k, v, b, h, k0, k_s, v_s);
    __syncthreads();
    scores<DP>(p, t0, n_rows, k0, q_s, do_s, k_s, v_s, lse_s, dl_s, nullptr,
               ds_s);
    __syncthreads();
    // dQ[r] += sum_c dS[r][c] K[c]
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float sa[4], kb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = ds_s[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kb[j] = k_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dqa[i][j] = fmaf(sa[i], kb[j], dqa[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= n_rows) continue;
    const size_t row = q_row(p, b, h, t0, r) * p.D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) store(dq + row + d, dqa[i][j] * p.scale);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, const Params& p, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);

  const long long rows = (long long)p.B * p.Tq * p.KVH * p.G;
  const long long nb = (rows + kThreads / 32 - 1) / (kThreads / 32);
  bwd_preprocess<T><<<(unsigned)nb, kThreads, 0, stream>>>(
      static_cast<const T*>(o), do_, delta, rows, p.D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t tiles = (size_t)(kRows + kBlockK) * 2 * (DP + 1);
  const size_t smem_kv =
      sizeof(float) * (tiles + 2 * (size_t)kRows * (kBlockK + 1) + 2 * kRows);
  const size_t smem_q =
      sizeof(float) * (tiles + (size_t)kRows * (kBlockK + 1) + 2 * kRows);
  // above 48 KB only after opting in (per device, so on every launch)
  e = cudaFuncSetAttribute(bwd_dkdv<T, DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dq<T, DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_q);
  if (e != cudaSuccess) return e;

  const dim3 grid_kv((p.Tk + kBlockK - 1) / kBlockK, p.KVH, p.B);
  bwd_dkdv<T, DP><<<grid_kv, kThreads, smem_kv, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int bq = kRows / p.G;
  const dim3 grid_q((p.Tq + bq - 1) / bq, p.KVH, p.B);
  bwd_dq<T, DP><<<grid_q, kThreads, smem_q, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv,
                       const Params& p, cudaStream_t s) {
  if (p.D <= 16)
    return launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (p.D <= 32)
    return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (p.D <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtype: 0 = fp32, 1 = bf16.
// lse: the forward's fp32 row log-sum-exp; delta: fp32 scratch of the same
// (B, Tq, KVH, G) shape.  Three launches on `stream`: delta, dK/dV, dQ.
// Returns the first failing cudaError_t (0 = cudaSuccess); shapes the kernel
// does not take return cudaErrorInvalidValue without launching.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Tq, int Tk, int KVH, int G, int D,
    int causal, int has_window, int window, int has_prefix, int prefix_len,
    int has_cap, float cap, float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || KVH < 1 || G < 1 || G > kRows || D < 1 ||
      D > 128 || KVH > 65535 || B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Params p{B,          Tq,     Tk,         KVH,     G,   D,     causal,
                 has_window, window, has_prefix, prefix_len, has_cap, cap,
                 scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const cudaError_t e =
      dtype == 0
          ? dispatch_d<float>(q, k, v, o, dout, l, dl, dq, dk, dv, p, s)
          : dispatch_d<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, p,
                                      s);
  return (int)e;
}
