// Flash-attention forward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_flash_kernel`) in
// src/repro/kernels/flash_attention.py.  Same function: online-softmax GQA
// attention with the causal, sliding-window, prefix-LM and logit-softcap
// masks and fp32 running max / sum / accumulator, plus the `q_offset` and
// `k_valid_len` of the model's blockwise attention.  The ragged q and k
// edges are masked here by the true lengths: the wrapper pads nothing.
//
// Layout (the JAX package's): q (B, Tq, KVH, G, D), k and v (B, Tk, KVH, D),
// all contiguous, fp32 or bf16 (template), output like q.  D <= 256, G <= 64.
//
// What bounds it on the card: at the serving prefill shape (smollm-360m,
// B=4, T=512, KVH=5, G=3, D=64, fp32) the causal work is ~2.0 GFLOP against
// ~21 MB of q/k/v/o traffic, i.e. ~95 FLOP per byte, far above the H100's
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte for fp32 outside the tensor cores.
// So it is bounded by arithmetic, and the design spends its shared memory on
// reusing operands, not on streaming:
//   * one CTA per (batch, kv head, q tile) holds ALL G query heads of that
//     kv head (64 rows = q positions x G), so every K/V tile it stages in
//     shared memory feeds G heads instead of one;
//   * the KV dimension, a sequential grid axis on the TPU, is a loop inside
//     the CTA with the online-softmax state in registers and shared memory;
//   * under `causal` the loop stops at the q tile's last position (or the
//     prefix, if larger), under `window` it starts at the first key the
//     tile's first row can see: tiles wholly masked are never loaded.
// This first version uses fp32 FMAs on the CUDA cores (4x4 register tiles
// over padded, bank-conflict-free shared memory); wgmma and TMA come later.
//
// For training, the kernel also writes each row's log-sum-exp of the scaled
// (and capped) scores, lse = m + log(l), -inf for a row that sees no key, to
// an optional fp32 array laid out like q without D: (B, Tq, KVH, G).  The
// backward kernel (flash_attention_bwd.cu) recomputes P = exp(S - lse) from
// it.  Prefill passes no array and writes nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;        // query rows per CTA: (position, head) pairs
constexpr int kBlockK = 64;      // keys per KV tile
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr float kNegInit = -1e30f;  // reference's running-max init / mask

struct Params {
  int B, Tq, Tk, KVH, G, D;
  int causal;
  int has_window, window;
  int has_prefix, prefix_len;
  int has_cap;
  float cap;
  float scale;
  int q_offset;
  int has_kvl, k_valid_len;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Params p) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 1;          // odd stride: column reads hit 16 banks
  constexpr int LDS = kBlockK + 1;
  constexpr int DJ = DP / 16;         // output columns per thread
  float* q_s = smem;                  // kRows x LD, pre-scaled
  float* k_s = q_s + kRows * LD;      // kBlockK x LD
  float* v_s = k_s + kBlockK * LD;    // kBlockK x LD
  float* s_s = v_s + kBlockK * LD;    // kRows x LDS: scores, then P
  float* m_s = s_s + kRows * LDS;     // running max per row
  float* l_s = m_s + kRows;           // running sum per row
  float* c_s = l_s + kRows;           // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = p.G, D = p.D;
  const int bq = kRows / G;                  // q positions per CTA
  const int t0 = qt * bq;
  const int n_pos = min(bq, p.Tq - t0);
  const int n_rows = n_pos * G;              // row r <-> (t0 + r / G, r % G)

  for (int idx = tid; idx < kRows * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    float x = 0.f;
    if (r < n_rows && d < D) {
      const size_t off =
          (((size_t)b * p.Tq + t0 + r / G) * p.KVH + h) * (size_t)G * D +
          (size_t)(r % G) * D + d;
      x = to_float(q[off]) * p.scale;
    }
    q_s[r * LD + d] = x;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInit;
    l_s[tid] = 0.f;
  }

  // KV tiles that hold at least one visible key for some row of this CTA.
  const int qp_min = p.q_offset + t0;
  const int qp_max = p.q_offset + t0 + n_pos - 1;
  int hi = p.Tk;
  if (p.has_kvl) hi = min(hi, p.k_valid_len);
  if (p.causal) {
    int lim = qp_max + 1;
    if (p.has_prefix) lim = max(lim, p.prefix_len);
    hi = min(hi, lim);
  }
  int lo = 0;
  if (p.has_window) lo = max(0, qp_min - p.window + 1);
  lo = (lo / kBlockK) * kBlockK;

  const int ty = tid / 16, tx = tid % 16;    // rows ty + 16 i, cols tx + 16 j
  const int warp = tid / 32, lane = tid % 32;
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = p.q_offset + t0 + (ty + 16 * i) / G;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = lo; k0 < hi; k0 += kBlockK) {
    __syncthreads();   // the previous tile's P.V is done with k_s/v_s/s_s
    for (int idx = tid; idx < kBlockK * DP; idx += kThreads) {
      const int c = idx / DP, d = idx % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < p.Tk && d < D) {
        const size_t off =
            (((size_t)b * p.Tk + k0 + c) * p.KVH + h) * (size_t)D + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      k_s[c * LD + d] = kx;
      v_s[c * LD + d] = vx;
    }
    __syncthreads();

    // S = (scale Q) K^T on a 4 x 4 register tile per thread.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c, qp = qpos[i];
        float x = s[i][j];
        if (p.has_cap) x = tanhf(x / p.cap) * p.cap;
        bool ok = kp < p.Tk;
        if (p.has_kvl) ok = ok && kp < p.k_valid_len;
        if (p.causal)
          ok = ok && (kp <= qp || (p.has_prefix && kp < p.prefix_len));
        if (p.has_window) ok = ok && (qp - kp < p.window);
        s_s[(ty + 16 * i) * LDS + c] = ok ? x : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax: warp w owns rows 8w .. 8w+7, two columns per lane.
    // A masked score is -inf here and contributes p = 0, as the reference's
    // where(mask, exp(s - m_new), 0) does.
#pragma unroll
    for (int rr = 0; rr < kRows / 8; ++rr) {
      const int r = warp * (kRows / 8) + rr;
      const float s0 = s_s[r * LDS + lane], s1 = s_s[r * LDS + lane + 32];
      const float m_prev = m_s[r];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = (s0 == -INFINITY) ? 0.f : expf(s0 - m_new);
      const float p1 = (s1 == -INFINITY) ? 0.f : expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      s_s[r * LDS + lane] = p0;
      s_s[r * LDS + lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pa[4], vb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = s_s[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vb[j] = v_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }
  __syncthreads();   // l_s is final (also when no tile was visible)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= n_rows) continue;
    const float l = fmaxf(l_s[r], 1e-30f);   // fully masked rows give 0
    const size_t row =
        (((size_t)b * p.Tq + t0 + r / G) * p.KVH + h) * (size_t)G * D +
        (size_t)(r % G) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(o + row + d, acc[i][j] / l);
    }
  }
  if (lse != nullptr && tid < n_rows) {
    const float l = l_s[tid];
    const size_t row =
        (((size_t)b * p.Tq + t0 + tid / G) * p.KVH + h) * (size_t)G + tid % G;
    lse[row] = l > 0.f ? m_s[tid] + logf(l) : -INFINITY;
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kRows + 2 * kBlockK) * (DP + 1) +
                       (size_t)kRows * (kBlockK + 1) + 3 * kRows);
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int bq = kRows / p.G;
  const dim3 grid((p.Tq + bq - 1) / bq, p.KVH, p.B);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, const Params& p, cudaStream_t stream) {
  if (p.D <= 16) return launch<T, 16>(q, k, v, o, lse, p, stream);
  if (p.D <= 32) return launch<T, 32>(q, k, v, o, lse, p, stream);
  if (p.D <= 64) return launch<T, 64>(q, k, v, o, lse, p, stream);
  if (p.D <= 128) return launch<T, 128>(q, k, v, o, lse, p, stream);
  return launch<T, 256>(q, k, v, o, lse, p, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtype: 0 = fp32, 1 = bf16.
// lse: fp32 (B, Tq, KVH, G) array for the row log-sum-exp, or null.  Returns the cudaError_t of the launch (0 = cudaSuccess); shapes the kernel
// does not take return cudaErrorInvalidValue without launching.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Tq, int Tk, int KVH, int G, int D, int causal, int has_window,
    int window, int has_prefix, int prefix_len, int has_cap, float cap,
    float scale, int q_offset, int has_kvl, int k_valid_len, void* lse,
    void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || KVH < 1 || G < 1 || G > kRows || D < 1 ||
      D > 256 || KVH > 65535 || B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Params p{B,        Tq,         Tk,      KVH,   G,     D,
                 causal,   has_window, window,  has_prefix,   prefix_len,
                 has_cap,  cap,        scale,   q_offset,     has_kvl,
                 k_valid_len};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t e = dtype == 0
                            ? dispatch_d<float>(q, k, v, o, l, p, s)
                            : dispatch_d<__nv_bfloat16>(q, k, v, o, l, p, s);
  return (int)e;
}
