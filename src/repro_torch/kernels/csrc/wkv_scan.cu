// RWKV-6 WKV recurrence for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `wkv_scan_pallas` (body `_wkv_kernel`) in
// src/repro/kernels/wkv_scan.py.  Same function per (batch, head), with the
// matrix state S (K x V) in fp32:
//     out_t = r_t . (S + u * k_t^T v_t),    S <- diag(w_t) S + k_t^T v_t,
// plus what the serving path needs and the Pallas kernel lacks: a starting
// state s0 (`rwkv_block` prefill continues from `state.s`) and the final
// state s_T, written for decode.
//
// Layout (the model's, read in place with no transposes): r, k, w
// (B, T, H, K), v (B, T, H, V), u (H, K), s0 and s_T (B, H, K, V), out
// (B, T, H, V); all fp32 and contiguous; K = V in {16, 32, 64}.
//
// What bounds it on the card: per (b, t, h) the function needs 5 K V + 3 K
// + 2 V fp32 operations (out_t[j] = sum_k r_k S[k,j] + v_j sum_k r_k u_k k_k
// is 2 K V + 3 K + 2 V, the state update 3 K V) against 4 K + V floats in
// and V out, plus s0 in and s_T out.  At RWKV-6 1.6B's serving shape (B=4,
// T=512, H=32, K=V=64) that is 1.36 GFLOP (0.020 ms at 67 TFLOP/s outside
// the tensor cores) against 88 MB (0.026 ms at 3.35 TB/s): bound by bytes,
// with the operations close behind.  What actually limits this design is
// the sequential time axis: each step's state update depends on the last.
//
// The design: one CTA per (b, h), one thread per value column j, which
// keeps S[:, j] (K floats) in registers for the whole sequence, so the
// state never touches memory between s0 and s_T and no step needs a
// cross-thread reduction (out_t[j] sums over k inside the thread).  The
// time axis, a sequential grid dimension on the TPU, is a loop inside the
// CTA.  Every kChunk steps the CTA stages r, k, w and v of those steps in
// shared memory with coalesced row loads (one row of K floats per step and
// head is contiguous), and the threads read them back as broadcast float4s.
// The sum over k runs in four partial sums to shorten the dependent chain.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kChunk = 16;     // time steps staged in shared memory at once

template <int K>
__global__ void __launch_bounds__(K)
wkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ out, float* __restrict__ sT, int T, int H) {
  __shared__ __align__(16) float r_s[kChunk][K];
  __shared__ __align__(16) float k_s[kChunk][K];
  __shared__ __align__(16) float w_s[kChunk][K];
  __shared__ __align__(16) float v_s[kChunk][K];
  __shared__ __align__(16) float u_s[K];
  const int j = threadIdx.x;           // value column
  const int bh = blockIdx.x;           // b * H + h
  const int b = bh / H, h = bh - b * H;

  u_s[j] = u[(size_t)h * K + j];
  float S[K];
  const size_t sbase = (size_t)bh * K * K + j;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) S[kk] = s0[sbase + (size_t)kk * K];

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    __syncthreads();                   // the last chunk's reads are done
    for (int i = 0; i < n; ++i) {
      const size_t row = (((size_t)b * T + t0 + i) * H + h) * K + j;
      r_s[i][j] = __ldg(r + row);
      k_s[i][j] = __ldg(k + row);
      w_s[i][j] = __ldg(w + row);
      v_s[i][j] = __ldg(v + row);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float vj = v_s[i][j];
      const float4* r4 = reinterpret_cast<const float4*>(r_s[i]);
      const float4* k4 = reinterpret_cast<const float4*>(k_s[i]);
      const float4* w4 = reinterpret_cast<const float4*>(w_s[i]);
      const float4* u4 = reinterpret_cast<const float4*>(u_s);
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kk4[4] = {kq.x, kq.y, kq.z, kq.w};
        const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
        const float uu[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 4 * q + e;
          const float kv = kk4[e] * vj;
          o[e] += rr[e] * (S[kk] + uu[e] * kv);
          S[kk] = ww[e] * S[kk] + kv;
        }
      }
      out[(((size_t)b * T + t0 + i) * H + h) * K + j] = (o[0] + o[1]) + (o[2] + o[3]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk) sT[sbase + (size_t)kk * K] = S[kk];
}

template <int K>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* out, void* sT, int B,
                   int T, int H, cudaStream_t stream) {
  wkv_scan_kernel<K><<<B * H, K, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(sT), T, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  K is the head size (K = V).
// Returns the cudaError_t of the launch (0 = cudaSuccess); shapes the kernel
// does not take return cudaErrorInvalidValue without launching.
extern "C" int repro_wkv_scan(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* out, void* sT, int B, int T, int H, int K,
                              void* stream) {
  if (B < 1 || T < 1 || H < 1 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return (int)launch<16>(r, k, v, w, u, s0, out, sT, B, T, H, s);
    case 32: return (int)launch<32>(r, k, v, w, u, s0, out, sT, B, T, H, s);
    case 64: return (int)launch<64>(r, k, v, w, u, s0, out, sT, B, T, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
