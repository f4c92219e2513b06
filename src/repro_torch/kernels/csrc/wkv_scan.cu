// RWKV-6 WKV recurrence for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `wkv_scan_pallas` (body `_wkv_kernel`) in
// src/repro/kernels/wkv_scan.py.  Same function per (batch, head), with the
// matrix state S (K x V) in fp32:
//     out_t = r_t . (S + u * k_t^T v_t),    S <- diag(w_t) S + k_t^T v_t,
// plus what the serving path needs and the Pallas kernel lacks: a starting
// state s0 (`rwkv_block` prefill continues from `state.s`) and the final
// state s_T, written for decode.  Under autograd it also writes the state
// at the start of every chunk of kChunk steps to `ckpt` (B, H, chunks, K,
// V), from which wkv_scan_bwd.cu replays each chunk; serving passes a null
// `ckpt` and writes nothing more.
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
// with the operations close behind.
//
// The design: the exact recurrence, spread over the card.  A state column
// S[:, j] and out_t[j] depend on no other column, so
//   * each lane holds kRows = 4 state rows of C = 2 value columns in
//     registers for the whole sequence and updates them in time order with
//     the operations above; a group of K / 4 lanes covers a column pair, and
//     out_t[j] is the sum of the group's partial dot products;
//   * a CTA holds COLS = 32 columns (8 warps), two CTAs a (b, h): 256 CTAs,
//     16 warps an SM, at the serving shape, where the first version ran one
//     CTA of two warps per (b, h);
//   * the partial outputs of kSteps = 4 steps are summed over the group at
//     once, by a shuffle reduce-scatter that leaves one (step, column) total
//     a lane: one chain of shuffles per 4 steps, off the state's dependency
//     chain (one FMA a step);
//   * the time axis, a sequential grid dimension on the TPU, is a loop in
//     the CTA over chunks of kChunk steps: r, k and w rows of the chunk and
//     the CTA's slice of v are staged in shared memory with cp.async, the
//     next chunk loading while the current one runs (double buffer).
// Each lane reads 3 / C floats of r, k, w a state entry a step from shared
// memory, and more columns a lane leave fewer warps to hide the shuffles:
// on the H100, 2 columns, 32 a CTA and 4 steps a sum were the fastest of
// the layouts tried (1-8 columns, 2 or 4 rows, 16-64 columns a CTA, 1-8
// steps; PERF.md).
// Not the chunked matrix form on the tensor cores (intra-chunk products
// with the state carried between chunks): its cumulative decay products
// over a chunk underflow fp32 at the decays the model makes (w down to
// exp(-e^3) ~ 2e-9 at once, so a product over 16 steps is far below 1e-38),
// and dividing by them overflows; sub-chunks relative to their own start
// and 3xTF32 would be needed to hold 1e-5.

#include <stddef.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kChunk = 16;     // time steps staged in shared memory at once
constexpr int kRows = 4;       // state rows a lane holds
constexpr int kSteps = 4;      // steps whose outputs are summed over lanes at once

// For head size K: C value columns a lane holds (for its kRows rows), and
// COLS columns a CTA holds, K / COLS CTAs per (b, h).  A group of
// K / kRows lanes shares C columns; NT = COLS / C groups of lanes.
template <int K> struct Config;
template <> struct Config<64> { static constexpr int C = 2, COLS = 32; };
template <> struct Config<32> { static constexpr int C = 2, COLS = 32; };
template <> struct Config<16> { static constexpr int C = 1, COLS = 16; };

template <int K>
struct Shape {
  static constexpr int C = Config<K>::C, COLS = Config<K>::COLS;
  static constexpr int L = K / kRows;            // lanes per group
  static constexpr int NT = COLS / C * L;        // threads per CTA
  static_assert(NT % 32 == 0 && 32 % L == 0 && kSteps * C <= L &&
                    kChunk % kSteps == 0, "whole warps of groups");
};

// r, k, w rows (K floats each) and v[j0 .. j0 + COLS) of steps t0 ..
// t0 + kChunk - 1 into rkw_s[i][0..2][K] and v_s[i][COLS]; past T, zeros
// and w = 1, a step that leaves the state as it is.
// VEC: every row starts on the 16-byte grid (cp.async of 16 bytes).
template <int K, bool VEC>
__device__ __forceinline__ void load_chunk(const float* r, const float* k,
                                           const float* w, const float* v,
                                           int b, int h, int j0, int t0, int T,
                                           int H, float* rkw_s, float* v_s) {
  constexpr int COLS = Shape<K>::COLS, NT = Shape<K>::NT;
  constexpr int W = VEC ? 4 : 1;                  // floats per copy
  constexpr int PER = (3 * K + COLS) / W;         // copies per step
  for (int idx = threadIdx.x; idx < kChunk * PER; idx += NT) {
    const int i = idx / PER, c = (idx % PER) * W;
    const bool ok = t0 + i < T;
    const size_t row = ok ? (((size_t)b * T + t0 + i) * H + h) * K : 0;
    const float* src;
    float* dst;
    if (c < 3 * K) {
      const int which = c / K, col = c % K;
      src = (which == 0 ? r : which == 1 ? k : w) + row + col;
      dst = rkw_s + (i * 3 + which) * K + col;
    } else {
      src = v + row + j0 + (c - 3 * K);
      dst = v_s + i * COLS + (c - 3 * K);
    }
    if (!ok && c >= 2 * K && c < 3 * K) {
#pragma unroll
      for (int e = 0; e < W; ++e) dst[e] = 1.f;
    } else if (VEC) {
      cp16(dst, src, ok);
    } else {
      cp4(dst, src, ok);
    }
  }
}

// x[0..C) = p[0..C) in vector loads (p is aligned to min(C, 4) floats)
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float* x) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C; q += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + q);
      x[q] = t.x, x[q + 1] = t.y, x[q + 2] = t.z, x[q + 3] = t.w;
    }
  } else if constexpr (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    static_assert(C == 1, "1, 2 or a multiple of 4 floats");
    x[0] = p[0];
  }
}

// Sum o[0..N) over the L lanes of a group, entry by entry, and leave the
// total of entry lg / (L / N) in o[0] (lg: lane in the group): each of the
// first log2(N) butterfly levels hands half the entries to the partner lane
// and keeps the other half (a reduce-scatter), the remaining levels sum one
// entry.  The same order in every call.
template <int L, int N>
__device__ __forceinline__ void group_sum(float* o, int lg) {
#pragma unroll
  for (int lvl = 0, m = L / 2; m > 0; ++lvl, m >>= 1) {
    const int n = N >> lvl;
    if (n > 1) {
      const bool up = (lg & m) != 0;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = up ? o[i] : o[i + n / 2];
        const float keep = up ? o[i + n / 2] : o[i];
        o[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
      }
    } else {
      o[0] += __shfl_xor_sync(0xffffffffu, o[0], m);
    }
  }
}

template <int K, bool VEC>
__global__ void __launch_bounds__(Shape<K>::NT)
wkv_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ out, float* __restrict__ sT,
                float* __restrict__ ckpt, int T, int H) {
  constexpr int L = Shape<K>::L, C = Shape<K>::C, COLS = Shape<K>::COLS;
  __shared__ __align__(16) float rkw_s[2][kChunk * 3 * K];
  __shared__ __align__(16) float v_s[2][kChunk * COLS];
  constexpr int parts = K / COLS;
  const int bh = blockIdx.x / parts;             // b * H + h
  const int j0 = (blockIdx.x % parts) * COLS;
  const int b = bh / H, h = bh - b * H;
  const int grp = threadIdx.x / L, lg = threadIdx.x % L;
  const int c0 = grp * C, k0 = lg * kRows;   // columns j0 + c0 .., rows k0 ..
  // the (step, column) of a block of kSteps whose sum group_sum leaves here
  constexpr int N = kSteps * C;
  const int mine = lg / (L / N), ms = mine / C, mc = mine % C;

  float S[kRows][C], uu[kRows];
  const size_t sbase = (size_t)bh * K * K + j0 + c0;
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    uu[e] = u[(size_t)h * K + k0 + e];
#pragma unroll
    for (int c = 0; c < C; ++c) S[e][c] = s0[sbase + (size_t)(k0 + e) * K + c];
  }

  const int nchunks = (T + kChunk - 1) / kChunk;
  load_chunk<K, VEC>(r, k, w, v, b, h, j0, 0, T, H, rkw_s[0], v_s[0]);
  cp_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    const int buf = ch & 1, t0 = ch * kChunk;
    if (ckpt != nullptr) {           // the state before step t0
      float* cp = ckpt + ((size_t)bh * nchunks + ch) * K * K + j0 + c0;
#pragma unroll
      for (int e = 0; e < kRows; ++e)
#pragma unroll
        for (int c = 0; c < C; ++c) cp[(size_t)(k0 + e) * K + c] = S[e][c];
    }
    if (ch + 1 < nchunks)
      load_chunk<K, VEC>(r, k, w, v, b, h, j0, t0 + kChunk, T, H,
                         rkw_s[buf ^ 1], v_s[buf ^ 1]);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int n = min(kChunk, T - t0);
    const float* rkw = rkw_s[buf];
    const float* vs = v_s[buf];
    for (int i = 0; i < n; i += kSteps) {
      // kSteps steps (past T in the last chunk: w = 1, zeros), their outputs'
      // partial sums in o[s * C + c], summed over the lanes at once
      float o[N];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const float* row = rkw + (i + s) * 3 * K + k0;
        float rr[kRows], kk[kRows], ww[kRows], vj[C];
        load_cols<kRows>(row, rr);
        load_cols<kRows>(row + K, kk);
        load_cols<kRows>(row + 2 * K, ww);
        load_cols<C>(vs + (i + s) * COLS + c0, vj);
#pragma unroll
        for (int c = 0; c < C; ++c) o[s * C + c] = 0.f;
#pragma unroll
        for (int e = 0; e < kRows; ++e)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float kv = kk[e] * vj[c];
            o[s * C + c] = fmaf(rr[e], fmaf(uu[e], kv, S[e][c]), o[s * C + c]);
            S[e][c] = fmaf(ww[e], S[e][c], kv);
          }
      }
      group_sum<L, N>(o, lg);
      if (lg % (L / N) == 0 && i + ms < n)
        out[(((size_t)b * T + t0 + i + ms) * H + h) * K + j0 + c0 + mc] = o[0];
    }
    __syncthreads();     // the next iteration's load reuses this buffer
  }
  cp_wait<0>();
#pragma unroll
  for (int e = 0; e < kRows; ++e)
#pragma unroll
    for (int c = 0; c < C; ++c) sT[sbase + (size_t)(k0 + e) * K + c] = S[e][c];
}

template <int K>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* out, void* sT, void* ckpt,
                   int B, int T, int H, bool vec, cudaStream_t stream) {
  const dim3 grid((unsigned)(B * H * (K / Shape<K>::COLS)));
  auto kernel = vec ? wkv_scan_kernel<K, true> : wkv_scan_kernel<K, false>;
  kernel<<<grid, Shape<K>::NT, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(sT), static_cast<float*>(ckpt),
      T, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  K is the head size (K = V);
// ckpt is null, or room for B * H * ceil(T / 16) states.  Returns the cudaError_t of the launch (0 = cudaSuccess); shapes the kernel
// does not take return cudaErrorInvalidValue without launching.
extern "C" int repro_wkv_scan(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* out, void* sT, void* ckpt, int B, int T,
                              int H, int K, void* stream) {
  if (B < 1 || T < 1 || H < 1 || (long long)B * H * 4 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return (int)launch<16>(r, k, v, w, u, s0, out, sT, ckpt, B, T, H, vec, s);
    case 32: return (int)launch<32>(r, k, v, w, u, s0, out, sT, ckpt, B, T, H, vec, s);
    case 64: return (int)launch<64>(r, k, v, w, u, s0, out, sT, ckpt, B, T, H, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
