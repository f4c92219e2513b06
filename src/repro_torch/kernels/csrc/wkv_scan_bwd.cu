// RWKV-6 WKV recurrence backward for NVIDIA Hopper (sm_90a), hand-written
// CUDA C++.
//
// No Pallas counterpart: the JAX package trains through `jax.grad` of its
// model scan (`wkv_scan_ref`, a lax.scan, src/repro/models/rwkv6.py:97),
// and this kernel takes that place under `WKVScan` (kernels/wkv_scan.py).
//
// Function, per (batch, head), with S_{t-1} the state before step t
// (S_{-1} = s0) and dS the adjoint of the state after it (gS_T at the end,
// zeros when not given), from t = T - 1 down to 0:
//     c_t  = v_t . gy_t
//     gr_t = S_{t-1} gy_t + u * k_t c_t          gu += r_t * k_t c_t
//     gk_t = dS v_t + r_t * u c_t
//     gv_t = dS^T k_t + (sum_i r_t[i] u_i k_t[i]) gy_t
//     gw_t = rowsum(dS * S_{t-1})
//     dS  <- diag(w_t) dS + r_t^T gy_t
// and gs0 = dS at the end (`ref.reference_wkv_bwd` in plain torch).
//
// Layout (the model's): r, k, w, v, gy and the gradients of the first four
// (B, T, H, K) with K = V in {16, 32, 64}; u and gu (H, K); s0, gS_T and gs0
// (B, H, K, V); ckpt (B, H, chunks, K, V), the state at the start of every
// chunk of kChunk steps, written by the forward (wkv_scan.cu) under
// autograd.  All fp32 and contiguous; gS_T and gs0 may be null.
//
// What bounds it on the card: per (b, t, h) the function needs 14 K V fp32
// operations (the states again, S <- w S + k v^T, 3 K V; the adjoint's
// update 3 K V; the four sums gr, gk, gv, gw 2 K V each) against 5 K floats
// in (r, k, w, v, gy) and 4 K out.  At rwkv6-1.6b's training shape (B = 2,
// T = 512, H = 32, K = V = 64) that is 1.9 GFLOP, 0.028 ms at 67 TFLOP/s
// outside the tensor cores, against 78 MB, 0.023 ms at 3.35 TB/s: bound by
// operations, the bytes close behind.  This kernel does about 22 K V a
// step (its replay and the summing of partials are extra).
//
// The design, a simple one (a redesign is later work):
//   * The states are never recovered by dividing by w_t: at the model's
//     decays (w down to ~2e-9) that overflows (wkv_scan.cu's note).  The
//     backward walks the chunks from the last to the first; for each it
//     loads the chunk's checkpoint and replays the kChunk forward steps with
//     the forward's own multiply-adds (so the replayed states are the
//     forward's, bit for bit), keeping them in shared memory, then walks the
//     chunk in reverse with the adjoint dS in registers.
//   * A column of S, and of dS, depends on no other column.  A CTA holds
//     kCols = 16 columns of one (b, h) for all K rows, K / 16 CTAs a (b, h);
//     a thread holds one row and kCpt = 4 columns of S and dS.  At the
//     training shape that is 256 CTAs of 256 threads, 78 KB of shared
//     memory each (the replayed chunk is 64 KB of it).
//   * gv sums over rows: each thread leaves its terms of a step in the
//     replayed state's place (the state is read there for the last time),
//     and after the chunk every (step, column) is summed over the rows in
//     row order.  gr, gk and gw sum over columns: the kCpt-column partials
//     are summed over the row's 4 lanes by a fixed butterfly, and each CTA
//     writes its 16-column partial to scratch; gu sums over b and t as well,
//     each CTA keeping its sum over t.  A second, small kernel then sums the
//     K / 16 partials of gr, gk and gw, and the B * K / 16 of gu, in a fixed
//     order.  No float atomics: two calls give the same bits (the R2CCL
//     parity argument needs rank-ordered sums to give identical bits).

#include <stddef.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kChunk = 16;     // steps a checkpoint covers (wkv_scan.cu's kChunk)
constexpr int kCols = 16;      // state columns a CTA
constexpr int kCpt = 4;        // state columns a thread
constexpr int kGroup = kCols / kCpt;   // threads a row
constexpr int kReduceThreads = 256;

template <int K>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kChunk * 3 * K + kChunk * 2 * kCols + kChunk * K * kCols);
}

template <int K>
__global__ void __launch_bounds__(K * kGroup)
wkv_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ ckpt,
                    const float* __restrict__ gy, const float* __restrict__ gsT,
                    float* __restrict__ gv, float* __restrict__ gs0,
                    float* __restrict__ part, float* __restrict__ gu_part, int B,
                    int T, int H) {
  constexpr int P = K / kCols, NT = K * kGroup;
  extern __shared__ __align__(16) float smem[];
  float* rkw_s = smem;                          // [kChunk][3][K]: r, k, w rows
  float* vg_s = rkw_s + kChunk * 3 * K;         // [kChunk][2][kCols]: v, gy slices
  float* st_s = vg_s + kChunk * 2 * kCols;      // [kChunk][K][kCols]: S_{t-1}, then gv terms

  const int p = blockIdx.x % P, bh = blockIdx.x / P;
  const int b = bh / H, h = bh - b * H;
  const int j0 = p * kCols;
  const int row = threadIdx.x / kGroup, cc0 = (threadIdx.x % kGroup) * kCpt;
  const bool leader = threadIdx.x % kGroup == 0;
  const float uu = u[(size_t)h * K + row];
  const int nchunks = (T + kChunk - 1) / kChunk;
  const size_t N = (size_t)B * T * H * K;
  const size_t sidx = (size_t)bh * K * K + (size_t)row * K + j0 + cc0;

  float S[kCpt], dS[kCpt];
#pragma unroll
  for (int c = 0; c < kCpt; ++c) dS[c] = gsT != nullptr ? gsT[sidx + c] : 0.f;
  float gu_acc = 0.f;

  for (int ch = nchunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk, n = min(kChunk, T - t0);
    __syncthreads();                 // the chunk after's shared reads are done
    for (int idx = threadIdx.x; idx < n * 3 * K; idx += NT) {
      const int i = idx / (3 * K), q = (idx / K) % 3, col = idx % K;
      const float* src = q == 0 ? r : q == 1 ? k : w;
      rkw_s[idx] = src[(((size_t)b * T + t0 + i) * H + h) * K + col];
    }
    for (int idx = threadIdx.x; idx < n * 2 * kCols; idx += NT) {
      const int i = idx / (2 * kCols), q = (idx / kCols) % 2, col = idx % kCols;
      vg_s[idx] = (q == 0 ? v : gy)[(((size_t)b * T + t0 + i) * H + h) * K + j0 + col];
    }
    const float* cp = ckpt + ((size_t)bh * nchunks + ch) * K * K + (size_t)row * K + j0 + cc0;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) S[c] = cp[c];
    __syncthreads();

    // replay the chunk: st_s[i] = S_{t0+i-1} (this thread's entries only)
    for (int i = 0; i < n; ++i) {
      const float kr = rkw_s[(i * 3 + 1) * K + row], wr = rkw_s[(i * 3 + 2) * K + row];
      const float* vv = vg_s + i * 2 * kCols + cc0;
      float* sp = st_s + (i * K + row) * kCols + cc0;
#pragma unroll
      for (int c = 0; c < kCpt; ++c) {
        sp[c] = S[c];
        S[c] = fmaf(wr, S[c], kr * vv[c]);
      }
    }
    // walk it in reverse
    for (int i = n - 1; i >= 0; --i) {
      const float rr = rkw_s[i * 3 * K + row], kr = rkw_s[(i * 3 + 1) * K + row],
                  wr = rkw_s[(i * 3 + 2) * K + row];
      const float uk = uu * kr, ru = rr * uu;
      const float* vv = vg_s + i * 2 * kCols + cc0;
      const float* gg = vv + kCols;
      float* sp = st_s + (i * K + row) * kCols + cc0;
      float pr = 0.f, pk = 0.f, pw = 0.f, pc = 0.f;
#pragma unroll
      for (int c = 0; c < kCpt; ++c) {
        const float sprev = sp[c];
        pr = fmaf(gg[c], fmaf(uk, vv[c], sprev), pr);     // gy (S_{t-1} + u k v)
        pk = fmaf(vv[c], fmaf(ru, gg[c], dS[c]), pk);     // v (dS + r u gy)
        pw = fmaf(dS[c], sprev, pw);                      // dS * S_{t-1}
        pc = fmaf(vv[c], gg[c], pc);                      // v . gy
        sp[c] = kr * fmaf(ru, gg[c], dS[c]);              // gv term: k (dS + r u gy)
        dS[c] = fmaf(wr, dS[c], rr * gg[c]);
      }
      // the row's kGroup lanes are adjacent: every lane ends with the same sums
#pragma unroll
      for (int m = 1; m < kGroup; m <<= 1) {
        pr += __shfl_xor_sync(0xffffffffu, pr, m);
        pk += __shfl_xor_sync(0xffffffffu, pk, m);
        pw += __shfl_xor_sync(0xffffffffu, pw, m);
        pc += __shfl_xor_sync(0xffffffffu, pc, m);
      }
      gu_acc = fmaf(rr * kr, pc, gu_acc);
      if (leader) {
        const size_t o = (((size_t)b * T + t0 + i) * H + h) * K + row;
        part[(size_t)(0 * P + p) * N + o] = pr;
        part[(size_t)(1 * P + p) * N + o] = pk;
        part[(size_t)(2 * P + p) * N + o] = pw;
      }
    }
    __syncthreads();
    // gv: every (step, column) of the chunk summed over the rows in order
    for (int idx = threadIdx.x; idx < n * kCols; idx += NT) {
      const int i = idx / kCols, col = idx % kCols;
      const float* s = st_s + i * K * kCols + col;
      float acc = 0.f;
      for (int e = 0; e < K; ++e) acc += s[e * kCols];
      gv[(((size_t)b * T + t0 + i) * H + h) * K + j0 + col] = acc;
    }
  }
  if (gs0 != nullptr) {
#pragma unroll
    for (int c = 0; c < kCpt; ++c) gs0[sidx + c] = dS[c];
  }
  if (leader) gu_part[((size_t)p * B + b) * H * K + (size_t)h * K + row] = gu_acc;
}

// gr, gk, gw: the sum of the P column parts; gu: of the P * B parts; each
// in part order
__global__ void wkv_scan_bwd_reduce(const float* __restrict__ part,
                                    const float* __restrict__ gu_part,
                                    float* __restrict__ gr, float* __restrict__ gk,
                                    float* __restrict__ gw, float* __restrict__ gu,
                                    size_t N, int P, int B, int HK) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < N; i += stride) {
    float a = 0.f, c = 0.f, d = 0.f;
    for (int p = 0; p < P; ++p) {
      a += part[(size_t)p * N + i];
      c += part[(size_t)(P + p) * N + i];
      d += part[(size_t)(2 * P + p) * N + i];
    }
    gr[i] = a, gk[i] = c, gw[i] = d;
  }
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)HK; i += stride) {
    float a = 0.f;
    for (int q = 0; q < P * B; ++q) a += gu_part[(size_t)q * HK + i];
    gu[i] = a;
  }
}

template <int K>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* ckpt, const float* gy,
                   const float* gsT, float* gr, float* gk, float* gv, float* gw,
                   float* gu, float* gs0, float* part, float* gu_part, int B, int T,
                   int H, cudaStream_t stream) {
  constexpr int P = K / kCols;
  auto kernel = wkv_scan_bwd_kernel<K>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<K>());
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)(B * H * P), K * kGroup, smem_bytes<K>(), stream>>>(
      r, k, v, w, u, ckpt, gy, gsT, gv, gs0, part, gu_part, B, T, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t N = (size_t)B * T * H * K;
  const size_t want = (N + kReduceThreads - 1) / kReduceThreads;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  wkv_scan_bwd_reduce<<<blocks, kReduceThreads, 0, stream>>>(part, gu_part, gr, gk,
                                                             gw, gu, N, P, B, H * K);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  K is the head size (K = V);
// gsT and gs0 may be null; part holds 3 * (K / 16) * B * T * H * K floats
// and gu_part (K / 16) * B * H * K.  Returns the cudaError_t of the
// launches (0 = cudaSuccess); shapes the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int repro_wkv_scan_bwd(const void* r, const void* k, const void* v,
                                  const void* w, const void* u, const void* ckpt,
                                  const void* gy, const void* gsT, void* gr, void* gk,
                                  void* gv, void* gw, void* gu, void* gs0, void* part,
                                  void* gu_part, int B, int T, int H, int K,
                                  void* stream) {
  if (B < 1 || T < 1 || H < 1 || (long long)B * H * 4 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_WKV_BWD_ARGS                                                          \
  static_cast<const float*>(r), static_cast<const float*>(k),                       \
      static_cast<const float*>(v), static_cast<const float*>(w),                   \
      static_cast<const float*>(u), static_cast<const float*>(ckpt),                \
      static_cast<const float*>(gy), static_cast<const float*>(gsT),                \
      static_cast<float*>(gr), static_cast<float*>(gk), static_cast<float*>(gv),    \
      static_cast<float*>(gw), static_cast<float*>(gu), static_cast<float*>(gs0),   \
      static_cast<float*>(part), static_cast<float*>(gu_part), B, T, H, s
  switch (K) {
    case 16: return (int)launch<16>(REPRO_WKV_BWD_ARGS);
    case 32: return (int)launch<32>(REPRO_WKV_BWD_ARGS);
    case 64: return (int)launch<64>(REPRO_WKV_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_WKV_BWD_ARGS
}
