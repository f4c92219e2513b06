// RG-LRU linear scan for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `lru_scan_pallas` (body `_lru_kernel`) in
// src/repro/kernels/lru_scan.py.  Same function, h_t = a_t * h_{t-1} + x_t
// over the time axis with an fp32 state, plus the starting state h0 that
// the model passes (`rglru_block` prefill continues from `state.h`; the
// Pallas kernel fixes h0 = 0).
//
// Layout (the model's): a, x (B, T, W) fp32, h0 (B, W) fp32, out (B, T, W)
// fp32, all contiguous.
//
// What bounds it on the card: one multiply-add per element against 12 bytes
// moved (a and x in, h out), so it is bound by bytes: at RecurrentGemma-9B's
// prefill shape (2, 2304, 4096) that is 226 MB, 0.068 ms at 3.35 TB/s.
// Reaching that needs ~2 MB of loads in flight across the card.
//
// The design: one thread per (b, w) channel walks the whole time axis, so
// the recurrence needs no cross-thread combine.  Neighbouring threads hold
// neighbouring w, so each time step's loads and stores are coalesced rows.
// The time loop is unrolled by kUnroll: a thread issues the loads of kUnroll
// steps before the dependent multiply-add chain consumes them, which puts
// B * W * kUnroll * 8 bytes in flight (1 MB at the serving shape).  CTAs
// are small (64 threads) so that 8192 channels spread over 128 SMs.  With
// so few channels, each walking 2304 steps, this stays well below the
// bytes bound; the TPU kernel's log-depth scan inside a time tile (a
// chunked two-pass scan here) is the way to fill the card, and later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                const float* __restrict__ h0, float* __restrict__ out, int B,
                int T, int W) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= (long long)B * W) return;
  const int b = (int)(c / W);
  const int w = (int)(c - (long long)b * W);
  const size_t base = (size_t)b * T * W + w;
  float h = h0[c];
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float av[kUnroll], xv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const size_t o = base + (size_t)(t + i) * W;
      av[i] = __ldg(a + o);
      xv[i] = __ldg(x + o);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      h = av[i] * h + xv[i];
      out[base + (size_t)(t + i) * W] = h;
    }
  }
  for (; t < T; ++t) {
    const size_t o = base + (size_t)t * W;
    h = __ldg(a + o) * h + __ldg(x + o);
    out[o] = h;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns the cudaError_t of the
// launch (0 = cudaSuccess); shapes the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int repro_lru_scan(const void* a, const void* x, const void* h0,
                              void* out, int B, int T, int W, void* stream) {
  if (B < 1 || T < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long channels = (long long)B * W;
  const long long blocks = (channels + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  lru_scan_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<const float*>(h0), static_cast<float*>(out), B, T, W);
  return (int)cudaGetLastError();
}
