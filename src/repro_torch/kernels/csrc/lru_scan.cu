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
// prefill shape (2, 2304, 4096) that is 226.5 MB, 0.0676 ms at 3.35 TB/s.
// Reaching that takes a few MB of loads in flight across the card at all
// times; a thread that walks its channel alone, loading a few steps and
// then waiting for them, leaves the memory idle between round trips.
//
// The design: the TPU kernel's structure (the state carried across time
// tiles, a parallel scan inside a tile), written for this card.
//   * A CTA owns one batch row and kLanes = 32 channels; lane = channel, so
//     each time step's loads and stores are one 128-byte row.  At the
//     serving shape that is 256 CTAs.
//   * The CTA walks T in tiles of kTile = 128 steps.  The a and x rows of a
//     tile arrive by cp.async into a ring of kStages = 4 stages in shared
//     memory, three tiles ahead of the one being scanned: 96 KB in flight a
//     CTA.  The 128 KB ring leaves room for one CTA an SM, so 132 CTAs run
//     at once (12.7 MB in flight) and the 256 take two waves.  Other
//     tiles, warp counts and ring depths are timed against this one by
//     `launch/sweep_lru_scan.py` (PERF.md, Findings).
//   * Inside a tile each of the kWarps = 8 warps takes kSub = 16
//     consecutive steps:
//       1. it scans its steps from a zero state into the pair (A, X), the
//          product of its a's and its last h, of the operator
//          (a2, x2) o (a1, x1) = (a1 a2, a2 x1 + x2) that `_lru_kernel` uses;
//       2. the pairs go through shared memory, and each warp folds the
//          pairs of the warps before it onto the tile's carry-in, in warp
//          order;
//       3. it re-runs its steps' recurrence from that starting state and
//          stores h, so the output differs from the sequential scan only
//          through the starting states (no A-prefix times carry term);
//       4. the last warp's last h is the next tile's carry-in.
//     That work is ~1k cycles a tile (reckoned from the chains and the
//     barriers) against the ~4k that a CTA's share of 3.35 TB/s takes for
//     the tile's 48 KB, so the memory sets the time.  The same order on
//     every call: no atomics, no wait across CTAs, so two calls give
//     identical bits.  `kernels/lru_scan.py::lru_scan_tiled` is this
//     arithmetic in plain torch, checked on the CPU.
//   * Steps past T load a = 1 and x = 0 and are not stored; lanes past W
//     load nothing and store nothing.

#include <stddef.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kLanes = 32;                  // channels a CTA, one a lane
constexpr int kWarps = 8;                   // warps a CTA, time split among them
constexpr int kTile = 128;                  // time steps a tile
constexpr int kStages = 4;                  // tiles in the cp.async ring
constexpr int kSub = kTile / kWarps;        // steps a warp scans in a tile
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 2 * kTile * kLanes;  // floats a stage: a rows, then x rows
static_assert(kTile % kWarps == 0, "whole sub-chunks");

constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kStages * kStage + 2 * kWarps * kLanes + 2 * kLanes);
}

// a and x of steps t0 .. t0 + kTile - 1, channels c0 .. c0 + kLanes - 1 of
// batch row `base` into stage s: a rows at s[0 ..), x rows at s[kTile *
// kLanes ..).  Past T, a = 1 and x = 0 (a step that keeps the state); past
// W, zeros.  VEC: W % 4 == 0 and a, x on the 16-byte grid, so cp.async moves
// 16 bytes at a time.
template <bool VEC>
__device__ __forceinline__ void load_tile(const float* a, const float* x,
                                          size_t base, int c0, int t0, int T,
                                          int W, float* s) {
  constexpr int E = VEC ? 4 : 1;                  // floats a copy
  constexpr int PER = 2 * kLanes / E;             // copies a step
  for (int idx = threadIdx.x; idx < kTile * PER; idx += kThreads) {
    const int i = idx / PER, q = (idx % PER) * E;
    const int which = q / kLanes, col = q % kLanes;
    float* dst = s + which * kTile * kLanes + i * kLanes + col;
    const bool in_t = t0 + i < T;
    if (!in_t && which == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) dst[e] = 1.f;
      continue;
    }
    const bool ok = in_t && c0 + col < W;
    const float* src = (which == 0 ? a : x) +
                       (ok ? base + (size_t)(t0 + i) * W + c0 + col : 0);
    if (VEC)
      cp16(dst, src, ok);
    else
      cp4(dst, src, ok);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                const float* __restrict__ h0, float* __restrict__ out, int T,
                int W, int groups) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                 // kStages stages
  float* pair_a = ring + kStages * kStage;            // [kWarps][kLanes]
  float* pair_x = pair_a + kWarps * kLanes;
  float* carry = pair_x + kWarps * kLanes;            // [2][kLanes], by tile parity

  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x - b * groups) * kLanes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = c0 + lane;
  const bool live = c < W;
  const size_t base = (size_t)b * T * W;
  const int tiles = (T + kTile - 1) / kTile;

  if (warp == kWarps - 1) carry[lane] = live ? h0[(size_t)b * W + c] : 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_tile<VEC>(a, x, base, c0, s * kTile, T, W, ring + s * kStage);
    cp_commit();
  }

  for (int k = 0; k < tiles; ++k) {
    cp_wait<kStages - 2>();             // tile k has landed (for this thread)
    __syncthreads();                    // ... and for every thread
    const int next = k + kStages - 1;   // into the stage tile k - 1 used
    if (next < tiles)
      load_tile<VEC>(a, x, base, c0, next * kTile, T, W,
                     ring + (next % kStages) * kStage);
    cp_commit();

    const float* as = ring + (k % kStages) * kStage + warp * kSub * kLanes + lane;
    const float* xs = as + kTile * kLanes;
    // 1. this warp's steps from a zero state: (A, X)
    float A = as[0], X = xs[0];
#pragma unroll
    for (int i = 1; i < kSub; ++i) {
      const float ai = as[i * kLanes];
      X = fmaf(ai, X, xs[i * kLanes]);
      A *= ai;
    }
    pair_a[warp * kLanes + lane] = A;
    pair_x[warp * kLanes + lane] = X;
    __syncthreads();
    // 2. the starting state: the earlier warps' pairs on the carry-in
    float h = carry[(k & 1) * kLanes + lane];
    for (int j = 0; j < warp; ++j)
      h = fmaf(pair_a[j * kLanes + lane], h, pair_x[j * kLanes + lane]);
    // 3. the recurrence again from there, stored
    const int t0 = k * kTile + warp * kSub;
    float* o = out + base + (size_t)t0 * W + c;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      h = fmaf(as[i * kLanes], h, xs[i * kLanes]);
      if (live && t0 + i < T) o[(size_t)i * W] = h;
    }
    // 4. the next tile's carry-in (read after the next tile's barriers)
    if (warp == kWarps - 1) carry[((k + 1) & 1) * kLanes + lane] = h;
  }
  cp_wait<0>();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns the cudaError_t of the
// launch (0 = cudaSuccess); shapes the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int repro_lru_scan(const void* a, const void* x, const void* h0,
                              void* out, int B, int T, int W, void* stream) {
  if (B < 1 || T < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int groups = (W + kLanes - 1) / kLanes;
  const long long blocks = (long long)B * groups;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && aligned16(a) && aligned16(x);
  auto kernel = vec ? lru_scan_kernel<true> : lru_scan_kernel<false>;
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes());
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, kThreads, smem_bytes(),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x),
      static_cast<const float*>(h0), static_cast<float*>(out), T, W, groups);
  return (int)cudaGetLastError();
}
