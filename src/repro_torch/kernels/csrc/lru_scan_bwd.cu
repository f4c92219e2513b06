// RG-LRU scan backward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// No Pallas counterpart: the JAX package trains through `jax.grad` of its
// associative scan (`lru_scan_ref`, src/repro/models/rglru.py:96), and this
// kernel takes that place under `LRUScan` (kernels/lru_scan.py), as
// flash_attention_bwd.cu takes the place of `jax.grad` through attention.
//
// Function: with the forward h_t = a_t h_{t-1} + x_t (h_{-1} = h0) and the
// gradient gh of h,
//     dh_{T-1} = gh_{T-1},   dh_t = gh_t + a_{t+1} dh_{t+1},
//     gx_t = dh_t,   ga_t = dh_t h_{t-1},   gh0 = a_0 dh_0,
// which is the forward recurrence run backwards in time with a shifted by
// one step (`ref.reference_lru_scan_bwd` is the same in plain torch).
//
// Layout (the model's): a, h, gh, gx, ga (B, T, W) fp32, h0 and gh0 (B, W)
// fp32, all contiguous; gh0 may be null (not asked for).
//
// What bounds it on the card: two multiply-adds per element against 20
// bytes moved (a, h, gh in; gx, ga out), so bytes: at recurrentgemma-9b's
// training shape (2, 512, 4096) that is 84 MB, 0.025 ms at 3.35 TB/s.
//
// The design: the forward kernel's tiled time scan (lru_scan.cu), walked
// from the last tile to the first.
//   * A CTA owns one batch row and kLanes = 32 channels, lane = channel.
//   * Tile k covers steps t0 .. t0 + kTile - 1.  Its stage in shared memory
//     holds, for each step t of the tile, a_{t+1} (the rows shifted one step
//     later; 1 past T), gh_t (0 past T) and h_{t-1} (h0 for t = 0, rows
//     shifted one step earlier), all by cp.async, kStages - 1 tiles ahead
//     of the one being scanned.
//   * Inside a tile each of the kWarps warps takes kSub consecutive steps,
//     scans them in reverse from zero into a pair (A, X), folds the pairs of
//     the warps after it (later in time) onto the tile's carry-in (dh at the
//     tile's end + 1), in warp order from the last, re-runs its steps'
//     reverse recurrence from there, and stores dh (gx) and dh * h_{t-1}
//     (ga) in the same pass.  Warp 0's last dh (dh_{t0}) carries into the
//     tile before.
//   * gh0 = a_0 dh_0, after the first tile.
//   * The same order on every call: no atomics, no wait across CTAs, so two
//     calls give identical bits.

#include <stddef.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kLanes = 32;                  // channels a CTA, one a lane
constexpr int kWarps = 8;                   // warps a CTA, time split among them
constexpr int kTile = 128;                  // time steps a tile
constexpr int kStages = 3;                  // tiles in the cp.async ring
constexpr int kSub = kTile / kWarps;        // steps a warp scans in a tile
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile * kLanes;       // floats of one stream in a stage
constexpr int kStage = 3 * kRows;           // a (shifted), gh, h (shifted)
static_assert(kTile % kWarps == 0, "whole sub-chunks");

constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kStages * kStage + 2 * kWarps * kLanes + 2 * kLanes);
}

// One stream of tile rows t0 .. t0 + kTile - 1 into dst[i * kLanes + col]:
// row t0 + i + shift of `src` (channels c0 ..), `fill` where that row is
// outside [0, T) or, for shift -1 at row -1, h0's row.  VEC: 16-byte copies.
template <bool VEC>
__device__ __forceinline__ void load_stream(const float* src, const float* h0,
                                            size_t base, size_t b0, int c0,
                                            int t0, int shift, float fill,
                                            int T, int W, float* dst) {
  constexpr int E = VEC ? 4 : 1;
  constexpr int PER = kLanes / E;
  for (int idx = threadIdx.x; idx < kTile * PER; idx += kThreads) {
    const int i = idx / PER, col = (idx % PER) * E;
    const int t = t0 + i + shift;
    float* d = dst + i * kLanes + col;
    const bool in_w = c0 + col < W;
    if (t >= T || (t < 0 && h0 == nullptr)) {
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = fill;
      continue;
    }
    const float* s = t < 0 ? h0 + b0 + c0 + col : src + base + (size_t)t * W + c0 + col;
    if (VEC)
      cp16(d, in_w ? s : src, in_w);
    else
      cp4(d, in_w ? s : src, in_w);
  }
}

template <bool VEC>
__device__ __forceinline__ void load_tile(const float* a, const float* h,
                                          const float* gh, const float* h0,
                                          size_t base, size_t b0, int c0,
                                          int t0, int T, int W, float* s) {
  load_stream<VEC>(a, nullptr, base, b0, c0, t0, 1, 1.f, T, W, s);
  load_stream<VEC>(gh, nullptr, base, b0, c0, t0, 0, 0.f, T, W, s + kRows);
  load_stream<VEC>(h, h0, base, b0, c0, t0, -1, 0.f, T, W, s + 2 * kRows);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
lru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                    const float* __restrict__ h0, const float* __restrict__ gh,
                    float* __restrict__ gx, float* __restrict__ ga,
                    float* __restrict__ gh0, int T, int W, int groups) {
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
  const size_t base = (size_t)b * T * W, b0 = (size_t)b * W;
  const int tiles = (T + kTile - 1) / kTile;

  if (warp == 0) carry[lane] = 0.f;                   // dh_T = 0
  // stage s holds tile tiles - 1 - s, ... (the walk goes backwards)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles)
      load_tile<VEC>(a, h, gh, h0, base, b0, c0, (tiles - 1 - s) * kTile, T, W,
                     ring + s * kStage);
    cp_commit();
  }

  for (int n = 0; n < tiles; ++n) {           // n-th tile of the walk
    const int k = tiles - 1 - n;              // its index in time
    cp_wait<kStages - 2>();
    __syncthreads();
    const int next = n + kStages - 1;
    if (next < tiles)
      load_tile<VEC>(a, h, gh, h0, base, b0, c0, (tiles - 1 - next) * kTile, T, W,
                     ring + (next % kStages) * kStage);
    cp_commit();

    const float* st = ring + (n % kStages) * kStage + warp * kSub * kLanes + lane;
    const float* as = st;                     // a_{t+1}
    const float* gs = st + kRows;             // gh_t
    const float* hs = st + 2 * kRows;         // h_{t-1}
    // 1. this warp's steps in reverse from a zero adjoint: (A, X)
    float A = as[(kSub - 1) * kLanes], X = gs[(kSub - 1) * kLanes];
#pragma unroll
    for (int i = kSub - 2; i >= 0; --i) {
      const float ai = as[i * kLanes];
      X = fmaf(ai, X, gs[i * kLanes]);
      A *= ai;
    }
    pair_a[warp * kLanes + lane] = A;
    pair_x[warp * kLanes + lane] = X;
    __syncthreads();
    // 2. the starting adjoint: the later warps' pairs on the carry-in
    float d = carry[(n & 1) * kLanes + lane];
    for (int j = kWarps - 1; j > warp; --j)
      d = fmaf(pair_a[j * kLanes + lane], d, pair_x[j * kLanes + lane]);
    // 3. the reverse recurrence again from there: dh, and dh * h_{t-1}
    const int t0 = k * kTile + warp * kSub;
    const size_t o = base + (size_t)t0 * W + c;
#pragma unroll
    for (int i = kSub - 1; i >= 0; --i) {
      d = fmaf(as[i * kLanes], d, gs[i * kLanes]);
      if (live && t0 + i < T) {
        gx[o + (size_t)i * W] = d;
        ga[o + (size_t)i * W] = d * hs[i * kLanes];
      }
    }
    // 4. dh_{t0} of the tile carries into the tile before
    if (warp == 0) carry[((n + 1) & 1) * kLanes + lane] = d;
  }
  cp_wait<0>();
  // warp 0 wrote the last carry (dh_0) itself
  if (gh0 != nullptr && warp == 0 && live)
    gh0[b0 + c] = a[base + c] * carry[(tiles & 1) * kLanes + lane];
}

}  // namespace

// Plain C entry point (loaded with ctypes).  gh0 may be null.  Returns the
// cudaError_t of the launch (0 = cudaSuccess); shapes the kernel does not
// take return cudaErrorInvalidValue without launching.
extern "C" int repro_lru_scan_bwd(const void* a, const void* h, const void* h0,
                                  const void* gh, void* gx, void* ga, void* gh0,
                                  int B, int T, int W, void* stream) {
  if (B < 1 || T < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int groups = (W + kLanes - 1) / kLanes;
  const long long blocks = (long long)B * groups;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && aligned16(a) && aligned16(h) && aligned16(gh) &&
                   aligned16(h0);
  auto kernel = vec ? lru_scan_bwd_kernel<true> : lru_scan_bwd_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes());
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, kThreads, smem_bytes(),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(gh),
      static_cast<float*>(gx), static_cast<float*>(ga), static_cast<float*>(gh0),
      T, W, groups);
  return (int)cudaGetLastError();
}
