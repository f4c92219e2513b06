// Float32 matrix products at few rows for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces no TPU kernel.  The JAX package leaves every matrix product to
// XLA, and the port left them to cuBLAS; this kernel takes decode's:
// y[g] = x[g] @ w[g] for g < G, x (G, M, K) with M <= 16 rows, float32 or
// bfloat16 (widened on load, which is exact), w (G, K, N) float32, row-major
// with N contiguous (the JAX layout as stored), y (G, M, N) float32.  G is 1
// for a layer's product (models/layers.py::_mm) and the held or routed
// experts for models/moe.py::_expert_mm.
//
// What bounds it on the card: the weight's bytes.  At 16 rows a product
// does 8 FLOP a weight byte, 27 TFLOP/s at 3.35 TB/s, 40% of fp32's 66.9 on
// the CUDA cores; at 1 row, 2 FLOP a byte.  A decode step reads 25-27 GB of
// weights, which never fit the 50 MB L2.  cuBLAS's small-M kernels (split-K
// SIMT sgemm, gemmSN) read them at 1.1-2.6 TB/s, slower as the rows grow.
//
// The design streams every weight byte from HBM exactly once, with enough
// bytes in flight, and keeps the rows' sums in registers:
//   * A CTA of 256 threads owns bn consecutive columns (32, 64 or 128) of
//     one batch entry: bn / 4 threads across them, each thread 4
//     consecutive columns (one 16-byte piece a row), and R = 1024 / bn
//     "row lanes" that split each step's rows of K: lane r takes 4
//     consecutive rows of the step's 4 R.  So the CTA reads whole rows of
//     its tile, bn * 4 contiguous bytes each.
//   * Each thread copies its own pieces of w with cp.async (L2 evict-first:
//     each byte is read once) into a ring of kStages steps in shared
//     memory, and reads back only its own pieces, so the ring needs no
//     barrier.  Three steps stay in flight: 48 KB a CTA, two CTAs an SM,
//     ~12 MB across the card, several times what 3.35 TB/s needs at HBM's
//     latency, and without the registers that as many loads into registers
//     would take.
//   * The thread keeps TM x 4 fp32 sums in registers (TM, the template's
//     rows: 1, 2, 4, 8 or 16, the next up from M, the extra rows zero) and
//     multiplies its 4 rows' pieces by x at those rows, one 4-wide load of
//     x a row of the sums (bf16 widened with a shift, which is exact).  The
//     CTA's share of x sits in shared memory as stored, in chunks of kc
//     rows of K copied with cp.async a chunk ahead into two buffers, so
//     reading x never stalls the stream; a chunk costs one barrier.
//   * Where N is too narrow to fill the card (k, v at N = 1024, MLA's
//     w_dkv at 512 and w_kpe at 64), K is split over the `split` CTAs of a
//     thread-block cluster (2 .. 16): each sums its slice of K, and the
//     partial sums meet over distributed shared memory.  The host picks bn
//     and split from the shape (kernels/small_mm.py::plan).
//   * The sums run in a fixed order: each thread's rows in increasing k
//     (one fused multiply-add each, IEEE fp32, no TF32), then the row lanes
//     0 .. R - 1 in shared memory, then the cluster's ranks 0 .. split - 1.
//     No atomics: the same bits on every call, in a CUDA graph or not.
//   * No allocation and no host sync: the wrapper allocates y with
//     torch.empty, so a CUDA graph can capture the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;              // cp.async ring: stages of kUnroll rows
constexpr int kUnroll = 4;              // rows a thread copies a stage
constexpr int kMaxRows = 16;            // the largest template, M <= 16
constexpr int kMaxPortableSplit = 8;    // the portable cluster size
constexpr int kMaxSplit = 16;           // H100's largest cluster
constexpr int kXBytes = 40 * 1024;      // shared memory for x's two chunks
constexpr int kRingBytes = kStages * kUnroll * kThreads * 16;

struct Params {
  long long sxg, sxm;   // x's strides (elements): batch entry, row
  long long swg, ldw;   // w's strides: batch entry, row of K
  int M, K, N;          // rows, depth, columns
  int bn;               // columns a CTA: 32, 64 or 128
  int split;            // CTAs (a cluster) along K
  int per;              // rows of K a CTA of the cluster: whole steps
  int kc;               // rows of K a chunk of x in shared memory
};

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// copy 16 bytes global -> shared (zeros when !ok), w's evict-first in L2
__device__ __forceinline__ void cp16_once(void* dst, const void* src, bool ok,
                                          uint64_t policy) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(d),
      "l"(src), "r"(ok ? 16 : 0), "l"(policy));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x at 4 consecutive rows of K, widened to fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ void fma4(float (&a)[4], float xv, float4 wv) {
  a[0] = fmaf(xv, wv.x, a[0]);
  a[1] = fmaf(xv, wv.y, a[1]);
  a[2] = fmaf(xv, wv.z, a[2]);
  a[3] = fmaf(xv, wv.w, a[3]);
}

template <int TM, typename TX>
__global__ void __launch_bounds__(kThreads, 2)
small_mm_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, Params p) {
  static_assert(kUnroll == 4, "a thread's rows of a step are one 4-wide load of x");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = 16 / sizeof(TX);           // values of x a 16-byte copy
  float4* ring = reinterpret_cast<float4*>(smem);
  TX* xbuf = reinterpret_cast<TX*>(smem + kRingBytes);   // [2][TM][kc]

  const int tid = threadIdx.x;
  const int cols4 = p.bn >> 2, R = kThreads / cols4;
  const int c = tid % cols4, r = tid / cols4;
  const int tile = blockIdx.x / p.split, q = blockIdx.x % p.split;
  const int g = blockIdx.y;
  const int n0 = tile * p.bn, n = n0 + 4 * c;
  const bool col_ok = n < p.N;                  // N % 4 == 0: all 4 or none
  const int kb = min(p.K, q * p.per), ke = min(p.K, kb + p.per);
  const int step_rows = R * kUnroll;
  const int steps = (ke - kb + step_rows - 1) / step_rows;
  const int chunks = (ke - kb + p.kc - 1) / p.kc;
  const float* wcol = w + (long long)g * p.swg + n;
  const TX* xg = x + (long long)g * p.sxg;
  const uint64_t policy = evict_first_policy();

  // this thread's pieces of w for step s into ring slot s % kStages: rows
  // kb + s step_rows + r kUnroll + u, u < kUnroll; zeros past ke or N
  auto copy_w = [&](int s) {
    float4* slot = ring + (s % kStages) * (kUnroll * kThreads) + tid;
    const int k0 = kb + s * step_rows + r * kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = col_ok && k0 + u < ke;
      cp16_once(slot + u * kThreads,
                ok ? (const void*)(wcol + (long long)(k0 + u) * p.ldw) : (const void*)w,
                ok, policy);
    }
  };
  // chunk j of x (rows kb + j kc .. of K, its TM rows) into buffer j & 1,
  // as stored; zeros past M and past K (K % V == 0: a copy is all in or out)
  auto copy_x = [&](int j) {
    TX* buf = xbuf + (j & 1) * TM * p.kc;
    const int k0 = kb + j * p.kc, per_row = p.kc / V;
    for (int i = tid; i < TM * per_row; i += kThreads) {
      const int m = i / per_row, kk = (i - m * per_row) * V;
      const bool ok = m < p.M && k0 + kk < p.K;
      cp16(buf + m * p.kc + kk, ok ? (const void*)(xg + m * p.sxm + k0 + kk) : (const void*)x,
           ok);
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int m = 0; m < TM; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  if (steps > 0) copy_x(0);
  cp_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) copy_w(s);
    cp_commit();
  }
  const TX* xc = xbuf;
  int in_chunk = 0;
  for (int s = 0; s < steps; ++s, in_chunk += step_rows) {
    // step s's w has landed (this thread's pieces); at a chunk's first step
    // also its x, which the barrier makes every thread's, and after which
    // the other buffer is free for the next chunk (kc >= 2 step_rows)
    cp_wait<kStages - 2>();
    if (in_chunk == p.kc) in_chunk = 0;
    if (in_chunk == 0) {
      __syncthreads();
      const int j = s * step_rows / p.kc;
      xc = xbuf + (j & 1) * TM * p.kc;
      if (j + 1 < chunks) copy_x(j + 1);
      cp_commit();
    }
    if (s + kStages - 1 < steps) copy_w(s + kStages - 1);  // into step s - 1's slot
    cp_commit();
    const float4* slot = ring + (s % kStages) * (kUnroll * kThreads) + tid;
    float4 wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) wv[u] = slot[u * kThreads];
    const TX* xr = xc + in_chunk + r * kUnroll;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const float4 xv = load4(xr + m * p.kc);
      fma4(acc[m], xv.x, wv[0]);
      fma4(acc[m], xv.y, wv[1]);
      fma4(acc[m], xv.z, wv[2]);
      fma4(acc[m], xv.w, wv[3]);
    }
  }
  cp_wait<0>();
  __syncthreads();                              // ring and x free: red over them

  // the row lanes' sums, [R][TM][bn], summed over lanes 0 .. R - 1
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < TM; ++m)
    *reinterpret_cast<float4*>(red + (r * TM + m) * p.bn + 4 * c) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  float* yg = y + (long long)g * p.M * p.N;
  for (int e = tid; e < TM * p.bn; e += kThreads) {
    const int m = e / p.bn, col = e - m * p.bn;
    float sum = red[e];
    for (int j = 1; j < R; ++j) sum += red[j * TM * p.bn + e];
    if (p.split == 1) {
      if (m < p.M && n0 + col < p.N) yg[(long long)m * p.N + n0 + col] = sum;
    } else {
      red[e] = sum;                             // only this thread reads red[e]
    }
  }
  if (p.split == 1) return;

  // the cluster's partial sums: rank q sums its share of the tile over
  // ranks 0 .. split - 1 in that order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = TM * p.bn / p.split;
  for (int i = tid; i < share; i += kThreads) {
    const int e = q * share + i;
    const int m = e / p.bn, col = e - m * p.bn;
    if (m < p.M && n0 + col < p.N) {
      float sum = 0.f;
      for (int j = 0; j < p.split; ++j) sum += cluster.map_shared_rank(red, j)[e];
      yg[(long long)m * p.N + n0 + col] = sum;
    }
  }
  cluster.sync();      // no CTA leaves while another reads its shared memory
}

template <int TM, typename TX>
cudaError_t launch(const void* x, const void* w, void* y, Params p, int G,
                   cudaStream_t stream) {
  const int step_rows = kThreads / (p.bn / 4) * kUnroll;
  // each CTA's slice of K: whole steps, so a slice starts on x's 16-byte grid
  p.per = ((p.K + p.split - 1) / p.split + step_rows - 1) / step_rows * step_rows;
  // x's chunk: whole steps, two buffers of TM rows within kXBytes, at
  // least two steps (the next chunk is copied a step ahead)
  int kc = kXBytes / (2 * TM * (int)sizeof(TX)) / step_rows * step_rows;
  if (kc > p.per) kc = p.per;
  if (kc < 2 * step_rows) kc = 2 * step_rows;
  p.kc = kc;
  const size_t smem = kRingBytes + (size_t)2 * TM * kc * sizeof(TX);
  auto kernel = small_mm_kernel<TM, TX>;
  // above 48 KB only after opting in (per device, so on every launch)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (p.split > kMaxPortableSplit) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  const unsigned tiles = (unsigned)((p.N + p.bn - 1) / p.bn);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * (unsigned)p.split, (unsigned)G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TX*>(x),
                         static_cast<const float*>(w), static_cast<float*>(y), p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_rows(const void* x, const void* w, void* y,
                          const Params& p, int G, cudaStream_t s) {
  if (p.M <= 1) return launch<1, TX>(x, w, y, p, G, s);
  if (p.M <= 2) return launch<2, TX>(x, w, y, p, G, s);
  if (p.M <= 4) return launch<4, TX>(x, w, y, p, G, s);
  if (p.M <= 8) return launch<8, TX>(x, w, y, p, G, s);
  return launch<16, TX>(x, w, y, p, G, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x: (G, M, K), float32 (xdtype
// 0) or bfloat16 (1), its last dim contiguous, strides sxg (0 for one x
// shared by every batch entry) and sxm, its rows on the 16-byte grid; w:
// (G, K, N) float32, strides swg and ldw, its last dim contiguous, on the
// 16-byte grid; K and N multiples of 8 and 4; y: (G, M, N) float32,
// contiguous.  bn (32, 64 or 128) and split (1, 2, 4, 8 or 16) from
// kernels/small_mm.py::plan.  Returns the cudaError_t of the launch (0 =
// cudaSuccess); arguments the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int repro_small_mm(const void* x, const void* w, void* y,
                              long long sxg, long long sxm, long long swg,
                              long long ldw, int G, int M, int K, int N,
                              int xdtype, int bn, int split, void* stream) {
  const bool bn_ok = bn == 32 || bn == 64 || bn == 128;
  const bool split_ok =
      split == 1 || split == 2 || split == 4 || split == 8 || split == 16;
  const long long xsize = xdtype == 0 ? 4 : 2;
  if (G < 1 || G > 65535 || M < 1 || M > kMaxRows || K < 1 || K % 8 != 0 ||
      N < 4 || N % 4 != 0 || ldw < N || ldw % 4 != 0 || swg < 0 || swg % 4 != 0 ||
      sxg < 0 || sxm < 0 || (sxg * xsize) % 16 != 0 || (sxm * xsize) % 16 != 0 ||
      ((uintptr_t)x & 15) != 0 || ((uintptr_t)w & 15) != 0 || !bn_ok || !split_ok ||
      split > kMaxSplit || (xdtype != 0 && xdtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (N + bn - 1) / bn;
  if (tiles * split > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Params p{sxg, sxm, swg, ldw, M, K, N, bn, split, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      xdtype == 0 ? dispatch_rows<float>(x, w, y, p, G, s)
                  : dispatch_rows<__nv_bfloat16>(x, w, y, p, G, s);
  return (int)e;
}
