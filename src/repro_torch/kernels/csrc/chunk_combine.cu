// R2CCL chunk combine for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `chunk_combine_pallas` (body `_combine_kernel`) in
// src/repro/kernels/chunk_combine.py: the stage-2 merge of R2CCL-AllReduce
// ("a customized broadcast kernel", paper Section 7).  For every row c of a
// (C, M) chunk buffer:
//
//   out[c] = seg[c] ? (acc[c] ? local[c] + recv[c] : recv[c]) : local[c]
//
// added in fp32 and rounded once to the storage type, as the plain version
// (`ref.reference_chunk_combine`) does.  fp32 or bf16, `out` may be `local`.
//
// What bounds it on the card: nothing but bytes.  A row with seg=1 and acc=1
// reads local and recv and writes out (3 x M x itemsize); with acc=0 it reads
// only recv (2x); a row with seg=0 costs nothing in place and one copy out of
// place.  The design moves exactly that:
//   * per-row control (seg, acc) travels in the kernel's parameters as two
//     bitmasks, the counterpart of the TPU kernel's scalar-prefetch operands,
//     so the host never copies masks to the card and a block reads them once;
//   * grid (blocks per row, C): a block whose row has seg=0 in place exits
//     before touching memory;
//   * no loop: each block of 128 threads moves one stretch of 128 16-byte
//     vectors of its row (8 bf16 or 4 fp32 each), one per thread, and the
//     blocks sweep the buffer in order, as PyTorch's own elementwise
//     kernels do.  On the H100 a grid-stride loop over ~2 waves of resident
//     blocks ran ~10% behind in-place `torch.add` on the same bytes; four
//     vectors a thread, streaming cache hints, or `recv` read through the
//     read-only path (`__restrict__`) were all slower than this.
//   * rows of a ragged (C, M) buffer, or a row view at an odd offset, start
//     off the 16-byte grid: the unaligned head and tail (under 16 bytes
//     each) go through scalar loads in the row's first block, so the wrapper
//     pads and copies nothing.  If the three pointers are misaligned
//     relative to each other, every block moves its stretch element by
//     element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxChunks = 1024;
constexpr int kWords = kMaxChunks / 32;

struct Masks {
  unsigned seg[kWords];
  unsigned acc[kWords];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of local + recv, added in fp32, rounded once.
__device__ __forceinline__ uint4 add16(uint4 a, uint4 b, float) {
  const float4 x = *reinterpret_cast<float4*>(&a);
  const float4 y = *reinterpret_cast<float4*>(&b);
  float4 z = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  return *reinterpret_cast<uint4*>(&z);
}
__device__ __forceinline__ uint4 add16(uint4 a, uint4 b, __nv_bfloat16) {
  uint4 r;
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]);
    const float2 fy = __bfloat1622float2(y[i]);
    z[i] = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void combine_scalar(const T* l, const T* r, T* o,
                                               long long i, bool seg,
                                               bool acc) {
  if (!seg) {
    o[i] = l[i];
  } else if (acc) {
    store(o + i, to_float(l[i]) + to_float(r[i]));
  } else {
    o[i] = r[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_combine_kernel(const T* local, const T* recv, T* out,
                     long long M, Masks masks) {
  const int c = blockIdx.y;
  const bool seg = (masks.seg[c >> 5] >> (c & 31)) & 1u;
  const bool acc = (masks.acc[c >> 5] >> (c & 31)) & 1u;
  if (!seg && out == local) return;          // in place: nothing to move
  const size_t base = (size_t)c * (size_t)M;
  const T* l = local + base;
  const T* r = recv + base;
  T* o = out + base;

  constexpr int V = 16 / sizeof(T);
  constexpr long long kStretch = (long long)kThreads * V;
  const unsigned al = (unsigned)((uintptr_t)l & 15);
  if (al != ((uintptr_t)r & 15) || al != ((uintptr_t)o & 15)) {
    // misaligned against each other: this block's stretch, element by element
    const long long end = min(M, (blockIdx.x + 1) * kStretch);
    for (long long i = blockIdx.x * kStretch + threadIdx.x; i < end; i += kThreads)
      combine_scalar(l, r, o, i, seg, acc);
    return;
  }
  long long head = al ? (long long)((16 - al) / sizeof(T)) : 0;
  if (head > M) head = M;
  const long long nvec = (M - head) / V;
  if (blockIdx.x == 0) {      // the scalar head and tail: under 16 bytes each
    for (long long i = threadIdx.x; i < head; i += kThreads)
      combine_scalar(l, r, o, i, seg, acc);
    for (long long i = head + nvec * V + threadIdx.x; i < M; i += kThreads)
      combine_scalar(l, r, o, i, seg, acc);
  }

  const uint4* lv = reinterpret_cast<const uint4*>(l + head);
  const uint4* rv = reinterpret_cast<const uint4*>(r + head);
  uint4* ov = reinterpret_cast<uint4*>(o + head);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nvec) return;
  if (!seg)
    ov[i] = lv[i];
  else if (!acc)
    ov[i] = rv[i];
  else
    ov[i] = add16(lv[i], rv[i], T());
}

template <typename T>
cudaError_t launch(const void* local, const void* recv, void* out, int C,
                   long long M, const Masks& masks, cudaStream_t stream) {
  constexpr long long per_block = (long long)kThreads * (16 / sizeof(T));
  long long bx = (M + per_block - 1) / per_block;
  if (bx < 1) bx = 1;
  if (bx > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)bx, (unsigned)C);
  chunk_combine_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(local), static_cast<const T*>(recv),
      static_cast<T*>(out), M, masks);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtype: 0 = fp32, 1 = bf16.
// seg and acc are host arrays of C bytes (0 or 1).  Returns the cudaError_t
// of the launch (0 = cudaSuccess); arguments the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int repro_chunk_combine(const void* local, const void* recv,
                                   void* out, const unsigned char* seg,
                                   const unsigned char* acc, int dtype, int C,
                                   long long M, void* stream) {
  if (C < 1 || C > kMaxChunks || M < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  Masks masks = {};
  for (int c = 0; c < C; ++c) {
    if (seg[c]) masks.seg[c >> 5] |= 1u << (c & 31);
    if (acc[c]) masks.acc[c >> 5] |= 1u << (c & 31);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? launch<float>(local, recv, out, C, M, masks, s)
                 : launch<__nv_bfloat16>(local, recv, out, C, M, masks, s);
  return (int)e;
}
