// Helpers shared by the port's Hopper (sm_90a) kernels: element conversion,
// cp.async, and mma.sync tensor-core fragments for fp32 (as 3xTF32) and
// bf16.  Included by flash_attention.cu, flash_attention_bwd.cu,
// wkv_scan.cu and lru_scan.cu; kernels/build.py hashes this file into every
// library's name, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// a pointer on the 16-byte grid, as cp16 needs
inline bool aligned16(const void* x) { return ((uintptr_t)x & 15) == 0; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---- cp.async ---------------------------------------------------------------

// copy 16 (or 4) bytes global -> shared; with ok false, write zeros instead
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- tensor-core fragments --------------------------------------------------
//
// m16n8k8 tf32 (A 16x8 row, B 8x8 col, C 16x8), lane = 4 g + t:
//   A: (g, t) (g+8, t) (g, t+4) (g+8, t+4);  B: (k=t, n=g) (k=t+4, n=g);
//   C: (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1).
// m16n8k16 bf16: A pairs (g, 2t..) (g+8, 2t..) (g, 2t+8..) (g+8, 2t+8..);
//   B pairs (k=2t.., n=g) (k=2t+8.., n=g); C as above.

template <typename T>
struct Mma;

// hi = x with its low 13 bits cleared (a tf32, exactly), lo = x - hi (exact
// in fp32; the tensor core reads only its top 19 bits): |x - hi - lo| is
// below 2^-21 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
struct Mma<float> {
  static constexpr int K = 8;
  struct A { uint32_t h[4], l[4]; };
  struct B { uint32_t h[2], l[2]; };

  // A = X[m0 + i][k0 + j] from a row-major shared tile
  static __device__ __forceinline__ A load_a(const float* s, int ld, int m0,
                                             int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* r0 = s + (m0 + g) * ld + k0 + t;
    const float* r8 = r0 + 8 * ld;
    A a;
    split(r0[0], a.h[0], a.l[0]);
    split(r8[0], a.h[1], a.l[1]);
    split(r0[4], a.h[2], a.l[2]);
    split(r8[4], a.h[3], a.l[3]);
    return a;
  }
  // A = chunk kc of a 16 x (8 n) accumulator, k permuted (2t, 2t+1 -> t, t+4)
  static __device__ __forceinline__ A from_c(float (*c)[4], int kc) {
    A a;
    split(c[kc][0], a.h[0], a.l[0]);
    split(c[kc][2], a.h[1], a.l[1]);
    split(c[kc][1], a.h[2], a.l[2]);
    split(c[kc][3], a.h[3], a.l[3]);
    return a;
  }
  // B[k][n] = X[n0 + n][k0 + k]  (X row-major: S = Q K^T takes K so)
  static __device__ __forceinline__ B load_b_nt(const float* s, int ld, int n0,
                                                int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* r = s + (n0 + g) * ld + k0 + t;
    B b;
    split(r[0], b.h[0], b.l[0]);
    split(r[4], b.h[1], b.l[1]);
    return b;
  }
  // B[k][n] = X[k0 + k][n0 + n], k permuted as in from_c
  static __device__ __forceinline__ B load_b_nn(const float* s, int ld, int k0,
                                                int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* r = s + (k0 + 2 * t) * ld + n0 + g;
    B b;
    split(r[0], b.h[0], b.l[0]);
    split(r[ld], b.h[1], b.l[1]);
    return b;
  }
  // c += a b in 3xTF32: the small terms first
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) {
    mma_tf32(c, a.l, b.h);
    mma_tf32(c, a.h, b.l);
    mma_tf32(c, a.h, b.h);
  }
};

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int K = 16;
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };

  static __device__ __forceinline__ uint32_t word(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ A load_a(const T* s, int ld, int m0,
                                             int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const T* r0 = s + (m0 + g) * ld + k0 + 2 * t;
    const T* r8 = r0 + 8 * ld;
    return A{{word(r0), word(r8), word(r0 + 8), word(r8 + 8)}};
  }
  // A = columns 16 kc .. 16 kc + 15 of the accumulator: tiles 2 kc, 2 kc + 1
  static __device__ __forceinline__ A from_c(float (*c)[4], int kc) {
    const float* lo = c[2 * kc];
    const float* hi = c[2 * kc + 1];
    return A{{pack(lo[0], lo[1]), pack(lo[2], lo[3]), pack(hi[0], hi[1]),
              pack(hi[2], hi[3])}};
  }
  static __device__ __forceinline__ B load_b_nt(const T* s, int ld, int n0,
                                                int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const T* r = s + (n0 + g) * ld + k0 + 2 * t;
    return B{{word(r), word(r + 8)}};
  }
  static __device__ __forceinline__ B load_b_nn(const T* s, int ld, int k0,
                                                int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const T* r = s + (k0 + 2 * t) * ld + n0 + g;
    return B{{pack(r[0], r[ld]), pack(r[8 * ld], r[9 * ld])}};
  }
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) {
    mma_bf16(c, a.x, b.x);
  }
};

// ---- shared tiles -----------------------------------------------------------

// row stride (elements) of a shared tile of DP columns: 16 bytes of padding,
// so that the fragment loads above hit 32 distinct banks
template <typename T>
__host__ __device__ constexpr int ld_of(int DP) {
  return DP + 16 / (int)sizeof(T);
}

// zero columns D .. DP-1 of `rows` rows of stride ld_of<T>(DP), which
// cp.async never writes
template <typename T, int DP, int NT>
__device__ __forceinline__ void zero_pad(int D, T* s, int rows) {
  constexpr int LD = ld_of<T>(DP);
  const int w = DP - D;
  if (w <= 0) return;
  for (int i = threadIdx.x; i < rows * w; i += NT)
    s[(i / w) * LD + D + i % w] = from_float<T>(0.f);
}

// Rows k0 .. k0 + n - 1 of a (B, Tk, KVH, D) tensor at (b, h) into a shared
// tile of stride ld_of<T>(DP); zero past Tk.  `vec`: rows start on the
// 16-byte grid, so cp.async moves 16 bytes at a time; else plain loads.
template <typename T, int DP, int NT>
__device__ __forceinline__ void load_kv_rows(const T* x, int b, int h, int k0,
                                             int n, int Tk, int KVH, int D,
                                             bool vec, T* s) {
  constexpr int LD = ld_of<T>(DP);
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = D / V;
    for (int i = threadIdx.x; i < n * cpr; i += NT) {
      const int r = i / cpr, col = (i % cpr) * V;
      const bool ok = k0 + r < Tk;
      const size_t off =
          ok ? (((size_t)b * Tk + k0 + r) * KVH + h) * D + col : 0;
      cp16(s + r * LD + col, x + off, ok);
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += NT) {
      const int r = i / D, col = i % D;
      const bool ok = k0 + r < Tk;
      const size_t off =
          ok ? (((size_t)b * Tk + k0 + r) * KVH + h) * D + col : 0;
      s[r * LD + col] = ok ? x[off] : from_float<T>(0.f);
    }
  }
}

}  // namespace hopper
