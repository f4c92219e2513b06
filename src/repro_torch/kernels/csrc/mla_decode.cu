// MLA decode's attention over the latent cache for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces no Pallas kernel: the JAX package computes MLA's absorbed decode
// in jnp (src/repro/models/mla.py), and the port computed it in plain
// PyTorch (two cuBLAS float32 products over every slot of the cache, then
// some ten elementwise passes over the (B, H, S) scores).  This kernel
// computes, for each row b and head h,
//
//   ctx[b, h, :] = softmax_s(scale * (q_abs[b, h, :] . c_kv[b, s, :]
//                                     + q_pe[b, h, :] . k_pe[b, s, :])) c_kv[b, s, :]
//
// over the slots s < L = min(pos + 1, S) that hold a token (pos, the
// position written this step, is read from the device, so a CUDA graph
// replays the launch as the cache's index advances; all S slots once pos >=
// S, the ring).  q_abs (B, H, 512) and q_pe (B, H, 64) float32; c_kv
// (B, S, 512) and k_pe (B, S, 64) float32 or bfloat16; ctx (B, H, 512)
// float32.  The plain version is kernels/ref.py::reference_mla_decode.
//
// What bounds it on the card: operations.  A row of a layer does
// 2 * H * L * (576 + 512) of them and reads L * 576 cache elements, which
// serve all H = 128 heads: 444 FLOP a byte of an fp32 cache, far above the
// card's ridge.  Float32-accurate products on the tensor cores are 3xTF32,
// 165 TFLOP/s (67 on the CUDA cores): at 8 rows, a live length of 2048 and
// 10 layers, 45.6 GFLOP take 0.28 ms at that peak.  On an H100 (700 W) those
// 10 calls take 1.14 ms, and with a bf16 cache (two products a term) 0.80:
// the time follows the count of mma.sync, whose TF32 rate (~120 TFLOP/s
// here) is a quarter of wgmma's.
//
// The design (flash-decoding over MLA's one shared latent "head"):
//   * Split over the cache.  A CTA takes one row, HB = 32 heads (so four
//     CTAs share each cache tile through L2) and one split of the live
//     slots: the live tiles of BN = 32 slots are dealt evenly to the
//     `nsplit` splits, which the host sizes from the rows so that a call of
//     1 to 16 rows fills the 132 SMs.  A split with no live tile writes an
//     empty partial and exits.  A second kernel merges the splits' partial
//     (max, sum, context) per head in a fixed order.
//   * Each tile (its 32 slots' c_kv and k_pe, 576 values a slot) comes into
//     shared memory with cp.async, one tile ahead of the one being used.
//   * Scores on the tensor cores, mma.sync in 3xTF32 (hi/lo splits, small
//     terms first; a bf16 cache value is exact in TF32, so its low part is 0
//     and its product term is skipped).  The 576-deep product is split over
//     the 8 warps, 72 deep each, so that each warp keeps its slice of the
//     CTA's 32 query rows in registers for the whole call; the 8 partial
//     score tiles meet in shared memory and are summed in a fixed order.
//   * The online softmax (fp32, expf) runs on the summed tile in shared
//     memory, 8 threads a head; the probabilities stay in fp32 (also for a
//     bf16 cache) and never reach device memory.
//   * P C on the tensor cores, 3xTF32, the 512 context dims split over the
//     8 warps (64 each), the sums in registers, rescaled by each tile's
//     correction of the running max.
//   * No atomics: the same bits on every call, in a CUDA graph or not.  No
//     allocation and no host sync: the wrapper allocates the output and the
//     partials with torch.empty.

#include <math.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int R = 512;             // kv_lora_rank: c_kv's width, the context's
constexpr int P = 64;              // qk_rope_head_dim: k_pe's width
constexpr int D = R + P;           // the scores' depth
constexpr int WARPS = 8, NT = 32 * WARPS;
constexpr int HB = 32;             // heads a CTA
constexpr int BN = 32;             // slots a tile
constexpr int KW = D / WARPS;      // 72: depth a warp takes in the scores
constexpr int KS = KW / 8;         // its k-steps of 8
constexpr int RW = R / WARPS;      // 64: context dims a warp takes in P C
constexpr int MT = HB / 16;        // 16-row (head) tiles
constexpr int NS = BN / 8;         // 8-slot tiles of the scores
constexpr int NO = RW / 8;         // 8-dim tiles of a warp's context
constexpr int LDS = BN + 8;        // row stride (floats) of the score tiles

// row stride (elements) of a cache tile: 16 bytes of padding, so that the
// fragment loads hit distinct banks
template <typename T>
__host__ __device__ constexpr int ldk() { return D + 16 / (int)sizeof(T); }

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * 2 * BN * ldk<T>()                 // two cache tiles
         + sizeof(float) * (WARPS + 1) * HB * LDS       // partial scores, P
         + sizeof(float) * HB;                          // corrections
}

// a cache value is exact in TF32 when it is a widened bf16
template <typename T>
struct Exact { static constexpr bool value = false; };
template <>
struct Exact<__nv_bfloat16> { static constexpr bool value = true; };

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// B operand (k x 8) of a cache tile: hi, and lo unless the value is exact
template <typename T>
struct BFrag {
  uint32_t h[2], l[2];
  __device__ __forceinline__ void set(int i, float x) {
    if (Exact<T>::value) h[i] = bits(x);
    else split(x, h[i], l[i]);
  }
};

struct AFrag {
  uint32_t h[4], l[4];
  __device__ __forceinline__ void set(int i, float x) { split(x, h[i], l[i]); }
};

// c += a b in 3xTF32, small terms first; 2 products for an exact b
template <typename T>
__device__ __forceinline__ void mma3(float* c, const AFrag& a, const BFrag<T>& b) {
  mma_tf32(c, a.l, b.h);
  if (!Exact<T>::value) mma_tf32(c, a.h, b.l);
  mma_tf32(c, a.h, b.h);
}

struct Params {
  const float* q_abs;        // (B, H, R)
  const float* q_pe;         // (B, H, P)
  const void* c_kv;          // (B, S, R), batch stride skv
  const void* k_pe;          // (B, S, P), batch stride spe
  const long long* index;    // the position on the device, or null
  long long pos;             // ... else this one
  float* o_part;             // (B, H, nsplit, R): unnormalised context
  float* ml_part;            // (B, H, nsplit, 2): running max, sum
  float* out;                // (B, H, R)
  float* lse;                // (B, H) or null
  long long skv, spe;
  int B, H, S, nsplit;
  float scale;
};

__device__ __forceinline__ int live_slots(const Params& p) {
  const long long pos = p.index != nullptr ? *p.index : p.pos;
  const long long L = pos + 1 < (long long)p.S ? pos + 1 : (long long)p.S;
  return L > 0 ? (int)L : 0;
}

// slots [s0, s0 + BN) of row b into a shared tile; zeros past L
template <typename T>
__device__ __forceinline__ void load_tile(const Params& p, int b, int s0, int L,
                                          T* tile) {
  constexpr int V = 16 / sizeof(T);           // elements a 16-byte copy
  constexpr int CR = R / V, CP = P / V;       // copies a slot's c_kv, k_pe
  constexpr int LD = ldk<T>();
  const T* ckv = static_cast<const T*>(p.c_kv) + (size_t)b * p.skv;
  const T* kpe = static_cast<const T*>(p.k_pe) + (size_t)b * p.spe;
#pragma unroll
  for (int i = threadIdx.x; i < BN * (CR + CP); i += NT) {
    const int r = i / (CR + CP), c = i % (CR + CP);
    const int s = s0 + r;
    const bool ok = s < L;
    const T* src = c < CR ? ckv + (size_t)(ok ? s : 0) * R + c * V
                          : kpe + (size_t)(ok ? s : 0) * P + (c - CR) * V;
    cp16(tile + r * LD + c * V, src, ok);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
mla_decode_kernel(Params p) {
  constexpr int LD = ldk<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);                        // 2 x BN x LD
  float* spart = reinterpret_cast<float*>(tiles + 2 * BN * LD); // WARPS x HB x LDS
  float* p_s = spart + WARPS * HB * LDS;                        // HB x LDS
  float* corr_s = p_s + HB * LDS;                               // HB

  const int hg = blockIdx.x, split_i = blockIdx.y, b = blockIdx.z;
  const int h0 = hg * HB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // the softmax's role of this thread: head rh of the CTA, slots 4 rq ..
  const int rh = threadIdx.x >> 3, rq = threadIdx.x & 7;

  const int L = live_slots(p);
  const int ntiles = (L + BN - 1) / BN;
  const int per = (ntiles + p.nsplit - 1) / p.nsplit;
  const int t0 = split_i * per;
  const int t1 = min(t0 + per, ntiles);
  const size_t part = ((size_t)b * p.H + h0 + rh) * p.nsplit + split_i;
  if (t0 >= t1) {                      // no live slot in this split
    if (rq == 0 && h0 + rh < p.H) {
      p.ml_part[2 * part] = -INFINITY;
      p.ml_part[2 * part + 1] = 0.f;
    }
    return;
  }

  load_tile<T>(p, b, t0 * BN, L, tiles);
  cp_commit();

  // this warp's slice of the queries, depth [KW warp, KW warp + KW), as A
  // fragments: element (g | g + 8, t | t + 4) of each 16 x 8 block
  float qa[MT][KS][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = h0 + 16 * mi + g + 8 * (e & 1);
        const int k = KW * warp + 8 * ks + t + 4 * (e >> 1);
        float x = 0.f;
        if (h < p.H)
          x = k < R ? p.q_abs[((size_t)b * p.H + h) * R + k]
                    : p.q_pe[((size_t)b * p.H + h) * P + k - R];
        qa[mi][ks][e] = x;
      }

  float acc[MT][NO][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NO; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;     // head rh's, over this thread's slots

  for (int it = t0; it < t1; ++it) {
    const T* tile = tiles + ((it - t0) & 1) * BN * LD;
    cp_wait<0>();
    __syncthreads();     // tile `it` has landed; every warp is done with it - 1
    if (it + 1 < t1) load_tile<T>(p, b, (it + 1) * BN, L,
                                  tiles + ((it + 1 - t0) & 1) * BN * LD);
    cp_commit();

    // partial scores over this warp's depth: HB heads x BN slots
    float s[MT][NS][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NS; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][ni][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      AFrag a[MT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        a[mi].set(0, qa[mi][ks][0]);
        a[mi].set(1, qa[mi][ks][1]);
        a[mi].set(2, qa[mi][ks][2]);
        a[mi].set(3, qa[mi][ks][3]);
      }
      const int k0 = KW * warp + 8 * ks;
#pragma unroll
      for (int ni = 0; ni < NS; ++ni) {
        // B[k][n] = tile[8 ni + n][k0 + k]
        const T* r = tile + (8 * ni + g) * LD + k0 + t;
        BFrag<T> bf;
        bf.set(0, to_float(r[0]));
        bf.set(1, to_float(r[4]));
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma3<T>(s[mi][ni], a[mi], bf);
      }
    }
    float* mine = spart + warp * HB * LDS;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NS; ++ni) {
        float* row = mine + (16 * mi + g) * LDS + 8 * ni + 2 * t;
        *reinterpret_cast<float2*>(row) = make_float2(s[mi][ni][0], s[mi][ni][1]);
        *reinterpret_cast<float2*>(row + 8 * LDS) =
            make_float2(s[mi][ni][2], s[mi][ni][3]);
      }
    __syncthreads();

    // sum the warps' partials (warp 0 first), scale, mask, online softmax:
    // head rh, slots 4 rq .. 4 rq + 3 of the tile
    {
      float4 x = *reinterpret_cast<const float4*>(spart + rh * LDS + 4 * rq);
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        const float4 y =
            *reinterpret_cast<const float4*>(spart + (w * HB + rh) * LDS + 4 * rq);
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      float v[4] = {x.x * p.scale, x.y * p.scale, x.z * p.scale, x.w * p.scale};
      const int s0 = it * BN + 4 * rq;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (s0 + i >= L) v[i] = -INFINITY;
        mx = fmaxf(mx, v[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run, mx);        // finite: slot it * BN is live
      const float c = expf(m_run - m_new);         // 0 on the first tile
      m_run = m_new;
      float pr[4], sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = v[i] == -INFINITY ? 0.f : expf(v[i] - m_new);
        sum += pr[i];
      }
      l_run = l_run * c + sum;
      *reinterpret_cast<float4*>(p_s + rh * LDS + 4 * rq) =
          make_float4(pr[0], pr[1], pr[2], pr[3]);
      if (rq == 0) corr_s[rh] = c;
    }
    __syncthreads();

    // acc = corr acc + P C over this warp's 64 context dims
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const float c0 = corr_s[16 * mi + g], c8 = corr_s[16 * mi + g + 8];
#pragma unroll
      for (int ni = 0; ni < NO; ++ni) {
        acc[mi][ni][0] *= c0;
        acc[mi][ni][1] *= c0;
        acc[mi][ni][2] *= c8;
        acc[mi][ni][3] *= c8;
      }
    }
#pragma unroll
    for (int kc = 0; kc < BN / 8; ++kc) {
      // A = P[:, 8 kc ..], k permuted (2t, 2t + 1 -> t, t + 4) as B below
      AFrag a[MT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const float2 r0 = *reinterpret_cast<const float2*>(
            p_s + (16 * mi + g) * LDS + 8 * kc + 2 * t);
        const float2 r8 = *reinterpret_cast<const float2*>(
            p_s + (16 * mi + g + 8) * LDS + 8 * kc + 2 * t);
        a[mi].set(0, r0.x);
        a[mi].set(1, r8.x);
        a[mi].set(2, r0.y);
        a[mi].set(3, r8.y);
      }
#pragma unroll
      for (int ni = 0; ni < NO; ++ni) {
        // B[k][n] = tile[8 kc + k'][RW warp + 8 ni + n], k' = 2t, 2t + 1
        const T* r = tile + (8 * kc + 2 * t) * LD + RW * warp + 8 * ni + g;
        BFrag<T> bf;
        bf.set(0, to_float(r[0]));
        bf.set(1, to_float(r[LD]));
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) mma3<T>(acc[mi][ni], a[mi], bf);
      }
    }
  }
  cp_wait<0>();

  // this split's partial: the running max and sum of each head, and the
  // unnormalised context
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 4);
  if (rq == 0 && h0 + rh < p.H) {
    p.ml_part[2 * part] = m_run;
    p.ml_part[2 * part + 1] = l_run;
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int h = h0 + 16 * mi + g + 8 * e2;
      if (h >= p.H) continue;
      float* row = p.o_part + (((size_t)b * p.H + h) * p.nsplit + split_i) * R + RW * warp;
#pragma unroll
      for (int ni = 0; ni < NO; ++ni)
        *reinterpret_cast<float2*>(row + 8 * ni + 2 * t) =
            make_float2(acc[mi][ni][2 * e2], acc[mi][ni][2 * e2 + 1]);
    }
}

// ctx[b, h] = sum_j e^(m_j - M) o_j / sum_j e^(m_j - M) l_j over the
// splits j in order, M their max; lse = M + log of the denominator.  One
// CTA a (b, h), 4 context dims a thread.  An empty split (l_j = 0, its
// context never written) weighs 0 and reads split 0's, which is never
// empty: every load is unconditional, so they overlap.
__global__ void __launch_bounds__(R / 4)
mla_decode_combine(Params p) {
  const size_t bh = blockIdx.x;
  const float* ml = p.ml_part + bh * p.nsplit * 2;
  const float4* o = reinterpret_cast<const float4*>(p.o_part + bh * p.nsplit * R);
  float M = -INFINITY;
  for (int j = 0; j < p.nsplit; ++j) M = fmaxf(M, ml[2 * j]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
#pragma unroll 4
  for (int j = 0; j < p.nsplit; ++j) {
    const float l = ml[2 * j + 1];
    const bool live = l > 0.f;
    const float w = live ? expf(ml[2 * j] - M) : 0.f;
    den += w * l;
    const float4 x = o[(live ? j : 0) * (R / 4) + threadIdx.x];
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  reinterpret_cast<float4*>(p.out + bh * R)[threadIdx.x] =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  if (p.lse != nullptr && threadIdx.x == 0)
    p.lse[bh] = den > 0.f ? M + logf(den) : -INFINITY;
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  // above 48 KB only after opting in (per device, so on every launch)
  cudaError_t e = cudaFuncSetAttribute(
      mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.H + HB - 1) / HB, p.nsplit, p.B);
  mla_decode_kernel<T><<<grid, NT, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mla_decode_combine<<<(unsigned)((long long)p.B * p.H), R / 4, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtype: the cache's, 0 = fp32,
// 1 = bf16.  index: an int64 on the device holding the position, or null for
// `pos`.  o_part (B, H, nsplit, 512) and ml_part (B, H, nsplit, 2) fp32
// scratch; out (B, H, 512) fp32; lse (B, H) fp32 or null.  c_kv's and
// k_pe's slots contiguous rows, their batch strides skv, spe (elements).
// Returns the cudaError_t of the launches (0 = cudaSuccess); shapes the
// kernel does not take return cudaErrorInvalidValue without launching.
extern "C" int repro_mla_decode(const void* q_abs, const void* q_pe, const void* c_kv,
                                const void* k_pe, const void* index, long long pos,
                                void* o_part, void* ml_part, void* out, void* lse,
                                int dtype, int B, int H, int S, long long skv,
                                long long spe, int nsplit, float scale, void* stream) {
  const int elt = dtype == 0 ? 4 : 2;
  if (B < 1 || H < 1 || S < 1 || nsplit < 1 || B > 65535 || nsplit > 65535 ||
      (dtype != 0 && dtype != 1) || (skv * elt) % 16 || (spe * elt) % 16 ||
      !aligned16(c_kv) || !aligned16(k_pe) || !aligned16(o_part) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(q_abs), static_cast<const float*>(q_pe),
                 c_kv, k_pe, static_cast<const long long*>(index), pos,
                 static_cast<float*>(o_part), static_cast<float*>(ml_part),
                 static_cast<float*>(out), static_cast<float*>(lse), skv, spe, B, H, S,
                 nsplit, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? launch<float>(p, s) : launch<__nv_bfloat16>(p, s);
  return (int)e;
}
