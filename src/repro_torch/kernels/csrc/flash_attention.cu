// Flash-attention forward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_flash_kernel`) in
// src/repro/kernels/flash_attention.py.  Same function: online-softmax GQA
// attention with the causal, sliding-window, prefix-LM and logit-softcap
// masks and fp32 running max / sum / accumulator, plus the `q_offset` and
// `k_valid_len` of the model's blockwise attention.  The ragged q and k
// edges are masked here by the true lengths: the wrapper pads nothing.
//
// Layout (the JAX package's): q (B, Tq, KVH, G, D), k and v (B, Tk, KVH, D),
// all contiguous, fp32 or bf16 (template), output like q.  D <= 256, G <= 64.
// A "row" is one (position, query head) pair of a kv head, r = t * G + g:
// the G heads of a kv head share its K and V, so a CTA takes a run of rows
// of one (batch, kv head) and every K/V tile it stages feeds all of them.
//
// For training, the kernel also writes each row's log-sum-exp of the scaled
// (and capped) scores, lse = m + log(l), -inf for a row that sees no key, to
// an optional fp32 array laid out like q without D: (B, Tq, KVH, G).  The
// backward kernel (flash_attention_bwd.cu) recomputes P = exp(S - lse) from
// it.  Prefill passes no array and writes nothing more.
//
// What bounds it on the card: 4 D operations per visible (row, key) pair.
// At the serving prefill shape (smollm-360m, B=4, T=512, KVH=5, G=3, D=64,
// fp32) that is 2.0 GFLOP against 21 MB of q/k/v/o, and at recurrentgemma-9b's
// local attention (B=2, T=2304, KVH=1, G=16, D=256, window 2048) 86 GFLOP
// against 160 MB: far above the card's ridge, so bound by the tensor cores,
// fp32-accurate work as 3xTF32 (0.0122 and 0.5208 ms).
//
// The design (FlashAttention-2's, on mma.sync):
//   * Products on the tensor cores: S = Q K^T and O += P V with mma.sync,
//     fp32 as 3xTF32 (hi/lo split, three m16n8k8 products, small terms
//     first), bf16 as m16n8k16 with fp32 sums; P goes from the S accumulator
//     registers straight into the A fragment of P V (hopper_mma.cuh), rounded
//     to bf16 only there for bf16 inputs.
//   * The online softmax in registers: each warp owns 16 rows, a thread two
//     of them; a row's max and sum reduce over the four lanes of a quad with
//     shuffles (the sum only once, at the end: the lanes' partial sums are
//     rescaled alike), and the rescale is applied to the output accumulators
//     in place.  A masked score is -inf and gives p = 0, the running max
//     starts at -1e30, so a row that sees no key gives 0 and lse -inf.
//   * K and V tiles asynchronous with cp.async, one buffer each, staggered:
//     V of tile j loads while S = Q K_j^T multiplies, K of tile j + 1 while
//     the softmax and P V_j run.  At head_dim 256 fp32 a 128-row Q tile and a
//     double buffer of 32-key K and V tiles would need 266 KB; the staggered
//     buffers need 200 KB, one CTA of 8 warps an SM.
//   * Tiles (`Tiles`): 64 rows (4 warps) and 64-key tiles up to head_dim
//     128, three or two CTAs an SM; 128 rows (8 warps) and 32-key tiles at
//     256, so that 128 rows (8 positions of recurrentgemma's 16 heads, not
//     the first version's 4) share every K/V tile streamed from L2.
//   * Per tile and warp, the kernel visits only key tiles that hold a
//     visible key for some row of the CTA, skips the products of a warp
//     none of whose rows sees a key of the tile, and evaluates the mask pair
//     by pair only where some pair of the warp's block is hidden
//     (`key_tiles`, `classify`; kernels/flash_attention.py::fwd_plan computes
//     the same, and the CPU tests check it).  CTAs go out longest first (the
//     last query tiles under the causal mask).
//   * No cross-CTA sum: two calls on the same inputs give the same bits.

#include <math.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr float kNegInit = -1e30f;  // reference's running-max init
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  int B, Tq, Tk, KVH, G, D;
  int causal;
  int has_window, window;
  int has_prefix, prefix_len;
  int has_cap;
  float cap;
  float scale;
  int q_offset;
  int has_kvl, k_valid_len;
  int vec;     // rows start on the 16-byte grid: cp.async 16 bytes at a time
};

// warps of 16 query rows per CTA, keys per K/V tile, and the CTAs an SM the
// kernel is built for; kernels/flash_attention.py::fwd_tiles mirrors it
template <typename T, int DP>
struct Tiles {
  static constexpr int WARPS = DP == 256 ? 8 : 4;
  static constexpr int BK = DP == 256 ? 32 : 64;
  static constexpr int MINB = DP <= 64 ? 3 : (DP == 128 ? 2 : 1);
};

// ---- the per-tile plan (mirrored by flash_attention.py::fwd_plan) ----------

// keys past the tensor or past the cache's fill level are never visible
__host__ __device__ inline int key_end(const Params& p) {
  return p.has_kvl && p.k_valid_len < p.Tk ? p.k_valid_len : p.Tk;
}

// Key tiles [lo, hi) (of `bk` keys) holding a visible key for some row of
// [r0, r1): up to the last row's position (or the prefix) under the causal
// mask, from the first row's position - window + 1 with a window.
__host__ __device__ inline void key_tiles(const Params& p, int r0, int r1,
                                          int bk, int& lo, int& hi) {
  const int qa = p.q_offset + r0 / p.G, qb = p.q_offset + (r1 - 1) / p.G;
  int khi = key_end(p);
  if (p.causal) {
    int lim = qb + 1;
    if (p.has_prefix && p.prefix_len > lim) lim = p.prefix_len;
    if (lim < khi) khi = lim;
  }
  int klo = 0;
  if (p.has_window && qa - p.window + 1 > 0) klo = qa - p.window + 1;
  lo = klo / bk;
  hi = klo < khi ? (khi + bk - 1) / bk : lo;
}

enum { kSkip = 0, kMasked = 1, kFull = 2 };

// What a warp does with key tile [k0, k0 + bk) for its rows [r0, r1) (r1
// clipped to the last row): kSkip if no pair is visible, kFull if every
// pair is, else kMasked.
__host__ __device__ inline int classify(const Params& p, int r0, int r1,
                                        int k0, int bk) {
  if (r0 >= r1) return kSkip;
  const int qa = p.q_offset + r0 / p.G, qb = p.q_offset + (r1 - 1) / p.G;
  const int kb = k0 + bk - 1, kend = key_end(p);
  const bool in_prefix = p.has_prefix && k0 < p.prefix_len;
  if (k0 >= kend || (p.causal && k0 > qb && !in_prefix) ||
      (p.has_window && qa - kb >= p.window))
    return kSkip;
  bool full = kb < kend;
  if (p.causal) full = full && (kb <= qa || (p.has_prefix && kb < p.prefix_len));
  if (p.has_window) full = full && (qb - k0 < p.window);
  return full ? kFull : kMasked;
}

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp,
                                        int kend) {
  bool ok = kp < kend;
  if (p.causal) ok = ok && (kp <= qp || (p.has_prefix && kp < p.prefix_len));
  if (p.has_window) ok = ok && (qp - kp < p.window);
  return ok;
}

// element offset / D of row r (= t * G + g) of (batch b, kv head h)
__device__ __forceinline__ size_t row_off(const Params& p, int b, int h,
                                          int r) {
  return (((size_t)b * p.Tq + r / p.G) * p.KVH + h) * (size_t)p.G +
         (size_t)(r % p.G);
}

// rows r0 .. r0 + n - 1 of q into a shared tile; zero past the last row
template <typename T, int DP, int NT>
__device__ __forceinline__ void load_q(const Params& p, const T* q, int b,
                                       int h, int r0, int n, T* s) {
  constexpr int LD = ld_of<T>(DP);
  const int nr = p.Tq * p.G;
  if (p.vec) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = p.D / V;
    for (int i = threadIdx.x; i < n * cpr; i += NT) {
      const int r = i / cpr, col = (i % cpr) * V;
      const bool ok = r0 + r < nr;
      const size_t off = ok ? row_off(p, b, h, r0 + r) * p.D + col : 0;
      cp16(s + r * LD + col, q + off, ok);
    }
  } else {
    for (int i = threadIdx.x; i < n * p.D; i += NT) {
      const int r = i / p.D, col = i % p.D;
      const bool ok = r0 + r < nr;
      const size_t off = ok ? row_off(p, b, h, r0 + r) * p.D + col : 0;
      s[r * LD + col] = ok ? q[off] : from_float<T>(0.f);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(32 * Tiles<T, DP>::WARPS, Tiles<T, DP>::MINB)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Params p) {
  using M = Mma<T>;
  constexpr int NT = 32 * Tiles<T, DP>::WARPS;
  constexpr int BM = 16 * Tiles<T, DP>::WARPS;   // query rows per CTA
  constexpr int BK = Tiles<T, DP>::BK;           // keys per K/V tile
  constexpr int LD = ld_of<T>(DP);
  constexpr int NK = BK / 8;                     // 8-key blocks of S
  constexpr int ND = DP / 8;                     // 8-column blocks of O
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);           // BM x LD
  T* k_s = q_s + BM * LD;                        // BK x LD
  T* v_s = k_s + BK * LD;                        // BK x LD

  const int nr = p.Tq * p.G;
  const int nqt = (nr + BM - 1) / BM;
  const int BH = p.B * p.KVH;
  const int item = blockIdx.x;                   // (query tile, b, h)
  const int qt = p.causal ? nqt - 1 - item / BH : item / BH;  // longest first
  const int b = (item % BH) / p.KVH, h = (item % BH) % p.KVH;
  const int r0 = qt * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = r0 + warp * 16, wr1 = min(wr0 + 16, nr);  // this warp's rows
  const int kend = key_end(p);

  int lo, hi;
  key_tiles(p, r0, min(r0 + BM, nr), BK, lo, hi);
  const int n = hi - lo;

  zero_pad<T, DP, NT>(p.D, q_s, BM + 2 * BK);
  load_q<T, DP, NT>(p, q, b, h, r0, BM, q_s);
  cp_commit();
  if (n > 0)
    load_kv_rows<T, DP, NT>(k, b, h, lo * BK, BK, p.Tk, p.KVH, p.D, p.vec, k_s);
  cp_commit();

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // this thread's rows wr0 + g and wr0 + g + 8: position, running max, and
  // the thread's partial running sum (over its columns 2t, 2t + 1 of each
  // 8-key block; the quad's four partials are summed at the end)
  int qp[2];
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) qp[i] = p.q_offset + (wr0 + g + 8 * i) / p.G;

  for (int it = 0; it < n; ++it) {
    const int k0 = (lo + it) * BK;
    // V_j into its buffer (the last tile's P V is done with it)
    load_kv_rows<T, DP, NT>(v, b, h, k0, BK, p.Tk, p.KVH, p.D, p.vec, v_s);
    cp_commit();
    cp_wait<1>();        // Q and K_j have landed
    __syncthreads();

    const int cls = classify(p, wr0, wr1, k0, BK);
    float s[NK][4];
    if (cls != kSkip) {
      // S = Q K_j^T: this warp's 16 rows x BK keys
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
      for (int kc = 0; kc < DP / M::K; ++kc) {
        const typename M::A qa = M::load_a(q_s, LD, warp * 16, kc * M::K);
#pragma unroll
        for (int j = 0; j < NK; ++j)
          M::mma(s[j], qa, M::load_b_nt(k_s, LD, j * 8, kc * M::K));
      }
    }
    cp_wait<0>();        // V_j has landed
    __syncthreads();     // every warp is done with K_j
    if (it + 1 < n)
      load_kv_rows<T, DP, NT>(k, b, h, k0 + BK, BK, p.Tk, p.KVH, p.D, p.vec,
                              k_s);
    cp_commit();

    if (cls != kSkip) {
      // scale, cap, mask; element e of block j is (row, key) =
      // (wr0 + g + 8 (e >> 1), k0 + 8 j + 2 t + (e & 1))
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * p.scale;
          if (p.has_cap) x = tanhf(x / p.cap) * p.cap;
          if (cls == kMasked &&
              !visible(p, qp[e >> 1], k0 + 8 * j + 2 * t + (e & 1), kend))
            x = -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2f((m[i] - m_new) * kLog2e);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const float pr =
              x == -INFINITY ? 0.f : exp2f((x - m[e >> 1]) * kLog2e);
          s[j][e] = pr;
          l[e >> 1] += pr;
        }
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
      // O += P V_j, P from the S accumulators
#pragma unroll
      for (int kc = 0; kc < BK / M::K; ++kc) {
        const typename M::A pa = M::from_c(s, kc);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
          M::mma(acc[nd], pa, M::load_b_nn(v_s, LD, kc * M::K, nd * 8));
      }
    }
    __syncthreads();     // every warp is done with V_j
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = wr0 + g + 8 * i;
    if (r >= nr) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);   // fully masked rows give 0
    T* row = o + row_off(p, b, h, r) * p.D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = nd * 8 + 2 * t + c;
        if (d < p.D) store(row + d, acc[nd][2 * i + c] * inv);
      }
    if (lse != nullptr && t == 0)
      lse[row_off(p, b, h, r)] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Params& p, cudaStream_t stream) {
  constexpr int BM = 16 * Tiles<T, DP>::WARPS, BK = Tiles<T, DP>::BK;
  const size_t smem = sizeof(T) * (size_t)(BM + 2 * BK) * ld_of<T>(DP);
  // above 48 KB only after opting in (per device, so on every launch)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const long long nqt = ((long long)p.Tq * p.G + BM - 1) / BM;
  const long long grid = nqt * p.B * p.KVH;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, DP><<<(unsigned)grid, 32 * Tiles<T, DP>::WARPS, smem,
                            stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, const Params& p, cudaStream_t stream) {
  if (p.D <= 16) return launch<T, 16>(q, k, v, o, lse, p, stream);
  if (p.D <= 32) return launch<T, 32>(q, k, v, o, lse, p, stream);
  if (p.D <= 64) return launch<T, 64>(q, k, v, o, lse, p, stream);
  if (p.D <= 128) return launch<T, 128>(q, k, v, o, lse, p, stream);
  return launch<T, 256>(q, k, v, o, lse, p, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtype: 0 = fp32, 1 = bf16.
// lse: fp32 (B, Tq, KVH, G) array for the row log-sum-exp, or null.  Returns
// the cudaError_t of the launch (0 = cudaSuccess); shapes the kernel does not
// take return cudaErrorInvalidValue without launching.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Tq, int Tk, int KVH, int G, int D, int causal, int has_window,
    int window, int has_prefix, int prefix_len, int has_cap, float cap,
    float scale, int q_offset, int has_kvl, int k_valid_len, void* lse,
    void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || KVH < 1 || G < 1 || G > 64 || D < 1 ||
      D > 256 || (long long)Tq * G > 2147483647LL ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t row_bytes = (size_t)D * (dtype == 0 ? 4 : 2);
  const int vec =
      row_bytes % 16 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const Params p{B,        Tq,         Tk,      KVH,   G,     D,
                 causal,   has_window, window,  has_prefix,   prefix_len,
                 has_cap,  cap,        scale,   q_offset,     has_kvl,
                 k_valid_len, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t e = dtype == 0
                            ? dispatch_d<float>(q, k, v, o, l, p, s)
                            : dispatch_d<__nv_bfloat16>(q, k, v, o, l, p, s);
  return (int)e;
}
