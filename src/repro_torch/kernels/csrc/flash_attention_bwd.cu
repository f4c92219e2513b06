// Flash-attention backward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: the JAX package has no Pallas backward; in train mode it
// differentiates its jnp `blockwise_attention` (src/repro/models/layers.py:137)
// with `jax.grad`.  This kernel is the port's counterpart of that gradient for
// the forward in flash_attention.cu, over the mask menu training uses (causal,
// sliding window, prefix-LM, logit softcap, non-causal; ragged Tq != Tk;
// q_offset = 0, no cache fill level).  With x = cap * tanh(scale q.k / cap)
// (or scale q.k), the forward's row log-sum-exp lse and delta = rowsum(dO*O):
//
//   P  = exp(x - lse)          (0 where masked or where the row sees no key)
//   dV = P^T dO                dP = dO V^T
//   dX = P * (dP - delta)      dS = dX * (1 - (x / cap)^2)   (dS = dX uncapped)
//   dQ = scale * dS K          dK = scale * dS^T Q
//
// Layout (the JAX package's): q, o, dO, dq (B, Tq, KVH, G, D); k, v, dk, dv
// (B, Tk, KVH, D); lse, delta fp32 (B, Tq, KVH, G).  fp32 or bf16 in and out.
// D <= 256, G <= 64.  A "row" is one (position, query head) pair of a kv
// head, r = t * G + g: the G heads of a kv head share its K and V.
//
// What bounds it: five products of 2 * D operations per visible (row, key)
// pair.  At the training shape (smollm-360m, B=2, T=512, KVH=5, G=3, D=64)
// that is 2.52 GFLOP against ~21 MB, far above the card's ridge, so it is
// bound by the tensor cores: fp32-accurate work as 3xTF32 is three TF32
// products per product at 495 TFLOP/s, 0.0153 ms.
//
// Precision route (the products run on the tensor cores with mma.sync):
//   * bf16: mma.sync.m16n8k16 bf16 x bf16 -> fp32.  P and dS are rounded to
//     bf16 for the second products (dV, dK, dQ);
//   * fp32: 3xTF32 on mma.sync.m16n8k8 tf32.  Each operand x splits into
//     hi = x with its low 13 bits cleared (exactly a tf32) and lo = x - hi
//     (exact in fp32; the tensor core reads its top 19 bits), and each
//     product is lo*hi + hi*lo + hi*hi summed in fp32: ~2^-21 relative per
//     product at a third of the TF32 rate.  Plain TF32 keeps ~3 decimal
//     digits and is not used.
//   Fragments are read from padded shared memory with 32-bit loads (no bank
//   conflicts at any D).  A product whose A operand is P or dS takes it
//   straight from the accumulator registers of S or dP: for bf16 two 16x8
//   accumulator tiles are one 16x16 A fragment; for tf32 the accumulator
//   holds columns (2t, 2t+1) where A wants (t, t+4), so the k index of the
//   8-wide chunk is permuted the same way in A and B, which leaves the sum
//   unchanged.
//
// Passes (three launches on one stream; every sum in registers or in a fixed
// order, no atomics, so two calls give identical bits):
//   1. bwd_preprocess: delta = rowsum(dO * O), one warp per row.
//   2. bwd_dkdv: a CTA of 4 warps (8 above D = 128, below) holds a 64-key
//      tile of K and V (16 keys a warp) and the fp32 dK, dV accumulators, and
//      steps over the query rows that see the key tile, 32 rows a step (16
//      for fp32 from D = 128).
//   3. bwd_dq: a CTA of 4 warps (8 above D = 128) holds 64 query rows (16 a
//      warp) and the dQ accumulator, and steps over the keys the forward
//      visited, 32 a step (16 for fp32 above D = 128).
//   In both, one tile's range of steps is split evenly over a thread-block
//   cluster of S CTAs (S = 1, 2, 4 or 8: the least whose share of the
//   longest tile is no longer than an even share of the pass over the card,
//   so no CTA outlasts the rest); the S partial sums meet in shared memory and
//   each CTA of the cluster sums a slice of the tile over the cluster in
//   rank order through distributed shared memory: no scratch in device
//   memory, no atomics.  CTAs go out longest first (the first key tile, the
//   last query tile, under the causal mask).  The streamed tiles (Q, dO, lse,
//   delta in dK/dV; K, V in dQ) are double-buffered with cp.async, so the
//   next step loads while the current one multiplies.  At D = 64 a CTA takes
//   ~72 KB of shared memory and at most 170 registers a thread: three an SM.
//   Where a step's whole (row, key) rectangle is visible, the mask is not
//   evaluated pair by pair.  After the loop the cluster sums dK, then dV,
//   through one 64 x (DP + 8) fp32 buffer laid over the CTA's tiles.
//
// Head dims 129 .. 256 (paligemma-3b's 256, MLA's 192; templates DP = 192
// and 256).  At DP = 256 a warp holding 16 keys' dK and dV over all columns
// would need 256 fp32 accumulators a thread before S and dP, and the tiles
// at 4 warps' shape would not fit 227 KB.  So a CTA has 8 warps in two
// column halves: warp w (< 4) and its partner w + 4 take the same 16 keys
// (dK/dV) or 16 rows (dQ); each multiplies S and dP over its half of the D
// columns only, the two partial tiles meet in shared memory (each warp adds
// the other's; IEEE addition commutes, so both hold the same bits, and P and
// dS come out identical in both), and each then accumulates dK, dV or dQ
// over its own half of the columns: 128 accumulators a thread at DP = 256,
// as at DP = 128.  No product is done twice; a step costs one more barrier.
// fp32 steps 16 rows (dK/dV) and 16 keys (dQ) there, so that K, V (or Q,
// dO), the double-buffered stream and the exchange fit one CTA an SM: 216
// KB of the 227 at DP = 256.  The split and the cluster sums are as at D <= 128.
//
// The dQ pass recomputes S and dP (seven products per visible pair, not
// five) instead of taking dS from the dK/dV pass: storing dS would cost
// Tq * G * Tk * 4 bytes written and read again (31 MB at the training shape,
// more than the inputs and outputs together) and would order the dQ pass
// behind the dK/dV pass; accumulating dQ in the dK/dV pass would need
// atomics or a partial per key tile.  Both passes are bound by the tensor
// cores, and the two extra products cost less than those bytes.
//
// What it does about the first version's limits: (1) products on the tensor
// cores instead of fp32 FMAs fed by shared memory; (2) the cluster splits
// give 640 dK/dV CTAs and 960 dQ CTAs at the training shape instead of 80
// and 250, and no CTA has more steps than an even share (key tile 0's 48
// row steps go to 8 CTAs); (3) the recompute stays, for the reason above;
// (4) cp.async double buffering instead of synchronous tile loads; (5) still
// three launches: each split is summed inside its cluster, not by another
// pass.

#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

constexpr int kRowWarps = 4;       // warps along the keys (dK/dV) or rows (dQ)
constexpr int kBK = 16 * kRowWarps;   // keys per dK/dV CTA, 16 a warp
constexpr int kBQ = 16 * kRowWarps;   // query rows per dQ CTA, 16 a warp
constexpr int kMaxSplit = 8;       // the portable cluster size
constexpr int kPreThreads = 256;

// Column halves NH (warps 4 NH, each over DH = DP / NH columns), query rows
// per dK/dV step and keys per dQ step, and the CTAs an SM each pass is built
// for: 32-wide steps keep the S and dP tiles in 32 registers a thread and a
// CTA in 72 KB of shared memory at D = 64, three an SM; fp32 at D = 128
// steps 16 rows to keep dK and dV (128 registers) from spilling; above 128
// the columns split in two halves, and fp32 steps 16 keys in dQ to fit
// shared memory
template <typename T, int DP>
struct Tiles {
  static constexpr int NH = DP > 128 ? 2 : 1;
  static constexpr int DH = DP / NH;
  static constexpr int THREADS = 32 * kRowWarps * NH;
  static constexpr int BR = DP <= 64 || sizeof(T) == 2 ? 32 : 16;
  static constexpr int BKQ = DP > 128 && sizeof(T) == 4 ? 16 : 32;
  static constexpr int MINB = DP <= 64 ? 3 : 1;
  // fp32 words of the column halves' exchange of NB 8-wide S and dP blocks
  static constexpr int xchg(int nb) { return NH == 2 ? THREADS * 2 * nb * 4 : 0; }
};

struct Params {
  int B, Tq, Tk, KVH, G, D;
  int causal;
  int has_window, window;
  int has_prefix, prefix_len;
  int has_cap;
  float cap;
  float scale;
  int vec;     // rows start on the 16-byte grid: cp.async 16 bytes at a time
  int split;   // CTAs (a cluster) per tile of the pass
};

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  bool ok = kp < p.Tk;
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

// ---- tile loads -------------------------------------------------------------

// rows r0 .. r0 + n - 1 of q-like tensors (and lse * log2(e), delta, the
// rows' positions) into shared tiles; zero past the last row.  Columns
// D .. DP-1 are zeroed once by the caller.
template <typename T, int DP, int NT>
__device__ __forceinline__ void load_rows(const Params& p, const T* a,
                                          const T* c, const float* lse,
                                          const float* delta, int b, int h,
                                          int r0, int n, T* a_s, T* c_s,
                                          float* lse_s, float* dl_s,
                                          int* pos_s) {
  constexpr int LD = ld_of<T>(DP);
  const int nr = p.Tq * p.G;
  if (p.vec) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = p.D / V;
    for (int i = threadIdx.x; i < n * cpr; i += NT) {
      const int r = i / cpr, col = (i % cpr) * V;
      const bool ok = r0 + r < nr;
      const size_t off = ok ? row_off(p, b, h, r0 + r) * p.D + col : 0;
      cp16(a_s + r * LD + col, a + off, ok);
      cp16(c_s + r * LD + col, c + off, ok);
    }
  } else {
    for (int i = threadIdx.x; i < n * p.D; i += NT) {
      const int r = i / p.D, col = i % p.D;
      const bool ok = r0 + r < nr;
      const size_t off = ok ? row_off(p, b, h, r0 + r) * p.D + col : 0;
      a_s[r * LD + col] = ok ? a[off] : from_float<T>(0.f);
      c_s[r * LD + col] = ok ? c[off] : from_float<T>(0.f);
    }
  }
  for (int r = threadIdx.x; r < n; r += NT) {
    const bool ok = r0 + r < nr;
    const size_t off = ok ? row_off(p, b, h, r0 + r) : 0;
    cp4(lse_s + r, lse + off, ok);
    cp4(dl_s + r, delta + off, ok);
    pos_s[r] = (r0 + r) / p.G;
  }
}

// keys k0 .. k0 + n - 1 of k and v into shared tiles, zero past Tk
template <typename T, int DP, int NT>
__device__ __forceinline__ void load_keys(const Params& p, const T* k,
                                          const T* v, int b, int h, int k0,
                                          int n, T* k_s, T* v_s) {
  constexpr int LD = ld_of<T>(DP);
  if (p.vec) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = p.D / V;
    for (int i = threadIdx.x; i < n * cpr; i += NT) {
      const int r = i / cpr, col = (i % cpr) * V;
      const bool ok = k0 + r < p.Tk;
      const size_t off =
          ok ? (((size_t)b * p.Tk + k0 + r) * p.KVH + h) * p.D + col : 0;
      cp16(k_s + r * LD + col, k + off, ok);
      cp16(v_s + r * LD + col, v + off, ok);
    }
  } else {
    for (int i = threadIdx.x; i < n * p.D; i += NT) {
      const int r = i / p.D, col = i % p.D;
      const bool ok = k0 + r < p.Tk;
      const size_t off =
          ok ? (((size_t)b * p.Tk + k0 + r) * p.KVH + h) * p.D + col : 0;
      k_s[r * LD + col] = ok ? k[off] : from_float<T>(0.f);
      v_s[r * LD + col] = ok ? v[off] : from_float<T>(0.f);
    }
  }
}

// ---- probabilities ----------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// Every (row, key) of positions [qa, qb] x keys [ka, kb] visible, rows and
// keys inside the tensors: the mask need not be read pair by pair.
__device__ __forceinline__ bool all_visible(const Params& p, int r_end, int qa,
                                            int qb, int ka, int kb) {
  bool ok = r_end <= p.Tq * p.G && kb < p.Tk;
  if (p.causal) ok = ok && (kb <= qa || (p.has_prefix && kb < p.prefix_len));
  if (p.has_window) ok = ok && (qb - ka < p.window);
  return ok;
}

// P and dS from the raw score s and dP of one (row, key) pair; lse2 is the
// row's lse * log2(e).  `full`: the pair is known to be visible.
__device__ __forceinline__ void probs(const Params& p, bool full, float s,
                                      float dp, float lse2, float dl, bool row_ok,
                                      int qp, int key, float& pr, float& ds) {
  float x = s * p.scale;
  if (p.has_cap) x = tanhf(x / p.cap) * p.cap;
  const bool ok = full || (row_ok && lse2 != -INFINITY && visible(p, qp, key));
  pr = ok ? exp2f(fmaf(x, kLog2e, -lse2)) : 0.f;
  ds = pr * (dp - dl);
  if (p.has_cap) {
    const float t = x / p.cap;
    ds *= 1.f - t * t;
  }
}

// ---- cluster sums -----------------------------------------------------------

// The cluster's S partial sums of a 64-row tile meet in shared memory: each
// CTA has written its 64 x rld floats to `red`; rank r sums rows
// [r 64 / S, (r + 1) 64 / S) over ranks 0 .. S-1 in that order and hands
// (row, column, sum) to `emit`.  Deterministic, no atomics.  Ends with a
// cluster barrier, so `red` may be written again after it.
template <int NT, typename Emit>
__device__ __forceinline__ void cluster_sum(const float* red, int rld,
                                            int ncols, Emit emit) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster.sync();
  const int per = 64 / S;
  for (int i = threadIdx.x; i < per * ncols; i += NT) {
    const int c = rank * per + i / ncols, d = i % ncols;
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      acc += cluster.map_shared_rank(red, s)[c * rld + d];
    emit(c, d, acc);
  }
  cluster.sync();      // no CTA leaves while another reads its shared memory
}

// The two column halves' partial S and dP tiles of a warp pair (warps w and
// w + 4, NB 8-wide blocks each) meet in `xs`: each warp writes its own and
// adds its partner's, so both hold the full sums, bit for bit the same
// (IEEE addition commutes).  The caller's next barrier frees `xs`.
template <int NB>
__device__ __forceinline__ void pair_sum(float (*a)[4], float (*b)[4],
                                         float* xs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* mine = xs + warp * (2 * NB * 4 * 32);
  const float* other = xs + (warp ^ kRowWarps) * (2 * NB * 4 * 32);
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[(j * 4 + e) * 32 + lane] = a[j][e];
      mine[((NB + j) * 4 + e) * 32 + lane] = b[j][e];
    }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[j][e] += other[(j * 4 + e) * 32 + lane];
      b[j][e] += other[((NB + j) * 4 + e) * 32 + lane];
    }
}

// ---- the passes -------------------------------------------------------------

// delta = rowsum(dO * O), one warp per row of D.
template <typename T>
__global__ void __launch_bounds__(kPreThreads)
bwd_preprocess(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ delta, long long rows, int D) {
  const long long row =
      (long long)blockIdx.x * (kPreThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_float(o[row * D + d]), to_float(dout[row * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Query row tiles [lo, hi) (of `tile` rows) that can see key tile [k0, k0 +
// kBK): rows of positions >= k0 under the causal mask (all, for a key tile
// inside the prefix), below kmax + window with a window.
__host__ __device__ inline void dkdv_tiles(const Params& p, int k0, int tile,
                                           int& lo, int& hi) {
  const int kmax = (k0 + kBK < p.Tk ? k0 + kBK : p.Tk) - 1;
  int qlo = 0, qhi = p.Tq;
  if (p.causal && !(p.has_prefix && k0 < p.prefix_len)) qlo = k0;
  if (p.has_window && kmax + p.window < qhi) qhi = kmax + p.window;
  if (qlo >= qhi) {
    lo = hi = 0;
    return;
  }
  lo = qlo * p.G / tile;
  hi = (qhi * p.G + tile - 1) / tile;
}

// Key tiles [lo, hi) (of `tile` keys) the forward visited for query rows
// [r0, r1).
__host__ __device__ inline void dq_tiles(const Params& p, int r0, int r1,
                                         int tile, int& lo, int& hi) {
  const int t_first = r0 / p.G, t_last = (r1 - 1) / p.G;
  int khi = p.Tk;
  if (p.causal) {
    int lim = t_last + 1;
    if (p.has_prefix && p.prefix_len > lim) lim = p.prefix_len;
    if (lim < khi) khi = lim;
  }
  int klo = 0;
  if (p.has_window && t_first - p.window + 1 > 0) klo = t_first - p.window + 1;
  lo = klo / tile;
  hi = klo < khi ? (khi + tile - 1) / tile : lo;
}

// This cluster rank's share [first, first + n) of `lo .. hi` split S ways.
__device__ __forceinline__ void share(int lo, int hi, int& first, int& n) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int chunk = (hi - lo + S - 1) / S;
  first = min(hi, lo + rank * chunk);
  n = min(hi, first + chunk) - first;
}

template <typename T, int DP>
__global__ void __launch_bounds__(Tiles<T, DP>::THREADS, Tiles<T, DP>::MINB)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, Params p) {
  using M = Mma<T>;
  using TL = Tiles<T, DP>;
  constexpr int BR = TL::BR, NT = TL::THREADS, DH = TL::DH;
  constexpr int LD = ld_of<T>(DP);
  constexpr int NB = BR / 8;        // 8-row blocks of S^T per warp
  constexpr int ND = DH / 8;        // 8-column blocks of dK, dV per warp
  constexpr int RLD = DP + 8;       // fp32 stride of the reduction tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);      // kBK x LD
  T* v_s = k_s + kBK * LD;                  // kBK x LD
  T* q_s = v_s + kBK * LD;                  // 2 x BR x LD
  T* do_s = q_s + 2 * BR * LD;              // 2 x BR x LD
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BR * LD);  // 2 x BR
  float* dl_s = lse_s + 2 * BR;                                  // 2 x BR
  int* pos_s = reinterpret_cast<int*>(dl_s + 2 * BR);            // 2 x BR
  float* xs = reinterpret_cast<float*>(pos_s + 2 * BR);  // TL::xchg(NB)
  float* red = reinterpret_cast<float*>(smem);  // after the loop: kBK x RLD

  const int item = blockIdx.x / p.split;    // (key tile, b, h), longest first
  const int BH = p.B * p.KVH;
  const int k0 = (item / BH) * kBK;
  const int b = (item % BH) / p.KVH, h = (item % BH) % p.KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = warp % kRowWarps;          // this warp's 16 keys
  const int c0 = (warp / kRowWarps) * DH;   // and first column
  const int g = lane >> 2, t = lane & 3;
  const int nr = p.Tq * p.G;

  int lo, hi, first, n;
  dkdv_tiles(p, k0, BR, lo, hi);
  share(lo, hi, first, n);

  zero_pad<T, DP, NT>(p.D, k_s, 2 * kBK + 4 * BR);
  load_keys<T, DP, NT>(p, k, v, b, h, k0, kBK, k_s, v_s);
  if (n > 0)
    load_rows<T, DP, NT>(p, q, dout, lse, delta, b, h, first * BR, BR, q_s,
                         do_s, lse_s, dl_s, pos_s);
  cp_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const int key0 = k0 + kw * 16 + g;        // this thread's keys: key0, key0 + 8

  for (int it = 0; it < n; ++it) {
    const int buf = it & 1;
    if (it + 1 < n)
      load_rows<T, DP, NT>(p, q, dout, lse, delta, b, h, (first + it + 1) * BR,
                           BR, q_s + (buf ^ 1) * BR * LD,
                           do_s + (buf ^ 1) * BR * LD, lse_s + (buf ^ 1) * BR,
                           dl_s + (buf ^ 1) * BR, pos_s + (buf ^ 1) * BR);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T* qs = q_s + buf * BR * LD;
    const T* dos = do_s + buf * BR * LD;
    const float* ls = lse_s + buf * BR;
    const float* dls = dl_s + buf * BR;
    const int* ps = pos_s + buf * BR;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BR rows, over
    // its DH columns (then summed with its partner's)
    float st[NB][4], dpt[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll 2
    for (int kc = 0; kc < DH / M::K; ++kc) {
      const int col = c0 + kc * M::K;
      const typename M::A ka = M::load_a(k_s, LD, kw * 16, col);
      const typename M::A va = M::load_a(v_s, LD, kw * 16, col);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        M::mma(st[j], ka, M::load_b_nt(qs, LD, j * 8, col));
        M::mma(dpt[j], va, M::load_b_nt(dos, LD, j * 8, col));
      }
    }
    if constexpr (TL::NH == 2) pair_sum<NB>(st, dpt, xs);

    // P^T and dS^T in place; element e of block j is (key, row) =
    // (key0 + 8 (e >> 1), 8 j + 2 t + (e & 1))
    const int r0 = (first + it) * BR;
    const bool full = all_visible(p, r0 + BR, ps[0], ps[BR - 1], k0,
                                  k0 + kBK - 1);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = j * 8 + 2 * t + (e & 1);
        probs(p, full, st[j][e], dpt[j][e], ls[rl] * kLog2e, dls[rl],
              r0 + rl < nr, ps[rl], key0 + 8 * (e >> 1), st[j][e], dpt[j][e]);
      }

    // dV += P^T dO and dK += dS^T Q over this warp's columns, summing over
    // the tile's rows
#pragma unroll
    for (int kc = 0; kc < BR / M::K; ++kc) {
      const typename M::A pa = M::from_c(st, kc);
      const typename M::A sa = M::from_c(dpt, kc);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        M::mma(dva[nd], pa, M::load_b_nn(dos, LD, kc * M::K, c0 + nd * 8));
        M::mma(dka[nd], sa, M::load_b_nn(qs, LD, kc * M::K, c0 + nd * 8));
      }
    }
    __syncthreads();   // the next iteration's load reuses this buffer
  }
  cp_wait<0>();
  __syncthreads();

  // dK, then dV, summed over the cluster through `red`
  const size_t base = ((size_t)b * p.Tk + k0) * p.KVH + h;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(kw * 16 + g + 8 * (e >> 1)) * RLD + c0 + nd * 8 + 2 * t + (e & 1)] =
          dka[nd][e];
  cluster_sum<NT>(red, RLD, p.D, [&](int c, int d, float sum) {
    if (k0 + c < p.Tk) store(dk + (base + (size_t)c * p.KVH) * p.D + d, sum * p.scale);
  });
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(kw * 16 + g + 8 * (e >> 1)) * RLD + c0 + nd * 8 + 2 * t + (e & 1)] =
          dva[nd][e];
  cluster_sum<NT>(red, RLD, p.D, [&](int c, int d, float sum) {
    if (k0 + c < p.Tk) store(dv + (base + (size_t)c * p.KVH) * p.D + d, sum);
  });
}

template <typename T, int DP>
__global__ void __launch_bounds__(Tiles<T, DP>::THREADS, Tiles<T, DP>::MINB)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, Params p) {
  using M = Mma<T>;
  using TL = Tiles<T, DP>;
  constexpr int BKQ = TL::BKQ, NT = TL::THREADS, DH = TL::DH;
  constexpr int LD = ld_of<T>(DP);
  constexpr int NK = BKQ / 8;       // 8-key blocks of S per warp
  constexpr int ND = DH / 8;        // 8-column blocks of dQ per warp
  constexpr int RLD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);      // kBQ x LD
  T* do_s = q_s + kBQ * LD;                 // kBQ x LD
  T* k_s = do_s + kBQ * LD;                 // 2 x BKQ x LD
  T* v_s = k_s + 2 * BKQ * LD;              // 2 x BKQ x LD
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * BKQ * LD);  // kBQ
  float* dl_s = lse_s + kBQ;                                     // kBQ
  int* pos_s = reinterpret_cast<int*>(dl_s + kBQ);               // kBQ
  float* xs = reinterpret_cast<float*>(pos_s + kBQ);  // TL::xchg(NK)
  float* red = reinterpret_cast<float*>(smem);  // after the loop: kBQ x RLD

  const int nr = p.Tq * p.G;
  const int nqt = (nr + kBQ - 1) / kBQ;
  const int BH = p.B * p.KVH;
  const int item = blockIdx.x / p.split;    // (query tile, b, h)
  const int qt = p.causal ? nqt - 1 - item / BH : item / BH;  // longest first
  const int b = (item % BH) / p.KVH, h = (item % BH) % p.KVH;
  const int r0 = qt * kBQ, r1 = min(r0 + kBQ, nr);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % kRowWarps;          // this warp's 16 rows
  const int c0 = (warp / kRowWarps) * DH;   // and first column
  const int g = lane >> 2, t = lane & 3;

  int lo, hi, first, n;
  dq_tiles(p, r0, r1, BKQ, lo, hi);
  share(lo, hi, first, n);

  zero_pad<T, DP, NT>(p.D, q_s, 2 * kBQ + 4 * BKQ);
  load_rows<T, DP, NT>(p, q, dout, lse, delta, b, h, r0, kBQ, q_s, do_s, lse_s,
                       dl_s, pos_s);
  if (n > 0) load_keys<T, DP, NT>(p, k, v, b, h, first * BKQ, BKQ, k_s, v_s);
  cp_commit();

  float dqa[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  // this thread's two rows, 16 rw + g and + 8: their position, lse, delta
  const int rl0 = rw * 16 + g;
  int qp[2];
  float lse2[2], dl[2];
  bool row_ok[2];
  cp_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qp[i] = pos_s[rl0 + 8 * i];
    lse2[i] = lse_s[rl0 + 8 * i] * kLog2e;
    dl[i] = dl_s[rl0 + 8 * i];
    row_ok[i] = r0 + rl0 + 8 * i < nr;
  }

  for (int it = 0; it < n; ++it) {
    const int buf = it & 1;
    const int k0 = (first + it) * BKQ;
    if (it + 1 < n)
      load_keys<T, DP, NT>(p, k, v, b, h, k0 + BKQ, BKQ,
                           k_s + (buf ^ 1) * BKQ * LD, v_s + (buf ^ 1) * BKQ * LD);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T* ks = k_s + buf * BKQ * LD;
    const T* vs = v_s + buf * BKQ * LD;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x BKQ keys, over its
    // DH columns (then summed with its partner's)
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
    for (int kc = 0; kc < DH / M::K; ++kc) {
      const int col = c0 + kc * M::K;
      const typename M::A qa = M::load_a(q_s, LD, rw * 16, col);
      const typename M::A oa = M::load_a(do_s, LD, rw * 16, col);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        M::mma(s[j], qa, M::load_b_nt(ks, LD, j * 8, col));
        M::mma(dp[j], oa, M::load_b_nt(vs, LD, j * 8, col));
      }
    }
    if constexpr (TL::NH == 2) pair_sum<NK>(s, dp, xs);
    // element e of block j is (row, key) = (rl0 + 8 (e >> 1),
    // k0 + 8 j + 2 t + (e & 1))
    const bool full = all_visible(p, r0 + kBQ, pos_s[0], pos_s[kBQ - 1], k0,
                                  k0 + BKQ - 1);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pr;
        probs(p, full, s[j][e], dp[j][e], lse2[i], dl[i], row_ok[i], qp[i],
              k0 + j * 8 + 2 * t + (e & 1), pr, dp[j][e]);
      }
    // dQ += dS K over this warp's columns
#pragma unroll
    for (int kc = 0; kc < BKQ / M::K; ++kc) {
      const typename M::A sa = M::from_c(dp, kc);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        M::mma(dqa[nd], sa, M::load_b_nn(ks, LD, kc * M::K, c0 + nd * 8));
    }
    __syncthreads();
  }
  cp_wait<0>();
  __syncthreads();

#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(rl0 + 8 * (e >> 1)) * RLD + c0 + nd * 8 + 2 * t + (e & 1)] = dqa[nd][e];
  cluster_sum<NT>(red, RLD, p.D, [&](int c, int d, float sum) {
    if (r0 + c < nr) store(dq + row_off(p, b, h, r0 + c) * p.D + d, sum * p.scale);
  });
}

// ---- host side --------------------------------------------------------------

// bytes of shared memory: the tiles (and the column halves' exchange)
// during the loop, the fp32 reduction tile laid over them after it
template <typename T, int DP>
size_t smem_dkdv() {
  using TL = Tiles<T, DP>;
  const size_t tiles = sizeof(T) * (size_t)(2 * kBK + 4 * TL::BR) * ld_of<T>(DP) +
                       sizeof(float) * (6 * TL::BR + TL::xchg(TL::BR / 8));
  const size_t red = sizeof(float) * (size_t)kBK * (DP + 8);
  return tiles > red ? tiles : red;
}

template <typename T, int DP>
size_t smem_dq() {
  using TL = Tiles<T, DP>;
  const size_t tiles = sizeof(T) * (size_t)(2 * kBQ + 4 * TL::BKQ) * ld_of<T>(DP) +
                       sizeof(float) * (3 * kBQ + TL::xchg(TL::BKQ / 8));
  const size_t red = sizeof(float) * (size_t)kBQ * (DP + 8);
  return tiles > red ? tiles : red;
}

// CTAs (a cluster) per item of a pass: the least power of two up to
// kMaxSplit whose share of the longest item (`most` steps) is no longer than
// an even share of all `total` steps over the card's CTA slots (SMs x
// `minb`), so that no CTA outlasts the rest.
// kernels/flash_attention.py::bwd_plan computes the same.
int choose_split(long long total, int most, int minb, int n_sm) {
  int s = 1;
  while (s < kMaxSplit && (long long)((most + s - 1) / s) * n_sm * minb > total)
    s *= 2;
  return s;
}

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, unsigned grid, int threads, int split,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, Params p, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);

  const long long rows = (long long)p.B * p.Tq * p.KVH * p.G;
  const long long nb = (rows + kPreThreads / 32 - 1) / (kPreThreads / 32);
  bwd_preprocess<T><<<(unsigned)nb, kPreThreads, 0, stream>>>(
      static_cast<const T*>(o), do_, delta, rows, p.D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  int dev = 0, n_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int BH = p.B * p.KVH;

  constexpr int MINB = Tiles<T, DP>::MINB;
  const int nkt = (p.Tk + kBK - 1) / kBK;
  int most = 0;
  long long total = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    int lo, hi;
    dkdv_tiles(p, kt * kBK, Tiles<T, DP>::BR, lo, hi);
    most = std::max(most, hi - lo);
    total += (long long)(hi - lo) * BH;
  }
  Params pk = p;
  pk.split = choose_split(total, most, MINB, n_sm);
  e = launch_cluster(bwd_dkdv<T, DP>, (unsigned)(nkt * BH * pk.split),
                     Tiles<T, DP>::THREADS, pk.split, smem_dkdv<T, DP>(), stream, q_, k_, v_, do_,
                     lse, static_cast<const float*>(delta),
                     static_cast<T*>(dk), static_cast<T*>(dv), pk);
  if (e != cudaSuccess) return e;

  const int nr = p.Tq * p.G, nqt = (nr + kBQ - 1) / kBQ;
  most = 0;
  total = 0;
  for (int qt = 0; qt < nqt; ++qt) {
    int lo, hi;
    dq_tiles(p, qt * kBQ, std::min(qt * kBQ + kBQ, nr), Tiles<T, DP>::BKQ, lo,
             hi);
    most = std::max(most, hi - lo);
    total += (long long)(hi - lo) * BH;
  }
  Params pq = p;
  pq.split = choose_split(total, most, MINB, n_sm);
  return launch_cluster(bwd_dq<T, DP>, (unsigned)(nqt * BH * pq.split),
                        Tiles<T, DP>::THREADS, pq.split, smem_dq<T, DP>(), stream, q_, k_, v_, do_,
                        lse, static_cast<const float*>(delta),
                        static_cast<T*>(dq), pq);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv,
                       const Params& p, cudaStream_t s) {
  if (p.D <= 16)
    return launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (p.D <= 32)
    return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (p.D <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (p.D <= 128)
    return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  if (p.D <= 192)
    return launch<T, 192>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
  return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtype: 0 = fp32, 1 = bf16.
// lse: the forward's fp32 row log-sum-exp; delta: fp32 scratch of the same
// (B, Tq, KVH, G) shape.  Three kernels on `stream`: delta, then dK/dV and
// dQ, each a cluster launch.  Returns the first failing cudaError_t (0 =
// cudaSuccess); shapes the kernel does not take return
// cudaErrorInvalidValue without launching.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Tq, int Tk, int KVH, int G, int D,
    int causal, int has_window, int window, int has_prefix, int prefix_len,
    int has_cap, float cap, float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || KVH < 1 || G < 1 || G > 64 || D < 1 ||
      D > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t row_bytes = (size_t)D * (dtype == 0 ? 4 : 2);
  const int vec = row_bytes % 16 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout);
  const Params p{B,       Tq,         Tk,     KVH,        G,
                 D,       causal,     has_window, window, has_prefix,
                 prefix_len, has_cap, cap,    scale,      vec,
                 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const cudaError_t e =
      dtype == 0
          ? dispatch_d<float>(q, k, v, o, dout, l, dl, dq, dk, dv, p, s)
          : dispatch_d<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, p,
                                      s);
  return (int)e;
}
