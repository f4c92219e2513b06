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
// operations, the bytes close behind.  On CUDA cores every instruction
// takes an issue slot as an FMA does: 8 of arithmetic a state entry a step,
// and the moves of the partial sums between threads (the reduce-scatters
// below, about a quarter of the instructions) come on top.
//
// The design (layouts swept by launch/sweep_wkv_scan_bwd.py; PERF.md):
//   * The states are never recovered by dividing by w_t: at the model's
//     decays (w down to ~2e-9) that overflows (wkv_scan.cu's note).  The
//     chunks are walked from the last to the first; each is replayed from
//     its checkpoint with the forward's own multiply-adds (so the replayed
//     states are the forward's, bit for bit) into registers, kCpt = 8
//     columns of one row a thread for all kChunk steps (kHist), then walked
//     in reverse with the adjoint dS in registers too.
//   * A column of S, and of dS, depends on no other column.  A CTA holds
//     kCols = 32 columns of one (b, h) for all K rows, 256 threads; the
//     K / 32 CTAs of a (b, h) are one thread-block cluster.  At the
//     training shape: 64 clusters of 2, one CTA an SM, one wave (the card
//     holds 66 such clusters at once; 16 columns a CTA in clusters of 4
//     fit only 62, and ran in two waves).
//   * The sums over columns (gr, gk, gw) cross the cluster.  Every kSteps
//     steps a row's partials are summed over its lanes by a shuffle
//     reduce-scatter that leaves each lane whole steps, and the first lane
//     of each group stores them straight into the shared memory of the CTA
//     that sums that step (distributed shared memory, 32-bit cluster
//     addresses).  kExch = 4 chunks cross at once: a cluster barrier (its
//     release is a GPU-wide memory barrier) after the group, whose wait
//     comes after the next chunk's replay; then each CTA sums its share in
//     rank order and writes gr, gk and gw once.
//   * The sum over rows (gv) stays in the CTA: a reduce-scatter over a
//     warp's rows, then one step over the warps through shared memory.
//   * The u terms are rank-one and added once a (step, row) or (step,
//     column): with c over the CTA's own columns, each CTA's part of gr and
//     gk holds its share of them, and gu (a sum over b and t) is written by
//     each CTA as a part of a (P, B, H, K) scratch; the last CTA of a head
//     to finish (an integer ticket) sums the parts in a fixed order.
//   * r, k and w rows, the CTA's slices of v and gy for a chunk are staged
//     in shared memory with cp.async while the chunk before it is walked
//     (double buffer), the next checkpoint is loaded into registers early;
//     a thread's copy slot, output pointers and cluster addresses are
//     worked out once, outside the chunk loop.
// No float atomics and fixed orders of summation: two calls give the same
// bits (the R2CCL parity argument needs rank-ordered sums to give identical
// bits).  One launch (and a memset of the tickets).

#include <stddef.h>

#include <cooperative_groups.h>

#include "hopper_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;

constexpr int kChunk = 16;     // steps a checkpoint covers (wkv_scan.cu's kChunk)
constexpr int kCols = 32;      // state columns a CTA (at most K); K / kCols CTAs a cluster
constexpr int kCpt = 8;        // state columns a thread (of one row)
constexpr int kSteps = 4;      // steps whose partial sums are reduced over lanes at once
constexpr int kHist = 16;      // steps whose states a thread holds (the chunk in kChunk / kHist parts)
constexpr int kExch = 4;       // chunks whose partials cross the cluster at once
constexpr int kMinBlocks = 1;  // CTAs an SM that the registers must allow

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

template <int K>
struct Shape {
  static constexpr int COLS = imin(kCols, K);   // state columns a CTA
  static constexpr int P = K / COLS;            // CTAs a cluster
  static constexpr int SPC = kChunk / P;        // steps of a chunk whose gr, gk, gw a CTA sums
  static constexpr int L = COLS / kCpt;         // lanes a row
  static constexpr int RW = 32 / L;             // rows a warp
  static constexpr int NT = K * L;              // threads a CTA
  static constexpr int NW = NT / 32;            // warps a CTA
  static constexpr int ROW = 3 * K + 2 * COLS;  // floats a step of a chunk: r, k, w, v and gy slices
  // the row sums (3 a step) over a row's L lanes: reduce-scatter levels
  // that leave whole steps, then butterfly levels; a lane group is left
  // with SPL steps
  static constexpr int RS_R = imin(ilog2(L), ilog2(kSteps)), BF_R = ilog2(L) - RS_R;
  static constexpr int SPL = kSteps >> RS_R;
  // the column sums (kCpt a step) over a warp's RW rows, likewise; QN entries left
  static constexpr int NQ = kSteps * kCpt;
  static constexpr int RS_C = imin(ilog2(RW), ilog2(NQ)), BF_C = ilog2(RW) - RS_C;
  static constexpr int QN = NQ >> RS_C;
  static constexpr int CHUNK_F = kChunk * ROW;
  static constexpr int ROWBUF_F = kChunk * 3 * K;
  static constexpr int COLBUF_F = NW * kChunk * COLS;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * CHUNK_F + 2 * kExch * ROWBUF_F + COLBUF_F + 2 * kChunk + K);
  static_assert(K % COLS == 0 && COLS % kCpt == 0 && NT % 32 == 0 && NT <= 1024,
                "whole warps of whole rows");
  static_assert((kSteps & (kSteps - 1)) == 0 && (kCpt & (kCpt - 1)) == 0 &&
                    kChunk % kHist == 0 && kHist % kSteps == 0 && kChunk % P == 0,
                "batches of steps tile the parts, the parts the chunk, the cluster's shares too");
};

// the slot of chunk ch's partials in the exchange buffers
__device__ __forceinline__ int part_slot(int ch) { return ((ch / kExch) & 1) * kExch + ch % kExch; }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of this CTA's shared `addr` in CTA `rank`'s, in the cluster's window
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_cluster(unsigned addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}

// x[0..N) = p[0..N) and back; VEC: p is aligned to min(N, 4) floats
template <int N, bool VEC>
__device__ __forceinline__ void ldv(const float* p, float* x) {
  if constexpr (VEC && N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + q);
      x[q] = t.x, x[q + 1] = t.y, x[q + 2] = t.z, x[q + 3] = t.w;
    }
  } else if constexpr (VEC && N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) x[q] = p[q];
  }
}
template <int N, bool VEC>
__device__ __forceinline__ void stv(float* p, const float* x) {
  if constexpr (VEC && N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4)
      *reinterpret_cast<float4*>(p + q) = make_float4(x[q], x[q + 1], x[q + 2], x[q + 3]);
  } else if constexpr (VEC && N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) p[q] = x[q];
  }
}

// Sum o[0..N) entry by entry over the lanes that differ in the bits M,
// M / 2, .. (LEVELS of them): each level hands half of the entries still
// held to the partner lane and keeps the other half.  A lane is left, in
// o[0..N >> LEVELS), with the totals of block number (its lane's bits M,
// M / 2, .., highest first).  The same order in every call.  A level a
// template instance, so that every index is a constant and o stays in
// registers.
template <int N, int M, int LEVELS>
__device__ __forceinline__ void reduce_scatter(float* o, int lane) {
  if constexpr (LEVELS > 0) {
    const bool up = (lane & M) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? o[i] : o[i + N / 2];
      const float keep = up ? o[i + N / 2] : o[i];
      o[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    reduce_scatter<N / 2, M / 2, LEVELS - 1>(o, lane);
  }
}

// Sum o[0..N) over the lanes that differ in the bits M, M / 2, .. (LEVELS
// of them), every lane left with the totals (a butterfly: the same bits in
// every lane).
template <int N, int M, int LEVELS>
__device__ __forceinline__ void butterfly(float* o) {
  if constexpr (LEVELS > 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] += __shfl_xor_sync(0xffffffffu, o[i], M);
    butterfly<N, M / 2, LEVELS - 1>(o);
  }
}

// How a CTA stages a chunk: steps t0 .. t0 + kChunk - 1 of r, k, w (whole
// rows) and of its slices of v and gy into dst[i][ROW]; past T, zeros and
// w = 1, a step that leaves state and adjoint as they are.  With 16-byte
// copies and the threads a multiple of a step's copies, a thread keeps one
// slot of the row (its source pointer worked out once) for every
// (NT / copies)-th step; otherwise it walks the copies in turn.
template <int K, bool VEC>
struct Stage {
  static constexpr int ROW = Shape<K>::ROW, NT = Shape<K>::NT, COLS = Shape<K>::COLS;
  static constexpr int W = VEC ? 4 : 1;                 // floats a copy
  static constexpr int PER = ROW / W;                   // copies a step
  static constexpr bool FIXED = VEC && NT % PER == 0 && kChunk % (NT / PER) == 0;
  const float *r, *k, *w, *v, *gy;
  size_t at0, HK;           // the (b, t = 0, h) row's index, a step's stride
  int j0, T;
  const float* src0;        // FIXED: this thread's slot at t = 0
  int c0, i_first;          // FIXED: its offset in a row, its first step

  __device__ const float* source(int c, size_t row) const {
    if (c < 3 * K) {
      const int which = c / K;
      return (which == 0 ? r : which == 1 ? k : w) + row + c % K;
    }
    if (c < 3 * K + COLS) return v + row + j0 + (c - 3 * K);
    return gy + row + j0 + (c - 3 * K - COLS);
  }

  __device__ Stage(const float* r_, const float* k_, const float* w_, const float* v_,
                   const float* gy_, int b, int h, int j0_, int T_, int H)
      : r(r_), k(k_), w(w_), v(v_), gy(gy_), at0(((size_t)b * T_ * H + h) * K),
        HK((size_t)H * K), j0(j0_), T(T_) {
    c0 = ((int)threadIdx.x % PER) * W;
    i_first = (int)threadIdx.x / PER;
    src0 = source(c0, at0);
  }

  __device__ void load(int t0, float* dst) const {
    if constexpr (FIXED) {
      constexpr int DI = NT / PER;
      const bool is_w = c0 >= 2 * K && c0 < 3 * K;
#pragma unroll
      for (int j = 0; j < kChunk / DI; ++j) {
        const int i = i_first + j * DI;
        const bool ok = t0 + i < T;
        float* d = dst + i * ROW + c0;
        if (!ok && is_w) {
          d[0] = d[1] = d[2] = d[3] = 1.f;
        } else {
          cp16(d, src0 + (ok ? (size_t)(t0 + i) * HK : 0), ok);
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < (kChunk * PER + NT - 1) / NT; ++it) {
        const int idx = it * NT + (int)threadIdx.x;
        if (kChunk * PER % NT != 0 && idx >= kChunk * PER) break;
        const int i = idx / PER, c = (idx % PER) * W;
        const bool ok = t0 + i < T;
        float* d = dst + i * ROW + c;
        if (!ok && c >= 2 * K && c < 3 * K) {
#pragma unroll
          for (int e = 0; e < W; ++e) d[e] = 1.f;
        } else {
          const float* src = source(c, ok ? at0 + (size_t)(t0 + i) * HK : 0);
          if constexpr (VEC) {
            cp16(d, src, ok);
          } else {
            cp4(d, src, ok);
          }
        }
      }
    }
  }
};

// Per step of the chunk in cs: c_s[i] = v_i . gy_i over the CTA's columns,
// a_s[i] = sum over the K rows of r_i u k_i.  16 lanes a step, summed by a
// butterfly (every lane of the 16 ends with the same bits).
template <int K>
__device__ __forceinline__ void chunk_sums(const float* cs, const float* u_s, float* c_s,
                                           float* a_s) {
  constexpr int NT = Shape<K>::NT, ROW = Shape<K>::ROW, COLS = Shape<K>::COLS;
#pragma unroll
  for (int base = 0; base < kChunk * 16; base += NT) {
    const int idx = base + (int)threadIdx.x;
    const int i = idx / 16, c = idx % 16;
    float pc = 0.f, pa = 0.f;
    if (i < kChunk) {
      const float* st = cs + i * ROW;
#pragma unroll
      for (int j = c; j < COLS; j += 16) pc = fmaf(st[3 * K + j], st[3 * K + COLS + j], pc);
#pragma unroll
      for (int q = c; q < K; q += 16) pa = fmaf(st[q] * u_s[q], st[K + q], pa);
    }
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) {
      pc += __shfl_xor_sync(0xffffffffu, pc, m);
      pa += __shfl_xor_sync(0xffffffffu, pa, m);
    }
    if (i < kChunk && c == 0) c_s[i] = pc, a_s[i] = pa;
  }
}

// gr, gk and gw of the CTA's share of the chunk at t0 (steps p * SPC ..):
// each (step, kind, row) the sum of the cluster's partials, which every CTA
// stored into this CTA's buffer `part` ([SPC][P][3][K]), in rank order.  A
// thread takes one (kind, row) for all the share's steps; at0 and HK as
// Stage's.
template <int K>
__device__ __forceinline__ void cluster_sum(const float* part, int p, size_t at0, size_t HK,
                                            int t0, int T, float* __restrict__ gr,
                                            float* __restrict__ gk, float* __restrict__ gw) {
  constexpr int P = Shape<K>::P, NT = Shape<K>::NT, SPC = Shape<K>::SPC;
  for (int rest = threadIdx.x; rest < 3 * K; rest += NT) {
    const int kind = rest / K, row = rest % K;
    float* g = (kind == 0 ? gr : kind == 1 ? gk : gw) + at0 + row;
    const float* src = part + rest;
#pragma unroll
    for (int il = 0; il < SPC; ++il) {
      float acc = src[il * P * 3 * K];
#pragma unroll
      for (int q = 1; q < P; ++q) acc += src[(il * P + q) * 3 * K];
      const int t = t0 + p * SPC + il;
      if (t < T) g[(size_t)t * HK] = acc;
    }
  }
}

template <int K, bool VEC>
__global__ void __launch_bounds__(Shape<K>::NT, kMinBlocks)
wkv_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ ckpt,
                    const float* __restrict__ gy, const float* __restrict__ gsT,
                    float* __restrict__ gr, float* __restrict__ gk, float* __restrict__ gv,
                    float* __restrict__ gw, float* __restrict__ gu, float* __restrict__ gs0,
                    float* __restrict__ gu_part, unsigned* __restrict__ ticket, int B, int T,
                    int H) {
  using Sh = Shape<K>;
  constexpr int P = Sh::P, L = Sh::L, NT = Sh::NT, NW = Sh::NW, ROW = Sh::ROW;
  constexpr int COLS = Sh::COLS, SPC = Sh::SPC, QN = Sh::QN;
  extern __shared__ __align__(16) float smem[];
  float* chunk_s = smem;                          // [2][kChunk][ROW]
  float* rowbuf = chunk_s + 2 * Sh::CHUNK_F;      // [2][kExch][SPC][P][3][K]: partials of gr, gk, gw
  float* colbuf = rowbuf + 2 * kExch * Sh::ROWBUF_F;  // [NW][kChunk][COLS]: a warp's rows' sums for gv
  float* c_s = colbuf + Sh::COLBUF_F;             // [kChunk]
  float* a_s = c_s + kChunk;                      // [kChunk]
  float* u_s = a_s + kChunk;                      // [K]
  __shared__ int last;

  const int p = (int)cg::this_cluster().block_rank();
  const int bh = blockIdx.x / P, b = bh / H, h = bh - b * H;
  const int j0 = p * COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = threadIdx.x / L, lg = threadIdx.x % L, cc0 = lg * kCpt;
  const float uu = u[(size_t)h * K + row];
  for (int i = threadIdx.x; i < K; i += NT) u_s[i] = u[(size_t)h * K + i];
  const int nch = (T + kChunk - 1) / kChunk;
  const size_t sidx = (size_t)bh * K * K + (size_t)row * K + j0 + cc0;
  const float* ck_at = ckpt + (size_t)bh * nch * K * K + (size_t)row * K + j0 + cc0;
  const Stage<K, VEC> stage(r, k, w, v, gy, b, h, j0, T, H);

  // worked out once: where this thread's row partials go in each CTA of
  // the cluster (its lanes' first), where its column sums go in colbuf,
  // the thread's gv column and steps
  unsigned rpart[P];
  {
    const unsigned mine =
        (unsigned)__cvta_generic_to_shared(rowbuf) + 4u * (unsigned)(p * 3 * K + row);
#pragma unroll
    for (int q = 0; q < P; ++q) rpart[q] = mapa(mine, q);
  }
  const bool row_writer = (lg & ((1 << Sh::BF_R) - 1)) == 0;
  const int row_step = (lg >> Sh::BF_R) * Sh::SPL;     // of a batch
  const int rgb = (lane / L) >> Sh::BF_C;
  const bool col_writer = ((lane / L) & ((1 << Sh::BF_C) - 1)) == 0;
  // entry e of this lane's column sums: step (rgb * QN + e) / kCpt, column
  // cc0 + (rgb * QN + e) % kCpt of the batch
  float* col_at = colbuf + (warp * kChunk + (rgb * QN) / kCpt) * COLS + cc0 +
                  (QN < kCpt ? (rgb * QN) % kCpt : 0);
  constexpr int SPP = NT / COLS;                  // steps a pass of the gv sums
  const int gv_c = threadIdx.x % COLS, gv_i = threadIdx.x / COLS;

  float dS[kCpt], ck[kCpt];
  if (gsT != nullptr) {
    ldv<kCpt, VEC>(gsT + sidx, dS);
  } else {
#pragma unroll
    for (int c = 0; c < kCpt; ++c) dS[c] = 0.f;
  }
  stage.load((nch - 1) * kChunk, chunk_s + ((nch - 1) & 1) * Sh::CHUNK_F);
  cp_commit();
  ldv<kCpt, VEC>(ck_at + (size_t)(nch - 1) * K * K, ck);
  float gu_acc = 0.f;

  for (int ch = nch - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk;
    const float* cs = chunk_s + (ch & 1) * Sh::CHUNK_F;
    // this chunk's partials: slot ch % kExch of buffer (ch / kExch) & 1 (of
    // the CTA that sums them); a group of kExch chunks crosses the cluster
    // at once
    const unsigned part_at = 4u * (unsigned)(part_slot(ch) * Sh::ROWBUF_F);
    cp_wait<0>();
    __syncthreads();          // chunk ch staged; the chunk after it is done with
    if (ch > 0) {             // the other buffer, colbuf, c_s and a_s
      stage.load(t0 - kChunk, chunk_s + ((ch - 1) & 1) * Sh::CHUNK_F);
      cp_commit();
    }
    chunk_sums<K>(cs, u_s, c_s, a_s);
    float S0[kCpt];           // the state at the chunk's start
#pragma unroll
    for (int c = 0; c < kCpt; ++c) S0[c] = ck[c];
    if (ch > 0) ldv<kCpt, VEC>(ck_at + (size_t)(ch - 1) * K * K, ck);

    // the chunk's parts from the last: each replayed from S0 (the steps
    // before it without keeping the states), then walked in reverse
#pragma unroll 1
    for (int sub = kChunk / kHist - 1; sub >= 0; --sub) {
      const int i0 = sub * kHist;
      float S[kCpt];
#pragma unroll
      for (int c = 0; c < kCpt; ++c) S[c] = S0[c];
      for (int i = 0; i < i0; ++i) {
        const float* st = cs + i * ROW;
        const float kr = st[K + row], wr = st[2 * K + row];
        float vv[kCpt];
        ldv<kCpt, true>(st + 3 * K + cc0, vv);
#pragma unroll
        for (int c = 0; c < kCpt; ++c) S[c] = fmaf(wr, S[c], kr * vv[c]);
      }
      float hist[kHist][kCpt];  // hist[i] = S_{t0+i0+i-1}, this thread's entries
#pragma unroll
      for (int i = 0; i < kHist; ++i) {
        const float* st = cs + (i0 + i) * ROW;
        const float kr = st[K + row], wr = st[2 * K + row];
        float vv[kCpt];
        ldv<kCpt, true>(st + 3 * K + cc0, vv);
#pragma unroll
        for (int c = 0; c < kCpt; ++c) {
          hist[i][c] = S[c];
          S[c] = fmaf(wr, S[c], kr * vv[c]);
        }
      }
      if (sub == kChunk / kHist - 1) {
        __syncthreads();      // c_s, a_s
        // at a group's first chunk, the group after it: its partials are all here
        if ((ch % kExch == kExch - 1 || ch == nch - 1) && ch + 1 < nch) {
          cluster_wait();
          for (int cc = ch + 1; cc <= min(ch + kExch, nch - 1); ++cc)
            cluster_sum<K>(rowbuf + part_slot(cc) * Sh::ROWBUF_F, p, stage.at0, stage.HK,
                           cc * kChunk, T, gr, gk, gw);
        }
      }

      // the reverse walk, kSteps steps at a time
#pragma unroll
      for (int i1 = kHist - kSteps; i1 >= 0; i1 -= kSteps) {
        float o[3 * kSteps];          // [step][gr, gk, gw]: this thread's columns
        float q[kSteps * kCpt];       // [step][column]: this thread's row, for gv
#pragma unroll
        for (int s = kSteps - 1; s >= 0; --s) {
          const float* st = cs + (i0 + i1 + s) * ROW;
          const float rr = st[row], kr = st[K + row], wr = st[2 * K + row];
          float vv[kCpt], gg[kCpt];
          ldv<kCpt, true>(st + 3 * K + cc0, vv);
          ldv<kCpt, true>(st + 3 * K + COLS + cc0, gg);
          float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
          for (int c = 0; c < kCpt; ++c) {
            const float sp = hist[i1 + s][c];
            pr = fmaf(sp, gg[c], pr);               // S_{t-1} gy
            pk = fmaf(dS[c], vv[c], pk);            // dS v
            pw = fmaf(dS[c], sp, pw);               // dS * S_{t-1}
            q[s * kCpt + c] = kr * dS[c];           // dS^T k, this row's term
            dS[c] = fmaf(wr, dS[c], rr * gg[c]);
          }
          o[3 * s] = pr, o[3 * s + 1] = pk, o[3 * s + 2] = pw;
        }
        // over the row's L lanes: lane group lg >> BF_R is left with steps
        // i1 + row_step .., and its first lane stores them into the buffer
        // of the CTA that sums them
        reduce_scatter<3 * kSteps, L / 2, Sh::RS_R>(o, lane);
        butterfly<3 * Sh::SPL, (L >> Sh::RS_R) / 2, Sh::BF_R>(o);
        if (row_writer) {
#pragma unroll
          for (int e = 0; e < Sh::SPL; ++e) {
            const int i = i0 + i1 + row_step + e;
            const float* st = cs + i * ROW;
            const float rr = st[row], kr = st[K + row], ci = c_s[i];
            const int own = i / SPC, il = i - own * SPC;
            unsigned at = rpart[0];
#pragma unroll
            for (int qq = 1; qq < P; ++qq) at = own == qq ? rpart[qq] : at;
            at += part_at + 4u * (unsigned)(il * P * 3 * K);
            st_cluster(at, fmaf(uu * kr, ci, o[3 * e]));              // + u k c (this CTA's c)
            st_cluster(at + 4u * K, fmaf(rr * uu, ci, o[3 * e + 1]));  // + r u c
            st_cluster(at + 8u * K, o[3 * e + 2]);
            gu_acc = fmaf(rr * kr, ci, gu_acc);
          }
        }
        // over the warp's RW rows: lane group rgb is left with entries
        // rgb * QN .. of q
        reduce_scatter<Sh::NQ, 16, Sh::RS_C>(q, lane);
        butterfly<QN, (16 >> Sh::RS_C), Sh::BF_C>(q);
        if (col_writer) {
#pragma unroll
          for (int e = 0; e < QN; ++e)
            col_at[(i0 + i1 + (QN < kCpt ? 0 : e / kCpt)) * COLS + (QN < kCpt ? e : e % kCpt)] =
                q[e];
        }
      }
    }
    __syncthreads();          // colbuf, and every partial of this chunk stored
    if (ch % kExch == 0) cluster_arrive();  // ... and of its group, in the CTAs that sum them
#pragma unroll
    for (int j = 0; j < (kChunk + SPP - 1) / SPP; ++j) {
      const int i = gv_i + j * SPP;
      if (kChunk % SPP == 0 || i < kChunk) {
        float acc = colbuf[i * COLS + gv_c];
#pragma unroll
        for (int wv = 1; wv < NW; ++wv) acc += colbuf[(wv * kChunk + i) * COLS + gv_c];
        acc = fmaf(a_s[i], cs[i * ROW + 3 * K + COLS + gv_c], acc);
        if (t0 + i < T) gv[stage.at0 + (size_t)(t0 + i) * stage.HK + j0 + gv_c] = acc;
      }
    }
  }
  cluster_wait();
  for (int cc = 0; cc < min(kExch, nch); ++cc)
    cluster_sum<K>(rowbuf + part_slot(cc) * Sh::ROWBUF_F, p, stage.at0, stage.HK, cc * kChunk, T,
                   gr, gk, gw);

  if (gs0 != nullptr) stv<kCpt, VEC>(gs0 + sidx, dS);
  // gu: this CTA's part (its columns' c, all t) to the scratch; the head's
  // last CTA to get here sums the P * B parts in order
#pragma unroll
  for (int m = 1; m < L; m <<= 1) gu_acc += __shfl_xor_sync(0xffffffffu, gu_acc, m);
  if (lg == 0) gu_part[(((size_t)p * B + b) * H + h) * K + row] = gu_acc;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket + h, 1u) == (unsigned)(P * B - 1);
  __syncthreads();
  if (last) {
    __threadfence();
    for (int i = threadIdx.x; i < K; i += NT) {
      float acc = 0.f;
      for (int qb = 0; qb < P * B; ++qb) acc += __ldcg(gu_part + ((size_t)qb * H + h) * K + i);
      gu[(size_t)h * K + i] = acc;
    }
  }
}

template <int K, bool VEC>
cudaError_t launch(const float* r, const float* k, const float* v, const float* w,
                   const float* u, const float* ckpt, const float* gy, const float* gsT,
                   float* gr, float* gk, float* gv, float* gw, float* gu, float* gs0,
                   float* gu_part, unsigned* ticket, int B, int T, int H,
                   cudaStream_t stream) {
  using Sh = Shape<K>;
  auto kernel = wkv_scan_bwd_kernel<K, VEC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Sh::SMEM);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(ticket, 0, sizeof(unsigned) * H, stream);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Sh::P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H * Sh::P));
  cfg.blockDim = dim3(Sh::NT);
  cfg.dynamicSmemBytes = Sh::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, r, k, v, w, u, ckpt, gy, gsT, gr, gk, gv, gw, gu, gs0,
                         gu_part, ticket, B, T, H);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_any(bool vec, const float* r, const float* k, const float* v,
                       const float* w, const float* u, const float* ckpt, const float* gy,
                       const float* gsT, float* gr, float* gk, float* gv, float* gw, float* gu,
                       float* gs0, float* gu_part, unsigned* ticket, int B, int T, int H,
                       cudaStream_t stream) {
  return (vec ? launch<K, true> : launch<K, false>)(r, k, v, w, u, ckpt, gy, gsT, gr, gk, gv,
                                                     gw, gu, gs0, gu_part, ticket, B, T, H,
                                                     stream);
}

}  // namespace

// The CTAs of a (b, h)'s cluster at head size K (K / min(kCols, K)), the
// first dimension of the gu_part scratch; 0 for a K the kernel does not take.
extern "C" int repro_wkv_scan_bwd_cluster(int K) {
  switch (K) {
    case 16: return Shape<16>::P;
    case 32: return Shape<32>::P;
    case 64: return Shape<64>::P;
    default: return 0;
  }
}

// Plain C entry point (loaded with ctypes).  K is the head size (K = V);
// gsT and gs0 may be null; gu_part holds repro_wkv_scan_bwd_cluster(K) * B * H
// * K floats and ticket H unsigned ints (zeroed here, on the stream, before
// the launch).
// Returns the cudaError_t of the launch (0 = cudaSuccess); shapes the
// kernel does not take return cudaErrorInvalidValue without launching.
extern "C" int repro_wkv_scan_bwd(const void* r, const void* k, const void* v,
                                  const void* w, const void* u, const void* ckpt,
                                  const void* gy, const void* gsT, void* gr, void* gk,
                                  void* gv, void* gw, void* gu, void* gs0, void* gu_part,
                                  void* ticket, int B, int T, int H, int K, void* stream) {
  if (B < 1 || T < 1 || H < 1 || (long long)B * H * 4 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
                   aligned16(ckpt) && aligned16(gy) && (gsT == nullptr || aligned16(gsT)) &&
                   (gs0 == nullptr || aligned16(gs0));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_WKV_BWD_ARGS                                                          \
  vec, static_cast<const float*>(r), static_cast<const float*>(k),                  \
      static_cast<const float*>(v), static_cast<const float*>(w),                   \
      static_cast<const float*>(u), static_cast<const float*>(ckpt),                \
      static_cast<const float*>(gy), static_cast<const float*>(gsT),                \
      static_cast<float*>(gr), static_cast<float*>(gk), static_cast<float*>(gv),    \
      static_cast<float*>(gw), static_cast<float*>(gu), static_cast<float*>(gs0),   \
      static_cast<float*>(gu_part), static_cast<unsigned*>(ticket), B, T, H, s
  switch (K) {
    case 16: return (int)launch_any<16>(REPRO_WKV_BWD_ARGS);
    case 32: return (int)launch_any<32>(REPRO_WKV_BWD_ARGS);
    case 64: return (int)launch_any<64>(REPRO_WKV_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_WKV_BWD_ARGS
}
