// Backward of chunkwise multi-scale retention for Hopper (sm_90a): the
// gradient RetNet's training forward needs.
//
// Replaces the gradient of the Pallas TPU kernel `retention_chunkwise_pallas`
// (src/repro/kernels/retention_kernel.py), which JAX's autodiff derives there.
// The forward (retention_chunkwise.cu) computes, per (batch*head) and chunk j
// of c positions with incoming f32 state S_j [dk, dv],
//
//     Y_j     = ((Q_j K_j^T) .* D) V_j + Lambda Q_j S_j      D[i,t] = gamma^(i-t), i >= t
//     S_{j+1} = gamma^c S_j + (Gamma K_j)^T V_j              Lambda = diag(gamma^(i+1)),
//                                                            Gamma = diag(gamma^(c-1-t))
//
// Given dY and the cotangent dS_N of the final state (zero when the pointer
// is null), this file computes, walking the chunks in reverse for the states,
//
//     dS_j = gamma^c dS_{j+1} + (Lambda Q_j)^T dY_j
//     dQ_j = ((dY_j V_j^T) .* D) K_j   + Lambda dY_j S_j^T
//     dK_j = ((dY_j V_j^T) .* D)^T Q_j + Gamma V_j dS_{j+1}^T
//     dV_j = ((Q_j K_j^T) .* D)^T dY_j + Gamma K_j dS_{j+1}
//
// and the initial state's cotangent dS_0 (when asked for).
//
// What bounds it on the H100: operations.  At retnet-1.3b's training shape
// (B 2, H 8, S 512, dk 256, dv 512, c 128, zero initial state, no final-state
// cotangent) the gradient needs 9.95 GFLOP against 83.9 MB of inputs and
// outputs.  Single-pass TF32 misses the 1e-4 tolerance (retention_chunkwise.cu),
// so every product runs as 3xTF32 on the tensor cores (mma.sync m16n8k8, the
// split of tf32.cuh: a = hi + lo, a.b ~ lo.hi + hi.lo + hi.hi): 3 x 9.95
// GFLOP at 495 TFLOP/s is 0.060 ms a call, the kernel's bound (the same work
// as f32 FMAs on the CUDA cores, the first design's, 0.149 ms; the bytes
// alone 0.025 ms at 3.35 TB/s).  The tensor cores' accumulate truncates, so
// each k8 step's three products go into a fresh fragment and reach the
// running sum through an f32 add, as in the forward.
//
// Two launches (one wrapper call, one count in
// hopper.LAUNCHES["retention_chunkwise_bwd"]):
//
//   pass 1, two kinds of blocks in one grid, the longest first:
//     state blocks (direction, bh, 64 rows of dk, 128 columns of dv) hold
//       their tile in registers and walk the chunks: forward from S_0 (zero
//       when the pointer is null), storing the recomputed incoming states
//       S_1..S_{N-1}; in reverse from dS_N, storing dS_{N-1}..dS_1 and, when
//       asked for, dS_0.  Neither S_0 nor dS_N is copied: pass 2 reads them
//       where they lie, or skips their terms when the pointers are null;
//     score blocks (kind, bh, chunk, 64 columns) compute dP = (dY V^T) .* D
//       and P = (Q K^T) .* D over a whole chunk of rows, zero above the
//       diagonal, where whole warp tiles skip their products;
//   pass 2, grads blocks (bh, chunk, 64 columns of dQ, dK or dV) over a whole
//       chunk of rows: the state term first (skipped where its state or
//       cotangent is zero), its rows scaled by gamma^(i+1) or gamma^(c-1-t),
//       then the intra-chunk term in the same accumulator, each warp
//       contracting only the pairs on its side of the diagonal (dQ up to its
//       last row, dK and dV from its first).  Chunks with a state term run
//       first.
//
// Every block is 8 warps of 32 x 32 warp tiles (a 64 x 128 or 128 x 64
// block tile), two blocks per SM, streaming 32-deep k-slices of both
// operands through a 3-stage cp.async ring (16-byte copies, zero-filled past
// ragged edges), so the next slices are in flight while the current one is
// multiplied.  Each product reads its operands as they lie in device memory:
// an operand contracted over its rows (K^T V and Q^T dY in the state walk,
// dP^T Q in dK, P^T dY in dV) is staged as rows of k, and the row strides in
// shared memory are padded (k-major rows by 8 floats, m- or n-major rows by
// 4) so that every fragment read hits 32 distinct banks.  The per-row decays
// are applied at the fragment (the state walk's gamma^(c-1-t), gamma^(t+1)
// on A's columns) or in the epilogue (D, Lambda, Gamma), never in the copy.
// Why not wgmma: a TF32 wgmma reads both operands K-major from shared
// memory, and its transpose modes exist only for 16-bit types, while four
// of these products read an operand transposed; that is left to a later
// design.
// Every output element is summed in one fixed order by one thread: no
// atomics, so relaunches are bit-equal.  The launches allocate nothing and
// capture into a CUDA graph.
// Scratch (allocated by the caller, sized by hopper.retention_bwd_plan): the
// incoming states S_1..S_{N-1} and the cotangents dS_1..dS_{N-1}, 2 * BH *
// (N - 1) * dk * dv floats, and P and dP, 2 * BH * N * c * ldp floats (50.3
// + 8.4 MB at the shape above).  q, k, v and dY are read through their
// (B, H, S) strides (unit stride in the last dim, 16-byte aligned rows); dQ,
// dK and dV are written through their own.
// Limits: chunk <= 128 (a score or grads block holds a whole chunk); dk <=
// 256 (hopper.retention_plan); dk, dv multiples of 4; ldp a multiple of 4
// >= chunk.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kBK = 32;                 // k-slice depth
constexpr int kStages = 3;              // cp.async ring
constexpr int kTile = 128;              // rows of a score / grads block: a whole chunk
constexpr int kCols = 64;               // columns of a score / grads block
constexpr int kStateM = 64, kStateN = 128;   // a state block's tile of [dk, dv]
constexpr int kMaxChunk = 128;
constexpr int kTable = kMaxChunk + 4;   // gamma^t, t = 0..128 (+ pad to 16 bytes)
constexpr int kMF = 2, kNF = 4;         // a 32 x 32 warp tile of m16n8 fragments
constexpr int kBlocksPerSm = 2;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dy;
  const float* gamma;
  const float* state_in;   // S_0, or null for zero
  const float* dstate;     // dS_N, or null for zero
  float* dq;
  float* dk;
  float* dv;
  float* dstate0;          // dS_0 out, or null when not asked for
  float* s_in;             // [BH, N - 1, dk, dv] incoming states S_1..S_{N-1}
  float* ds;               // [BH, N - 1, dk, dv] cotangents dS_1..dS_{N-1}
  float* p;                // [BH, N, c, ldp] (Q K^T) .* D
  float* dp;               // [BH, N, c, ldp] (dY V^T) .* D
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, gb, gh, gs;
  long long dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
  int bh, heads, dk_, dv_, chunk, n_chunks, ldp;
  int st_dk_t, st_dv_t, fwd_blocks, rev_blocks, c_t, dk_t, dv_t;
};

// ---- operand staging ------------------------------------------------------------
// A product's operands: A is M x K, B is K x N.  A_KM: A is staged as rows of
// k ([k][m]); B_NK: B as rows of n ([n][k]).  The padding puts a warp's
// fragment reads on 32 distinct banks either way.
template <bool A_KM_, bool B_NK_, int BM_, int BN_>
struct Lay {
  static constexpr bool A_KM = A_KM_, B_NK = B_NK_;
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int LDA = A_KM ? BM + 8 : kBK + 4;
  static constexpr int LDB = B_NK ? kBK + 4 : BN + 8;
  static constexpr int A_SIZE = A_KM ? kBK * LDA : BM * LDA;
  static constexpr int STAGE = A_SIZE + (B_NK ? BN * LDB : kBK * LDB);
  static constexpr int WARPS_N = BN / (kNF * 8);
  static_assert((BM / (kMF * 16)) * WARPS_N * 32 == kThreads, "8 warps of 32 x 32");
};

using StateLay = Lay<true, false, kStateM, kStateN>;   // K^T V, Q^T dY
using RowNkLay = Lay<false, true, kTile, kCols>;       // Q K^T, dY V^T; dY S^T, V dS^T
using RowRowLay = Lay<false, false, kTile, kCols>;     // dP K, K dS
using KmRowLay = Lay<true, false, kTile, kCols>;       // dP^T Q, P^T dY

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kRing = cmax(cmax(StateLay::STAGE, RowNkLay::STAGE),
                           cmax(RowRowLay::STAGE, KmRowLay::STAGE));
constexpr int kSmem = kTable + kMaxChunk + kStages * kRing;   // floats
static_assert((kTable + kMaxChunk) % 4 == 0, "the ring starts 16-byte aligned");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major global matrix (row
// stride ld; rows_ok x cols_ok valid, cols_ok a multiple of 4) into shared
// memory with row stride lds; pieces past the edges are zero-filled.
template <int R, int C>
__device__ __forceinline__ void load_tile(float* sm, int lds, const float* g, long long ld,
                                          int r0, int c0, int rows_ok, int cols_ok) {
  constexpr int kPer = C / 4;
  static_assert((R * kPer) % kThreads == 0, "whole rounds of 16-byte copies");
#pragma unroll
  for (int it = 0; it < R * kPer / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / kPer, c = (idx % kPer) * 4;
    const bool ok = r0 + r < rows_ok && c0 + c < cols_ok;
    cp_async16(sm + r * lds + c, ok ? g + (long long)(r0 + r) * ld + c0 + c : g, ok);
  }
}

// One k-slice of both operands into a ring stage: A's rows m0.. (m_ok valid,
// k past ka_ok zero) and B's columns n0.. (n_ok valid, k past kb_ok zero),
// each as it lies in device memory (row stride lda, ldb), over k0 .. k0 + kBK.
template <class L>
__device__ __forceinline__ void load_slice(float* stage, const float* a, long long lda,
                                           int m0, int m_ok, int ka_ok, const float* b,
                                           long long ldb, int n0, int n_ok, int kb_ok, int k0) {
  if (L::A_KM)
    load_tile<kBK, L::BM>(stage, L::LDA, a, lda, k0, m0, ka_ok, m_ok);
  else
    load_tile<L::BM, kBK>(stage, L::LDA, a, lda, m0, k0, m_ok, ka_ok);
  float* sb = stage + L::A_SIZE;
  if (L::B_NK)
    load_tile<L::BN, kBK>(sb, L::LDB, b, ldb, n0, k0, n_ok, kb_ok);
  else
    load_tile<kBK, L::BN>(sb, L::LDB, b, ldb, k0, n0, kb_ok, n_ok);
}

struct Acc {
  float v[kMF][kNF][4];
};

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc.v[mf][nf][i] = 0.f;
}

// Calls f(row, col, a0, a1) for each pair of neighbouring accumulator columns
// a thread owns; row and col are within the block tile.
template <class F>
__device__ __forceinline__ void for_pairs(Acc& acc, int wm, int wn, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        f(wm + mf * 16 + g + 8 * hf, wn + nf * 8 + 2 * t, acc.v[mf][nf][2 * hf],
          acc.v[mf][nf][2 * hf + 1]);
}

// One k8 step of a warp tile in 3xTF32, k = kk..kk+7 of the staged slice.
// With ksc (shared, the slice's own), A's column k is scaled by ksc[k].
template <class L, bool SCALE>
__device__ __forceinline__ void mma_k8(Acc& acc, const float* sA, const float* sB, int wm,
                                       int wn, int kk, const float* ksc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[kMF][4], al[kMF][4], bh[kNF][2], bl[kNF][2];
  float s0 = 1.f, s1 = 1.f;
  if (SCALE) {
    s0 = ksc[kk + t];
    s1 = ksc[kk + t + 4];
  }
#pragma unroll
  for (int mf = 0; mf < kMF; ++mf) {
    const int r = wm + mf * 16 + g;
    float x[4];
    if (L::A_KM) {
      x[0] = sA[(kk + t) * L::LDA + r];
      x[1] = sA[(kk + t) * L::LDA + r + 8];
      x[2] = sA[(kk + t + 4) * L::LDA + r];
      x[3] = sA[(kk + t + 4) * L::LDA + r + 8];
    } else {
      x[0] = sA[r * L::LDA + kk + t];
      x[1] = sA[(r + 8) * L::LDA + kk + t];
      x[2] = sA[r * L::LDA + kk + t + 4];
      x[3] = sA[(r + 8) * L::LDA + kk + t + 4];
    }
    if (SCALE) {
      x[0] *= s0;
      x[1] *= s0;
      x[2] *= s1;
      x[3] *= s1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], ah[mf][i], al[mf][i]);
  }
#pragma unroll
  for (int nf = 0; nf < kNF; ++nf) {
    const int c = wn + nf * 8 + g;
    const float y0 = L::B_NK ? sB[c * L::LDB + kk + t] : sB[(kk + t) * L::LDB + c];
    const float y1 = L::B_NK ? sB[c * L::LDB + kk + t + 4] : sB[(kk + t + 4) * L::LDB + c];
    split_tf32(y0, bh[nf][0], bl[nf][0]);
    split_tf32(y1, bh[nf][1], bl[nf][1]);
  }
  // The tensor cores' accumulate truncates, so the three products of this
  // k-step go into a fresh fragment (small ones first) and reach the running
  // sum through an f32 add, which rounds to nearest.
#pragma unroll
  for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf) {
      float d[4];
      mma_tf32_zero(d, al[mf], bh[nf]);
      mma_tf32(d, ah[mf], bl[nf]);
      mma_tf32(d, ah[mf], bh[nf]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc.v[mf][nf][i] += d[i];
    }
}

// The k8 steps of a staged slice below k_hi.
template <class L, bool SCALE>
__device__ __forceinline__ void mma_slice(Acc& acc, const float* stage, int wm, int wn,
                                          int k_hi, const float* ksc) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8)
    if (kk < k_hi)
      mma_k8<L, SCALE>(acc, stage, stage + L::A_SIZE, wm, wn, kk, ksc);
}

// The cp.async ring: load(slice, stage) issues a slice's copies, compute(slice,
// stage) consumes it.  Slices s + 1 .. s + kStages - 1 are in flight while
// slice s is multiplied.
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int nslices, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslices) load(s, s);
    cp_commit();
  }
  for (int s = 0; s < nslices; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < nslices) load(next, next % kStages);
    cp_commit();
    compute(s, s % kStages);
  }
  cp_wait<0>();
}

// gamma^t for t = 0..kTable-1 of head h, as the forward builds it (read after
// the pipeline's first barrier).
__device__ __forceinline__ float fill_decays(float* pw, const Params& p, int h) {
  const float lg = logf(p.gamma[h]);
  for (int t = threadIdx.x; t < kTable; t += kThreads) pw[t] = expf((float)t * lg);
  return lg;
}

__device__ __forceinline__ void warp_origin(int warps_n, int& wm, int& wn) {
  const int w = threadIdx.x >> 5;
  wm = (w / warps_n) * 32;
  wn = (w % warps_n) * 32;
}

__device__ __forceinline__ void store_tile(Acc& acc, int wm, int wn, float* dst, long long ld,
                                           int m_ok, int n0, int n_ok) {
  for_pairs(acc, wm, wn, [&](int r, int c, float& a0, float& a1) {
    if (r < m_ok && n0 + c < n_ok)
      *reinterpret_cast<float2*>(dst + (long long)r * ld + n0 + c) = make_float2(a0, a1);
  });
}

// ---- pass 1: a state block -----------------------------------------------------------
// Forward: acc = S_0, then per chunk j = 0..N-2, S_{j+1} = gamma^c S_j +
// (Gamma K_j)^T V_j, each stored.  Reverse: acc = dS_N, then per chunk j =
// N-1 down to 1 (0 when dS_0 is asked for), dS_j = gamma^c dS_{j+1} +
// (Lambda Q_j)^T dY_j, each stored.
__device__ __forceinline__ void state_block(const Params& p, float* sc, float* ring, int blk) {
  using L = StateLay;
  const bool rev = blk >= p.fwd_blocks;
  if (rev) blk -= p.fwd_blocks;
  const int et = blk % p.st_dv_t;
  blk /= p.st_dv_t;
  const int dt = blk % p.st_dk_t, bh = blk / p.st_dk_t;
  const int b = bh / p.heads, h = bh % p.heads, c = p.chunk, n = p.n_chunks;
  const float lg = logf(p.gamma[h]);
  const float chunk_decay = expf((float)c * lg);
  // A's column t of a chunk (its position) carries gamma^(c-1-t) (K) or
  // gamma^(t+1) (Q), as gamma^t is built (read after the pipeline's first
  // barrier).
  for (int t = threadIdx.x; t < kMaxChunk; t += kThreads)
    sc[t] = t < c ? expf((float)(rev ? t + 1 : c - 1 - t) * lg) : 0.f;
  const int m0 = dt * L::BM, n0 = et * L::BN;
  const size_t mat = (size_t)p.dk_ * p.dv_;
  const float* xa = rev ? p.q + b * p.qb + h * p.qh : p.k + b * p.kb + h * p.kh;
  const long long lda = rev ? p.qs : p.ks;
  const float* xb = rev ? p.dy + b * p.gb + h * p.gh : p.v + b * p.vb + h * p.vh;
  const long long ldb = rev ? p.gs : p.vs;
  float* scratch = (rev ? p.ds : p.s_in) + (size_t)bh * (n - 1) * mat;
  int wm, wn;
  warp_origin(L::WARPS_N, wm, wn);

  Acc acc;
  const float* s0 = rev ? p.dstate : p.state_in;
  for_pairs(acc, wm, wn, [&](int r, int cc, float& a0, float& a1) {
    const int d = m0 + r, e = n0 + cc;
    float2 x = make_float2(0.f, 0.f);
    if (s0 && d < p.dk_ && e < p.dv_)
      x = *reinterpret_cast<const float2*>(s0 + bh * mat + (size_t)d * p.dv_ + e);
    a0 = x.x;
    a1 = x.y;
  });
  // Chunks walked: forward 0..N-2; reverse N-1 down to 1, or to 0 for dS_0.
  const int walked = rev ? n - 1 + (p.dstate0 != nullptr) : n - 1;
  const int per_chunk = (c + kBK - 1) / kBK;
  // The state after `done` chunks of the walk: S_done (forward), dS_{N-done}
  // (reverse), in scratch slot done - 1 or N - done - 1.
  auto store = [&](int done) {
    float* dst = rev ? (done == n ? p.dstate0 + bh * mat : scratch + (size_t)(n - done - 1) * mat)
                     : scratch + (size_t)(done - 1) * mat;
    store_tile(acc, wm, wn, dst + m0 * (size_t)p.dv_, p.dv_, p.dk_ - m0, n0, p.dv_);
  };
  auto load = [&](int s, int stage) {
    const int i = s / per_chunk, j = rev ? n - 1 - i : i;
    const long long row0 = (long long)j * c;
    load_slice<L>(ring + stage * kRing, xa + row0 * lda, lda, m0, p.dk_, c, xb + row0 * ldb,
                  ldb, n0, p.dv_, c, (s % per_chunk) * kBK);
  };
  auto compute = [&](int s, int stage) {
    const int i = s / per_chunk, j0 = (s % per_chunk) * kBK;
    if (j0 == 0) {          // a chunk starts: acc is the state before it
      if (i > 0) store(i);
#pragma unroll
      for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc.v[mf][nf][e] *= chunk_decay;
    }
    mma_slice<L, true>(acc, ring + stage * kRing, wm, wn, c - j0, sc + j0);
  };
  pipeline(walked * per_chunk, load, compute);
  if (walked > 0) store(walked);
}

// ---- pass 1: a score block -------------------------------------------------------------
__device__ __forceinline__ void score_block(const Params& p, float* pw, float* ring, int blk) {
  using L = RowNkLay;
  const int n0 = (blk % p.c_t) * L::BN;
  blk /= p.c_t;
  const int j = blk % p.n_chunks;
  blk /= p.n_chunks;
  const int bh = blk % p.bh;
  const bool grad = blk / p.bh == 0;         // dP = (dY V^T) .* D first, then P = (Q K^T) .* D
  const int b = bh / p.heads, h = bh % p.heads, c = p.chunk;
  fill_decays(pw, p, h);
  const long long row0 = (long long)j * c;
  const float* xa = grad ? p.dy + b * p.gb + h * p.gh + row0 * p.gs
                         : p.q + b * p.qb + h * p.qh + row0 * p.qs;
  const float* xb = grad ? p.v + b * p.vb + h * p.vh + row0 * p.vs
                         : p.k + b * p.kb + h * p.kh + row0 * p.ks;
  const long long lda = grad ? p.gs : p.qs, ldb = grad ? p.vs : p.ks;
  const int kdim = grad ? p.dv_ : p.dk_;
  int wm, wn;
  warp_origin(L::WARPS_N, wm, wn);
  // A warp tile wholly above the diagonal (every column past every row) or
  // past the chunk computes nothing: its scores are zero.
  const bool idle = n0 + wn >= wm + 32 || wm >= c || n0 + wn >= c;

  Acc acc;
  zero(acc);
  auto load = [&](int s, int stage) {
    load_slice<L>(ring + stage * kRing, xa, lda, 0, c, kdim, xb, ldb, n0, c, kdim, s * kBK);
  };
  auto compute = [&](int s, int stage) {
    if (!idle) mma_slice<L, false>(acc, ring + stage * kRing, wm, wn, kdim - s * kBK, nullptr);
  };
  pipeline((kdim + kBK - 1) / kBK, load, compute);

  float* dst = (grad ? p.dp : p.p) + ((size_t)bh * p.n_chunks + j) * c * p.ldp;
  for_pairs(acc, wm, wn, [&](int i, int cc, float& a0, float& a1) {
    const int t = n0 + cc;
    if (i < c && t < p.ldp) {
      const float x0 = t <= i ? a0 * pw[i - t] : 0.f;
      const float x1 = t + 1 <= i ? a1 * pw[i - t - 1] : 0.f;
      *reinterpret_cast<float2*>(dst + (size_t)i * p.ldp + t) = make_float2(x0, x1);
    }
  });
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) retention_bwd_pass1(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + kTable + kMaxChunk;
  const int blk = blockIdx.x, states = p.fwd_blocks + p.rev_blocks;
  if (blk < states)
    state_block(p, smem + kTable, ring, blk);
  else
    score_block(p, smem, ring, blk - states);
}

// ---- pass 2: a grads block ---------------------------------------------------------------
// KIND 0: dQ = Lambda (dY S_j^T) + dP K; 1: dK = Gamma (V dS_{j+1}^T) + dP^T Q;
// 2: dV = Gamma (K dS_{j+1}) + P^T dY, over a whole chunk of rows and 64
// columns.  The first product (L1, over dv or dk) is skipped when its state
// is zero; the second (L2) runs over the chunk's positions on the warp's
// side of the diagonal.
template <int KIND>
__device__ __forceinline__ void grads_block(const Params& p, float* pw, float* ring, int col_t,
                                            int bh, int walked) {
  using L1 = typename std::conditional<KIND == 2, RowRowLay, RowNkLay>::type;
  using L2 = typename std::conditional<KIND == 0, RowRowLay, KmRowLay>::type;
  const int n0 = col_t * kCols, n = p.n_chunks;
  const int j = KIND == 0 ? n - 1 - walked : walked;    // chunks with a state term first
  const int b = bh / p.heads, h = bh % p.heads, c = p.chunk;
  fill_decays(pw, p, h);
  const long long row0 = (long long)j * c;
  const size_t mat = (size_t)p.dk_ * p.dv_;
  const float* q = p.q + b * p.qb + h * p.qh + row0 * p.qs;
  const float* k = p.k + b * p.kb + h * p.kh + row0 * p.ks;
  const float* v = p.v + b * p.vb + h * p.vh + row0 * p.vs;
  const float* dy = p.dy + b * p.gb + h * p.gh + row0 * p.gs;
  const float* scores = (KIND == 2 ? p.p : p.dp) + ((size_t)bh * n + j) * c * p.ldp;
  // The state term's matrix: S_j for dQ, dS_{j+1} for dK and dV, read where
  // it lies (S_0 and dS_N from the caller's tensors), null when zero.
  const float* st;
  if (KIND == 0)
    st = j > 0 ? p.s_in + ((size_t)bh * (n - 1) + j - 1) * mat
               : (p.state_in ? p.state_in + bh * mat : nullptr);
  else
    st = j < n - 1 ? p.ds + ((size_t)bh * (n - 1) + j) * mat
                   : (p.dstate ? p.dstate + bh * mat : nullptr);
  const int n_ok = KIND == 2 ? p.dv_ : p.dk_;
  const int kdim1 = KIND == 2 ? p.dk_ : p.dv_;
  const int nk1 = st ? (kdim1 + kBK - 1) / kBK : 0;
  const int nk2 = (c + kBK - 1) / kBK;
  int wm, wn;
  warp_origin(L1::WARPS_N, wm, wn);

  Acc acc;
  zero(acc);
  auto load = [&](int s, int stage) {
    float* sa = ring + stage * kRing;
    if (s < nk1) {
      const float* a = KIND == 0 ? dy : KIND == 1 ? v : k;
      const long long lda = KIND == 0 ? p.gs : KIND == 1 ? p.vs : p.ks;
      load_slice<L1>(sa, a, lda, 0, c, kdim1, st, p.dv_, n0, n_ok, kdim1, s * kBK);
    } else {
      const float* bm = KIND == 0 ? k : KIND == 1 ? q : dy;
      const long long ldb = KIND == 0 ? p.ks : KIND == 1 ? p.qs : p.gs;
      // dQ reads the scores' rows (k = their columns, zero from the chunk's
      // end to ldp); dK and dV read them as rows of k.
      load_slice<L2>(sa, scores, p.ldp, 0, KIND == 0 ? c : p.ldp, KIND == 0 ? p.ldp : c, bm,
                     ldb, n0, n_ok, c, (s - nk1) * kBK);
    }
  };
  auto compute = [&](int s, int stage) {
    if (wm >= c) return;                       // rows past the chunk
    const float* sa = ring + stage * kRing;
    if (s < nk1) {
      mma_slice<L1, false>(acc, sa, wm, wn, kdim1 - s * kBK, nullptr);
      return;
    }
    if (s == nk1 && nk1 > 0)                   // the state term's rows: Lambda or Gamma
      for_pairs(acc, wm, wn, [&](int i, int, float& a0, float& a1) {
        const float w = i < c ? pw[KIND == 0 ? i + 1 : c - 1 - i] : 0.f;
        a0 *= w;
        a1 *= w;
      });
    const int j0 = (s - nk1) * kBK;
    if (KIND == 0)                             // dP[i, t] = 0 past i: stop at the warp's last row
      mma_slice<L2, false>(acc, sa, wm, wn, min(wm + 32, c) - j0, nullptr);
    else if (j0 >= wm)                         // dP[i, t], P[i, t] = 0 before t: start at its first
      mma_slice<L2, false>(acc, sa, wm, wn, c - j0, nullptr);
  };
  pipeline(nk1 + nk2, load, compute);

  float* out;
  long long ld;
  if (KIND == 0) {
    out = p.dq + b * p.dqb + h * p.dqh + row0 * p.dqs;
    ld = p.dqs;
  } else if (KIND == 1) {
    out = p.dk + b * p.dkb + h * p.dkh + row0 * p.dks;
    ld = p.dks;
  } else {
    out = p.dv + b * p.dvb + h * p.dvh + row0 * p.dvs;
    ld = p.dvs;
  }
  store_tile(acc, wm, wn, out, ld, c, n0, n_ok);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) retention_bwd_pass2(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + kTable + kMaxChunk;
  // (step of the chunk walk, bh, tile of dQ | dK | dV): every kind's chunks
  // with a state term come before the last step's, which may have none.
  const int tiles = 2 * p.dk_t + p.dv_t;
  const int tile = blockIdx.x % tiles, rest = blockIdx.x / tiles;
  const int bh = rest % p.bh, walked = rest / p.bh;
  if (tile < p.dk_t)
    grads_block<0>(p, smem, ring, tile, bh, walked);
  else if (tile < 2 * p.dk_t)
    grads_block<1>(p, smem, ring, tile - p.dk_t, bh, walked);
  else
    grads_block<2>(p, smem, ring, tile - 2 * p.dk_t, bh, walked);
}

template <class K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmem * (int)sizeof(float));
}

int ceil_div(int x, int t) { return (x + t - 1) / t; }

}  // namespace

// dims (int64): B, H, S, dk, dv, chunk, ldp, then the element strides over
// (B, H, S) of q, k, v, dY, dQ, dK and dV.
extern "C" int retention_chunkwise_bwd_launch(const void* q, const void* k, const void* v,
                                              const void* gamma, const void* state_in,
                                              const void* dy, const void* dstate, void* dq,
                                              void* dk, void* dv, void* dstate0,
                                              void* s_scratch, void* ds_scratch,
                                              void* p_scratch, void* dp_scratch,
                                              const long long* dims, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(retention_bwd_pass1);
    if (err == cudaSuccess) err = allow_smem(retention_bwd_pass2);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  Params p;
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.dy = (const float*)dy;
  p.gamma = (const float*)gamma;
  p.state_in = (const float*)state_in;
  p.dstate = (const float*)dstate;
  p.dq = (float*)dq;
  p.dk = (float*)dk;
  p.dv = (float*)dv;
  p.dstate0 = (float*)dstate0;
  p.s_in = (float*)s_scratch;
  p.ds = (float*)ds_scratch;
  p.p = (float*)p_scratch;
  p.dp = (float*)dp_scratch;
  const int batch = (int)dims[0], seq = (int)dims[2];
  p.heads = (int)dims[1];
  p.dk_ = (int)dims[3];
  p.dv_ = (int)dims[4];
  p.chunk = (int)dims[5];
  p.ldp = (int)dims[6];
  long long* st[] = {&p.qb, &p.qh, &p.qs, &p.kb, &p.kh, &p.ks, &p.vb, &p.vh, &p.vs,
                     &p.gb, &p.gh, &p.gs, &p.dqb, &p.dqh, &p.dqs, &p.dkb, &p.dkh, &p.dks,
                     &p.dvb, &p.dvh, &p.dvs};
  for (int i = 0; i < 21; ++i) *st[i] = dims[7 + i];
  if (p.chunk < 1 || p.chunk > kMaxChunk || seq % p.chunk || p.dk_ % 4 || p.dv_ % 4 ||
      p.ldp % 4 || p.ldp < p.chunk)
    return (int)cudaErrorInvalidValue;
  p.bh = batch * p.heads;
  p.n_chunks = seq / p.chunk;
  p.st_dk_t = ceil_div(p.dk_, kStateM);
  p.st_dv_t = ceil_div(p.dv_, kStateN);
  const int state_tiles = p.bh * p.st_dk_t * p.st_dv_t;
  p.fwd_blocks = p.n_chunks > 1 ? state_tiles : 0;
  p.rev_blocks = p.n_chunks > 1 || p.dstate0 ? state_tiles : 0;
  p.c_t = ceil_div(p.chunk, kCols);
  p.dk_t = ceil_div(p.dk_, kCols);
  p.dv_t = ceil_div(p.dv_, kCols);
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = kSmem * sizeof(float);
  retention_bwd_pass1<<<p.fwd_blocks + p.rev_blocks + 2 * p.bh * p.n_chunks * p.c_t, kThreads,
                        smem, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  retention_bwd_pass2<<<p.bh * p.n_chunks * (2 * p.dk_t + p.dv_t), kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}
