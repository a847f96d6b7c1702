// Chunkwise multi-scale retention for Hopper (sm_90a): RetNet prefill.
//
// Replaces the Pallas TPU kernel `retention_chunkwise_pallas`
// (src/repro/kernels/retention_kernel.py).  Per (batch*head) and chunk of c
// positions in order, with an f32 state S[dk, dv]:
//
//     y  = ((Q K^T) .* D) V + (Q .* gamma^m) S         D[i,j] = gamma^(i-j), i >= j
//     S <- gamma^c S + (K .* gamma^(c-m))^T V           m = 1..c within the chunk
//
// and returns y and the final S.  Unlike the TPU kernel, it takes an optional
// initial state (zero when the pointer is null).
//
// What bounds it on the H100: operations.  At the retnet-1.3b prefill shape
// (B 2, H 8, S 512, dk 256, dv 512, c 128, zero initial state) the function
// needs 4.57 GFLOP: Q K^T and P V over the c(c+1)/2 pairs i >= j of a chunk,
// Q S for the chunks that have a state, K^T V for every chunk.  Its inputs
// and outputs are 58.7 MB.  Single-pass TF32 on the tensor cores misses the
// 1e-4 tolerance by 20x, so every product runs as 3xTF32 (mma.sync m16n8k8;
// a = hi + lo with hi a rounded to TF32 and lo the exact rest; a.b ~ hi.hi +
// hi.lo + lo.hi): 3 x 4.57 GFLOP at 495 TFLOP/s, 27.7 us, the kernel's bound
// (the bytes take 17.5 us at 3.35 TB/s; the same work as f32 FMAs on the
// CUDA cores, 68 us at 67 TFLOP/s).  The tensor cores' accumulate
// truncates; fed the running sum it gave 9x the f32 error on an H100, so
// each k-step's products are summed apart and added in f32 (PERF.md).  The
// split and that add are ALU work beside every fragment load, and with
// mma.sync that issue, not the tensor cores' rate, is what the kernel runs
// into.
//
// The TPU walks the chunks as a sequential grid axis.  Here only the state
// recurrence is sequential, so the work is cut chunk-parallel into two
// launches (one wrapper call, one count in hopper.LAUNCHES):
//
//   pass 1, two kinds of blocks in one grid:
//     state blocks (bh, 64 rows of dk, 128 columns of dv) walk the chunks in
//       order, holding their S tile in registers: they store each chunk's
//       incoming state (chunks 1..n-1) to a scratch, then
//       S <- gamma^c S + (K gamma^(c-m))^T V; the last S is the final state;
//     score blocks (bh, chunk, 64 columns) compute P = (Q K^T) .* D once per
//       chunk into a scratch, zero above the diagonal, where whole warp
//       tiles skip their products;
//   pass 2, output blocks (bh, chunk, 64 columns of dv):
//       y = gamma^m .* (Q S_in) + P V in one accumulator, each warp stopping
//       its P V k-loop at its last row; the chunks with a state run first.
//
// Every block is 8 warps of 32 x 32 warp tiles, two blocks per SM, and
// streams 32-deep k-slices of its two operands through a 3-stage cp.async
// ring (16-byte copies, zero-filled past the edges), so the next slices are
// in flight while the current one is multiplied.  Decay factors gamma^t
// (t = 0..128) are built once per block into shared memory from
// log(gamma[h]) (expf of multiples of it, as the TPU kernel builds them).
// q, k and v are read in place through their (B, H, S) strides (unit stride
// in the last dim, 16-byte aligned rows): the model's transpose(1, 2) views
// need no copy.  y is written through its own strides, so the wrapper can
// hand back a [B, H, S, dv] view of a [B, S, H, dv] buffer.  No atomics:
// every sum has one fixed order, and relaunches are bit-equal.
// Scratch (allocated by the caller, sized by hopper.retention_plan): the
// decayed scores, BH * S * ldp floats, and the incoming states of chunks
// 1..N-1, BH * (N - 1) * dk * dv floats.  It grows linearly in S: at B 2,
// H 8, dk 256, dv 512, c 128 it is 29.4 MB at S 512 and stays under the
// 50 MB L2 up to S 768 (48.2 MB); at S 2048 it is 142.6 MB, at S 8192
// 595.6 MB, and pass 2 reads the states back from HBM.
// The tiles and the grid are fixed here (below); the launch works the grid
// out from dk, dv and the chunk count.
// Limits: chunk <= 128 (a score or output block holds a whole chunk);
// dk <= 256; dk, dv multiples of 4.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr int kMaxChunk = 128;
constexpr int kMaxDk = 256;
constexpr int kThreads = 256;           // 8 warps
constexpr int kBK = 32;                 // k-slice depth
constexpr int kStages = 3;              // cp.async ring
constexpr int kTile = 128;              // rows of a score / output tile: a whole chunk
constexpr int kTable = kMaxChunk + 4;   // gamma^t, t = 0..128 (+ pad to 16 bytes)

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* gamma;
  const float* state_in;
  float* y;
  float* state_out;
  float* p;        // [BH, N, chunk, ldp] decayed scores
  float* s;        // [BH, N - 1, dk, dv] incoming states of chunks 1..N-1
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, yb, yh, ys;
  int bh, heads, dk, dv, chunk, n_chunks, ldp;
  int state_blocks, state_dk_tiles, state_dv_tiles, out_dv_tiles;
};

// ---- tile shape of one block GEMM -------------------------------------------
// A is M x K, B is K x N.  A_KM: A is held as rows of k ([k][m]); B_NK: B is
// held as rows of n ([n][k]).  Shared-memory rows are padded so that a warp's
// fragment loads hit 32 distinct banks.
template <int BM_, int BN_, int WARPS_M_, bool A_KM_, bool B_NK_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = kThreads / 32 / WARPS_M;
  static constexpr bool A_KM = A_KM_, B_NK = B_NK_;
  static constexpr int TM = BM / WARPS_M, TN = BN / WARPS_N;
  static constexpr int MF = TM / 16, NF = TN / 8;
  static constexpr int LDA = A_KM ? BM + 8 : kBK + 4;
  static constexpr int LDB = B_NK ? kBK + 4 : BN + 8;
  static constexpr int A_SIZE = A_KM ? kBK * LDA : BM * LDA;
  static constexpr int B_SIZE = B_NK ? BN * LDB : kBK * LDB;
  static constexpr int STAGE = A_SIZE + B_SIZE;
  static constexpr int SMEM = kTable + kStages * STAGE;   // floats
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps");
  static_assert(TM % 16 == 0 && TN % 8 == 0, "warp tile");
};

// The three block GEMMs, each 8 warps of 32 x 32 warp tiles, registers held
// to two blocks per SM.  State: a 64 x 128 tile of S (A = K [j][d] read as
// [k][m], B = V [j][e]).  Score: a whole chunk x 64 columns of P (A = Q
// [i][d], B = K [j][d] read as [n][k]).  Output: a whole chunk x 64 columns
// of y (A = Q [i][d] then P [i][j], B = S [d][e] then V [j][e]).
using StateCfg = Cfg<64, 128, 2, true, false>;
using ScoreCfg = Cfg<kTile, 64, 4, false, true>;
using OutCfg = Cfg<kTile, 64, 4, false, false>;
constexpr int kBlocksPerSm = 2;
constexpr int kPass1Smem = StateCfg::SMEM > ScoreCfg::SMEM ? StateCfg::SMEM : ScoreCfg::SMEM;

// ---- primitives ---------------------------------------------------------------
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

template <class G>
struct Acc {
  float v[G::MF][G::NF][4];
};

// Calls f(row, col, pair) for each pair of neighbouring accumulator columns a
// thread owns; row and col are within the block tile.
template <class G, class F>
__device__ __forceinline__ void for_pairs(Acc<G>& acc, int wm, int wn, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mf = 0; mf < G::MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < G::NF; ++nf)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        f(wm + mf * 16 + g + 8 * hf, wn + nf * 8 + 2 * t, acc.v[mf][nf][2 * hf],
          acc.v[mf][nf][2 * hf + 1]);
}

// One k8 step of a warp tile in 3xTF32.  With SCALE, A's column k is scaled
// by pw[max(base - k, 0)] (the state pass's gamma^(c-m)).
template <class G, bool SCALE>
__device__ __forceinline__ void mma_k8(Acc<G>& acc, const float* sA, const float* sB,
                                       int wm, int wn, int kk, const float* pw, int base) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[G::MF][4], al[G::MF][4], bh[G::NF][2], bl[G::NF][2];
  float s0 = 1.f, s1 = 1.f;
  if (SCALE) {
    s0 = pw[max(base - (kk + t), 0)];
    s1 = pw[max(base - (kk + t + 4), 0)];
  }
#pragma unroll
  for (int mf = 0; mf < G::MF; ++mf) {
    const int r = wm + mf * 16 + g;
    float x[4];
    if (G::A_KM) {
      x[0] = sA[(kk + t) * G::LDA + r];
      x[1] = sA[(kk + t) * G::LDA + r + 8];
      x[2] = sA[(kk + t + 4) * G::LDA + r];
      x[3] = sA[(kk + t + 4) * G::LDA + r + 8];
    } else {
      x[0] = sA[r * G::LDA + kk + t];
      x[1] = sA[(r + 8) * G::LDA + kk + t];
      x[2] = sA[r * G::LDA + kk + t + 4];
      x[3] = sA[(r + 8) * G::LDA + kk + t + 4];
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
  for (int nf = 0; nf < G::NF; ++nf) {
    const int c = wn + nf * 8 + g;
    const float y0 = G::B_NK ? sB[c * G::LDB + kk + t] : sB[(kk + t) * G::LDB + c];
    const float y1 = G::B_NK ? sB[c * G::LDB + kk + t + 4] : sB[(kk + t + 4) * G::LDB + c];
    split_tf32(y0, bh[nf][0], bl[nf][0]);
    split_tf32(y1, bh[nf][1], bl[nf][1]);
  }
  // The tensor cores' accumulate truncates, so the three products of this
  // k-step go into a fresh fragment (small ones first) and reach the running
  // sum through an f32 add, which rounds to nearest.
#pragma unroll
  for (int mf = 0; mf < G::MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < G::NF; ++nf) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(t, al[mf], bh[nf]);
      mma_tf32(t, ah[mf], bl[nf]);
      mma_tf32(t, ah[mf], bh[nf]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc.v[mf][nf][i] += t[i];
    }
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

// gamma^t for t = 0..kTable-1 of head h, once per block.
__device__ __forceinline__ float fill_decays(float* pw, const Params& p, int h) {
  const float lg = logf(p.gamma[h]);
  for (int t = threadIdx.x; t < kTable; t += kThreads) pw[t] = expf((float)t * lg);
  return lg;
}

__device__ __forceinline__ void warp_origin(int warps_n, int tm, int tn, int& wm, int& wn) {
  const int w = threadIdx.x >> 5;
  wm = (w / warps_n) * tm;
  wn = (w % warps_n) * tn;
}

// ---- pass 1: a state block ----------------------------------------------------
__device__ __forceinline__ void state_block(const Params& p, float* pw, float* ring, int blk) {
  using G = StateCfg;
  constexpr int BM = G::BM;
  const int et = blk % p.state_dv_tiles;
  blk /= p.state_dv_tiles;
  const int dt = blk % p.state_dk_tiles, bh = blk / p.state_dk_tiles;
  const int b = bh / p.heads, h = bh % p.heads;
  const float lg = fill_decays(pw, p, h);
  const float chunk_decay = expf((float)p.chunk * lg);
  const int m0 = dt * BM, n0 = et * G::BN;
  const float* kg = p.k + b * p.kb + h * p.kh;
  const float* vg = p.v + b * p.vb + h * p.vh;
  int wm, wn;
  warp_origin(G::WARPS_N, G::TM, G::TN, wm, wn);

  Acc<G> acc;
  const size_t mat = (size_t)p.dk * p.dv;
  const float* s0 = p.state_in ? p.state_in + bh * mat : nullptr;
  for_pairs<G>(acc, wm, wn, [&](int r, int c, float& a0, float& a1) {
    const int d = m0 + r, e = n0 + c;
    float2 x = make_float2(0.f, 0.f);
    if (s0 && d < p.dk && e < p.dv) x = *reinterpret_cast<const float2*>(s0 + (size_t)d * p.dv + e);
    a0 = x.x;
    a1 = x.y;
  });
  auto store = [&](float* dst) {
    for_pairs<G>(acc, wm, wn, [&](int r, int c, float& a0, float& a1) {
      const int d = m0 + r, e = n0 + c;
      if (d < p.dk && e < p.dv)
        *reinterpret_cast<float2*>(dst + (size_t)d * p.dv + e) = make_float2(a0, a1);
    });
  };

  const int per_chunk = (p.chunk + kBK - 1) / kBK;
  auto load = [&](int s, int stage) {
    const long long row0 = (long long)(s / per_chunk) * p.chunk;
    const int j0 = (s % per_chunk) * kBK;
    float* sa = ring + stage * G::STAGE;
    load_tile<kBK, BM>(sa, G::LDA, kg + row0 * p.ks, p.ks, j0, m0, p.chunk, p.dk);
    load_tile<kBK, G::BN>(sa + G::A_SIZE, G::LDB, vg + row0 * p.vs, p.vs, j0, n0, p.chunk, p.dv);
  };
  auto compute = [&](int s, int stage) {
    const int n = s / per_chunk, j0 = (s % per_chunk) * kBK;
    if (j0 == 0) {          // chunk n starts: acc is its incoming state
      if (n > 0) store(p.s + ((size_t)bh * (p.n_chunks - 1) + n - 1) * mat);
#pragma unroll
      for (int mf = 0; mf < G::MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < G::NF; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc.v[mf][nf][i] *= chunk_decay;
    }
    const float* sa = ring + stage * G::STAGE;
    const int kvalid = min(kBK, p.chunk - j0);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8)
      if (kk < kvalid) mma_k8<G, true>(acc, sa, sa + G::A_SIZE, wm, wn, kk, pw, p.chunk - 1 - j0);
  };
  pipeline(p.n_chunks * per_chunk, load, compute);
  store(p.state_out + bh * mat);
}

// ---- pass 1: a score block ----------------------------------------------------
__device__ __forceinline__ void score_block(const Params& p, float* pw, float* ring, int blk) {
  using G = ScoreCfg;
  constexpr int kCols = kTile / G::BN;        // column tiles of a chunk's P
  const int n0 = (blk % kCols) * G::BN;
  blk /= kCols;
  const int n = blk % p.n_chunks, bh = blk / p.n_chunks;
  const int b = bh / p.heads, h = bh % p.heads;
  fill_decays(pw, p, h);
  const long long row0 = (long long)n * p.chunk;
  const float* qg = p.q + b * p.qb + h * p.qh + row0 * p.qs;
  const float* kg = p.k + b * p.kb + h * p.kh + row0 * p.ks;
  int wm, wn;
  warp_origin(G::WARPS_N, G::TM, G::TN, wm, wn);
  // A warp tile wholly above the diagonal (every column past every row) or
  // past the chunk computes nothing: its P is zero.
  const bool idle = n0 + wn >= wm + G::TM || wm >= p.chunk || n0 + wn >= p.chunk;

  Acc<G> acc;
  for_pairs<G>(acc, wm, wn, [](int, int, float& a0, float& a1) { a0 = a1 = 0.f; });
  auto load = [&](int s, int stage) {
    float* sa = ring + stage * G::STAGE;
    load_tile<G::BM, kBK>(sa, G::LDA, qg, p.qs, 0, s * kBK, p.chunk, p.dk);
    load_tile<G::BN, kBK>(sa + G::A_SIZE, G::LDB, kg, p.ks, n0, s * kBK, p.chunk, p.dk);
  };
  auto compute = [&](int s, int stage) {
    if (idle) return;
    const float* sa = ring + stage * G::STAGE;
    const int kvalid = p.dk - s * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8)
      if (kk < kvalid) mma_k8<G, false>(acc, sa, sa + G::A_SIZE, wm, wn, kk, pw, 0);
  };
  pipeline((p.dk + kBK - 1) / kBK, load, compute);

  float* dst = p.p + ((size_t)bh * p.n_chunks + n) * p.chunk * p.ldp;
  for_pairs<G>(acc, wm, wn, [&](int i, int c, float& a0, float& a1) {
    const int j = n0 + c;
    if (i < p.chunk && j < p.ldp) {
      const float x0 = j <= i ? a0 * pw[i - j] : 0.f;
      const float x1 = j + 1 <= i ? a1 * pw[i - j - 1] : 0.f;
      *reinterpret_cast<float2*>(dst + (size_t)i * p.ldp + j) = make_float2(x0, x1);
    }
  });
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) retention_pass1(const Params p) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < p.state_blocks)
    state_block(p, smem, smem + kTable, blockIdx.x);
  else
    score_block(p, smem, smem + kTable, blockIdx.x - p.state_blocks);
}

// ---- pass 2: an output block ----------------------------------------------------
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) retention_pass2(const Params p) {
  using G = OutCfg;
  extern __shared__ __align__(16) float smem[];
  float* pw = smem;
  float* ring = smem + kTable;
  int blk = blockIdx.x;
  const int et = blk % p.out_dv_tiles;
  blk /= p.out_dv_tiles;
  const int bh = blk % p.bh;
  const int n = p.n_chunks - 1 - blk / p.bh;     // chunks with a state first
  const int b = bh / p.heads, h = bh % p.heads;
  fill_decays(pw, p, h);
  const long long row0 = (long long)n * p.chunk;
  const int n0 = et * G::BN;
  const float* qg = p.q + b * p.qb + h * p.qh + row0 * p.qs;
  const float* vg = p.v + b * p.vb + h * p.vh + row0 * p.vs;
  const size_t mat = (size_t)p.dk * p.dv;
  const float* sg = n > 0 ? p.s + ((size_t)bh * (p.n_chunks - 1) + n - 1) * mat
                          : (p.state_in ? p.state_in + bh * mat : nullptr);
  const float* pg = p.p + ((size_t)bh * p.n_chunks + n) * p.chunk * p.ldp;
  const int nk1 = sg ? (p.dk + kBK - 1) / kBK : 0;       // cross-term slices
  const int nk2 = (p.chunk + kBK - 1) / kBK;             // P V slices
  int wm, wn;
  warp_origin(G::WARPS_N, G::TM, G::TN, wm, wn);

  Acc<G> acc;
  for_pairs<G>(acc, wm, wn, [](int, int, float& a0, float& a1) { a0 = a1 = 0.f; });
  auto load = [&](int s, int stage) {
    float* sa = ring + stage * G::STAGE;
    float* sb = sa + G::A_SIZE;
    if (s < nk1) {
      load_tile<G::BM, kBK>(sa, G::LDA, qg, p.qs, 0, s * kBK, p.chunk, p.dk);
      load_tile<kBK, G::BN>(sb, G::LDB, sg, p.dv, s * kBK, n0, p.dk, p.dv);
    } else {
      const int j0 = (s - nk1) * kBK;
      load_tile<G::BM, kBK>(sa, G::LDA, pg, p.ldp, 0, j0, p.chunk, p.ldp);
      load_tile<kBK, G::BN>(sb, G::LDB, vg, p.vs, j0, n0, p.chunk, p.dv);
    }
  };
  auto compute = [&](int s, int stage) {
    if (wm >= p.chunk) return;        // rows past the chunk
    if (s == nk1 && nk1 > 0)          // cross term done: scale row i by gamma^(i+1)
      for_pairs<G>(acc, wm, wn, [&](int i, int, float& a0, float& a1) {
        const float w = pw[i + 1];
        a0 *= w;
        a1 *= w;
      });
    const float* sa = ring + stage * G::STAGE;
    int kvalid;
    if (s < nk1) {
      kvalid = p.dk - s * kBK;
    } else {                          // P[i, j] = 0 for j > i: stop at the warp's last row
      const int j0 = (s - nk1) * kBK;
      kvalid = min(wm + G::TM, p.chunk) - j0;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8)
      if (kk < kvalid) mma_k8<G, false>(acc, sa, sa + G::A_SIZE, wm, wn, kk, pw, 0);
  };
  pipeline(nk1 + nk2, load, compute);

  float* yg = p.y + b * p.yb + h * p.yh + row0 * p.ys;
  for_pairs<G>(acc, wm, wn, [&](int i, int c, float& a0, float& a1) {
    const int e = n0 + c;
    if (i < p.chunk && e < p.dv)
      *reinterpret_cast<float2*>(yg + (long long)i * p.ys + e) = make_float2(a0, a1);
  });
}

template <class K>
cudaError_t allow_smem(K kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

}  // namespace

// dims (int64): B, H, S, dk, dv, chunk, ldp (row stride of the score
// scratch), then the element strides of q, k, v and y over (B, H, S).
extern "C" int retention_chunkwise_launch(const void* q, const void* k, const void* v,
                                          const void* gamma, const void* state_in, void* y,
                                          void* state_out, void* p_scratch,
                                          void* s_scratch, const long long* dims,
                                          void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(retention_pass1, kPass1Smem);
    if (err == cudaSuccess) err = allow_smem(retention_pass2, OutCfg::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  Params p;
  p.q = (const float*)q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.gamma = (const float*)gamma;
  p.state_in = (const float*)state_in;
  p.y = (float*)y;
  p.state_out = (float*)state_out;
  p.p = (float*)p_scratch;
  p.s = (float*)s_scratch;
  const int batch = (int)dims[0], seq = (int)dims[2];
  p.heads = (int)dims[1];
  p.dk = (int)dims[3];
  p.dv = (int)dims[4];
  p.chunk = (int)dims[5];
  p.ldp = (int)dims[6];
  p.qb = dims[7], p.qh = dims[8], p.qs = dims[9];
  p.kb = dims[10], p.kh = dims[11], p.ks = dims[12];
  p.vb = dims[13], p.vh = dims[14], p.vs = dims[15];
  p.yb = dims[16], p.yh = dims[17], p.ys = dims[18];
  if (p.chunk < 1 || p.chunk > kMaxChunk || seq % p.chunk || p.dk % 4 || p.dv % 4 ||
      p.dk > kMaxDk || p.ldp % 4 || p.ldp < p.chunk)
    return (int)cudaErrorInvalidValue;
  p.bh = batch * p.heads;
  p.n_chunks = seq / p.chunk;
  p.state_dk_tiles = (p.dk + StateCfg::BM - 1) / StateCfg::BM;
  p.state_dv_tiles = (p.dv + StateCfg::BN - 1) / StateCfg::BN;
  p.out_dv_tiles = (p.dv + OutCfg::BN - 1) / OutCfg::BN;
  p.state_blocks = p.bh * p.state_dk_tiles * p.state_dv_tiles;
  constexpr int kScoreTiles = kTile / ScoreCfg::BN;
  const cudaStream_t st = (cudaStream_t)stream;
  retention_pass1<<<p.state_blocks + p.bh * p.n_chunks * kScoreTiles, kThreads,
                    kPass1Smem * sizeof(float), st>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  retention_pass2<<<p.bh * p.n_chunks * p.out_dv_tiles, kThreads,
                    OutCfg::SMEM * sizeof(float), st>>>(p);
  return (int)cudaGetLastError();
}
