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
// and the initial state's cotangent dS_0 (when asked for).  Three launches
// (one wrapper call, one count in hopper.LAUNCHES["retention_chunkwise_bwd"]):
//
//   states:  blocks (direction, bh, 64 rows of dk, 64 columns of dv) walk the
//            chunks in order, recomputing the incoming states S_j into a
//            scratch, or in reverse, writing dS_{j+1} and finally dS_0;
//   scores:  blocks (kind, bh, chunk, 64 x 64 tile on or below the diagonal)
//            compute P = (Q K^T) .* D and dP = (dY V^T) .* D into scratch;
//   grads:   blocks (bh, chunk, a 64 x 64 tile of dQ, dK or dV) sum the
//            state term first, scale its rows, then add the intra-chunk term,
//            stopping the causal contraction at the tile's diagonal.
//
// What bounds it on the H100: operations.  At retnet-1.3b's training shape
// (B 2, H 8, S 512, dk 256, dv 512, c 128, zero initial state, no final-state
// cotangent) the gradient needs 9.95 GFLOP against 83.9 MB of inputs and
// outputs: 0.149 ms of f32 FMAs at 67 TFLOP/s, 25 us of bytes at 3.35 TB/s.
// This first design is plain f32 FMAs on the CUDA cores (no tensor cores, no
// TMA): every block is 256 threads on a 64 x 64 output tile, 4 x 4 outputs a
// thread, streaming 16-deep slices of its two operands through shared
// memory.  Every output element is summed by one thread in one fixed order:
// no atomics, so relaunches are bit-equal.  dQ's sum over all of dv runs in
// one block.
// Scratch (allocated by the caller, sized by hopper.retention_bwd_plan): the
// incoming states and the outgoing states' cotangents, 2 * BH * N * dk * dv
// floats, and P and dP, 2 * BH * N * c * ldp floats (67.1 + 8.4 MB at the
// shape above).  q, k, v and dY are read through their (B, H, S) strides
// (unit stride in the last dim); dQ, dK and dV are written through their own.
// Limits: chunk <= 128; dk, dv multiples of 4; ldp a multiple of 4 >= chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;                  // output tile rows and columns
constexpr int kBK = 16;                 // contraction slice
constexpr int kLd = kT + 4;             // shared row stride (16-byte rows)
constexpr int kMaxChunk = 128;
constexpr int kTable = kMaxChunk + 4;   // gamma^t, t = 0..128

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
  float* s_in;             // [BH, N, dk, dv] incoming states S_j
  float* ds;               // [BH, N, dk, dv] cotangents dS_{j+1} of the outgoing states
  float* p;                // [BH, N, c, ldp] (Q K^T) .* D
  float* dp;               // [BH, N, c, ldp] (dY V^T) .* D
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, gb, gh, gs;
  long long dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
  int bh, heads, dk_, dv_, chunk, n_chunks, ldp;
  int dk_t, dv_t, c_t;     // 64-wide tiles of dk, dv and the chunk
};

struct Smem {
  float a[kBK * kLd];
  float b[kBK * kLd];
  float pw[kTable];        // gamma^t
  float sc[kMaxChunk];     // a per-position factor of the state pass
};

// gamma^t for t = 0..kTable-1 of head h, as the forward builds it.
__device__ __forceinline__ float fill_decays(float* pw, const Params& p, int h) {
  const float lg = logf(p.gamma[h]);
  for (int t = threadIdx.x; t < kTable; t += kThreads) pw[t] = expf((float)t * lg);
  return lg;
}

// acc += A[m0 + 0..63, k] . B[k, n0 + 0..63] over k in [k_lo, k_hi), each
// thread its 4 x 4 outputs (rows 4 ty.., columns 4 tx..).  A(m, k) is
// a[k * lda + m] when A_T, else a[m * lda + k]; B(k, n) is b[n * ldb + k]
// when B_T, else b[k * ldb + n].  Rows m >= m_ok and columns n >= n_ok read
// zero.  ksc (shared, or null) scales A's column k by ksc[k].
template <bool A_T, bool B_T>
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], Smem& sm, const float* a,
                                         long long lda, const float* b, long long ldb,
                                         int m0, int m_ok, int n0, int n_ok, int k_lo,
                                         int k_hi, const float* ksc) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kT * kBK / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int m = A_T ? idx % kT : idx / kBK, kk = A_T ? idx / kT : idx % kBK;
      const int gm = m0 + m, gk = k0 + kk;
      float x = 0.f;
      if (gm < m_ok && gk < k_hi) {
        x = A_T ? a[(long long)gk * lda + gm] : a[(long long)gm * lda + gk];
        if (ksc) x *= ksc[gk];
      }
      sm.a[kk * kLd + m] = x;
      const int n = B_T ? idx / kBK : idx % kT, kb = B_T ? idx % kBK : idx / kT;
      const int gn = n0 + n, gkb = k0 + kb;
      float y = 0.f;
      if (gn < n_ok && gkb < k_hi)
        y = B_T ? b[(long long)gn * ldb + gkb] : b[(long long)gkb * ldb + gn];
      sm.b[kb * kLd + n] = y;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[kk * kLd + 4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[kk * kLd + 4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc[i][*] *= rs[r] for the tile's local row r = 4 ty + i; rows at or past
// m_ok (past the chunk) are zeroed.
__device__ __forceinline__ void scale_rows(float (&acc)[4][4], const float* rs, int m_ok) {
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const float w = r < m_ok ? rs[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= w;
  }
}

// The tile's outputs into dst[row * ld + col] (rows < m_ok, columns < n_ok;
// n_ok and ld multiples of 4, dst 16-byte aligned: whole float4 stores).
__device__ __forceinline__ void store4(const float (&acc)[4][4], float* dst, long long ld,
                                      int m0, int m_ok, int n0, int n_ok) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int c = n0 + 4 * tx;
  if (c >= n_ok) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
    if (r < m_ok)
      *reinterpret_cast<float4*>(dst + (long long)r * ld + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

__device__ __forceinline__ void load4(float (&acc)[4][4], const float* src, long long ld,
                                      int m0, int m_ok, int n0, int n_ok) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int c = n0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src && r < m_ok && c < n_ok)
      x = *reinterpret_cast<const float4*>(src + (long long)r * ld + c);
    acc[i][0] = x.x;
    acc[i][1] = x.y;
    acc[i][2] = x.z;
    acc[i][3] = x.w;
  }
}

// ---- launch 1: the states, forward and reverse ------------------------------------
__global__ void __launch_bounds__(kThreads) retention_bwd_states(const Params p) {
  __shared__ __align__(16) Smem sm;
  int blk = blockIdx.x;
  const int et = blk % p.dv_t;
  blk /= p.dv_t;
  const int dt = blk % p.dk_t;
  blk /= p.dk_t;
  const int bh = blk % p.bh;
  const bool rev = blk / p.bh;
  const int b = bh / p.heads, h = bh % p.heads, c = p.chunk, n = p.n_chunks;
  const float lg = fill_decays(sm.pw, p, h);
  const float chunk_decay = expf((float)c * lg);
  __syncthreads();
  // Forward: K's row t scaled by gamma^(c-1-t); reverse: Q's by gamma^(t+1).
  for (int t = threadIdx.x; t < c; t += kThreads) sm.sc[t] = rev ? sm.pw[t + 1] : sm.pw[c - 1 - t];
  __syncthreads();
  const int m0 = dt * kT, n0 = et * kT;
  const size_t mat = (size_t)p.dk_ * p.dv_;
  float acc[4][4];
  load4(acc, rev ? (p.dstate ? p.dstate + bh * mat : nullptr)
                 : (p.state_in ? p.state_in + bh * mat : nullptr),
        p.dv_, m0, p.dk_, n0, p.dv_);
  const float* xa = rev ? p.q + b * p.qb + h * p.qh : p.k + b * p.kb + h * p.kh;
  const long long lda = rev ? p.qs : p.ks;
  const float* xb = rev ? p.dy + b * p.gb + h * p.gh : p.v + b * p.vb + h * p.vh;
  const long long ldb = rev ? p.gs : p.vs;
  for (int step = 0; step < n; ++step) {
    const int j = rev ? n - 1 - step : step;
    store4(acc, (rev ? p.ds : p.s_in) + ((size_t)bh * n + j) * mat, p.dv_, m0, p.dk_, n0, p.dv_);
    if (!rev && j == n - 1) return;            // the final state is not needed
    if (rev && j == 0 && !p.dstate0) return;   // nor dS_0 unless asked for
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= chunk_decay;
    const long long row0 = (long long)j * c;
    tile_mma<true, false>(acc, sm, xa + row0 * lda, lda, xb + row0 * ldb, ldb, m0, p.dk_, n0,
                          p.dv_, 0, c, sm.sc);
  }
  store4(acc, p.dstate0 + bh * mat, p.dv_, m0, p.dk_, n0, p.dv_);
}

// ---- launch 2: P and dP ------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) retention_bwd_scores(const Params p) {
  __shared__ __align__(16) Smem sm;
  int blk = blockIdx.x;
  const int ct = blk % p.c_t;
  blk /= p.c_t;
  const int rt = blk % p.c_t;
  blk /= p.c_t;
  const int j = blk % p.n_chunks;
  blk /= p.n_chunks;
  const int bh = blk % p.bh;
  const bool grad = blk / p.bh;                // dP = (dY V^T) .* D, else P = (Q K^T) .* D
  if (ct > rt) return;                          // above the diagonal: zero, never read
  const int b = bh / p.heads, h = bh % p.heads, c = p.chunk;
  fill_decays(sm.pw, p, h);
  const long long row0 = (long long)j * c;
  const float* xa = grad ? p.dy + b * p.gb + h * p.gh + row0 * p.gs
                         : p.q + b * p.qb + h * p.qh + row0 * p.qs;
  const float* xb = grad ? p.v + b * p.vb + h * p.vh + row0 * p.vs
                         : p.k + b * p.kb + h * p.kh + row0 * p.ks;
  float acc[4][4];
  zero(acc);
  tile_mma<false, true>(acc, sm, xa, grad ? p.gs : p.qs, xb, grad ? p.vs : p.ks, rt * kT, c,
                        ct * kT, c, 0, grad ? p.dv_ : p.dk_, nullptr);
  float* dst = (grad ? p.dp : p.p) + ((size_t)bh * p.n_chunks + j) * c * p.ldp;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rt * kT + 4 * ty + i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = ct * kT + 4 * tx + e;
      if (r < c && t < c) dst[(size_t)r * p.ldp + t] = t <= r ? acc[i][e] * sm.pw[r - t] : 0.f;
    }
  }
}

// ---- launch 3: dQ, dK and dV -------------------------------------------------------
__global__ void __launch_bounds__(kThreads) retention_bwd_grads(const Params p) {
  __shared__ __align__(16) Smem sm;
  const int per_q = p.c_t * p.dk_t, per_v = p.c_t * p.dv_t;
  int blk = blockIdx.x;
  const int tile = blk % (2 * per_q + per_v);
  blk /= 2 * per_q + per_v;
  const int j = blk % p.n_chunks, bh = blk / p.n_chunks;
  const int b = bh / p.heads, h = bh % p.heads, c = p.chunk, n = p.n_chunks;
  const float lg = fill_decays(sm.pw, p, h);
  (void)lg;
  __syncthreads();
  const int kind = tile < per_q ? 0 : tile < 2 * per_q ? 1 : 2;   // dQ, dK, dV
  const int rest = kind == 0 ? tile : kind == 1 ? tile - per_q : tile - 2 * per_q;
  const int cols_t = kind == 2 ? p.dv_t : p.dk_t;
  const int rt = rest / cols_t, m0 = rt * kT, n0 = (rest % cols_t) * kT;
  const int n_ok = kind == 2 ? p.dv_ : p.dk_;
  const long long row0 = (long long)j * c;
  const size_t mat = (size_t)p.dk_ * p.dv_;
  const float* q = p.q + b * p.qb + h * p.qh + row0 * p.qs;
  const float* k = p.k + b * p.kb + h * p.kh + row0 * p.ks;
  const float* v = p.v + b * p.vb + h * p.vh + row0 * p.vs;
  const float* dy = p.dy + b * p.gb + h * p.gh + row0 * p.gs;
  const size_t sc_off = ((size_t)bh * n + j) * c * p.ldp;
  // Per-row factors of the state term: gamma^(i+1) (dQ), gamma^(c-1-t) (dK, dV).
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    const int t = m0 + r;
    sm.sc[r] = t < c ? (kind == 0 ? sm.pw[t + 1] : sm.pw[c - 1 - t]) : 0.f;
  }
  __syncthreads();
  float acc[4][4];
  zero(acc);
  float* out;
  long long ld;
  if (kind == 0) {
    if (j > 0 || p.state_in) {   // Lambda dY S_j^T
      const float* s = p.s_in + ((size_t)bh * n + j) * mat;
      tile_mma<false, true>(acc, sm, dy, p.gs, s, p.dv_, m0, c, n0, p.dk_, 0, p.dv_, nullptr);
      scale_rows(acc, sm.sc, c - m0);
    }
    tile_mma<false, false>(acc, sm, p.dp + sc_off, p.ldp, k, p.ks, m0, c, n0, p.dk_, 0,
                           min(c, m0 + kT), nullptr);
    out = p.dq + b * p.dqb + h * p.dqh + row0 * p.dqs;
    ld = p.dqs;
  } else {
    const float* ds = p.ds + ((size_t)bh * n + j) * mat;
    const bool has_ds = j < n - 1 || p.dstate;
    if (kind == 1) {
      if (has_ds) {   // Gamma V dS_{j+1}^T
        tile_mma<false, true>(acc, sm, v, p.vs, ds, p.dv_, m0, c, n0, p.dk_, 0, p.dv_, nullptr);
        scale_rows(acc, sm.sc, c - m0);
      }
      tile_mma<true, false>(acc, sm, p.dp + sc_off, p.ldp, q, p.qs, m0, c, n0, p.dk_, m0, c,
                            nullptr);
      out = p.dk + b * p.dkb + h * p.dkh + row0 * p.dks;
      ld = p.dks;
    } else {
      if (has_ds) {   // Gamma K dS_{j+1}
        tile_mma<false, false>(acc, sm, k, p.ks, ds, p.dv_, m0, c, n0, p.dv_, 0, p.dk_, nullptr);
        scale_rows(acc, sm.sc, c - m0);
      }
      tile_mma<true, false>(acc, sm, p.p + sc_off, p.ldp, dy, p.gs, m0, c, n0, p.dv_, m0, c,
                            nullptr);
      out = p.dv + b * p.dvb + h * p.dvh + row0 * p.dvs;
      ld = p.dvs;
    }
  }
  store4(acc, out, ld, m0, c, n0, n_ok);
}

int tiles(int x) { return (x + kT - 1) / kT; }

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
  p.dk_t = tiles(p.dk_);
  p.dv_t = tiles(p.dv_);
  p.c_t = tiles(p.chunk);
  const cudaStream_t s = (cudaStream_t)stream;
  retention_bwd_states<<<2 * p.bh * p.dk_t * p.dv_t, kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  retention_bwd_scores<<<2 * p.bh * p.n_chunks * p.c_t * p.c_t, kThreads, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  retention_bwd_grads<<<p.bh * p.n_chunks * (2 * p.c_t * p.dk_t + p.c_t * p.dv_t), kThreads,
                        0, s>>>(p);
  return (int)cudaGetLastError();
}
