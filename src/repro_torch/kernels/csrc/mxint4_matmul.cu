// MXINT4 dequant-fused GEMV for Hopper (sm_90a): the HSA decode (MVM) path.
//
// Replaces the Pallas TPU kernel `mxint4_matmul_pallas`
// (src/repro/kernels/mxint4_matmul.py).  Computes
//
//     y[M, N] = (x[M, K] @ W) * out_scale[N] * row_scale[M] + bias[N]
//
// with W[K, N] streamed as int8 `packed[K, N/2]` (two int4 mantissas per byte,
// low nibble = even column) and uint8 `exps[K, N/32]` (one 4-bit code per 16
// columns, two codes per byte, low nibble = even group): w = m * 2^(code - 11).
//
// What bounds it on the H100: bytes.  At decode M = 2 each weight byte feeds
// four multiply-adds, far below the ~600 operations per byte where compute
// would become the limit, so the floor is 4.25 bits per weight over
// 3.35 TB/s.  The design streams W at that rate:
//   * a block covers 256 columns and TM rows of x (TM = 1, 2, 4 or 8, chosen
//     by the wrapper, so no FMA runs on a padding row of the decode batch);
//     each thread owns C consecutive columns (32 for TM <= 2, 16 for TM = 4,
//     8 for TM = 8) and loads their mantissas of one K row in one vector
//     load (16 bytes at C = 32);
//   * each thread keeps 32 bytes of weights per batch (two rows at C = 32)
//     and issues the next batch's loads before it computes this one.  The
//     loop is bound by instruction issue more than by loads in flight:
//     64-byte batches, and a 4-stage cp.async ring in shared memory, both
//     measured slower on the H100;
//   * a weight becomes a float with no int -> float convert: the nibbles of
//     a word are split into even and odd columns with their sign bit
//     flipped (`lop3`: u = m + 8), each byte is placed in the mantissa of
//     2^23 (`prmt`), and one subtract of 2^23 + 8 leaves m exactly.  The
//     group's power-of-two scale is folded into x once per (row, k, group):
//     products of x with exact powers of two are exact, so (x * 2^s) * m
//     equals the reference's x * (m * 2^s);
//   * x rows come through the read-only cache (M * K * 4 bytes, L1/L2
//     resident); accumulation is f32 FMA on the CUDA cores (Hopper's
//     tensor cores have no int4 product);
//   * K splits across blocks (grid.y) in runs the wrapper sizes by weight
//     bytes per block.  Each split writes its partial sums to a workspace;
//     the last block of a column tile to finish (an atomic ticket) adds the
//     partials in split order and applies the Eq. (4) epilogue in the
//     reference's order (acc * out_scale, * row_scale, + bias), so a
//     relaunch is bit-equal.  (Reducing a tile's splits inside a thread
//     block cluster instead measured slower on the H100: PERF.md.)
// Within a block the K rows held by different threads are summed in a fixed
// order (warp shuffles, then shared memory by warp).  Ragged N (a multiple of
// 32) and M are masked.  The kernel allocates nothing; the wrapper passes the
// workspace and the ticket counters (zero on entry, reset by the last block).
//
// Beside it, `mxint4_expert_matmul_launch`: the routed-MoE decode product
//
//     y[a, :] = x[a, :] @ W[expert_ids[a]]        (a < A, no epilogue)
//
// over stacked experts packed[E, K, N/2], exps[E, K, N/32].  It replaces no
// TPU kernel: the reference dequantizes every expert stack to f32 on every
// call and runs an einsum (src/repro/models/mlp.py `_expert_weight`,
// `_expert_ffn`).  Bound by bytes: a decode step's A = B * top_k rows read
// only the addressed experts' 4.25-bit weights.  The ids are read in device
// memory, so the launch does not depend on the routing and captures into a
// CUDA graph.  The design is the simple one: a block covers 64 columns of
// one row a; its 32 row groups of threads walk K in strides of 32 rows,
// each thread one 32-bit word (8 columns) per K row, four rows' loads in
// flight before their FMAs; the 32 partial sums of a column are added in
// row-group order through shared memory, so a relaunch is bit-equal.  Two
// rows routed to one expert both stream it; the weight loads are cached
// ones (`__ldg`, not the GEMV's evict-first `__ldcs`), so that the second
// can find it in L2.
// It shares the nibble decode and the scale of the GEMV above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 256;
constexpr int kBatchBytes = 32;          // weight bytes per thread per batch

template <int C> struct Row;             // one K row of C columns: C/2 bytes
template <> struct Row<32> { uint4 v; };
template <> struct Row<16> { uint2 v; };
template <> struct Row<8> { uint32_t v; };

template <int C>
__device__ __forceinline__ Row<C> load_row(const uint8_t* p) {
  Row<C> r;
  if constexpr (C == 32) r.v = __ldcs(reinterpret_cast<const uint4*>(p));
  else if constexpr (C == 16) r.v = __ldcs(reinterpret_cast<const uint2*>(p));
  else r.v = __ldcs(reinterpret_cast<const unsigned int*>(p));
  return r;
}

template <int C>
__device__ __forceinline__ Row<C> zero_row() {
  Row<C> r;
  uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < C / 8; ++i) w[i] = 0u;             // all mantissas 0
  return r;
}

// The 8 mantissas of one 32-bit word of packed nibbles (low nibble = even
// column), exactly, with no int -> float convert: the nibbles are split into
// even and odd columns with their sign bit flipped (u = m + 8), each byte is
// placed in the mantissa of 2^23 (`prmt`), and one subtract of 2^23 + 8
// leaves m.  m[2j] is column 2j of the word, m[2j + 1] column 2j + 1.
__device__ __forceinline__ void mx_mantissas(uint32_t word, float (&m)[8]) {
  const uint32_t even = (word ^ 0x88888888u) & 0x0F0F0F0Fu;
  const uint32_t odd = ((word >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // 0x4B0000uu: byte j in the mantissa of 2^23, minus 2^23 + 8.
    m[2 * j] = __int_as_float(__byte_perm(even, 0x4B000000u, 0x7540 + j)) - 8388616.f;
    m[2 * j + 1] = __int_as_float(__byte_perm(odd, 0x4B000000u, 0x7540 + j)) - 8388616.f;
  }
}

// A group's scale 2^(code - 11) from its 4-bit shift code.
__device__ __forceinline__ float mx_scale(uint32_t code) {
  return __int_as_float((int)((code & 0xFu) + 116u) << 23);
}

template <int TM, int C>
__global__ void __launch_bounds__(kThreads)
mxint4_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                   const uint8_t* __restrict__ exps,
                   const float* __restrict__ out_scale,
                   const float* __restrict__ row_scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   float* __restrict__ partials, int* __restrict__ tickets,
                   int M, int N, int K, int k_per_split) {
  constexpr int TX = kTileN / C;         // threads across the columns
  constexpr int TY = kThreads / TX;      // K rows side by side (== C)
  constexpr int U = kBatchBytes / (C / 2);   // rows per thread per batch
  constexpr int W = C / 8;               // 32-bit words per row
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float red[];         // [kWarps][TM][kTileN]
  __shared__ int is_last;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kTileN + tx * C;
  const int m0 = blockIdx.z * TM;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int k_beg = split * k_per_split;
  const int k_end = min(K, k_beg + k_per_split);
  const bool col_ok = n0 < N;
  const size_t row_bytes = (size_t)N / 2;
  const int exp_row = N / 32, exp_col = n0 / 32;
  const int exp_shift = C == 32 ? 0 : 4 * ((n0 / 16) & 1);

  float acc[TM][C];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[m][c] = 0.f;

  // This thread's rows of a batch at kb are kb + u * TY + ty, u < U.
  const uint8_t* wp = packed + (size_t)ty * row_bytes + n0 / 2;
  const uint8_t* ep = exps + (size_t)ty * exp_row + exp_col;
  const float* xp[TM];
  bool m_ok[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    m_ok[m] = m0 + m < M;
    xp[m] = x + (size_t)(m_ok[m] ? m0 + m : 0) * K + ty;
  }

  auto load = [&](Row<C>(&w)[U], uint32_t(&e)[U], int kb) {
    if (col_ok && kb + TY * U <= k_end) {     // a whole batch: no row masks
#pragma unroll
      for (int u = 0; u < U; ++u) {
        w[u] = load_row<C>(wp + (size_t)(kb + u * TY) * row_bytes);
        e[u] = ep[(size_t)(kb + u * TY) * exp_row];
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kb + u * TY + ty;
        const bool ok = col_ok && k < k_end;
        w[u] = ok ? load_row<C>(wp + (size_t)(kb + u * TY) * row_bytes) : zero_row<C>();
        e[u] = ok ? ep[(size_t)(kb + u * TY) * exp_row] : 0u;
      }
    }
  };
  auto compute = [&](const Row<C>(&w)[U], const uint32_t(&e)[U], int kb) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float xv[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m)
        xv[m] = (m_ok[m] && kb + u * TY + ty < k_end) ? __ldg(xp[m] + kb + u * TY) : 0.f;
      const uint32_t code = e[u] >> exp_shift;
      const uint32_t* words = reinterpret_cast<const uint32_t*>(&w[u]);
#pragma unroll
      for (int g = 0; g < (C + 15) / 16; ++g) {
        const float se = mx_scale(code >> (4 * g));   // 2^(code - 11)
        float xe[TM];
#pragma unroll
        for (int m = 0; m < TM; ++m) xe[m] = xv[m] * se;
#pragma unroll
        for (int i = g * 2; i < min(W, g * 2 + 2); ++i) {
          float wm[8];
          mx_mantissas(words[i], wm);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
#pragma unroll
            for (int m = 0; m < TM; ++m)
              acc[m][8 * i + c] = fmaf(xe[m], wm[c], acc[m][8 * i + c]);
          }
        }
      }
    }
  };

  // Two register buffers in turn: the next batch's loads are in flight
  // while this one is computed.
  constexpr int kStep = TY * U;
  Row<C> wa[U], wb[U];
  uint32_t ea[U], eb[U];
  load(wa, ea, k_beg);
  for (int kb = k_beg; kb < k_end; kb += 2 * kStep) {
    if (kb + kStep < k_end) load(wb, eb, kb + kStep);
    compute(wa, ea, kb);
    if (kb + kStep >= k_end) break;
    if (kb + 2 * kStep < k_end) load(wa, ea, kb + 2 * kStep);
    compute(wb, eb, kb + kStep);
  }

  // Sum the block's K rows in a fixed order: the rows of one warp by
  // shuffles, then the warps through shared memory in warp order.
#pragma unroll
  for (int off = TX; off < 32; off *= 2)
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
  if (lane < TX) {
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < C; ++c) red[(warp * TM + m) * kTileN + tx * C + c] = acc[m][c];
  }
  __syncthreads();

  float sums[TM];
#pragma unroll
  for (int e = 0; e < TM; ++e) {
    const int idx = tid + e * kThreads;      // covers TM * kTileN
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) s += red[r * TM * kTileN + idx];
    sums[e] = s;
  }

  if (n_splits > 1) {
#pragma unroll
    for (int e = 0; e < TM; ++e) {
      const int idx = tid + e * kThreads;
      const int m = m0 + idx / kTileN, n = blockIdx.x * kTileN + idx % kTileN;
      if (m < M && n < N) partials[((size_t)split * M + m) * N + n] = sums[e];
    }
    __threadfence();
    __syncthreads();
    const int tile = blockIdx.z * gridDim.x + blockIdx.x;
    if (tid == 0) is_last = (atomicAdd(&tickets[tile], 1) == n_splits - 1);
    __syncthreads();
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int e = 0; e < TM; ++e) {
      const int idx = tid + e * kThreads;
      const int m = m0 + idx / kTileN, n = blockIdx.x * kTileN + idx % kTileN;
      float s = 0.f;
      if (m < M && n < N) {
        // In split order; eight loads in flight at a time.
        const float* p = partials + (size_t)m * N + n;
        const size_t stride = (size_t)M * N;
        int sp = 0;
        for (; sp + 8 <= n_splits; sp += 8) {
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __ldcg(p + (sp + j) * stride);
#pragma unroll
          for (int j = 0; j < 8; ++j) s += v[j];
        }
        for (; sp < n_splits; ++sp) s += __ldcg(p + sp * stride);
      }
      sums[e] = s;
    }
    if (tid == 0) tickets[tile] = 0;
  }

#pragma unroll
  for (int e = 0; e < TM; ++e) {
    const int idx = tid + e * kThreads;
    const int m = m0 + idx / kTileN, n = blockIdx.x * kTileN + idx % kTileN;
    if (m < M && n < N) {
      float y = __fmul_rn(sums[e], out_scale[n]);
      y = __fmul_rn(y, row_scale[m]);
      out[(size_t)m * N + n] = __fadd_rn(y, bias[n]);
    }
  }
}

template <int TM, int C>
int launch(const void* x, const void* packed, const void* exps, const void* out_scale,
           const void* row_scale, const void* bias, void* out, void* partials,
           void* tickets, int M, int N, int K, int n_splits, int k_per_split,
           cudaStream_t stream) {
  const int smem = kThreads / 32 * TM * kTileN * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(mxint4_gemv_kernel<TM, C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((N + kTileN - 1) / kTileN, n_splits, (M + TM - 1) / TM);
  mxint4_gemv_kernel<TM, C><<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const uint8_t*)packed, (const uint8_t*)exps,
      (const float*)out_scale, (const float*)row_scale, (const float*)bias, (float*)out,
      (float*)partials, (int*)tickets, M, N, K, k_per_split);
  return (int)cudaGetLastError();
}

// The routed expert GEMV (see the head of this file).  A block is 256
// threads: kExpertTX across 64 columns (8 each), kExpertTY row groups.
constexpr int kExpertTX = 8;
constexpr int kExpertTY = kThreads / kExpertTX;
constexpr int kExpertTileN = 8 * kExpertTX;
constexpr int kExpertUnroll = 4;

__global__ void __launch_bounds__(kThreads)
mxint4_expert_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                     const uint8_t* __restrict__ exps,
                     const long long* __restrict__ expert_ids, float* __restrict__ out,
                     int N, int K, int E) {
  __shared__ float red[kExpertTY][kExpertTileN];
  const int tid = threadIdx.x, tx = tid % kExpertTX, ty = tid / kExpertTX;
  const int a = blockIdx.y;
  const int n0 = blockIdx.x * kExpertTileN + tx * 8;
  const long long e = expert_ids[a];
  if (e < 0 || e >= E) {                 // a bad id: the row reads as NaN
    if (ty == 0 && n0 < N)
      for (int c = 0; c < 8; ++c) out[(size_t)a * N + n0 + c] = __int_as_float(0x7fc00000);
    return;
  }
  const bool col_ok = n0 < N;
  const size_t row_bytes = (size_t)N / 2, exp_row = (size_t)N / 32;
  const uint8_t* wp = packed + (size_t)e * K * row_bytes + n0 / 2;
  const uint8_t* ep = exps + (size_t)e * K * exp_row + n0 / 32;
  const int shift = 4 * ((n0 / 16) & 1);
  const float* xa = x + (size_t)a * K;

  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  if (col_ok) {
    for (int k0 = ty; k0 < K; k0 += kExpertTY * kExpertUnroll) {
      uint32_t w[kExpertUnroll], code[kExpertUnroll];
      float xv[kExpertUnroll];
#pragma unroll
      for (int u = 0; u < kExpertUnroll; ++u) {
        const int k = k0 + u * kExpertTY;
        const bool ok = k < K;
        w[u] = ok ? __ldg(reinterpret_cast<const unsigned int*>(wp + (size_t)k * row_bytes))
                  : 0u;                   // mantissas 0
        code[u] = ok ? (uint32_t)(ep[(size_t)k * exp_row] >> shift) : 0u;
        xv[u] = ok ? __ldg(xa + k) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kExpertUnroll; ++u) {
        const float xe = xv[u] * mx_scale(code[u]);
        float wm[8];
        mx_mantissas(w[u], wm);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] = fmaf(xe, wm[c], acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) red[ty][tx * 8 + c] = acc[c];
  __syncthreads();
  if (tid < kExpertTileN) {
    const int n = blockIdx.x * kExpertTileN + tid;
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < kExpertTY; ++r) s += red[r][tid];
    if (n < N) out[(size_t)a * N + n] = s;
  }
}

}  // namespace

// y[A, N] = row a of x[A, K] times expert expert_ids[a] of the stacks.
extern "C" int mxint4_expert_matmul_launch(const void* x, const void* packed,
                                           const void* exps, const void* expert_ids,
                                           void* out, int A, int N, int K, int E,
                                           void* stream) {
  if (A <= 0 || N <= 0 || K <= 0 || E <= 0 || N % 32) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kExpertTileN - 1) / kExpertTileN, A);
  mxint4_expert_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const uint8_t*)packed, (const uint8_t*)exps,
      (const long long*)expert_ids, (float*)out, N, K, E);
  return (int)cudaGetLastError();
}

// tm is the row tile the wrapper's planner chose (1, 2, 4 or 8).
extern "C" int mxint4_matmul_launch(const void* x, const void* packed, const void* exps,
                                    const void* out_scale, const void* row_scale,
                                    const void* bias, void* out, void* partials,
                                    void* tickets, int M, int N, int K, int tm,
                                    int n_splits, int k_per_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (tm) {
    case 1: return launch<1, 32>(x, packed, exps, out_scale, row_scale, bias, out,
                                 partials, tickets, M, N, K, n_splits, k_per_split, s);
    case 2: return launch<2, 32>(x, packed, exps, out_scale, row_scale, bias, out,
                                 partials, tickets, M, N, K, n_splits, k_per_split, s);
    case 4: return launch<4, 16>(x, packed, exps, out_scale, row_scale, bias, out,
                                 partials, tickets, M, N, K, n_splits, k_per_split, s);
    case 8: return launch<8, 8>(x, packed, exps, out_scale, row_scale, bias, out,
                                partials, tickets, M, N, K, n_splits, k_per_split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
