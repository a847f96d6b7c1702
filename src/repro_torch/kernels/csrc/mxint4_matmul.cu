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
        const int cg = (code >> (4 * g)) & 0xF;
        const float se = __int_as_float((cg + 116) << 23);   // 2^(code - 11)
        float xe[TM];
#pragma unroll
        for (int m = 0; m < TM; ++m) xe[m] = xv[m] * se;
#pragma unroll
        for (int i = g * 2; i < min(W, g * 2 + 2); ++i) {
          // u = m + 8 of the even and the odd columns, one per byte.
          const uint32_t even = (words[i] ^ 0x88888888u) & 0x0F0F0F0Fu;
          const uint32_t odd = ((words[i] >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // 0x4B0000uu: byte j in the mantissa of 2^23, minus 2^23 + 8.
            const float we = __int_as_float(__byte_perm(even, 0x4B000000u, 0x7540 + j)) - 8388616.f;
            const float wo = __int_as_float(__byte_perm(odd, 0x4B000000u, 0x7540 + j)) - 8388616.f;
            const int col = 8 * i + 2 * j;
#pragma unroll
            for (int m = 0; m < TM; ++m) {
              acc[m][col] = fmaf(xe[m], we, acc[m][col]);
              acc[m][col + 1] = fmaf(xe[m], wo, acc[m][col + 1]);
            }
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

}  // namespace

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
