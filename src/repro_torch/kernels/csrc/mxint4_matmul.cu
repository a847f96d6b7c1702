// MXINT4 dequant-fused matmul for Hopper (sm_90a): the HSA decode (MVM) path.
//
// Replaces the Pallas TPU kernel `mxint4_matmul_pallas`
// (src/repro/kernels/mxint4_matmul.py).  Computes
//
//     y[M, N] = (x[M, K] @ W) * out_scale[N] * row_scale[M] + bias[N]
//
// with W[K, N] streamed as int8 `packed[K, N/2]` (two int4 mantissas per byte,
// low nibble = even column) and uint8 `exps[K, N/32]` (one 4-bit code per 16
// columns, two codes per byte, low nibble = even group), dequantized in
// registers as m * 2^(code - 11), an exact power-of-two scale.
//
// What bounds it on the H100: bytes.  At decode M = 2 each weight byte feeds
// four multiply-adds, far below the ~600 int/f32 operations per byte where
// the card's compute would become the limit, so the time floor is the 4.25
// bits per weight over 3.35 TB/s.  The design serves that:
//   * each thread owns 8 consecutive output columns and loads their mantissas
//     as one 32-bit word, so a warp reads 128 contiguous bytes of a row;
//   * x (cast to f32 by the wrapper) is staged in shared memory in 256-deep
//     slices and broadcast to all threads; accumulation is f32 FMA on the
//     CUDA cores (Hopper's tensor cores have no int4 product);
//   * a split over K across blocks (grid.y) gives the 132 SMs work even at
//     N = 2048.  Each split writes its partial sums to a workspace; the last
//     block of a column tile to finish (an atomic ticket) adds the partials
//     in split order, so the result is deterministic, and applies the Eq. (4)
//     epilogue in the reference's order: acc * out_scale, * row_scale, + bias.
// Ragged N (a multiple of 32, not of the 256-column tile) is masked, not
// padded.  The kernel allocates nothing; the wrapper passes the workspace and
// the ticket counters (zero on entry, reset to zero by the last block).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColsPerThread = 8;
constexpr int kThreadsX = 32;                       // columns: 32 * 8 = 256
constexpr int kThreadsY = 8;                        // K rows in flight
constexpr int kTileN = kThreadsX * kColsPerThread;  // 256
constexpr int kTileM = 4;                           // rows of x per block
constexpr int kSliceK = 256;                        // x slice staged in smem

__device__ __forceinline__ float pow2(int e) {
  // 2^e for e in [-11, 4]: a normal float, built exactly from its bits.
  return __int_as_float((e + 127) << 23);
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
mxint4_matmul_kernel(const float* __restrict__ x, const uint32_t* __restrict__ packed,
                     const uint8_t* __restrict__ exps,
                     const float* __restrict__ out_scale,
                     const float* __restrict__ row_scale,
                     const float* __restrict__ bias, float* __restrict__ out,
                     float* __restrict__ partials, int* __restrict__ tickets,
                     int M, int N, int K, int k_per_split) {
  __shared__ float xs[kTileM][kSliceK];
  __shared__ float red[kThreadsY][kTileM][kTileN];
  __shared__ int is_last;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int n0 = blockIdx.x * kTileN + tx * kColsPerThread;
  const int m0 = blockIdx.z * kTileM;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int k_beg = split * k_per_split;
  const int k_end = min(K, k_beg + k_per_split);
  const bool col_ok = n0 < N;
  const int words_per_row = N / 8;                  // 8 int4 per 32-bit word
  const int exps_per_row = N / 32;

  float acc[kTileM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  for (int kt = k_beg; kt < k_end; kt += kSliceK) {
    const int depth = min(kSliceK, k_end - kt);
    for (int i = tid; i < kTileM * kSliceK; i += kThreadsX * kThreadsY) {
      const int m = i / kSliceK, kk = i % kSliceK;
      xs[m][kk] = (m0 + m < M && kk < depth) ? x[(size_t)(m0 + m) * K + kt + kk] : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      for (int kk = ty; kk < depth; kk += kThreadsY) {
        const int k = kt + kk;
        const uint32_t word = packed[(size_t)k * words_per_row + n0 / 8];
        const uint8_t eb = exps[(size_t)k * exps_per_row + n0 / 32];
        const int code = ((n0 / 16) & 1) ? (eb >> 4) : (eb & 0x0F);
        const float scale = pow2(code - 11);
        float w[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const int nib = (word >> (4 * j)) & 0x0F;
          w[j] = (float)((nib ^ 8) - 8) * scale;    // sign-extended int4
        }
#pragma unroll
        for (int m = 0; m < kTileM; ++m) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
        }
      }
    }
    __syncthreads();
  }

  // Reduce the kThreadsY partial rows of this block in a fixed order.
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) red[ty][m][tx * kColsPerThread + j] = acc[m][j];
  __syncthreads();

  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  float sums[kTileM];
#pragma unroll
  for (int e = 0; e < kTileM; ++e) {
    const int idx = tid + e * kThreadsX * kThreadsY;  // covers kTileM * kTileN
    const int m = idx / kTileN, c = idx % kTileN;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kThreadsY; ++r) s += red[r][m][c];
    sums[e] = s;
  }

  if (n_splits > 1) {
#pragma unroll
    for (int e = 0; e < kTileM; ++e) {
      const int idx = tid + e * kThreadsX * kThreadsY;
      const int m = m0 + idx / kTileN, n = blockIdx.x * kTileN + idx % kTileN;
      if (m < M && n < N) partials[((size_t)split * M + m) * N + n] = sums[e];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = (atomicAdd(&tickets[tile], 1) == n_splits - 1);
    __syncthreads();
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int e = 0; e < kTileM; ++e) {
      const int idx = tid + e * kThreadsX * kThreadsY;
      const int m = m0 + idx / kTileN, n = blockIdx.x * kTileN + idx % kTileN;
      float s = 0.f;
      if (m < M && n < N)
        for (int sp = 0; sp < n_splits; ++sp) s += __ldcg(&partials[((size_t)sp * M + m) * N + n]);
      sums[e] = s;
    }
    if (tid == 0) tickets[tile] = 0;
  }

#pragma unroll
  for (int e = 0; e < kTileM; ++e) {
    const int idx = tid + e * kThreadsX * kThreadsY;
    const int m = m0 + idx / kTileN, n = blockIdx.x * kTileN + idx % kTileN;
    if (m < M && n < N) {
      float y = __fmul_rn(sums[e], out_scale[n]);
      y = __fmul_rn(y, row_scale[m]);
      out[(size_t)m * N + n] = __fadd_rn(y, bias[n]);
    }
  }
}

}  // namespace

extern "C" int mxint4_matmul_launch(const void* x, const void* packed, const void* exps,
                                    const void* out_scale, const void* row_scale,
                                    const void* bias, void* out, void* partials,
                                    void* tickets, int M, int N, int K, int n_splits,
                                    int k_per_split, void* stream) {
  dim3 grid((N + kTileN - 1) / kTileN, n_splits, (M + kTileM - 1) / kTileM);
  dim3 block(kThreadsX, kThreadsY);
  mxint4_matmul_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const uint32_t*)packed, (const uint8_t*)exps,
      (const float*)out_scale, (const float*)row_scale, (const float*)bias, (float*)out,
      (float*)partials, (int*)tickets, M, N, K, k_per_split);
  return (int)cudaGetLastError();
}

extern "C" int mxint4_tile_m() { return kTileM; }
extern "C" int mxint4_tile_n() { return kTileN; }
