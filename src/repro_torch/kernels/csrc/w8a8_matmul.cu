// W8A8 int8 GEMM for Hopper (sm_90a): the HSA prefill (MMM) path.
//
// Replaces the Pallas TPU kernel `w8a8_matmul_pallas`
// (src/repro/kernels/w8a8_matmul.py).  Computes
//
//     y[M, N] = f32(int32(x_q[M, K] . w_q[K, N])) * out_scale[N] * row_scale[M] + bias[N]
//
// with exact int32 accumulation and the epilogue applied once, when the
// accumulator drains, in the reference's order (x out_scale, x row_scale,
// + bias; no fused multiply-add, so each step rounds as the reference does).
//
// What bounds it on the H100: operations.  At prefill M = B*S = 1024 a
// (2048 x 2048) product does 2*M*K*N = 8.6 G int8 operations on 6.3 MB, far
// above the ~590 operations per byte where int8 tensor cores (1979 TOP/s
// dense) outrun 3.35 TB/s.  The design is the simple tensor-core GEMM:
//   * 128 x 128 output tile per block, 8 warps of 64 x 32, K in steps of 32;
//   * warp-level `mma.sync.m16n8k32` s8 x s8 -> s32 (int8 tensor cores,
//     exact integer sums);
//   * both operands staged in shared memory with k contiguous; W arrives
//     [K, N] row-major and is transposed to [N, K] while it is stored, since
//     the MMA takes B column-major.  Rows are padded by 16 bytes so the
//     fragment loads hit 32 distinct banks.
// It is single-buffered with no TMA or `wgmma`: right first, fast later.
// K and N must be multiples of 16 (16-byte loads); M is masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kPad = 16;                 // bytes of padding per smem row
constexpr int kLd = kBK + kPad;          // 48-byte row stride
constexpr int kThreads = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
w8a8_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                   const float* __restrict__ out_scale,
                   const float* __restrict__ row_scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int M, int N, int K) {
  __shared__ __align__(16) int8_t As[kBM][kLd];   // [m][k]
  __shared__ __align__(16) int8_t Bs[kBN][kLd];   // [n][k] (transposed W)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2;          // 0..1 -> 64 rows each
  const int warp_n = warp & 3;           // 0..3 -> 32 cols each
  const int g = lane >> 2, t = lane & 3; // mma groupID / thread-in-group
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;

  int acc[4][4][4];                      // [m16 tile][n8 tile][frag]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // Global -> smem copy roles: A is 128 rows x 32 bytes (two 16 B per row),
  // B is 32 k-rows x 128 bytes (eight 16 B per row).
  const int a_row = tid >> 1, a_col = (tid & 1) * 16;
  const int b_k = tid >> 3, b_n = (tid & 7) * 16;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    int4 av = make_int4(0, 0, 0, 0), bv = make_int4(0, 0, 0, 0);
    if (bm + a_row < M && k0 + a_col < K)
      av = *reinterpret_cast<const int4*>(xq + (size_t)(bm + a_row) * K + k0 + a_col);
    if (k0 + b_k < K && bn + b_n < N)
      bv = *reinterpret_cast<const int4*>(wq + (size_t)(k0 + b_k) * N + bn + b_n);
    *reinterpret_cast<int4*>(&As[a_row][a_col]) = av;
    const int8_t* bb = reinterpret_cast<const int8_t*>(&bv);
#pragma unroll
    for (int j = 0; j < 16; ++j) Bs[b_n + j][b_k] = bb[j];
    __syncthreads();

    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp_m * 64 + i * 16 + g;
      af[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][t * 4]);
      af[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][t * 4]);
      af[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][t * 4 + 16]);
      af[i][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][t * 4 + 16]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = warp_n * 32 + j * 8 + g;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][t * 4]);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[c][t * 4 + 16]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    __syncthreads();
  }

  // Drain: c0,c1 at (row g, cols 2t, 2t+1); c2,c3 at row g + 8.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = bm + warp_m * 64 + i * 16 + g + h * 8;
        if (m >= M) continue;
        const float rs = row_scale[m];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = bn + warp_n * 32 + j * 8 + t * 2 + e;
          if (n >= N) continue;
          float y = __fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]), out_scale[n]);
          y = __fmul_rn(y, rs);
          out[(size_t)m * N + n] = __fadd_rn(y, bias[n]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int w8a8_matmul_launch(const void* xq, const void* wq, const void* out_scale,
                                  const void* row_scale, const void* bias, void* out,
                                  int M, int N, int K, void* stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8a8_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const int8_t*)wq, (const float*)out_scale,
      (const float*)row_scale, (const float*)bias, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}
