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
// initial state (zero when the pointer is null), so a warm-state caller runs
// the kernel too.
//
// The TPU walks the chunks as a sequential grid axis; here one block owns one
// (batch*head, 64-wide dv tile) and loops over the chunks itself.  Columns of
// y and S are independent, so splitting dv is exact: the full 256 x 512 f32
// state (512 KiB) does not fit one block's 227 KB, a 256 x 64 tile (64 KiB)
// does.  Shared memory holds that state tile, the decayed score matrix P
// (c x c), the chunk's V tile and a staging buffer for Q/K slices: 197 KB,
// one block per SM.  At the main path's B = 2, H = 8, dv = 512 that is
// 8 x 16 = 128 blocks for the 132 SMs.  Decay factors are built in log space
// from log(gamma) (expf of multiples of it), as the TPU kernel does.
//
// What bounds it on the H100: operations.  At B = 2, S = 512 the math is
// ~5.9 GFLOP f32 on ~59 MB; the kernel runs it on the CUDA cores (f32 FMA,
// 8 x 8 and 16 x 4 register tiles), recomputing Q K^T once per dv tile.
// Tensor cores (tf32) and a shared score pass are later work.
// Limits: chunk <= 128, dk <= 256; dv and S are free (dv is masked).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;       // max chunk
constexpr int kDK = 256;      // max key width
constexpr int kDVT = 64;      // dv tile per block
constexpr int kKT = 32;       // contraction slice
constexpr int kThreads = 256; // 16 x 16
constexpr int kLdP = kC + 1;  // padded row of P and of the Q/K staging

constexpr int kSmemS = kDK * kDVT;
constexpr int kSmemP = kC * kLdP;
constexpr int kSmemV = kC * kDVT;
constexpr int kSmemT = (2 * kKT * kLdP > kKT * kDK) ? 2 * kKT * kLdP : kKT * kDK;
constexpr size_t kSmemBytes = sizeof(float) * (kSmemS + kSmemP + kSmemV + kSmemT);

__global__ void __launch_bounds__(kThreads)
retention_chunkwise_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ log_g,
                           const float* __restrict__ state_in, float* __restrict__ y,
                           float* __restrict__ state_out, int seq, int dk, int dv,
                           int chunk) {
  extern __shared__ float smem[];
  float* S = smem;              // [kDK][kDVT]
  float* P = S + kSmemS;        // [kC][kLdP]
  float* V = P + kSmemP;        // [kC][kDVT]
  float* T = V + kSmemV;        // staging
  float* Qt = T;                // [kKT][kLdP]
  float* Kt = T + kKT * kLdP;   // [kKT][kLdP]
  float* Ks = T;                // [kKT][kDK] (step C)

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, dv0 = blockIdx.x * kDVT;
  const float lg = log_g[bh];
  const float chunk_decay = expf((float)chunk * lg);

  for (int e = tid; e < kSmemS; e += kThreads) {
    const int d = e / kDVT, c = e % kDVT;
    S[e] = (state_in != nullptr && d < dk && dv0 + c < dv)
               ? state_in[((size_t)bh * dk + d) * dv + dv0 + c] : 0.f;
  }

  for (int c0 = 0; c0 < seq; c0 += chunk) {
    const float* qb = q + ((size_t)bh * seq + c0) * dk;
    const float* kb = k + ((size_t)bh * seq + c0) * dk;
    const float* vb = v + ((size_t)bh * seq + c0) * dv;

    // ---- A: P = (Q K^T) .* D ------------------------------------------------
    float pa[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) pa[r][cc] = 0.f;
    for (int kk0 = 0; kk0 < dk; kk0 += kKT) {
      for (int e = tid; e < kC * kKT; e += kThreads) {
        const int i = e / kKT, kk = e % kKT;
        const bool ok = i < chunk && kk0 + kk < dk;
        Qt[kk * kLdP + i] = ok ? qb[(size_t)i * dk + kk0 + kk] : 0.f;
        Kt[kk * kLdP + i] = ok ? kb[(size_t)i * dk + kk0 + kk] : 0.f;
      }
      __syncthreads();
      const int kmax = min(kKT, dk - kk0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = Qt[kk * kLdP + ty + 16 * r];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) b[cc] = Kt[kk * kLdP + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) pa[r][cc] = fmaf(a[r], b[cc], pa[r][cc]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int j = tx + 16 * cc;
        const int diff = i - j;
        P[i * kLdP + j] = diff >= 0 ? pa[r][cc] * expf((float)diff * lg) : 0.f;
      }
    }

    // ---- B: y = P V + (Q .* gamma^m) S --------------------------------------
    for (int e = tid; e < kC * kDVT; e += kThreads) {
      const int j = e / kDVT, c = e % kDVT;
      V[e] = (j < chunk && dv0 + c < dv) ? vb[(size_t)j * dv + dv0 + c] : 0.f;
    }
    __syncthreads();
    float yi[8][4], yc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) yi[r][cc] = yc[r][cc] = 0.f;
    for (int j = 0; j < chunk; ++j) {
      float p[8], w[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) p[r] = P[(ty + 16 * r) * kLdP + j];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) w[cc] = V[j * kDVT + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) yi[r][cc] = fmaf(p[r], w[cc], yi[r][cc]);
    }
    for (int kk0 = 0; kk0 < dk; kk0 += kKT) {
      for (int e = tid; e < kC * kKT; e += kThreads) {
        const int i = e / kKT, kk = e % kKT;
        const bool ok = i < chunk && kk0 + kk < dk;
        Qt[kk * kLdP + i] =
            ok ? qb[(size_t)i * dk + kk0 + kk] * expf((float)(i + 1) * lg) : 0.f;
      }
      __syncthreads();
      const int kmax = min(kKT, dk - kk0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[8], s[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = Qt[kk * kLdP + ty + 16 * r];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[cc] = S[(kk0 + kk) * kDVT + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) yc[r][cc] = fmaf(a[r], s[cc], yc[r][cc]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= chunk) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = dv0 + tx + 16 * cc;
        if (c < dv) y[((size_t)bh * seq + c0 + i) * dv + c] = yi[r][cc] + yc[r][cc];
      }
    }

    // ---- C: S <- gamma^c S + (K .* gamma^(c-m))^T V --------------------------
    float kv[16][4];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) kv[r][cc] = 0.f;
    for (int j0 = 0; j0 < chunk; j0 += kKT) {
      for (int e = tid; e < kKT * kDK; e += kThreads) {
        const int jj = e / kDK, d = e % kDK, j = j0 + jj;
        Ks[e] = (j < chunk && d < dk)
                    ? kb[(size_t)j * dk + d] * expf((float)(chunk - (j + 1)) * lg) : 0.f;
      }
      __syncthreads();
      const int jmax = min(kKT, chunk - j0);
      for (int jj = 0; jj < jmax; ++jj) {
        float a[16], w[4];
#pragma unroll
        for (int r = 0; r < 16; ++r) a[r] = Ks[jj * kDK + ty + 16 * r];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) w[cc] = V[(j0 + jj) * kDVT + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 16; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) kv[r][cc] = fmaf(a[r], w[cc], kv[r][cc]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float* s = &S[(ty + 16 * r) * kDVT + tx + 16 * cc];
        *s = chunk_decay * *s + kv[r][cc];
      }
    __syncthreads();
  }

  for (int e = tid; e < kSmemS; e += kThreads) {
    const int d = e / kDVT, c = e % kDVT;
    if (d < dk && dv0 + c < dv) state_out[((size_t)bh * dk + d) * dv + dv0 + c] = S[e];
  }
}

}  // namespace

extern "C" int retention_chunkwise_launch(const void* q, const void* k, const void* v,
                                          const void* log_g, const void* state_in,
                                          void* y, void* state_out, int bh, int seq,
                                          int dk, int dv, int chunk, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(retention_chunkwise_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((dv + kDVT - 1) / kDVT, bh);
  retention_chunkwise_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)log_g,
      (const float*)state_in, (float*)y, (float*)state_out, seq, dk, dv, chunk);
  return (int)cudaGetLastError();
}

extern "C" int retention_max_chunk() { return kC; }
extern "C" int retention_max_dk() { return kDK; }
