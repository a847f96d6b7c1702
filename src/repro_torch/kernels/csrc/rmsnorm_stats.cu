// Row-wise sigma^{-1} for Hopper (sm_90a): the fused-RMSNorm producer.
//
// Replaces the Pallas TPU kernel `rmsnorm_stats_pallas`
// (src/repro/kernels/rmsnorm_stats.py).  For y[M, D] in f32 or bf16:
//
//     out[m] = rsqrt(sum_i y[m, i]^2 / D + eps)          (f32 [M, 1])
//
// What bounds it on the H100: bytes.  Two operations per element read, no
// matrix product, so the floor is M * D * elem over 3.35 TB/s (about 2.5 us
// at [1024, 4096] bf16).  The design: one warp per row, eight rows per block;
// each lane reads 16 bytes at a time (4 f32 or 8 bf16), neighbouring lanes on
// neighbouring addresses, keeps one f32 sum of squares per vector slot, and
// the warp adds them in a fixed shuffle order, so the result does not depend
// on the launch.  The load loop is unrolled so that several 16-byte loads per
// lane are in flight at once.  Rows past M are masked (the Pallas version
// pads M to 8).  Rows whose byte width or base address is not a multiple of
// 16 take a scalar-load variant of the same loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // rows per block

__device__ __forceinline__ float sq(float v) { return v * v; }

template <bool kBF16, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_stats_kernel(const void* __restrict__ y, float* __restrict__ out, int M, int D,
                     float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  constexpr int kPer = kBF16 ? 8 : 4;            // elements per 16-byte load
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;

  if (kVec) {
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const char*>(y) + (size_t)row * D * (kBF16 ? 2 : 4));
#pragma unroll 4
    for (int c = lane; c < D / kPer; c += 32) {
      const uint4 w = src[c];
      if (kBF16) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          acc[2 * j] += sq(f.x);
          acc[2 * j + 1] += sq(f.y);
        }
      } else {
        acc[0] += sq(__uint_as_float(w.x));
        acc[1] += sq(__uint_as_float(w.y));
        acc[2] += sq(__uint_as_float(w.z));
        acc[3] += sq(__uint_as_float(w.w));
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float v = kBF16
          ? __bfloat162float(static_cast<const __nv_bfloat16*>(y)[(size_t)row * D + i])
          : static_cast<const float*>(y)[(size_t)row * D + i];
      acc[(i / 32) % kPer] += sq(v);
    }
  }

  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) s += acc[j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = rsqrtf(s / (float)D + eps);
}

template <bool kBF16, bool kVec>
int launch(const void* y, float* out, int M, int D, float eps, cudaStream_t stream) {
  const int blocks = (M + kWarps - 1) / kWarps;
  rmsnorm_stats_kernel<kBF16, kVec><<<blocks, kWarps * 32, 0, stream>>>(y, out, M, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rmsnorm_stats_launch(const void* y, void* out, int M, int D, int is_bf16,
                                    int vec, float eps, void* stream) {
  if (M < 1 || D < 1) return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return vec ? launch<true, true>(y, o, M, D, eps, s) : launch<true, false>(y, o, M, D, eps, s);
  return vec ? launch<false, true>(y, o, M, D, eps, s) : launch<false, false>(y, o, M, D, eps, s);
}
