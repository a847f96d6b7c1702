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
// (4096 x 4096) product does 34 G int8 operations on 21 MB, far above the
// ~590 operations per byte where int8 tensor cores (1979 TOP/s dense)
// outrun 3.35 TB/s; at M <= 64 (the prefill lm_head) it streams W and bytes
// bound it.  The design is Hopper's warp-specialised GEMM:
//   * both operands K-major, as `wgmma` takes s8: x_q is [M, K] row-major
//     and the deployed weight is stored as W^T [N, K] contiguous, so no tile
//     is ever transposed;
//   * TMA loads A [BM x 128] and W^T [BN x 128] tiles (BK = 128 bytes, one
//     128-byte swizzled row) into a ring of 4 to 8 stages guarded by
//     full/empty `mbarrier`s; out-of-range rows and K are zero-filled by TMA,
//     so ragged M, N and K need no masks in the main loop;
//   * one producer thread keeps the ring full; one or two consumer
//     warpgroups (64 rows each) issue `wgmma.mma_async.m64nNk32.s32.s8.s8`
//     (N = 128 or 256) from shared memory with the accumulators in
//     registers, keeping one k-step's group in flight while the previous
//     stage is released;
//   * tiles 128 x 128 and 128 x 256, and 64 x 128 / 64 x 256 (one consumer
//     warpgroup) for M <= 64, the prefill lm_head, whose one masked m64 row
//     of tiles streams W, and for N = 1024, where 64 x 128 fills the card;
//     the wrapper's planner (kernels/hopper.py `w8a8_plan`) picks the tile.
//     Each block runs the whole of K: one wave of these tiles measured
//     faster than two waves or a K split at every main-path shape.
// The TMA descriptors are encoded on the host per call with libcuda's
// cuTensorMapEncodeTiled (linked with -lcuda).  K and N must be multiples of
// 16 (TMA row strides); the pointers 16-byte aligned.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 128;                 // bytes of K per stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the phase of the given parity to complete.  A wait that never
// ends (a pipeline fault) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int i = 0; !mbar_try_wait(bar, parity); ++i)
    if (i == (1 << 24)) __trap();
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO),
// the leading offset unused by this layout (1), layout type 1 (128B swizzle).
// The tile base is 1024-byte aligned; a k32 step within the row adds 32 bytes
// to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// wgmma m64nNk32 s8 x s8 -> s32, A and B from shared memory, D += A.B.
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k32(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_n128(d, da, db);
  else wgmma_n256(d, da, db);
}

// kWG consumer warpgroups of 64 rows (BM = 64 * kWG), BN columns, kStages
// ring stages; warpgroup 0 is the producer.
template <int kWG, int BN, int kStages>
__global__ void __launch_bounds__((kWG + 1) * 128, 1)
w8a8_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b,
                 const float* __restrict__ out_scale,
                 const float* __restrict__ row_scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int N, int K) {
  constexpr int BM = 64 * kWG;
  constexpr int kABytes = BM * kBK, kStage = (BM + BN) * kBK;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the 128B swizzle atoms.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_k = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kWG * 4);     // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        mbar_wait(smem_u32(&empty[s]), ((kt / kStages) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, kStage);
        const int kc = kt * kBK;
        tma_load_2d(smem_u32(smem + s * kStage), &tm_a, bar, kc, m0);
        tma_load_2d(smem_u32(smem + s * kStage + kABytes), &tm_b, bar, kc, n0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg - 1 owns rows [64 (wg - 1), 64 wg) of the tile.
  const int cw = wg - 1;
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kStages;
    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
    const uint64_t da = sw128_desc(smem_u32(smem + s * kStage + cw * 64 * kBK));
    const uint64_t db = sw128_desc(smem_u32(smem + s * kStage + kABytes));
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) wgmma_k32<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    fence_regs(acc);
    // The previous k-step's products are done: release its stage.
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % kStages]));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Accumulator layout (per warpgroup, m64nN): register 4c + 2h + e holds
  // row 16 warp + lane / 4 + 8 h, column 8 c + 2 (lane % 4) + e.
  const int row0 = m0 + cw * 64 + warp * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane & 3);

#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int n = col0 + 8 * c;
    if (n >= N) continue;
    const float os0 = out_scale[n], os1 = out_scale[n + 1];
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= M) continue;
      const float rs = row_scale[m];
      float2 y;
      y.x = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * c + 2 * h]), os0), rs), b0);
      y.y = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * c + 2 * h + 1]), os1), rs), b1);
      *reinterpret_cast<float2*>(&out[(size_t)m * N + n]) = y;
    }
  }
}

// A [rows, K] int8 K-major operand as a 2-D TMA map of [rows_box x 128] tiles.
CUresult encode(CUtensorMap* map, const void* ptr, int rows, int K, int rows_box) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)rows_box};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encoder failures are returned as 10000 + CUresult, launch failures as the
// cudaError.
template <int kWG, int BN, int kStages>
int launch(const void* xq, const void* wt, const void* out_scale, const void* row_scale,
           const void* bias, void* out, int M, int N, int K, cudaStream_t stream) {
  constexpr int BM = 64 * kWG;
  constexpr int smem = 1024 + kStages * (BM + BN) * kBK + 2 * kStages * 8;
  auto kernel = w8a8_gemm_kernel<kWG, BN, kStages>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tm_a, tm_b;
  CUresult r = encode(&tm_a, xq, M, K, BM);
  if (r == CUDA_SUCCESS) r = encode(&tm_b, wt, N, K, BN);
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, (kWG + 1) * 128, smem, stream>>>(
      tm_a, tm_b, (const float*)out_scale, (const float*)row_scale, (const float*)bias,
      (float*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// wt is W^T [N, K] contiguous (the deployed K-major weight); cfg indexes
// kernels/hopper.py W8A8_TILES: (BM, BN, stages) = (128, 128, 6),
// (128, 256, 4), (64, 256, 5), (64, 128, 8).
extern "C" int w8a8_matmul_launch(const void* xq, const void* wt, const void* out_scale,
                                  const void* row_scale, const void* bias, void* out,
                                  int M, int N, int K, int cfg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (cfg) {
    case 0: return launch<2, 128, 6>(xq, wt, out_scale, row_scale, bias, out, M, N, K, s);
    case 1: return launch<2, 256, 4>(xq, wt, out_scale, row_scale, bias, out, M, N, K, s);
    case 2: return launch<1, 256, 5>(xq, wt, out_scale, row_scale, bias, out, M, N, K, s);
    case 3: return launch<1, 128, 8>(xq, wt, out_scale, row_scale, bias, out, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
