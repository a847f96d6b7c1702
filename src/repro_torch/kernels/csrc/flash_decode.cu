// Split-KV flash-decode attention for Hopper (sm_90a): one new token per
// sequence against its KV cache, the MVM-phase attention of every model that
// keeps one.
//
// Replaces the Pallas TPU kernel `flash_decode_pallas`
// (src/repro/kernels/flash_decode.py), GQA layout.  For each batch lane b and
// kv head h, with G query heads per kv head:
//
//     s[g, r] = (q[b, h, g, :] . K[b, r, h, :]) / sqrt(d)   for r < kv_len
//     out[b, h, g, :] = softmax_r(s[g, :]) @ V[b, :kv_len, h, :]
//
// K and V arrive in the reference's [B, C, KV, d] layout, each in one of five
// cache formats (template parameters, K and V independent): f32, bf16, legacy
// int8 (q / 32), int8_tok (q * s per row) and mxint4_blk (packed nibbles,
// sign-extended in registers, times 2^(e - 2) per 16 values).  Every value is
// dequantized exactly as `kvq.decode` does, once per row for all G heads.
//
// What bounds it on the H100: bytes.  Each cache byte feeds about 2G/elem
// operations, so the floor is the kv_len rows of K and V (and their scales)
// over 3.35 TB/s: about 2.6 us per layer for an f32 cache at kv_len 528,
// B = 2, KV = 8, d = 128, and 0.67 / 0.36 us for int8_tok / mxint4_blk.  At
// that size launch and tail effects dominate, so the design spreads the rows:
//   * the grid is (splits, KV, B).  One (b, h) pair per block, as the Pallas
//     grid walks it, gives only B * KV = 16 blocks for 132 SMs, so the wrapper
//     splits the kv_len rows into ranges of whole 32-row tiles, about two
//     blocks per SM in all.  Rows at or past kv_len are never read.
//   * a block stages G query rows in shared memory, dequantizes a 32-row tile
//     of K and of V into shared memory (the tail of the last tile masked:
//     scores -inf, V rows 0), and folds the tile into an online softmax
//     (m, l, acc[G, dv]) kept in f32, with the reference's finite-max guard.
//   * each thread issues a batch of independent loads before it stores them
//     to shared memory, so the rows' memory latencies overlap;
//   * with more than one split, each block writes its partial (m, l, acc) to a
//     workspace and the last block of its (b, h) to finish (an atomic ticket)
//     merges the splits in split order, so two launches are bit-equal.
// The kernel allocates nothing: the wrapper passes the workspace and the
// ticket counters (zero on entry, reset to zero by the merging block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;        // cache rows per tile (one per lane)
constexpr int kThreads = 128;
constexpr int kMaxDim = 256;     // head dims d, dv
constexpr int kMaxGroup = 16;    // query heads per kv head

enum Fmt { kF32 = 0, kBF16 = 1, kInt8Legacy = 2, kInt8Tok = 3, kMxint4Blk = 4 };

__device__ __forceinline__ float pow2(int e) {
  // 2^e for the cache exponents' range (e in [-11, 3]): exact, from the bits.
  return __int_as_float((e + 127) << 23);
}

// Element i of cache row `row` (the flat index (b * C + r) * KV + h) of one
// operand, dequantized to f32.  `p0` holds the values, `p1` the per-row
// scales (int8_tok) or the per-16 exponents (mxint4_blk).
template <int F>
__device__ __forceinline__ float load_elem(const void* p0, const void* p1, size_t row,
                                           int dim, int i) {
  if (F == kF32) {
    return static_cast<const float*>(p0)[row * dim + i];
  } else if (F == kBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p0)[row * dim + i]);
  } else if (F == kInt8Legacy) {
    return (float)static_cast<const int8_t*>(p0)[row * dim + i] * 0.03125f;  // / 32
  } else if (F == kInt8Tok) {
    return (float)static_cast<const int8_t*>(p0)[row * dim + i] *
           static_cast<const float*>(p1)[row];
  } else {
    const int byte = static_cast<const int8_t*>(p0)[row * (dim / 2) + i / 2];
    const int mant = (i & 1) ? (byte >> 4) : (((byte & 0x0F) ^ 8) - 8);
    const int e = static_cast<const int8_t*>(p1)[row * (dim / 16) + i / 16];
    return (float)mant * pow2(e - 2);
  }
}

// Dequantize rows [r0, r0 + kTile) of one operand into dst[kTile][ld]; rows
// at or past r_end read as 0.  Each thread issues kBatch independent loads
// before its first store, so their memory latencies overlap.
template <int F>
__device__ void load_tile(float* dst, int ld, const void* p0, const void* p1, int b,
                          int h, int C, int KV, int dim, int r0, int r_end) {
  constexpr int kBatch = 8;
  const int n = kTile * dim;
  for (int base = threadIdx.x; base < n; base += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads, r = idx / dim, cr = r0 + r;
      v[u] = (idx < n && cr < r_end)
          ? load_elem<F>(p0, p1, ((size_t)b * C + cr) * KV + h, dim, idx - r * dim)
          : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads, r = idx / dim;
      if (idx < n) dst[r * ld + idx - r * dim] = v[u];
    }
  }
}

template <int KF, int VF>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const void* k0, const void* k1,
                    const void* v0, const void* v1, float* __restrict__ out,
                    float* __restrict__ partials, int* __restrict__ tickets, int C,
                    int KV, int G, int d, int dv, int kv_len, int rows_per_split,
                    float scale, int scale_is_div) {
  extern __shared__ float smem[];
  const int ldk = d + 1;                       // padded: conflict-free dot rows
  float* qs = smem;                            // [G][d]
  float* ks = qs + G * d;                      // [kTile][d + 1]
  float* vs = ks + kTile * ldk;                // [kTile][dv]
  float* acc = vs + kTile * dv;                // [G][dv]
  float* sc = acc + G * dv;                    // [G][kTile] scores, then p
  float* m = sc + G * kTile;                   // [G]
  float* l = m + G;                            // [G]
  float* corr = l + G;                         // [G]
  float* wts = corr + G;                       // [n_splits][G] merge weights
  __shared__ int is_last;

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * KV + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r_beg = split * rows_per_split;
  const int r_end = min(kv_len, r_beg + rows_per_split);
  const float sqrt_d = sqrtf((float)d);

  for (int i = tid; i < G * d; i += kThreads) qs[i] = q[(size_t)bh * G * d + i];
  for (int i = tid; i < G * dv; i += kThreads) acc[i] = 0.f;
  if (tid < G) {
    m[tid] = -INFINITY;
    l[tid] = 0.f;
  }

  for (int r0 = r_beg; r0 < r_end; r0 += kTile) {
    __syncthreads();                           // previous tile fully consumed
    load_tile<KF>(ks, ldk, k0, k1, b, h, C, KV, d, r0, r_end);
    load_tile<VF>(vs, dv, v0, v1, b, h, C, KV, dv, r0, r_end);
    __syncthreads();

    for (int idx = tid; idx < G * kTile; idx += kThreads) {
      const int g = idx / kTile, r = idx % kTile;
      float s = 0.f;
      for (int i = 0; i < d; ++i) s = fmaf(qs[g * d + i], ks[r * ldk + i], s);
      s = scale_is_div ? s / sqrt_d : s * scale;
      sc[idx] = (r0 + r < r_end) ? s : -INFINITY;
    }
    __syncthreads();

    // Online softmax, one warp per query head, one lane per tile row.
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s = sc[g * kTile + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float p = expf(s - m_safe);        // masked rows: exp(-inf) = 0
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      sc[g * kTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float c = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        corr[g] = c;
        l[g] = l[g] * c + ps;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * dv; idx += kThreads) {
      const int g = idx / dv, j = idx % dv;
      float a = acc[idx] * corr[g];
      for (int r = 0; r < kTile; ++r) a = fmaf(sc[g * kTile + r], vs[r * dv + j], a);
      acc[idx] = a;
    }
  }
  __syncthreads();

  if (n_splits == 1) {
    for (int idx = tid; idx < G * dv; idx += kThreads)
      out[(size_t)bh * G * dv + idx] = acc[idx] / fmaxf(l[idx / dv], 1e-30f);
    return;
  }

  // Partials of this split: [B * KV][n_splits][G * (2 + dv)] as (m, l, acc).
  const int per = G * (2 + dv);
  float* mine = partials + ((size_t)bh * n_splits + split) * per;
  for (int idx = tid; idx < G * dv; idx += kThreads) mine[2 * G + idx] = acc[idx];
  if (tid < G) {
    mine[tid] = m[tid];
    mine[G + tid] = l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = (atomicAdd(&tickets[bh], 1) == n_splits - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // Merge in split order: weights exp(m_s - max_s m_s) once per (split,
  // head), then the denominator and every output entry as sums over splits.
  const float* all = partials + (size_t)bh * n_splits * per;
  if (tid < G) {
    float mx = -INFINITY;
    for (int sp = 0; sp < n_splits; ++sp) mx = fmaxf(mx, __ldcg(&all[sp * per + tid]));
    m[tid] = isfinite(mx) ? mx : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < n_splits * G; i += kThreads) {
    const int sp = i / G, g = i % G;
    const float ms = __ldcg(&all[sp * per + g]);
    wts[i] = isfinite(ms) ? expf(ms - m[g]) : 0.f;
  }
  __syncthreads();
  if (tid < G) {
    float den = 0.f;
    for (int sp = 0; sp < n_splits; ++sp)
      den += __ldcg(&all[sp * per + G + tid]) * wts[sp * G + tid];
    l[tid] = den;
  }
  __syncthreads();
  for (int idx = tid; idx < G * dv; idx += kThreads) {
    const int g = idx / dv;
    float a = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_splits; ++sp)
      a += __ldcg(&all[sp * per + 2 * G + idx]) * wts[sp * G + g];
    out[(size_t)bh * G * dv + idx] = a / fmaxf(l[g], 1e-30f);
  }
  if (tid == 0) tickets[bh] = 0;
}

size_t smem_bytes(int G, int d, int dv, int n_splits) {
  return sizeof(float) * ((size_t)G * d + kTile * (d + 1) + kTile * dv + G * dv +
                          G * kTile + 3 * G + (size_t)n_splits * G);
}

template <int KF, int VF>
int launch(const float* q, const void* k0, const void* k1, const void* v0, const void* v1,
           float* out, float* partials, int* tickets, int B, int C, int KV, int G, int d,
           int dv, int kv_len, int n_splits, int rows_per_split, float scale,
           int scale_is_div, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, d, dv, n_splits);
  auto kernel = flash_decode_kernel<KF, VF>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n_splits, KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k0, k1, v0, v1, out, partials, tickets, C,
                                           KV, G, d, dv, kv_len, rows_per_split, scale,
                                           scale_is_div);
  return (int)cudaGetLastError();
}

template <int KF>
int launch_v(int vfmt, const float* q, const void* k0, const void* k1, const void* v0,
             const void* v1, float* out, float* partials, int* tickets, int B, int C,
             int KV, int G, int d, int dv, int kv_len, int n_splits, int rows_per_split,
             float scale, int scale_is_div, cudaStream_t stream) {
#define FD_ARGS q, k0, k1, v0, v1, out, partials, tickets, B, C, KV, G, d, dv, kv_len, \
                n_splits, rows_per_split, scale, scale_is_div, stream
  switch (vfmt) {
    case kF32: return launch<KF, kF32>(FD_ARGS);
    case kBF16: return launch<KF, kBF16>(FD_ARGS);
    case kInt8Legacy: return launch<KF, kInt8Legacy>(FD_ARGS);
    case kInt8Tok: return launch<KF, kInt8Tok>(FD_ARGS);
    case kMxint4Blk: return launch<KF, kMxint4Blk>(FD_ARGS);
  }
#undef FD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k0, const void* k1,
                                   const void* v0, const void* v1, void* out,
                                   void* partials, void* tickets, int B, int C, int KV,
                                   int G, int d, int dv, int kv_len, int kfmt, int vfmt,
                                   int n_splits, int rows_per_split, float scale,
                                   int scale_is_div, void* stream) {
  if (G < 1 || G > kMaxGroup || d < 1 || d > kMaxDim || dv < 1 || dv > kMaxDim ||
      kv_len < 1 || kv_len > C || n_splits < 1 || rows_per_split < kTile ||
      rows_per_split % kTile || (long long)n_splits * rows_per_split < kv_len)
    return (int)cudaErrorInvalidValue;
#define FD_ARGS vfmt, (const float*)q, k0, k1, v0, v1, (float*)out, (float*)partials, \
                (int*)tickets, B, C, KV, G, d, dv, kv_len, n_splits, rows_per_split, \
                scale, scale_is_div, (cudaStream_t)stream
  switch (kfmt) {
    case kF32: return launch_v<kF32>(FD_ARGS);
    case kBF16: return launch_v<kBF16>(FD_ARGS);
    case kInt8Legacy: return launch_v<kInt8Legacy>(FD_ARGS);
    case kInt8Tok: return launch_v<kInt8Tok>(FD_ARGS);
    case kMxint4Blk: return launch_v<kMxint4Blk>(FD_ARGS);
  }
#undef FD_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_decode_tile_rows() { return kTile; }
extern "C" int flash_decode_max_dim() { return kMaxDim; }
extern "C" int flash_decode_max_group() { return kMaxGroup; }
