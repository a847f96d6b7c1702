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
// `_expert_ffn`).  What bounds it on the H100: the bytes of the distinct
// experts the rows address, 4.25 bits a weight over 3.35 TB/s (a decode
// step's A = B * top_k rows address up to A experts, a verify step's 80
// rows about 53 of olmoe's 64).  The ids are read in device memory and
// nothing of the routing on the host, so the launch captures into a CUDA
// graph and a replay serves whatever routing is written into the ids.
// Against what held back the first design (a block per row and 64
// columns that walked all of K with 4-byte loads, each row streaming its
// expert again):
//   * each distinct expert's bytes stream once.  Every block builds the
//     routing from the ids (`x_route`: slot j is the expert whose first row
//     is the j-th such row; its group is every row routed to it) and takes
//     items (slot, split, tile) of the launch, computing the whole group
//     from one read of each weight byte: up to kXPass rows a walk over the
//     item's run (a bigger group walks it again, from L2).  An id outside
//     [0, E) makes its row NaN.
//   * wide copies, far ahead: an item is 512 columns (256 contiguous bytes
//     of a K row) by a run of K rows, streamed in 64-row steps through a
//     ring of kXStages stages, kXStages - 1 steps in flight ahead of the
//     one computed, across the ends of items: a step's mantissas, codes and
//     the group's x rows as 2-D TMA tiles (16 KB, 1 KB and 256 bytes a
//     row), issued by one thread once the stage's 8 warps are done with it
//     (its empty barrier); a warp waits only for the stage it computes.  A
//     thread decodes 16 columns of a K row from one 8-byte shared load and
//     one 4-bit code.  (The same ring fed by one 1-D bulk copy a row
//     measured slower on the H100.)
//   * a K split sized so that the items of a decode step's 16 experts fill
//     one wave of two blocks an SM (`mxint4_expert_plan`); persistent
//     blocks take items in turn.  Each split writes its partial sums to a
//     workspace; the last of an item's splits to finish (an atomic ticket)
//     adds them in split order, with no atomic on a sum, so a relaunch is
//     bit-equal.  The ticket is taken a step after the partials were
//     stored and read a step later, so the block does not wait on it.
// Row isolation: a row's order of summation depends on (K, N) alone (its
// own FMAs over each thread's K rows in order, the block's 8 K lanes in
// order, the splits in order), never on A, on the size of its group or on
// the ids, so its bits are the same whatever other rows share the launch
// and wherever they are routed.
// It shares the nibble decode and the scale of the GEMV above.  Built with
// -DMX_EXPERT_PHASE_CLOCK (tools/expert_phase_clock.py), thread 0 of every
// block counts the cycles it spent routing, waiting for its copies,
// computing its steps and ending its passes, and the global timer at its
// entry and exit.

#include <cuda.h>
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

// ---- The routed expert GEMV (see the head of this file). ----
// A block is 256 threads on a tile of 512 columns of one expert (256
// contiguous bytes of each K row), walked in steps of 64 K rows through a
// ring of kXStages stages in shared memory.  Thread (tx, ty) owns columns
// 16 tx .. 16 tx + 15 (8 bytes of a K row, one 4-bit code) and K rows
// 4 ty .. 4 ty + 3 and 32 + 4 ty .. 32 + 4 ty + 3 of each step: a warp
// reads one K row at a time.
constexpr int kXTileN = 512;
constexpr int kXCols = 16;
constexpr int kXTX = kXTileN / kXCols;                 // 32 threads across
constexpr int kXTY = kThreads / kXTX;                  // 8 K lanes
constexpr int kXQuads = 2;                             // 4-row quads a thread a step
constexpr int kXStep = 4 * kXTY * kXQuads;             // 64 K rows a step
constexpr int kXRowBytes = kXTileN / 2;                // 256 bytes of mantissas
constexpr int kXCodeBytes = kXTileN / 32;              // 16 code bytes a K row
constexpr int kXPass = 3;                              // group rows a walk
constexpr int kXStages = 6;
// A stage: the step's mantissas [64][256 bytes], its codes [64][16 bytes]
// and the pass's x rows [kXPass][64] floats, each a 2-D TMA tile on the
// stage's full barrier.
constexpr int kXStageW = kXStep * kXRowBytes;
constexpr int kXStageC = kXStep * kXCodeBytes;
constexpr int kXStageBytes = kXStageW + kXStageC + kXPass * kXStep * 4;
static_assert(kXTY * kXTileN * 4 <= kXStageBytes, "a pass's sums go through one stage");

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

// Waits for the phase of the given parity to complete; a wait that never
// ends (a pipeline fault) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int i = 0; !mbar_try_wait(bar, parity); ++i)
    if (i == (1 << 26)) __trap();
}

// One 2-D TMA tile at (c0 bytes, c1 rows) of `map` into shared memory,
// counted on the mbarrier `bar` (out-of-bounds bytes land as zeros).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// A block's shared memory (byte offsets): the ring, two mbarriers a stage
// (full: its copies landed; empty: its 8 warps are done with it), then the routing it builds once: the ids, each
// expert's first row and slot, each slot's expert, the start of each
// slot's rows in `order`, and the rows in order of their slot (each
// slot's rows in row order).
struct XLayout { int bar, ids, first, eslot, dexp, start, order, bytes; };

__host__ __device__ inline XLayout x_layout(int A, int E) {
  XLayout l;
  l.bar = kXStages * kXStageBytes;
  l.ids = l.bar + 2 * kXStages * 8;
  l.first = l.ids + A * 4;
  l.eslot = l.first + E * 4;
  l.dexp = l.eslot + E * 4;
  l.start = l.dexp + A * 4;
  l.order = l.start + (A + 1) * 4;
  l.bytes = l.order + A * 4 + 128;        // + the alignment of the TMA tiles
  return l;
}

// The launch's shape and the block's routing tables.
struct XCtx {
  const CUtensorMap* tm_w;           // the mantissas [E * K rows][N / 2 bytes]
  const CUtensorMap* tm_c;           // the codes [E * K rows][N / 32 bytes]
  const CUtensorMap* tm_x;           // x [A rows][K floats]
  const uint8_t* exps;               // read in place where the codes are not copied
  unsigned char* smem;
  uint32_t full, empty;              // the ring's mbarriers, a stage's at + 8 * stage
  const int* dexp;                   // slot -> expert
  const int* start;                  // slot -> first index in order
  const int* order;                  // the rows, slot by slot
  int A, N, K, k_per, tiles, splits, items;
};

// A cursor over the steps of this block's work: items w = blockIdx.x,
// blockIdx.x + gridDim.x, ... (an item is a (slot, split, tile): tile
// fastest); each item in passes of up to kXPass of its group's rows (a
// pass walks the item's run of K rows once); each pass in steps.  What a
// step needs is set when the cursor enters an item or pass.
struct XJob {
  int w, pass, t;                    // item, pass, step
  int slot, split, n0, k0, rows, steps, g0, R, passes, e;
};

__device__ __forceinline__ void x_job_load(XJob& j, const XCtx& c) {
  if (j.w >= c.items) return;
  const int tile = j.w % c.tiles, rest = j.w / c.tiles;
  j.split = rest % c.splits;
  j.slot = rest / c.splits;
  j.e = c.dexp[j.slot];
  j.n0 = tile * kXTileN;
  j.k0 = j.split * c.k_per;
  j.rows = min(c.K - j.k0, c.k_per);
  j.steps = (j.rows + kXStep - 1) / kXStep;
  const int G = c.start[j.slot + 1] - c.start[j.slot];
  j.passes = (G + kXPass - 1) / kXPass;
  j.g0 = j.pass * kXPass;
  j.R = min(kXPass, G - j.g0);
}

__device__ __forceinline__ void x_job_first(XJob& j, const XCtx& c) {
  j.w = blockIdx.x;
  j.pass = j.t = 0;
  x_job_load(j, c);
}

__device__ __forceinline__ void x_job_next(XJob& j, const XCtx& c) {
  if (++j.t < j.steps) return;
  j.t = 0;
  if (++j.pass == j.passes) {
    j.pass = 0;
    j.w += gridDim.x;
  }
  x_job_load(j, c);
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The copies of the job's current step into stage st, issued by one
// thread as 2-D TMA tiles on the stage's full barrier: the mantissas, the
// codes and the pass's x rows.  Runs are whole steps but at the end of K,
// where the rows past K (the next expert's) meet x's zeros past K.
template <bool kStagedCodes>
__device__ __forceinline__ void x_issue(const XCtx& c, const XJob& j, int st) {
  unsigned char* sp = c.smem + st * kXStageBytes;
  const uint32_t bar = c.full + 8 * st;
  const int kb = j.k0 + j.t * kXStep;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, kXStageW + (kStagedCodes ? kXStageC : 0) + j.R * kXStep * 4);
  tma_load_2d(sp, c.tm_w, bar, j.n0 / 2, j.e * c.K + kb);
  if (kStagedCodes) tma_load_2d(sp + kXStageW, c.tm_c, bar, j.n0 / 32, j.e * c.K + kb);
  const int* rows = c.order + c.start[j.slot] + j.g0;
  for (int r = 0; r < j.R; ++r)
    tma_load_2d(sp + kXStageW + kXStageC + r * kXStep * 4, c.tm_x, bar, kb, rows[r]);
}

// One step of the job's pass: each thread's two quads of K rows times its
// 16 columns, for the pass's R rows, into acc[0 .. R), K rows in order.
template <int R, bool kStagedCodes>
__device__ __forceinline__ void x_step(const XCtx& c, const XJob& j, int st,
                                       float (&acc)[kXPass][kXCols]) {
  const int tid = threadIdx.x, tx = tid % kXTX, ty = tid / kXTX, shift = 4 * (tx & 1);
  const unsigned char* sp = c.smem + st * kXStageBytes;
#pragma unroll
  for (int h = 0; h < kXQuads; ++h) {
    const int k4 = h * 4 * kXTY + 4 * ty;   // the quad's first K row in the step
    uint32_t code[4];
    if constexpr (kStagedCodes) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        code[i] = (uint32_t)sp[kXStageW + (k4 + i) * kXCodeBytes + tx / 2] >> shift;
    } else {
      const int code_row = c.N / 32;
      const uint8_t* src = c.exps + ((size_t)j.e * c.K + j.k0) * code_row + j.n0 / 32 + tx / 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = j.t * kXStep + k4 + i;
        const bool ok = k < j.rows && j.n0 + 16 * tx < c.N;
        code[i] = ok ? (uint32_t)__ldg(src + (size_t)k * code_row) >> shift : 0u;
      }
    }
    float4 xv[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      xv[r] = *reinterpret_cast<const float4*>(sp + kXStageW + kXStageC + (r * kXStep + k4) * 4);
    const unsigned char* wp = sp + k4 * kXRowBytes + tx * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint2 w = *reinterpret_cast<const uint2*>(wp + i * kXRowBytes);
      const float se = mx_scale(code[i]);   // 2^(code - 11)
      float m0[8], m1[8];
      mx_mantissas(w.x, m0);
      mx_mantissas(w.y, m1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float xe = lane_of(xv[r], i) * se;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          acc[r][q] = fmaf(xe, m0[q], acc[r][q]);
          acc[r][8 + q] = fmaf(xe, m1[q], acc[r][8 + q]);
        }
      }
    }
  }
}

// The end of a pass: acc[0 .. R) summed over the block's K lanes (ty in
// order) into dst[row * N + column], and zeroed.  A row's order of
// summation is the same for every R: its own FMAs over the K rows in
// order, then these sums.
template <int R>
__device__ __forceinline__ void x_pass_sums(const XCtx& c, const XJob& j, int st,
                                            float (&acc)[kXPass][kXCols], float* dst) {
  const int tid = threadIdx.x, tx = tid % kXTX, ty = tid / kXTX;
  // The sums go through stage st, whose step every thread has computed
  // after this barrier; its next copies are issued after the next one.
  float* red = reinterpret_cast<float*>(c.smem + st * kXStageBytes);
  __syncthreads();
  const int* rows = c.order + c.start[j.slot] + j.g0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float4* to = reinterpret_cast<float4*>(red + ty * kXTileN + tx * kXCols);
#pragma unroll
    for (int q = 0; q < kXCols / 4; ++q) {
      to[q] = make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2], acc[r][4 * q + 3]);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][4 * q + u] = 0.f;
    }
    __syncthreads();
    for (int q = tid; q < kXTileN; q += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < kXTY; ++y) s += red[y * kXTileN + q];
      if (j.n0 + q < c.N) dst[(size_t)rows[r] * c.N + j.n0 + q] = s;
    }
    __syncthreads();
  }
}

// The last split of an item's (slot, tile) to finish adds the partials of
// its group's rows in split order into out (no atomic on a sum).
__device__ __forceinline__ void x_split_sums(const XCtx& c, int slot, int n0,
                                             const float* __restrict__ partials,
                                             float* __restrict__ out) {
  const int* rows = c.order + c.start[slot];
  const int G = c.start[slot + 1] - c.start[slot];
  const size_t stride = (size_t)c.A * c.N;
  for (int i = threadIdx.x; i < G * kXTileN; i += kThreads) {
    const int n = n0 + i % kXTileN;
    if (n >= c.N) continue;
    const size_t at = (size_t)rows[i / kXTileN] * c.N + n;
    float v[8], sum = 0.f;
    int sp = 0;
    for (; sp + 8 <= c.splits; sp += 8) {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __ldcg(partials + at + (sp + q) * stride);
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += v[q];
    }
    for (; sp < c.splits; ++sp) sum += __ldcg(partials + at + sp * stride);
    out[at] = sum;
  }
}

// The routing, built by every block from the ids in device memory: each
// expert's first row, the distinct experts in order of their first rows
// (slot j is the j-th), and every slot's rows in row order.  An id outside
// [0, E) makes its row NaN (written by block 0).  Returns the slot count.
__device__ int x_route(const long long* __restrict__ expert_ids, float* __restrict__ out,
                       const XLayout& l, unsigned char* smem, int A, int N, int E) {
  __shared__ int s_count;
  int* ids = reinterpret_cast<int*>(smem + l.ids);
  int* first = reinterpret_cast<int*>(smem + l.first);
  int* eslot = reinterpret_cast<int*>(smem + l.eslot);
  int* dexp = reinterpret_cast<int*>(smem + l.dexp);
  int* start = reinterpret_cast<int*>(smem + l.start);
  int* order = reinterpret_cast<int*>(smem + l.order);
  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  if (A <= 32) {                            // one warp, in registers
    if (tid < 32) {
      const long long v = lane < A ? expert_ids[lane] : -1;
      const int id = (v >= 0 && v < E) ? (int)v : -1;
      if (lane < A) ids[lane] = id;
      const unsigned same = __match_any_sync(0xffffffffu, id);   // the rows of my expert
      const int lead = __ffs(same) - 1;                          // its first row
      const bool is_first = id >= 0 && lane == lead;
      const unsigned firsts = __ballot_sync(0xffffffffu, is_first);
      int incl = is_first ? __popc(same) : 0;                    // rows of the slots up to mine
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const int from = incl - (is_first ? __popc(same) : 0);
      const int at = __shfl_sync(0xffffffffu, from, lead);
      if (is_first) {
        dexp[__popc(firsts & below)] = id;
        start[__popc(firsts & below)] = from;
      }
      if (id >= 0) order[at + __popc(same & below)] = lane;
      const unsigned routed = __ballot_sync(0xffffffffu, id >= 0);
      if (lane == 0) {
        s_count = __popc(firsts);
        start[__popc(firsts)] = __popc(routed);
      }
    }
    __syncthreads();
    if (blockIdx.x == 0) {
      for (int r = 0; r < A; ++r)
        if (ids[r] < 0)
          for (int n = tid; n < N; n += kThreads) out[(size_t)r * N + n] = __int_as_float(0x7fc00000);
    }
    return s_count;
  }
  for (int r = tid; r < A; r += kThreads) {
    const long long id = expert_ids[r];
    ids[r] = (id >= 0 && id < E) ? (int)id : -1;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int r = 0; r < A; ++r)
      if (ids[r] < 0)
        for (int n = tid; n < N; n += kThreads) out[(size_t)r * N + n] = __int_as_float(0x7fc00000);
  }
  if (tid < 32) {                           // the rest in one warp
    for (int i = lane; i < E; i += 32) first[i] = A;
    for (int i = lane; i <= A; i += 32) start[i] = 0;
    __syncwarp();
    for (int r = lane; r < A; r += 32)
      if (ids[r] >= 0) atomicMin(&first[ids[r]], r);
    __syncwarp();
    int d = 0;                              // slots, in order of first rows
    for (int b = 0; b < A; b += 32) {
      const int r = b + lane;
      const bool is_first = r < A && ids[r] >= 0 && first[ids[r]] == r;
      const unsigned m = __ballot_sync(0xffffffffu, is_first);
      if (is_first) {
        const int j = d + __popc(m & below);
        eslot[ids[r]] = j;
        dexp[j] = ids[r];
      }
      d += __popc(m);
    }
    __syncwarp();
    for (int r = lane; r < A; r += 32)      // rows a slot, at start[slot + 1]
      if (ids[r] >= 0) atomicAdd(&start[eslot[ids[r]] + 1], 1);
    __syncwarp();
    int carry = 0;                          // start[j]: the rows of the slots before j
    for (int b = 1; b <= d; b += 32) {
      const int i = b + lane;
      int v = i <= d ? start[i] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (i <= d) start[i] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();
    for (int j = lane; j < d; j += 32) first[j] = start[j];   // each slot's next place
    __syncwarp();
    for (int b = 0; b < A; b += 32) {      // the rows, each slot's in row order
      const int r = b + lane;
      const int j = r < A && ids[r] >= 0 ? eslot[ids[r]] : -1;
      const unsigned m = __match_any_sync(0xffffffffu, j);
      if (j >= 0) order[first[j] + __popc(m & below)] = r;
      __syncwarp();
      if (j >= 0 && lane == 31 - __clz(m)) first[j] += __popc(m);
      __syncwarp();
    }
    if (lane == 0) s_count = d;
  }
  __syncthreads();
  return s_count;
}
#ifdef MX_EXPERT_PHASE_CLOCK
__device__ long long g_expert_phases[1024][8];
#endif

// Each block builds the routing, then walks its items' steps through the
// ring, kXStages - 1 steps in flight ahead of the one computed, across the
// ends of passes and items.  Thread 0 issues the copies of a stage once
// its 8 warps have arrived on its empty barrier; a warp waits only for the
// stage it computes (its full barrier), so no barrier holds the block
// between the ends of passes.  An item's split ticket is taken when the
// item ends and read at the next pass's end, where the block is together.
template <bool kStagedCodes>
__global__ void __launch_bounds__(kThreads, 2)
mxint4_expert_gemv_kernel(const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_c,
                          const __grid_constant__ CUtensorMap tm_x,
                          const uint8_t* __restrict__ exps,
                          const long long* __restrict__ expert_ids, float* __restrict__ out,
                          float* __restrict__ partials, int* __restrict__ tickets, int A,
                          int N, int K, int E, int k_per, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_last[2];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const XLayout l = x_layout(A, E);
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < kXStages) {
    mbar_init(smem_u32(smem + l.bar) + 8 * tid, 1);
    mbar_init(smem_u32(smem + l.bar) + 8 * (kXStages + tid), kThreads / 32);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#ifdef MX_EXPERT_PHASE_CLOCK
  long long p_t0 = clock64(), p_wait = 0, p_step = 0, p_pass = 0, p_mark, p_n = 0, p_g0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(p_g0));
#endif
  const int slots = x_route(expert_ids, out, l, smem, A, N, E);
#ifdef MX_EXPERT_PHASE_CLOCK
  const long long p_route = clock64() - p_t0;
#endif
  XCtx c;
  c.tm_w = &tm_w;
  c.tm_c = &tm_c;
  c.tm_x = &tm_x;
  c.exps = exps;
  c.smem = smem;
  c.full = smem_u32(smem + l.bar);
  c.empty = c.full + 8 * kXStages;
  c.dexp = reinterpret_cast<const int*>(smem + l.dexp);
  c.start = reinterpret_cast<const int*>(smem + l.start);
  c.order = reinterpret_cast<const int*>(smem + l.order);
  c.A = A;
  c.N = N;
  c.K = K;
  c.k_per = k_per;
  c.tiles = (N + kXTileN - 1) / kXTileN;
  c.splits = splits;
  c.items = slots * c.tiles * splits;

  XJob in, cur;                             // `in` is thread 0's: the copies' cursor
  x_job_first(cur, c);
  if (tid == 0) {
    x_job_first(in, c);
    for (int s = 0; s < kXStages - 1 && in.w < c.items; ++s) {
      x_issue<kStagedCodes>(c, in, s);
      x_job_next(in, c);
    }
  }
  float acc[kXPass][kXCols];
#pragma unroll
  for (int r = 0; r < kXPass; ++r)
#pragma unroll
    for (int q = 0; q < kXCols; ++q) acc[r][q] = 0.f;

  const int tt = kThreads - 1;              // the ticket's thread (it issues no copy)
  int pending = 0, turn = 0, ticket = 0, old = 0, pend_slot = 0, pend_n0 = 0;
  for (int n = 0; cur.w < c.items; ++n) {
    const int st = n % kXStages;
#ifdef MX_EXPERT_PHASE_CLOCK
    p_mark = clock64();
#endif
    if (tid == 0 && in.w < c.items) {       // step n + kXStages - 1, into step n - 1's stage
      const int m = n + kXStages - 1, sm = m % kXStages;
      if (n > 0) mbar_wait(c.empty + 8 * sm, ((n - 1) / kXStages) & 1);
      x_issue<kStagedCodes>(c, in, sm);
      x_job_next(in, c);
    }
    mbar_wait(c.full + 8 * st, (n / kXStages) & 1);   // step n's copies
#ifdef MX_EXPERT_PHASE_CLOCK
    { const long long t = clock64(); p_wait += t - p_mark; p_mark = t; ++p_n; }
#endif
    switch (cur.R) {
      case 1: x_step<1, kStagedCodes>(c, cur, st, acc); break;
      case 2: x_step<2, kStagedCodes>(c, cur, st, acc); break;
      default: x_step<3, kStagedCodes>(c, cur, st, acc); break;
    }
#ifdef MX_EXPERT_PHASE_CLOCK
    { const long long t = clock64(); p_step += t - p_mark; p_mark = t; }
#endif
    if (cur.t == cur.steps - 1) {           // the pass's last step
      if (pending && tid == tt) s_last[turn & 1] = (old == splits - 1);
      float* dst = splits > 1 ? partials + (size_t)cur.split * A * N : out;
      switch (cur.R) {
        case 1: x_pass_sums<1>(c, cur, st, acc, dst); break;
        case 2: x_pass_sums<2>(c, cur, st, acc, dst); break;
        default: x_pass_sums<3>(c, cur, st, acc, dst); break;
      }
      if (pending) {                        // the last item's ticket, read
        if (s_last[turn & 1]) {
          __threadfence();
          x_split_sums(c, pend_slot, pend_n0, partials, out);
          if (tid == tt) tickets[ticket] = 0;
        }
        pending = 0;
        ++turn;
      }
      if (splits > 1 && cur.pass == cur.passes - 1) {
        // This item's partials are stored (the barrier ending the pass's
        // sums); one thread publishes them at device scope with its ticket.
        pending = 1;
        ticket = cur.slot * c.tiles + cur.n0 / kXTileN;
        pend_slot = cur.slot;
        pend_n0 = cur.n0;
        if (tid == tt) {
          __threadfence();
          old = atomicAdd(&tickets[ticket], 1);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(c.empty + 8 * st);   // this warp is done with stage st
#ifdef MX_EXPERT_PHASE_CLOCK
    p_pass += clock64() - p_mark;
#endif
    x_job_next(cur, c);
  }
  if (pending) {                            // the last item's ticket
    if (tid == tt) s_last[turn & 1] = (old == splits - 1);
    __syncthreads();
    if (s_last[turn & 1]) {
      __threadfence();
      x_split_sums(c, pend_slot, pend_n0, partials, out);
      if (tid == tt) tickets[ticket] = 0;
    }
  }
#ifdef MX_EXPERT_PHASE_CLOCK
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < 1024) {
    long long* d = g_expert_phases[blockIdx.x];
    d[0] = p_route; d[1] = p_wait; d[2] = p_step; d[3] = p_pass; d[4] = p_n;
    d[5] = clock64() - p_t0;
    d[6] = p_g0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(d[7]));
  }
#endif
}

// A [rows, row_bytes] uint8 operand as a 2-D TMA map of [64 rows x box]
// tiles, out-of-bounds bytes zero.
CUresult x_encode(CUtensorMap* map, const void* ptr, long long rows, int row_bytes, int box) {
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t boxes[2] = {(cuuint32_t)box, (cuuint32_t)kXStep};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                                dims, strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encoder failures are returned as 10000 + CUresult, launch failures as the
// cudaError.
template <bool kStagedCodes>
int expert_launch(const void* x, const void* packed, const void* exps, const void* ids,
                  void* out, void* partials, void* tickets, int A, int N, int K, int x_pitch,
                  int E, int k_per, int splits, int blocks, cudaStream_t stream) {
  const XLayout l = x_layout(A, E);
  static int configured = 0;
  if (l.bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(mxint4_expert_gemv_kernel<kStagedCodes>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           l.bytes);
    if (err != cudaSuccess) return (int)err;
    configured = l.bytes;
  }
  CUtensorMap tm_w{}, tm_c{}, tm_x{};
  CUresult r = x_encode(&tm_w, packed, (long long)E * K, N / 2, kXRowBytes);
  if (r == CUDA_SUCCESS && kStagedCodes)
    r = x_encode(&tm_c, exps, (long long)E * K, N / 32, kXCodeBytes);
  if (r == CUDA_SUCCESS) {                  // x [A, K] f32 in [1 row x 64] tiles
    const cuuint64_t dims[2] = {(cuuint64_t)x_pitch, (cuuint64_t)A};
    const cuuint64_t strides[1] = {(cuuint64_t)x_pitch * 4};
    const cuuint32_t box[2] = {(cuuint32_t)kXStep, 1};
    const cuuint32_t elem[2] = {1, 1};
    r = cuTensorMapEncodeTiled(&tm_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x),
                               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  mxint4_expert_gemv_kernel<kStagedCodes><<<blocks, kThreads, l.bytes, stream>>>(
      tm_w, tm_c, tm_x, (const uint8_t*)exps,
      (const long long*)ids, (float*)out, (float*)partials, (int*)tickets, A, N, K, E, k_per,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef MX_EXPERT_PHASE_CLOCK
extern "C" int mxint4_expert_phases_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_expert_phases, sizeof(g_expert_phases));
}
#endif

// y[A, N] = row a of x[A, K] times expert expert_ids[a] of the stacks, K in
// splits runs of k_per rows (the wrapper's `mxint4_expert_plan`), on
// `blocks` persistent blocks.  x's rows come as TMA tiles: x is 16-byte
// aligned, its rows x_pitch floats apart (a multiple of 4, zeros past K).
// partials holds [splits, A, N] floats when
// splits > 1; tickets at least min(A, E) * ceil(N / 512) zeros.  The codes
// are copied with the mantissas (16 bytes a K row) where N is a multiple of
// 512 and exps 16-byte aligned, and read in place otherwise.
extern "C" int mxint4_expert_matmul_launch(const void* x, const void* packed,
                                           const void* exps, const void* expert_ids,
                                           void* out, void* partials, void* tickets, int A,
                                           int N, int K, int x_pitch, int E, int k_per,
                                           int splits, int blocks, void* stream) {
  if (A <= 0 || N <= 0 || K <= 0 || E <= 0 || N % 32 || x_pitch < K || x_pitch % 4 ||
      k_per <= 0 || k_per % kXStep || splits != (K + k_per - 1) / k_per || blocks <= 0 ||
      (reinterpret_cast<uintptr_t>(packed) & 15) || (reinterpret_cast<uintptr_t>(x) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N % kXTileN == 0 && (reinterpret_cast<uintptr_t>(exps) & 15) == 0)
    return expert_launch<true>(x, packed, exps, expert_ids, out, partials, tickets, A, N, K,
                               x_pitch, E, k_per, splits, blocks, s);
  return expert_launch<false>(x, packed, exps, expert_ids, out, partials, tickets, A, N, K,
                              x_pitch, E, k_per, splits, blocks, s);
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
