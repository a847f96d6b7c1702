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
// (a given `scale` multiplies instead of dividing by sqrt(d)).  K and V
// arrive in the reference's [B, C, KV, d] layout, each in one of five cache
// formats (template parameters, K and V independent): f32, bf16, legacy int8
// (q / 32), int8_tok (q * s per row) and mxint4_blk (packed nibbles times
// 2^(e - 2) per 16 values).  Every value is dequantized exactly as
// `kvq.decode` does, once per element for all the block's query heads.
//
// What bounds it on the H100: bytes.  Each cache byte feeds about 2G / elem
// operations, so the floor is the kv_len rows of K and V (and their side
// data) over 3.35 TB/s: about 2.6 us per layer for an f32 cache at kv_len
// 528, B = 2, KV = 8, d = 128, and 0.67 / 0.36 us for int8_tok / mxint4_blk.
// At that size a launch is a chain of latencies more than a stream of bytes,
// so the design keeps the chain short:
//   * the grid is (splits, KV * G-chunks, B), fixed by the capacity C as the
//     reference's grid is.  A block of 4 warps owns one (b, h), 4 of its
//     query heads, and an even share of the C rows' 16-row tiles, chosen by
//     the wrapper's planner (`hopper.flash_decode_plan`) for about two
//     blocks per SM.  kv_len is read from device memory, once per block, so
//     one launch (or one captured graph) serves every position: a block
//     streams the tiles of its share below kv_len, and rows at or past
//     kv_len are never read.  kv_len is one length for the batch or one per
//     lane (block (., ., b) reads lane b's: a scheduler's slot class, whose
//     lanes sit at different positions, as the reference's kernel runs
//     under vmap); nothing else depends on it.  A block whose share starts at or past kv_len
//     streams nothing and still writes its (empty) partial and takes its
//     ticket, so that the merge always fires;
//   * its tiles stream through a 2-4 stage ring in shared memory filled by
//     cp.async in 16-byte chunks (the narrow side rows, an int8_tok scale or
//     a few mxint4 exponent bytes, in chunks of their own width).  Each warp
//     copies one array (K, V and their side data), so that their first
//     touches, cold after the rest of a decode step, overlap; a thread's
//     chunks are fixed for the launch, so no division runs per tile.  The
//     ring's wait is the only block-wide barrier of the loop;
//   * each warp owns 4 rows of every tile.  A lane holds 4 consecutive
//     elements of each 128-wide slot of a row: it dequantizes them from one
//     vector read of shared memory (16 bytes of f32, 4 of int8, 2 of
//     nibbles) and forms its part of the 16 (row, head) scores against the
//     query in registers.  A reduce-scatter of 16 shuffles completes them,
//     one score per lane pair, so each lane scales and exponentiates one
//     score and keeps one head's online-softmax state (m, l), with the
//     reference's finite-max guard; the lanes then share p and the rescale
//     factors for P.V into acc[G, dv] in registers.  The tile's code has no
//     branch, so the shuffle chains of its rows and heads interleave;
//   * at the end of its range the block merges its warps' states in shared
//     memory in warp order; with more than one split, it writes the result
//     as a partial (m, l, acc), and the last block of its (b, h) to finish
//     (an acquire-release ticket) brings every partial into shared memory
//     in one round of cp.async and merges them in split order.  The order
//     of every sum is fixed, so two launches are bit-equal.
// The kernel allocates nothing: the wrapper passes the workspace and the
// ticket counters (zero on entry, reset to zero by the merging block), and
// the ring's layout, which the planner owns; the launch only checks it.
//
// Built with -DFD_PHASE_CLOCK (tools/fd_phase_clock.py), thread 0 of every
// block stamps clock64 and the global timer at each phase boundary into a
// buffer set by flash_decode_set_stamps.
//
// The MLA two-stream mode (`flash_decode_mla_kernel`, below the GQA mode)
// is the reference's `two_stream` branch: absorbed latent queries against
// one shared latent cache that is both K and V, plus a rope score stream,
// on the tensor cores.  Its design notes are at the kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;               // cache rows per ring stage
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kTile / kWarps;   // rows of a stage per warp
constexpr int kGroup = 4;               // query heads per block (a G-chunk)
constexpr int kSlot = 128;              // elements per lane slot: 4 per lane
constexpr int kMaxDim = 256;            // head dims d, dv
constexpr int kMaxGroup = 16;           // query heads per kv head
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 226 * 1024;    // dynamic shared memory per block (of 227 KB)

enum Fmt { kF32 = 0, kBF16 = 1, kInt8Legacy = 2, kInt8Tok = 3, kMxint4Blk = 4 };

// Bytes of one cache row of `dim` elements: values, and side data (the
// int8_tok scale, the mxint4_blk exponents).
int value_bytes(int f, int dim) {
  return f == kF32 ? 4 * dim : f == kBF16 ? 2 * dim : f == kMxint4Blk ? dim / 2 : dim;
}
int side_bytes(int f, int dim) {
  return f == kInt8Tok ? 4 : f == kMxint4Blk ? dim / 16 : 0;
}

#ifdef FD_PHASE_CLOCK
constexpr int kPhases = 6;   // entry, first tile, loop end, block merged, ticket, split merge
long long* g_stamps = nullptr;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define FD_STAMP(i)                                                  \
  do {                                                               \
    if (tid == 0) {                                                  \
      p.stamps[stamp0 + (i)] = clock64();                            \
      p.stamps[stamp0 + kPhases + (i)] = global_ns();                \
    }                                                                \
  } while (0)
#else
#define FD_STAMP(i) do {} while (0)
#endif

struct Params {
  const float* q;                        // [B, KV, G, d]
  const unsigned char *k0, *k1, *v0, *v1;  // values and side data of K and V
  float* out;                            // [B, KV, G, dv]
  float* part_acc;                       // [units][splits][kGroup][dv]
  float* part_ml;                        // [units][splits][2][kGroup]
  int* tickets;                          // [units]
  const int* kv_len;                     // device: the rows to attend over, per lane
  int kv_stride;                         // lane b reads kv_len[b * kv_stride] (0: a scalar)
  int C, KV, G, d, dv;
  int tiles, splits, gchunks, stages;
  int kb, ks, vb, vs;                    // row bytes: K values, K side, V values, V side
  int off_v, off_ks, off_vs, stage_bytes;   // shared-memory layout of a stage
  float scale;
  int scale_is_div;
#ifdef FD_PHASE_CLOCK
  long long* stamps;                     // [blocks][2 * kPhases]
#endif
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(W) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Wait until the oldest tile of a ring of `stages` has landed (this
// thread's copies; the barrier after it covers everyone's).
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4) cp_async_wait<2>();
  else if (stages == 3) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// Copier t's share of copying one array's tile (of `threads` copiers, 32 or
// 64), fixed for the launch: its first chunk (row r, chunk c of the row's
// `chunks`, at most 64) and the step to its next (`threads` chunks: dq rows
// and dr chunks), packed in one word, so that no division runs per tile.  A
// power-of-two chunk count (every main-path row) takes shifts.
__device__ __forceinline__ unsigned copy_plan(int chunks, int t, int threads) {
  int r, c, dq, dr;
  if ((chunks & (chunks - 1)) == 0) {
    const int sh = __ffs(chunks) - 1;
    r = t >> sh, c = t & (chunks - 1), dq = threads >> sh, dr = threads & (chunks - 1);
  } else {
    r = t / chunks, c = t % chunks, dq = threads / chunks, dr = threads % chunks;
  }
  return min(r, 255) | c << 8 | min(dq, 255) << 16 | (unsigned)dr << 24;
}

// Copy the first `rows` rows of one array's tile in chunks of W bytes: row r
// lies at src + r * pitch in device memory and goes to dst + r * rb.  W = 2
// has no cp.async form: those copies go through registers.
template <int W>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const unsigned char* src,
                                          int rb, int pitch, int rows, unsigned plan) {
  const int chunks = rb / W, dq = (plan >> 16) & 0xff, dr = plan >> 24;
  int r = plan & 0xff, c = (plan >> 8) & 0xff;
  if (dr == 0) {           // the chunk count divides the copiers': c is fixed
    dst += c * W;
    src += c * W;
#pragma unroll 4
    for (; r < rows; r += dq) {
      if constexpr (W == 2) {
        *reinterpret_cast<unsigned short*>(dst + r * rb) =
            __ldg(reinterpret_cast<const unsigned short*>(src + (size_t)r * pitch));
      } else {
        cp_async<W>(dst + r * rb, src + (size_t)r * pitch);
      }
    }
    return;
  }
  while (r < rows) {
    unsigned char* to = dst + r * rb + c * W;
    const unsigned char* from = src + (size_t)r * pitch + c * W;
    if constexpr (W == 2) {
      *reinterpret_cast<unsigned short*>(to) =
          __ldg(reinterpret_cast<const unsigned short*>(from));
    } else {
      cp_async<W>(to, from);
    }
    r += dq;
    c += dr;
    if (c >= chunks) {
      c -= chunks;
      ++r;
    }
  }
}

// Side rows (an int8_tok scale, or d / 16 mxint4 exponent bytes) go in
// chunks of the largest of 16, 8, 4, 2 bytes that divides them; the wrapper
// checks the base's alignment to the same width.
__device__ __forceinline__ int side_width(int rb) {
  return rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : rb % 4 == 0 ? 4 : 2;
}

// Elements e0 .. e0 + 3 of one cache row in shared memory, dequantized to
// f32 exactly as `kvq.decode` does.  `side` is the row's side data.
template <int F>
__device__ __forceinline__ void dequant4(const unsigned char* row, const unsigned char* side,
                                         int e0, float v[4]) {
  if constexpr (F == kF32) {
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * e0);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (F == kBF16) {
    const uint2 x = *reinterpret_cast<const uint2*>(row + 2 * e0);
    v[0] = __uint_as_float(x.x << 16);
    v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16);
    v[3] = __uint_as_float(x.y & 0xffff0000u);
  } else if constexpr (F == kInt8Legacy || F == kInt8Tok) {
    const unsigned x = *reinterpret_cast<const unsigned*>(row + e0);
    // legacy: q / 32 (exact as a multiply); int8_tok: q * s, one multiply.
    const float s = F == kInt8Tok ? *reinterpret_cast<const float*>(side) : 0.03125f;
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = (float)((int)(x << (24 - 8 * c)) >> 24) * s;
  } else {
    // Two bytes hold elements e0 .. e0 + 3, low nibble first; the four share
    // the exponent of their group of 16.  2^(e - 2) comes from the bits (e in
    // [-9, 5]), and m * 2^(e - 2) is exact.
    const unsigned x = *reinterpret_cast<const unsigned short*>(row + e0 / 2);
    const int e = static_cast<signed char>(side[e0 >> 4]);
    const float sc = __int_as_float((e - 2 + 127) << 23);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = (float)((int)(x << (28 - 4 * c)) >> 28) * sc;
  }
}

// Add one to a ticket counter with acquire-release semantics at GPU scope;
// returns the count before.
__device__ __forceinline__ int ticket_acq_rel(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// One step of a warp's reduce-scatter of 2H scores per lane: lanes L and
// L ^ 2H swap halves, each keeps the sum of the half its bit 2H selects, and
// the next step halves again.  H is a template parameter so that every index
// is a constant and the scores stay in registers.
template <int H>
__device__ __forceinline__ void halve_scores(float* x, int lane) {
  const bool upper = lane & (2 * H);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? x[k] : x[k + H];
    const float keep = upper ? x[k + H] : x[k];
    x[k] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
  if constexpr (H > 1) halve_scores<H / 2>(x, lane);
}

template <int KF, int VF, int NS>
__global__ void __launch_bounds__(kThreads, 4) flash_decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  constexpr int GB = kGroup;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, splits = p.splits;
  const int h = p.gchunks == 1 ? blockIdx.y : blockIdx.y / p.gchunks;
  const int gc = blockIdx.y - h * p.gchunks, b = blockIdx.z;
  const int g0 = gc * GB, gn = min(GB, p.G - g0);
  const int bh = b * p.KV + h;
  const int unit = bh * p.gchunks + gc;
  // This split's tiles: an even share of the C rows' tiles (the first
  // tiles % splits splits take one more), streamed up to kv_len; a share
  // that starts at or past kv_len streams none.
  const int lo = p.tiles / splits, extra = p.tiles - lo * splits;
  const int t_beg = split * lo + min(split, extra);
  const int r_beg = t_beg * kTile;
  const int kv_len = min(max(p.kv_len[(size_t)b * p.kv_stride], 0), p.C);
  const int r_end = min(kv_len, r_beg + (lo + (split < extra)) * kTile);
  const int n_tiles = r_end > r_beg ? (r_end - r_beg + kTile - 1) / kTile : 0;
  const size_t base = (size_t)b * p.C * p.KV + h;
#ifdef FD_PHASE_CLOCK
  const size_t stamp0 =
      ((blockIdx.z * gridDim.y + blockIdx.y) * (size_t)gridDim.x + blockIdx.x) * 2 * kPhases;
#endif
  FD_STAMP(0);

  // This lane's elements of the block's query rows (loaded first, so their
  // latency overlaps the copies), and its accumulators.
  float qr[GB][NS][4], acc[GB][NS][4];
  const float* qb = p.q + ((size_t)bh * p.G + g0) * p.d;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      const int e0 = sl * kSlot + 4 * lane;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < gn && e0 < p.d) x = *reinterpret_cast<const float4*>(qb + g * p.d + e0);
      qr[g][sl][0] = x.x; qr[g][sl][1] = x.y; qr[g][sl][2] = x.z; qr[g][sl][3] = x.w;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][sl][c] = 0.f;
    }
  }
  constexpr bool kKSide = KF == kInt8Tok || KF == kMxint4Blk;
  constexpr bool kVSide = VF == kInt8Tok || VF == kMxint4Blk;
  // Each warp copies one array, so that the first touches of the arrays
  // (cold lines and address translations) overlap instead of queuing in
  // every warp: warp 0 copies K's values, warp 1 V's, warp 2 K's side data
  // or else K's values with warp 0, warp 3 V's side data or else V's values.
  const int arr = (warp == 2 && kKSide) ? 2 : (warp == 3 && kVSide) ? 3 : (warp & 1);
  const bool pair = (arr == 0 && !kKSide) || (arr == 1 && !kVSide);
  const unsigned char* csrc = arr == 0 ? p.k0 : arr == 1 ? p.v0 : arr == 2 ? p.k1 : p.v1;
  const int crb = arr == 0 ? p.kb : arr == 1 ? p.vb : arr == 2 ? p.ks : p.vs;
  const int coff = arr == 0 ? 0 : arr == 1 ? p.off_v : arr == 2 ? p.off_ks : p.off_vs;
  const int cw = arr < 2 ? 16 : side_width(crb);
  const unsigned plan = copy_plan(crb >> (__ffs(cw) - 1), pair ? (warp >> 1) * 32 + lane : lane,
                                  pair ? 64 : 32);
  // Tile t goes to ring stage `stage`.
  auto issue = [&](int t, int stage) {
    const int r0 = r_beg + t * kTile, rows = min(kTile, r_end - r0);
    unsigned char* dst = smem + stage * p.stage_bytes + coff;
    const unsigned char* src = csrc + (base + (size_t)r0 * p.KV) * crb;
    const int pitch = p.KV * crb;
    switch (cw) {
      case 16: copy_tile<16>(dst, src, crb, pitch, rows, plan); break;
      case 8: copy_tile<8>(dst, src, crb, pitch, rows, plan); break;
      case 4: copy_tile<4>(dst, src, crb, pitch, rows, plan); break;
      default: copy_tile<2>(dst, src, crb, pitch, rows, plan);
    }
  };

  // The first stages - 1 tiles go in flight before anything else.
  for (int t = 0; t < p.stages - 1; ++t) {
    if (t < n_tiles) issue(t, t);
    cp_async_commit();
  }

  // A warp's tile yields kV = 4 rows x 4 heads scores, (row i, head g) at
  // v = 4 i + g.  After their reduce-scatter lane L holds score v = L >> 1:
  // row L >> 3 (lane bits 3 and 4) and head (L >> 1) & 3.  The lane keeps
  // the online-softmax state (m, l) of that head.
  constexpr int kV = kRows * GB;
  static_assert(kV == 16 && kRows == 4, "the lane layout below is for 4 x 4 scores");
  const int my_row = lane >> 3, my_head = (lane >> 1) & 3;
  float m_own = -INFINITY, l_own = 0.f;

  const float sqrt_d = sqrtf((float)p.d);

  int rd = 0, wr = p.stages - 1;     // ring stages read and written next
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_ring(p.stages);
    __syncthreads();       // tile t landed; every warp is done with tile t - 1
    if (t == 0) FD_STAMP(1);
    if (t + p.stages - 1 < n_tiles) issue(t + p.stages - 1, wr);
    cp_async_commit();
    wr = wr + 1 == p.stages ? 0 : wr + 1;

    const unsigned char* st = smem + rd * p.stage_bytes;
    rd = rd + 1 == p.stages ? 0 : rd + 1;
    const int r0 = r_beg + t * kTile;
    // Partial scores of this warp's rows for every head (a head past G has
    // a zero query).  A row at or past r_end holds stale shared memory: its
    // score is masked to -inf and its V row to 0.  The code has no branch.
    float x[kV];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int lr = warp + kWarps * i;
#pragma unroll
      for (int g = 0; g < GB; ++g) x[i * GB + g] = 0.f;
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) {
        const int e0 = sl * kSlot + 4 * lane;
        if (e0 < p.d) {
          float kv[4];
          dequant4<KF>(st + lr * p.kb, st + p.off_ks + lr * p.ks, e0, kv);
#pragma unroll
          for (int g = 0; g < GB; ++g)
#pragma unroll
            for (int c = 0; c < 4; ++c) x[i * GB + g] = fmaf(qr[g][sl][c], kv[c], x[i * GB + g]);
        }
      }
    }
    // Reduce-scatter over the warp: the distances 16, 8, 4, 2 each halve the
    // scores a lane carries, distance 1 sums the one left.  Every lane
    // holding score v ends with the same bits (a + b == b + a).
    halve_scores<kV / 2>(x, lane);
    x[0] += __shfl_xor_sync(0xffffffffu, x[0], 1);
    const bool valid = r0 + warp + kWarps * my_row < r_end;
    const float xs = valid ? (p.scale_is_div ? x[0] / sqrt_d : x[0] * p.scale) : -INFINITY;

    // Online softmax of this lane's head over the warp's 4 rows of the tile
    // (lanes L ^ 8, L ^ 16, L ^ 24), with the reference's finite-max guard.
    float mt = fmaxf(xs, __shfl_xor_sync(0xffffffffu, xs, 8));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
    const float m_new = fmaxf(m_own, mt);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float corr = expf(isfinite(m_own) ? m_own - m_safe : -INFINITY);
    const float pv = expf(xs - m_safe);                // masked rows: exp(-inf) = 0
    float ps = pv + __shfl_xor_sync(0xffffffffu, pv, 8);
    ps += __shfl_xor_sync(0xffffffffu, ps, 16);
    l_own = l_own * corr + ps;
    m_own = m_new;

    // P.V over this lane's columns, with every score's p and every head's
    // corr (score v's lanes are 2v, 2v + 1; head g's row-0 lane is 2g).
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float cg = __shfl_sync(0xffffffffu, corr, 2 * g);
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][sl][c] *= cg;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int lr = warp + kWarps * i;
      const bool row_valid = r0 + lr < r_end;
      float pr[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) pr[g] = __shfl_sync(0xffffffffu, pv, 2 * (i * GB + g));
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) {
        const int e0 = sl * kSlot + 4 * lane;
        if (e0 < p.dv) {
          float vv[4];
          dequant4<VF>(st + p.off_v + lr * p.vb, st + p.off_vs + lr * p.vs, e0, vv);
#pragma unroll
          for (int c = 0; c < 4; ++c) vv[c] = row_valid ? vv[c] : 0.f;
#pragma unroll
          for (int g = 0; g < GB; ++g)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[g][sl][c] = fmaf(pr[g], vv[c], acc[g][sl][c]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();         // the ring is free: warp states go over it
  FD_STAMP(2);

  // Per-warp states: [warp][m: GB | l: GB | acc: GB x NS * 128].
  constexpr int kDvp = NS * kSlot, kWarpState = GB * (2 + kDvp);
  float* ws = reinterpret_cast<float*>(smem);
  float* mine = ws + warp * kWarpState;
  if (my_row == 0 && (lane & 1) == 0) {            // head my_head's row-0 lane
    mine[my_head] = m_own;
    mine[GB + my_head] = l_own;
  }
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) {
      const int e0 = sl * kSlot + 4 * lane;
      if (e0 < p.dv)
        *reinterpret_cast<float4*>(mine + 2 * GB + g * kDvp + e0) =
            make_float4(acc[g][sl][0], acc[g][sl][1], acc[g][sl][2], acc[g][sl][3]);
    }
  __syncthreads();

  // Merge the warps in warp order: 4 columns of one head per item.  A block
  // that streamed no row has m = -inf and l = 0 in every warp: its weights
  // are 0 (never exp(-inf - -inf)), and it writes an empty partial.
  const int dv4 = p.dv >> 2;
  for (int i = tid; i < gn * dv4; i += kThreads) {
    const int g = i / dv4, j = (i - g * dv4) * 4;
    float mw[kWarps], M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = ws[w * kWarpState + g];
      M = fmaxf(M, mw[w]);
    }
    const float m_safe = isfinite(M) ? M : 0.f;
    float L = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* st = ws + w * kWarpState;
      const float wt = isfinite(mw[w]) ? expf(mw[w] - m_safe) : 0.f;
      L = fmaf(st[GB + g], wt, L);
      const float4 x = *reinterpret_cast<const float4*>(st + 2 * GB + g * kDvp + j);
      a.x = fmaf(x.x, wt, a.x); a.y = fmaf(x.y, wt, a.y);
      a.z = fmaf(x.z, wt, a.z); a.w = fmaf(x.w, wt, a.w);
    }
    if (splits == 1) {
      const float den = fmaxf(L, 1e-30f);
      *reinterpret_cast<float4*>(p.out + ((size_t)bh * p.G + g0 + g) * p.dv + j) =
          make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
    } else {
      const size_t slot = (size_t)unit * splits + split;
      *reinterpret_cast<float4*>(p.part_acc + (slot * GB + g) * p.dv + j) = a;
      if (j == 0) {
        p.part_ml[slot * 2 * GB + g] = M;
        p.part_ml[slot * 2 * GB + GB + g] = L;
      }
    }
  }
  FD_STAMP(3);
  if (splits == 1) return;

  // The barrier orders every thread's partial before thread 0's ticket, an
  // acquire-release atomic: its release covers them (it is cumulative), its
  // acquire makes the other splits' partials visible to this block.
  __syncthreads();
  if (tid == 0) is_last = (ticket_acq_rel(&p.tickets[unit]) == splits - 1);
  __syncthreads();
  FD_STAMP(4);
  if (!is_last) return;

  // Merge the splits in split order.  Every split's partial comes into
  // shared memory (over the warp states) in one round of 16-byte cp.async
  // from L2.  Warp g forms head g's weights exp(m_s - max_s m_s) and
  // denominator while the accumulators land, its lanes over the splits and
  // shuffles across them; then each item of 4 output columns sums its splits.
  float* pa = reinterpret_cast<float*>(smem);               // [splits][GB][dv]
  float* mls = pa + (size_t)splits * GB * p.dv;              // [splits][2][GB]
  float* wts = mls + splits * 2 * GB;                        // [splits][GB]
  float* lg = wts + splits * GB;                             // [GB]
  const float* ga = p.part_acc + (size_t)unit * splits * GB * p.dv;
  const float* gm = p.part_ml + (size_t)unit * splits * 2 * GB;
  for (int i = tid; i < splits * 2 * GB / 4; i += kThreads) cp_async<16>(mls + 4 * i, gm + 4 * i);
  cp_async_commit();
  for (int i = tid; i < splits * GB * dv4; i += kThreads) cp_async<16>(pa + 4 * i, ga + 4 * i);
  cp_async_commit();
  cp_async_wait<1>();      // the (m, l) pairs; the accumulators stay in flight
  __syncthreads();
  static_assert(kWarps == GB, "a warp per head");
  if (warp < gn) {
    float M = -INFINITY;
    for (int sp = lane; sp < splits; sp += 32) M = fmaxf(M, mls[sp * 2 * GB + warp]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    const float m_safe = isfinite(M) ? M : 0.f;
    float L = 0.f;
    for (int sp = lane; sp < splits; sp += 32) {
      const float ms = mls[sp * 2 * GB + warp];
      const float wt = isfinite(ms) ? expf(ms - m_safe) : 0.f;
      wts[sp * GB + warp] = wt;
      L = fmaf(mls[sp * 2 * GB + GB + warp], wt, L);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    if (lane == 0) lg[warp] = fmaxf(L, 1e-30f);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < gn * dv4; i += kThreads) {
    const int g = i / dv4, j = (i - g * dv4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < splits; ++sp) {
      const float wt = wts[sp * GB + g];
      const float4 x = *reinterpret_cast<const float4*>(pa + (sp * GB + g) * p.dv + j);
      a.x = fmaf(x.x, wt, a.x); a.y = fmaf(x.y, wt, a.y);
      a.z = fmaf(x.z, wt, a.z); a.w = fmaf(x.w, wt, a.w);
    }
    const float den = lg[g];
    *reinterpret_cast<float4*>(p.out + ((size_t)bh * p.G + g0 + g) * p.dv + j) =
        make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
  }
  if (tid == 0) p.tickets[unit] = 0;
  FD_STAMP(5);
}

template <int KF, int VF, int NS>
int launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<KF, VF, NS>;
  // Raise the kernel's dynamic shared-memory limit once per device, to the
  // most any launch of it has asked for so far (no host call per launch).
  // The default limit is 48 KB less the kernel's static shared memory (its
  // `is_last` flag), so a launch of exactly 48 KB needs it raised too.
  static int limit[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if ((int)smem > limit[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    limit[dev] = (int)smem;
  }
  dim3 grid(p.splits, p.KV * p.gchunks, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KF, int VF>
int launch_slots(int ns, const Params& p, int B, size_t smem, cudaStream_t s) {
  if (ns == 1) return launch<KF, VF, 1>(p, B, smem, s);
  if (ns == 2) return launch<KF, VF, 2>(p, B, smem, s);
  return (int)cudaErrorInvalidValue;
}

template <int KF>
int launch_v(int vfmt, int ns, const Params& p, int B, size_t smem, cudaStream_t s) {
  switch (vfmt) {
    case kF32: return launch_slots<KF, kF32>(ns, p, B, smem, s);
    case kBF16: return launch_slots<KF, kBF16>(ns, p, B, smem, s);
    case kInt8Legacy: return launch_slots<KF, kInt8Legacy>(ns, p, B, smem, s);
    case kInt8Tok: return launch_slots<KF, kInt8Tok>(ns, p, B, smem, s);
    case kMxint4Blk: return launch_slots<KF, kMxint4Blk>(ns, p, B, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// `tiles` = ceil(C / 16); split i owns tiles [i * lo + min(i, x), ...) with
// lo = tiles / splits, the first x = tiles % splits splits one more than
// lo, and streams those below its lane's kv_len (an int32 in device memory:
// lane b's at kv_len[b * kv_stride], kv_stride 0 for one length shared by
// the batch; read by every block and clamped to [0, C]); a block takes 4 query
// heads (G-chunks = ceil(G / 4)); `ns` 128-wide slots per row (1 or 2)
// picks the instantiation.  A ring stage holds 16 rows of K's values at
// offset 0, V's at `off_v`, K's and V's side rows at `off_ks` and `off_vs`,
// in `stage_bytes`.  `partials` holds splits * G-chunks * B * KV * 4 *
// (dv + 2) floats when splits > 1.
extern "C" int flash_decode_launch(const void* q, const void* k0, const void* k1,
                                   const void* v0, const void* v1, void* out,
                                   void* partials, void* tickets, const void* kv_len,
                                   int kv_stride, int B, int C, int KV, int G, int d, int dv, int kfmt,
                                   int vfmt, int tiles, int splits, int stages, int ns,
                                   int off_v, int off_ks, int off_vs, int stage_bytes,
                                   float scale, int scale_is_div, void* stream) {
  if (kfmt < kF32 || kfmt > kMxint4Blk || vfmt < kF32 || vfmt > kMxint4Blk)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.kb = value_bytes(kfmt, d);
  p.ks = side_bytes(kfmt, d);
  p.vb = value_bytes(vfmt, dv);
  p.vs = side_bytes(vfmt, dv);
  const int gchunks = (G + kGroup - 1) / kGroup;
  if (G < 1 || G > kMaxGroup || d < 4 || d > kMaxDim || dv < 4 || dv > kMaxDim ||
      d > ns * kSlot || dv > ns * kSlot || d % 4 || dv % 4 || p.kb % 16 || p.vb % 16 ||
      p.ks % 2 || p.vs % 2 || C < 1 || kv_len == nullptr || kv_stride < 0 ||
      tiles != (C + kTile - 1) / kTile || splits < 1 || splits > tiles ||
      stages < 2 || stages > kMaxStages || ns < 1 || ns > 2)
    return (int)cudaErrorInvalidValue;
  // Every array's tile fits its place in the stage, 16-byte aligned.
  if (off_v % 16 || off_ks % 16 || off_vs % 16 || stage_bytes % 16 ||
      off_v < kTile * p.kb || off_ks < off_v + kTile * p.vb ||
      off_vs < off_ks + kTile * p.ks || stage_bytes < off_vs + kTile * p.vs)
    return (int)cudaErrorInvalidValue;
  p.off_v = off_v;
  p.off_ks = off_ks;
  p.off_vs = off_vs;
  p.stage_bytes = stage_bytes;
  const int warp_states = kWarps * kGroup * (2 + ns * kSlot) * (int)sizeof(float);
  const long long ring = (long long)stages * p.stage_bytes;
  const long long ring_bytes = ring > warp_states ? ring : warp_states;
  // The last block of a (b, h) brings every split's partial (dv + 2 values
  // per head) into shared memory, with a weight per split and head.
  const long long merge = (long long)sizeof(float) * kGroup * ((long long)splits * (dv + 3) + 1);
  const size_t smem = (size_t)(merge > ring_bytes ? merge : ring_bytes);
  if (ring > kMaxSmem || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  p.q = static_cast<const float*>(q);
  p.k0 = static_cast<const unsigned char*>(k0);
  p.k1 = static_cast<const unsigned char*>(k1);
  p.v0 = static_cast<const unsigned char*>(v0);
  p.v1 = static_cast<const unsigned char*>(v1);
  p.out = static_cast<float*>(out);
  const size_t units = (size_t)B * KV * gchunks;
  p.part_acc = static_cast<float*>(partials);
  p.part_ml = p.part_acc + units * splits * kGroup * dv;
  p.tickets = static_cast<int*>(tickets);
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_stride = kv_stride;
  p.C = C; p.KV = KV; p.G = G; p.d = d; p.dv = dv;
  p.tiles = tiles; p.splits = splits; p.gchunks = gchunks; p.stages = stages;
  p.scale = scale;
  p.scale_is_div = scale_is_div;
#ifdef FD_PHASE_CLOCK
  p.stamps = g_stamps;
#endif
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kfmt) {
    case kF32: return launch_v<kF32>(vfmt, ns, p, B, smem, s);
    case kBF16: return launch_v<kBF16>(vfmt, ns, p, B, smem, s);
    case kInt8Legacy: return launch_v<kInt8Legacy>(vfmt, ns, p, B, smem, s);
    case kInt8Tok: return launch_v<kInt8Tok>(vfmt, ns, p, B, smem, s);
    case kMxint4Blk: return launch_v<kMxint4Blk>(vfmt, ns, p, B, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef FD_PHASE_CLOCK
// The stamp buffer of later launches: 2 * 6 int64 per block.
extern "C" void flash_decode_set_stamps(void* stamps) {
  g_stamps = static_cast<long long*>(stamps);
}
#endif

extern "C" int flash_decode_tile_rows() { return kTile; }
extern "C" int flash_decode_max_dim() { return kMaxDim; }
extern "C" int flash_decode_max_group() { return kMaxGroup; }
extern "C" int flash_decode_max_stages() { return kMaxStages; }

// ---------------------------------------------------------------------------
// MLA two-stream mode: deepseek-v3's absorbed decode attention.
//
// Replaces the `two_stream` branch of `flash_decode_pallas`'s kernel body
// (src/repro/kernels/flash_decode.py, `_kernel`).  For each batch lane b and
// query head h, over the latent cache rows t < kv_len:
//
//     s[h, t] = (q[b, h, :] . L[b, t, :] + q2[b, h, :] . R[b, t, :]) * scale
//     out[b, h, :] = softmax_t(s[h, :]) @ L[b, :kv_len, :]
//
// q [B, H, r] is the absorbed latent query, q2 [B, H, dr] the rope query,
// L [B, C, r] the latent cache (K and V at once) and R [B, C, dr] the shared
// rope key, both in one cache format, dequantized as `kvq.decode` does.
//
// After absorption one batch lane is two matrix products with the query
// heads as rows: S = [Q | Q2] [L | R]^T (M = H, N = kv_len, K = r + dr) and
// O = softmax(S) L (M = H, N = r, K = kv_len).  Both run on the tensor cores
// as mma.sync m16n8k8 TF32 in split precision (csrc/tf32.cuh):
//   * f32 cache: 3xTF32, hi.hi + hi.lo + lo.hi of Q and the cache, then of
//     P and the cache;
//   * every other format: 2xTF32, only Q and P split, because the cache
//     values are exact in TF32: bf16, legacy int8 (q / 32), mxint4_blk
//     (m * 2^(e - 2)) and int8_tok's integers, whose row scale is factored
//     out: a score column is multiplied by s_t, and s_t is folded into P's
//     column before P.V;
//   * each k-step's products go into a fresh fragment, added to the running
//     sum in f32 (fed the running sum, the tensor cores' truncating
//     accumulate cost retention 9x the f32 error; PERF.md).
// mma.sync, not wgmma: wgmma's tf32 B operand must be K-major, and the
// latent tile is K-major for the scores but not for P.V, which would need a
// transposed copy of every tile.
//
// What bounds it on the H100: operations.  At deepseek-v3's decode shape (B
// 2, H 128, r 512, dr 64, kv_len 528) the function is 294 MFLOP: 1.78 us as
// 3xTF32 at 495 TFLOP/s (f32 cache), 1.19 us as 2xTF32, 4.39 us as f32 FMAs
// on the CUDA cores; the f32 cache's bytes take 1.06 us at 3.35 TB/s.
//
// Design:
//   * the grid is (splits, head groups of 16, B), fixed by the capacity C.
//     A block of 16 warps owns the 16 query heads (one m16 tile) of one
//     group of one batch lane and an even share of the C rows' 32-row
//     tiles, of which it streams those below kv_len (read from device
//     memory once per block); the splits of one (b, group) form a
//     thread-block cluster.  hopper.flash_decode_mla_plan picks the splits
//     (at most 8) from the card's resident-cluster counts, so that every
//     cluster runs in one wave.  A block whose share starts at or past
//     kv_len issues no copy (no bulk copy's byte count is ever expected for
//     a tile past kv_len) and still publishes an empty (m, l, acc) and
//     joins its cluster's barriers and merge;
//   * the staging tile holds 32 rows of [latent | rope] in f32, the latent at
//     column 0, the rope at rl = r rounded up to 32, every row w floats with
//     w = 8 mod 32 (zero columns pad each stream to whole k-steps);
//   * copies, two stages ahead: an f32 tile lands by 16-byte cp.async from
//     every thread straight into one of two staging tiles.  For the other
//     formats each of a tile's four arrays (latent values and side data,
//     rope values and side data) is one contiguous run in device memory:
//     the last warp issues each whose rows are whole 16-byte chunks as one
//     1-D bulk async copy (cp.async.bulk, completing on the raw stage's
//     mbarrier), every thread copies the narrower ones in chunks of 8, 4, 2
//     or 1 bytes (int8_tok's 4-byte scales, the reduced cut's 8-byte
//     mxint4_blk rope rows with 1-byte exponent rows), into one of two raw
//     stages.  The block then dequantizes the tile once into the staging
//     tile, 4 values per lane and a row per warp (int8_tok's row scales to a
//     side array), which frees the raw stage;
//   * scores: each warp holds a K-slice of the queries (at most 6 k-steps of
//     8) in registers for the whole launch (the latent's k-steps over 16 - wr
//     warps, the rope's over the last wr, so no warp mixes the streams and
//     int8_tok scales each stream's sum by its own row scale) and forms the
//     partial scores of every (head, row) over its slice.  A B fragment is
//     one 8-byte read: k t and t + 4 sit in adjacent columns, and the
//     queries are permuted alike.  The 16 partials are summed in warp order
//     in shared memory;
//   * softmax: warp h takes head h, a lane per row, online, with the
//     reference's finite-max guard; rows at or past kv_len are -inf, and
//     their staging rows are zero.  P (split hi / lo) and each head's
//     correction go to shared memory;
//   * P.V: warp w owns the latent's 32-column group w for the 16 heads,
//     accumulators in registers.  A B fragment of four n8 fragments is one
//     16-byte read (the output columns permuted alike, so that each lane's
//     results are float4 runs); with w = 8 mod 32 both products read shared
//     memory without bank conflicts;
//   * merge: with more than one split, every block leaves (m, l, acc) in
//     shared memory and, after a cluster barrier, merges its share of the
//     output columns from every split's shared memory (distributed shared
//     memory) in split order.  The order of every sum is fixed, so
//     relaunches are bit-equal.
// It reads each latent row once for both roles: the wrapper raises when V
// is not the same leaf as K.
//
// What holds it back (H100 80GB HBM3 at 700 W, tools/mla_phase_clock.py,
// PERF.md): at the main shape a block's 3 tiles take 15-16 us of its 20-21
// us span, about 1 us per tile each for the dequantize pass (encoded
// formats), the scores and P.V, 0.6 for the softmax, and the first copy's
// wait 2-2.5 us; the cluster barrier, merge and exit take 4.7 us more.  The
// products run at 8-13 cycles per mma.sync per SM sub-partition, against
// 6.1-6.8 for mma.sync m16n8k8 TF32 alone on this card (mla_phase_clock.py):
// the tensor path is within 2x of its rate, and the rest is latency between
// barriers.  Tried and dropped: 32-head groups (two m16 tiles per block:
// half the blocks and register spills, slower at the main shape) and 8
// warps with 255 registers (the same phase times).  wgmma would issue a
// third as often, but its M is 64 rows: the 16 heads of a block fill a
// quarter of it, and the scores taken transposed (rows as M) need 64-row
// tiles, 150 KB of f32 staging each.
//
// Built with -DFD_PHASE_CLOCK (tools/mla_phase_clock.py), thread 0 of every
// block records clock64 at entry, loop end, after the cluster barrier, after
// the merge and at exit, the cycles its loop spent waiting for copies,
// dequantizing, in the scores (their partial sums' barrier included), in the
// softmax and in P.V, and the global timer at entry and exit, into a buffer
// set by flash_decode_mla_set_stamps.
// ---------------------------------------------------------------------------

#include "tf32.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMlaTile = 32;                  // cache rows per tile: a lane per row
constexpr int kMlaHeads = 16;                 // query heads per block: a warp per head
constexpr int kMlaWarps = 16;
constexpr int kMlaThreads = 32 * kMlaWarps;
constexpr int kMlaMaxSplits = 8;              // blocks of a cluster (the portable size)
constexpr int kMlaMaxLatent = 32 * kMlaWarps; // a 32-column P.V group per warp
constexpr int kMlaMaxRope = 128;
constexpr int kMlaMaxKSteps = 6;              // k-steps of 8 in a warp's query slice
constexpr int kMlaRedStride = kMlaTile + 8;   // floats per head of a warp's partial scores

#ifdef FD_PHASE_CLOCK
constexpr int kMlaStamps = 13;
long long* g_mla_stamps = nullptr;
// Cycles since the last tick, added to phase k of this thread's loop sums.
#define MLA_TICK(k)                                                  \
  do {                                                               \
    const long long now_ = clock64();                                \
    clk_sum[k] += now_ - clk_last;                                   \
    clk_last = now_;                                                 \
  } while (0)
#define MLA_STAMP(i, v)                                              \
  do {                                                               \
    if (tid == 0) p.stamps[stamp0 + (i)] = (v);                      \
  } while (0)
#else
#define MLA_TICK(k) do {} while (0)
#define MLA_STAMP(i, v) do {} while (0)
#endif

struct MlaParams {
  const float* q;                        // [B, H, r]
  const float* q2;                       // [B, H, dr]
  const unsigned char* src[4];           // latent values, latent side, rope values, rope side
  int rb[4];                             // row bytes of each (0: the format has no side data)
  int off[4];                            // offset of each array in a raw stage
  float* out;                            // [B, H, r]
  const int* kv_len;                     // device: the rows to attend over, per lane
  int kv_stride;                         // lane b reads kv_len[b * kv_stride] (0: a scalar)
  int C, H, r, dr, tiles, splits;
  int w, rl, rr, wr;                     // staging row floats, latent and rope columns, rope warps
  int stage_bytes;                       // a raw stage (every format but f32)
  int red_off, p_off, misc_off, bar_off;   // shared-memory regions
  float scale;
#ifdef FD_PHASE_CLOCK
  long long* stamps;                     // [blocks][kMlaStamps]
#endif
};

// Staging columns: the latent rounded up to whole 32-column P.V groups, the
// rope to whole k-steps, the row to 8 mod 32 floats.
struct MlaStaging {
  int rl, rr, w;
};
inline MlaStaging mla_staging(int r, int dr) {
  const int rl = (r + 31) / 32 * 32, rr = (dr + 7) / 8 * 8;
  return {rl, rr, rl + rr + ((8 - (rl + rr) % 32) + 32) % 32};
}

// Warps on the rope stream: the fewest k-steps in the busiest warp, the
// fewer rope warps on a tie.
inline int mla_rope_warps(int rl, int rr, int* ksteps) {
  const int kl = rl / 8, kr = rr / 8;
  int best = 1, most = 1 << 30;
  for (int wr = 1; wr < kMlaWarps; ++wr) {
    const int wl = kMlaWarps - wr;
    const int k1 = (kl + wl - 1) / wl, k2 = (kr + wr - 1) / wr, k = k1 > k2 ? k1 : k2;
    if (k < most) most = k, best = wr;
  }
  *ksteps = most;
  return best;
}

// Shared-memory regions of one launch: two staging tiles (f32: the copies
// land there) or one staging tile and two raw stages, then the warps'
// partial scores, P, the row scales and per-head state, and an mbarrier per
// raw stage.  Returns the total bytes.
struct MlaLayout {
  int red_off, p_off, misc_off, bar_off, bytes;
};
inline MlaLayout mla_layout(bool f32, int w, int stage_bytes) {
  MlaLayout l;
  const int staging = kMlaTile * w * 4;
  l.red_off = f32 ? 2 * staging : staging + 2 * stage_bytes;
  l.p_off = l.red_off + kMlaWarps * kMlaHeads * kMlaRedStride * 4;
  l.misc_off = l.p_off + 2 * (kMlaTile / 8) * 32 * 4 * 4;
  l.bar_off = l.misc_off + (2 * kMlaTile + 3 * kMlaHeads) * 4;
  l.bytes = l.bar_off + 16;
  return l;
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

// Waits for the phase of the given parity to complete.  A wait that never
// ends (a pipeline fault) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int i = 0; !mbar_try_wait(bar, parity); ++i)
    if (i == (1 << 24)) __trap();
}

// One 1-D bulk async copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into this block's shared memory, counted on
// the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Copy n chunks of W bytes, contiguous on both sides, with every thread of
// the block; W < 4 goes through registers (cp.async has no such size).
template <int W>
__device__ __forceinline__ void mla_copy(unsigned char* dst, const unsigned char* src, int n,
                                         int tid) {
  for (int i = tid; i < n; i += kMlaThreads) {
    if constexpr (W >= 4) {
      cp_async<W>(dst + i * W, src + (size_t)i * W);
    } else if constexpr (W == 2) {
      reinterpret_cast<unsigned short*>(dst)[i] =
          __ldg(reinterpret_cast<const unsigned short*>(src) + i);
    } else {
      dst[i] = __ldg(src + i);
    }
  }
}

// A run of rows narrower than whole 16-byte chunks, in chunks of the widest
// of 8, 4, 2 or 1 bytes that divides a row.
__device__ __forceinline__ void mla_copy_narrow(unsigned char* dst, const unsigned char* src,
                                                int rows, int rb, int tid) {
  const int bytes = rows * rb;
  if (rb % 8 == 0) mla_copy<8>(dst, src, bytes / 8, tid);
  else if (rb % 4 == 0) mla_copy<4>(dst, src, bytes / 4, tid);
  else if (rb % 2 == 0) mla_copy<2>(dst, src, bytes / 2, tid);
  else mla_copy<1>(dst, src, bytes, tid);
}

// Elements e0 .. e0 + 3 of an encoded cache row as the staging tile holds
// them: exact in TF32, int8_tok's integers without their row scale.
template <int F>
__device__ __forceinline__ float4 mla_decode4(const unsigned char* row,
                                              const unsigned char* side, int e0) {
  float v[4];
  if constexpr (F == kInt8Tok) {
    const unsigned x = *reinterpret_cast<const unsigned*>(row + e0);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = (float)((int)(x << (24 - 8 * c)) >> 24);
  } else {
    dequant4<F>(row, side, e0, v);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <int F>
__global__ void __launch_bounds__(kMlaThreads, 1) flash_decode_mla_kernel(const MlaParams p) {
  constexpr bool kIsF32 = F == kF32;
  constexpr int RS = kMlaRedStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x, splits = p.splits;
  const int h0 = blockIdx.y * kMlaHeads, hn = min(kMlaHeads, p.H - h0);
  const int b = blockIdx.z;
  // This split's tiles: an even share of the C rows' tiles (the first
  // tiles % splits splits take one more), streamed up to kv_len; a share
  // that starts at or past kv_len streams none, and the block still takes
  // part in the cluster's merge below.
  const int lo = p.tiles / splits, extra = p.tiles - lo * splits;
  const int t_beg = split * lo + min(split, extra);
  const int r_beg = t_beg * kMlaTile;
  const int kv_len = min(max(p.kv_len[(size_t)b * p.kv_stride], 0), p.C);
  const int r_end = min(kv_len, r_beg + (lo + (split < extra)) * kMlaTile);
  const int n_tiles = r_end > r_beg ? (r_end - r_beg + kMlaTile - 1) / kMlaTile : 0;
#ifdef FD_PHASE_CLOCK
  const size_t stamp0 =
      ((blockIdx.z * gridDim.y + blockIdx.y) * (size_t)gridDim.x + blockIdx.x) * kMlaStamps;
  long long clk_last = clock64(), clk_sum[5] = {0, 0, 0, 0, 0};
  MLA_STAMP(0, clk_last);
  {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    MLA_STAMP(11, t);
  }
#endif

  const int stage_floats = kMlaTile * p.w;
  float* stg0 = reinterpret_cast<float*>(smem);                     // [stages][tile][w]
  unsigned char* raw = smem + stage_floats * 4;                     // [2][stage_bytes]
  float* red = reinterpret_cast<float*>(smem + p.red_off);          // [warp][head][RS]
  // P's A fragments, hi then lo: [k-step][lane][4], a lane's 4 words in one
  // place (entry i of lane 4g + t: head g + 8 (i & 1), row 8 kk + t + 4 (i >> 1)).
  uint32_t* p_hi = reinterpret_cast<uint32_t*>(smem + p.p_off);
  uint32_t* p_lo = p_hi + kMlaTile / 8 * 32 * 4;
  float* s_scale = reinterpret_cast<float*>(smem + p.misc_off);     // [2][tile]: int8_tok
  float* s_corr = s_scale + 2 * kMlaTile;                           // [head]
  float* s_m = s_corr + kMlaHeads;
  float* s_l = s_m + kMlaHeads;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.bar_off);   // a raw stage's copies

  if (!kIsF32 && tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    // The staging tiles' pad columns are never written: zero them once.
    const int pl = p.rl - p.r, npad = pl + p.rr - p.dr, nst = kIsF32 ? 2 : 1;
    for (int i = tid; i < nst * kMlaTile * npad; i += kMlaThreads) {
      const int row = i / npad, c = i - row * npad;
      stg0[row * p.w + (c < pl ? p.r + c : p.rl + p.dr + c - pl)] = 0.f;
    }
  }
  __syncthreads();

  // Tile t goes to stage `stage` (a cp.async group per tile from every
  // thread; for the encoded formats also the bulk copies of the last warp).
  auto issue = [&](int t, int stage) {
    const int r0 = r_beg + t * kMlaTile, rows = min(kMlaTile, r_end - r0);
    const size_t row0 = (size_t)b * p.C + r0;
    if constexpr (kIsF32) {
      // A row per warp: its 16-byte chunks of the latent, then of the rope.
      float* dst = stg0 + stage * stage_floats;
      for (int row = warp; row < rows; row += kMlaWarps) {
        const float* lv = reinterpret_cast<const float*>(p.src[0]) + (row0 + row) * p.r;
        const float* rv = reinterpret_cast<const float*>(p.src[2]) + (row0 + row) * p.dr;
        for (int c = 4 * lane; c < p.r; c += 128) cp_async<16>(dst + row * p.w + c, lv + c);
        for (int c = 4 * lane; c < p.dr; c += 128)
          cp_async<16>(dst + row * p.w + p.rl + c, rv + c);
      }
    } else {
      unsigned char* st = raw + stage * p.stage_bytes;
      if (warp == kMlaWarps - 1) {
        const uint32_t bar = smem_u32(&bars[stage]);
        int bytes = 0;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (p.rb[a] && p.rb[a] % 16 == 0) bytes += rows * p.rb[a];
        if (lane == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_expect_tx(bar, bytes);
        }
        __syncwarp();
        if (lane < 4 && p.rb[lane] && p.rb[lane] % 16 == 0)
          bulk_copy(st + p.off[lane], p.src[lane] + row0 * p.rb[lane], rows * p.rb[lane], bar);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (p.rb[a] % 16)
          mla_copy_narrow(st + p.off[a], p.src[a] + row0 * p.rb[a], rows, p.rb[a], tid);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0, 0);
  if (n_tiles > 1) issue(1, 1);

  // This warp's stream and k-steps: warps 0 .. 15 - wr take the latent's,
  // the last wr the rope's, each an even share.
  const int wl = kMlaWarps - p.wr;
  const bool rope_w = warp >= wl;
  const int nw = rope_w ? p.wr : wl, wi = rope_w ? warp - wl : warp;
  const int kst = (rope_w ? p.rr : p.rl) / 8;
  const int klo = kst / nw, kex = kst - klo * nw;
  const int ks0 = wi * klo + min(wi, kex), nks = klo + (wi < kex);
  // The queries of this slice, as A fragments: logical k t and t + 4 of a
  // k-step are the physical columns 2t and 2t + 1 (the staging tile's B
  // fragments are permuted alike).  Heads past H and columns past the width
  // are zero.
  float qa[kMlaMaxKSteps][4];
  {
    const float* qsrc = rope_w ? p.q2 : p.q;
    const int qw = rope_w ? p.dr : p.r;
#pragma unroll
    for (int kk = 0; kk < kMlaMaxKSteps; ++kk) {
      const int c = (ks0 + kk) * 8 + 2 * t4;
      float2 x[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int hh = g + 8 * hf;
        if (kk < nks && c < qw && hh < hn)
          x[hf] = *reinterpret_cast<const float2*>(qsrc + ((size_t)b * p.H + h0 + hh) * qw + c);
      }
      qa[kk][0] = x[0].x; qa[kk][1] = x[1].x;
      qa[kk][2] = x[0].y; qa[kk][3] = x[1].y;
    }
  }
  const int col0 = (rope_w ? p.rl : 0) + ks0 * 8 + 2 * t4;   // staging column of k-step 0
  const bool pv_w = warp < p.rl / 32;                          // this warp's P.V group exists
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  // Softmax: warp h takes head h, lane t row t; the state is lane-uniform.
  float m_run = -INFINITY, l_run = 0.f;

  // A partial last tile: P.V skips its k-steps of 8 rows past `rows`, and
  // the rows after `rows` in its last one are zero (P is 0 there, and stale
  // or unset values must not make a NaN).  The scores of rows past `rows`
  // are masked by a select, whatever the staging tile holds there.
  auto zero_tail = [&](float* stg, int rows) {
    const int n4 = (p.rl + p.rr) >> 2;
    for (int row = rows + warp; row < (rows + 7) / 8 * 8; row += kMlaWarps)
      for (int c = lane; c < n4; c += 32)
        *reinterpret_cast<float4*>(stg + row * p.w + 4 * c) = make_float4(0.f, 0.f, 0.f, 0.f);
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const int r0 = r_beg + t * kMlaTile, rows = min(kMlaTile, r_end - r0);
    const int nfr = (rows + 7) / 8;   // the tile's P.V k-steps of 8 rows
    float* stg = stg0;
    if constexpr (kIsF32) {
      stg = stg0 + stage * stage_floats;
      if (t + 1 < n_tiles) cp_async_wait<1>();
      else cp_async_wait<0>();
      zero_tail(stg, rows);
      __syncthreads();         // tile t landed in every thread's copies
      MLA_TICK(0);
    } else {
      mbar_wait(smem_u32(&bars[stage]), (t >> 1) & 1);
      if (t + 1 < n_tiles) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();         // every thread's narrow copies of tile t landed
      MLA_TICK(0);
      // The tile into the staging tile, once: a row per warp, 4 values per
      // lane (each lane's 16 bytes beside its neighbours'); int8_tok's row
      // scales apart.
      const unsigned char* st = raw + stage * p.stage_bytes;
      const int cl = p.r >> 2, cr = p.dr >> 2;
      for (int row = warp; row < rows; row += kMlaWarps) {
        float* drow = stg + row * p.w;
        const unsigned char *lv = st + row * p.rb[0], *ls = st + p.off[1] + row * p.rb[1];
        const unsigned char *rv = st + p.off[2] + row * p.rb[2];
        const unsigned char *rs = st + p.off[3] + row * p.rb[3];
#pragma unroll 4
        for (int c = lane; c < cl; c += 32)
          *reinterpret_cast<float4*>(drow + 4 * c) = mla_decode4<F>(lv, ls, 4 * c);
        for (int c = lane; c < cr; c += 32)
          *reinterpret_cast<float4*>(drow + p.rl + 4 * c) = mla_decode4<F>(rv, rs, 4 * c);
      }
      zero_tail(stg, rows);
      if constexpr (F == kInt8Tok) {
        if (tid < 2 * kMlaTile) {
          const int row = tid & (kMlaTile - 1), a = tid < kMlaTile ? 1 : 3;
          s_scale[tid] = row < rows ? *reinterpret_cast<const float*>(st + p.off[a] + 4 * row)
                                    : 0.f;
        }
      }
      __syncthreads();         // the staging tile is full; the raw stage is free
      if (t + 2 < n_tiles) issue(t + 2, stage);
      MLA_TICK(1);
    }

    // Scores: this warp's partial sums over its K-slice for every (head,
    // row).  Each product of a k-step is issued for every fragment before
    // the next product, which depends on it.
    {
      float part[4][4];
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[nf][c] = 0.f;
      const float* brow = stg + g * p.w + col0;
#pragma unroll
      for (int kk = 0; kk < kMlaMaxKSteps; ++kk) {
        if (kk < nks) {
          uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(qa[kk][i], ah[i], al[i]);
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) {
            const float2 v = *reinterpret_cast<const float2*>(brow + nf * 8 * p.w + kk * 8);
            if constexpr (kIsF32) {
              split_tf32(v.x, bh[nf][0], bl[nf][0]);
              split_tf32(v.y, bh[nf][1], bl[nf][1]);
            } else {
              bh[nf][0] = __float_as_uint(v.x);
              bh[nf][1] = __float_as_uint(v.y);
            }
          }
          float f[4][4];
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) mma_tf32_zero(f[nf], al, bh[nf]);
          if constexpr (kIsF32) {
#pragma unroll
            for (int nf = 0; nf < 4; ++nf) mma_tf32(f[nf], ah, bl[nf]);
          }
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) mma_tf32(f[nf], ah, bh[nf]);
#pragma unroll
          for (int nf = 0; nf < 4; ++nf)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[nf][c] += f[nf][c];
        }
      }
      float* mine = red + warp * kMlaHeads * RS;
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int o = g * RS + nf * 8 + 2 * t4;
        *reinterpret_cast<float2*>(mine + o) = make_float2(part[nf][0], part[nf][1]);
        *reinterpret_cast<float2*>(mine + o + 8 * RS) = make_float2(part[nf][2], part[nf][3]);
      }
    }
    __syncthreads();
    MLA_TICK(2);

    // Softmax of head `warp` over the tile's rows, a lane per row: the warps'
    // partials in warp order, each stream's sum scaled by its row scale
    // (int8_tok).
    {
      float lat = 0.f, rop = 0.f;
#pragma unroll
      for (int w = 0; w < kMlaWarps; ++w) {
        const float x = red[(w * kMlaHeads + warp) * RS + lane];
        if (w < wl) lat += x;
        else rop += x;
      }
      float s;
      if constexpr (F == kInt8Tok) s = lat * s_scale[lane] + rop * s_scale[kMlaTile + lane];
      else s = lat + rop;
      const float xs = lane < rows ? s * p.scale : -INFINITY;
      float mx = xs;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float corr = expf(isfinite(m_run) ? m_run - m_safe : -INFINITY);
      const float pv = expf(xs - m_safe);              // masked rows: exp(-inf) = 0
      float ps = pv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_run = l_run * corr + ps;
      m_run = m_new;
      uint32_t ph, pl;
      if constexpr (F == kInt8Tok) split_tf32(pv * s_scale[lane], ph, pl);
      else split_tf32(pv, ph, pl);
      const int o = ((lane >> 3) * 32 + 4 * (warp & 7) + (lane & 3)) * 4 + (warp >> 3) +
                    2 * ((lane >> 2) & 1);
      p_hi[o] = ph;
      p_lo[o] = pl;
      if (lane == 0) s_corr[warp] = corr;
    }
    __syncthreads();
    MLA_TICK(3);

    // P.V: rescale, then the tile's 4 k-steps of 8 rows.  Four n8 fragments
    // of the warp's 32-column group read one float4 per B row: fragment j,
    // logical column n, is physical column 4n + j of the group.
    if (pv_w) {
      const float c0 = s_corr[g], c1 = s_corr[g + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] *= c0;
        acc[j][1] *= c0;
        acc[j][2] *= c1;
        acc[j][3] *= c1;
      }
#pragma unroll
      for (int kk = 0; kk < kMlaTile / 8; ++kk) {
        if (kk >= nfr) break;
        const uint4 xh = *reinterpret_cast<const uint4*>(p_hi + (kk * 32 + lane) * 4);
        const uint4 xl = *reinterpret_cast<const uint4*>(p_lo + (kk * 32 + lane) * 4);
        const uint32_t ah[4] = {xh.x, xh.y, xh.z, xh.w}, al[4] = {xl.x, xl.y, xl.z, xl.w};
        const float* vb = stg + (kk * 8 + t4) * p.w + warp * 32 + 4 * g;
        const float4 v0 = *reinterpret_cast<const float4*>(vb);
        const float4 v1 = *reinterpret_cast<const float4*>(vb + 4 * p.w);
        const float b0[4] = {v0.x, v0.y, v0.z, v0.w}, b1[4] = {v1.x, v1.y, v1.z, v1.w};
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kIsF32) {
            split_tf32(b0[j], bh[j][0], bl[j][0]);
            split_tf32(b1[j], bh[j][1], bl[j][1]);
          } else {
            bh[j][0] = __float_as_uint(b0[j]);
            bh[j][1] = __float_as_uint(b1[j]);
          }
        }
        float f[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32_zero(f[j], al, bh[j]);
        if constexpr (kIsF32) {
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(f[j], ah, bl[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(f[j], ah, bh[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][c] += f[j][c];
      }
    }
    __syncthreads();           // the staging tile, partials and P are free
    if constexpr (kIsF32) {
      if (t + 2 < n_tiles) issue(t + 2, stage);
    }
    MLA_TICK(4);
  }
  if (lane == 0) {
    s_m[warp] = m_run;
    s_l[warp] = l_run;
  }
  __syncthreads();
#ifdef FD_PHASE_CLOCK
  MLA_STAMP(1, clock64());
  for (int k = 0; k < 5; ++k) MLA_STAMP(5 + k, clk_sum[k]);
  MLA_STAMP(10, n_tiles);
  auto stamp_end = [&](int i) {
    MLA_STAMP(i, clock64());
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    MLA_STAMP(12, t);
  };
#endif

  // Lane (g, t4) holds, for heads g (c0, c1) and g + 8 (c2, c3), columns
  // 32 warp + 8 t4 + j (c0, c2) and + 4 + j (c1, c3) of fragment j: two
  // float4 runs per head.
  if (splits == 1) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int hh = g + 8 * hf;
      const float den = fmaxf(s_l[hh], 1e-30f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = warp * 32 + 8 * t4 + 4 * half, k = 2 * hf + half;
        if (pv_w && hh < hn && c < p.r)
          *reinterpret_cast<float4*>(p.out + ((size_t)b * p.H + h0 + hh) * p.r + c) =
              make_float4(acc[0][k] / den, acc[1][k] / den, acc[2][k] / den, acc[3][k] / den);
      }
    }
#ifdef FD_PHASE_CLOCK
    stamp_end(4);
#endif
    return;
  }

  // Every split leaves acc [heads][rl] over the staging tile; the cluster
  // barrier publishes it (and m, l) to the other blocks of the cluster.
  float* s_acc = stg0;
  if (pv_w) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(s_acc + (g + 8 * (k >> 1)) * p.rl + warp * 32 + 8 * t4 +
                                 4 * (k & 1)) =
          make_float4(acc[0][k], acc[1][k], acc[2][k], acc[3][k]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
#ifdef FD_PHASE_CLOCK
  MLA_STAMP(2, clock64());
#endif

  // This block's share of the group's output: items of 4 columns of one
  // head, merged over the splits in split order.  Every split's
  // accumulator for a thread's first item and every split's (m, l) are read
  // from the cluster's shared memory in one round; then each head's weight
  // per split, exp(m_k - max m), and its denominator (over the partial
  // scores, which the loop no longer needs).
  const int per_head = p.r >> 2, items = hn * per_head;
  const int i_beg = (int)((long long)items * split / splits);
  const int i_end = (int)((long long)items * (split + 1) / splits);
  float4 x[kMlaMaxSplits];
  auto fetch = [&](int item) {
    const int ih = item / per_head, ij = (item - ih * per_head) * 4;
#pragma unroll
    for (int k = 0; k < kMlaMaxSplits; ++k)
      if (k < splits)
        x[k] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(s_acc, k) +
                                                ih * p.rl + ij);
  };
  if (i_beg + tid < i_end) fetch(i_beg + tid);
  float* s_wt = red;                                    // [splits][heads]: m, then weights
  float* s_lk = red + kMlaMaxSplits * kMlaHeads;        // [splits][heads]
  float* s_den = s_lk + kMlaMaxSplits * kMlaHeads;      // [heads]
  if (tid < splits * kMlaHeads) {
    const int k = tid / kMlaHeads, hh = tid - k * kMlaHeads;
    s_wt[tid] = cluster.map_shared_rank(s_m, k)[hh];
    s_lk[tid] = cluster.map_shared_rank(s_l, k)[hh];
  }
  __syncthreads();
  if (tid < kMlaHeads) {
    float M = -INFINITY;
    for (int k = 0; k < splits; ++k) M = fmaxf(M, s_wt[k * kMlaHeads + tid]);
    const float m_safe = isfinite(M) ? M : 0.f;
    float L = 0.f;
    for (int k = 0; k < splits; ++k) {
      const float mk = s_wt[k * kMlaHeads + tid];
      const float wt = isfinite(mk) ? expf(mk - m_safe) : 0.f;
      s_wt[k * kMlaHeads + tid] = wt;
      L = fmaf(s_lk[k * kMlaHeads + tid], wt, L);
    }
    s_den[tid] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int item = i_beg + tid; item < i_end; item += kMlaThreads) {
    if (item > i_beg + tid) fetch(item);
    const int ih = item / per_head, ij = (item - ih * per_head) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kMlaMaxSplits; ++k) {
      if (k < splits) {
        const float wt = s_wt[k * kMlaHeads + ih];
        a.x = fmaf(x[k].x, wt, a.x); a.y = fmaf(x[k].y, wt, a.y);
        a.z = fmaf(x[k].z, wt, a.z); a.w = fmaf(x[k].w, wt, a.w);
      }
    }
    const float den = s_den[ih];
    *reinterpret_cast<float4*>(p.out + ((size_t)b * p.H + h0 + ih) * p.r + ij) =
        make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
  }
#ifdef FD_PHASE_CLOCK
  MLA_STAMP(3, clock64());
#endif
  cluster.sync();          // no block leaves while another reads its shared memory
#ifdef FD_PHASE_CLOCK
  stamp_end(4);
#endif
}

template <int F>
int mla_launch(const MlaParams& p, int B, size_t smem, cudaStream_t stream) {
  auto kernel = flash_decode_mla_kernel<F>;
  static int limit[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if ((int)smem > limit[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    limit[dev] = (int)smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, (p.H + kMlaHeads - 1) / kMlaHeads, B);
  cfg.blockDim = dim3(kMlaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// MLA mode.  q f32 [B, H, r], q2 f32 [B, H, dr]; the latent cache (values
// lat0, side data lat1) [B, C, *] and the rope cache (rope0, rope1) in cache
// format `fmt`; out f32 [B, H, r].  A block takes 16 query heads; `tiles` =
// ceil(C / 32), split i owns tiles [i * lo + min(i, x), ...) and streams
// those below its lane's kv_len, as in the GQA mode.  A raw stage (every format but
// f32) holds 32 rows of the latent values at offset 0, then the latent
// side, the rope values and the rope side at `off_ls`, `off_rv`, `off_rs`,
// in `stage_bytes`, as hopper.flash_decode_mla_plan lays them out (checked
// here); the staging rows and the rest of shared memory are laid out here.
// Nothing is allocated: the merge goes through the cluster's shared memory.
extern "C" int flash_decode_mla_launch(const void* q, const void* q2, const void* lat0,
                                       const void* lat1, const void* rope0, const void* rope1,
                                       void* out, const void* kv_len, int kv_stride, int B,
                                       int C, int H,
                                       int r, int dr, int fmt, int tiles, int splits,
                                       int off_ls, int off_rv, int off_rs, int stage_bytes,
                                       float scale, void* stream) {
  if (fmt < kF32 || fmt > kMxint4Blk || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  MlaParams p{};
  p.rb[0] = value_bytes(fmt, r);
  p.rb[1] = side_bytes(fmt, r);
  p.rb[2] = value_bytes(fmt, dr);
  p.rb[3] = side_bytes(fmt, dr);
  if (r < 4 || r % 4 || r > kMlaMaxLatent || dr < 4 || dr % 4 || dr > kMlaMaxRope ||
      (fmt == kMxint4Blk && (r % 16 || dr % 16)) || C < 1 || kv_len == nullptr ||
      kv_stride < 0 ||
      tiles != (C + kMlaTile - 1) / kMlaTile || splits < 1 ||
      splits > kMlaMaxSplits || splits > tiles)
    return (int)cudaErrorInvalidValue;
  const MlaStaging sg = mla_staging(r, dr);
  int ksteps = 0;
  p.wr = mla_rope_warps(sg.rl, sg.rr, &ksteps);
  if (ksteps > kMlaMaxKSteps) return (int)cudaErrorInvalidValue;
  // Every array's tile fits its place in a raw stage, 16-byte aligned.
  if (off_ls % 16 || off_rv % 16 || off_rs % 16 || stage_bytes % 16 ||
      off_ls < kMlaTile * p.rb[0] || off_rv < off_ls + kMlaTile * p.rb[1] ||
      off_rs < off_rv + kMlaTile * p.rb[2] || stage_bytes < off_rs + kMlaTile * p.rb[3])
    return (int)cudaErrorInvalidValue;
  const MlaLayout lay = mla_layout(fmt == kF32, sg.w, stage_bytes);
  if (lay.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  p.q = static_cast<const float*>(q);
  p.q2 = static_cast<const float*>(q2);
  p.src[0] = static_cast<const unsigned char*>(lat0);
  p.src[1] = static_cast<const unsigned char*>(lat1);
  p.src[2] = static_cast<const unsigned char*>(rope0);
  p.src[3] = static_cast<const unsigned char*>(rope1);
  p.off[0] = 0;
  p.off[1] = off_ls;
  p.off[2] = off_rv;
  p.off[3] = off_rs;
  p.out = static_cast<float*>(out);
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_stride = kv_stride;
  p.C = C; p.H = H; p.r = r; p.dr = dr;
  p.tiles = tiles; p.splits = splits;
  p.w = sg.w; p.rl = sg.rl; p.rr = sg.rr;
  p.stage_bytes = stage_bytes;
  p.red_off = lay.red_off; p.p_off = lay.p_off; p.misc_off = lay.misc_off;
  p.bar_off = lay.bar_off;
  p.scale = scale;
#ifdef FD_PHASE_CLOCK
  p.stamps = g_mla_stamps;
#endif
  const size_t smem = (size_t)lay.bytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kF32: return mla_launch<kF32>(p, B, smem, s);
    case kBF16: return mla_launch<kBF16>(p, B, smem, s);
    case kInt8Legacy: return mla_launch<kInt8Legacy>(p, B, smem, s);
    case kInt8Tok: return mla_launch<kInt8Tok>(p, B, smem, s);
    case kMxint4Blk: return mla_launch<kMxint4Blk>(p, B, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef FD_PHASE_CLOCK
// The stamp buffer of later MLA launches: kMlaStamps int64 per block.
extern "C" void flash_decode_mla_set_stamps(void* stamps) {
  g_mla_stamps = static_cast<long long*>(stamps);
}
#endif

// How many clusters of `splits` blocks of the f32 instantiation with `smem`
// bytes of shared memory the card holds at once (negative: the CUDA error);
// the planner sizes the grid so that every cluster is resident.  The
// kernel's shared-memory limit is raised to the most any launch may take,
// never lowered under one a launch has set.
extern "C" int flash_decode_mla_max_clusters(int splits, int smem) {
  if (splits < 1 || splits > kMlaMaxSplits || smem > kMaxSmem)
    return -(int)cudaErrorInvalidValue;
  auto kernel = flash_decode_mla_kernel<kF32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 8, 2);
  cfg.blockDim = dim3(kMlaThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The planner's constants, for hopper's bind-time check.
extern "C" int flash_decode_mla_tile_rows() { return kMlaTile; }
extern "C" int flash_decode_mla_heads() { return kMlaHeads; }
extern "C" int flash_decode_mla_max_splits() { return kMlaMaxSplits; }
