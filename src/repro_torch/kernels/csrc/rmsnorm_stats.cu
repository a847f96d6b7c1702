// Row-wise sigma^{-1} for Hopper (sm_90a): the fused-RMSNorm producer.
//
// Replaces the Pallas TPU kernel `rmsnorm_stats_pallas`
// (src/repro/kernels/rmsnorm_stats.py).  For y[M, D] in f32 or bf16, rows
// `stride` bytes apart (the inner stride is 1):
//
//     out[m] = rsqrt(sum_i y[m, i]^2 / D + eps)          (f32 [M, 1])
//
// What bounds it on the H100: bytes.  Two operations per element read and
// no matrix product, so the floor is M * D * elem over 3.35 TB/s (2.5 us at
// [1024, 4096] bf16).  Reaching it takes about 3.35 TB/s x 0.8 us of
// latency, some 2.7 MB, in flight across the card at once: a kernel that
// walks each row in a chain of dependent rounds pays the latency once per
// round.  So a block puts every byte of its rows in flight before it adds
// any of them: `tpr` threads own a row, and each issues all `kN` (a
// compile-time 1 or 2) streaming loads (`__ldcs`) of `kW` bytes of a round
// before it squares any, neighbouring threads on neighbouring addresses:
// thread t's load j of round k reads chunk (k * kN + j) * tpr + t.  A row
// takes `rounds` rounds (one at every shape the models normalise).
// `hopper.rmsnorm_stats_plan` owns the whole split: the load width, the
// row's `chunks` whole loads and `tail` elements past them (read one by
// one), `tpr`, `rounds`, the rows per block and the grid; the launch checks
// that the plan covers every row and element once and lays nothing out on
// its own.  A wide row spreads over the warps of its block, many narrow
// rows share a warp, a few rows take a block each.  Rows whose width or
// base is not a multiple of 16 bytes take a narrower kW.  (Bulk copies of
// the rows into shared memory, in 1 to 4 column stages on mbarriers,
// measured 10-40 % slower at every shape: PERF.md.)
//
// The row's threads then add their f32 partial sums in a fixed order (a
// shuffle butterfly inside a warp, then the warps' sums in warp order), so
// two launches on the same input are bit-equal.  Rows past M are masked.
//
// Built with -DRMS_PHASE_CLOCK (tools/rmsnorm_turns.py --phases), thread 0
// of every block records clock64 and the global timer at entry (0), when
// its first bytes have landed (1), when its last bytes are added (2) and
// after the write (3), into the buffer set by rmsnorm_stats_set_stamps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

struct Params {
  const unsigned char* y;
  float* out;
  long long stride;   // bytes between rows
  int M, D;
  int tpr;            // threads per row: a power of two up to 32, or a multiple of 32
  int rows;           // rows per block
  int chunks;         // whole loads per row
  int tail;           // elements after the last whole load
  int rounds;         // rounds of kN loads per thread
  float eps;
  long long* stamps;
};

#ifdef RMS_PHASE_CLOCK
constexpr int kPhases = 4;   // entry, first bytes landed, last bytes added, written
long long* g_stamps = nullptr;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define RMS_STAMP(i)                                                        \
  do {                                                                      \
    if (threadIdx.x == 0) {                                                 \
      p.stamps[blockIdx.x * 2 * kPhases + (i)] = clock64();                 \
      p.stamps[blockIdx.x * 2 * kPhases + kPhases + (i)] = global_ns();     \
    }                                                                       \
  } while (0)
#else
#define RMS_STAMP(i) \
  do {               \
  } while (0)
#endif

template <int kW> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<2> { using type = unsigned short; };

// The 32-bit words of a load, in address order.
template <int kW>
__device__ __forceinline__ unsigned int word(const typename VecOf<kW>::type& v, int i) {
  if constexpr (kW == 16) return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  else if constexpr (kW == 8) return i == 0 ? v.x : v.y;
  else return v;
}

template <int n>
__device__ __forceinline__ float tree(const float* x) {
  if constexpr (n == 1) return x[0];
  else return tree<n / 2>(x) + tree<n / 2>(x + n / 2);
}

// Sum of the squares of the elements of one load, in a fixed tree.
template <bool kBF16, int kW>
__device__ __forceinline__ float sumsq(const typename VecOf<kW>::type& v) {
  if constexpr (kW == 2) {
    const float f = __uint_as_float((unsigned int)v << 16);
    return f * f;
  } else {
    constexpr int kWords = kW / 4, kVals = kBF16 ? 2 * kWords : kWords;
    float sq[kVals];
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const unsigned int w = word<kW>(v, i);
      if constexpr (kBF16) {
        const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
        sq[2 * i] = lo * lo;
        sq[2 * i + 1] = hi * hi;
      } else {
        const float f = __uint_as_float(w);
        sq[i] = f * f;
      }
    }
    return tree<kVals>(sq);
  }
}

template <bool kBF16>
__device__ __forceinline__ float element(const unsigned char* row, int i) {
  if constexpr (kBF16)
    return __bfloat162float(__ldcs(reinterpret_cast<const __nv_bfloat16*>(row) + i));
  else
    return __ldcs(reinterpret_cast<const float*>(row) + i);
}

// Adds the tail elements (past the row's last whole load) to this thread's sum.
template <bool kBF16>
__device__ __forceinline__ float add_tail(const Params& p, const unsigned char* row, int first,
                                          int t, float acc) {
  for (int e = t; e < p.tail; e += p.tpr) {
    const float f = element<kBF16>(row, first + e);
    acc += f * f;
  }
  return acc;
}

// Adds the partial sums of a row's threads in a fixed order and writes the
// row's sigma^{-1}.  Every thread of the block calls it.
__device__ __forceinline__ void finish(const Params& p, float acc, int t, int r, int row,
                                       bool live) {
  __shared__ float part[kMaxThreads / 32];
  const int span = p.tpr < 32 ? p.tpr : 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < span) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (p.tpr > 32) {
    const int warps = p.tpr >> 5;
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (t != 0) return;
    acc = 0.f;
    for (int w = 0; w < warps; ++w) acc += part[r * warps + w];
  }
  if (t == 0 && live) p.out[row] = rsqrtf(acc / (float)p.D + p.eps);
}

// (1024, 2): at most 32 registers a thread, so that an SM holds 2048 threads
// whatever the plan's block size (hopper.RMS_THREADS_PER_SM).
template <bool kBF16, int kW, int kN>
__global__ void __launch_bounds__(kMaxThreads, 2048 / kMaxThreads)
rmsnorm_stats_kernel(const Params p) {
  using Vec = typename VecOf<kW>::type;
  RMS_STAMP(0);
  const int t = threadIdx.x % p.tpr, r = threadIdx.x / p.tpr;
  const int row = blockIdx.x * p.rows + r;
  const bool live = row < p.M;
  const unsigned char* src = p.y + (live ? (size_t)row * p.stride : 0);
  const Vec* vsrc = reinterpret_cast<const Vec*>(src);
  float acc = 0.f;
  for (int k = 0; k < p.rounds; ++k) {
    Vec v[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int c = (k * kN + j) * p.tpr + t;
      v[j] = (live && c < p.chunks) ? __ldcs(vsrc + c) : Vec{};
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      acc += sumsq<kBF16, kW>(v[j]);
#ifdef RMS_PHASE_CLOCK
      if (k == 0 && j == 0) RMS_STAMP(1);
#endif
    }
  }
  if (live) acc = add_tail<kBF16>(p, src, p.chunks * (kW / (kBF16 ? 2 : 4)), t, acc);
  RMS_STAMP(2);
  finish(p, acc, t, r, row, live);
  RMS_STAMP(3);
}

template <bool kBF16, int kW>
int launch(const Params& p, int loads, int blocks, int threads, cudaStream_t s) {
  switch (loads) {
    case 1: rmsnorm_stats_kernel<kBF16, kW, 1><<<blocks, threads, 0, s>>>(p); break;
    case 2: rmsnorm_stats_kernel<kBF16, kW, 2><<<blocks, threads, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

bool valid_tpr(int tpr) {
  return tpr >= 1 && tpr <= kMaxThreads && (tpr <= 32 ? (tpr & (tpr - 1)) == 0 : tpr % 32 == 0);
}

}  // namespace

#ifdef RMS_PHASE_CLOCK
extern "C" void rmsnorm_stats_set_stamps(void* stamps) {
  g_stamps = static_cast<long long*>(stamps);
}
#endif

// y: M rows of D elements (bf16 if is_bf16, else f32), `stride` bytes apart,
// read `width` bytes at a time (16, 8, 4 or, for bf16, 2; the base and the
// stride are multiples of it).  The plan (`hopper.rmsnorm_stats_plan`), which
// this function checks and does not amend: a row is `chunks` loads and
// `tail` elements, read by `tpr` threads in `rounds` rounds of `loads` loads
// each; `rows` rows per block, `blocks` blocks.
extern "C" int rmsnorm_stats_launch(const void* y, void* out, int M, int D, long long stride,
                                    int is_bf16, int width, int chunks, int tail, int rounds,
                                    int tpr, int loads, int rows, int blocks, float eps,
                                    void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  const long long per_round = (long long)tpr * loads;
  if (M < 1 || D < 1 || stride < 0 || !valid_tpr(tpr) || rows < 1 ||
      (long long)tpr * rows > kMaxThreads || width < elem || width > 16 ||
      (width & (width - 1)) || (loads != 1 && loads != 2) || chunks < 0 || tail < 0 ||
      tail >= width / elem || (long long)chunks * (width / elem) + tail != D || rounds < 0 ||
      rounds * per_round < chunks || (rounds > 0 && (rounds - 1) * per_round >= chunks) ||
      (long long)blocks * rows < M || (long long)(blocks - 1) * rows >= M)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.y = static_cast<const unsigned char*>(y);
  p.out = static_cast<float*>(out);
  p.stride = stride;
  p.M = M;
  p.D = D;
  p.tpr = tpr;
  p.rows = rows;
  p.chunks = chunks;
  p.tail = tail;
  p.rounds = rounds;
  p.eps = eps;
#ifdef RMS_PHASE_CLOCK
  p.stamps = g_stamps;
#endif
  const int threads = tpr * rows;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    switch (width) {
      case 16: return launch<true, 16>(p, loads, blocks, threads, s);
      case 8: return launch<true, 8>(p, loads, blocks, threads, s);
      case 4: return launch<true, 4>(p, loads, blocks, threads, s);
      default: return launch<true, 2>(p, loads, blocks, threads, s);
    }
  }
  switch (width) {
    case 16: return launch<false, 16>(p, loads, blocks, threads, s);
    case 8: return launch<false, 8>(p, loads, blocks, threads, s);
    default: return launch<false, 4>(p, loads, blocks, threads, s);
  }
}
