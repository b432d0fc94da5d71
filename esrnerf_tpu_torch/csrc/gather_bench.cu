// The gather microbenchmarks' kernels: per-chunk windowed gather (K-5) and
// piece-sweep gather (K-6).
//
// Replace the Pallas bodies scripts/bench_gather_grid.py::body (K-5) and
// scripts/bench_gather_parts.py::body (K-6). Both read a table of 128-word
// tiles as one flat f32 array and write [., 24, 2048] outputs: 4 offset
// families k (37 words apart) x 6 taps w per lane, 16 groups g x 128 lanes
// j. Contracts (floor division; esrnerf_tpu_torch/ops/gather_bench.py has
// the plain versions):
//
// K-5, chunk c: b = (w0[c] / 128) * 128, rel = idx[16c+g][j] + 37k - w0[c],
//   t0 = clip((gf[c][g] + 37k - w0[c]) / 128, 0, 767),
//   t1 = min((gl[c][g] + 37k - w0[c]) / 128, 767),
//   hi = 128 (t0 + 2 + 2 ((t1 - t0) / 2)) if t1 > t0 + 1 else 128 t0 + 256;
//   out[c][6k+w][128g+j] = tbl[b + rel + w] if 0 <= rel < GCAP and
//   128 t0 <= rel < hi, else 0.
// K-6, r = 3j + 37k - 5, t0 = (13p + 7g + k) mod 768, piece p at GCAP p:
//   full:  sum_p [0 <= r < GCAP, 0 <= r - 128 t0 < 256] tbl[GCAP p + r + w]
//   build: sum_p (tbl[GCAP p + 128 t0 + j + w]
//                 + tbl[GCAP p + 128 t0 + 128 + j + w] + [r - 128 t0 == w])
//   dma:   zeros, after reading every piece's 770 tiles.
// build and full add each piece's term in piece order with unfused
// __fadd_rn, as the plain versions do, so their sums agree bitwise.
//
// K-5. Bound on the H100: bytes. The TPU body DMAs each window into VMEM
// and builds every tap by one-hot MXU matmuls and lane rolls; here each tap
// is a direct load. One thread per (chunk, lane) reads its index and span
// once and writes its 24 outputs, each a coalesced row across the warp;
// neighbouring lanes read nearby words, so the table traffic is mostly the
// distinct words the chunk touches.
//
// K-6, one kernel per mode, each a single launch. Every piece is swept.
// The design before this one ran all three modes as one kernel of one
// thread per output word (192 blocks x 256 threads) sweeping the pieces in
// order, and took 0.0290 (dma), 0.0168 (build) and 0.0120 ms (full) at 64
// pieces (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//  - dma is bound by HBM bytes: 64 pieces x 394,240 B = 25.2 MB, 7.6 us at
//    3.35 TB/s. Reaching that takes ~2.5 MB in flight across the card
//    (Little's law at ~0.75 us), ~20 KB an SM; the old threads' 4-byte
//    strided loads held a few KB. Now two persistent blocks per SM walk
//    the pieces cut into 5,120-byte units (77 per piece, 16-byte aligned),
//    unit u to block u mod grid, each through a ring of 8 shared-memory
//    stages filled by 1-D bulk copies (cp.async.bulk) that complete on the
//    stage's mbarrier: 80 KB in flight per SM, issued by one thread. The
//    completed mbarrier is the proof that a unit's bytes arrived, so
//    nothing is summed; the other threads write the zeros.
//  - build is bound by latency and L2 bytes: its HBM bytes (the windows
//    of all (k, g) pairs, 0.85 us at 3.35 TB/s) lie below a launch, and
//    the old kernel waited one L2 round trip per piece before each
//    in-order add (64 x ~250 ns). Now two blocks per (k, g) pair, one per
//    half of the lanes j, stage the two 72-word runs of every piece their
//    taps read (576 B a piece; a whole window per block took twice the L2
//    traffic, and many small bulk copies queue on one SM's copy engine)
//    by cp.async, one 16-byte chunk per thread per batch of 8
//    pieces, 8 stages (36,864 B: every copy of a 64-piece sweep is issued
//    before the first add), each stage completing an mbarrier. The 384
//    (w, j) threads then add from shared memory in piece order: one round
//    trip of loads instead of 64. The indicator [r - 128 t0 == w] can be 1
//    only where t0 <= 3; a batch whose 8 t0 (block-uniform) all lie in
//    [4, 767] skips those +0.0 adds, which leave the sum bitwise as it is.
//  - full is bound by issue: a lane's window holds its r in ~2 of 768 t0
//    values, so it loads in well under 1% of the pieces, and the old loop
//    spent 64 dependent iterations of 64-bit index math. Now each lane
//    steps d = r - 128 t0 by -1,664 (t0 + 13) in 32 bits, wrapping by
//    +GCAP (t0 past 767) after one compare; the hit test is one unsigned
//    compare of d with 256. Pieces go 16 at a time: their d are
//    independent offsets of the batch's d, their rare loads are
//    predicated and issued together, then the 16 adds run in order (a miss
//    adds +0.0, as the plain version does).

#include <climits>

#include "common.cuh"

namespace {

constexpr int kG = 128;             // lanes per group
constexpr int kGcap = 98304;        // words per window
constexpr int kNt = 768;            // tiles per window
constexpr int kExt = 2;             // extra tiles past a window
constexpr int kW = 6;               // taps per family
constexpr int kK = 4;               // offset families
constexpr int kStride = 37;         // words between families
constexpr int kLanes = 16 * kG;     // lanes per chunk / piece
constexpr int kRows = kK * kW;      // output rows per chunk / piece

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ long long clip_word(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void gather_grid_kernel(const float* __restrict__ tbl,
                                   long long n_words,
                                   const int* __restrict__ idx,
                                   const int* __restrict__ w0,
                                   const int* __restrict__ gf,
                                   const int* __restrict__ gl, int nch,
                                   float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(nch) * kLanes) return;
  const int c = static_cast<int>(t / kLanes);
  const int lane = static_cast<int>(t - static_cast<long long>(c) * kLanes);
  const int g = lane / kG;
  const long long base0 = w0[c];
  const long long b = floordiv(base0, kG) * kG;
  const long long row = idx[t];  // idx[16c + g][j] == idx_flat[c*2048 + lane]
  const long long f = gf[c * 16 + g];
  const long long l = gl[c * 16 + g];
  float* o = out + static_cast<long long>(c) * kRows * kLanes + lane;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const long long ck = static_cast<long long>(k) * kStride;
    const long long rel = row + ck - base0;
    long long t0 = floordiv(f + ck - base0, kG);
    t0 = t0 < 0 ? 0 : (t0 > kNt - 1 ? kNt - 1 : t0);
    long long t1 = floordiv(l + ck - base0, kG);
    t1 = t1 > kNt - 1 ? kNt - 1 : t1;
    const long long hi = t1 > t0 + 1
                             ? kG * (t0 + 2 + 2 * floordiv(t1 - t0, 2))
                             : kG * t0 + 2 * kG;
    const bool ok = rel >= 0 && rel < kGcap && rel >= kG * t0 && rel < hi;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      o[static_cast<long long>(k * kW + w) * kLanes] =
          ok ? tbl[clip_word(b + rel + w, n_words)] : 0.f;
    }
  }
}

// ---- K-6

// dma: pieces cut into units of 10 tiles, each one bulk copy
constexpr int kDmaThreads = 128;
constexpr int kDmaBlocksPerSm = 2;
constexpr int kDmaUnitWords = 10 * kG;                         // 5,120 B
constexpr int kDmaUnits = (kNt + kExt) * kG / kDmaUnitWords;  // per piece
static_assert(kDmaUnits * kDmaUnitWords == (kNt + kExt) * kG,
              "a piece is a whole number of units");
constexpr int kDmaStages = 8;

__global__ void __launch_bounds__(kDmaThreads)
    gather_parts_dma_kernel(const float* __restrict__ tbl, int npiece,
                            float* __restrict__ out) {
  __shared__ __align__(128) float ring[kDmaStages][kDmaUnitWords];
  __shared__ uint64_t bars[kDmaStages];
  const int tid = threadIdx.x;
  const int n4 = kRows * kLanes / 4;
  for (int i = blockIdx.x * kDmaThreads + tid; i < n4;
       i += gridDim.x * kDmaThreads)
    reinterpret_cast<float4*>(out)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid >= 32) return;
  init_bars(bars, kDmaStages, 1, tid);
  if (tid != 0) return;
  const int units = npiece * kDmaUnits;
  const int first = blockIdx.x, stride = gridDim.x;
  const int mine = first < units ? (units - 1 - first) / stride + 1 : 0;
  // the i-th unit of this block into stage i mod kDmaStages
  auto issue = [&](int i) {
    const int u = first + i * stride;
    const int p = u / kDmaUnits;
    const float* src = tbl + static_cast<size_t>(p) * kGcap +
                       (u - p * kDmaUnits) * kDmaUnitWords;
    const int st = i % kDmaStages;
    const uint32_t bar = smem_u32(bars + st);
    mbar_expect_tx(bar, kDmaUnitWords * 4);
    bulk_load(ring[st], src, kDmaUnitWords * 4, bar);
  };
  for (int i = 0; i < mine && i < kDmaStages; ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    mbar_wait(smem_u32(bars + i % kDmaStages), (i / kDmaStages) & 1);
    if (i + kDmaStages < mine) issue(i + kDmaStages);
  }
}

// build: lane j's taps of a piece are words 128 t0 + j + w (x0) and
// 128 t0 + 128 + j + w (x1). Two blocks per (k, g) pair, one per half of
// the lanes j (jb = 0 or 64), stage per piece the two runs of 72 words
// from 128 t0 + jb and 128 t0 + 128 + jb (j + w - jb < 69): 576 B, 16-byte
// aligned, half the whole window's bytes.
constexpr int kBuildJ = kG / 2;               // lanes j per block
constexpr int kBuildThreads = kW * kBuildJ;   // one per (w, j)
constexpr int kBuildBlocks = kK * 16 * 2;
constexpr int kBuildRun = kBuildJ + 8;        // words per run
constexpr int kBuildWin = 2 * kBuildRun;      // words per piece
constexpr int kBuildChunks = kBuildWin / 4;   // 16-byte chunks per piece
constexpr int kBuildBatch = 8;                // pieces per stage
constexpr int kBuildStages = 8;
constexpr int kBuildStageWords = kBuildBatch * kBuildWin;
static_assert(kBuildBatch * kBuildChunks <= kBuildThreads,
              "a batch is at most one chunk per thread");

// One staged batch of n pieces into acc, in piece order, t0 the first
// piece's. With kInd the indicator [r - 128 t0 == w] is added after each
// piece's pair sum; without, the batch's t0 all lie in [4, 767], where
// 128 t0 exceeds every r - w (at most 487), and the indicator is +0.0:
// adding it to a sum that started at +0.0 leaves the sum bitwise as it is.
template <bool kInd>
__device__ __forceinline__ void build_batch(const float* sw, int n, int rw,
                                            int t0, float& acc) {
#pragma unroll
  for (int q = 0; q < kBuildBatch; ++q) {
    if (q < n) {
      const float x =
          __fadd_rn(sw[q * kBuildWin], sw[q * kBuildWin + kBuildRun]);
      if (kInd) {
        acc = __fadd_rn(__fadd_rn(acc, x), (t0 << 7) == rw ? 1.f : 0.f);
        t0 = t0 + 13 < kNt ? t0 + 13 : t0 + 13 - kNt;
      } else {
        acc = __fadd_rn(acc, x);
      }
    }
  }
}

__global__ void __launch_bounds__(kBuildThreads)
    gather_parts_build_kernel(const float* __restrict__ tbl, int npiece,
                              float* __restrict__ out) {
  __shared__ __align__(128) float win[kBuildStages * kBuildStageWords];
  __shared__ uint64_t bars[kBuildStages];
  const int pair = blockIdx.x >> 1;
  const int k = pair / 16;
  const int g = pair - 16 * k;
  const int jb = (blockIdx.x & 1) * kBuildJ;
  const int tid = threadIdx.x;
  const int w = tid / kBuildJ;
  const int jl = tid - w * kBuildJ;
  const int nb = (npiece + kBuildBatch - 1) / kBuildBatch;
  if (tid < 32) init_bars(bars, kBuildStages, kBuildThreads, tid);
  __syncthreads();
  // this thread's 16-byte chunk of each batch: piece cq, run cr, word co
  const int cq = tid / kBuildChunks;
  const int cr = (tid - cq * kBuildChunks) / (kBuildRun / 4);
  const int co = 4 * (tid - cq * kBuildChunks - cr * (kBuildRun / 4));
  // batch b (pieces 8b..) into stage b mod kBuildStages: each thread copies
  // its chunk by cp.async, then arrives on the stage's mbarrier once its
  // copies have landed
  auto issue = [&](int b) {
    const int st = b % kBuildStages;
    const int p = b * kBuildBatch + cq;
    if (cq < kBuildBatch && p < npiece) {
      const int t0 = (13 * (p % kNt) + 7 * g + k) % kNt;
      cp_async16(win + st * kBuildStageWords + cq * kBuildWin +
                     cr * kBuildRun + co,
                 tbl + static_cast<size_t>(p) * kGcap + kG * (t0 + cr) + jb +
                     co);
    }
    cp_async_arrive(smem_u32(bars + st));
  };
  for (int b = 0; b < nb && b < kBuildStages; ++b) issue(b);
  const int rw = 3 * (jb + jl) + kStride * k - 5 - w;
  int t0 = 7 * g + k;  // t0 of the batch's first piece
  float acc = 0.f;
  for (int b = 0; b < nb; ++b) {
    const int st = b % kBuildStages;
    mbar_wait(smem_u32(bars + st), (b / kBuildStages) & 1);
    const float* sw = win + st * kBuildStageWords + jl + w;
    const int n = min(kBuildBatch, npiece - b * kBuildBatch);
    if (t0 < 4 || t0 + 13 * (kBuildBatch - 1) >= kNt)
      build_batch<true>(sw, n, rw, t0, acc);
    else
      build_batch<false>(sw, n, rw, t0, acc);
    t0 += 13 * kBuildBatch;
    if (t0 >= kNt) t0 -= kNt;
    if (b + kBuildStages < nb) {
      __syncthreads();  // the stage is read: refill it
      issue(b + kBuildStages);
    }
  }
  out[(k * kW + w) * kLanes + g * kG + jb + jl] = acc;
}

// full: one thread per output word, 16 pieces a batch
constexpr int kStepD = 13 * kG;  // d = r - 128 t0 falls by this per piece

// d = r - 128 t0 of the piece step / kStepD pieces on (step < GCAP): t0
// rises by step / 128 and wraps past 767 (d rises by GCAP) at most once,
// exactly when d - step falls to dwrap = r - GCAP or below
__device__ __forceinline__ int next_d(int d, int step, int dwrap) {
  d -= step;
  return d <= dwrap ? d + kGcap : d;
}

constexpr int kFullThreads = 256;
constexpr int kFullBatch = 16;

__global__ void __launch_bounds__(kFullThreads)
    gather_parts_full_kernel(const float* __restrict__ tbl, int npiece,
                             float* __restrict__ out) {
  const int t = blockIdx.x * kFullThreads + threadIdx.x;
  if (t >= kRows * kLanes) return;
  const int kw = t / kLanes;
  const int k = kw / kW;
  const int w = kw - k * kW;
  const int lane = t - kw * kLanes;
  const int g = lane / kG;
  const int j = lane - g * kG;
  const int r = 3 * j + kStride * k - 5;
  const int dwrap = r - kGcap;
  // d = r - 128 t0; a hit is 0 <= d < 256 (r < 0 gives d < 0: no hit)
  int d = r - kG * (7 * g + k);
  float acc = 0.f;
  for (int p0 = 0; p0 < npiece; p0 += kFullBatch) {
    const int n = min(kFullBatch, npiece - p0);
    const float* pb = tbl + static_cast<size_t>(p0) * kGcap;
    float v[kFullBatch];
#pragma unroll
    for (int q = 0; q < kFullBatch; ++q) {
      const int dq = next_d(d, q * kStepD, dwrap);
      const bool hit = q < n && static_cast<unsigned>(dq) < 2u * kG;
      v[q] = hit ? pb[static_cast<size_t>(q) * kGcap + r + w] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kFullBatch; ++q) acc = __fadd_rn(acc, v[q]);
    d = next_d(d, kFullBatch * kStepD, dwrap);
  }
  out[t] = acc;
}

constexpr int kBlock = 256;

}  // namespace

// tbl: [n_words] f32; idx: [nch*16, 128] i32; w0: [nch] i32;
// gf, gl: [nch, 16] i32; out: [nch, 24, 2048] f32.
ESR_EXPORT int esr_gather_grid(const void* tbl, long long n_words,
                               const void* idx, const void* w0,
                               const void* gf, const void* gl, int nch,
                               void* out, void* stream) {
  if (n_words < 1 || nch < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(nch) * kLanes;
  if (n > 0) {
    gather_grid_kernel<<<static_cast<unsigned>((n + kBlock - 1) / kBlock),
                         kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tbl), n_words,
        static_cast<const int*>(idx), static_cast<const int*>(w0),
        static_cast<const int*>(gf), static_cast<const int*>(gl), nch,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// tbl: [n_words] f32 with n_words >= npiece*GCAP + 256, 16-byte aligned;
// out: [1, 24, 2048], 16-byte aligned. mode: 0 dma, 1 build, 2 full.
ESR_EXPORT int esr_gather_parts(const void* tbl, long long n_words,
                                int npiece, int mode, void* out,
                                void* stream) {
  if (mode < 0 || mode > 2 || npiece < 0 || npiece > INT_MAX / kDmaUnits ||
      n_words < static_cast<long long>(kGcap) * npiece + kExt * kG ||
      reinterpret_cast<uintptr_t>(tbl) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* t = static_cast<const float*>(tbl);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    gather_parts_dma_kernel<<<kDmaBlocksPerSm * sms, kDmaThreads, 0, st>>>(
        t, npiece, o);
  } else if (mode == 1) {
    gather_parts_build_kernel<<<kBuildBlocks, kBuildThreads, 0, st>>>(
        t, npiece, o);
  } else {
    gather_parts_full_kernel<<<(kRows * kLanes + kFullThreads - 1) /
                                   kFullThreads,
                               kFullThreads, 0, st>>>(t, npiece, o);
  }
  return static_cast<int>(cudaGetLastError());
}
