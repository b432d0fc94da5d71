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
//
// Bound on the H100: bytes. The TPU bodies DMA each window into VMEM and
// build every tap by one-hot MXU matmuls and lane rolls; here each tap is a
// direct load. K-5 runs one thread per (chunk, lane): it reads its index
// and span once and writes its 24 outputs, each a coalesced row across the
// warp; neighbouring lanes read nearby words, so the table traffic is
// mostly the distinct words the chunk touches. K-6 runs one thread per
// output element and sweeps the pieces in order, adding with unfused
// __fadd_rn in the plain version's order, so the sums agree bitwise. The
// dma mode spreads each piece's words over all threads (coalesced) and
// keeps the loads alive by writing the running sum only when it is NaN.

#include "common.cuh"

namespace {

constexpr int kG = 128;             // lanes per group
constexpr long long kGcap = 98304;  // words per window
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

// mode: 0 dma, 1 build, 2 full
__global__ void gather_parts_kernel(const float* __restrict__ tbl,
                                    long long n_words, int npiece, int mode,
                                    float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_out = kRows * kLanes;
  if (mode == 0) {
    // every thread of the grid takes a strided share of each piece
    const int nthreads = gridDim.x * blockDim.x;
    const long long piece_words = static_cast<long long>(kNt + kExt) * kG;
    float s = 0.f;
    for (int p = 0; p < npiece; ++p) {
      const float* piece = tbl + kGcap * p;
      for (long long i = t; i < piece_words; i += nthreads) s += piece[i];
    }
    if (t < n_out) out[t] = (s != s) ? s : 0.f;
    return;
  }
  if (t >= n_out) return;
  const int kw = t / kLanes;
  const int k = kw / kW;
  const int w = kw - k * kW;
  const int lane = t - kw * kLanes;
  const int g = lane / kG;
  const int j = lane - g * kG;
  const long long r = 3LL * j + static_cast<long long>(kStride) * k - 5;
  const bool v_rel = r >= 0 && r < kGcap;
  float acc = 0.f;
  for (int p = 0; p < npiece; ++p) {
    const long long t0 = (13LL * p + 7LL * g + k) % kNt;
    const long long base = kGcap * p;
    if (mode == 2) {
      const long long d = r - kG * t0;
      if (v_rel && d >= 0 && d < 2 * kG)
        acc = __fadd_rn(acc, tbl[clip_word(base + r + w, n_words)]);
    } else {
      const float x0 = tbl[base + kG * t0 + j + w];
      const float x1 = tbl[base + kG * t0 + kG + j + w];
      const float ind = (v_rel && r - kG * t0 == w) ? 1.f : 0.f;
      acc = __fadd_rn(__fadd_rn(acc, __fadd_rn(x0, x1)), ind);
    }
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

// tbl: [n_words] f32 with n_words >= npiece*GCAP + 256; out: [1, 24, 2048].
ESR_EXPORT int esr_gather_parts(const void* tbl, long long n_words,
                                int npiece, int mode, void* out,
                                void* stream) {
  if (mode < 0 || mode > 2 || npiece < 0 ||
      n_words < kGcap * npiece + kExt * kG)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = kRows * kLanes;
  gather_parts_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl), n_words, npiece, mode,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
