// Chunk-major sorted corner gather (K-4), weighted and raw.
//
// Replaces the Pallas kernel esrnerf_tpu/ops/splat.py::_gather_kernel_body
// (driven by sorted_corner_gather). Contract:
//   weighted: out[m, c] = sum_d w[m, d] * table[clip(base[m] + off[d]), c]
//   raw (C=1): out[m, d] = table[clip(base[m] + off[d])]
// with indices clipped to [0, R) (out-of-range corners carry zero weight),
// and zeros for every row of a 2048-row chunk that starts at or after
// *n_valid (the march's pad tail), exactly as the plain version.
//
// Bound on the H100: bytes. Each output reads D table rows; with base
// spatially local (the march sorts its points by cell) neighbouring points
// share corner rows, so most of those reads hit L1/L2 and device memory
// sees roughly the table window plus the index, weight and output streams.
// At the step's shapes most rows are pad, so the output stream dominates.
//
// Design: a block owns a tile of kTile points, which lies inside one
// 2048-row chunk, and tests once whether that chunk is pad; a pad tile only
// writes zeros, with 16-byte stores. A live tile stages its base (and, in
// the weighted form, its contiguous w rows) and the offsets in shared
// memory with coalesced loads. Each thread then produces V consecutive
// outputs of one point -- V channels of the weighted sum, whose threads
// read contiguous table rows, or V offsets of the raw form -- and the
// block writes its outputs in linear order, as 16-byte stores where V = 4.
// D and C are template parameters for the shapes the port runs (weighted
// D = 8, C = 12; raw D = 24) with a generic instance for the rest, so the
// per-thread index math is 32-bit division by constants; rows are clipped
// in 64 bits once per (point, offset). The weighted sum runs over d in
// order with unfused multiply and add (__fmul_rn/__fadd_rn), so it is
// bitwise the plain version's out = out + w[:, d] * table[idx_d]. The TPU's
// one-hot MXU matmuls, VMEM pieces and offset families do not carry over.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = 2048;  // pad-skip granularity of the reference
constexpr int kTile = 64;     // points per block; divides kChunk

__device__ __forceinline__ long long clip_row(long long i, long long R) {
  return i < 0 ? 0 : (i >= R ? R - 1 : i);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// True when the tile starting at row m0 lies in a chunk that starts at or
// after *n_valid (one test per block: kTile divides kChunk).
__device__ __forceinline__ bool pad_tile(const int* n_valid, int m0) {
  return n_valid != nullptr && (m0 & ~(kChunk - 1)) >= *n_valid;
}

// Block-wide: write n zeros at p, 16 bytes a store where p is aligned.
__device__ void zero_fill(float* __restrict__ p, int n) {
  int done = 0;
  if (aligned16(p)) {
    const int n4 = n >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

// Block-wide: stage the tile's base rows and the offsets in shared memory.
__device__ __forceinline__ void stage_base(const int* __restrict__ base,
                                           int m0, int np,
                                           const EsrOffsets& offs, int D,
                                           int* s_b, long long* s_off) {
  for (int i = threadIdx.x; i < np; i += blockDim.x) s_b[i] = base[m0 + i];
  if (threadIdx.x < D) s_off[threadIdx.x] = offs.v[threadIdx.x];
}

// One thread per (point, V channels); THREADS = kTile * C / V for the
// specialised shapes, so each thread makes one item.
template <int D_T, int C_T, int V, int THREADS>
__global__ void __launch_bounds__(THREADS) gather_weighted_kernel(
    const float* __restrict__ table, long long R, int C_rt,
    const int* __restrict__ base, const float* __restrict__ w,
    EsrOffsets offs, int D_rt, int M, const int* __restrict__ n_valid,
    float* __restrict__ out) {
  const int D = D_T > 0 ? D_T : D_rt;
  const int C = C_T > 0 ? C_T : C_rt;
  const int m0 = blockIdx.x * kTile;
  const int np = min(kTile, M - m0);
  float* o = out + static_cast<size_t>(m0) * C;
  if (pad_tile(n_valid, m0)) {
    zero_fill(o, np * C);
    return;
  }
  __shared__ int s_b[kTile];
  __shared__ long long s_off[ESR_MAX_OFFSETS];
  __shared__ __align__(16) float s_w[kTile * ESR_MAX_OFFSETS];
  stage_base(base, m0, np, offs, D, s_b, s_off);
  const float* wt = w + static_cast<size_t>(m0) * D;  // contiguous rows
  const int nw = np * D;
  int done = 0;
  if (aligned16(wt)) {
    const int n4 = nw >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(s_w)[i] =
          reinterpret_cast<const float4*>(wt)[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < nw; i += blockDim.x) s_w[i] = wt[i];
  __syncthreads();

  const int groups = C / V;  // threads per point
  for (int t = threadIdx.x; t < np * groups; t += blockDim.x) {
    const int p = t / groups;
    const int c0 = (t - p * groups) * V;
    const long long b = s_b[p];
    const float* wp = s_w + p * D;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float wd = wp[d];
      const float* row = table + clip_row(b + s_off[d], R) * C + c0;
      if constexpr (V == 4) {
        const float4 x = *reinterpret_cast<const float4*>(row);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(wd, x.x));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(wd, x.y));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(wd, x.z));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(wd, x.w));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(wd, row[j]));
      }
    }
    float* op = o + p * C + c0;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(op) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) op[j] = acc[j];
    }
  }
}

// One thread per (point, V consecutive offsets).
template <int D_T, int V, int THREADS>
__global__ void __launch_bounds__(THREADS) gather_raw_kernel(
    const float* __restrict__ table, long long R,
    const int* __restrict__ base, EsrOffsets offs, int D_rt, int M,
    const int* __restrict__ n_valid, float* __restrict__ out) {
  const int D = D_T > 0 ? D_T : D_rt;
  const int m0 = blockIdx.x * kTile;
  const int np = min(kTile, M - m0);
  float* o = out + static_cast<size_t>(m0) * D;
  if (pad_tile(n_valid, m0)) {
    zero_fill(o, np * D);
    return;
  }
  __shared__ int s_b[kTile];
  __shared__ long long s_off[ESR_MAX_OFFSETS];
  stage_base(base, m0, np, offs, D, s_b, s_off);
  __syncthreads();

  const int groups = D / V;  // threads per point
  for (int t = threadIdx.x; t < np * groups; t += blockDim.x) {
    const int p = t / groups;
    const int d0 = (t - p * groups) * V;
    const long long b = s_b[p];
    float x[V];
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = table[clip_row(b + s_off[d0 + j], R)];
    float* op = o + p * D + d0;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(op) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) op[j] = x[j];
    }
  }
}

constexpr int kGenericThreads = 256;

inline unsigned tiles_for(int M) {
  return static_cast<unsigned>((M + kTile - 1) / kTile);
}

}  // namespace

// table: [R, C] f32; base: [M] i32; w: [M, D] f32; offsets: host array of D
// row shifts; n_valid: device i32 scalar or null; out: [M, C] f32.
ESR_EXPORT int esr_gather_weighted(const void* table, long long R, int C,
                                   const void* base, const void* w,
                                   const long long* offsets, int D, int M,
                                   const void* n_valid, void* out,
                                   void* stream) {
  EsrOffsets offs;
  if (!esr_pack_offsets(offsets, D, &offs) || R < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0) {
    const auto* t = static_cast<const float*>(table);
    const auto* b = static_cast<const int*>(base);
    const auto* wt = static_cast<const float*>(w);
    const auto* nv = static_cast<const int*>(n_valid);
    auto* o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if (D == 8 && C == 12 && aligned16(table) && aligned16(out)) {
      constexpr int kThreads = kTile * 12 / 4;
      gather_weighted_kernel<8, 12, 4, kThreads>
          <<<tiles_for(M), kThreads, 0, s>>>(t, R, C, b, wt, offs, D, M, nv,
                                             o);
    } else {
      gather_weighted_kernel<0, 0, 1, kGenericThreads>
          <<<tiles_for(M), kGenericThreads, 0, s>>>(t, R, C, b, wt, offs, D,
                                                    M, nv, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// table: [R, 1] f32; base: [M] i32; out: [M, D] f32.
ESR_EXPORT int esr_gather_raw(const void* table, long long R,
                              const void* base, const long long* offsets,
                              int D, int M, const void* n_valid, void* out,
                              void* stream) {
  EsrOffsets offs;
  if (!esr_pack_offsets(offsets, D, &offs) || R < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0) {
    const auto* t = static_cast<const float*>(table);
    const auto* b = static_cast<const int*>(base);
    const auto* nv = static_cast<const int*>(n_valid);
    auto* o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if (D == 24 && aligned16(out)) {
      constexpr int kThreads = kTile * 24 / 4;
      gather_raw_kernel<24, 4, kThreads>
          <<<tiles_for(M), kThreads, 0, s>>>(t, R, b, offs, D, M, nv, o);
    } else {
      gather_raw_kernel<0, 1, kGenericThreads>
          <<<tiles_for(M), kGenericThreads, 0, s>>>(t, R, b, offs, D, M, nv,
                                                    o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
