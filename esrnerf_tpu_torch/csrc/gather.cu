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
// Design: one thread per (point, channel) in the weighted form -- the C
// threads of a point read one contiguous table row -- and one thread per
// (point, offset) in the raw form. The weighted sum runs over d in order
// with unfused multiply and add (__fmul_rn/__fadd_rn), so it is bitwise the
// plain version's out = out + w[:, d] * table[idx_d]. The TPU's one-hot MXU
// matmuls, VMEM pieces and offset families do not carry over.

#include "common.cuh"

namespace {

constexpr int kChunk = 2048;  // pad-skip granularity of the reference

__device__ __forceinline__ long long clip_row(long long i, long long R) {
  return i < 0 ? 0 : (i >= R ? R - 1 : i);
}

__device__ __forceinline__ bool pad_chunk(const int* n_valid, long long m) {
  return n_valid != nullptr && (m / kChunk) * kChunk >= *n_valid;
}

__global__ void gather_weighted_kernel(const float* __restrict__ table,
                                       long long R, int C,
                                       const int* __restrict__ base,
                                       const float* __restrict__ w,
                                       EsrOffsets offs, int D, int M,
                                       const int* __restrict__ n_valid,
                                       float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(M) * C) return;
  const long long m = t / C;
  const int c = static_cast<int>(t - m * C);
  if (pad_chunk(n_valid, m)) {
    out[t] = 0.f;
    return;
  }
  const long long b = base[m];
  const float* wm = w + m * D;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) {
    const long long i = clip_row(b + offs.v[d], R);
    acc = __fadd_rn(acc, __fmul_rn(wm[d], table[i * C + c]));
  }
  out[t] = acc;
}

__global__ void gather_raw_kernel(const float* __restrict__ table,
                                  long long R, const int* __restrict__ base,
                                  EsrOffsets offs, int D, int M,
                                  const int* __restrict__ n_valid,
                                  float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(M) * D) return;
  const long long m = t / D;
  const int d = static_cast<int>(t - m * D);
  if (pad_chunk(n_valid, m)) {
    out[t] = 0.f;
    return;
  }
  out[t] = table[clip_row(static_cast<long long>(base[m]) + offs.v[d], R)];
}

constexpr int kBlock = 256;

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
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
  const long long n = static_cast<long long>(M) * C;
  if (n > 0) {
    gather_weighted_kernel<<<blocks_for(n), kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), R, C,
        static_cast<const int*>(base), static_cast<const float*>(w), offs, D,
        M, static_cast<const int*>(n_valid), static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// table: [R, 1] f32; base: [M] i32; out: [M, D] f32.
ESR_EXPORT int esr_gather_raw(const void* table, long long R,
                              const void* base, const long long* offsets,
                              int D, int M, const void* n_valid, void* out,
                              void* stream) {
  EsrOffsets offs;
  if (!esr_pack_offsets(offsets, D, &offs) || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(M) * D;
  if (n > 0) {
    gather_raw_kernel<<<blocks_for(n), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), R, static_cast<const int*>(base),
        offs, D, M, static_cast<const int*>(n_valid),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
