// Sorted-stream scatter-add ("splat", K-3).
//
// Replaces the Pallas kernel esrnerf_tpu/ops/splat.py::_splat_kernel_body
// (driven by sorted_streams_splat). Contract:
//   out[n, c] += sum_s sum_k vals[s, c, k] * [base[k] + offsets[s] == n]
// into an f32 [n_cells, C] table that the caller zeroed. Rows outside
// [0, n_cells) are dropped; updates k >= *n_valid (a zero pad tail) are
// skipped without being read.
//
// Bound on the H100: bytes, and in practice the throughput of the L2's
// atomic units. Each update reads 4 B of base plus 4*C B of values and does
// C float atomics into the table; the table is written once. Design: one
// thread per (update k, stream s) -- blockIdx.y is the stream -- adding its
// C channels with atomicAdd, skipping exact zeros (out-of-range trilinear
// corners carry zero weight). Consecutive k read consecutive addresses of
// vals[s, c, :], so the loads coalesce. Ascending base only buys locality
// here: neighbouring threads hit neighbouring (or the same) table rows, so
// the atomics stay in L2. The TPU's one-hot MXU matmuls, bf16 hi+lo split,
// fold/shear tables and host-side block ranges do not carry over; a
// warp-segmented reduction with one atomic per run of equal rows is the
// next step for this kernel.

#include "common.cuh"

namespace {

__global__ void splat_kernel(const int* __restrict__ base,
                             const float* __restrict__ vals, EsrOffsets offs,
                             int C, int M, long long n_cells,
                             const int* __restrict__ n_valid,
                             float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (k >= esr_n_valid(n_valid, M)) return;
  const long long row = static_cast<long long>(base[k]) + offs.v[s];
  if (row < 0 || row >= n_cells) return;
  const float* v = vals + static_cast<size_t>(s) * C * M + k;
  float* o = out + row * C;
  for (int c = 0; c < C; ++c) {
    const float x = v[static_cast<size_t>(c) * M];
    if (x != 0.f) atomicAdd(o + c, x);
  }
}

constexpr int kBlock = 256;

}  // namespace

// base: [M] i32; vals: [S, C, M] f32; offsets: host array of S row shifts;
// n_valid: device i32 scalar or null; out: [n_cells, C] f32, pre-zeroed.
ESR_EXPORT int esr_splat(const void* base, const void* vals,
                         const long long* offsets, int S, int C, int M,
                         long long n_cells, const void* n_valid, void* out,
                         void* stream) {
  EsrOffsets offs;
  if (!esr_pack_offsets(offsets, S, &offs) || S > 65535 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0 && S > 0) {
    const dim3 grid((M + kBlock - 1) / kBlock, S);
    splat_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(base), static_cast<const float*>(vals), offs,
        C, M, n_cells, static_cast<const int*>(n_valid),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
