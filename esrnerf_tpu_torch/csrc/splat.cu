// Sorted-stream scatter-add ("splat", K-3).
//
// Replaces the Pallas kernel esrnerf_tpu/ops/splat.py::_splat_kernel_body
// (driven by sorted_streams_splat). Contract:
//   out[n, c] += sum_s sum_k vals[s, c, k] * [base[k] + offsets[s] == n]
// into an f32 [n_cells, C] table that the caller zeroed. Rows outside
// [0, n_cells) are dropped; updates k >= *n_valid (a zero pad tail) are
// skipped without being read; exact zeros add nothing. The sum order is
// free (float atomics), so the result matches the plain version to
// rounding, not bitwise.
//
// Bound on the H100: bytes -- base and vals read once, each touched table
// row written once -- and in practice the L2's atomic throughput and the
// table traffic between L2 and device memory: a sweep of the sorted range
// per stream would take a table larger than the 50 MB L2 (the 67 MB SDF
// grid) to device memory and back once per stream.
//
// Design: one pass. The grid walks the sorted updates in tiles of kTile,
// one update per thread. When the tiles fill the card several times over,
// a block applies all S streams of its tile in a loop, so at any moment
// the blocks in flight touch the table only in their tiles' row windows
// (span plus the largest offset), which stay in L2 until every stream has
// added to them, and the tile's base, n_valid and run structure are read
// or computed once for all streams. With fewer tiles (the step's head
// samples: 131,072 rows of which ~10% are live make ~52 live tiles) that
// loop would leave most SMs idle, so each block takes one stream
// (blockIdx.y); the tiles are then few enough to be in flight together.
// The choice is made on the host from M (no sync on n_valid), and the grid
// needs no division to find a block's tile and streams.
// Equal rows are combined before the atomic: a run of lanes of one warp
// with the same base (consecutive samples in one cell, in the cell-sorted
// order most call sites give) targets one row in every stream, so a
// warp-segmented sum (five shuffles) leaves the run's total in its first
// lane, which does one atomic per run, stream and channel. A warp whose
// lanes all differ skips the shuffles. Runs are found between
// neighbouring lanes only, so unsorted input stays correct, with fewer
// runs. The TPU's one-hot MXU matmuls, bf16 hi+lo split, fold/shear
// tables and host-side block ranges do not carry over.

#include "common.cuh"

namespace {

constexpr int kTile = 256;  // updates per block, one per thread
// below this many tiles each block takes one stream (about two waves of
// resident 256-thread blocks on 132 SMs)
constexpr int kOnePassTiles = 2048;
constexpr unsigned kFull = 0xffffffffu;

// Sum of x over this lane's run [lane, run_end], left in the run's first
// lane (other lanes hold partial sums). Every lane of the warp calls it.
__device__ __forceinline__ float run_sum(float x, int lane, int run_end) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_down_sync(kFull, x, o);
    if (lane + o <= run_end) x += y;
  }
  return x;
}

// Block: tile blockIdx.x, streams [G blockIdx.y, G blockIdx.y + G) of S.
template <int C_T>
__global__ void __launch_bounds__(kTile) splat_kernel(
    const int* __restrict__ base, const float* __restrict__ vals,
    EsrOffsets offs, int S, int G, int C_rt, int M, long long n_cells,
    const int* __restrict__ n_valid, float* __restrict__ out) {
  const int C = C_T > 0 ? C_T : C_rt;
  const int s0 = blockIdx.y * G;
  const int s1 = min(S, s0 + G);
  const int nv = esr_n_valid(n_valid, M);
  const int k0 = blockIdx.x * kTile;
  if (k0 >= nv) return;  // the whole tile is pad tail
  const int k = k0 + threadIdx.x;
  const bool live = k < nv;
  const int b = live ? base[k] : 0;

  // runs of equal rows among live neighbouring lanes; a dead lane is a run
  // of its own that adds nothing
  const int lane = threadIdx.x & 31;
  const int b_next = __shfl_down_sync(kFull, b, 1);
  const bool tail = !live || lane == 31 || k + 1 >= nv || b_next != b;
  const unsigned tails = __ballot_sync(kFull, tail);
  const bool head = lane == 0 || ((tails >> (lane - 1)) & 1u);
  const int run_end = __ffs(tails & (kFull << lane)) - 1;
  const bool runs = tails != kFull;  // warp-uniform

#pragma unroll 2
  for (int s = s0; s < s1; ++s) {
    const float* v = vals + static_cast<size_t>(s) * C * M + k;
    const long long row = static_cast<long long>(b) + offs.v[s];
    const bool in = live && row >= 0 && row < n_cells;  // uniform per run
    float* o = out + row * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // loaded for every live update, so the load need not wait for base
      float x = live ? v[static_cast<size_t>(c) * M] : 0.f;
      if (!in) x = 0.f;
      if (runs) x = run_sum(x, lane, run_end);
      if (head && in && x != 0.f) atomicAdd(o + c, x);
    }
  }
}

}  // namespace

// base: [M] i32; vals: [S, C, M] f32; offsets: host array of S row shifts;
// n_valid: device i32 scalar or null; out: [n_cells, C] f32, pre-zeroed.
ESR_EXPORT int esr_splat(const void* base, const void* vals,
                         const long long* offsets, int S, int C, int M,
                         long long n_cells, const void* n_valid, void* out,
                         void* stream) {
  EsrOffsets offs;
  if (!esr_pack_offsets(offsets, S, &offs) || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0 && S > 0) {
    const int tiles = (M + kTile - 1) / kTile;
    const int G = tiles >= kOnePassTiles ? S : 1;  // streams per block
    const dim3 grid(tiles, S / G);
    const auto* b = static_cast<const int*>(base);
    const auto* v = static_cast<const float*>(vals);
    const auto* nv = static_cast<const int*>(n_valid);
    auto* o = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    // C as a constant for the port's widths: the channel loads of an
    // update are then issued together
    switch (C) {
      case 1:
        splat_kernel<1><<<grid, kTile, 0, st>>>(b, v, offs, S, G, C, M,
                                                 n_cells, nv, o);
        break;
      case 2:
        splat_kernel<2><<<grid, kTile, 0, st>>>(b, v, offs, S, G, C, M,
                                                 n_cells, nv, o);
        break;
      case 6:
        splat_kernel<6><<<grid, kTile, 0, st>>>(b, v, offs, S, G, C, M,
                                                 n_cells, nv, o);
        break;
      default:
        splat_kernel<0><<<grid, kTile, 0, st>>>(b, v, offs, S, G, C, M,
                                                 n_cells, nv, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
