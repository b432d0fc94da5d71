// Masked transmittance scan: forward (K-1) and its reverse-scan backward
// (K-2), on the march's own [N, S] layout (rays x samples, row-major).
//
// Replaces the Pallas kernels esrnerf_tpu/ops/scan.py::_fwd_kernel and
// ::_bwd_kernel. Semantics are the reference's: a sample is live iff the
// transmittance entering it is >= ee; the sample that takes T below ee still
// gets weight; later samples get 0 and T freezes. The backward is the
// division form grad = T_in*ct_w - A / max(1 - a, 1e-10) on live samples,
// with A the running sum of w*ct_w downstream plus T_last*ct_last.
//
// Bound on the H100: bytes. Per sample the forward reads alpha and writes
// w and T_in (12 B); the backward reads alpha, T_in and ct_w and writes
// d_alpha (16 B); either does under ten flops per sample.
//
// Design. Each ray's products and sums are taken in sample order, one
// thread per ray, as the reference and the plain versions take them: the
// early exit makes that order matter (a T rounded to the other side of ee
// flips a sample between live and dead), so S is not split. With 8,192
// rays that is 8,192 threads, about two warps per SM, so the loads cannot
// come from the consumer threads themselves: a block owns 32 rays (one
// warp, one ray per lane) and streams [32 rays x 32 samples] tiles of each
// input (128-byte rows) into a ring of shared-memory stages, several tiles
// ahead of the consumer, each stage completing an mbarrier:
//   - by TMA 2D tiles where the rows allow it (S a multiple of 4, 16-byte
//     aligned bases); the tensor map zero-fills the N and S tails and its
//     128-byte swizzle puts the 16-byte chunk j/4 of row r at chunk
//     (j/4) ^ (r % 8), so the lanes' float4 reads of four samples each are
//     free of bank conflicts (a plain [32 x 32] tile read down a column is
//     a 32-way conflict);
//   - otherwise by cp.async, 4 bytes a lane along each row (coalesced),
//     zero-filling the tails, into the same swizzled layout, completing the
//     stage's mbarrier through cp.async.mbarrier.arrive.noinc.
// The ring's depth comes from the card: the SM count and shared memory per
// SM decide how many blocks share an SM and so how many stages each holds,
// at most four (at 8,192 rays: 256 blocks, two per SM, four stages of 4 KB
// forward and 12 KB backward). Outputs are staged in shared memory in the
// same layout and leave as whole 128-byte rows: by TMA store, or by
// coalesced warp stores on the cp.async route. The consumer does the
// reference's operations in their order, with __fmul_rn/__fsub_rn/
// __fadd_rn/__fdiv_rn and no contraction, so every result is bitwise that
// of a sequential float32 loop over the samples. The backward walks the
// tiles from the last one to the first; per tile it first carries A alone
// (one add per sample on the dependent chain), then does the tile's 32
// IEEE divisions, none of which waits on another.
//
// The tensor maps are encoded through cudaGetDriverEntryPoint
// ("cuTensorMapEncodeTiled"), so the library needs no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums only; libcuda is not linked

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRays = 32;   // rays per block: one warp, one ray per lane
constexpr int kTileS = 32;  // samples per tile row: 128 bytes, one swizzle span
constexpr int kTileFloats = kRays * kTileS;
constexpr int kTileBytes = kTileFloats * 4;
constexpr int kOutSlots = 2;  // output tiles in flight per output
// Ring depth cap; esrnerf_tpu_torch/scripts/bench_scan_ring.py builds
// this file with other caps and times them beside it
#ifndef ESR_SCAN_MAX_STAGES
#define ESR_SCAN_MAX_STAGES 4
#endif
constexpr int kMaxStages = ESR_SCAN_MAX_STAGES;
constexpr int kAlign = 1024;  // the 128-byte swizzle repeats every 1 KB

struct ScanMaps {
  CUtensorMap m[4];  // inputs, then outputs (TMA route only)
};

struct ScanArgs {
  const float* in[3];
  float* out[2];
  const float* ct_last;
  float* last;
  int S, N, stages;
  float ee;
};

// float offset of the 16-byte chunk c (samples 4c..4c+3) of row r in a
// swizzled [32 x 32] tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * kTileS + ((c ^ (r & 7)) << 2);
}

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint32_t bar, int s0, int n0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(s0), "r"(n0)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const float* src, int s0, int n0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(s0), "r"(n0)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until at most N committed store groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// order this thread's shared-memory writes before later async-proxy reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  // src-size 0 zero-fills the destination without reading
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float x, float y, float z,
                                    float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}

// the dynamic shared memory rounded up to the swizzle's 1 KB period
__device__ __forceinline__ float* align_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return reinterpret_cast<float*>(raw + ((kAlign - (a & (kAlign - 1))) &
                                         (kAlign - 1)));
}

// One [32 x 32] tile of src at (n0, s0) into a swizzled shared tile by the
// warp's cp.async copies, one 128-byte row per instruction; rows and
// samples past the ends are zero-filled.
__device__ __forceinline__ void cp_async_tile(float* tile, const float* src,
                                              int n0, int s0, int N, int S,
                                              int lane) {
  const int s = s0 + lane;
#pragma unroll 8
  for (int r = 0; r < kRays; ++r) {
    const int n = n0 + r;
    const bool ok = n < N && s < S;
    cp_async4(tile + swz(r, lane >> 2) + (lane & 3),
              ok ? src + static_cast<size_t>(n) * S + s : src, ok);
  }
}

// A swizzled shared tile to dst at (n0, s0) by coalesced warp stores (one
// 128-byte row per store), leaving out rows and samples past the ends.
__device__ __forceinline__ void warp_store_tile(const float* tile, float* dst,
                                                int n0, int s0, int N, int S,
                                                int lane) {
  const int s = s0 + lane;
  if (s >= S) return;
  const int rows = min(kRays, N - n0);
#pragma unroll 8
  for (int r = 0; r < rows; ++r)
    dst[static_cast<size_t>(n0 + r) * S + s] =
        tile[swz(r, lane >> 2) + (lane & 3)];
}

// Fill a ring stage with sample tile `tile` of every input: by TMA (lane 0
// arms the stage's mbarrier with the bytes to come) or by the warp's
// cp.async copies (each lane's copies arrive on the mbarrier).
template <bool kTma, int kIn>
__device__ __forceinline__ void issue_stage(const ScanMaps& maps,
                                            const ScanArgs& a, float* stage,
                                            uint32_t bar, int tile, int n0,
                                            int lane) {
  const int s0 = tile * kTileS;
  if (kTma) {
    if (lane == 0) {
      mbar_expect_tx(bar, kIn * kTileBytes);
#pragma unroll
      for (int i = 0; i < kIn; ++i)
        tma_load(stage + i * kTileFloats, &maps.m[i], bar, s0, n0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kIn; ++i)
      cp_async_tile(stage + i * kTileFloats, a.in[i], n0, s0, a.N, a.S, lane);
    cp_async_arrive(bar);
  }
}

// The output tiles of sample tile `tile` out: TMA stores (clipped at the
// ends) in one bulk group, or warp stores.
template <bool kTma, int kIn, int kOut>
__device__ __forceinline__ void store_outputs(const ScanMaps& maps,
                                              const ScanArgs& a,
                                              const float* outs, int tile,
                                              int n0, int lane) {
  const int s0 = tile * kTileS;
  if (kTma) {
    if (lane == 0) {
#pragma unroll
      for (int o = 0; o < kOut; ++o)
        tma_store(&maps.m[kIn + o], outs + o * kTileFloats, s0, n0);
      bulk_commit();
    }
  } else {
#pragma unroll
    for (int o = 0; o < kOut; ++o)
      warp_store_tile(outs + o * kTileFloats, a.out[o], n0, s0, a.N, a.S,
                      lane);
  }
}

// K-1 on one tile: this lane's ray through 32 samples in order.
__device__ __forceinline__ void fwd_tile(const float* at, float* wt,
                                         float* tt, int lane, float ee,
                                         float& T) {
#pragma unroll
  for (int c = 0; c < kTileS / 4; ++c) {
    const int o = swz(lane, c);
    const float4 a4 = ld4(at + o);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    float wv[4], tv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float a_eff = (T >= ee) ? av[q] : 0.f;
      tv[q] = T;
      wv[q] = __fmul_rn(a_eff, T);
      T = __fmul_rn(T, __fsub_rn(1.f, a_eff));
    }
    st4(wt + o, wv[0], wv[1], wv[2], wv[3]);
    st4(tt + o, tv[0], tv[1], tv[2], tv[3]);
  }
}

// K-2 on one tile, last sample first; with kTail only the first `valid`
// samples exist (the last tile of a row whose S is no multiple of 32).
// First the carried sum alone, A before each sample (one add per sample on
// the dependent chain), then the 32 independent divisions.
// scripts/bench_scan_ring.py times one interleaved loop beside this order.
template <bool kTail>
__device__ __forceinline__ void bwd_tile(const float* at, const float* tt,
                                         const float* ct, float* dt, int lane,
                                         float ee, int valid, float& A) {
  float av[kTileS], tv[kTileS], cv[kTileS], Av[kTileS];
#pragma unroll
  for (int c = 0; c < kTileS / 4; ++c) {
    const int o = swz(lane, c);
    const float4 a4 = ld4(at + o), t4 = ld4(tt + o), c4 = ld4(ct + o);
    av[4 * c] = a4.x;
    av[4 * c + 1] = a4.y;
    av[4 * c + 2] = a4.z;
    av[4 * c + 3] = a4.w;
    tv[4 * c] = t4.x;
    tv[4 * c + 1] = t4.y;
    tv[4 * c + 2] = t4.z;
    tv[4 * c + 3] = t4.w;
    cv[4 * c] = c4.x;
    cv[4 * c + 1] = c4.y;
    cv[4 * c + 2] = c4.z;
    cv[4 * c + 3] = c4.w;
  }
#pragma unroll
  for (int j = kTileS - 1; j >= 0; --j) {
    Av[j] = A;
    if (!kTail || j < valid) {
      const float a_eff = (tv[j] >= ee) ? av[j] : 0.f;
      A = __fadd_rn(A, __fmul_rn(__fmul_rn(a_eff, tv[j]), cv[j]));
    }
  }
#pragma unroll
  for (int c = 0; c < kTileS / 4; ++c) {
    float dv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * c + q;
      const bool live = tv[j] >= ee;
      const float a_eff = live ? av[j] : 0.f;
      const float den = fmaxf(__fsub_rn(1.f, a_eff), 1e-10f);
      // A / 1 is A exactly. Lanes with den 1 (alpha 0, or past the exit)
      // divide 1 by 1 instead: at the step's inputs enough of them took
      // the IEEE division's slow path to make K-2 three times slower
      const bool one = den == 1.f;
      const float quot = __fdiv_rn(one ? 1.f : Av[j], one ? 1.f : den);
      const float grad =
          __fsub_rn(__fmul_rn(tv[j], cv[j]), one ? Av[j] : quot);
      dv[q] = (live && (!kTail || j < valid)) ? grad : 0.f;
    }
    st4(dt + swz(lane, c), dv[0], dv[1], dv[2], dv[3]);
  }
}

// Shared memory of a block (after rounding up to 1 KB): the ring of
// `stages` x kIn input tiles, kOutSlots x kOut output tiles, one mbarrier
// per stage.
template <int kIn, int kOut>
struct Smem {
  static constexpr int kInStage = kIn * kTileFloats;
  static constexpr int kOutStage = kOut * kTileFloats;
  float* ring;
  float* outs;
  uint64_t* bars;
  __device__ Smem(unsigned char* raw, int stages) {
    ring = align_smem(raw);
    outs = ring + stages * kInStage;
    bars = reinterpret_cast<uint64_t*>(outs + kOutSlots * kOutStage);
  }
  __device__ float* stage(int i) const { return ring + i * kInStage; }
  __device__ float* out_slot(int k) const {
    return outs + (k % kOutSlots) * kOutStage;
  }
  __device__ uint32_t bar(int i) const { return smem_u32(bars + i); }
};

// alpha [N, S] -> w, t_in [N, S] and last [N]. Block b: rays 32b..32b+31.
template <bool kTma>
__global__ void __launch_bounds__(kRays)
    scan_fwd_kernel(const __grid_constant__ ScanMaps maps, const ScanArgs a) {
  constexpr int kIn = 1, kOut = 2;
  extern __shared__ unsigned char smem_raw[];
  const Smem<kIn, kOut> sm(smem_raw, a.stages);
  const int P = a.stages, lane = threadIdx.x, n0 = blockIdx.x * kRays;
  const int n_tiles = (a.S + kTileS - 1) / kTileS;
  init_bars(sm.bars, P, kTma ? 1 : kRays, lane);
  for (int k = 0; k < min(P, n_tiles); ++k)
    issue_stage<kTma, kIn>(maps, a, sm.stage(k), sm.bar(k), k, n0, lane);

  float T = 1.f;
  int slot = 0;
  uint32_t parity = 0;
  for (int k = 0; k < n_tiles; ++k) {
    float* ot = sm.out_slot(k);
    mbar_wait(sm.bar(slot), parity);
    if (kTma) {  // the store that last read this output slot is done
      if (lane == 0) bulk_wait_read<kOutSlots - 1>();
      __syncwarp();
    }
    // the S tail is zero-filled: alpha 0 leaves T as it is
    fwd_tile(sm.stage(slot), ot, ot + kTileFloats, lane, a.ee, T);
    if (kTma) fence_async_shared();
    __syncwarp();
    if (k + P < n_tiles)
      issue_stage<kTma, kIn>(maps, a, sm.stage(slot), sm.bar(slot), k + P,
                             n0, lane);
    store_outputs<kTma, kIn, kOut>(maps, a, ot, k, n0, lane);
    if (++slot == P) slot = 0, parity ^= 1;
  }
  if (kTma && lane == 0) bulk_wait_read<0>();
  if (n0 + lane < a.N) a.last[n0 + lane] = T;
}

// alpha, t_in, ct_w [N, S] and ct_last [N] -> d_alpha [N, S]; the tiles
// are walked from the last one, the k-th consumed being n_tiles - 1 - k.
template <bool kTma>
__global__ void __launch_bounds__(kRays)
    scan_bwd_kernel(const __grid_constant__ ScanMaps maps, const ScanArgs a) {
  constexpr int kIn = 3, kOut = 1;
  extern __shared__ unsigned char smem_raw[];
  const Smem<kIn, kOut> sm(smem_raw, a.stages);
  const int P = a.stages, lane = threadIdx.x, n0 = blockIdx.x * kRays;
  const int n_tiles = (a.S + kTileS - 1) / kTileS;
  const int n = n0 + lane;
  const float cl = n < a.N ? a.ct_last[n] : 0.f;
  init_bars(sm.bars, P, kTma ? 1 : kRays, lane);
  for (int k = 0; k < min(P, n_tiles); ++k)
    issue_stage<kTma, kIn>(maps, a, sm.stage(k), sm.bar(k), n_tiles - 1 - k,
                           n0, lane);

  const int tail = a.S - (n_tiles - 1) * kTileS;  // samples in the last tile
  float A = 0.f;
  int slot = 0;
  uint32_t parity = 0;
  for (int k = 0; k < n_tiles; ++k) {
    const int tile = n_tiles - 1 - k;
    float* ot = sm.out_slot(k);
    const float* at = sm.stage(slot);
    const float* tt = at + kTileFloats;
    const float* ct = tt + kTileFloats;
    mbar_wait(sm.bar(slot), parity);
    if (kTma) {
      if (lane == 0) bulk_wait_read<kOutSlots - 1>();
      __syncwarp();
    }
    if (k == 0) {
      // A starts at T_final * ct_last, T_final from the last sample's
      // entry state
      const int o = swz(lane, (tail - 1) >> 2) + ((tail - 1) & 3);
      const float tl = tt[o];
      const float al = (tl >= a.ee) ? at[o] : 0.f;
      A = __fmul_rn(__fmul_rn(tl, __fsub_rn(1.f, al)), cl);
    }
    if (k == 0 && tail < kTileS)
      bwd_tile<true>(at, tt, ct, ot, lane, a.ee, tail, A);
    else
      bwd_tile<false>(at, tt, ct, ot, lane, a.ee, kTileS, A);
    if (kTma) fence_async_shared();
    __syncwarp();
    if (k + P < n_tiles)
      issue_stage<kTma, kIn>(maps, a, sm.stage(slot), sm.bar(slot),
                             tile - P, n0, lane);
    store_outputs<kTma, kIn, kOut>(maps, a, ot, tile, n0, lane);
    if (++slot == P) slot = 0, parity ^= 1;
  }
  if (kTma && lane == 0) bulk_wait_read<0>();
}

// ------------------------------------------------------------------ host

using ScanKernel = void (*)(ScanMaps, ScanArgs);

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A TMA map of an f32 [N, S] row-major tensor in [32 x 32] boxes with the
// 128-byte swizzle; out-of-range elements read as zeros and are not
// written.
int encode_ns(CUtensorMap* m, const void* ptr, int S, int N) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(S) * 4};
  const cuuint32_t box[2] = {kTileS, kRays};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                         const_cast<void*>(ptr), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

struct DevInfo {
  int sms = 0, smem_sm = 0, smem_block = 0;
};

int dev_info(DevInfo* out) {
  static DevInfo cache[64];
  int d = 0;
  cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return e;
  if (d < 0 || d >= 64) return cudaErrorInvalidDevice;
  DevInfo& c = cache[d];
  if (c.sms == 0) {
    DevInfo t;
    if ((e = cudaDeviceGetAttribute(&t.sms, cudaDevAttrMultiProcessorCount,
                                    d)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(
             &t.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, d)) !=
            cudaSuccess ||
        (e = cudaDeviceGetAttribute(
             &t.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, d)) !=
            cudaSuccess)
      return e;
    c = t;
  }
  *out = c;
  return 0;
}

// Stages per block: the shared memory of one SM split among the blocks
// that must share it for the whole grid to be resident at once (at most
// 4), less the 1 KB the card reserves per block; at most kMaxStages and
// the number of tiles.
int pick_stages(int nblocks, int n_tiles, int stage_bytes, int fixed,
                const DevInfo& di) {
  const int per_sm = std::min(4, std::max(1, (nblocks + di.sms - 1) / di.sms));
  const int budget = std::min(di.smem_block, di.smem_sm / per_sm - 1024);
  const int p = (budget - fixed) / stage_bytes;
  return std::max(1, std::min({p, kMaxStages, n_tiles}));
}

bool tma_ok(int S, const void* const* ptrs, int n) {
  if (S <= 0 || S % 4 != 0) return false;  // TMA row strides: 16-byte steps
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

// The ring depth and the dynamic shared memory of one block, for N rays of
// S samples with n_in inputs and n_out outputs on the current device.
int scan_config(int n_in, int n_out, int S, int N, int* stages, int* smem) {
  DevInfo di;
  if (const int e = dev_info(&di)) return e;
  const int nblocks = (N + kRays - 1) / kRays;
  const int n_tiles = (S + kTileS - 1) / kTileS;
  const int fixed = kAlign + kOutSlots * n_out * kTileBytes + kMaxStages * 8;
  *stages = pick_stages(nblocks, n_tiles, n_in * kTileBytes, fixed, di);
  *smem = fixed + *stages * n_in * kTileBytes;
  return 0;
}

// ptrs: the kIn inputs, then the kOut outputs (the TMA maps' order)
int launch_scan(ScanKernel tma_kernel, ScanKernel cp_kernel, int n_in,
                int n_out, const void* const* ptrs, ScanArgs a, int use_tma,
                void* stream) {
  ScanMaps maps{};
  if (use_tma) {
    if (!tma_ok(a.S, ptrs, n_in + n_out)) return cudaErrorInvalidValue;
    for (int i = 0; i < n_in + n_out; ++i)
      if (const int e = encode_ns(&maps.m[i], ptrs[i], a.S, a.N)) return e;
  }
  int smem = 0;
  if (const int e = scan_config(n_in, n_out, a.S, a.N, &a.stages, &smem))
    return e;
  const int nblocks = (a.N + kRays - 1) / kRays;
  const ScanKernel kern = use_tma ? tma_kernel : cp_kernel;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<nblocks, kRays, smem, static_cast<cudaStream_t>(stream)>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// alpha, w, t_in: [N, S] f32; last: [N] f32. use_tma: 1 for the TMA route
// (S a multiple of 4, 16-byte aligned pointers, else an error), 0 for
// cp.async.
ESR_EXPORT int esr_scan_fwd(const void* alpha, void* w, void* t_in,
                            void* last, int S, int N, float ee, int use_tma,
                            void* stream) {
  if (N <= 0) return 0;
  ScanArgs a{};
  a.in[0] = static_cast<const float*>(alpha);
  a.out[0] = static_cast<float*>(w);
  a.out[1] = static_cast<float*>(t_in);
  a.last = static_cast<float*>(last);
  a.S = S;
  a.N = N;
  a.ee = ee;
  const void* ptrs[3] = {alpha, w, t_in};
  return launch_scan(scan_fwd_kernel<true>, scan_fwd_kernel<false>, 1, 2,
                     ptrs, a, use_tma, stream);
}

// alpha, t_in, ct_w, d_alpha: [N, S] f32; ct_last: [N] f32.
ESR_EXPORT int esr_scan_bwd(const void* alpha, const void* t_in,
                            const void* ct_w, const void* ct_last,
                            void* d_alpha, int S, int N, float ee,
                            int use_tma, void* stream) {
  if (N <= 0 || S <= 0) return 0;
  ScanArgs a{};
  a.in[0] = static_cast<const float*>(alpha);
  a.in[1] = static_cast<const float*>(t_in);
  a.in[2] = static_cast<const float*>(ct_w);
  a.ct_last = static_cast<const float*>(ct_last);
  a.out[0] = static_cast<float*>(d_alpha);
  a.S = S;
  a.N = N;
  a.ee = ee;
  const void* ptrs[4] = {alpha, t_in, ct_w, d_alpha};
  return launch_scan(scan_bwd_kernel<true>, scan_bwd_kernel<false>, 3, 1,
                     ptrs, a, use_tma, stream);
}

// The ring depth and dynamic shared memory per block that esr_scan_fwd
// (backward 0) or esr_scan_bwd (backward 1) takes for N rays of S samples.
ESR_EXPORT int esr_scan_config(int S, int N, int backward, int* stages,
                               int* smem_bytes) {
  return backward ? scan_config(3, 1, S, N, stages, smem_bytes)
                  : scan_config(1, 2, S, N, stages, smem_bytes);
}
