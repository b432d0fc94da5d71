// Shared pieces of the port's CUDA kernels: the plain C export macro, the
// by-value offset table, the mbarrier and bulk-copy helpers of the kernels
// that stage bytes in shared memory (scan.cu, gather_bench.cu), and the
// error-string export every library carries.
//
// Each source in this directory is compiled on its own into a shared library
// with a plain C interface (nvcc -shared, sm_90a) and loaded with ctypes by
// esrnerf_tpu_torch/ops/kernels.py. Launchers take PyTorch's current stream,
// allocate nothing, never synchronise, and return cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#define ESR_EXPORT extern "C" __attribute__((visibility("default")))

// Static per-stream / per-offset row shifts, passed by value as a kernel
// argument (no host-to-device copy, no synchronisation per call).
#define ESR_MAX_OFFSETS 32

struct EsrOffsets {
  long long v[ESR_MAX_OFFSETS];
};

static inline bool esr_pack_offsets(const long long* host, int n,
                                    EsrOffsets* out) {
  if (n < 0 || n > ESR_MAX_OFFSETS) return false;
  for (int i = 0; i < n; ++i) out->v[i] = host[i];
  for (int i = n; i < ESR_MAX_OFFSETS; ++i) out->v[i] = 0;
  return true;
}

// Number of valid rows: rows >= *n_valid are a zero pad tail. A null pointer
// means every row is valid. Read on the device so no caller syncs the host.
__device__ __forceinline__ int esr_n_valid(const int* n_valid, int m) {
  if (n_valid == nullptr) return m;
  int nv = *n_valid;
  return nv < m ? nv : m;
}

// ---- mbarriers and asynchronous copies into shared memory (sm_90)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also announces `bytes` of asynchronous copies to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Lane 0 initialises n mbarriers of `count` arrivals each and makes them
// visible to the copy engines; the warp then proceeds together (a block of
// several warps syncs the block after this).
__device__ __forceinline__ void init_bars(uint64_t* bars, int n,
                                          uint32_t count, int lane) {
  if (lane == 0) {
    for (int i = 0; i < n; ++i) mbar_init(smem_u32(bars + i), count);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
}

// One 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, completing its bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes by cp.async, bypassing L1 (both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// the mbarrier's next arrival (one per thread, counted in its init) fires
// when this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

ESR_EXPORT const char* esr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
