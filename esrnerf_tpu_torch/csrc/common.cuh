// Shared pieces of the port's CUDA kernels: the plain C export macro, the
// by-value offset table and the error-string export every library carries.
//
// Each source in this directory is compiled on its own into a shared library
// with a plain C interface (nvcc -shared, sm_90a) and loaded with ctypes by
// esrnerf_tpu_torch/ops/kernels.py. Launchers take PyTorch's current stream,
// allocate nothing, never synchronise, and return cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

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

ESR_EXPORT const char* esr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
