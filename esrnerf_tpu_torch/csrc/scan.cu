// Masked transmittance scan: forward (K-1) and its reverse-scan backward
// (K-2).
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
// d_alpha (16 B); either does under ten flops per sample. Design: one
// thread per ray walks its S samples in order (the TPU's in-kernel
// fori_loop). The [S, N] layout puts neighbouring rays on neighbouring
// addresses, so each step of a warp is one coalesced 128-byte access. The
// loads of one thread do not depend on the carried T, so the unrolled loop
// keeps several of them in flight; 64-thread blocks spread 8192 rays over
// 128 blocks, about one per SM.

#include "common.cuh"

namespace {

__global__ void scan_fwd_kernel(const float* __restrict__ alpha,
                                float* __restrict__ w,
                                float* __restrict__ t_in,
                                float* __restrict__ last, int S, int N,
                                float ee) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float T = 1.f;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const size_t i = static_cast<size_t>(s) * N + n;
    const float a = alpha[i];
    const float a_eff = (T >= ee) ? a : 0.f;
    t_in[i] = T;
    w[i] = __fmul_rn(a_eff, T);
    T = __fmul_rn(T, __fsub_rn(1.f, a_eff));
  }
  last[n] = T;
}

__global__ void scan_bwd_kernel(const float* __restrict__ alpha,
                                const float* __restrict__ t_in,
                                const float* __restrict__ ct_w,
                                const float* __restrict__ ct_last,
                                float* __restrict__ d_alpha, int S, int N,
                                float ee) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N || S == 0) return;
  // A starts at T_final * ct_last; T_final from the last row's entry state
  const size_t il = static_cast<size_t>(S - 1) * N + n;
  const float tl = t_in[il];
  const float al = (tl >= ee) ? alpha[il] : 0.f;
  float A = __fmul_rn(__fmul_rn(tl, __fsub_rn(1.f, al)), ct_last[n]);
#pragma unroll 8
  for (int s = S - 1; s >= 0; --s) {
    const size_t i = static_cast<size_t>(s) * N + n;
    // all three loads are unconditional so the unrolled loop keeps them
    // in flight; a load predicated on the loaded T would serialise them
    const float T = t_in[i];
    const float a = alpha[i];
    const float c = ct_w[i];
    const bool live = T >= ee;
    const float a_eff = live ? a : 0.f;
    const float grad = __fsub_rn(
        __fmul_rn(T, c), __fdiv_rn(A, fmaxf(__fsub_rn(1.f, a_eff), 1e-10f)));
    d_alpha[i] = live ? grad : 0.f;
    A = __fadd_rn(A, __fmul_rn(__fmul_rn(a_eff, T), c));
  }
}

constexpr int kBlock = 64;

}  // namespace

// alpha, w, t_in: [S, N] f32; last: [N] f32.
ESR_EXPORT int esr_scan_fwd(const void* alpha, void* w, void* t_in,
                            void* last, int S, int N, float ee,
                            void* stream) {
  if (N > 0) {
    scan_fwd_kernel<<<(N + kBlock - 1) / kBlock, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(alpha), static_cast<float*>(w),
        static_cast<float*>(t_in), static_cast<float*>(last), S, N, ee);
  }
  return static_cast<int>(cudaGetLastError());
}

// alpha, t_in, ct_w, d_alpha: [S, N] f32; ct_last: [N] f32.
ESR_EXPORT int esr_scan_bwd(const void* alpha, const void* t_in,
                            const void* ct_w, const void* ct_last,
                            void* d_alpha, int S, int N, float ee,
                            void* stream) {
  if (N > 0) {
    scan_bwd_kernel<<<(N + kBlock - 1) / kBlock, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(alpha), static_cast<const float*>(t_in),
        static_cast<const float*>(ct_w), static_cast<const float*>(ct_last),
        static_cast<float*>(d_alpha), S, N, ee);
  }
  return static_cast<int>(cudaGetLastError());
}
