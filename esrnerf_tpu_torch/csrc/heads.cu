// Fused eval heads of the fine renderer: both radiance heads, the three
// tone-mapper passes and the per-ray weighted sums in one pass over 64-row
// tiles of the march's cell-sorted head rows.
//
// Replaces no Pallas kernel: the JAX package leaves the eval heads to XLA
// (esrnerf_tpu/models/voxurff.py::forward_evaluate). It replaces the port's
// eager chain in VoxurfF.forward_evaluate -- apply_mlp for the off and emo
// heads, three apply_tonemapper calls and eight segment_to_rays
// (index_add_) calls -- which ran over the march's whole static phase-2
// budget, although only the rows before its device-side n_valid are live.
// Contract, for each row r < *n_valid (every other row is not read):
//   x_h   = bf16([gv_h[r] | feat[r]])                      h in {off, emo}
//   lin_h = softplus(L3(q(relu(L2(q(relu(L1(q(relu(L0(x_h))))))))))
//   lin_on = lin_off + lin_emo
//   srgb_t = sigmoid(T1(q(relu(T0(q([lin_t | sin(lin_t 2^i) | cos(..)]))))))
//   out[k][ray_id[r]] += w[r] * v_k[r]
// where q rounds to bf16, L(x) = x @ bf16(W) + bf16(b) with the products
// exact and the sums in f32 (models/mlp.py::apply_mlp), the encodings are
// ordered (channel, frequency) as apply_tonemapper's, and v_k runs over
// srgb_off, lin_off, srgb_on, lin_on, srgb_emo, lin_emo, nrm[r] (3 each)
// and step_id[r] * stepdist. out is 7 [n_rays, 3] blocks and one [n_rays]
// block, zeroed by the caller; the sums are float atomics, in no fixed
// order, as index_add_'s are. The heads are 192 wide with in <= 96 (the
// fine configuration's 85 -> 192 x 3 -> 3); the tone-mapper 33 -> 192 -> 3
// (in = 3 + 6 P <= 48).
//
// Bound on the H100: at the render chunk's ~10,000 live rows, ~4 GFLOP is
// microseconds of tensor-core time, and the weights (~0.8 MB in f32) are
// read from L2 by every tile; all of a chunk's 262,144 rows live is
// ~106 GFLOP, ~0.11 ms at the bf16 peak. So the kernel is built to skip
// pad tiles at no cost and to keep every activation on chip.
//
// Design: a block of four warps owns 64 rows and returns at once if they
// start at or past *n_valid (no host sync, as csrc/gather.cu's pad tiles).
// Each warp owns 16 rows and runs every layer as mma.sync m16n8k16 (bf16
// operands, f32 accumulators). A layer's weights are staged in shared
// memory as bf16 [in][out] rows (converted from f32 in the copy) and read
// as B fragments by ldmatrix.trans; the first layer's A fragments come
// from the staged input tile by ldmatrix. After a hidden layer, the bias,
// ReLU and bf16 rounding turn the warp's f32 accumulators for two adjacent
// 8-column tiles directly into the next layer's A fragment of 16 columns,
// so the 192-wide activations stay in registers between layers. Each warp
// builds its own rows' tone-mapper encodings. A row's 22 results go to a
// shared [64][22] tile, and the block ends with one atomic per live row
// and value. Shared memory (~96 KB) lets two blocks share an SM, so one
// block's weight staging overlaps another's products.

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRows = 64;          // rows per block: 16 per warp
constexpr int kThreads = 128;
constexpr int kHidden = 192;       // head and tone-mapper width
constexpr int kIn0 = 96;           // padded head input (<= 96 columns)
constexpr int kTmIn = 48;          // padded tone-mapper input
constexpr int kOut = 3;
constexpr int kNOut = 8;           // padded output columns (one n-tile)
constexpr int kVals = 22;          // per-row values summed per ray
// shared-memory row strides in bf16 elements: 16-byte aligned rows whose
// eight ldmatrix row addresses fall in distinct 16-byte bank groups
constexpr int kWS = kHidden + 8;   // 400 B
constexpr int kW3S = 24;           // 48 B, [192][8] output weights
constexpr int kXS = kIn0 + 8;      // 208 B
constexpr int kWBytes = kHidden * kWS * 2;
constexpr int kTm1Off = kTmIn * kWS * 2;  // tone-mapper W1 after its W0
constexpr int kXBytes = kRows * kXS * 2;
constexpr int kSmem = kWBytes + kXBytes + (kHidden + kNOut) * 4 +
                      kRows * kVals * 4;
// row offset of each value block in vals / out
constexpr int kSrgbOff = 0, kLinOff = 3, kSrgbOn = 6, kLinOn = 9,
              kSrgbEmo = 12, kLinEmo = 15, kNrm = 18, kDepth = 21;

struct HeadsArgs {
  const float* gv[2];  // [M, C_g] color-grid samples, off and emo
  const float* feat;   // [M, F]
  const float* nrm;    // [M, 3]
  const float* w;      // [M]
  const long long* ray_id;   // [M]
  const long long* step_id;  // [M]
  const int* n_valid;        // device scalar or null (every row live)
  const float* hw[2][4];     // [in, out] f32 weights of each head
  const float* hb[2][4];
  const float* tw[2];        // tone-mapper
  const float* tb[2];
  float* out;                // [22 * n_rays]
  int M, n_rays, C_g, F, P;
  float stepdist;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float relu(float x) { return x > 0.f ? x : 0.f; }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
      : "=r"(r0), "=r"(r1)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block-wide: W [k_in, n] f32 row-major -> dst [k_pad][stride] bf16, zero
// past k_in rows and n columns up to n_pad.
__device__ void stage_w(const float* __restrict__ W, int k_in, int n,
                        int k_pad, int n_pad, __nv_bfloat16* dst,
                        int stride) {
  if (n == n_pad && (n & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(W) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < k_pad * n4; i += blockDim.x) {
      const int k = i / n4, c = (i - k * n4) << 2;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < k_in)
        v = *reinterpret_cast<const float4*>(W + static_cast<size_t>(k) * n +
                                             c);
      uint2 p;
      p.x = pack_bf16(v.x, v.y);
      p.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(dst + k * stride + c) = p;
    }
    return;
  }
  for (int i = threadIdx.x; i < k_pad * n_pad; i += blockDim.x) {
    const int k = i / n_pad, c = i - k * n_pad;
    const float v = (k < k_in && c < n) ? W[static_cast<size_t>(k) * n + c]
                                        : 0.f;
    dst[k * stride + c] = __float2bfloat16_rn(v);
  }
}

// Block-wide: bias[c] = bf16(b[c]) as f32 for c < n, 0 up to n_pad.
__device__ void stage_b(const float* __restrict__ b, int n, int n_pad,
                        float* dst) {
  for (int c = threadIdx.x; c < n_pad; c += blockDim.x)
    dst[c] = c < n ? round_bf16(b[c]) : 0.f;
}

// This warp's A fragments of kt k-tiles from a bf16 [rows][kXS] tile.
template <int KT>
__device__ __forceinline__ void load_a(uint32_t (&a)[KT][4], uint32_t x_base,
                                       int row0, int lane) {
  const int mat = lane >> 3, r = lane & 7;
  const uint32_t addr =
      x_base + ((row0 + (mat & 1) * 8 + r) * kXS + (mat >> 1) * 8) * 2;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) ldsm_x4(a[kt], addr + kt * 32);
}

// acc = A (this warp's 16 rows x 16 KT) @ W (16 KT x 8 NT), W a bf16
// [k][stride] tile in shared memory at w_base.
template <int KT, int NT>
__device__ __forceinline__ void layer(float (&acc)[NT][4],
                                      const uint32_t (&a)[KT][4],
                                      uint32_t w_base, int stride, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int mat = lane >> 3, r = lane & 7;
  if constexpr (NT == 1) {
    const uint32_t base = w_base + ((mat & 1) * 8 + r) * stride * 2;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t b0, b1;
      ldsm_x2_t(b0, b1, base + kt * 16 * stride * 2);
      mma_bf16(acc[0], a[kt], b0, b1);
    }
  } else {
    static_assert(NT % 2 == 0, "pairs of n-tiles");
    const uint32_t base =
        w_base + (((mat & 1) * 8 + r) * stride + (mat >> 1) * 8) * 2;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, base + (kt * 16 * stride + np * 16) * 2);
        mma_bf16(acc[2 * np], a[kt], b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a[kt], b[2], b[3]);
      }
    }
  }
}

// Bias, ReLU and bf16 rounding of a hidden layer's accumulators, as the
// next layer's A fragments: n-tiles 2k and 2k+1 make k-tile k.
template <int NT>
__device__ __forceinline__ void hidden_to_a(const float (&acc)[NT][4],
                                            uint32_t (&a)[NT / 2][4],
                                            const float* bias, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t;
    const float b0 = bias[c], b1 = bias[c + 1];
    a[j >> 1][(j & 1) * 2] = pack_bf16(relu(acc[j][0] + b0),
                                       relu(acc[j][1] + b1));
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(relu(acc[j][2] + b0),
                                           relu(acc[j][3] + b1));
  }
}

// The output layer's three columns of this warp's rows, plus bias and f,
// into vals[row][slot + col].
template <typename Fn>
__device__ __forceinline__ void output_to_vals(const float (&acc)[1][4],
                                               const float* bias, float* vals,
                                               int row0, int slot, int lane,
                                               Fn f) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = 2 * t + (e & 1);
    const int row = row0 + g + (e >> 1) * 8;
    if (col < kOut) vals[row * kVals + slot + col] = f(acc[0][e] + bias[col]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    eval_heads_kernel(const __grid_constant__ HeadsArgs args) {
  const int m0 = blockIdx.x * kRows;
  const int nv = esr_n_valid(args.n_valid, args.M);
  if (m0 >= nv) return;  // a pad tile: nothing to read or add
  const int np = min(kRows, args.M - m0);  // rows that exist
  const int live = min(kRows, nv - m0);

  extern __shared__ __align__(128) unsigned char smem[];
  auto* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* xbuf = reinterpret_cast<__nv_bfloat16*>(smem + kWBytes);
  float* bias = reinterpret_cast<float*>(smem + kWBytes + kXBytes);
  float* bias_out = bias + kHidden;
  float* vals = bias_out + kNOut;
  const uint32_t w_s = smem_u32(wbuf), x_s = smem_u32(xbuf);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;
  const int C_g = args.C_g, F = args.F, in0 = C_g + F;

  // the input tile's features (shared by both heads) and zero padding
  {
    const float* feat = args.feat + static_cast<size_t>(m0) * F;
    for (int i = threadIdx.x; i < np * F; i += kThreads) {
      const int r = i / F;
      xbuf[r * kXS + C_g + (i - r * F)] = __float2bfloat16_rn(feat[i]);
    }
    for (int i = threadIdx.x; i < kRows * kIn0; i += kThreads) {
      const int r = i / kIn0, c = i - r * kIn0;
      if (r >= np || c >= in0) xbuf[r * kXS + c] = __float2bfloat16_rn(0.f);
    }
  }

  uint32_t a[kHidden / 16][4];
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    // layer 0: the head's grid samples beside the shared features
    {
      const float* gv = args.gv[h] + static_cast<size_t>(m0) * C_g;
      for (int i = threadIdx.x; i < np * C_g; i += kThreads) {
        const int r = i / C_g;
        xbuf[r * kXS + (i - r * C_g)] = __float2bfloat16_rn(gv[i]);
      }
    }
    stage_w(args.hw[h][0], in0, kHidden, kIn0, kHidden, wbuf, kWS);
    stage_b(args.hb[h][0], kHidden, kHidden, bias);
    __syncthreads();
    {
      uint32_t x[kIn0 / 16][4];
      load_a<kIn0 / 16>(x, x_s, row0, lane);
      float acc[kHidden / 8][4];
      layer<kIn0 / 16, kHidden / 8>(acc, x, w_s, kWS, lane);
      hidden_to_a<kHidden / 8>(acc, a, bias, lane);
    }
    // layers 1 and 2: 192 -> 192 from registers
#pragma unroll 1
    for (int l = 1; l < 3; ++l) {
      __syncthreads();
      stage_w(args.hw[h][l], kHidden, kHidden, kHidden, kHidden, wbuf, kWS);
      stage_b(args.hb[h][l], kHidden, kHidden, bias);
      __syncthreads();
      float acc[kHidden / 8][4];
      layer<kHidden / 16, kHidden / 8>(acc, a, w_s, kWS, lane);
      hidden_to_a<kHidden / 8>(acc, a, bias, lane);
    }
    // layer 3: 192 -> 3, softplus
    __syncthreads();
    stage_w(args.hw[h][3], kHidden, kOut, kHidden, kNOut, wbuf, kW3S);
    stage_b(args.hb[h][3], kOut, kNOut, bias_out);
    __syncthreads();
    {
      float acc[1][4];
      layer<kHidden / 16, 1>(acc, a, w_s, kW3S, lane);
      output_to_vals(acc, bias_out, vals, row0, h ? kLinEmo : kLinOff, lane,
                     [](float v) { return v > 20.f ? v : log1pf(expf(v)); });
    }
    __syncthreads();
  }

  // the tone-mapper: W0 then W1 in the weight buffer
  const int tm_in = 3 + 6 * args.P;
  stage_w(args.tw[0], tm_in, kHidden, kTmIn, kHidden, wbuf, kWS);
  stage_w(args.tw[1], kHidden, kOut, kHidden, kNOut,
          reinterpret_cast<__nv_bfloat16*>(smem + kTm1Off), kW3S);
  stage_b(args.tb[0], kHidden, kHidden, bias);
  stage_b(args.tb[1], kOut, kNOut, bias_out);
  __syncthreads();
  const int P = args.P;
#pragma unroll 1
  for (int t = 0; t < 3; ++t) {  // off, emo, on
    const int lin_slot = t == 0 ? kLinOff : (t == 1 ? kLinEmo : kLinOn);
    const int srgb_slot = t == 0 ? kSrgbOff : (t == 1 ? kSrgbEmo : kSrgbOn);
    if (t == 2) {  // lin_on of this warp's rows
      for (int i = lane; i < 16 * 3; i += 32) {
        float* v = vals + (row0 + i / 3) * kVals;
        v[kLinOn + i % 3] = v[kLinOff + i % 3] + v[kLinEmo + i % 3];
      }
      __syncwarp();
    }
    // this warp's rows: lin, then sin and cos of lin * 2^i by (channel, i)
    for (int i = lane; i < 16 * kTmIn; i += 32) {
      const int r = row0 + i / kTmIn, c = i % kTmIn;
      const float* lin = vals + r * kVals + lin_slot;
      float f = 0.f;
      if (c < 3) {
        f = lin[c];
      } else if (c < 3 + 3 * P) {
        const int q = c - 3, ch = q / P;
        f = sinf(lin[ch] * static_cast<float>(1 << (q - ch * P)));
      } else if (c < 3 + 6 * P) {
        const int q = c - 3 - 3 * P, ch = q / P;
        f = cosf(lin[ch] * static_cast<float>(1 << (q - ch * P)));
      }
      xbuf[r * kXS + c] = __float2bfloat16_rn(f);
    }
    __syncwarp();
    {
      uint32_t x[kTmIn / 16][4];
      load_a<kTmIn / 16>(x, x_s, row0, lane);
      float acc[kHidden / 8][4];
      layer<kTmIn / 16, kHidden / 8>(acc, x, w_s, kWS, lane);
      hidden_to_a<kHidden / 8>(acc, a, bias, lane);
    }
    {
      float acc[1][4];
      layer<kHidden / 16, 1>(acc, a, w_s + kTm1Off, kW3S, lane);
      output_to_vals(acc, bias_out, vals, row0, srgb_slot, lane,
                     [](float v) { return 1.f / (1.f + expf(-v)); });
    }
    __syncwarp();
  }
  __syncthreads();

  // the per-ray sums of the live rows
  const int n_rays = args.n_rays;
  for (int i = threadIdx.x; i < live * kVals; i += kThreads) {
    const int r = i / kVals, k = i - r * kVals;
    const size_t row = static_cast<size_t>(m0) + r;
    const long long rid = args.ray_id[row];
    if (rid < 0 || rid >= n_rays) continue;
    float v;
    if (k < kNrm) {
      v = vals[r * kVals + k];
    } else if (k < kDepth) {
      v = args.nrm[row * 3 + (k - kNrm)];
    } else {
      v = __fmul_rn(static_cast<float>(args.step_id[row]), args.stepdist);
    }
    const size_t dst = k < kDepth
                           ? static_cast<size_t>(k / 3) * 3 * n_rays +
                                 static_cast<size_t>(rid) * 3 + k % 3
                           : static_cast<size_t>(kDepth) * n_rays + rid;
    atomicAdd(args.out + dst, __fmul_rn(args.w[row], v));
  }
}

}  // namespace

// ptrs, in order: gv_off, gv_emo [M, C_g]; feat [M, F]; nrm [M, 3]; w [M]
// (f32); ray_id, step_id [M] (i64); n_valid (device i32 scalar or null);
// the off head's W0..W3 then b0..b3; the emo head's the same; the
// tone-mapper's W0, W1, b0, b1 (f32, W [in, out]); out [22 * n_rays] f32,
// zeroed. P: the tone-mapper's frequencies (its input is 3 + 6 P wide).
ESR_EXPORT int esr_eval_heads(const void* const* ptrs, int M, int n_rays,
                              int C_g, int F, int P, float stepdist,
                              void* stream) {
  if (C_g < 1 || F < 0 || C_g + F > kIn0 || P < 0 || 3 + 6 * P > kTmIn ||
      n_rays < 0 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || n_rays == 0) return 0;
  HeadsArgs a{};
  int i = 0;
  auto f = [&]() { return static_cast<const float*>(ptrs[i++]); };
  a.gv[0] = f();
  a.gv[1] = f();
  a.feat = f();
  a.nrm = f();
  a.w = f();
  a.ray_id = static_cast<const long long*>(ptrs[i++]);
  a.step_id = static_cast<const long long*>(ptrs[i++]);
  a.n_valid = static_cast<const int*>(ptrs[i++]);
  for (int h = 0; h < 2; ++h) {
    for (int l = 0; l < 4; ++l) a.hw[h][l] = f();
    for (int l = 0; l < 4; ++l) a.hb[h][l] = f();
  }
  a.tw[0] = f();
  a.tw[1] = f();
  a.tb[0] = f();
  a.tb[1] = f();
  a.out = static_cast<float*>(const_cast<void*>(ptrs[i++]));
  a.M = M;
  a.n_rays = n_rays;
  a.C_g = C_g;
  a.F = F;
  a.P = P;
  a.stepdist = stepdist;
  const cudaError_t e = cudaFuncSetAttribute(
      eval_heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((M + kRows - 1) / kRows);
  eval_heads_kernel<<<blocks, kThreads, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
