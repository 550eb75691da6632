// The flash-attention experiments X1 and X2 for Hopper (sm_90a), bound to
// Python with ctypes (sdxl_tpu_torch/scripts/exp_flash_exp2.py and
// exp_flash_floor.py).
//
// Replaces the Pallas TPU kernels of
//   X1: scripts/exp_flash_exp2.py `flash2` -> `_kernel` (call :81): the
//       exp2 flash forward with the scale applied to the f32 logits;
//   X2: scripts/exp_flash_floor.py `attn` -> `make_kernel(mode)` (call
//       :103): timing variants of the same forward that strip parts of the
//       online softmax, to split a call's time:
//         full      X1 itself;
//         qscaled   q arrives pre-scaled and rounded to bf16 (the wrapper
//                   does it, as the reference does outside its kernel), so
//                   the kernel skips the multiply of the logits;
//         noexp     p = (s - m_new) * 0.01 + 0.5 and alpha likewise, in
//                   place of exp2. With m starting at -inf, the first tile
//                   gives alpha = -inf, l = -inf * 0 and acc = 0 * -inf, so
//                   the output is NaN everywhere, as the reference's is: a
//                   timing variant, kept so;
//         mxu_only  p = the scaled logits rounded to bf16, no max and no l;
//                   acc sums p v and the output is acc * (1 / 4096).
// Inputs are bf16 [B*H, T, D], T divisible by both tiles (the wrapper
// raises otherwise: the reference leaves the last query rows unwritten and
// drops the last keys there).
//
// Bound. 4*B*H*T^2*D tensor-core operations at 989 TFLOP/s: at T=4096,
// D=64, B*H=20 one call is 86 GFLOP against 42 MB of q/k/v/o, far above
// the card's ~295 FLOP/byte ridge. The design is K1's first bf16 route
// (an mma.sync kernel, since replaced by flash_hopper.cu's wgmma kernel),
// so that the variants time that route's own structure:
// BQ/16 warps each own 16 query rows and run mma.sync m16n8k16 (bf16 in,
// f32 accumulate); S = Q K^T stays in registers, the softmax runs on the
// accumulator fragments with quad shuffles, and the f32 fragment of S is
// re-packed in place as the bf16 A operand of P V. K is staged row-major
// and V transposed in padded shared memory, synchronously. The tile (BQ,
// BK) is a template parameter, X1's sweep: the reference's 512-4096 VMEM
// blocks do not fit a 227 KB shared memory, so BQ is 64 or 128 (4 or 8
// warps) and BK 64 or 128. X2 runs at K1's tile, 64 x 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace {

using flash::allow_smem_once;
using flash::ld32;
using flash::mma_16816;
using flash::pack_bf16;

enum Mode { kFull = 0, kQScaled = 1, kNoExp = 2, kMxuOnly = 3 };

template <int D, int BQ, int BK>
constexpr int exp_smem_bytes() {
  return (BQ * (D + 8) + BK * (D + 8) + D * (BK + 8)) * 2;
}

template <int D, int BQ, int BK, int MODE>
__global__ void __launch_bounds__(BQ / 16 * 32)
flash_exp(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
          int t, float scale) {
  constexpr int NT = BQ / 16 * 32;
  constexpr int LD = D + 8;    // Q and K tiles: [row][LD]
  constexpr int LDV = BK + 8;  // transposed V tile: [d][LDV]
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sVt = sK + BK * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * t * D;

  for (int i = tid; i < BQ * D / 8; i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(sQ + r * LD + c) =
        *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * D + c);
  }
  __syncthreads();

  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qw = sQ + warp * 16 * LD;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tg * 2;
      qa[kk][0] = ld32(qw + g * LD + c);
      qa[kk][1] = ld32(qw + (g + 8) * LD + c);
      qa[kk][2] = ld32(qw + g * LD + c + 8);
      qa[kk][3] = ld32(qw + (g + 8) * LD + c + 8);
    }
  }

  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp
  float l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int k0 = 0; k0 < t; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * D / 8; i += NT) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const size_t off = base + (size_t)(k0 + r) * D + c;
      *reinterpret_cast<uint4*>(sK + r * LD + c) =
          *reinterpret_cast<const uint4*>(k + off);
      const uint4 vx = *reinterpret_cast<const uint4*>(v + off);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * LDV + r] = ve[j];
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sK + (nt * 8 + g) * LD + tg * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_16816(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      if (MODE != kQScaled) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= scale;  // base-2 logits, f32
      }
    }

    if (MODE != kMxuOnly) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      float alpha[2], m_new[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        m_new[i] = fmaxf(m_run[i], mx[i]);
        alpha[i] = MODE == kNoExp ? (m_run[i] - m_new[i]) * 0.01f + 0.5f
                                  : exp2f(m_run[i] - m_new[i]);
        m_run[i] = m_new[i];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[nt][e] - m_new[e >> 1];
          s[nt][e] = MODE == kNoExp ? x * 0.01f + 0.5f : exp2f(x);
          rs[e >> 1] += s[nt][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l_run[i] = alpha[i] * l_run[i] + rs[i];
      }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
      }
    }

    // acc += P V, p rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr = sVt + (dt * 8 + g) * LDV + kk * 16 + tg * 2;
        mma_16816(acc[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    inv[i] = MODE == kMxuOnly ? 1.f / 4096.f : 1.f / l_run[i];
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)r0 * D + c) =
        __floats2bfloat162_rn(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)(r0 + 8) * D + c) =
        __floats2bfloat162_rn(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
}

template <int D, int BQ, int BK, int MODE>
int launch_exp(const void* q, const void* k, const void* v, void* o, int bh,
               int tq, int tk, int d, float scale, void* stream) {
  if (d != D || tq != tk || tq % BQ || tk % BK) return cudaErrorInvalidValue;
  constexpr int smem = exp_smem_bytes<D, BQ, BK>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err =
      allow_smem_once(flash_exp<D, BQ, BK, MODE>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(tq / BQ, bh);
  flash_exp<D, BQ, BK, MODE><<<grid, BQ / 16 * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), tq,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous bf16 [B*H, T, D] device buffers with D = 64 and T
// divisible by the tile; scale = d^-0.5 * log2(e) (ignored by qscaled,
// whose q arrives pre-scaled). Returns a cudaError_t; 0 means launched.
#define SDXL_EXP_EXPORT(name, BQ, BK, MODE)                                  \
  extern "C" int name(const void* q, const void* k, const void* v, void* o,  \
                      int bh, int tq, int tk, int d, float scale,            \
                      void* stream) {                                        \
    return launch_exp<64, BQ, BK, MODE>(q, k, v, o, bh, tq, tk, d, scale,    \
                                        stream);                            \
  }
// X1, one export per tile
SDXL_EXP_EXPORT(sdxl_flash2_bf16_q64_k64, 64, 64, kFull)
SDXL_EXP_EXPORT(sdxl_flash2_bf16_q64_k128, 64, 128, kFull)
SDXL_EXP_EXPORT(sdxl_flash2_bf16_q128_k64, 128, 64, kFull)
SDXL_EXP_EXPORT(sdxl_flash2_bf16_q128_k128, 128, 128, kFull)
// X2, one export per mode at 64 x 64 (full shares X1's instance)
SDXL_EXP_EXPORT(sdxl_flash_floor_full_bf16, 64, 64, kFull)
SDXL_EXP_EXPORT(sdxl_flash_floor_qscaled_bf16, 64, 64, kQScaled)
SDXL_EXP_EXPORT(sdxl_flash_floor_noexp_bf16, 64, 64, kNoExp)
SDXL_EXP_EXPORT(sdxl_flash_floor_mxu_only_bf16, 64, 64, kMxuOnly)
