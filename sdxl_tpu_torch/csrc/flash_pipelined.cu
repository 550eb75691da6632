// The software-pipelined flash-attention experiment X3 for Hopper
// (sm_90a), bound to Python with ctypes
// (sdxl_tpu_torch/scripts/exp_flash_pipelined.py).
//
// Replaces the Pallas TPU kernel of scripts/exp_flash_pipelined.py
// `flash_pipelined` -> `_kernel` (call :104): K1's function on T that the
// tile divides. q arrives pre-scaled by d^-0.5 * log2(e) and rounded to
// bf16 (the wrapper does it, as the reference does outside its kernel,
// :100); base-2 online softmax with f32 m, l and acc; p rounded to bf16
// before P V; the output acc / l in bf16.
//
// Bound. 4*B*H*T^2*D tensor-core operations at 989 TFLOP/s, as K1.
//
// The TPU design ping-pongs the f32 logits tile between two VMEM buffers
// and lags V's block index one grid step behind K's, so the next block's
// QK product on the MXU overlaps this block's softmax on the VPU. On
// Hopper the counterpart is:
//   - K and V tiles in a two-stage ring in shared memory, filled by
//     cp.async (no registers on the copy), K and V in separate commit
//     groups: K of tile j+2 is issued as soon as QK of tile j has read its
//     stage, V of tile j+2 as soon as P V of tile j has, so each copy
//     overlaps a whole tile's work;
//   - in the key loop, the QK product of tile j+1 is issued into a second
//     S register fragment before the softmax and P V of tile j, so the
//     tensor-core work and the softmax's FP32 and SFU work are independent
//     instructions the warp schedulers can interleave;
//   - V is kept row-major (cp.async cannot transpose) and its P V B
//     fragments are read with ldmatrix.trans, where K1 transposes V with
//     scalar shared-memory stores.
// mma.sync m16n8k16 as K1, BQ/16 warps of 16 query rows; the tiles are
// X1's (BQ 64 or 128, BK 64 or 128). The second S fragment costs BK/2 f32
// registers a thread (32 at BK = 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace {

using flash::allow_smem_once;
using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::ld32;
using flash::ldmatrix_x4_trans;
using flash::mma_16816;
using flash::pack_bf16;

template <int D, int BQ, int BK>
constexpr int pipe_smem_bytes() {
  return (BQ + 4 * BK) * (D + 8) * 2;  // Q, and two stages of K and of V
}

// Rows [0, ROWS) of a [*, D] bf16 matrix into a [ROWS][D + 8] tile.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src) {
  for (int i = threadIdx.x; i < ROWS * D / 8; i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    cp_async16(dst + r * (D + 8) + c, src + (size_t)r * D + c);
  }
}

// s = this warp's 16 query rows times the BK keys of a K stage.
template <int D, int BK>
__device__ __forceinline__ void qk(float (&s)[BK / 8][4],
                                   uint32_t (&qa)[D / 16][4],
                                   const __nv_bfloat16* sk, int g, int tg) {
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* kr = sk + (nt * 8 + g) * (D + 8) + tg * 2;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_16816(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
  }
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 16 * 32)
flash_pipelined(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int t) {
  constexpr int NT = BQ / 16 * 32;
  constexpr int LD = D + 8;
  constexpr int STAGE = BK * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LD]
  __nv_bfloat16* sK = sQ + BQ * LD;                             // [2][BK][LD]
  __nv_bfloat16* sV = sK + 2 * STAGE;                           // [2][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * t * D;
  const __nv_bfloat16* kg = k + base;
  const __nv_bfloat16* vg = v + base;
  const int n_kt = t / BK;

  // Prologue. Commit groups, in order: (Q, K0, V0), K1, V1; then each
  // iteration commits one K and one V group (empty past the last tile), so
  // the wait counts below are the same in every iteration.
  copy_tile<BQ, D, NT>(sQ, q + base + (size_t)q0 * D);
  copy_tile<BK, D, NT>(sK, kg);
  copy_tile<BK, D, NT>(sV, vg);
  cp_async_commit();
  if (n_kt > 1) copy_tile<BK, D, NT>(sK + STAGE, kg + (size_t)BK * D);
  cp_async_commit();
  if (n_kt > 1) copy_tile<BK, D, NT>(sV + STAGE, vg + (size_t)BK * D);
  cp_async_commit();
  cp_async_wait<2>();
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

  float s[BK / 8][4], s_next[BK / 8][4];
  qk<D, BK>(s, qa, sK, g, tg);

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    cp_async_wait<1>();  // K of tile j+1 has landed (V of j+1 may not)
    __syncthreads();     // ... for every thread; and QK of tile j is done
    if (j + 2 < n_kt)
      copy_tile<BK, D, NT>(sK + st * STAGE, kg + (size_t)(j + 2) * BK * D);
    cp_async_commit();
    // the next tile's QK product, ahead of this tile's softmax and P V
    if (j + 1 < n_kt) qk<D, BK>(s_next, qa, sK + (st ^ 1) * STAGE, g, tg);
    cp_async_wait<2>();  // V of tile j has landed
    __syncthreads();

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
      alpha[i] = exp2f(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m_new[e >> 1]);
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

    // acc += P V; lane l addresses row l % 8 of matrix l / 8: keys
    // (l / 8 % 2) * 8 + l % 8 of the 16-key step, columns of d tile
    // dt + l / 16
    const __nv_bfloat16* sv = sV + st * STAGE +
                              ((lane >> 3 & 1) * 8 + (lane & 7)) * LD +
                              (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sv + kk * 16 * LD + dt * 8);
        mma_16816(acc[dt], pa, b[0], b[1]);
        mma_16816(acc[dt + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with V of tile j
    if (j + 2 < n_kt)
      copy_tile<BK, D, NT>(sV + st * STAGE, vg + (size_t)(j + 2) * BK * D);
    cp_async_commit();

#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s_next[nt][e];
  }

  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)r0 * D + c) =
        __floats2bfloat162_rn(acc[dt][0] / l_run[0], acc[dt][1] / l_run[0]);
    *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)(r0 + 8) * D + c) =
        __floats2bfloat162_rn(acc[dt][2] / l_run[1], acc[dt][3] / l_run[1]);
  }
}

template <int D, int BQ, int BK>
int launch_pipelined(const void* q, const void* k, const void* v, void* o,
                     int bh, int tq, int tk, int d, void* stream) {
  if (d != D || tq != tk || tq % BQ || tk % BK) return cudaErrorInvalidValue;
  constexpr int smem = pipe_smem_bytes<D, BQ, BK>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(flash_pipelined<D, BQ, BK>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(tq / BQ, bh);
  flash_pipelined<D, BQ, BK><<<grid, BQ / 16 * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), tq);
  return cudaGetLastError();
}

}  // namespace

// q (pre-scaled), k, v, o: contiguous bf16 [B*H, T, D] device buffers with
// D = 64 and T divisible by the tile; scale is unused (q carries it).
// Returns a cudaError_t; 0 means the kernel was launched.
#define SDXL_PIPELINED_EXPORT(name, BQ, BK)                                  \
  extern "C" int name(const void* q, const void* k, const void* v, void* o,  \
                      int bh, int tq, int tk, int d, float /*scale*/,        \
                      void* stream) {                                        \
    return launch_pipelined<64, BQ, BK>(q, k, v, o, bh, tq, tk, d, stream);  \
  }
SDXL_PIPELINED_EXPORT(sdxl_flash_pipelined_bf16_q64_k64, 64, 64)
SDXL_PIPELINED_EXPORT(sdxl_flash_pipelined_bf16_q64_k128, 64, 128)
SDXL_PIPELINED_EXPORT(sdxl_flash_pipelined_bf16_q128_k64, 128, 64)
SDXL_PIPELINED_EXPORT(sdxl_flash_pipelined_bf16_q128_k128, 128, 128)
