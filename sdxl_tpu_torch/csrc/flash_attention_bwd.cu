// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernels of sdxl_tpu/ops/flash_attention.py
// `flash_attention_bwd_bhtd` (:342, the FlashAttention-2 backward), which
// take any dtype:
//   K3a `_flash_bwd_dq_kernel` (:272)  -> flash_bwd_dq (bf16),
//                                         flash_bwd_dq_f32 (f32)
//   K3b `_flash_bwd_dkv_kernel` (:302) -> flash_bwd_dkv (bf16),
//                                         flash_bwd_dkv_f32 (f32)
// With qf = bf16(q * d^-0.5 * log2(e)) (the forward's rounded pre-scaled q),
// lse the forward's base-2 row log-sum-exp and delta_i = dO_i . O_i (f32,
// computed by the caller, as the reference computes it outside Pallas):
//   p_ij  = exp2(qf_i . k_j - lse_i)        (the forward's own logits)
//   dp_ij = dO_i . v_j
//   dz_ij = p_ij (dp_ij - delta_i)
//   dq_i  = sum_j bf16(dz_ij) k_j * d^-0.5
//   dk_j  = sum_i bf16(dz_ij) qf_i / log2(e)
//   dv_j  = sum_i bf16(p_ij) dO_i
// Rounding as in the reference: p is rounded to dO's dtype before dv, dz to
// k's / qf's dtype before dq / dk; every product accumulates in f32 and the
// outputs are rounded to bf16 once.
//
// Ragged token counts are masked in-kernel, never padded in device memory:
// query rows >= tq are zero-filled (q and dO) and get p = 0; key columns
// >= tk get p = 0; rows past the edge are never stored.
//
// Design. Two kernels and no atomics, so the result is deterministic: each
// output tile is written by exactly one block, which loops over the other
// axis itself (on the TPU that loop was the sequential last grid axis).
// Four warps each own 16 rows and run mma.sync m16n8k16
// (bf16 in, f32 accumulate); C fragments are re-packed in place as bf16 A
// operands. Bound: 6 (dq) and 8 (dk/dv) x B*H*Tq*Tk*d operations against
// a few MB, far above the card's ~295 FLOP/byte ridge, so tensor-core issue
// and shared-memory traffic bound them. No wgmma, TMA or pipelining yet.
//
// flash_bwd_dq: a block owns (batch*head, 64 query rows); qf and dO of its
//   rows stay in registers as A fragments; per 64-key tile it stages K
//   row-major and transposed and V row-major, forms S = qf K^T and
//   dP = dO V^T, then dq += bf16(dz) K.
// flash_bwd_dkv: a block owns (batch*head, 64 keys) and works in the
//   transposed frame (rows = keys): per 64-query tile it stages qf and dO
//   row-major and transposed, forms S^T = K qf^T and dP^T = V dO^T (K and V
//   A fragments read from shared memory), then dv += bf16(p^T) dO and
//   dk += bf16(dz^T) qf.
//
// flash_bwd_dq_f32, flash_bwd_dkv_f32 (the f32 trainer, d 64 and 128): the
//   same grids, ownership and formulas with every rounding point f32 (qf =
//   q * scale in f32, p and dz unrounded), on the f32 FMA pipes: a TF32
//   product would break the f32 bound, and the tensor-core redesign of K3
//   (bf16 and f32 together, on wgmma) is queued in ROADMAP. Bound: 6 (dq)
//   and 8 (dk/dv) x B*H*Tq*Tk*d operations at 67 TFLOP/s (0.96 / 1.28 ms at
//   [1,10,4096,64]). 256 threads in a 16 x 16 grid: thread (tr, tc) forms
//   the 4 x 4 logits of rows tr + 16 i and keys tc + 16 j (float4 dot
//   products along d; a warp's two row groups read broadcasts, its 16 key
//   rows, padded by 4 floats, hit distinct banks), writes p and dz to
//   shared memory with the rows it owns in the next product side by side,
//   then accumulates 4 rows x D / 16 columns of dq (or of dk and dv) as
//   outer products over the tile's 64 keys (queries). Shared memory: dq
//   87 / 153 kB, dk/dv 105 / 170 kB at d 64 / 128, so two blocks an SM at
//   d = 64 (at most 128 registers a thread), one at 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace {

using flash::allow_smem_once;
using flash::kThreads;
using flash::ld32;
using flash::load_a;
using flash::mma_16816;
using flash::pack_bf16;
using flash::stage_tile;

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr float kInvLog2e = 0.69314718055994531f;  // 1 / log2(e)

template <int D>
constexpr int dq_smem_bytes() {
  // sQ, sdO, sK, sV: [64][D + 8]; sKt: [D][64 + 8]
  return (4 * 64 * (D + 8) + D * (kBK + 8)) * 2;
}

template <int D>
constexpr int dkv_smem_bytes() {
  // sK, sV, sQ, sdO: [64][D + 8]; sQt, sdOt: [D][64 + 8]; lse, delta: [64]
  return (4 * 64 * (D + 8) + 2 * D * (kBQ + 8)) * 2 + 2 * kBQ * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int tq, int tk, float scale,
             float nat_scale) {
  constexpr int LD = D + 8;
  constexpr int LDT = kBK + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + kBQ * LD;
  __nv_bfloat16* sK = sdO + kBQ * LD;
  __nv_bfloat16* sV = sK + kBK * LD;
  __nv_bfloat16* sKt = sV + kBK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const size_t q_base = (size_t)blockIdx.y * tq * D;
  const size_t kv_base = (size_t)blockIdx.y * tk * D;
  const size_t row_base = (size_t)blockIdx.y * tq;

  stage_tile<kBQ, D>(q + q_base, q0, tq, true, scale, sQ, LD, nullptr, 0);
  stage_tile<kBQ, D>(dout + q_base, q0, tq, false, 0.f, sdO, LD, nullptr, 0);
  __syncthreads();

  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qa[kk], sQ, LD, warp * 16, kk * 16, g, tg);
    load_a(da[kk], sdO, LD, warp * 16, kk * 16, g, tg);
  }

  // rows g and g + 8 of this warp; padded rows carry lse = delta = 0 and
  // zero q / dO, and are masked to p = 0 below
  const int r0 = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    row_ok[i] = r < tq;
    lse_r[i] = row_ok[i] ? lse[row_base + r] : 0.f;
    delta_r[i] = row_ok[i] ? delta[row_base + r] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int n_kt = (tk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_tile<kBK, D>(k + kv_base, k0, tk, false, 0.f, sK, LD, sKt, LDT);
    stage_tile<kBK, D>(v + kv_base, k0, tk, false, 0.f, sV, LD, nullptr, 0);
    __syncthreads();

    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      const __nv_bfloat16* kr = sK + (nt * 8 + g) * LD + tg * 2;
      const __nv_bfloat16* vr = sV + (nt * 8 + g) * LD + tg * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_16816(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
        mma_16816(dp[nt], da[kk], ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
      }
    }

    // dz = p (dp - delta), in place of s
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok = row_ok[i] && k0 + nt * 8 + tg * 2 + (e & 1) < tk;
        const float p = ok ? exp2f(s[nt][e] - lse_r[i]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[i]);
      }
    }

    // acc += bf16(dz) K
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t za[4];
      za[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      za[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      za[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      za[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* kr = sKt + (dt * 8 + g) * LDT + kk * 16 + tg * 2;
        mma_16816(acc[dt], za, ld32(kr), ld32(kr + 8));
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    if (row_ok[0])
      *reinterpret_cast<__nv_bfloat162*>(dq + q_base + (size_t)r0 * D + c) =
          __floats2bfloat162_rn(acc[dt][0] * nat_scale, acc[dt][1] * nat_scale);
    if (row_ok[1])
      *reinterpret_cast<__nv_bfloat162*>(dq + q_base + (size_t)(r0 + 8) * D + c) =
          __floats2bfloat162_rn(acc[dt][2] * nat_scale, acc[dt][3] * nat_scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              int tq, int tk, float scale) {
  constexpr int LD = D + 8;
  constexpr int LDT = kBQ + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kBK * LD;
  __nv_bfloat16* sQ = sV + kBK * LD;
  __nv_bfloat16* sdO = sQ + kBQ * LD;
  __nv_bfloat16* sQt = sdO + kBQ * LD;
  __nv_bfloat16* sdOt = sQt + D * LDT;
  float* sLse = reinterpret_cast<float*>(sdOt + D * LDT);
  float* sDelta = sLse + kBQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int k0 = blockIdx.x * kBK;
  const size_t q_base = (size_t)blockIdx.y * tq * D;
  const size_t kv_base = (size_t)blockIdx.y * tk * D;
  const size_t row_base = (size_t)blockIdx.y * tq;

  stage_tile<kBK, D>(k + kv_base, k0, tk, false, 0.f, sK, LD, nullptr, 0);
  stage_tile<kBK, D>(v + kv_base, k0, tk, false, 0.f, sV, LD, nullptr, 0);

  // keys g and g + 8 of this warp (the rows of the transposed frame)
  const int key0 = k0 + warp * 16 + g;
  const bool key_ok[2] = {key0 < tk, key0 + 8 < tk};

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[dt][e] = adv[dt][e] = 0.f;

  const int n_qt = (tq + kBQ - 1) / kBQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // every warp is done with the previous q tile
    stage_tile<kBQ, D>(q + q_base, q0, tq, true, scale, sQ, LD, sQt, LDT);
    stage_tile<kBQ, D>(dout + q_base, q0, tq, false, 0.f, sdO, LD, sdOt, LDT);
    if (threadIdx.x < kBQ) {
      const int r = q0 + threadIdx.x;
      sLse[threadIdx.x] = r < tq ? lse[row_base + r] : 0.f;
      sDelta[threadIdx.x] = r < tq ? delta[row_base + r] : 0.f;
    }
    __syncthreads();

    // S^T = K qf^T and dP^T = V dO^T: 16 keys x 64 query rows per warp
    float s[kBQ / 8][4], dp[kBQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, LD, warp * 16, kk * 16, g, tg);
      load_a(va, sV, LD, warp * 16, kk * 16, g, tg);
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
        const int off = (nt * 8 + g) * LD + kk * 16 + tg * 2;
        mma_16816(s[nt], ka, ld32(sQ + off), ld32(sQ + off + 8));
        mma_16816(dp[nt], va, ld32(sdO + off), ld32(sdO + off + 8));
      }
    }

    // p^T in s, dz^T in dp
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + tg * 2 + (e & 1);  // query row in the tile
        const bool ok = key_ok[e >> 1] && q0 + c < tq;
        const float p = ok ? exp2f(s[nt][e] - sLse[c]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sDelta[c]);
      }
    }

    // dv += bf16(p^T) dO, dk += bf16(dz^T) qf: contract the query axis
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t pa[4], za[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      za[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      za[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      za[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      za[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int off = (dt * 8 + g) * LDT + kk * 16 + tg * 2;
        mma_16816(adv[dt], pa, ld32(sdOt + off), ld32(sdOt + off + 8));
        mma_16816(adk[dt], za, ld32(sQt + off), ld32(sQt + off + 8));
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!key_ok[i]) continue;
      const size_t off = kv_base + (size_t)(key0 + 8 * i) * D + c;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(
          adk[dt][2 * i] * kInvLog2e, adk[dt][2 * i + 1] * kInvLog2e);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(adv[dt][2 * i], adv[dt][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32, d in {64, 128}: the FMA pipes
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // a 16 x 16 grid of threads

template <int D>
struct BwdF32Plan {
  static constexpr int LD = D + 4;    // row stride of the [64][D] tiles
  static constexpr int LZ = 64 + 4;   // row stride of the [64][64] p, dz tiles
  static constexpr int kTile = 64 * LD;
  static constexpr int kZTile = 64 * LZ;
  // dq: qf, dO, K, V and dz; dk/dv: K, V, qf, dO, p^T, dz^T, lse, delta
  static constexpr int kDqSmem = (4 * kTile + kZTile) * 4;
  static constexpr int kDkvSmem = (4 * kTile + 2 * kZTile + 2 * 64) * 4;
};

// Rows [row0, row0 + 64) of a [n_rows, D] f32 matrix into shared memory
// (row stride LD), times `scale`; rows past n_rows zero.
template <int D>
__device__ __forceinline__ void stage_f32(const float* __restrict__ g,
                                          int row0, int n_rows, float scale,
                                          float* s) {
  constexpr int LD = BwdF32Plan<D>::LD;
  for (int i = threadIdx.x; i < 64 * D / 4; i += kF32Threads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) {
      x = *reinterpret_cast<const float4*>(g + (size_t)(row0 + r) * D + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(s + r * LD + c) = x;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

// x[i][j] = a row (ra + 16 i) . b row (rb + 16 j) and y likewise from c and
// e, over D columns of four [64][LD] tiles: the 4x4 logits of thread (ra,
// rb) of S = A B^T and of dP = C E^T.
template <int D>
__device__ __forceinline__ void dots_4x4(const float* a, const float* b,
                                         const float* c, const float* e,
                                         int ra, int rb, float (&x)[4][4],
                                         float (&y)[4][4]) {
  constexpr int LD = BwdF32Plan<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = y[i][j] = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 4) {
    float4 av[4], cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (ra + 16 * i) * LD + d);
      cv[i] = *reinterpret_cast<const float4*>(c + (ra + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 bv =
          *reinterpret_cast<const float4*>(b + (rb + 16 * j) * LD + d);
      const float4 ev =
          *reinterpret_cast<const float4*>(e + (rb + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i][j] = dot4(av[i], bv, x[i][j]);
        y[i][j] = dot4(cv[i], ev, y[i][j]);
      }
    }
  }
}

// acc[i][4u + e] += sum_r z[r][4 ra + i] b[r][4 rb + 64 u + e] over the 64
// rows r of z ([64][LZ]) and b ([64][LD]).
template <int D>
__device__ __forceinline__ void outer_acc(const float* z, const float* b,
                                          int ra, int rb,
                                          float (&acc)[4][D / 16]) {
  constexpr int LD = BwdF32Plan<D>::LD, LZ = BwdF32Plan<D>::LZ;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    const float4 zv = *reinterpret_cast<const float4*>(z + r * LZ + 4 * ra);
    const float zs[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
    for (int u = 0; u < D / 64; ++u) {
      const float4 bv =
          *reinterpret_cast<const float4*>(b + r * LD + 4 * rb + 64 * u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * u] = fmaf(zs[i], bv.x, acc[i][4 * u]);
        acc[i][4 * u + 1] = fmaf(zs[i], bv.y, acc[i][4 * u + 1]);
        acc[i][4 * u + 2] = fmaf(zs[i], bv.z, acc[i][4 * u + 2]);
        acc[i][4 * u + 3] = fmaf(zs[i], bv.w, acc[i][4 * u + 3]);
      }
    }
  }
}

// One block a (batch*head, 64 query rows). Thread (tr, tc) = (tid / 16,
// tid % 16) forms logits of rows tr + 16 i and keys tc + 16 j, and
// accumulates dq of rows tr + 16 i, columns 4 tc + 64 u (+ 0..3).
template <int D>
__global__ void __launch_bounds__(kF32Threads, D == 64 ? 2 : 1)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int tq, int tk, float scale, float nat_scale) {
  using P = BwdF32Plan<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sdO = sQ + P::kTile;
  float* sK = sdO + P::kTile;
  float* sV = sK + P::kTile;
  float* sZ = sV + P::kTile;  // dz [key][4 tr + i]: row tr + 16 i

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int q0 = blockIdx.x * 64;
  const size_t q_base = (size_t)blockIdx.y * tq * D;
  const size_t kv_base = (size_t)blockIdx.y * tk * D;
  stage_f32<D>(q + q_base, q0, tq, scale, sQ);
  stage_f32<D>(dout + q_base, q0, tq, 1.f, sdO);

  float lse_r[4], delta_r[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr + 16 * i;
    row_ok[i] = r < tq;
    lse_r[i] = row_ok[i] ? lse[(size_t)blockIdx.y * tq + r] : 0.f;
    delta_r[i] = row_ok[i] ? delta[(size_t)blockIdx.y * tq + r] : 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const int n_kt = (tk + 63) / 64;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * 64;
    __syncthreads();  // the previous K, V and dz read
    stage_f32<D>(k + kv_base, k0, tk, 1.f, sK);
    stage_f32<D>(v + kv_base, k0, tk, 1.f, sV);
    __syncthreads();

    float s[4][4], dp[4][4];
    dots_4x4<D>(sQ, sK, sdO, sV, tr, tc, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key_ok = k0 + tc + 16 * j < tk;
      float z[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p =
            row_ok[i] && key_ok ? exp2f(s[i][j] - lse_r[i]) : 0.f;
        z[i] = p * (dp[i][j] - delta_r[i]);
      }
      *reinterpret_cast<float4*>(sZ + (tc + 16 * j) * P::LZ + 4 * tr) =
          make_float4(z[0], z[1], z[2], z[3]);
    }
    __syncthreads();
    outer_acc<D>(sZ, sK, tr, tc, acc);  // dq += dz K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    float* row = dq + q_base + (size_t)(q0 + tr + 16 * i) * D + 4 * tc;
#pragma unroll
    for (int u = 0; u < D / 64; ++u)
      *reinterpret_cast<float4*>(row + 64 * u) = make_float4(
          acc[i][4 * u] * nat_scale, acc[i][4 * u + 1] * nat_scale,
          acc[i][4 * u + 2] * nat_scale, acc[i][4 * u + 3] * nat_scale);
  }
}

// One block a (batch*head, 64 keys), in the transposed frame: thread (tr,
// tc) forms p^T and dz^T of keys tr + 16 i and query rows tc + 16 j, and
// accumulates dk and dv of keys tr + 16 i, columns 4 tc + 64 u (+ 0..3).
template <int D>
__global__ void __launch_bounds__(kF32Threads, D == 64 ? 2 : 1)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int tq, int tk, float scale) {
  using P = BwdF32Plan<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + P::kTile;
  float* sQ = sV + P::kTile;
  float* sdO = sQ + P::kTile;
  float* sP = sdO + P::kTile;   // p^T [query][4 tr + i]: key tr + 16 i
  float* sZ = sP + P::kZTile;   // dz^T, likewise
  float* sLse = sZ + P::kZTile;
  float* sDelta = sLse + 64;

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int k0 = blockIdx.x * 64;
  const size_t q_base = (size_t)blockIdx.y * tq * D;
  const size_t kv_base = (size_t)blockIdx.y * tk * D;
  stage_f32<D>(k + kv_base, k0, tk, 1.f, sK);
  stage_f32<D>(v + kv_base, k0, tk, 1.f, sV);
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_ok[i] = k0 + tr + 16 * i < tk;

  float adk[4][D / 16], adv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int n_qt = (tq + 63) / 64;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * 64;
    __syncthreads();  // the previous q tile, p^T and dz^T read
    stage_f32<D>(q + q_base, q0, tq, scale, sQ);
    stage_f32<D>(dout + q_base, q0, tq, 1.f, sdO);
    if (threadIdx.x < 64) {
      const int r = q0 + threadIdx.x;
      sLse[threadIdx.x] = r < tq ? lse[(size_t)blockIdx.y * tq + r] : 0.f;
      sDelta[threadIdx.x] = r < tq ? delta[(size_t)blockIdx.y * tq + r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // S^T = K qf^T, dP^T = V dO^T
    dots_4x4<D>(sK, sQ, sV, sdO, tr, tc, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;  // query row in the tile
      const bool q_ok = q0 + c < tq;
      float p[4], z[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = key_ok[i] && q_ok ? exp2f(s[i][j] - sLse[c]) : 0.f;
        z[i] = p[i] * (dp[i][j] - sDelta[c]);
      }
      *reinterpret_cast<float4*>(sP + c * P::LZ + 4 * tr) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(sZ + c * P::LZ + 4 * tr) =
          make_float4(z[0], z[1], z[2], z[3]);
    }
    __syncthreads();
    outer_acc<D>(sP, sdO, tr, tc, adv);  // dv += p^T dO
    outer_acc<D>(sZ, sQ, tr, tc, adk);   // dk += dz^T qf
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!key_ok[i]) continue;
    const size_t off = kv_base + (size_t)(k0 + tr + 16 * i) * D + 4 * tc;
#pragma unroll
    for (int u = 0; u < D / 64; ++u) {
      *reinterpret_cast<float4*>(dk + off + 64 * u) = make_float4(
          adk[i][4 * u] * kInvLog2e, adk[i][4 * u + 1] * kInvLog2e,
          adk[i][4 * u + 2] * kInvLog2e, adk[i][4 * u + 3] * kInvLog2e);
      *reinterpret_cast<float4*>(dv + off + 64 * u) =
          make_float4(adv[i][4 * u], adv[i][4 * u + 1], adv[i][4 * u + 2],
                      adv[i][4 * u + 3]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int tq, int tk, float scale,
                      float nat_scale, cudaStream_t s) {
  constexpr int smem = dq_smem_bytes<D>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(flash_bwd_dq<D>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kBQ - 1) / kBQ, bh);
  flash_bwd_dq<D><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), tq, tk,
      scale, nat_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int tq, int tk, float scale,
                       cudaStream_t s) {
  constexpr int smem = dkv_smem_bytes<D>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(flash_bwd_dkv<D>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + kBK - 1) / kBK, bh);
  flash_bwd_dkv<D><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tq, tk, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          void* dq, int bh, int tq, int tk, float scale,
                          float nat_scale, cudaStream_t s) {
  constexpr int smem = BwdF32Plan<D>::kDqSmem;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(flash_bwd_dq_f32<D>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + 63) / 64, bh);
  flash_bwd_dq_f32<D><<<grid, kF32Threads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), tq, tk, scale, nat_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int tq, int tk, float scale, cudaStream_t s) {
  constexpr int smem = BwdF32Plan<D>::kDkvSmem;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(flash_bwd_dkv_f32<D>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + 63) / 64, bh);
  flash_bwd_dkv_f32<D><<<grid, kF32Threads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), tq, tk, scale);
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq: contiguous [B*H, tq, D] bf16; k, v, dk, dv: [B*H, tk, D]
// bf16; lse, delta: [B*H, tq] f32; scale = d^-0.5*log2(e), nat_scale =
// d^-0.5. Each returns a cudaError_t; 0 means the kernel was launched.
extern "C" int sdxl_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
    int d, float scale, float nat_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, scale,
                         nat_scale, s);
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, scale,
                          nat_scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int sdxl_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
    int tk, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                          scale, s);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                           scale, s);
  return cudaErrorInvalidValue;
}

// The f32 pair: the same arguments with f32 q, k, v, dout and outputs.
extern "C" int sdxl_flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
    int d, float scale, float nat_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dq_f32<64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, scale,
                             nat_scale, s);
  if (d == 128)
    return launch_dq_f32<128>(q, k, v, dout, lse, delta, dq, bh, tq, tk,
                              scale, nat_scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int sdxl_flash_attention_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
    int tk, int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv_f32<64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                              scale, s);
  if (d == 128)
    return launch_dkv_f32<128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                               scale, s);
  return cudaErrorInvalidValue;
}
