// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernels of sdxl_tpu/ops/flash_attention.py
// `flash_attention_bwd_bhtd` (the FlashAttention-2 backward):
//   K3a `_flash_bwd_dq_kernel`  -> flash_bwd_dq
//   K3b `_flash_bwd_dkv_kernel` -> flash_bwd_dkv
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
