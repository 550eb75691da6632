// Flash-attention backward in f32 on the FMA pipes (sm_90a), d = 128,
// bound to Python with ctypes.
//
// Replaces the Pallas TPU kernels of sdxl_tpu/ops/flash_attention.py
// `flash_attention_bwd_bhtd` (:342, the FlashAttention-2 backward) on
// their f32 d = 128 route, which no SDXL path takes (SDXL's heads are 64
// wide; the f32 trainer's d = 64 route runs on TF32 tensor cores in three
// passes in flash_hopper_bwd.cu, whose wgmma design does not fit d = 128's
// resident operands in a block's shared memory with two consumer
// warpgroups):
//   K3a `_flash_bwd_dq_kernel` (:272)  -> flash_bwd_dq_f32
//   K3b `_flash_bwd_dkv_kernel` (:302) -> flash_bwd_dkv_f32
// With qf = q * d^-0.5 * log2(e) (the forward's pre-scaled q, formed by
// the wrapper in torch as the reference forms it outside Pallas), lse the
// forward's base-2 row log-sum-exp and delta_i = dO_i . O_i (also the
// wrapper's):
//   p_ij  = exp2(qf_i . k_j - lse_i)        (the forward's own logits)
//   dp_ij = dO_i . v_j
//   dz_ij = p_ij (dp_ij - delta_i)
//   dq_i  = sum_j dz_ij k_j * d^-0.5
//   dk_j  = sum_i dz_ij qf_i / log2(e)
//   dv_j  = sum_i p_ij dO_i
// every rounding point f32, as in the reference at f32.
//
// Ragged token counts are masked in-kernel, never padded in device memory:
// query rows >= tq are zero-filled (qf and dO) and get p = 0; key columns
// >= tk get p = 0; rows past the edge are never stored.
//
// Design. Two kernels and no atomics, so the result is deterministic: each
// output tile is written by exactly one block, which loops over the other
// axis itself (on the TPU that loop was the sequential last grid axis).
// flash_bwd_dq_f32: a block owns (batch*head, 64 query rows); per 64-key
// tile it forms S = qf K^T and dP = dO V^T, then dq += dz K.
// flash_bwd_dkv_f32: a block owns (batch*head, 64 keys) and works in the
// transposed frame (rows = keys): per 64-query tile it forms S^T = K qf^T
// and dP^T = V dO^T, then dv += p^T dO and dk += dz^T qf.
// Bound: 6 (dq) and 8 (dk/dv) x B*H*Tq*Tk*d operations at 67 TFLOP/s.
// 256 threads in a 16 x 16 grid: thread (tr, tc) forms the 4 x 4 logits of
// rows tr + 16 i and keys tc + 16 j (float4 dot products along d; a warp's
// two row groups read broadcasts, its 16 key rows, padded by 4 floats, hit
// distinct banks), writes p and dz to shared memory with the rows it owns
// in the next product side by side, then accumulates 4 rows x D / 16
// columns of dq (or of dk and dv) as outer products over the tile's 64
// keys (queries). Shared memory: dq 153 kB, dk/dv 170 kB, one block an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace {

using flash::allow_smem_once;

constexpr float kInvLog2e = 0.69314718055994531f;  // 1 / log2(e)

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
// (row stride LD); rows past n_rows zero.
template <int D>
__device__ __forceinline__ void stage_f32(const float* __restrict__ g,
                                          int row0, int n_rows, float* s) {
  constexpr int LD = BwdF32Plan<D>::LD;
  for (int i = threadIdx.x; i < 64 * D / 4; i += kF32Threads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      x = *reinterpret_cast<const float4*>(g + (size_t)(row0 + r) * D + c);
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
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dq_f32(const float* __restrict__ qf, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int tq, int tk, float nat_scale) {
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
  stage_f32<D>(qf + q_base, q0, tq, sQ);
  stage_f32<D>(dout + q_base, q0, tq, sdO);

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
    stage_f32<D>(k + kv_base, k0, tk, sK);
    stage_f32<D>(v + kv_base, k0, tk, sV);
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
__global__ void __launch_bounds__(kF32Threads, 1)
flash_bwd_dkv_f32(const float* __restrict__ qf, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int tq, int tk) {
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
  stage_f32<D>(k + kv_base, k0, tk, sK);
  stage_f32<D>(v + kv_base, k0, tk, sV);
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
    stage_f32<D>(qf + q_base, q0, tq, sQ);
    stage_f32<D>(dout + q_base, q0, tq, sdO);
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
cudaError_t launch_dq_f32(const void* qf, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          void* dq, int bh, int tq, int tk, float nat_scale,
                          cudaStream_t s) {
  constexpr int smem = BwdF32Plan<D>::kDqSmem;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(flash_bwd_dq_f32<D>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + 63) / 64, bh);
  flash_bwd_dq_f32<D><<<grid, kF32Threads, smem, s>>>(
      static_cast<const float*>(qf), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), tq, tk, nat_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* qf, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int tq, int tk, cudaStream_t s) {
  constexpr int smem = BwdF32Plan<D>::kDkvSmem;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(flash_bwd_dkv_f32<D>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + 63) / 64, bh);
  flash_bwd_dkv_f32<D><<<grid, kF32Threads, smem, s>>>(
      static_cast<const float*>(qf), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), tq, tk);
  return cudaGetLastError();
}

}  // namespace

// qf, dout, dq: contiguous [B*H, tq, 128] f32 device buffers (qf the
// pre-scaled q); k, v, dk, dv: [B*H, tk, 128] f32; lse, delta: [B*H, tq]
// f32; nat_scale = d^-0.5. Each returns a cudaError_t; 0 means the kernel
// was launched.
extern "C" int sdxl_flash_attention_bwd_dq_f32_d128(
    const void* qf, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
    int d, float nat_scale, void* stream) {
  if (d != 128) return cudaErrorInvalidValue;
  return launch_dq_f32<128>(qf, k, v, dout, lse, delta, dq, bh, tq, tk,
                            nat_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int sdxl_flash_attention_bwd_dkv_f32_d128(
    const void* qf, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
    int tk, int d, void* stream) {
  if (d != 128) return cudaErrorInvalidValue;
  return launch_dkv_f32<128>(qf, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                             static_cast<cudaStream_t>(stream));
}
