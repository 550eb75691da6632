// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernels of sdxl_tpu/ops/flash_attention.py
// `flash_attention_bhtd`: K1 (return_lse=False -> `_flash_kernel` ->
// `_flash_kernel_core`) on its f32 routes, and K2 (return_lse=True ->
// `_flash_kernel_lse`, which also stores the row's base-2 log-sum-exp m +
// log2(l) for the backward; here one f32 per row, without the TPU's lane
// replication). K1's bf16 routes run on wgmma and TMA in flash_hopper.cu.
// Unmasked softmax(q k^T / sqrt(d)) v over [B,H,T,D], with the reference's
// semantics kept exactly:
//   - q is multiplied by d^-0.5 * log2(e) in f32 and rounded to q's dtype
//     before any product (flash_attention.py:185);
//   - the online softmax runs in base 2 with f32 running max m, normaliser l
//     and accumulator; p is rounded to v's dtype before P.V while l sums the
//     f32 p (flash_attention.py:57-89);
//   - the output is acc / l rounded to v's dtype.
// Ragged token counts are masked here rather than padded in device memory:
// query rows >= tq are zero-filled in shared memory and never stored, key
// columns >= tk get a -inf logit, and their V rows are zero-filled.
//
// Design. On the TPU the grid ran in order and carried m/l/acc from one k
// block to the next in VMEM scratch. Here blocks run in parallel in no
// order, so each thread block owns one (batch*head, q-tile) and walks all
// k-tiles in a loop of its own; nothing crosses blocks.
//
// Two kernels:
//
// flash_fwd_bf16 (K2, the training forward, d = 64 or 128, bf16 in/out,
// also storing lse).
//   Bound by tensor-core issue and shared-memory traffic: at T=4096, d=64,
//   B*H=20 one call is 4*B*H*T^2*d = 86 GFLOP against 42 MB of q/k/v/o, so
//   it is far above the card's ~295 FLOP/byte ridge. Four warps each own 16
//   query rows and run mma.sync m16n8k16 (bf16 in, f32 accumulate): S = Q K^T
//   stays in registers, the softmax runs on the accumulator fragments with
//   quad shuffles, and the f32 fragment of S is re-packed in place as the
//   bf16 A operand of P V. K is staged row-major and V transposed in padded
//   shared memory so every B fragment is one 32-bit load. No wgmma, TMA or
//   software pipelining yet.
//
// flash_fwd_fma<D> (the FMA route): f32 in/out at d = 512 (the VAE
// mid-block attention), d = 64 (the f32 UNet's self-attention) and
// d = 128.
//   f32 must stay in full f32 (no TF32, no bf16 tensor cores: the bound is
//   1e-3 against plain f32 attention), so the route runs on the f32 FMA
//   pipes (67 TFLOP/s peak) and is bound by them and by shared-memory
//   bandwidth. A 32x512 f32 tile is 64 KB, so a block holds 32 query rows
//   and a 32-key tile of K and V (about 200 KB of dynamic shared memory at
//   d = 512, one block per SM; 34 KB at d = 64). Each thread computes 4x1
//   logits and an 8x8 (d 512), 4x4 (d 128) or 2x4 (d 64) register tile of
//   the output; Q/K rows are padded by 4 floats so the float4 reads of
//   eight consecutive rows hit distinct banks.

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
using flash::mma_16816;
using flash::pack_bf16;

// ---------------------------------------------------------------------------
// K2: bf16, d in {64, 128}
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // query rows per block (4 warps x 16)
constexpr int kBK = 64;       // keys per tile

template <int D>
constexpr int bf16_smem_bytes() {
  return (kBQ * (D + 8) + kBK * (D + 8) + D * (kBK + 8)) * 2;
}

// Also stores each row's base-2 log-sum-exp m + log2(l) to lse ([B*H, tq]
// f32), the residual the backward recomputes p from.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int tq,
               int tk, float scale) {
  constexpr int LD = D + 8;     // Q and K tiles: [row][LD]
  constexpr int LDV = kBK + 8;  // transposed V tile: [d][LDV]
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kBQ * LD;
  __nv_bfloat16* sVt = sK + kBK * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row group / column pair
  const int q0 = blockIdx.x * kBQ;
  const size_t q_base = (size_t)blockIdx.y * tq * D;
  const size_t kv_base = (size_t)blockIdx.y * tk * D;

  // Q tile, pre-scaled in f32 and rounded to bf16 as the reference does.
  for (int i = tid; i < kBQ * D / 2; i += kThreads) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    float x0 = 0.f, x1 = 0.f;
    if (q0 + r < tq) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
          q + q_base + (size_t)(q0 + r) * D + c);
      x0 = __bfloat162float(x.x) * scale;
      x1 = __bfloat162float(x.y) * scale;
    }
    *reinterpret_cast<__nv_bfloat162*>(sQ + r * LD + c) =
        __floats2bfloat162_rn(x0, x1);
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

  const int n_kt = (tk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < kBK * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (k0 + r < tk) {
        const size_t off = kv_base + (size_t)(k0 + r) * D + c;
        kx = *reinterpret_cast<const uint4*>(k + off);
        vx = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kx;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * LDV + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (base-2 logits).
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sK + (nt * 8 + g) * LD + tg * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_16816(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + nt * 8 + tg * 2 + (e & 1) >= tk) s[nt][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
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
    for (int nt = 0; nt < kBK / 8; ++nt) {
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

    // acc += P V: the C fragments of two adjacent 8-key column tiles are
    // exactly the A fragment of one 16-key k-step.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
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

  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tg * 2;
    if (r0 < tq)
      *reinterpret_cast<__nv_bfloat162*>(o + q_base + (size_t)r0 * D + c) =
          __floats2bfloat162_rn(acc[dt][0] / l_run[0], acc[dt][1] / l_run[0]);
    if (r0 + 8 < tq)
      *reinterpret_cast<__nv_bfloat162*>(o + q_base + (size_t)(r0 + 8) * D + c) =
          __floats2bfloat162_rn(acc[dt][2] / l_run[1], acc[dt][3] / l_run[1]);
  }
  // m and l are already reduced across the quad: one lane of four stores.
  if (tg == 0) {
    float* lrow = lse + (size_t)blockIdx.y * tq;
    if (r0 < tq) lrow[r0] = m_run[0] + log2f(l_run[0]);
    if (r0 + 8 < tq) lrow[r0 + 8] = m_run[1] + log2f(l_run[1]);
  }
}

// ---------------------------------------------------------------------------
// FMA route: f32 at d in {64, 128, 512}
// ---------------------------------------------------------------------------

constexpr int kFBQ = 32;
constexpr int kFBK = 32;
constexpr int kFThreads = 256;
constexpr int kFLS = kFBK + 1;    // padded logit row stride

// Tile plan of the FMA kernel at head dim D: in P V each thread owns kRows
// query rows and kChunks float4 column chunks (the chunks D / kChunks
// apart); the kColThreads threads of a row group cover the D columns.
template <int D>
struct FmaPlan {
  static constexpr int LD = D + 4;  // padded Q/K row stride (floats)
  static constexpr int kChunks = D >= 512 ? 2 : 1;
  static constexpr int kColThreads = D / (4 * kChunks);  // 64, 32, 16
  static constexpr int kRows = kFBQ * kColThreads / kFThreads;  // 8, 4, 2
  static constexpr int kSmemBytes =
      (kFBQ * LD + kFBK * LD + kFBK * D + kFBQ * kFLS + kFBK * kFBQ + 3 * kFBQ) * 4;
};

// Four consecutive elements as f32, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
template <int D>
__global__ void __launch_bounds__(kFThreads, 1)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int tq,
              int tk, float scale) {
  using P = FmaPlan<D>;
  constexpr int LD = P::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [kFBQ][LD]
  float* sK = sQ + kFBQ * LD;                  // [kFBK][LD]
  float* sV = sK + kFBK * LD;                  // [kFBK][D]
  float* sS = sV + kFBK * D;                   // [kFBQ][kFLS] logits
  float* sPt = sS + kFBQ * kFLS;               // [kFBK][kFBQ] probabilities
  float* sM = sPt + kFBK * kFBQ;               // running max
  float* sL = sM + kFBQ;                       // running normaliser
  float* sAlpha = sL + kFBQ;                   // this tile's rescale

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kFBQ;
  const size_t q_base = (size_t)blockIdx.y * tq * D;
  const size_t kv_base = (size_t)blockIdx.y * tk * D;

  // Q tile, pre-scaled in f32 as the reference does.
  for (int i = tid; i < kFBQ * D / 4; i += kFThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < tq) {
      x = load4(q + q_base + (size_t)(q0 + r) * D + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(sQ + r * LD + c) = x;
  }
  if (tid < kFBQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }

  // logits: thread owns key column `sc` of rows sr0 .. sr0+3
  const int sc = tid % kFBK, sr0 = (tid / kFBK) * 4;
  // softmax: 8 threads per row, keys j, j+8, j+16, j+24
  const int pr = tid / 8, pj = tid % 8;
  // P V: rows or0 .. or0+kRows-1, columns oc..oc+3 of each chunk
  const int oc = (tid % P::kColThreads) * 4;
  const int or0 = (tid / P::kColThreads) * P::kRows;
  float acc[P::kRows][4 * P::kChunks];
#pragma unroll
  for (int i = 0; i < P::kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4 * P::kChunks; ++j) acc[i][j] = 0.f;

  const int n_kt = (tk + kFBK - 1) / kFBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kFBK;
    __syncthreads();
    for (int i = tid; i < kFBK * D / 4; i += kFThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < tk) {
        const size_t off = kv_base + (size_t)(k0 + r) * D + c;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      *reinterpret_cast<float4*>(sK + r * LD + c) = kx;
      *reinterpret_cast<float4*>(sV + r * D + c) = vx;
    }
    __syncthreads();

    {
      float sacc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* kr = sK + sc * LD;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 kx = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qx =
              *reinterpret_cast<const float4*>(sQ + (sr0 + i) * LD + d);
          sacc[i] = fmaf(qx.x, kx.x, sacc[i]);
          sacc[i] = fmaf(qx.y, kx.y, sacc[i]);
          sacc[i] = fmaf(qx.z, kx.z, sacc[i]);
          sacc[i] = fmaf(qx.w, kx.w, sacc[i]);
        }
      }
      const bool valid = k0 + sc < tk;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sS[(sr0 + i) * kFLS + sc] = valid ? sacc[i] : -INFINITY;
    }
    __syncthreads();

    {
      float sv[4];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sv[u] = sS[pr * kFLS + pj + 8 * u];
        mx = fmaxf(mx, sv[u]);
      }
      const float m_old = sM[pr];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = exp2f(sv[u] - m_new);
        sPt[(pj + 8 * u) * kFBQ + pr] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if (pj == 0) {
        const float alpha = exp2f(m_old - m_new);
        sM[pr] = m_new;
        sL[pr] = alpha * sL[pr] + sum;
        sAlpha[pr] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < P::kRows; ++i) {
      const float a = sAlpha[or0 + i];
#pragma unroll
      for (int j = 0; j < 4 * P::kChunks; ++j) acc[i][j] *= a;
    }
#pragma unroll 2
    for (int kk = 0; kk < kFBK; ++kk) {
      float p[P::kRows], vv[4 * P::kChunks];
#pragma unroll
      for (int i = 0; i < P::kRows; ++i) p[i] = sPt[kk * kFBQ + or0 + i];
#pragma unroll
      for (int c = 0; c < P::kChunks; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(
            sV + kk * D + c * (D / P::kChunks) + oc);
        vv[4 * c] = x.x;
        vv[4 * c + 1] = x.y;
        vv[4 * c + 2] = x.z;
        vv[4 * c + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < P::kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4 * P::kChunks; ++j)
          acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < P::kRows; ++i) {
    const int r = q0 + or0 + i;
    if (r >= tq) continue;
    const float l = sL[or0 + i];
    float* orow = o + q_base + (size_t)r * D;
#pragma unroll
    for (int c = 0; c < P::kChunks; ++c)
      store4(orow + c * (D / P::kChunks) + oc,
             make_float4(acc[i][4 * c] / l, acc[i][4 * c + 1] / l,
                         acc[i][4 * c + 2] / l, acc[i][4 * c + 3] / l));
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int bh, int tq, int tk, int d, float scale,
                       cudaStream_t s) {
  if (d != D) return cudaErrorInvalidValue;
  constexpr int smem = FmaPlan<D>::kSmemBytes;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(flash_fwd_fma<D>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kFBQ - 1) / kFBQ, bh);
  flash_fwd_fma<D><<<grid, kFThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), tq, tk, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int bh, int tq, int tk, float scale,
                        cudaStream_t s) {
  constexpr int smem = bf16_smem_bytes<D>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(flash_fwd_bf16<D>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kBQ - 1) / kBQ, bh);
  flash_fwd_bf16<D><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      tq, tk, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous [B*H, T, D] device buffers; scale = d^-0.5*log2(e).
// Returns a cudaError_t; 0 means the kernel was launched.
// K2: the bf16 forward that also writes lse ([B*H, tq] f32 device buffer).
extern "C" int sdxl_flash_attention_lse_bf16(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int bh, int tq,
                                             int tk, int d, float scale,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (d == 64) return launch_bf16<64>(q, k, v, o, l, bh, tq, tk, scale, s);
  if (d == 128) return launch_bf16<128>(q, k, v, o, l, bh, tq, tk, scale, s);
  return cudaErrorInvalidValue;
}

// The FMA route, one export for each head dim it takes.
#define SDXL_FMA_EXPORT(name, D)                                             \
  extern "C" int name(const void* q, const void* k, const void* v, void* o,  \
                      int bh, int tq, int tk, int d, float scale,            \
                      void* stream) {                                        \
    return launch_fma<D>(q, k, v, o, bh, tq, tk, d, scale,                   \
                         static_cast<cudaStream_t>(stream));                 \
  }
SDXL_FMA_EXPORT(sdxl_flash_attention_f32, 512)
SDXL_FMA_EXPORT(sdxl_flash_attention_f32_d64, 64)
SDXL_FMA_EXPORT(sdxl_flash_attention_f32_d128, 128)
