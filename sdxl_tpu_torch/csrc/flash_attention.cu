// K1's and K2's f32 d=128 route for Hopper (sm_90a), on the FMA pipes,
// bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel of sdxl_tpu/ops/flash_attention.py
// `flash_attention_bhtd` (:140; pallas_call :207) on its f32 route at d =
// 128: K1 (return_lse=False -> `_flash_kernel` :92 -> `_flash_kernel_core`
// :40) and K2 (return_lse=True -> `_flash_kernel_lse` :102, which also
// stores the row's base-2 log-sum-exp m + log2(l); here one f32 per row,
// [B*H, tq]). No SDXL path launches it: the reference's `_flash_sdpa_fwd`
// routes every head dim up to 128 to K2, so the port keeps the route. K1's
// bf16 routes, its f32 d 64 and 512 routes (TF32 tensor cores in three
// passes) and K2's bf16 and f32 d=64 routes live in flash_hopper.cu.
// Unmasked softmax(q k^T / sqrt(d)) v over [B,H,T,128] in f32, with the
// reference's semantics kept exactly:
//   - q is multiplied by d^-0.5 * log2(e) in f32 before any product
//     (flash_attention.py:185);
//   - the online softmax runs in base 2 with f32 running max m, normaliser l
//     and accumulator (flash_attention.py:57-89);
//   - the output is acc / l.
// Ragged token counts are masked here rather than padded in device memory:
// query rows >= tq are zero-filled in shared memory and never stored, key
// columns >= tk get a -inf logit, and their V rows are zero-filled.
//
// Design. On the TPU the grid ran in order and carried m/l/acc from one k
// block to the next in VMEM scratch. Here blocks run in parallel in no
// order, so each thread block owns one (batch*head, q-tile) and walks all
// k-tiles in a loop of its own; nothing crosses blocks.
//
// flash_fwd_fma<LSE>: full f32 on the f32 FMA pipes (67 TFLOP/s peak),
//   bound by them and by shared-memory bandwidth. The three-pass TF32
//   split (flash_hopper.cu, d 64 and 512) is queued for this route in
//   ROADMAP. A block holds 32 query rows and a 32-key tile of K and V; each
//   thread computes 4x1 logits and a 4x4 register tile of the output; Q/K
//   rows are padded by 4 floats so the float4 reads of eight consecutive
//   rows hit distinct banks. With LSE the rows' m + log2(l) are stored from
//   shared memory after the last tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace {

using flash::allow_smem_once;

constexpr int D = 128;
constexpr int kFBQ = 32;
constexpr int kFBK = 32;
constexpr int kFThreads = 256;
constexpr int kFLS = kFBK + 1;    // padded logit row stride
constexpr int LD = D + 4;         // padded Q/K row stride (floats)
// in P V each thread owns kRows query rows and one float4 column chunk;
// the kColThreads threads of a row group cover the D columns
constexpr int kColThreads = D / 4;                      // 32
constexpr int kRows = kFBQ * kColThreads / kFThreads;   // 4
constexpr int kSmemBytes =
    (kFBQ * LD + kFBK * LD + kFBK * D + kFBQ * kFLS + kFBK * kFBQ + 3 * kFBQ) * 4;

// Four consecutive elements as f32, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// With LSE also lse ([B*H, tq] f32).
template <bool LSE>
__global__ void __launch_bounds__(kFThreads, 1)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int tq, int tk, float scale) {
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
  // P V: rows or0 .. or0+kRows-1, columns oc..oc+3
  const int oc = (tid % kColThreads) * 4;
  const int or0 = (tid / kColThreads) * kRows;
  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

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
    for (int i = 0; i < kRows; ++i) {
      const float a = sAlpha[or0 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= a;
    }
#pragma unroll 2
    for (int kk = 0; kk < kFBK; ++kk) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = sPt[kk * kFBQ + or0 + i];
      const float4 x = *reinterpret_cast<const float4*>(sV + kk * D + oc);
      const float vv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + or0 + i;
    if (r >= tq) continue;
    const float l = sL[or0 + i];
    store4(o + q_base + (size_t)r * D + oc,
           make_float4(acc[i][0] / l, acc[i][1] / l, acc[i][2] / l,
                       acc[i][3] / l));
  }
  if (LSE && tid < kFBQ && q0 + tid < tq)
    lse[(size_t)blockIdx.y * tq + q0 + tid] = sM[tid] + log2f(sL[tid]);
}

template <bool LSE>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int tq, int tk, int d, float scale,
                       cudaStream_t s) {
  if (d != D) return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(flash_fwd_fma<LSE>, kSmemBytes, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kFBQ - 1) / kFBQ, bh);
  flash_fwd_fma<LSE><<<grid, kFThreads, kSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, tq, tk,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous [B*H, T, 128] f32 device buffers; lse: [B*H, tq]
// f32; scale = d^-0.5*log2(e). Each returns a cudaError_t; 0 means the
// kernel was launched.
extern "C" int sdxl_flash_attention_f32_d128(const void* q, const void* k,
                                             const void* v, void* o, int bh,
                                             int tq, int tk, int d,
                                             float scale, void* stream) {
  return launch_fma<false>(q, k, v, o, nullptr, bh, tq, tk, d, scale,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int sdxl_flash_attention_lse_f32_d128(const void* q, const void* k,
                                                 const void* v, void* o,
                                                 void* lse, int bh, int tq,
                                                 int tk, int d, float scale,
                                                 void* stream) {
  return launch_fma<true>(q, k, v, o, static_cast<float*>(lse), bh, tq, tk, d,
                          scale, static_cast<cudaStream_t>(stream));
}
