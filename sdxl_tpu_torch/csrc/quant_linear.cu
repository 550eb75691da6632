// K4: the weight-only quantized linear, y = x · dequant(W)ᵀ + b, for
// Hopper (sm_90a).
//
// K4 replaces no Pallas kernel. The reference stores the big block linears
// as int8 (per output channel) or packed int4 (groups of 64 input rows,
// byte i of a column holding rows i and i + d_in/2) and dequantizes at the
// use site (sdxl_tpu/ops/linear.py:30 `_weight`, sdxl_tpu/ops/quant.py:109
// `_dequant_int8` and :113 `_dequant_int4`), where XLA fuses the dequant
// into the consuming matmul, so that the only copy of a weight in device
// memory stays the quantized one. Eager PyTorch has no such fusion:
// F.linear on a weight dequantized first keeps int8 resident but rebuilds
// the bf16 weight on every call, about five bytes of traffic a weight
// (read 1, write 2, read 2) against one here. This kernel reads the
// quantized tile and dequantizes it on the way into the product.
//
// What bounds it on the H100: the bf16 routes are operation-bound above
// M ≈ 300 rows (989 TFLOP/s against the int8 weight's bytes at 3.35 TB/s)
// and byte-bound below, where FLUX.1's modulation matvecs (M = 1-2, up to
// 3072 -> 18432) and the UNets' lin_embed live; there only the weight's
// bytes count, and reading one byte a weight (half a byte for int4) instead
// of five is the whole gain. The f32 routes (T5-XXL's int8 linears, the f32
// transformers) are operation-bound at 67 TFLOP/s above M ≈ 20.
//
// The design, right and simple first:
// - bf16 routes: mma.sync m16n8k16 (bf16 in, f32 accumulate) on 128 x 128
//   output tiles, eight warps of 64 x 32, K in steps of 32. The x tile and
//   the int8 / uint8 weight tile go from device memory to shared memory by
//   cp.async (16-byte copies) through a three-stage ring; each warp reads
//   its B fragment's bytes from shared memory and dequantizes them in
//   registers exactly as the plain version does (q · s in f32, rounded to
//   bf16 to nearest even) before they feed the MMA, so kernel and plain
//   version differ only in the order of the sums. int4: one step of the K
//   loop takes the byte tile at i and the two x tiles at i and i + K/2
//   (low nibble row i, high nibble row i + K/2), so every packed byte is
//   read once. Bias in the epilogue; the ragged M and N edges are masked
//   (zero-filled copies, guarded stores).
// - f32 routes: a tiled FFMA kernel, 64 x 64 output tiles, 4 x 4 outputs a
//   thread, the weight dequantized to f32 (exactly q · s) as it is staged
//   in shared memory.
// Speed (wgmma and TMA, a split-K or GEMV form for M <= 16, f32 on TF32
// tensor cores) is later work.
//
// Shapes taken: any M >= 1; N a multiple of 8; K a multiple of 64; for int4
// a group that is a multiple of 32 and divides K/2. x, W, the scales, the
// bias and y contiguous and 16-byte aligned. The wrapper
// (sdxl_tpu_torch/ops/quant.py `quant_linear`) checks all of this.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bf16 routes
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kALd = kBK + 8;        // bf16 a shared row of an x tile (80 B)
constexpr int kBLd = kBK + 16;       // bytes a shared row of a weight tile
constexpr int kATileBytes = kBM * kALd * 2;
constexpr int kBTileBytes = kBN * kBLd;

template <bool INT4>
__host__ __device__ constexpr int bf16_stage_bytes() {
  return (INT4 ? 2 : 1) * kATileBytes + kBTileBytes;
}

template <bool INT4>
__host__ __device__ constexpr int bf16_smem_bytes() {
  return kStages * bf16_stage_bytes<INT4>();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows m0.. of x [M, K] bf16, columns k0 .. k0 + 31 -> a [kBM][kALd] tile
__device__ __forceinline__ void load_x_tile(__nv_bfloat16* tile,
                                            const __nv_bfloat16* x, int M,
                                            int K, int m0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 2, col = (c & 3) * 8;
    const bool ok = m0 + r < M;
    cp_async16(tile + r * kALd + col,
               x + static_cast<size_t>(ok ? m0 + r : 0) * K + k0 + col, ok);
  }
}

// rows n0.. of the [N, row_bytes] weight bytes, bytes b0 .. b0 + 31 ->
// a [kBN][kBLd] tile
__device__ __forceinline__ void load_w_tile(uint8_t* tile, const uint8_t* w,
                                            int N, int row_bytes, int n0,
                                            int b0, int tid) {
#pragma unroll
  for (int i = 0; i < kBN * kBK / 16 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 1, col = (c & 1) * 16;
    const bool ok = n0 + r < N;
    cp_async16(tile + r * kBLd + col,
               w + static_cast<size_t>(ok ? n0 + r : 0) * row_bytes + b0 + col,
               ok);
  }
}

// two f32 -> bf16x2 (round to nearest even; `lo` in the low half, the
// lower k of an MMA fragment pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a signed nibble (0..15 as stored) -> -8..7
__device__ __forceinline__ float nibble(uint32_t u) {
  return static_cast<float>(static_cast<int>(u ^ 8u) - 8);
}

__device__ __forceinline__ float int8_at(uint32_t v, int byte) {
  return static_cast<float>(static_cast<int8_t>((v >> (8 * byte)) & 0xffu));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragments of one 16-wide k step for the warp's four m16 tiles
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4],
                                             const __nv_bfloat16* tile,
                                             int row0, int kk, int g, int t) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const __nv_bfloat16* p = tile + (row0 + mi * 16 + g) * kALd + kk + 2 * t;
    a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
    a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kALd);
    a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kALd + 8);
  }
}

template <bool INT4>
__global__ void __launch_bounds__(kThreads)
    quant_linear_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             const uint8_t* __restrict__ w,
                             const float* __restrict__ qs,
                             const __nv_bfloat16* __restrict__ bias,
                             __nv_bfloat16* __restrict__ y, int M, int N,
                             int K, int group) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int row_bytes = INT4 ? K / 2 : K;
  const int half = K / 2;
  const int n_groups = INT4 ? K / group : 1;
  const int ktiles = row_bytes / kBK;

  auto x_lo = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem +
                                            s * bf16_stage_bytes<INT4>());
  };
  auto x_hi = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(
        smem + s * bf16_stage_bytes<INT4>() + kATileBytes);
  };
  auto w_tile = [&](int s) {
    return smem + s * bf16_stage_bytes<INT4>() +
           (INT4 ? 2 : 1) * kATileBytes;
  };
  auto load_stage = [&](int s, int kt) {
    const int i0 = kt * kBK;
    load_x_tile(x_lo(s), x, M, K, m0, i0, tid);
    if (INT4) load_x_tile(x_hi(s), x, M, K, m0, half + i0, tid);
    load_w_tile(w_tile(s), w, N, row_bytes, n0, i0, tid);
  };

  // the output channel of each of the warp's n8 tiles this thread's B
  // fragment holds
  int ncol[4];
  float scale[4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    ncol[ni] = warp_n * 32 + ni * 8 + g;
    const int n = n0 + ncol[ni];
    scale[ni] = (!INT4 && n < N) ? qs[n] : 0.f;
  }

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int next = kt + kStages - 1;
      if (next < ktiles) load_stage(next % kStages, next);
      cp_async_commit();
    }
    const int s = kt % kStages;
    float s_lo[4], s_hi[4];
    if (INT4) {
      const int i0 = kt * kBK;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + ncol[ni];
        s_lo[ni] = n < N ? qs[static_cast<size_t>(n) * n_groups + i0 / group]
                         : 0.f;
        s_hi[ni] = n < N ? qs[static_cast<size_t>(n) * n_groups +
                              (half + i0) / group]
                         : 0.f;
      }
    }
    const uint8_t* wt = w_tile(s);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4];
      load_a_frags(a, x_lo(s), warp_m * 64, kk, g, t);
      uint32_t a2[4][4];
      if (INT4) load_a_frags(a2, x_hi(s), warp_m * 64, kk, g, t);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* bp = wt + ncol[ni] * kBLd + kk + 2 * t;
        const uint32_t v0 = *reinterpret_cast<const uint16_t*>(bp);
        const uint32_t v1 = *reinterpret_cast<const uint16_t*>(bp + 8);
        if (!INT4) {
          const float sc = scale[ni];
          const uint32_t b0 = pack_bf16(int8_at(v0, 0) * sc,
                                        int8_at(v0, 1) * sc);
          const uint32_t b1 = pack_bf16(int8_at(v1, 0) * sc,
                                        int8_at(v1, 1) * sc);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
        } else {
          // low nibbles: rows i (x_lo); high nibbles: rows i + K/2 (x_hi)
          const float sl = s_lo[ni], sh = s_hi[ni];
          const uint32_t l0 = pack_bf16(nibble(v0 & 0xfu) * sl,
                                        nibble((v0 >> 8) & 0xfu) * sl);
          const uint32_t l1 = pack_bf16(nibble(v1 & 0xfu) * sl,
                                        nibble((v1 >> 8) & 0xfu) * sl);
          const uint32_t h0 = pack_bf16(nibble((v0 >> 4) & 0xfu) * sh,
                                        nibble((v0 >> 12) & 0xfu) * sh);
          const uint32_t h1 = pack_bf16(nibble((v1 >> 4) & 0xfu) * sh,
                                        nibble((v1 >> 12) & 0xfu) * sh);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16(acc[mi][ni], a[mi], l0, l1);
            mma_bf16(acc[mi][ni], a2[mi], h0, h1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = n0 + warp_n * 32 + ni * 8 + 2 * t;
    if (c >= N) continue;  // N is a multiple of 8: c + 1 < N too
    const float b0 = bias ? __bfloat162float(bias[c]) : 0.f;
    const float b1 = bias ? __bfloat162float(bias[c + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r = m0 + warp_m * 64 + mi * 16 + g;
      if (r < M)
        *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(r) * N + c) =
            pack_bf16(acc[mi][ni][0] + b0, acc[mi][ni][1] + b1);
      if (r + 8 < M)
        *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(r + 8) * N + c) =
            pack_bf16(acc[mi][ni][2] + b0, acc[mi][ni][3] + b1);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 routes
// ---------------------------------------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16, kFThreads = 256;

template <bool INT4>
__global__ void __launch_bounds__(kFThreads)
    quant_linear_f32_kernel(const float* __restrict__ x,
                            const uint8_t* __restrict__ w,
                            const float* __restrict__ qs,
                            const float* __restrict__ bias,
                            float* __restrict__ y, int M, int N, int K,
                            int group) {
  __shared__ float xs[kFK][kFM + 4];  // the x tile, transposed: [k][m]
  __shared__ float ws[kFK][kFN + 4];  // the dequantized weight: [k][n]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 4 x 4 outputs at (ty, tx)
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int r = tid >> 2, kq = (tid & 3) * 4;  // this thread's loads
  const int row_bytes = INT4 ? K / 2 : K;
  const int half = K / 2;
  const int n_groups = INT4 ? K / group : 1;
  const bool m_ok = m0 + r < M, n_ok = n0 + r < N;
  const float s8 = (!INT4 && n_ok) ? qs[n0 + r] : 0.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m_ok)
      xv = *reinterpret_cast<const float4*>(
          x + static_cast<size_t>(m0 + r) * K + k0 + kq);
    float wv[4] = {0.f, 0.f, 0.f, 0.f};
    if (n_ok) {
      // a 16-wide k step never straddles K/2 (K is a multiple of 64)
      const bool hi = INT4 && k0 >= half;
      const int kb = hi ? k0 - half : k0;
      const uint32_t q4 = *reinterpret_cast<const uint32_t*>(
          w + static_cast<size_t>(n0 + r) * row_bytes + kb + kq);
      if (!INT4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = int8_at(q4, j) * s8;
      } else {
        const float s = qs[static_cast<size_t>(n0 + r) * n_groups +
                           (k0 + kq) / group];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t byte = (q4 >> (8 * j)) & 0xffu;
          wv[j] = nibble(hi ? byte >> 4 : byte & 0xfu) * s;
        }
      }
    }
    __syncthreads();  // the previous step's reads are done
    xs[kq + 0][r] = xv.x;
    xs[kq + 1][r] = xv.y;
    xs[kq + 2][r] = xv.z;
    xs[kq + 3][r] = xv.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) ws[kq + j][r] = wv[j];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        y[static_cast<size_t>(m) * N + n] =
            acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

template <bool INT4>
int launch_bf16(const void* x, const void* qw, const void* qs,
                const void* bias, void* y, int M, int N, int K, int group,
                void* stream) {
  auto kernel = quant_linear_bf16_kernel<INT4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bf16_smem_bytes<INT4>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, bf16_smem_bytes<INT4>(),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qw),
      static_cast<const float*>(qs), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, N, K, group);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT4>
int launch_f32(const void* x, const void* qw, const void* qs,
               const void* bias, void* y, int M, int N, int K, int group,
               void* stream) {
  const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
  quant_linear_f32_kernel<INT4>
      <<<grid, kFThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const uint8_t*>(qw),
          static_cast<const float*>(qs), static_cast<const float*>(bias),
          static_cast<float*>(y), M, N, K, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [M, N] = x [M, K] · dequant(qw)ᵀ + bias (bias may be null). int8: qw
// [N, K] int8, qs [N] f32; int4: qw [N, K/2] uint8, qs [N, K/group] f32.
// Returns the launch's CUDA error (0 on success).
extern "C" {

int sdxl_quant_linear_bf16_int8(const void* x, const void* qw, const void* qs,
                                const void* bias, void* y, int M, int N,
                                int K, int group, void* stream) {
  return launch_bf16<false>(x, qw, qs, bias, y, M, N, K, group, stream);
}

int sdxl_quant_linear_bf16_int4(const void* x, const void* qw, const void* qs,
                                const void* bias, void* y, int M, int N,
                                int K, int group, void* stream) {
  return launch_bf16<true>(x, qw, qs, bias, y, M, N, K, group, stream);
}

int sdxl_quant_linear_f32_int8(const void* x, const void* qw, const void* qs,
                               const void* bias, void* y, int M, int N, int K,
                               int group, void* stream) {
  return launch_f32<false>(x, qw, qs, bias, y, M, N, K, group, stream);
}

int sdxl_quant_linear_f32_int4(const void* x, const void* qw, const void* qs,
                               const void* bias, void* y, int M, int N, int K,
                               int group, void* stream) {
  return launch_f32<true>(x, qw, qs, bias, y, M, N, K, group, stream);
}

// Dynamic shared memory of a kernel (0 bf16 int8, 1 bf16 int4, 2 f32 int8,
// 3 f32 int4; the f32 kernels' is static), for the build check.
int quant_linear_smem_bytes(int kernel, int, int, int) {
  switch (kernel) {
    case 0: return bf16_smem_bytes<false>();
    case 1: return bf16_smem_bytes<true>();
    default: return 0;
  }
}

}  // extern "C"
