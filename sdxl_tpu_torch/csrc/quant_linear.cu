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
// (read 1, write 2, read 2) against one here. These kernels read the
// quantized tile and dequantize it on the way into the product.
//
// What bounds it on the H100: the bf16 routes are operation-bound above
// M ≈ 300 rows (989 TFLOP/s against the int8 weight's bytes at 3.35 TB/s)
// and byte-bound below, where FLUX.1's modulation matvecs (M = 1-2, up to
// 3072 -> 18432) and the UNets' lin_embed live; there only the weight's
// bytes count, and reading one byte a weight (half a byte for int4) instead
// of five is the whole gain. The f32 routes (T5-XXL's int8 linears, the f32
// transformers) are operation-bound at 67 TFLOP/s above M ≈ 20.
//
// bf16, M above the small-M threshold (ops/quant.py GEMV_MAX_M): a GEMM on
// wgmma and TMA, `quant_gemm_bf16<INT4, NT>`.
// - The operands are swapped: the block computes yᵀ = W · xᵀ for 128
//   output channels by NT (128 or 256) rows of x, so that the weight is
//   wgmma's A operand, which may come from registers. Each consumer
//   warpgroup (two a block) converts its 64 channels' bytes of a 16-wide k
//   step once into its bf16 A fragment and feeds it to NT / 128 products
//   m64n128k16 whose B operand is x's tile in shared memory: x [M, K]
//   row-major is exactly the K-major B that wgmma reads. A weight byte is
//   converted M / NT times (18 at FLUX.1's 4608 rows and NT 256), where the
//   mma.sync kernel this replaces converted it in every warp row of every
//   128-row tile (72 times), and the mma.sync m16n8k16 it ran on reaches
//   about two thirds of the tensor cores' rate.
// - One producer warp keeps a ring of stages full with TMA: each stage
//   holds the weight's [128 channels x 64 bytes] tile (64-byte swizzle),
//   x's [NT x 64] tile (128-byte swizzle) and for int4 also x's tile at
//   K/2 + k and the stage's scales ([128][4] f32: the low and high halves'
//   groups at k and k + 32, copied by the producer's lanes with cp.async
//   against the same mbarrier). The stage count fills the 227 KB of shared
//   memory (8, 5, 5 and 3 stages for int8 / int4 at NT 128 / 256). Nothing
//   reads device memory inside the k loop but the TMA unit and the
//   producer's copies.
// - The conversion: a byte permute puts each byte (sign flipped) under the
//   exponent of 2^23, and one f32 subtraction of 2^23 + 128 gives the
//   integer exactly, with no I2F; it is then times its scale in f32 and
//   rounded to bf16 to nearest even: bitwise the plain version's (and the
//   reference's) dequant, bf16(q · s), so that K4 differs from the plain
//   version only in its order of summation. int8's scale is its channel's,
//   two registers a thread (its fragment's two rows); int4's, its group's
//   from shared memory. Scaling in the f32 epilogue instead (exact q in the
//   product, the scale once an output) would save the multiply but differ
//   from the plain dequant by that rounding in every weight: about 2e-3
//   relative L2 a call, which builds up over a model's depth against the
//   whole-model holds, for a conversion that is not what bounds the kernel.
//   A k step of int4 bytes feeds two products, the low nibbles against x
//   at k and the high ones against x at K/2 + k.
// - At NT 256 a consumer converts step j + 1 while step j's products run
//   (two A fragments in turn, each freed by wgmma.wait_group 1), and frees
//   a stage once its last products are done. At NT 128 it converts a whole
//   stage's four fragments, issues them and waits: ptxas serialises the
//   per-step schedule's wgmmas there, and the other consumer warpgroup's
//   products keep the tensor cores busy meanwhile.
// - Where the output has too few tiles for the card's 132 SMs, the K loop
//   is split across blocks (ops/quant.py `k4_gemm_plan` picks NT and the
//   split from the shape), each writing its f32 partial sums into a
//   workspace the wrapper allocates; a second kernel sums the splits in
//   order, adds the bias and rounds to bf16. No
//   atomics: a result is the same from run to run.
// - The epilogue adds the bias and writes y [M, N] in bf16, masking the
//   ragged M and N edges (the TMA unit zero-fills the tiles past them).
//
// bf16, M <= GEMV_MAX_M: `quant_gemv_bf16<INT4, MB>`, bound by the weight's
// bytes (0.0169 ms for FLUX.1's double-block modulation [1, 3072 -> 18432]
// at int8 at 3.35 TB/s). x's rows (MB, M rounded up to a power of two, the
// rows past M zero) are staged in shared memory in chunks, permuted so
// that a warp's lanes read consecutive 8-byte words; each warp streams
// 16-byte loads of its channels' weight rows (neighbouring lanes on
// neighbouring addresses, 64 bytes in flight a lane), dequantizes each
// byte as above (bf16(q · s), back in f32), accumulates in f32, reduces
// across the warp with shuffles, and writes y with the bias. Four channels
// a warp, eight warps a block, 576 blocks for the double-block
// modulation: several blocks on each SM keep device memory busy.
//
// f32 routes (unchanged): a tiled FFMA kernel, 64 x 64 output tiles, 4 x 4
// outputs a thread, the weight dequantized to f32 (exactly q · s) as it is
// staged in shared memory. Their redesign (3xTF32 on wgmma) is later work.
//
// Shapes taken: any M >= 1; N a multiple of 8; K a multiple of 64; for int4
// a group that is a multiple of 32 and divides K/2. x, W, the scales, the
// bias and y contiguous and 16-byte aligned. The wrapper
// (sdxl_tpu_torch/ops/quant.py `quant_linear`) checks all of this.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;
using flash::allow_smem_once;
using flash::pack_bf16;

// ---------------------------------------------------------------------------
// conversions
// ---------------------------------------------------------------------------

// a signed nibble (0..15 as stored) -> -8..7
__device__ __forceinline__ float nibble(uint32_t u) {
  return static_cast<float>(static_cast<int>(u ^ 8u) - 8);
}

__device__ __forceinline__ float int8_at(uint32_t v, int byte) {
  return static_cast<float>(static_cast<int8_t>((v >> (8 * byte)) & 0xffu));
}

// Byte `i` of u (0..255) as the f32 2^23 + u_i: the byte under the
// exponent of 2^23, no FP instruction.
template <int I>
__device__ __forceinline__ float magic_byte(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | I));
}

// The four signed bytes of v -> f32, exactly: each byte with its sign bit
// flipped is 128 + q, so (2^23 + 128 + q) - (2^23 + 128) = q.
__device__ __forceinline__ void s8x4_f32(uint32_t v, float (&f)[4]) {
  const uint32_t u = v ^ 0x80808080u;
  f[0] = magic_byte<0>(u) - 8388736.f;
  f[1] = magic_byte<1>(u) - 8388736.f;
  f[2] = magic_byte<2>(u) - 8388736.f;
  f[3] = magic_byte<3>(u) - 8388736.f;
}

// The eight signed nibbles of v -> f32, exactly: lo[i] from byte i's low
// nibble, hi[i] from its high one (each nibble + 8, mod 16, under 2^23).
__device__ __forceinline__ void s4x8_f32(uint32_t v, float (&lo)[4],
                                         float (&hi)[4]) {
  const uint32_t u = v ^ 0x88888888u;
  const uint32_t l = u & 0x0F0F0F0Fu, h = (u >> 4) & 0x0F0F0F0Fu;
  lo[0] = magic_byte<0>(l) - 8388616.f;
  lo[1] = magic_byte<1>(l) - 8388616.f;
  lo[2] = magic_byte<2>(l) - 8388616.f;
  lo[3] = magic_byte<3>(l) - 8388616.f;
  hi[0] = magic_byte<0>(h) - 8388616.f;
  hi[1] = magic_byte<1>(h) - 8388616.f;
  hi[2] = magic_byte<2>(h) - 8388616.f;
  hi[3] = magic_byte<3>(h) - 8388616.f;
}

// Two signed bytes (v's low 16 bits, the lower k in byte 0) times their
// channel's scale in f32, rounded to bf16 to nearest even, as the plain
// version's dequant.
__device__ __forceinline__ uint32_t s8x2_bf16x2(uint32_t v, float s) {
  const uint32_t u = v ^ 0x8080u;
  return pack_bf16((magic_byte<0>(u) - 8388736.f) * s,
                   (magic_byte<1>(u) - 8388736.f) * s);
}

// The four nibbles of v's low 16 bits (byte b's low nibble at k b, its high
// nibble at k b + K/2) times their group's scale in f32, rounded to bf16 to
// nearest even, as the plain version's dequant: `lo` the low nibbles of
// bytes 0 and 1, `hi` the high ones.
__device__ __forceinline__ void s4x4_bf16x2(uint32_t v, float s_lo,
                                            float s_hi, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t u = v ^ 0x8888u;
  const uint32_t l = u & 0x0F0Fu, h = (u >> 4) & 0x0F0Fu;
  lo = pack_bf16((magic_byte<0>(l) - 8388616.f) * s_lo,
                 (magic_byte<1>(l) - 8388616.f) * s_lo);
  hi = pack_bf16((magic_byte<0>(h) - 8388616.f) * s_hi,
                 (magic_byte<1>(h) - 8388616.f) * s_hi);
}

__device__ __forceinline__ float bf16_bits_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_bits_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// f[i] times s, each rounded to bf16 to nearest even (the plain version's
// dequant), back in f32
__device__ __forceinline__ void scale_bf16x4(float (&f)[4], float s) {
  const uint32_t a = pack_bf16(f[0] * s, f[1] * s);
  const uint32_t b = pack_bf16(f[2] * s, f[3] * s);
  f[0] = bf16_bits_lo(a);
  f[1] = bf16_bits_hi(a);
  f[2] = bf16_bits_lo(b);
  f[3] = bf16_bits_hi(b);
}

// ---------------------------------------------------------------------------
// the bf16 GEMM (M > GEMV_MAX_M)
// ---------------------------------------------------------------------------

constexpr int kChannels = 128;  // output channels a block: two warpgroups
constexpr int kBK = 64;         // weight bytes a stage takes along a row
constexpr int kWTile = kChannels * kBK;  // the stage's weight tile
constexpr int kSmemLimit = 232448;       // 227 KB a block
constexpr int kGemmThreads = 384;        // a producer and two consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__host__ __device__ constexpr int min_int(int a, int b) { return a < b ? a : b; }

template <bool INT4, int NT>
struct GemmPlan {
  static_assert(NT == 128 || NT == 256, "128 or 256 rows of x a block");
  static constexpr int kXTiles = INT4 ? 2 : 1;  // x at k (and at K/2 + k)
  static constexpr int kXTile = NT * kRowBytes;  // NT rows x 64 bf16
  static constexpr int kScales = INT4 ? kChannels * 16 : 0;  // [128][4] f32
  static constexpr int kWOffset = kXTiles * kXTile;
  static constexpr int kStageBytes = kWOffset + kWTile + kScales;
  static constexpr int kTxBytes = kWOffset + kWTile;  // the TMA copies
  static constexpr int kStages =
      min_int(8, (kSmemLimit - 1024 - 256) / kStageBytes);
  static constexpr int kBars = kStages * kStageBytes;
  static constexpr int kSmemBytes = kBars + 16 * kStages + 1024;
  // the consumer's schedule: NT 256 converts step j + 1 under step j's
  // products; NT 128 converts a whole stage, then issues it and waits
  // (ptxas serialises NT 128's wgmmas under the per-step schedule, and the
  // other consumer warpgroup's products fill the tensor cores meanwhile)
  static constexpr bool kWholeStage = NT == 128;
  static_assert(kStageBytes % 1024 == 0, "stages on 1024-byte boundaries");
  static_assert(kStages >= 3 && kSmemBytes <= kSmemLimit, "the ring fits");
};

#define QL_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define QL_F16(i) QL_F4(i), QL_F4(i + 4), QL_F4(i + 8), QL_F4(i + 12)

// D[64x128] += A[64x16] B[16x128]: A in registers, B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_kmajor_n128(float (&d)[64],
                                                     const uint32_t* a,
                                                     uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : QL_F16(0), QL_F16(16), QL_F16(32), QL_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef QL_F16
#undef QL_F4

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N, int R>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][R]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_u32(r[i]);
}

// 4 bytes from device memory into shared memory (zeros where !valid)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies land
// (counted in the barrier's arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One block a (128 channels, NT rows, K split) tile. ws null: y = the
// whole K's sum plus the bias, in bf16; else the split's f32 sums go to ws
// [splits, M, N].
template <bool INT4, int NT>
__global__ void __launch_bounds__(kGemmThreads, 1)
    quant_gemm_bf16(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const float* __restrict__ qs,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                    int M, int N, int K, int group, int per_split) {
  using P = GemmPlan<INT4, NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* empty = full + P::kStages;
  const int n0 = blockIdx.x * kChannels, m0 = blockIdx.y * NT;
  const int row_bytes = INT4 ? K / 2 : K;
  const int kt0 = blockIdx.z * per_split;
  const int kt1 = min((row_bytes + kBK - 1) / kBK, kt0 + per_split);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      // the TMA arrival, and for int4 the producer lanes' scale copies
      mbar_init(&full[s], INT4 ? 33 : 1);
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: warp 0 fills the ring
    setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane >= 32 || (!INT4 && lane > 0)) return;
    const int n_groups = INT4 ? K / group : 1;
    for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
      const int s = it % P::kStages;
      mbar_wait(&empty[s], ((it / P::kStages) & 1) ^ 1);
      unsigned char* st = smem + s * P::kStageBytes;
      if (lane == 0) {
        mbar_expect_tx(&full[s], P::kTxBytes);
        tma_load(st, &x_map, &full[s], kt * kBK, m0, 0);
        if (INT4)
          tma_load(st + P::kXTile, &x_map, &full[s], K / 2 + kt * kBK, m0, 0);
        tma_load(st + P::kWOffset, &w_map, &full[s], kt * kBK, n0, 0);
      }
      if constexpr (INT4) {
        // scale e of channel ch: the low (e < 2) or high half's group at
        // k = kt * 64 + 32 (e & 1)
        float* sc = reinterpret_cast<float*>(st + P::kWOffset + kWTile);
        for (int i = lane; i < kChannels * 4; i += 32) {
          const int ch = i >> 2, e = i & 3;
          const int kk = kt * kBK + (e & 1) * 32;  // within the half
          const int k = (e & 2 ? K / 2 : 0) + kk;
          const bool ok = n0 + ch < N && kk < K / 2;
          cp_async4(sc + i,
                    qs + static_cast<size_t>(ok ? n0 + ch : 0) * n_groups +
                        k / group,
                    ok);
        }
        cp_async_arrive(&full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  // this thread's A rows (channels) in the tile: r0 and r0 + 8; both have
  // the same 64-byte swizzle, chunk j at (j ^ sw) * 16
  const int r0 = 64 * (wg - 1) + 16 * warp + g;
  const int sw = (r0 >> 1) & 3;
  const int na = n0 + r0, nb = na + 8;  // its channels
  // int8: the two channels' scales
  float s8[2] = {0.f, 0.f};
  if (!INT4) {
    s8[0] = na < N ? qs[na] : 0.f;
    s8[1] = nb < N ? qs[nb] : 0.f;
  }

  float acc[NT / 128][64];
#pragma unroll
  for (int h = 0; h < NT / 128; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  // the A fragment of step j (k bytes 16j .. 16j + 15 of the stage) from
  // the weight tile: bytes (2tq, 2tq + 1) and (2tq + 8, 2tq + 9) of rows
  // r0 and r0 + 8, the fragment's {(g, 2tq), (g + 8, 2tq), (g, 2tq + 8),
  // (g + 8, 2tq + 8)}; int4: the low nibbles in a[0..3], the high ones in
  // a[4..7]
  auto convert = [&](const unsigned char* wt, int j, const float4& sc0,
                     const float4& sc1, uint32_t* a) {
    const unsigned char* p = wt + r0 * kBK + ((j ^ sw) << 4) + 2 * tq;
    uint32_t v[4];
    v[0] = *reinterpret_cast<const uint16_t*>(p);
    v[1] = *reinterpret_cast<const uint16_t*>(p + 8 * kBK);
    v[2] = *reinterpret_cast<const uint16_t*>(p + 8);
    v[3] = *reinterpret_cast<const uint16_t*>(p + 8 * kBK + 8);
    if constexpr (INT4) {
      const float lo0 = j < 2 ? sc0.x : sc0.y, hi0 = j < 2 ? sc0.z : sc0.w;
      const float lo1 = j < 2 ? sc1.x : sc1.y, hi1 = j < 2 ? sc1.z : sc1.w;
      s4x4_bf16x2(v[0], lo0, hi0, a[0], a[4]);
      s4x4_bf16x2(v[1], lo1, hi1, a[1], a[5]);
      s4x4_bf16x2(v[2], lo0, hi0, a[2], a[6]);
      s4x4_bf16x2(v[3], lo1, hi1, a[3], a[7]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = s8x2_bf16x2(v[q], s8[q & 1]);
    }
  };
  // the products of step j on the stage's x tile(s) at xa
  auto issue = [&](uint32_t xa, int j, const uint32_t* a) {
#pragma unroll
    for (int h = 0; h < NT / 128; ++h) {
      wgmma_rs_kmajor_n128(acc[h], a,
                           desc128(xa + h * 128 * kRowBytes + 32 * j, 16));
      if constexpr (INT4)
        wgmma_rs_kmajor_n128(
            acc[h], a + 4,
            desc128(xa + P::kXTile + h * 128 * kRowBytes + 32 * j, 16));
    }
  };

  const uint32_t smem_base = smem_u32(smem);
  // whole stage: one fragment a step; per step: two in turn
  uint32_t frag[P::kWholeStage ? kBK / 16 : 2][INT4 ? 8 : 4];
#pragma unroll
  for (int i = 0; i < (P::kWholeStage ? kBK / 16 : 2); ++i)
#pragma unroll
    for (int r = 0; r < (INT4 ? 8 : 4); ++r) frag[i][r] = 0u;
  for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
    const int s = it % P::kStages;
    mbar_wait(&full[s], (it / P::kStages) & 1);
    const unsigned char* wt = smem + s * P::kStageBytes + P::kWOffset;
    const uint32_t xa = smem_base + s * P::kStageBytes;
    float4 sc0 = make_float4(0.f, 0.f, 0.f, 0.f), sc1 = sc0;
    if constexpr (INT4) {
      const float4* sc = reinterpret_cast<const float4*>(wt + kWTile);
      sc0 = sc[r0];
      sc1 = sc[r0 + 8];
    }
    if constexpr (P::kWholeStage) {
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) convert(wt, j, sc0, sc1, frag[j]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) issue(xa, j, frag[j]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_frags(frag);
      mbar_arrive(&empty[s]);
    } else {
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        convert(wt, j, sc0, sc1, frag[j & 1]);
        wgmma_fence();
        issue(xa, j, frag[j & 1]);
        wgmma_commit();
        // the previous step's products are done: its fragment is free,
        // and after a stage's first step the previous stage is
        wgmma_wait<1>();
        fence_u32(frag[(j & 1) ^ 1]);
        if (j == 0 && it > 0) mbar_arrive(&empty[(it - 1) % P::kStages]);
      }
    }
  }
  wgmma_wait<0>();
  fence_frags(frag);
#pragma unroll
  for (int h = 0; h < NT / 128; ++h) fence_regs(acc[h]);

  // acc[h][4i + e]: channel n0 + r0 (+ 8 for e >= 2), row m0 + 128h + 8i +
  // 2tq (+ 1 for odd e)
  if (ws != nullptr) {
    float* out = ws + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
    for (int h = 0; h < NT / 128; ++h)
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = e & 2 ? nb : na;
          const int m = m0 + 128 * h + 8 * i + 2 * tq + (e & 1);
          if (n < N && m < M) out[static_cast<size_t>(m) * N + n] = acc[h][4 * i + e];
        }
    return;
  }
  float ba = 0.f, bb = 0.f;
  if (bias != nullptr) {
    ba = na < N ? __bfloat162float(bias[na]) : 0.f;
    bb = nb < N ? __bfloat162float(bias[nb]) : 0.f;
  }
#pragma unroll
  for (int h = 0; h < NT / 128; ++h)
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 2;
        const int n = hi ? nb : na;
        const int m = m0 + 128 * h + 8 * i + 2 * tq + (e & 1);
        if (n < N && m < M)
          y[static_cast<size_t>(m) * N + n] =
              __float2bfloat16_rn(acc[h][4 * i + e] + (hi ? bb : ba));
      }
}

// The split-K sum: y = (sum of the splits' partials in order) + bias, in
// bf16; four outputs a thread (N is a multiple of 8).
__global__ void __launch_bounds__(256)
    quant_splitk_sum(const float* __restrict__ ws,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int M, int N, int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= total) return;
  const int n = static_cast<int>(i % N);
  float4 sum = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(ws + s * total + i);
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (bias != nullptr) v[e] += __bfloat162float(bias[n + e]);
  *reinterpret_cast<uint2*>(y + i) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// ---------------------------------------------------------------------------
// the bf16 GEMV (M <= GEMV_MAX_M)
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 256, kGemvWarps = 8;
constexpr int kGemvSmem = 48 * 1024;  // x's chunk, at most

constexpr int kGemvCh = 4;                         // channels a warp
constexpr int kGemvBlockCh = kGemvWarps * kGemvCh;  // channels a block

// Chunk byte b (along a weight row; int8: k, int4: k within a half) ->
// its element in the staged x: lane l's four values of sub-step q of
// 512-byte span c, at bytes 512c + 16l + 4q + e, sit at ((4c + q) * 32 +
// l) * 4 + e, so a warp's lanes read consecutive 8-byte words.
__device__ __forceinline__ int xperm(int b) {
  return ((((b >> 9) << 2) | ((b >> 2) & 3)) << 7) | (((b >> 4) & 31) << 2) |
         (b & 3);
}

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// One warp a kCh-channel group, eight a block; x staged `chunk` weight
// bytes at a time ([MB][SEG][stride] bf16, xperm order).
template <bool INT4, int MB>
__global__ void __launch_bounds__(kGemvThreads, 2)
    quant_gemv_bf16(const __nv_bfloat16* __restrict__ x,
                    const uint8_t* __restrict__ w,
                    const float* __restrict__ qs,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y, int M, int N, int K,
                    int group, int chunk) {
  static_assert(MB == 1 || MB == 2 || MB == 4, "MB 1, 2 or 4 rows");
  constexpr int CH = kGemvCh, SEG = INT4 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char gemv_smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(gemv_smem);
  const int stride = (chunk + 511) / 512 * 512;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_base = blockIdx.x * kGemvBlockCh + warp * CH;
  const int row_bytes = INT4 ? K / 2 : K, half = K / 2;
  const int n_groups = INT4 ? K / group : 1;

  float acc[CH][MB];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int m = 0; m < MB; ++m) acc[c][m] = 0.f;

  for (int b0 = 0; b0 < row_bytes; b0 += chunk) {
    const int len = min(chunk, row_bytes - b0);
    __syncthreads();  // the previous chunk's reads are done
    const int per = len / 8;
    for (int i = threadIdx.x; i < MB * SEG * per; i += kGemvThreads) {
      const int m = i / (SEG * per), r = i % (SEG * per);
      const int h = r / per, b = (r % per) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M)
        v = *reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(m) * K + h * half + b0 + b);
      __nv_bfloat16* dst = xs + (m * SEG + h) * stride;
      *reinterpret_cast<uint2*>(dst + xperm(b)) = make_uint2(v.x, v.y);
      *reinterpret_cast<uint2*>(dst + xperm(b + 4)) = make_uint2(v.z, v.w);
    }
    __syncthreads();
    for (int off = 16 * lane; off < len; off += 512) {
      uint4 wv[CH];
      float s_lo[CH], s_hi[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int n = n_base + c;
        wv[c] = make_uint4(0u, 0u, 0u, 0u);
        s_lo[c] = s_hi[c] = 0.f;
        if (n < N) {
          wv[c] = ld_stream(w + static_cast<size_t>(n) * row_bytes + b0 + off);
          const float* qn = qs + static_cast<size_t>(n) * n_groups;
          s_lo[c] = qn[INT4 ? (b0 + off) / group : 0];
          if (INT4) s_hi[c] = qn[(half + b0 + off) / group];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float wf[SEG][CH][4];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if constexpr (INT4) {
            s4x8_f32(word(wv[c], q), wf[0][c], wf[SEG - 1][c]);
            scale_bf16x4(wf[0][c], s_lo[c]);
            scale_bf16x4(wf[SEG - 1][c], s_hi[c]);
          } else {
            s8x4_f32(word(wv[c], q), wf[0][c]);
            scale_bf16x4(wf[0][c], s_lo[c]);
          }
        }
        const int xi = xperm(off + 4 * q);
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int h = 0; h < SEG; ++h) {
            const uint2 xv = *reinterpret_cast<const uint2*>(
                xs + (m * SEG + h) * stride + xi);
            const float xf[4] = {bf16_bits_lo(xv.x), bf16_bits_hi(xv.x),
                                 bf16_bits_lo(xv.y), bf16_bits_hi(xv.y)};
#pragma unroll
            for (int c = 0; c < CH; ++c)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[c][m] = fmaf(wf[h][c][e], xf[e], acc[c][m]);
          }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[c][m] += __shfl_xor_sync(0xffffffffu, acc[c][m], o);
  if (lane != 0) return;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int n = n_base + c;
    if (n >= N) continue;
    const float b = bias != nullptr ? __bfloat162float(bias[n]) : 0.f;
#pragma unroll
    for (int m = 0; m < MB; ++m)
      if (m < M)
        y[static_cast<size_t>(m) * N + n] = __float2bfloat16_rn(acc[c][m] + b);
  }
}

// ---------------------------------------------------------------------------
// f32 routes (unchanged)
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A 2-D map (as 3-D, the last dimension 1) over the [n, row_bytes] weight
// bytes, boxes of [kChannels rows x kBK bytes], 64-byte swizzled; reads
// past n are zeros.
inline cudaError_t make_w_map(CUtensorMap* map, const void* w, int n,
                              int row_bytes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)row_bytes, (cuuint64_t)n, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes,
                                 (cuuint64_t)row_bytes * n};
  const cuuint32_t box[3] = {kBK, kChannels, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool INT4, int NT>
int launch_gemm(const void* x, const void* qw, const void* qs,
                const void* bias, void* y, void* ws, int M, int N, int K,
                int group, int splits, cudaStream_t stream) {
  using P = GemmPlan<INT4, NT>;
  static std::atomic<unsigned long long> smem_set{0};
  const int row_bytes = INT4 ? K / 2 : K;
  const int stages = (row_bytes + kBK - 1) / kBK;
  if (splits < 1 || splits > stages || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (stages + splits - 1) / splits;
  CUtensorMap x_map, w_map;
  cudaError_t err = make_map(&x_map, x, false, 1, M, K, NT);
  if (err == cudaSuccess) err = make_w_map(&w_map, qw, N, row_bytes);
  if (err == cudaSuccess)
    err = allow_smem_once(quant_gemm_bf16<INT4, NT>, P::kSmemBytes,
                          &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kChannels - 1) / kChannels, (M + NT - 1) / NT, splits);
  quant_gemm_bf16<INT4, NT><<<grid, kGemmThreads, P::kSmemBytes, stream>>>(
      x_map, w_map, static_cast<const float*>(qs),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y),
      splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, K, group, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t quads = static_cast<size_t>(M) * N / 4;
  quant_splitk_sum<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT4>
int launch_gemm_nt(const void* x, const void* qw, const void* qs,
                   const void* bias, void* y, void* ws, int M, int N, int K,
                   int group, int nt, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt == 128)
    return launch_gemm<INT4, 128>(x, qw, qs, bias, y, ws, M, N, K, group,
                                  splits, s);
  if (nt == 256)
    return launch_gemm<INT4, 256>(x, qw, qs, bias, y, ws, M, N, K, group,
                                  splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x's chunk (weight bytes a pass) at MB rows: all of a row if it fits in
// kGemvSmem, else the most 512-byte spans that do
template <bool INT4>
inline int gemv_chunk(int mb, int row_bytes) {
  const int fit = kGemvSmem / (mb * (INT4 ? 2 : 1) * 2) / 512 * 512;
  return row_bytes <= fit ? row_bytes : fit;
}

template <bool INT4>
inline int gemv_smem(int mb, int row_bytes) {
  const int chunk = gemv_chunk<INT4>(mb, row_bytes);
  return mb * (INT4 ? 2 : 1) * ((chunk + 511) / 512 * 512) * 2;
}

template <bool INT4, int MB>
int launch_gemv_mb(const void* x, const void* qw, const void* qs,
                   const void* bias, void* y, int M, int N, int K, int group,
                   cudaStream_t stream) {
  const int row_bytes = INT4 ? K / 2 : K;
  const int chunk = gemv_chunk<INT4>(MB, row_bytes);
  const int smem = gemv_smem<INT4>(MB, row_bytes);
  const int blocks = (N + kGemvBlockCh - 1) / kGemvBlockCh;
  quant_gemv_bf16<INT4, MB><<<blocks, kGemvThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qw),
      static_cast<const float*>(qs), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, N, K, group, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT4>
int launch_gemv(const void* x, const void* qw, const void* qs,
                const void* bias, void* y, int M, int N, int K, int group,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1)
    return launch_gemv_mb<INT4, 1>(x, qw, qs, bias, y, M, N, K, group, s);
  if (M <= 2)
    return launch_gemv_mb<INT4, 2>(x, qw, qs, bias, y, M, N, K, group, s);
  if (M <= 4)
    return launch_gemv_mb<INT4, 4>(x, qw, qs, bias, y, M, N, K, group, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
// The bf16 GEMMs take nt (128 or 256 rows of x a block) and splits (the K
// loop's split across blocks); splits > 1 needs ws, an f32 workspace of
// [splits, M, N]. Each returns the launches' CUDA error (0 on success).
extern "C" {

int sdxl_quant_linear_bf16_int8(const void* x, const void* qw, const void* qs,
                                const void* bias, void* y, void* ws, int M,
                                int N, int K, int group, int nt, int splits,
                                void* stream) {
  return launch_gemm_nt<false>(x, qw, qs, bias, y, ws, M, N, K, group, nt,
                               splits, stream);
}

int sdxl_quant_linear_bf16_int4(const void* x, const void* qw, const void* qs,
                                const void* bias, void* y, void* ws, int M,
                                int N, int K, int group, int nt, int splits,
                                void* stream) {
  return launch_gemm_nt<true>(x, qw, qs, bias, y, ws, M, N, K, group, nt,
                              splits, stream);
}

int sdxl_quant_linear_bf16_int8_gemv(const void* x, const void* qw,
                                     const void* qs, const void* bias,
                                     void* y, int M, int N, int K, int group,
                                     void* stream) {
  return launch_gemv<false>(x, qw, qs, bias, y, M, N, K, group, stream);
}

int sdxl_quant_linear_bf16_int4_gemv(const void* x, const void* qw,
                                     const void* qs, const void* bias,
                                     void* y, int M, int N, int K, int group,
                                     void* stream) {
  return launch_gemv<true>(x, qw, qs, bias, y, M, N, K, group, stream);
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

// Dynamic shared memory of a kernel, for the build check: 0 GEMM int8 and
// 1 GEMM int4 (a = NT), 2 f32 int8 and 3 f32 int4 (static: 0), 4 GEMV
// int8 and 5 GEMV int4 (a = MB; the most any K takes).
int quant_linear_smem_bytes(int kernel, int a, int, int) {
  switch (kernel) {
    case 0: return a == 256 ? GemmPlan<false, 256>::kSmemBytes
                            : GemmPlan<false, 128>::kSmemBytes;
    case 1: return a == 256 ? GemmPlan<true, 256>::kSmemBytes
                            : GemmPlan<true, 128>::kSmemBytes;
    case 4: return gemv_smem<false>(a, 1 << 30);
    case 5: return gemv_smem<true>(a, 1 << 30);
    default: return 0;
  }
}

}  // extern "C"
