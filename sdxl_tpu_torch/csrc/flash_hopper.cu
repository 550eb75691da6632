// K1's two bf16 routes on Hopper's own machinery (sm_90a): TMA loads into
// a ring of shared-memory stages tracked by mbarriers, warpgroup matrix
// products (wgmma), and a producer warpgroup that hands its registers to
// the consumers (setmaxnreg). Bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel of sdxl_tpu/ops/flash_attention.py
// `flash_attention_bhtd` with return_lse=False (:140; `_flash_kernel` :92,
// `_flash_kernel_core` :40, pallas_call :207) on its two bf16 routes:
// unmasked softmax(q k^T / sqrt(d)) v over [B,H,T,D] with the reference's
// numerics kept exactly:
//   - q is multiplied by d^-0.5 * log2(e) in f32 and rounded to bf16
//     before any product (flash_attention.py:185);
//   - the online softmax runs in base 2 with f32 logits, running max m,
//     normaliser l and accumulator (exp2 flushes results below 2^-126 to
//     zero, as the TPU's f32 does); p is rounded to bf16 before P V while
//     l sums the f32 p;
//   - the output is acc / l rounded to bf16.
// Ragged token counts: the tensor maps are 3-D over [B*H, T, D], so a tile
// that runs past T is zero-filled by the TMA unit and never reads the next
// head's rows; keys >= tk still get a -inf logit (a zero key would give
// logit 0), and query rows >= tq are never stored.
//
// flash_fwd_wgmma<D> (the UNet's self-attention, d = 64 or 128).
//   Bound: 4*B*H*T^2*D tensor-core operations against 8 bytes of q/k/v/o
//   per element, far above the card's ~295 FLOP/byte ridge, so the bound
//   is the bf16 tensor-core rate (989 TFLOP/s). The mma.sync kernel it
//   replaces sat at 11% of it, its time in synchronous, transposing loads
//   (PERF.md, X2 and X3). Here the loads cost the consumers nothing: one
//   thread of the producer warpgroup keeps TMA copies of K and V tiles in
//   flight in a two-stage ring, and the consumers wait on the stage's
//   mbarrier. No operand is transposed or copied by a thread: S = Q K^T
//   reads Q and K from shared memory (both K-major), and P V takes P from
//   registers (the f32 accumulator fragment of S rounded to bf16 is the
//   A-register fragment of the next product, as FlashAttention-3 uses it)
//   and V from shared memory as an MN-major B operand (transpose-B).
//   Each consumer warpgroup runs S, softmax and P V in turn; the other
//   warpgroups' products fill the tensor cores meanwhile, so more
//   consumers hide more of the softmax (exp2 is about a fifth of the time
//   at d = 64). The rows' max and sum run as four partial chains each.
//   Tiles: three consumer warpgroups of 64 query rows at d = 64 (192 rows
//   a tile), two at d = 128 (128 rows); 128 keys a stage. One block a
//   (q-tile, b*h) tile: at T = 1024, 240 tiles of 192 rows on 132 SMs (a
//   persistent grid walking the tiles measured no faster, PERF.md). Shared
//   memory: Q 24 KB (d 64) or 32 KB (d 128), two K/V stages of 32 or 64
//   KB, all in 128-byte-swizzled boxes of 64 columns, so a d=128 row spans
//   two boxes and the descriptors step from one to the other: 88 KB or 160
//   KB, one block per SM. Registers: the producer drops to 24 (d 64) or
//   40, the consumers rise to 160 (d 64: S 64 f32, O 32 f32, P 32 packed
//   bf16 pairs) or 232 (d 128: O 64 f32). The q pre-scale is an
//   elementwise pass over the consumer's own Q rows in shared memory after
//   the TMA load (the swizzle only permutes 16-byte chunks), followed by a
//   proxy fence so that wgmma's async-proxy reads see it.
//
// flash_fwd_d512 (the bf16 VAE decode's mid-block attention, [1,1,T,512]).
//   Bound: the same operation count, 4*T^2*512; at T = 16384 the
//   operations take 0.556 ms at 989 TFLOP/s against 0.07 ms of bytes. The
//   FMA kernel it replaces ran on the f32 pipes at 1.5% of that bound.
//   A 64x512 f32 accumulator is 256 registers a thread in one warpgroup,
//   so the output's 512 columns are split between two consumer warpgroups
//   (256 columns each: two m64n128 accumulators, 128 registers). The
//   logits are shared instead of recomputed: each warpgroup computes S over
//   its half of the head dim (Q columns and K columns 256c..256c+255), the
//   two f32 partial S fragments are exchanged through shared memory (both
//   warpgroups hold the same fragment positions, so thread t adds thread
//   t's partial of the other group), and both then run the same softmax on
//   the same full S and keep P in registers for their P V. wgmma fits this
//   split: 64 query rows are one warpgroup tile, and both products take
//   the warpgroup's whole fragment (m64n32 for S, m64n128 twice for P V).
//   Tiles: 64 query rows a block, 32 keys a stage. Shared memory: Q 64 KB
//   resident, two K/V stages of 32 + 32 KB, the partial-S exchange 2 x 16
//   KB (double-buffered by tile parity, so one barrier a tile suffices):
//   224 KB, one block per SM; 256 blocks at T = 16384.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace {

using flash::allow_smem_once;
using flash::pack_bf16;

constexpr int kBoxCols = 64;          // bf16 columns in a 128-byte swizzle box
constexpr int kRowBytes = 128;        // one box row

// ---------------------------------------------------------------------------
// Hopper primitives (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive once and add `bytes` to the transactions this phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; its bytes count against the barrier's expected transactions.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Make this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 128B.
// K-major (Q, K): 8-row groups 1024 bytes apart (stride), the leading
// offset unused. MN-major (V): 8-key groups 1024 bytes apart (stride),
// 64-column boxes `lbo` bytes apart (leading).
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from touching registers across a wgmma that is still
// in flight (accumulators, and the A fragments of a register-A product,
// which must not change until its wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define SDXL_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SDXL_F16(i) SDXL_F4(i), SDXL_F4(i + 4), SDXL_F4(i + 8), SDXL_F4(i + 12)

// D[64x32] (+)= A[64x16] B[16x32]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : SDXL_F16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64x128] (+)= A[64x16] B[16x128]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SDXL_F16(0), SDXL_F16(16), SDXL_F16(32), SDXL_F16(48)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64x64] += A[64x16] B[16x64]: A in registers, B MN-major in shared
// memory (transpose-B).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t a[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SDXL_F16(0), SDXL_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64x128] += A[64x16] B[16x128]: A in registers, B MN-major in shared
// memory (transpose-B).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t a[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SDXL_F16(0), SDXL_F16(16), SDXL_F16(32), SDXL_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef SDXL_F16
#undef SDXL_F4

// The dynamic shared memory from its first 1024-byte boundary (a
// 128-byte-swizzled tile must start on one).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Multiply `bytes` of bf16 in shared memory by `scale` in f32 and round
// back to bf16 (the reference's pre-scaled q), `threads` threads from
// thread `t`; the swizzle only permutes 16-byte chunks, so any order does.
__device__ __forceinline__ void prescale(unsigned char* p, int bytes,
                                         float scale, int t, int threads) {
  for (int i = t * 16; i < bytes; i += threads * 16) {
    uint4 x = *reinterpret_cast<uint4*>(p + i);
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(p + i) = x;
  }
}

// 2^x on the SFU, results below 2^-126 flushed to zero (exp2f's
// subnormal fix-up costs three more instructions an element; the TPU the
// reference ran on flushes f32 subnormals too, and a p that small is
// nothing beside l >= 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online-softmax step on one warpgroup's S fragment (f32, base 2) of NK
// keys: rows g and g + 8 of the warp's 16, s[4j + e] at key 8j + 2tg + (e &
// 1). Masks keys >= tk, updates m and l, turns s into the unrounded p and
// returns each row's rescale of the accumulator in alpha.
template <int NK>
__device__ __forceinline__ void softmax_step(float (&s)[NK / 2], int k0,
                                             int tk, int tg, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  if (k0 + NK > tk) {
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * tg + (e & 1) >= tk) s[4 * j + e] = -INFINITY;
  }
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[r][u] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r][j & 3] = fmaxf(mx[r][j & 3],
                           fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    m_new[r] = fmaxf(m[r], x);
    alpha[r] = exp2_ftz(m[r] - m_new[r]);
    m[r] = m_new[r];
  }
  float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2_ftz(s[4 * j + e] - m_new[e >> 1]);
      rs[e >> 1][j & 3] += s[4 * j + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = (rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]);
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    l[r] = alpha[r] * l[r] + x;
  }
}

// The A-register fragment of 16 keys (k-step kk) of P from S's fragment.
__device__ __forceinline__ void p_fragment(const float* s, int kk,
                                           uint32_t a[4]) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// Rows (r, r + 8) of an accumulator fragment, each divided by its l and
// stored as bf16 at columns c0 + 8j + 2tg (rows >= tq skipped).
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N],
                                           __nv_bfloat16* o, int d, int r,
                                           int tq, int c0, int tg,
                                           const float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= tq) continue;
    __nv_bfloat16* row = o + (size_t)(r + 8 * h) * d + c0 + 2 * tg;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * h] / l[h], acc[4 * j + 2 * h + 1] / l[h]);
  }
}

// ---------------------------------------------------------------------------
// bf16, d in {64, 128}
// ---------------------------------------------------------------------------

constexpr int kTile = 128;  // keys a stage
constexpr int kStages = 2;

template <int D>
struct WsPlan {
  static constexpr int kNC = D == 64 ? 3 : 2;  // consumer warpgroups
  static constexpr int kThreads = 128 * (kNC + 1);
  static constexpr int kConsumers = 128 * kNC;
  static constexpr int kRowsQ = 64 * kNC;      // query rows a tile
  static constexpr int kBoxes = D / kBoxCols;  // 64-column boxes a row
  static constexpr int kQBox = kRowsQ * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kBoxBytes = kTile * kRowBytes;  // a K or V box, 16 KB
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kKV = kQBytes;  // stage s: K, then V
  static constexpr int kBars = kKV + 2 * kStages * kTileBytes;
  // q_full, then k_full, v_full and kv_empty for each stage
  static constexpr int kSmemBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

// One block a (b*h, q-tile) tile.
template <int D>
__global__ void __launch_bounds__(WsPlan<D>::kThreads, 1)
flash_fwd_wgmma(__grid_constant__ const CUtensorMap q_map,
                __grid_constant__ const CUtensorMap k_map,
                __grid_constant__ const CUtensorMap v_map,
                __nv_bfloat16* __restrict__ o, int tq, int tk, float scale) {
  using P = WsPlan<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * P::kRowsQ, h = blockIdx.y;
  const int n_kt = (tk + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], P::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread starts every copy
    if constexpr (P::kNC == 3) {
      setmaxnreg_dec<24>();
    } else {
      setmaxnreg_dec<40>();
    }
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, P::kQBytes);
      for (int b = 0; b < P::kBoxes; ++b)
        tma_load(smem + b * P::kQBox, &q_map, q_full, b * kBoxCols, q0, h);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&kv_empty[s], ((kt / kStages) & 1) ^ 1);
        unsigned char* sk = smem + P::kKV + 2 * s * P::kTileBytes;
        mbar_expect_tx(&k_full[s], P::kTileBytes);
        for (int b = 0; b < P::kBoxes; ++b)
          tma_load(sk + b * P::kBoxBytes, &k_map, &k_full[s], b * kBoxCols,
                   kt * kTile, h);
        mbar_expect_tx(&v_full[s], P::kTileBytes);
        for (int b = 0; b < P::kBoxes; ++b)
          tma_load(sk + P::kTileBytes + b * P::kBoxBytes, &v_map, &v_full[s],
                   b * kBoxCols, kt * kTile, h);
      }
    }
    return;
  }

  if constexpr (P::kNC == 3) {
    setmaxnreg_inc<160>();
  } else {
    setmaxnreg_inc<232>();
  }
  const int c = wg - 1;  // this warpgroup's rows: 64c .. 64c + 63
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const uint32_t q_addr = smem_u32(smem) + c * 64 * kRowBytes;

  mbar_wait(q_full, 0);
  for (int b = 0; b < P::kBoxes; ++b)
    prescale(smem + b * P::kQBox + c * 64 * kRowBytes, 64 * kRowBytes, scale,
             t, 128);
  fence_proxy_async();
  bar_sync(1 + c, 128);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;
    const uint32_t k_addr = smem_u32(smem + P::kKV + 2 * s * P::kTileBytes);
    const uint32_t v_addr = k_addr + P::kTileBytes;

    // S = Q K^T over 128 keys: D / 16 k-steps, four to a 64-column box.
    float sc[kTile / 2];
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_n128(sc, desc128(q_addr + (kk / 4) * P::kQBox + off, 16),
                    desc128(k_addr + (kk / 4) * P::kBoxBytes + off, 16),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    float alpha[2];
    softmax_step<kTile>(sc, kt * kTile, tk, tg, m_run, l_run, alpha);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // acc += P V: 8 k-steps of 16 keys, 2048 bytes apart in the V tile.
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) p_fragment(sc, kk, pa[kk]);
    fence_regs(pa);
    mbar_wait(&v_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t vd = desc128(v_addr + kk * 16 * kRowBytes, P::kBoxBytes);
      if constexpr (D == 64) {
        wgmma_rs_n64(acc, pa[kk], vd);
      } else {
        wgmma_rs_n128(acc, pa[kk], vd);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(&kv_empty[s]);
  }

  store_rows(acc, o + (size_t)h * tq * D, D, q0 + 64 * c + 16 * warp + g, tq,
             0, tg, l_run);
}

// ---------------------------------------------------------------------------
// bf16, d = 512
// ---------------------------------------------------------------------------

constexpr int kRows512 = 64;        // query rows a block
constexpr int kKeys512 = 32;        // keys a stage
constexpr int kThreads512 = 384;    // producer warpgroup + two consumers
constexpr int kConsumers512 = 256;

struct D512Plan {
  static constexpr int kBoxes = 512 / kBoxCols;                   // 8
  static constexpr int kQBox = kRows512 * kRowBytes;              // 8 KB
  static constexpr int kKVBox = kKeys512 * kRowBytes;             // 4 KB
  static constexpr int kKVTile = kBoxes * kKVBox;                 // 32 KB
  static constexpr int kKV = kBoxes * kQBox;                      // 64 KB
  static constexpr int kX = kKV + 2 * kStages * kKVTile;          // 192 KB
  static constexpr int kXBuf = 2 * (kKeys512 / 2) * 128 * 4;      // 16 KB
  static constexpr int kBars = kX + 2 * kXBuf;                    // 224 KB
  static constexpr int kSmemBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

__global__ void __launch_bounds__(kThreads512, 1)
flash_fwd_d512(__grid_constant__ const CUtensorMap q_map,
               __grid_constant__ const CUtensorMap k_map,
               __grid_constant__ const CUtensorMap v_map,
               __nv_bfloat16* __restrict__ o, int tq, int tk, float scale) {
  using P = D512Plan;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * kRows512, bh = blockIdx.y;
  const int n_kt = (tk + kKeys512 - 1) / kKeys512;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], kConsumers512);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, P::kBoxes * P::kQBox);
      for (int b = 0; b < P::kBoxes; ++b)
        tma_load(smem + b * P::kQBox, &q_map, q_full, b * kBoxCols, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&kv_empty[s], ((kt / kStages) & 1) ^ 1);
        unsigned char* sk = smem + P::kKV + 2 * s * P::kKVTile;
        mbar_expect_tx(&k_full[s], P::kKVTile);
        for (int b = 0; b < P::kBoxes; ++b)
          tma_load(sk + b * P::kKVBox, &k_map, &k_full[s], b * kBoxCols,
                   kt * kKeys512, bh);
        mbar_expect_tx(&v_full[s], P::kKVTile);
        for (int b = 0; b < P::kBoxes; ++b)
          tma_load(sk + P::kKVTile + b * P::kKVBox, &v_map, &v_full[s],
                   b * kBoxCols, kt * kKeys512, bh);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int c = wg - 1;  // this warpgroup's head-dim half: 256c .. 256c + 255
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;

  // Q: each warpgroup pre-scales the four boxes only its S product reads.
  mbar_wait(q_full, 0);
  prescale(smem + 4 * c * P::kQBox, 4 * P::kQBox, scale, t, 128);
  fence_proxy_async();
  bar_sync(2 + c, 128);

  const uint32_t q_addr = smem_u32(smem) + 4 * c * P::kQBox;
  float* xbuf = reinterpret_cast<float*>(smem + P::kX);  // [2][2][16][128]
  float acc[2][64];  // output columns 256c + 128h + (0 .. 127)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;
    const uint32_t k_addr =
        smem_u32(smem + P::kKV + 2 * s * P::kKVTile) + 4 * c * P::kKVBox;
    const uint32_t v_addr =
        smem_u32(smem + P::kKV + (2 * s + 1) * P::kKVTile) + 4 * c * P::kKVBox;

    // This half's partial S over 32 keys: 16 k-steps, four to a box.
    float sc[kKeys512 / 2];
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_ss_n32(sc,
                   desc128(q_addr + (kk / 4) * P::kQBox + (kk % 4) * 32, 16),
                   desc128(k_addr + (kk / 4) * P::kKVBox + (kk % 4) * 32, 16),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // S = the sum of the two halves' partials (addition commutes, so both
    // warpgroups hold the same S to the bit).
    float* mine = xbuf + ((kt & 1) * 2 + c) * (kKeys512 / 2) * 128;
    const float* other = xbuf + ((kt & 1) * 2 + 1 - c) * (kKeys512 / 2) * 128;
#pragma unroll
    for (int i = 0; i < kKeys512 / 2; ++i) mine[i * 128 + t] = sc[i];
    bar_sync(1, kConsumers512);
#pragma unroll
    for (int i = 0; i < kKeys512 / 2; ++i) {
      sc[i] += other[i * 128 + t];
    }

    float alpha[2];
    softmax_step<kKeys512>(sc, kt * kKeys512, tk, tg, m_run, l_run, alpha);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] *= alpha[(i >> 1) & 1];

    // acc += P V over this half's 256 columns: two 16-key k-steps, each
    // into two 128-column accumulators (V boxes 4c + 2h, 4c + 2h + 1).
    uint32_t pa[kKeys512 / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys512 / 16; ++kk) p_fragment(sc, kk, pa[kk]);
    fence_regs(pa);
    mbar_wait(&v_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys512 / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_rs_n128(acc[h], pa[kk],
                      desc128(v_addr + 2 * h * P::kKVBox + kk * 16 * kRowBytes,
                              P::kKVBox));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(pa);
    mbar_arrive(&kv_empty[s]);
  }

  const int r = q0 + 16 * warp + g;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    store_rows(acc[h], o + (size_t)bh * tq * 512, 512, r, tq, 256 * c + 128 * h,
               tg, l_run);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime's
// entry-point query (so the library needs no link against libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous [bh, t, d] bf16 tensor, boxes of 64 columns
// by `rows` rows of one head, 128-byte swizzled; reads past t are zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int bh, int t, int d,
                     int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxCols, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Maps {
  CUtensorMap q, k, v;
};

cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v,
                      int bh, int tq, int tk, int d, int q_rows, int kv_rows) {
  cudaError_t err = make_map(&m->q, q, bh, tq, d, q_rows);
  if (err == cudaSuccess) err = make_map(&m->k, k, bh, tk, d, kv_rows);
  if (err == cudaSuccess) err = make_map(&m->v, v, bh, tk, d, kv_rows);
  return err;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int bh, int tq, int tk, float scale, cudaStream_t s) {
  constexpr int smem = WsPlan<D>::kSmemBytes;
  static std::atomic<unsigned long long> smem_set{0};
  Maps m;
  cudaError_t err =
      make_maps(&m, q, k, v, bh, tq, tk, D, WsPlan<D>::kRowsQ, kTile);
  if (err == cudaSuccess)
    err = allow_smem_once(flash_fwd_wgmma<D>, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + WsPlan<D>::kRowsQ - 1) / WsPlan<D>::kRowsQ, bh);
  flash_fwd_wgmma<D><<<grid, WsPlan<D>::kThreads, smem, s>>>(
      m.q, m.k, m.v, static_cast<__nv_bfloat16*>(o), tq, tk, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous [B*H, T, D] bf16 device buffers, 16-byte aligned;
// scale = d^-0.5*log2(e). Returns a cudaError_t; 0 means launched.
extern "C" int sdxl_flash_attention_bf16(const void* q, const void* k,
                                         const void* v, void* o, int bh,
                                         int tq, int tk, int d, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_wgmma<64>(q, k, v, o, bh, tq, tk, scale, s);
  if (d == 128) return launch_wgmma<128>(q, k, v, o, bh, tq, tk, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int sdxl_flash_attention_bf16_d512(const void* q, const void* k,
                                              const void* v, void* o, int bh,
                                              int tq, int tk, int d,
                                              float scale, void* stream) {
  if (d != 512) return cudaErrorInvalidValue;
  constexpr int smem = D512Plan::kSmemBytes;
  static std::atomic<unsigned long long> smem_set{0};
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, bh, tq, tk, d, kRows512, kKeys512);
  if (err == cudaSuccess)
    err = allow_smem_once(flash_fwd_d512, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kRows512 - 1) / kRows512, bh);
  flash_fwd_d512<<<grid, kThreads512, smem, static_cast<cudaStream_t>(stream)>>>(
      m.q, m.k, m.v, static_cast<__nv_bfloat16*>(o), tq, tk, scale);
  return cudaGetLastError();
}

// The dynamic shared memory each kernel of this file launches with, by
// head dim (for the build report).
extern "C" int flash_hopper_smem_bytes(int d) {
  return d == 64 ? WsPlan<64>::kSmemBytes
         : d == 128 ? WsPlan<128>::kSmemBytes
         : d == 512 ? D512Plan::kSmemBytes : 0;
}
