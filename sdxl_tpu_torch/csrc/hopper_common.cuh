// Hopper's own machinery for the hand-written attention kernels (sm_90a),
// shared by flash_hopper.cu and flash_fwd_wgmma.cuh (the forwards, and
// through the latter flash_experiments.cu) and flash_hopper_bwd.cu (the
// backward): mbarriers, TMA loads into 128-byte-swizzled boxes, wgmma and
// its shared-memory descriptors, setmaxnreg, the SFU's exp2, the f32
// routes' TF32 split and its pre-pass, and on the host the encoding of the
// tensor maps the TMA unit reads.
//
// The layout every kernel uses: a [rows, d] bf16 tile is a row of boxes of
// 64 columns (128 bytes, one swizzle row) by `rows` rows, 128-byte
// swizzled, each box starting on a 1024-byte boundary. wgmma reads such a
// box K-major (d is the contracted axis: Q, K for S = Q K^T) or MN-major
// with the transpose bit (rows are the contracted axis: V for P V).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace hopper {

constexpr int kBoxCols = 64;          // bf16 columns in a 128-byte swizzle box
constexpr int kRowBytes = 128;        // one box row
constexpr int kBoxF32 = 32;           // f32 columns in a box

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

// The same for a 64-byte-swizzled K-major operand (rows of 64 bytes, the
// f32 d = 128 backward's transposed copies of 16 tokens): 8-row groups
// 512 bytes apart, layout 64B.
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// D[64x64] (+)= A[64x16] B[16x64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SDXL_F16(0), SDXL_F16(16)
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

// D[64x64] (+)= A[64x8] B[8x64] in TF32: A and B K-major in shared memory
// (32-bit operands have no transpose).
__device__ __forceinline__ void wgmma_ss_tf32_n64(float (&d)[32], uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31},"
      " %32, %33, p, 1, 1;\n}\n"
      : SDXL_F16(0), SDXL_F16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64x32] (+)= A[64x8] B[8x32] in TF32: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_tf32_n32(float (&d)[16], uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1;\n}\n"
      : SDXL_F16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64x16] (+)= A[64x8] B[8x16] in TF32: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_tf32_n16(float (&d)[8], uint64_t a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1;\n}\n"
      : SDXL_F4(0), SDXL_F4(4)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64x64] (+)= A[64x8] B[8x64] in TF32: A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_tf32_n64(float (&d)[32],
                                                  const uint32_t a[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SDXL_F16(0), SDXL_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64x128] (+)= A[64x8] B[8x128] in TF32: A in registers, B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_tf32_n128(float (&d)[64],
                                                   const uint32_t a[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : SDXL_F16(0), SDXL_F16(16), SDXL_F16(32), SDXL_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef SDXL_F16
#undef SDXL_F4

// The dynamic shared memory from its first 1024-byte boundary (a
// 128-byte-swizzled tile must start on one).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
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

// ---------------------------------------------------------------------------
// The f32 routes' TF32 arithmetic (3xTF32)
// ---------------------------------------------------------------------------
//
// One TF32 product keeps 10 mantissa bits of each operand. The f32 routes
// split each operand x into x_hi = rna(x) and x_lo = rna(x - x_hi), both
// TF32, and take a b as a_hi b_lo + a_lo b_hi + a_hi b_hi summed in f32:
// about 2^-21 of each product is lost, near f32's own 2^-24
// (tests/torch_tf32.py emulates this on the CPU).
//
// wgmma takes 32-bit operands only K-major, and a product whose A operand
// is an accumulator fragment (P V in the forward, dz K, p^T dO and dz^T qf
// in the backward) contracts over tokens: its B operand is a transposed
// copy, tokens contiguous. S's f32 accumulator fragment holds tokens (2tg,
// 2tg + 1) of each group of 8 for rows g and g + 8, while the TF32
// A-register fragment of a k8 step holds k-columns tg and tg + 4 (CUTLASS
// ALayout_64x8). So the transposed copy stores each group of 8 tokens
// permuted: position c holds token perm8(c), and the A fragment of k-step
// j is {s[4j], s[4j + 2], s[4j + 1], s[4j + 3]}, with no shuffle.

// x rounded to TF32 (10 mantissa bits; to nearest, ties away from zero),
// as an f32 whose low 13 bits are zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return __uint_as_float(y & 0xffffe000u);
}

// x = hi + lo, both TF32: hi = rna(x), lo = rna(x - hi).
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// Position c of each group of 8 tokens in a transposed copy holds token
// perm8(c): tokens 2c and 2c + 1 of an accumulator fragment become
// k-columns c and c + 4 of the TF32 A fragment.
__device__ __forceinline__ int perm8(int c) {
  return c < 4 ? 2 * c : 2 * c - 7;
}

// Element e of k-step j's TF32 A fragment, as an index into the f32
// accumulator fragment it comes from (perm8's order).
__device__ __forceinline__ constexpr int a_frag_index(int j, int e) {
  return 4 * j + (e >> 1) + 2 * (e & 1);
}

// The pre-pass of the f32 routes: a job splits one tensor x [n, t, D] f32
// (D = 64, or 128 for the f32 d = 128 backward) into hi and lo parts,
// written (hl set) as hl = [2, n, t, D] (all of x_hi, then all of x_lo)
// and (thl set) transposed as thl = [2, n, D, tp] with each group of 8
// tokens in perm8's order and zeros at tokens t .. tp - 1 (tp = t rounded
// up to 8; the scratch it writes is never assumed zero).
struct SplitJob {
  const float* x;
  float* hl;
  float* thl;
  int t, tp;
};
constexpr int kSplitJobs = 4;
constexpr int kSplitTokens = 64;  // tokens a block
struct SplitJobs {
  SplitJob job[kSplitJobs];
  int n;
};

// One block a (64-token tile, b*h, job).
template <int D = 64>
__global__ void __launch_bounds__(256)
split_tf32_pass(const __grid_constant__ SplitJobs jobs) {
  const SplitJob& j = jobs.job[blockIdx.z];
  const int t0 = blockIdx.x * kSplitTokens;
  if (t0 >= (j.thl ? j.tp : j.t)) return;
  __shared__ float tile[kSplitTokens][D + 1];  // x rows [token][d], padded
  const size_t base = (size_t)blockIdx.y * j.t * D;
  const size_t half = (size_t)jobs.n * j.t * D;
  for (int i = threadIdx.x; i < kSplitTokens * (D / 4); i += 256) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < j.t) {
      const size_t off = base + (size_t)(t0 + r) * D + c;
      x = *reinterpret_cast<const float4*>(j.x + off);
      if (j.hl) {
        float4 hi, lo;
        split_tf32(x.x, hi.x, lo.x);
        split_tf32(x.y, hi.y, lo.y);
        split_tf32(x.z, hi.z, lo.z);
        split_tf32(x.w, hi.w, lo.w);
        *reinterpret_cast<float4*>(j.hl + off) = hi;
        *reinterpret_cast<float4*>(j.hl + half + off) = lo;
      }
    }
    tile[r][c] = x.x;
    tile[r][c + 1] = x.y;
    tile[r][c + 2] = x.z;
    tile[r][c + 3] = x.w;
  }
  if (!j.thl) return;
  __syncthreads();
  const size_t tbase = (size_t)blockIdx.y * D * j.tp;
  const size_t thalf = (size_t)jobs.n * D * j.tp;
  for (int i = threadIdx.x; i < D * kSplitTokens; i += 256) {
    const int d = i / kSplitTokens, p = i % kSplitTokens;
    if (t0 + p >= j.tp) continue;
    float hi, lo;
    split_tf32(tile[(p & ~7) + perm8(p & 7)][d], hi, lo);
    const size_t off = tbase + (size_t)d * j.tp + t0 + p;
    j.thl[off] = hi;
    j.thl[thalf + off] = lo;
  }
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
inline EncodeTiled encode_tiled() {
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

// A 3-D map over a contiguous [n2, n1, n0] bf16 or f32 tensor (n0
// innermost), boxes of one row segment of `row_bytes` (128: 64 bf16 or 32
// f32, 128-byte swizzled; 64: 16 f32, 64-byte swizzled) by `rows` rows of
// one [n1, n0] slice; reads past n1 or n0 are zeros.
inline cudaError_t make_map(CUtensorMap* map, const void* base, bool f32,
                            int n2, int n1, int n0, int rows,
                            int row_bytes = kRowBytes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elem = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {n0 * elem, (cuuint64_t)n1 * n0 * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(row_bytes / elem), (cuuint32_t)rows,
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The pre-pass over `count` jobs of n = b*h heads each, on stream s.
template <int D = 64>
inline cudaError_t launch_split_tf32(SplitJobs jobs, int count, int n,
                              cudaStream_t s) {
  int tokens = 0;
  for (int i = 0; i < count; ++i)
    tokens = std::max(tokens, jobs.job[i].thl ? jobs.job[i].tp : jobs.job[i].t);
  jobs.n = n;
  split_tf32_pass<D><<<dim3((tokens + kSplitTokens - 1) / kSplitTokens, n,
                            count),
                       256, 0, s>>>(jobs);
  return cudaGetLastError();
}

}  // namespace hopper
