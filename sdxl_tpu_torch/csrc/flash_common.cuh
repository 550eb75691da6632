// Helpers shared by the flash-attention kernels (flash_hopper.cu,
// flash_hopper_bwd.cu, flash_attention.cu, flash_attention_bwd.cu,
// flash_experiments.cu, flash_pipelined.cu): bf16 packing, 32-bit
// shared-memory loads of mma fragments, the m16n8k16 bf16 mma.sync,
// cp.async and ldmatrix, and the one-time opt-in to more than 48 KB of
// dynamic shared memory.
//
// mma.sync.m16n8k16 fragment layout (g = lane / 4, tg = lane % 4):
//   A (16x16, row-major): a0 = A[g][2tg..+1],   a1 = A[g+8][2tg..+1],
//                         a2 = A[g][2tg+8..+9], a3 = A[g+8][2tg+8..+9]
//   B (16x8, col-major):  b0 = B[2tg..+1][g],   b1 = B[2tg+8..+9][g]
//   C (16x8):             c0,c1 = C[g][2tg..+1], c2,c3 = C[g+8][2tg..+1]
// so the C fragments of two adjacent 8-column tiles, rounded to bf16, are
// exactly the A fragment of one 16-deep k-step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace flash {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D[16x8] += A[16x16] * B[16x8]; bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Asynchronous 16-byte copy from device memory to shared memory (cp.async,
// bypassing L1), and its commit and wait groups: wait<N> returns once at
// most N of this thread's committed groups are still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory, each transposed: lane l gives
// the address of row l % 8 of matrix l / 8, and r[i] receives matrix i's
// elements [2 tg][g] and [2 tg + 1][g]. On a row-major [key][d] V tile this
// is the B fragment of P V (b0 = keys 0-7, b1 = keys 8-15 of a 16-key step).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Opting a kernel in to more than 48 KB of dynamic shared memory is a
// setting of the kernel on the current device: made once per device (one
// bit of *done each), not on every launch.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, int smem,
                            std::atomic<unsigned long long>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done->load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done->fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace flash
