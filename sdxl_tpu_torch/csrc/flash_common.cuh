// Helpers shared by the flash-attention kernels (flash_hopper.cu, whose f32
// d 64 and 128 forwards run on 3xTF32 wgmma and TMA, flash_hopper_bwd.cu,
// and through flash_fwd_wgmma.cuh flash_experiments.cu and
// flash_pipelined.cu; no kernel of the port runs on the FMA pipes, and
// flash_attention.cu is gone): bf16 packing, the cp.async groups, and the
// one-time opt-in to more than 48 KB of dynamic shared memory.

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

// The commit and wait groups of cp.async (asynchronous copies from device
// memory to shared memory): wait<N> returns once at most N of this
// thread's committed groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
