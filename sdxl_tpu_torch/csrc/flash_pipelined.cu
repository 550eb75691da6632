// The software-pipelined flash-attention experiment X3 for Hopper
// (sm_90a), bound to Python with ctypes
// (sdxl_tpu_torch/scripts/exp_flash_pipelined.py).
//
// Replaces the Pallas TPU kernel of scripts/exp_flash_pipelined.py
// `flash_pipelined` -> `_kernel` (call :104): K1's function on T that the
// tile divides. q arrives pre-scaled by d^-0.5 * log2(e) and rounded to
// bf16 (the wrapper does it, as the reference does outside its kernel,
// :100); base-2 online softmax with f32 m, l and acc; p rounded to bf16
// before P V; the output acc / l in bf16.
//
// Bound. 4*B*H*T^2*D tensor-core operations at 989 TFLOP/s, as K1.
//
// The TPU design ping-pongs the f32 logits tile between two VMEM buffers
// and lags V's block index one grid step behind K's, so the next block's
// QK product on the MXU overlaps this block's softmax on the VPU. X3 is an
// instance of K1's own kernel, flash_fwd_wgmma.cuh's `flash_fwd_wgmma<64,
// NC, BK, false, kQScaled, kX3Stages>` (TMA/mbarrier K/V ring, a producer
// warpgroup, consumer warpgroups of 64 query rows, S = Q K^T by SS wgmma,
// P V by RS wgmma with P from S's accumulator fragment), with the
// pipelined schedule the header's PIPE selects: each consumer warpgroup
// issues the QK product of key tile j+1 into a second S fragment before
// tile j's softmax and P V, and waits for it only after issuing P V, so
// both products run under the softmax (FlashAttention-3's intra-warpgroup
// overlap); K and V stages are freed apart, each refilled by its own
// producer thread. So X3 measures that overlap in the code the main path
// runs: the same tile as X1, without the logits' scale, is K1's schedule.
//
// Tiles (BQ, BK) = (64 NC, BK), NC in {1, 2} consumer warpgroups by BK in
// {64, 128} keys a stage; both must divide T (the wrapper raises
// otherwise: the reference leaves the last query rows unwritten and drops
// the last keys there). One consumer hands registers over (24 / 232) so
// that two blocks share an SM; two take K1's 40 / 232.
//
// CPU tests (the wrapper's plain version against the reference, and these
// exports' tiles and template arguments read from this file):
//   pytest tests/test_torch_flash_experiments.py
// On the card: python -m sdxl_tpu_torch.scripts.exp_flash_pipelined (X3
// against K1), python -m sdxl_tpu_torch.scripts.probe_pipelined_kernels
// (against its tiles on K1's schedule and a three-stage ring), or
// chip_smoke.py (phase 2 reads the SASS, phase 3b checks and times it).

#include <cuda_runtime.h>

#include "flash_fwd_wgmma.cuh"

using namespace flash_fwd;

// Stages of X3's K/V ring: with K and V freed apart, K of tile j + 2 is
// loaded once S_j is done, a tile ahead of its use, in K1's two stages.
constexpr int kX3Stages = 2;

// q (pre-scaled), k, v, o: contiguous bf16 [B*H, T, D] device buffers with
// D = 64, Tq = Tk and T divisible by both tiles; scale is unused (q
// carries it). Returns a cudaError_t; 0 means the kernel was launched.
#define SDXL_PIPELINED_EXPORT(name, NC, BK)                                  \
  extern "C" int name(const void* q, const void* k, const void* v, void* o,  \
                      int bh, int tq, int tk, int d, float scale,            \
                      void* stream) {                                        \
    if (d != 64 || tq != tk || tq % (64 * NC) || tk % BK)                    \
      return cudaErrorInvalidValue;                                          \
    return launch_fwd_wgmma<64, NC, BK, false, kQScaled, kX3Stages>(         \
        q, k, v, o, nullptr, bh, tq, tk, scale,                              \
        static_cast<cudaStream_t>(stream));                                  \
  }
SDXL_PIPELINED_EXPORT(sdxl_flash_pipelined_bf16_q64_k64, 1, 64)
SDXL_PIPELINED_EXPORT(sdxl_flash_pipelined_bf16_q64_k128, 1, 128)
SDXL_PIPELINED_EXPORT(sdxl_flash_pipelined_bf16_q128_k64, 2, 64)
SDXL_PIPELINED_EXPORT(sdxl_flash_pipelined_bf16_q128_k128, 2, 128)

// The dynamic shared memory an instance of this file launches with (for
// the build report), by its kernel index (0, flash_fwd_wgmma, the only
// one) and its leading int template arguments; 0 for any other.
extern "C" int flash_pipelined_smem_bytes(int kernel, int d, int nc,
                                          int bk) {
  return kernel == 0 ? fwd_smem_bytes<kX3Stages>(d, nc, bk) : 0;
}

template <int NC, int BK>
int blocks_per_sm() {
  using P = FwdPlan<64, NC, BK, kX3Stages>;
  const auto kernel = flash_fwd_wgmma<64, NC, BK, false, kQScaled, kX3Stages>;
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, P::kThreads, P::kSmemBytes);
  return err == cudaSuccess ? n : -1;
}

// Blocks of the (64 NC, BK) tile an SM holds at once on the current device
// (registers at launch, shared memory, threads), by the runtime's
// occupancy calculator; 0 for a tile not built, -1 on a CUDA error.
extern "C" int flash_pipelined_blocks_per_sm(int nc, int bk) {
  if (nc == 1) return bk == 64 ? blocks_per_sm<1, 64>()
                    : bk == 128 ? blocks_per_sm<1, 128>() : 0;
  if (nc == 2) return bk == 64 ? blocks_per_sm<2, 64>()
                    : bk == 128 ? blocks_per_sm<2, 128>() : 0;
  return 0;
}
