// The flash-attention experiments X1 and X2 for Hopper (sm_90a), bound to
// Python with ctypes (sdxl_tpu_torch/scripts/exp_flash_exp2.py and
// exp_flash_floor.py).
//
// Replaces the Pallas TPU kernels of
//   X1: scripts/exp_flash_exp2.py `flash2` -> `_kernel` (call :81): the
//       exp2 flash forward with the scale applied to the f32 logits;
//   X2: scripts/exp_flash_floor.py `attn` -> `make_kernel(mode)` (call
//       :103): timing variants of the same forward that strip parts of the
//       online softmax, to split a call's time: full (X1 itself), qscaled
//       (q pre-scaled and rounded by the wrapper, K1's function), noexp
//       (exp2 replaced by a linear shift; NaN everywhere, as in the
//       reference) and mxu_only (the scaled logits as p, no max, no l).
//
// Both are instances of K1's own kernel, flash_fwd_wgmma.cuh's
// `flash_fwd_wgmma<D, NC, BK, LSE, MODE>` (TMA/mbarrier K/V ring, a
// producer warpgroup handing its registers to NC consumer warpgroups of 64
// query rows, S = Q K^T and P V on wgmma, P from S's accumulator fragment
// in registers), which holds the modes' arithmetic: so X2 splits the time
// of the kernel the main path runs, and X1 sweeps its tile. Bound: 4 *
// B*H*T^2*D tensor-core operations at 989 TFLOP/s, as K1.
//
// X1's tiles (BQ, BK) = (64 NC, BK): NC in {1, 2, 3} consumer warpgroups
// by BK in {64, 128} keys a stage; the reference's 512-4096 VMEM blocks do
// not fit a 227 KB shared memory. (192, 128) is K1's tile, and X2 runs
// there. Inputs are bf16 [B*H, T, 64] with Tq = Tk and the key tile
// dividing T (the wrapper raises otherwise: the reference drops the last
// keys there); a query tile that runs past T is zero-filled by the TMA
// unit and its rows past T are never stored, as in K1.

#include <cuda_runtime.h>

#include "flash_fwd_wgmma.cuh"

using namespace flash_fwd;

// q, k, v, o: contiguous bf16 [B*H, T, D] device buffers with D = 64, Tq =
// Tk and T divisible by the key tile; scale = d^-0.5 * log2(e) (ignored by
// qscaled, whose q arrives pre-scaled). Returns a cudaError_t; 0 means
// launched.
#define SDXL_EXP_EXPORT(name, NC, BK, MODE)                                  \
  extern "C" int name(const void* q, const void* k, const void* v, void* o,  \
                      int bh, int tq, int tk, int d, float scale,            \
                      void* stream) {                                        \
    if (d != 64 || tq != tk || tk % BK) return cudaErrorInvalidValue;        \
    return launch_fwd_wgmma<64, NC, BK, false, MODE>(                        \
        q, k, v, o, nullptr, bh, tq, tk, scale,                              \
        static_cast<cudaStream_t>(stream));                                  \
  }
// X1, one export per tile (BQ = 64 NC)
SDXL_EXP_EXPORT(sdxl_flash2_bf16_q64_k64, 1, 64, kFull)
SDXL_EXP_EXPORT(sdxl_flash2_bf16_q64_k128, 1, 128, kFull)
SDXL_EXP_EXPORT(sdxl_flash2_bf16_q128_k64, 2, 64, kFull)
SDXL_EXP_EXPORT(sdxl_flash2_bf16_q128_k128, 2, 128, kFull)
SDXL_EXP_EXPORT(sdxl_flash2_bf16_q192_k64, 3, 64, kFull)
SDXL_EXP_EXPORT(sdxl_flash2_bf16_q192_k128, 3, 128, kFull)
// X2, one export per mode at K1's tile (full shares X1's instance)
SDXL_EXP_EXPORT(sdxl_flash_floor_full_bf16, 3, 128, kFull)
SDXL_EXP_EXPORT(sdxl_flash_floor_qscaled_bf16, 3, 128, kQScaled)
SDXL_EXP_EXPORT(sdxl_flash_floor_noexp_bf16, 3, 128, kNoExp)
SDXL_EXP_EXPORT(sdxl_flash_floor_mxu_only_bf16, 3, 128, kMxuOnly)

// The dynamic shared memory an instance of this file launches with (for
// the build report), by its kernel index (0, flash_fwd_wgmma, the only
// one) and its leading int template arguments; 0 for any other.
extern "C" int flash_experiments_smem_bytes(int kernel, int d, int nc,
                                            int bk) {
  return kernel == 0 ? fwd_smem_bytes(d, nc, bk) : 0;
}
