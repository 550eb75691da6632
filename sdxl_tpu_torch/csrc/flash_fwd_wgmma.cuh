// The bf16 flash forward on Hopper's own machinery (sm_90a), shared by K1
// and K2 (flash_hopper.cu) and by the experiments X1 and X2
// (flash_experiments.cu) and X3 (flash_pipelined.cu), so that the
// experiments time K1's own code: `flash_fwd_wgmma<D, NC, BK, LSE, MODE,
// PIPE>` and its launcher, with the online-softmax helpers the f32
// forwards of flash_hopper.cu use too.
//
// Unmasked softmax(q k^T / sqrt(d)) v over bf16 [B*H, T, D], D = 64 or 128,
// with the reference's numerics (sdxl_tpu/ops/flash_attention.py):
//   - the online softmax runs in base 2 with f32 logits, running max m,
//     normaliser l and accumulator (exp2 flushes results below 2^-126 to
//     zero, as the TPU's f32 does); p is rounded to bf16 before P V while
//     l sums the f32 p;
//   - the output is acc / l rounded to bf16.
// Where the scale d^-0.5 * log2(e) goes is MODE's:
//   kPrescaleQ  q is multiplied by it in f32 and rounded to bf16 before
//               any product (flash_attention.py:185): K1 and K2;
//   kFull       the f32 logits are multiplied by it after each Q K^T
//               (X1, scripts/exp_flash_exp2.py; X2 `full`);
//   kQScaled    q arrives pre-scaled and rounded (the wrapper does it), the
//               kernel scales nothing (X2 `qscaled`: K1's function);
// and two of X2's timing variants (scripts/exp_flash_floor.py) strip the
// softmax, with the logits scaled as kFull:
//   kNoExp      p = (s - m_new) * 0.01 + 0.5 and alpha likewise, in place
//               of exp2. m starts at -inf, so the first tile gives alpha =
//               -inf, l = -inf * 0 and acc = 0 * -inf: the output is NaN
//               everywhere, as the reference's is;
//   kMxuOnly    p = the scaled logits rounded to bf16, no max and no l
//               (l is held at 4096, so the store gives acc * (1 / 4096)).
// Ragged token counts: the tensor maps are 3-D over [B*H, T, D], so a tile
// that runs past T is zero-filled by the TMA unit and never reads the next
// head's rows; keys >= tk still get a -inf logit (a zero key would give
// logit 0), and query rows >= tq are never stored.
//
// Bound: 4*B*H*T^2*D tensor-core operations against 8 bytes of q/k/v/o per
// element, far above the card's ~295 FLOP/byte ridge, so the bound is the
// bf16 tensor-core rate (989 TFLOP/s). The loads cost the consumers
// nothing: one thread of the producer warpgroup keeps TMA copies of K and
// V tiles in flight in a two-stage ring, and the consumers wait on the
// stage's mbarrier. No operand is transposed or copied by a thread: S = Q
// K^T reads Q and K from shared memory (both K-major), and P V takes P
// from registers (the f32 accumulator fragment of S rounded to bf16 is the
// A-register fragment of the next product, as FlashAttention-3 uses it)
// and V from shared memory as an MN-major B operand (transpose-B). Each
// consumer warpgroup runs S, softmax and P V in turn; the other
// warpgroups' products fill the tensor cores meanwhile, so more consumers
// hide more of the softmax. The rows' max and sum run as four partial
// chains each. Where K1's time goes (X2 at K1's tile, [2,10,4096,64] on an
// H100; PERF.md): without the softmax (kMxuOnly) a call takes 58% of
// kFull's time, without exp2 (kNoExp) 95%; one FMUL an element (kFull's
// scale of the logits, which kPrescaleQ moves onto q) costs 12%. So the
// softmax's FP32 instructions, not the SFU or the TMA ring, are what the
// tensor cores wait for.
//
// PIPE picks the key loop's schedule. 0 (K1, K2, X1, X2): S, softmax and
// P V of a tile in turn, each product waited for at once, a two-stage
// ring whose stage is freed by one arrival after P V. n >= 2 (X3): the
// schedule of scripts/exp_flash_pipelined.py, where the QK product of the
// next key tile overlaps this tile's softmax; in a consumer warpgroup
// (FlashAttention-3's intra-warpgroup overlap), for tile j:
//   1. issue S_{j+1} = Q K_{j+1}^T into a second S fragment, commit;
//   2. the softmax of S_j, while S_{j+1} and P_{j-1} V_{j-1} run;
//   3. wait<1> (groups retire in order: P_{j-1} V_{j-1} is done, S_{j+1}
//      may run), free V_{j-1}'s stage, rescale acc, form P_j;
//   4. issue acc += P_j V_j, commit; wait<1>: S_{j+1} is done, free
//      K_{j+1}'s stage, while P_j V_j runs on into the next softmax.
// So the tensor cores have both products of a tile queued under each
// softmax, where K1's consumer leaves them to the other warpgroups. The
// ring has n stages, and K and V are freed apart (K of tile j when S_j
// is done, V after P_j V_j), each refilled by its own producer thread: K
// is read a tile ahead of V, and a joint release would hold K_{j+2} until
// P_j V_j is done, after S_{j+2} is wanted. The two S fragments cost BK/2
// registers more a thread, so the one-consumer tile hands registers
// over too (24 / 232, two blocks an SM, as X1's 64-row tile runs).
//
// Tiles: NC consumer warpgroups of 64 query rows (64 NC rows a block) and
// BK keys a stage (64 or 128). One block a (q-tile, b*h) tile. Shared
// memory: Q 8 KB a consumer a 64-column box, two K/V stages of 2 x BK x 128
// bytes a box, all in 128-byte-swizzled boxes of 64 columns, so a d=128
// row spans two boxes and the descriptors step from one to the other.
// Registers: with two or three consumers the producer hands its registers
// to them (setmaxnreg: 24 / 160 at NC = 3, 40 / 232 at NC = 2, which fill
// but do not pass 65,536 an SM); one consumer needs no hand-over (256
// threads at up to 255 registers fit). The kPrescaleQ pre-scale is an
// elementwise pass over the consumer's own Q rows in shared memory after
// the TMA load (the swizzle only permutes 16-byte chunks), followed by a
// proxy fence so that wgmma's async-proxy reads see it. With LSE (K2) one
// lane of each quad stores m + log2(l) of its two rows after the last
// tile: the split max and sum chains are already combined across the quad
// inside each softmax step, as the final 1/l needs them.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace flash_fwd {

using namespace hopper;
using flash::allow_smem_once;
using flash::pack_bf16;

// Where the scale goes, and which of X2's variants (see the top).
enum Mode {
  kPrescaleQ = 0,
  kFull = 1,
  kQScaled = 2,
  kNoExp = 3,
  kMxuOnly = 4,
};

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

// p from a logit less the row's new max: exp2, or (X2's noexp) the linear
// stand-in (x * 0.01 + 0.5).
template <bool EXP>
__device__ __forceinline__ float softmax_p(float x) {
  if constexpr (EXP) {
    return exp2_ftz(x);
  } else {
    return x * 0.01f + 0.5f;
  }
}

// Online-softmax step on one warpgroup's S fragment (f32, base 2) of NK
// keys: rows g and g + 8 of the warp's 16, s[4j + e] at key 8j + 2tg + (e &
// 1). Masks keys >= tk, updates m and l, turns s into the unrounded p and
// returns each row's rescale of the accumulator in alpha (EXP false: X2's
// noexp, p and alpha linear in place of exp2).
template <int NK, bool EXP = true>
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
    alpha[r] = softmax_p<EXP>(m[r] - m_new[r]);
    m[r] = m_new[r];
  }
  float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = softmax_p<EXP>(s[4 * j + e] - m_new[e >> 1]);
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

// Rows (r, r + 8)'s base-2 log-sum-exp m + log2(l), stored by one lane of
// the quad (m and l are already the whole row's there); rows >= tq skipped.
__device__ __forceinline__ void store_lse(float* lse, int r, int tq, int tg,
                                          const float (&m)[2],
                                          const float (&l)[2]) {
  if (tg != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (r + 8 * h < tq) lse[r + 8 * h] = m[h] + log2f(l[h]);
}

constexpr int kStages = 2;  // K/V stages in K1's ring

template <int D, int NC, int BK, int PIPE = 0>
struct FwdPlan {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static_assert(NC >= 1 && NC <= 3, "one to three consumer warpgroups");
  static_assert(BK == 64 || BK == 128, "64 or 128 keys a stage");
  static_assert(PIPE == 0 || PIPE >= 2, "a pipelined ring of 2+ stages");
  static constexpr bool kPipelined = PIPE > 0;
  static constexpr int kRing = kPipelined ? PIPE : kStages;  // K/V stages
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kConsumers = 128 * NC;
  static constexpr int kRowsQ = 64 * NC;       // query rows a tile
  static constexpr int kBoxes = D / kBoxCols;  // 64-column boxes a row
  static constexpr int kQBox = kRowsQ * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kBoxBytes = BK * kRowBytes;  // a K or V box
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kKV = kQBytes;  // stage s: K, then V
  static constexpr int kBars = kKV + 2 * kRing * kTileBytes;
  // q_full, then k_full, v_full and kv_empty for each stage (pipelined:
  // kv_empty frees K only, and v_empty follows)
  static constexpr int kSmemBytes =
      kBars + 8 * (1 + (kPipelined ? 4 : 3) * kRing) + 1024;
  // blocks an SM the registers are planned for: two for the pipelined
  // one-consumer tile, whose two S fragments pass 128 registers a thread
  static constexpr int kMinBlocks = kPipelined && NC == 1 ? 2 : 1;
  // registers a thread after the hand-over (K1's NC = 1: none)
  static constexpr bool kHandOver = NC > 1 || kMinBlocks > 1;
  static constexpr int kProducerRegs = NC == 3 || kMinBlocks > 1 ? 24 : 40;
  static constexpr int kConsumerRegs = NC == 3 ? 160 : 232;
  static_assert(!kHandOver || 128 * (kProducerRegs + NC * kConsumerRegs) *
                                      kMinBlocks <= 65536,
                "the hand-over passes an SM's registers");
};

// FwdPlan<D, NC, BK, PIPE>::kSmemBytes at run time (for the build
// report); 0 for a D, NC or BK the kernel does not take.
template <int D, int NC, int PIPE>
inline int fwd_smem_bytes(int bk) {
  return bk == 64 ? FwdPlan<D, NC, 64, PIPE>::kSmemBytes
       : bk == 128 ? FwdPlan<D, NC, 128, PIPE>::kSmemBytes : 0;
}
template <int D, int PIPE>
inline int fwd_smem_bytes(int nc, int bk) {
  return nc == 1 ? fwd_smem_bytes<D, 1, PIPE>(bk)
       : nc == 2 ? fwd_smem_bytes<D, 2, PIPE>(bk)
       : nc == 3 ? fwd_smem_bytes<D, 3, PIPE>(bk) : 0;
}
template <int PIPE = 0>
inline int fwd_smem_bytes(int d, int nc, int bk) {
  return d == 64 ? fwd_smem_bytes<64, PIPE>(nc, bk)
       : d == 128 ? fwd_smem_bytes<128, PIPE>(nc, bk) : 0;
}

// S = Q K^T of key tile kt (D / 16 k-steps, four to a 64-column box) into
// s, issued on the tile's stage once it has landed and committed as one
// group; not waited for.
template <int D, int BK, class P>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_addr,
                                        unsigned char* kv, uint64_t* k_full,
                                        int kt) {
  const int st = kt % P::kRing;
  const uint32_t k_addr = smem_u32(kv + 2 * st * P::kTileBytes);
  mbar_wait(&k_full[st], (kt / P::kRing) & 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t qd = desc128(q_addr + (kk / 4) * P::kQBox + off, 16);
    const uint64_t kd = desc128(k_addr + (kk / 4) * P::kBoxBytes + off, 16);
    if constexpr (BK == 128) {
      wgmma_ss_n128(s, qd, kd, kk > 0);
    } else {
      wgmma_ss_n64(s, qd, kd, kk > 0);
    }
  }
  wgmma_commit();
}

// acc += P V of key tile kt (BK / 16 k-steps of 16 keys, 2048 bytes apart
// in the V tile), issued once the tile's V has landed and committed as
// one group; not waited for.
template <int D, int BK, class P>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pa)[BK / 16][4],
                                         unsigned char* kv, uint64_t* v_full,
                                         int kt) {
  const int st = kt % P::kRing;
  const uint32_t v_addr = smem_u32(kv + (2 * st + 1) * P::kTileBytes);
  mbar_wait(&v_full[st], (kt / P::kRing) & 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t vd = desc128(v_addr + kk * 16 * kRowBytes, P::kBoxBytes);
    if constexpr (D == 64) {
      wgmma_rs_n64(acc, pa[kk], vd);
    } else {
      wgmma_rs_n128(acc, pa[kk], vd);
    }
  }
  wgmma_commit();
}

// One key tile kt of the pipelined schedule (PIPE >= 2; steps 1-4 at the
// top). On entry S_kt is done and in `cur`, and P V of tile kt - 1 may be
// in flight; NEXT: tile kt + 1 exists, and its S goes into `nxt`.
template <int D, int BK, class P, bool NEXT>
__device__ __forceinline__ void pipelined_step(
    float (&cur)[BK / 2], float (&nxt)[BK / 2], float (&acc)[D / 2],
    uint32_t (&pa)[BK / 16][4], float (&m)[2], float (&l)[2],
    uint32_t q_addr, unsigned char* kv, uint64_t* k_full, uint64_t* v_full,
    uint64_t* k_empty, uint64_t* v_empty, int kt, int tk, int tg) {
  if constexpr (NEXT) issue_s<D, BK, P>(nxt, q_addr, kv, k_full, kt + 1);
  float alpha[2];
  softmax_step<BK>(cur, kt * BK, tk, tg, m, l, alpha);
  if constexpr (NEXT) {
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_regs(acc);
  fence_regs(pa);
  if (kt > 0) mbar_arrive(&v_empty[(kt - 1) % P::kRing]);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) p_fragment(cur, kk, pa[kk]);
  fence_regs(pa);
  issue_pv<D, BK, P>(acc, pa, kv, v_full, kt);
  if constexpr (NEXT) {
    wgmma_wait<1>();  // S_{kt+1} is done; P_kt V_kt runs on
    fence_regs(nxt);
    mbar_arrive(&k_empty[(kt + 1) % P::kRing]);
  }
}

// One block a (b*h, q-tile) tile; with LSE also lse ([B*H, tq] f32).
template <int D, int NC, int BK, bool LSE, int MODE, int PIPE = 0>
__global__ void __launch_bounds__(FwdPlan<D, NC, BK, PIPE>::kThreads,
                                  FwdPlan<D, NC, BK, PIPE>::kMinBlocks)
flash_fwd_wgmma(__grid_constant__ const CUtensorMap q_map,
                __grid_constant__ const CUtensorMap k_map,
                __grid_constant__ const CUtensorMap v_map,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int tq, int tk, float scale) {
  using P = FwdPlan<D, NC, BK, PIPE>;
  static_assert(!P::kPipelined || MODE == kPrescaleQ || MODE == kQScaled,
                "the pipelined schedule computes K1's function");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + P::kRing;
  uint64_t* kv_empty = v_full + P::kRing;
  uint64_t* v_empty = kv_empty + P::kRing;  // pipelined only

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * P::kRowsQ, h = blockIdx.y;
  const int n_kt = (tk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < P::kRing; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], P::kConsumers);
      if constexpr (P::kPipelined) mbar_init(&v_empty[s], P::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread starts every copy (pipelined: two)
    if constexpr (P::kHandOver) setmaxnreg_dec<P::kProducerRegs>();
    if constexpr (P::kPipelined) {
      // Q and each K tile from thread 0, each V tile from thread 32 (the
      // next warp), each waiting only for its own half of the stage
      const bool is_v = threadIdx.x == 32;
      if (threadIdx.x == 0 || is_v) {
        if (!is_v) {
          mbar_expect_tx(q_full, P::kQBytes);
          for (int b = 0; b < P::kBoxes; ++b)
            tma_load(smem + b * P::kQBox, &q_map, q_full, b * kBoxCols, q0,
                     h);
        }
        const CUtensorMap* map = is_v ? &v_map : &k_map;
        uint64_t* full = is_v ? v_full : k_full;
        uint64_t* empty = is_v ? v_empty : kv_empty;
        for (int kt = 0; kt < n_kt; ++kt) {
          const int s = kt % P::kRing;
          mbar_wait(&empty[s], ((kt / P::kRing) & 1) ^ 1);
          unsigned char* dst =
              smem + P::kKV + (2 * s + (is_v ? 1 : 0)) * P::kTileBytes;
          mbar_expect_tx(&full[s], P::kTileBytes);
          for (int b = 0; b < P::kBoxes; ++b)
            tma_load(dst + b * P::kBoxBytes, map, &full[s], b * kBoxCols,
                     kt * BK, h);
        }
      }
    } else if (threadIdx.x == 0) {
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
                   kt * BK, h);
        mbar_expect_tx(&v_full[s], P::kTileBytes);
        for (int b = 0; b < P::kBoxes; ++b)
          tma_load(sk + P::kTileBytes + b * P::kBoxBytes, &v_map, &v_full[s],
                   b * kBoxCols, kt * BK, h);
      }
    }
    return;
  }

  if constexpr (P::kHandOver) setmaxnreg_inc<P::kConsumerRegs>();
  const int c = wg - 1;  // this warpgroup's rows: 64c .. 64c + 63
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const uint32_t q_addr = smem_u32(smem) + c * 64 * kRowBytes;

  mbar_wait(q_full, 0);
  if constexpr (MODE == kPrescaleQ) {
    for (int b = 0; b < P::kBoxes; ++b)
      prescale(smem + b * P::kQBox + c * 64 * kRowBytes, 64 * kRowBytes,
               scale, t, 128);
    fence_proxy_async();
    bar_sync(1 + c, 128);
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  if constexpr (MODE == kMxuOnly) l_run[0] = l_run[1] = 4096.f;

  unsigned char* kv = smem + P::kKV;  // the K/V ring
  if constexpr (P::kPipelined) {
    // S fragments s0 and s1 take turns, the loop unrolled by two so that
    // they stay in their registers
    float s0[BK / 2], s1[BK / 2];
    uint32_t pa[BK / 16][4];
    issue_s<D, BK, P>(s0, q_addr, kv, k_full, 0);
    wgmma_wait<0>();
    fence_regs(s0);
    mbar_arrive(&kv_empty[0]);
    int kt = 0;
    for (; kt + 2 < n_kt; kt += 2) {
      pipelined_step<D, BK, P, true>(s0, s1, acc, pa, m_run, l_run, q_addr,
                                     kv, k_full, v_full, kv_empty, v_empty,
                                     kt, tk, tg);
      pipelined_step<D, BK, P, true>(s1, s0, acc, pa, m_run, l_run, q_addr,
                                     kv, k_full, v_full, kv_empty, v_empty,
                                     kt + 1, tk, tg);
    }
    if (kt + 1 < n_kt) {
      pipelined_step<D, BK, P, true>(s0, s1, acc, pa, m_run, l_run, q_addr,
                                     kv, k_full, v_full, kv_empty, v_empty,
                                     kt, tk, tg);
      pipelined_step<D, BK, P, false>(s1, s0, acc, pa, m_run, l_run, q_addr,
                                      kv, k_full, v_full, kv_empty, v_empty,
                                      kt + 1, tk, tg);
    } else {
      pipelined_step<D, BK, P, false>(s0, s1, acc, pa, m_run, l_run, q_addr,
                                      kv, k_full, v_full, kv_empty, v_empty,
                                      kt, tk, tg);
    }
    wgmma_wait<0>();  // the last P V
    fence_regs(acc);
  } else {
    for (int kt = 0; kt < n_kt; ++kt) {
      float sc[BK / 2];
      issue_s<D, BK, P>(sc, q_addr, kv, k_full, kt);
      wgmma_wait<0>();
      fence_regs(sc);
      if constexpr (MODE == kFull || MODE == kNoExp || MODE == kMxuOnly) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= scale;  // base-2 logits, f32
      }

      if constexpr (MODE != kMxuOnly) {
        float alpha[2];
        softmax_step<BK, MODE != kNoExp>(sc, kt * BK, tk, tg, m_run, l_run,
                                          alpha);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }

      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) p_fragment(sc, kk, pa[kk]);
      fence_regs(pa);
      issue_pv<D, BK, P>(acc, pa, kv, v_full, kt);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(&kv_empty[kt % P::kRing]);
    }
  }

  const int r = q0 + 64 * c + 16 * warp + g;
  store_rows(acc, o + (size_t)h * tq * D, D, r, tq, 0, tg, l_run);
  if constexpr (LSE) store_lse(lse + (size_t)h * tq, r, tq, tg, m_run, l_run);
}

struct Maps {
  CUtensorMap q, k, v;
};

// Maps over bf16 [bh, t, d] q, k and v.
inline cudaError_t make_maps(Maps* m, const void* q, const void* k,
                             const void* v, int bh, int tq, int tk, int d,
                             int q_rows, int kv_rows) {
  cudaError_t err = make_map(&m->q, q, false, bh, tq, d, q_rows);
  if (err == cudaSuccess) err = make_map(&m->k, k, false, bh, tk, d, kv_rows);
  if (err == cudaSuccess) err = make_map(&m->v, v, false, bh, tk, d, kv_rows);
  return err;
}

// Launch flash_fwd_wgmma over contiguous bf16 [bh, t, D] q, k, v, o (and
// with LSE lse [bh, tq] f32) on stream s; scale = d^-0.5 * log2(e).
template <int D, int NC, int BK, bool LSE, int MODE, int PIPE = 0>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* o, float* lse, int bh, int tq, int tk,
                             float scale, cudaStream_t s) {
  using P = FwdPlan<D, NC, BK, PIPE>;
  static std::atomic<unsigned long long> smem_set{0};
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, bh, tq, tk, D, P::kRowsQ, BK);
  if (err == cudaSuccess)
    err = allow_smem_once(flash_fwd_wgmma<D, NC, BK, LSE, MODE, PIPE>,
                          P::kSmemBytes, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + P::kRowsQ - 1) / P::kRowsQ, bh);
  flash_fwd_wgmma<D, NC, BK, LSE, MODE, PIPE><<<grid, P::kThreads,
                                                P::kSmemBytes, s>>>(
      m.q, m.k, m.v, static_cast<__nv_bfloat16*>(o), lse, tq, tk, scale);
  return cudaGetLastError();
}

}  // namespace flash_fwd
