// The flash-attention backward in bf16 on Hopper's own machinery (sm_90a):
// TMA loads into a ring of shared-memory stages tracked by mbarriers,
// warpgroup matrix products (wgmma), and a producer warpgroup that hands
// its registers to the consumers (setmaxnreg). Bound to Python with ctypes.
//
// Replaces the Pallas TPU kernels of sdxl_tpu/ops/flash_attention.py
// `flash_attention_bwd_bhtd` (:342, the FlashAttention-2 backward) on
// their bf16 routes, d = 64 and 128:
//   K3a `_flash_bwd_dq_kernel` (:272)  -> flash_bwd_dq_wgmma<D>
//   K3b `_flash_bwd_dkv_kernel` (:302) -> flash_bwd_dkv_wgmma<D>
// (the f32 routes stay on the FMA pipes in flash_attention_bwd.cu). With
// qf = bf16(q * d^-0.5 * log2(e)) (the forward's rounded pre-scaled q,
// formed by the wrapper in torch, as the reference forms it outside its
// kernels at :381), lse the forward's base-2 row log-sum-exp and
// delta_i = dO_i . O_i in f32 (also the wrapper's):
//   p_ij  = exp2(qf_i . k_j - lse_i)
//   dz_ij = p_ij (dO_i . v_j - delta_i)
//   dq_i  = sum_j bf16(dz_ij) k_j * d^-0.5
//   dk_j  = sum_i bf16(dz_ij) qf_i / log2(e)
//   dv_j  = sum_i bf16(p_ij) dO_i
// Every sum runs in f32 in the tensor cores; each output is rounded to bf16
// once. exp2 is the SFU's, flushing results below 2^-126 to zero, as the
// forward's.
//
// Bound: 6 (dq) and 8 (dk, dv) x B*H*Tq*Tk*d tensor-core operations
// against a few MB, far above the card's ~295 FLOP/byte ridge, so the bound
// is the bf16 tensor-core rate: 0.0651 and 0.0869 ms at [1,10,4096,64]. The
// mma.sync kernels these replace sat at 9-13% of it: every tile was staged
// by the threads themselves, with transposed copies for mma.sync's B
// operands, between two __syncthreads, and no load overlapped a product.
//
// Design, as K1's and K2's flash_fwd_wgmma (flash_hopper.cu). One thread
// of the producer warpgroup keeps TMA copies in flight through a ring of
// stages; each consumer warpgroup owns 64 rows of the block's output and
// waits on the stage's mbarriers. No operand is transposed or copied by a
// thread: the logits' two products read both operands K-major from shared
// memory, the bf16 fragment of their f32 accumulator is the A-register
// fragment of the next product, and that product reads its B operand
// MN-major with the transpose bit, as P V reads V in the forward. The
// logits' two products are committed as separate groups, so that the exp2
// of the first overlaps the second.
//   Ragged token counts: the tensor maps are 3-D over [B*H, T, d], so a
//   tile past T is zero-filled by the TMA unit and never reads the next
//   head's rows. A zero key row gives a logit of 0 and p = exp2(-lse) != 0,
//   a zero query row (lse taken as 0) p = 1: both are masked to p = 0, in
//   a branch that only the tiles reaching past an edge take. Rows past T
//   are never stored. (The outputs would not show an unmasked tail: its p
//   and dz meet the same zero rows, K's in dq, qf's and dO's in dk and
//   dv, in the next product. Planted on the card, each unmasked tail left
//   dq, dk and dv bit for bit unchanged, PERF.md; the mask keeps p
//   itself exact.)
//
// flash_bwd_dq_wgmma<D> (K3a): a block owns kNC x 64 query rows of one
//   b*h; their qf and dO arrive by TMA once and stay in shared memory, each
//   thread keeps its two rows' lse and delta in registers. The producer
//   streams 64-key tiles of K and V. Per tile: S = qf K^T and dP = dO V^T
//   (SS wgmma, m64n64), p and dz in registers, then dq += bf16(dz) K (RS
//   wgmma, K as an MN-major B). No online max, no rescaling.
// flash_bwd_dkv_wgmma<D> (K3b): a block owns kNC x 64 keys of one b*h
//   (K and V resident), in the transposed frame (rows are keys). The
//   producer streams 64-row tiles of qf and dO with their lse and delta
//   (two 1-D maps over [B*H*Tq]; the entries past a head's last row are
//   the next head's or zeros, and masked). Per tile: S^T = K qf^T and
//   dP^T = V dO^T (SS wgmma, all K-major), p^T and dz^T in registers (lse
//   and delta indexed by the fragment's column, read from the stage), then
//   dv += bf16(p^T) dO and dk += bf16(dz^T) qf (RS wgmma, dO and qf as
//   MN-major B operands).
//
// Two kernels, no atomics: each output tile is written by one block, as
// in the reference's two pallas_calls, so the result is deterministic
// (FlashAttention-3 folds dq into the dk/dv kernel with f32 atomics).
//
// Tiles. The training path runs batch 1: B*H = 10 at T = 4096 (level 1, 10
// calls a step) and 20 at T = 1024 (level 2, 60 calls), on 132 SMs with one
// block an SM (the consumers' registers). Three consumers at d = 64 (192
// rows or keys a block): 220 blocks at level 1 (1.67 waves), 120 at level
// 2 (one wave, 91% of the SMs); two would give 320 and 160 blocks, the
// second wave of level 2 filling 28 SMs. Three consumers hold at most 160
// registers a thread: dq's S, dP and accumulator take 96, dk/dv's S^T,
// dP^T and two accumulators 128, so dk/dv forms bf16(p^T) and dz^T in one
// pass (issuing dv's products before dz^T was formed kept p^T's fragments
// live beside it and spilled 32 bytes). At d = 128 two consumers (240
// registers: K3b's accumulators alone take 128). Shared memory at d = 64:
// dq 48 KB of resident qf and dO and three 16 KB stages; dk/dv 48 KB of K
// and V and two 17 KB stages.
//   Tried on the card (scripts/probe_bwd_kernels.py, ms a call inside a
// CUDA graph at level 1 / level 2, against 0.141 / 0.022 for dq and 0.193
// / 0.031 for dk/dv; PERF.md): two consumers, dq 0.163 / 0.032 and dk/dv
// 0.220 / 0.044; dq with two stages 0.140 / 0.023, dk/dv with three 0.195
// / 0.031; S and dP as one group of products (exp2 after both), dq 0.147 /
// 0.024 and dk/dv 0.197 / 0.032. The edge masks: tested on every element
// of every tile, dq took 0.187 ms at level 1 (CUDA events); a copy of the
// exp2 loop for edge tiles took it to 0.155 but dk/dv from 0.200 to 0.263,
// spilling at d = 128; the zeroing pass that only edge tiles take is kept.

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

constexpr float kInvLog2e = 0.69314718055994531f;  // 1 / log2(e)
constexpr int kTileRows = 64;  // keys (dq) or query rows (dk/dv) a stage

// Consumer warpgroups a block and stages of the ring: dq, dk/dv.
template <int D>
constexpr int kDqConsumers = D == 64 ? 3 : 2;
constexpr int kDqStages = 3;
template <int D>
constexpr int kDkvConsumers = D == 64 ? 3 : 2;
constexpr int kDkvStages = 2;

// What both kernels share: NC consumer warpgroups, each owning 64 rows of
// the block's resident tile ([kRows, D]: qf and dO for dq, K and V for
// dk/dv); a ring of STAGES stages of two [64, D] tiles (K and V for dq, qf
// and dO for dk/dv) and, with kRowVectors, their 64 rows' lse and delta.
template <int D, int NC, int STAGES, bool kRowVectors>
struct BwdPlan {
  static constexpr int kNC = NC;
  static constexpr int kStages = STAGES;
  static constexpr int kThreads = 128 * (kNC + 1);
  static constexpr int kConsumers = 128 * kNC;
  static constexpr int kRows = 64 * kNC;
  static constexpr int kBoxes = D / kBoxCols;  // 64-column boxes a row
  static constexpr int kResBox = kRows * kRowBytes;
  static constexpr int kResTile = kBoxes * kResBox;
  static constexpr int kStageBox = kTileRows * kRowBytes;  // 8 KB
  static constexpr int kStageTile = kBoxes * kStageBox;
  static constexpr int kVectors = kRowVectors ? 2 * kTileRows * 4 : 0;
  // a stage: two tiles, then the vectors, padded to the 1024-byte
  // alignment of a swizzled tile
  static constexpr int kStageBytes =
      (2 * kStageTile + kVectors + 1023) / 1024 * 1024;
  static constexpr int kStage0 = 2 * kResTile;
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  // res_full, then first_full, second_full and empty for each stage
  static constexpr int kSmemBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

template <int D>
using DqPlan = BwdPlan<D, kDqConsumers<D>, kDqStages, false>;
template <int D>
using DkvPlan = BwdPlan<D, kDkvConsumers<D>, kDkvStages, true>;
static_assert(DqPlan<128>::kSmemBytes <= 232448 &&
                  DkvPlan<128>::kSmemBytes <= 232448,
              "over a block's shared memory");

template <int NC>
__device__ __forceinline__ void consumer_registers() {
  if constexpr (NC == 3) {
    setmaxnreg_inc<160>();
  } else {
    setmaxnreg_inc<240>();
  }
}

// The barriers after the plan's tiles.
struct Bars {
  uint64_t* res_full;
  uint64_t* first_full;
  uint64_t* second_full;
  uint64_t* empty;
};

template <typename P>
__device__ __forceinline__ Bars init_bars(unsigned char* smem) {
  uint64_t* b = reinterpret_cast<uint64_t*>(smem + P::kBars);
  Bars bars{b, b + 1, b + 1 + P::kStages, b + 1 + 2 * P::kStages};
  if (threadIdx.x == 0) {
    mbar_init(bars.res_full, 1);
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&bars.first_full[s], 1);
      mbar_init(&bars.second_full[s], 1);
      mbar_init(&bars.empty[s], P::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return bars;
}

// The kNC x 64 resident rows from row r0 of two maps, each D / 64 boxes.
template <typename P>
__device__ __forceinline__ void load_resident(unsigned char* smem,
                                              const CUtensorMap* a,
                                              const CUtensorMap* b,
                                              uint64_t* bar, int r0, int h) {
  mbar_expect_tx(bar, 2 * P::kResTile);
  for (int x = 0; x < P::kBoxes; ++x) {
    tma_load(smem + x * P::kResBox, a, bar, x * kBoxCols, r0, h);
    tma_load(smem + P::kResTile + x * P::kResBox, b, bar, x * kBoxCols, r0,
             h);
  }
}

// One [64, D] tile from row r0 of a map into a stage (D / 64 boxes); with
// vec, also 64 f32 of a 1-D map from element e0 behind both tiles.
template <typename P>
__device__ __forceinline__ void load_stage_tile(unsigned char* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int r0, int h,
                                                const CUtensorMap* vec,
                                                float* vec_dst, int e0) {
  mbar_expect_tx(bar, P::kStageTile + (vec ? kTileRows * 4 : 0));
  for (int x = 0; x < P::kBoxes; ++x)
    tma_load(dst + x * P::kStageBox, map, bar, x * kBoxCols, r0, h);
  if (vec) tma_load_1d(vec_dst, vec, bar, e0);
}

// acc = A B^T over D (64 x 64): A is 64 rows of a resident tile (from
// a_addr, boxes a_box bytes apart), B the 64 rows of a stage tile, both
// K-major.
template <int D, typename P>
__device__ __forceinline__ void product_kmajor(float (&acc)[32],
                                               uint32_t a_addr, int a_box,
                                               uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(acc, desc128(a_addr + (kk / 4) * a_box + off, 16),
                 desc128(b_addr + (kk / 4) * P::kStageBox + off, 16), kk > 0);
  }
}

// acc[D / 2] += A B over the 64 rows of B: A in registers (4 k-steps of
// 16), B a [64, D] stage tile read MN-major (transpose-B).
template <int D, typename P>
__device__ __forceinline__ void product_mnmajor(float (&acc)[D / 2],
                                                uint32_t (&a)[4][4],
                                                uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bd = desc128(b_addr + kk * 16 * kRowBytes, P::kStageBox);
    if constexpr (D == 64) {
      wgmma_rs_n64(acc, a[kk], bd);
    } else {
      wgmma_rs_n128(acc, a[kk], bd);
    }
  }
}

// Rows (r, r + 8) of an accumulator fragment times `scale`, stored as bf16
// (rows >= n skipped).
template <int N>
__device__ __forceinline__ void store_scaled(const float (&acc)[N],
                                             __nv_bfloat16* out, int d, int r,
                                             int n, int tg, float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= n) continue;
    __nv_bfloat16* row = out + (size_t)(r + 8 * h) * d + 2 * tg;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// K3a: dq
// ---------------------------------------------------------------------------

// One block a (b*h, kNC x 64 query rows).
template <int D>
__global__ void __launch_bounds__(DqPlan<D>::kThreads, 1)
flash_bwd_dq_wgmma(__grid_constant__ const CUtensorMap qf_map,
                   __grid_constant__ const CUtensorMap do_map,
                   __grid_constant__ const CUtensorMap k_map,
                   __grid_constant__ const CUtensorMap v_map,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int tq, int tk,
                   float nat_scale) {
  using P = DqPlan<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Bars bars = init_bars<P>(smem);
  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * P::kRows, h = blockIdx.y;
  const int n_kt = (tk + kTileRows - 1) / kTileRows;

  if (wg == 0) {  // producer: one thread starts every copy
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      load_resident<P>(smem, &qf_map, &do_map, bars.res_full, q0, h);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % P::kStages;
        mbar_wait(&bars.empty[s], ((kt / P::kStages) & 1) ^ 1);
        unsigned char* st = smem + P::kStage0 + s * P::kStageBytes;
        load_stage_tile<P>(st, &k_map, &bars.first_full[s], kt * kTileRows, h,
                           nullptr, nullptr, 0);
        load_stage_tile<P>(st + P::kStageTile, &v_map, &bars.second_full[s],
                           kt * kTileRows, h, nullptr, nullptr, 0);
      }
    }
    return;
  }

  consumer_registers<P::kNC>();
  const int c = wg - 1;  // this warpgroup's rows: q0 + 64c .. + 63
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const uint32_t qf_addr = smem_u32(smem) + c * 64 * kRowBytes;
  const uint32_t do_addr = qf_addr + P::kResTile;

  // rows r and r + 8 of this thread; rows >= tq get p = 0
  const int r = q0 + 64 * c + 16 * warp + g;
  float lse_r[2], delta_r[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_ok[i] = r + 8 * i < tq;
    lse_r[i] = row_ok[i] ? lse[(size_t)h * tq + r + 8 * i] : 0.f;
    delta_r[i] = row_ok[i] ? delta[(size_t)h * tq + r + 8 * i] : 0.f;
  }
  const bool rows_ok = row_ok[0] && row_ok[1];

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(bars.res_full, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % P::kStages;
    const uint32_t parity = (kt / P::kStages) & 1;
    const uint32_t k_addr = smem_u32(smem + P::kStage0 + s * P::kStageBytes);
    const uint32_t v_addr = k_addr + P::kStageTile;
    const int k0 = kt * kTileRows;

    // S = qf K^T, then dP = dO V^T: two groups
    float sc[32], dp[32];
    mbar_wait(&bars.first_full[s], parity);
    wgmma_fence();
    product_kmajor<D, P>(sc, qf_addr, P::kResBox, k_addr);
    wgmma_commit();
    mbar_wait(&bars.second_full[s], parity);
    wgmma_fence();
    product_kmajor<D, P>(dp, do_addr, P::kResBox, v_addr);
    wgmma_commit();

    // p = exp2(s - lse) while dP is in flight; s[4j + e] is row r + 8 (e
    // >> 1), key k0 + 8j + 2tg + (e & 1)
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = exp2_ftz(sc[i] - lse_r[(i >> 1) & 1]);
    if (k0 + kTileRows > tk || !rows_ok) {  // a tile past an edge
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!row_ok[e >> 1] || k0 + 8 * j + 2 * tg + (e & 1) >= tk)
            sc[4 * j + e] = 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dz = p (dP - delta), rounded to bf16: the A fragment of 16 keys
    // (k-step kk) is s[8kk .. 8kk + 7], register i of row half i & 1
    uint32_t za[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = 8 * kk + 2 * i;
        const float dl = delta_r[i & 1];
        za[kk][i] = pack_bf16(sc[x] * (dp[x] - dl),
                              sc[x + 1] * (dp[x + 1] - dl));
      }
    fence_regs(za);

    // dq += bf16(dz) K
    wgmma_fence();
    product_mnmajor<D, P>(acc, za, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(za);
    mbar_arrive(&bars.empty[s]);
  }

  store_scaled(acc, dq + (size_t)h * tq * D, D, r, tq, tg, nat_scale);
}

// ---------------------------------------------------------------------------
// K3b: dk, dv
// ---------------------------------------------------------------------------

// One block a (b*h, kNC x 64 keys), in the transposed frame.
template <int D>
__global__ void __launch_bounds__(DkvPlan<D>::kThreads, 1)
flash_bwd_dkv_wgmma(__grid_constant__ const CUtensorMap qf_map,
                    __grid_constant__ const CUtensorMap do_map,
                    __grid_constant__ const CUtensorMap k_map,
                    __grid_constant__ const CUtensorMap v_map,
                    __grid_constant__ const CUtensorMap lse_map,
                    __grid_constant__ const CUtensorMap delta_map,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int tq, int tk) {
  using P = DkvPlan<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Bars bars = init_bars<P>(smem);
  const int wg = threadIdx.x / 128;
  const int k0 = blockIdx.x * P::kRows, h = blockIdx.y;
  const int n_qt = (tq + kTileRows - 1) / kTileRows;

  if (wg == 0) {  // producer: one thread starts every copy
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      load_resident<P>(smem, &k_map, &v_map, bars.res_full, k0, h);
      for (int qt = 0; qt < n_qt; ++qt) {
        const int s = qt % P::kStages;
        mbar_wait(&bars.empty[s], ((qt / P::kStages) & 1) ^ 1);
        unsigned char* st = smem + P::kStage0 + s * P::kStageBytes;
        float* vec = reinterpret_cast<float*>(st + 2 * P::kStageTile);
        const int e0 = h * tq + qt * kTileRows;
        load_stage_tile<P>(st, &qf_map, &bars.first_full[s], qt * kTileRows,
                           h, &lse_map, vec, e0);
        load_stage_tile<P>(st + P::kStageTile, &do_map, &bars.second_full[s],
                           qt * kTileRows, h, &delta_map, vec + kTileRows, e0);
      }
    }
    return;
  }

  consumer_registers<P::kNC>();
  const int c = wg - 1;  // this warpgroup's keys: k0 + 64c .. + 63
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const uint32_t k_addr = smem_u32(smem) + c * 64 * kRowBytes;
  const uint32_t v_addr = k_addr + P::kResTile;

  // keys r and r + 8 of this thread (rows of the transposed frame)
  const int r = k0 + 64 * c + 16 * warp + g;
  const bool key_ok[2] = {r < tk, r + 8 < tk};

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  mbar_wait(bars.res_full, 0);

  for (int qt = 0; qt < n_qt; ++qt) {
    const int s = qt % P::kStages;
    const uint32_t parity = (qt / P::kStages) & 1;
    unsigned char* st = smem + P::kStage0 + s * P::kStageBytes;
    const uint32_t qf_addr = smem_u32(st);
    const uint32_t do_addr = qf_addr + P::kStageTile;
    const float* s_lse = reinterpret_cast<const float*>(st + 2 * P::kStageTile);
    const float* s_delta = s_lse + kTileRows;
    const int q0 = qt * kTileRows;

    // S^T = K qf^T, then dP^T = V dO^T: two groups
    float sc[32], dp[32];
    mbar_wait(&bars.first_full[s], parity);
    wgmma_fence();
    product_kmajor<D, P>(sc, k_addr, P::kResBox, qf_addr);
    wgmma_commit();
    mbar_wait(&bars.second_full[s], parity);
    wgmma_fence();
    product_kmajor<D, P>(dp, v_addr, P::kResBox, do_addr);
    wgmma_commit();

    // p^T = exp2(s^T - lse) while dP^T is in flight; s[4j + e] is key r + 8
    // (e >> 1), query row q0 + 8j + 2tg + (e & 1)
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(s_lse + 8 * j + 2 * tg);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = exp2_ftz(sc[4 * j + e] - ((e & 1) ? l.y : l.x));
    }
    if (q0 + kTileRows > tq || !(key_ok[0] && key_ok[1])) {  // past an edge
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!key_ok[e >> 1] || q0 + 8 * j + 2 * tg + (e & 1) >= tq)
            sc[4 * j + e] = 0.f;
    }

    wgmma_wait<0>();
    fence_regs(dp);

    // bf16(p^T) and dz^T = p^T (dP^T - delta) in one pass, so that S^T's
    // and dP^T's registers free as the A fragments fill: register i of
    // k-step kk holds query rows 16kk + 8 (i >> 1) + 2tg (+1) of the tile
    uint32_t pa[4][4], za[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = 8 * kk + 2 * i;
        const float2 dl = *reinterpret_cast<const float2*>(
            s_delta + 16 * kk + 8 * (i >> 1) + 2 * tg);
        pa[kk][i] = pack_bf16(sc[x], sc[x + 1]);
        za[kk][i] = pack_bf16(sc[x] * (dp[x] - dl.x),
                              sc[x + 1] * (dp[x + 1] - dl.y));
      }
    fence_regs(pa);
    fence_regs(za);

    // dv += bf16(p^T) dO, dk += bf16(dz^T) qf
    wgmma_fence();
    product_mnmajor<D, P>(adv, pa, do_addr);
    product_mnmajor<D, P>(adk, za, qf_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(adv);
    fence_regs(adk);
    fence_regs(pa);
    fence_regs(za);
    mbar_arrive(&bars.empty[s]);
  }

  store_scaled(adk, dk + (size_t)h * tk * D, D, r, tk, tg, kInvLog2e);
  store_scaled(adv, dv + (size_t)h * tk * D, D, r, tk, tg, 1.f);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_dq(const void* qf, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int bh, int tq, int tk, float nat_scale,
                      cudaStream_t s) {
  using P = DqPlan<D>;
  static std::atomic<unsigned long long> smem_set{0};
  CUtensorMap qf_map, do_map, k_map, v_map;
  cudaError_t err = make_map(&qf_map, qf, false, bh, tq, D, P::kRows);
  if (err == cudaSuccess)
    err = make_map(&do_map, dout, false, bh, tq, D, P::kRows);
  if (err == cudaSuccess)
    err = make_map(&k_map, k, false, bh, tk, D, kTileRows);
  if (err == cudaSuccess)
    err = make_map(&v_map, v, false, bh, tk, D, kTileRows);
  if (err == cudaSuccess)
    err = allow_smem_once(flash_bwd_dq_wgmma<D>, P::kSmemBytes, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + P::kRows - 1) / P::kRows, bh);
  flash_bwd_dq_wgmma<D><<<grid, P::kThreads, P::kSmemBytes, s>>>(
      qf_map, do_map, k_map, v_map, lse, delta,
      static_cast<__nv_bfloat16*>(dq), tq, tk, nat_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* qf, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int bh, int tq, int tk,
                       cudaStream_t s) {
  using P = DkvPlan<D>;
  static std::atomic<unsigned long long> smem_set{0};
  CUtensorMap qf_map, do_map, k_map, v_map, lse_map, delta_map;
  cudaError_t err = make_map(&qf_map, qf, false, bh, tq, D, kTileRows);
  if (err == cudaSuccess)
    err = make_map(&do_map, dout, false, bh, tq, D, kTileRows);
  if (err == cudaSuccess)
    err = make_map(&k_map, k, false, bh, tk, D, P::kRows);
  if (err == cudaSuccess)
    err = make_map(&v_map, v, false, bh, tk, D, P::kRows);
  if (err == cudaSuccess)
    err = make_map_1d(&lse_map, lse, bh * tq, kTileRows);
  if (err == cudaSuccess)
    err = make_map_1d(&delta_map, delta, bh * tq, kTileRows);
  if (err == cudaSuccess)
    err = allow_smem_once(flash_bwd_dkv_wgmma<D>, P::kSmemBytes, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + P::kRows - 1) / P::kRows, bh);
  flash_bwd_dkv_wgmma<D><<<grid, P::kThreads, P::kSmemBytes, s>>>(
      qf_map, do_map, k_map, v_map, lse_map, delta_map,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), tq,
      tk);
  return cudaGetLastError();
}

}  // namespace

// qf, dout, dq: contiguous [B*H, tq, D] bf16 device buffers (qf the
// rounded pre-scaled q); k, v, dk, dv: [B*H, tk, D] bf16; lse, delta:
// [B*H, tq] f32; all 16-byte aligned; nat_scale = d^-0.5. Each returns a
// cudaError_t; 0 means the kernel was launched.
extern "C" int sdxl_flash_attention_bwd_dq_bf16(
    const void* qf, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
    int d, float nat_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (d == 64)
    return launch_dq<64>(qf, k, v, dout, l, dl, dq, bh, tq, tk, nat_scale, s);
  if (d == 128)
    return launch_dq<128>(qf, k, v, dout, l, dl, dq, bh, tq, tk, nat_scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int sdxl_flash_attention_bwd_dkv_bf16(
    const void* qf, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
    int tk, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (d == 64)
    return launch_dkv<64>(qf, k, v, dout, l, dl, dk, dv, bh, tq, tk, s);
  if (d == 128)
    return launch_dkv<128>(qf, k, v, dout, l, dl, dk, dv, bh, tq, tk, s);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory a kernel of this file launches with (for the
// build report): kernel 0 flash_bwd_dq_wgmma<d>, 1 flash_bwd_dkv_wgmma<d>;
// 0 for any other.
extern "C" int flash_hopper_bwd_smem_bytes(int kernel, int d) {
  if (kernel == 0 && d == 64) return DqPlan<64>::kSmemBytes;
  if (kernel == 0 && d == 128) return DqPlan<128>::kSmemBytes;
  if (kernel == 1 && d == 64) return DkvPlan<64>::kSmemBytes;
  if (kernel == 1 && d == 128) return DkvPlan<128>::kSmemBytes;
  return 0;
}
