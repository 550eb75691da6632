// The flash-attention backward on Hopper's own machinery (sm_90a): TMA
// loads into rings of shared-memory stages tracked by mbarriers, warpgroup
// matrix products (wgmma), and a producer warpgroup that hands its
// registers to the consumers (setmaxnreg). Bound to Python with ctypes.
//
// Replaces the Pallas TPU kernels of sdxl_tpu/ops/flash_attention.py
// `flash_attention_bwd_bhtd` (:342, the FlashAttention-2 backward) on
// their bf16 routes, d = 64 and 128, and their f32 d = 64 route (the f32
// trainer; f32 d = 128, which no SDXL path takes, stays on the FMA pipes
// in flash_attention_bwd.cu):
//   K3a `_flash_bwd_dq_kernel` (:272)  -> flash_bwd_dq_wgmma<D> (bf16),
//                                         flash_bwd_dq_tf32 (f32)
//   K3b `_flash_bwd_dkv_kernel` (:302) -> flash_bwd_dkv_wgmma<D> (bf16),
//                                         flash_bwd_dkv_tf32 (f32)
// With qf = q * d^-0.5 * log2(e) rounded to q's dtype (the forward's
// pre-scaled q, formed by the wrapper in torch, as the reference forms it
// outside its kernels at :381), lse the forward's base-2 row log-sum-exp
// and delta_i = dO_i . O_i in f32 (also the wrapper's):
//   p_ij  = exp2(qf_i . k_j - lse_i)
//   dz_ij = p_ij (dO_i . v_j - delta_i)
//   dq_i  = sum_j dz_ij k_j * d^-0.5
//   dk_j  = sum_i dz_ij qf_i / log2(e)
//   dv_j  = sum_i p_ij dO_i
// In bf16, dz and p are rounded to bf16 before their products, every sum
// runs in f32 in the tensor cores, and each output is rounded to bf16 once.
// In f32 every product runs on TF32 operands in three passes (3xTF32,
// hopper_common.cuh), about 2^-21 of each product lost. exp2 is the SFU's,
// flushing results below 2^-126 to zero, as the forward's.
//
// Bound (bf16): 6 (dq) and 8 (dk, dv) x B*H*Tq*Tk*d tensor-core operations
// against a few MB, far above the card's ~295 FLOP/byte ridge, so the bound
// is the bf16 tensor-core rate: 0.0651 and 0.0869 ms at [1,10,4096,64]. The
// mma.sync kernels these replace sat at 9-13% of it: every tile was staged
// by the threads themselves, with transposed copies for mma.sync's B
// operands, between two __syncthreads, and no load overlapped a product.
//
// Design (bf16), as K1's and K2's flash_fwd_wgmma (flash_hopper.cu). One thread
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
//   producer's TMA thread streams 64-row tiles of qf and dO, and one of
//   its warps stores their rows' lse and delta beside them (zeros past
//   tq; as a 1-D TMA copy its start had to be 16-byte aligned, and at a
//   tq not a multiple of 4 the second head's faulted). Per tile: S^T = K qf^T and
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
#include <type_traits>

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
  static constexpr int kFullArrivals = kRowVectors ? 1 + 32 : 1;
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

// A stage's full barriers wait for the producer's copies and, with row
// vectors, for the 32 lanes of the warp that stores the rows' lse and
// delta.
constexpr int kVectorWarp = 1;  // of the producer warpgroup

template <typename P>
__device__ __forceinline__ Bars init_bars(unsigned char* smem) {
  uint64_t* b = reinterpret_cast<uint64_t*>(smem + P::kBars);
  Bars bars{b, b + 1, b + 1 + P::kStages, b + 1 + 2 * P::kStages};
  if (threadIdx.x == 0) {
    mbar_init(bars.res_full, 1);
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&bars.first_full[s], P::kFullArrivals);
      mbar_init(&bars.second_full[s], P::kFullArrivals);
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

// One [64, D] tile from row r0 of a map into a stage (D / 64 boxes).
template <typename P>
__device__ __forceinline__ void load_stage_tile(unsigned char* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int r0, int h) {
  mbar_expect_tx(bar, P::kStageTile);
  for (int x = 0; x < P::kBoxes; ++x)
    tma_load(dst + x * P::kStageBox, map, bar, x * kBoxCols, r0, h);
}

// The lse and delta of N rows from row t0 of head h (zeros from row tq
// on), stored by the 32 lanes of one warp (a 1-D TMA copy would need h *
// tq to be a multiple of 4: its start must be 16-byte aligned).
template <int N>
__device__ __forceinline__ void store_row_vectors(float* lse_dst,
                                                  float* delta_dst,
                                                  const float* lse,
                                                  const float* delta, int h,
                                                  int tq, int t0, int lane) {
#pragma unroll
  for (int i = lane; i < N; i += 32) {
    const bool ok = t0 + i < tq;
    lse_dst[i] = ok ? lse[(size_t)h * tq + t0 + i] : 0.f;
    delta_dst[i] = ok ? delta[(size_t)h * tq + t0 + i] : 0.f;
  }
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

// Rows (r, r + 8) of an accumulator fragment times `scale`, stored as T
// (bf16 or f32; rows >= n skipped).
template <int N, typename T>
__device__ __forceinline__ void store_scaled(const float (&acc)[N], T* out,
                                             int d, int r, int n, int tg,
                                             float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= n) continue;
    T* row = out + (size_t)(r + 8 * h) * d + 2 * tg;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float x = acc[4 * j + 2 * h] * scale;
      const float y = acc[4 * j + 2 * h + 1] * scale;
      if constexpr (std::is_same_v<T, float>) {
        *reinterpret_cast<float2*>(row + 8 * j) = make_float2(x, y);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(x, y);
      }
    }
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
        load_stage_tile<P>(st, &k_map, &bars.first_full[s], kt * kTileRows,
                           h);
        load_stage_tile<P>(st + P::kStageTile, &v_map, &bars.second_full[s],
                           kt * kTileRows, h);
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
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int tq, int tk) {
  using P = DkvPlan<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Bars bars = init_bars<P>(smem);
  const int wg = threadIdx.x / 128;
  const int k0 = blockIdx.x * P::kRows, h = blockIdx.y;
  const int n_qt = (tq + kTileRows - 1) / kTileRows;

  if (wg == 0) {  // producer: one thread starts every copy, one warp
    setmaxnreg_dec<24>();  // stores the rows' lse and delta
    if (threadIdx.x == 0) {
      load_resident<P>(smem, &k_map, &v_map, bars.res_full, k0, h);
      for (int qt = 0; qt < n_qt; ++qt) {
        const int s = qt % P::kStages;
        mbar_wait(&bars.empty[s], ((qt / P::kStages) & 1) ^ 1);
        unsigned char* st = smem + P::kStage0 + s * P::kStageBytes;
        load_stage_tile<P>(st, &qf_map, &bars.first_full[s], qt * kTileRows,
                           h);
        load_stage_tile<P>(st + P::kStageTile, &do_map, &bars.second_full[s],
                           qt * kTileRows, h);
      }
    } else if (threadIdx.x / 32 == kVectorWarp) {
      for (int qt = 0; qt < n_qt; ++qt) {
        const int s = qt % P::kStages;
        mbar_wait(&bars.empty[s], ((qt / P::kStages) & 1) ^ 1);
        float* vec = reinterpret_cast<float*>(smem + P::kStage0 +
                                              s * P::kStageBytes +
                                              2 * P::kStageTile);
        store_row_vectors<kTileRows>(vec, vec + kTileRows, lse, delta, h, tq,
                                     qt * kTileRows, threadIdx.x % 32);
        mbar_arrive(&bars.first_full[s]);
        mbar_arrive(&bars.second_full[s]);
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
// f32, d = 64: K3a and K3b on TF32 tensor cores in three passes
// ---------------------------------------------------------------------------
//
// Bound: three TF32 passes of 6 (dq) and 8 (dk, dv) x B*H*T^2*64
// operations at 495 TFLOP/s, 0.3904 and 0.5206 ms at [1,10,4096,64]; the
// FMA kernels these replace sat at 18-19% of it (46% and 45% of the f32
// FMA pipes' own bound).
// The bf16 kernels' structure, with the f32 forward's 3xTF32 arithmetic:
//   - wgmma takes TF32 operands only K-major, and every output product
//     contracts over tokens (dz K in dq, p^T dO and dz^T qf in dk/dv), so
//     its B operand is a transposed copy with tokens contiguous: K^T for
//     dq, qf^T and dO^T for dk/dv. A pre-pass (split_tf32_pass,
//     hopper_common.cuh) writes qf, dO, K and V split into hi and lo and
//     the transposed copies, split and in perm8's token order, to a scratch
//     buffer the wrapper allocates (each export its own; at
//     [1,10,4096,64] 10.5 MB a copy, 12 copies for dk/dv). The transposed
//     copies are written as zeros from T up to T rounded to 8, past that
//     the TMA unit reads zeros: no product sees uninitialised scratch.
//   - The A operand of an output product is the logits' accumulator
//     fragment (p or dz; p^T or dz^T), split into hi and lo in registers;
//     in perm8's order no shuffle is needed.
//   - Each tile's output product goes to a fresh accumulator added to dq
//     (dk, dv) on the FMA pipes: summed inside the tensor core over all
//     tiles, dq drifted with T (relative L2 2.9e-5 at T = 4096 against
//     1.4e-6 this way; PERF.md), as the forward's O had.
// Tiles. Two consumer warpgroups of 64 rows (dq) or keys (dk/dv) a block,
// whose resident operands hi and lo take 128 KB of shared memory (qf, dO or
// K, V: 4 x 32 KB); 32 keys or query rows a stage, so that two stages fit
// beside them. The stages are two rings: the logits' B operands (K, V or
// qf, dO, hi and lo: 32 KB a slot, two slots) and the output products'
// (K^T or qf^T, dO^T: 16 or 32 KB, two slots for dq, one for dk/dv), so
// that dk/dv's second ring reloads while the next tile's logits run.
// Shared memory 225 KB (dq) and 226 KB (dk/dv), one block an SM; the
// consumers rise to 240 registers (dk/dv holds dk, dv and two fresh
// accumulators, 128, and the hi and lo fragments of p^T and dz^T, 64). At
// d = 128 the resident operands alone would be 256 KB.

constexpr int kTf32Tile = 32;  // keys (dq) or query rows (dk/dv) a stage
constexpr int kTf32NC = 2;     // consumer warpgroups, 64 rows or keys each

// Shared memory of the f32 kernels: the resident rows (kTf32NC x 64 rows of
// four [kRows, 64] arrays: the two logits' A operands, each hi then lo); a
// ring of FIRST slots of four [32, 64] arrays (the logits' B operands, each
// hi then lo); a ring of SECOND slots of T_ARRAYS [64, 32] arrays (the
// output products' B operands, transposed, each hi then lo); with VECTORS,
// the 32 rows' lse and delta of each first slot. Every array is boxes of
// 32 f32 columns (128 bytes), 128-byte swizzled.
template <int FIRST, int SECOND, int T_ARRAYS, bool VECTORS>
struct Tf32BwdPlan {
  static constexpr int kFirst = FIRST;
  static constexpr int kSecond = SECOND;
  static constexpr int kTArrays = T_ARRAYS;
  static constexpr int kThreads = 128 * (kTf32NC + 1);
  static constexpr int kConsumers = 128 * kTf32NC;
  static constexpr int kRows = 64 * kTf32NC;
  static constexpr int kResBox = kRows * kRowBytes;  // 16 KB
  static constexpr int kResArray = 2 * kResBox;
  static constexpr int kFirstBox = kTf32Tile * kRowBytes;  // 4 KB
  static constexpr int kFirstArray = 2 * kFirstBox;
  static constexpr int kFirstBytes = 4 * kFirstArray;
  static constexpr int kTArray = 64 * kRowBytes;  // one box, 8 KB
  static constexpr int kSecondBytes = kTArrays * kTArray;
  static constexpr int kFirst0 = 4 * kResArray;
  static constexpr int kSecond0 = kFirst0 + kFirst * kFirstBytes;
  static constexpr int kVec0 = kSecond0 + kSecond * kSecondBytes;
  static constexpr int kVecBytes = VECTORS ? 2 * kTf32Tile * 4 : 0;
  static constexpr int kFullArrivals = VECTORS ? 1 + 32 : 1;
  static constexpr int kBars = kVec0 + kFirst * kVecBytes;
  // res_full, first_full and first_empty of each first slot, second_full
  // and second_empty of each second slot
  static constexpr int kSmemBytes =
      kBars + 8 * (1 + 2 * kFirst + 2 * kSecond) + 1024;
};

// dq: first K, V; second K^T. dk/dv: first qf, dO (and lse, delta);
// second qf^T, dO^T, in one slot.
using DqTf32Plan = Tf32BwdPlan<2, 2, 2, false>;
using DkvTf32Plan = Tf32BwdPlan<2, 1, 4, true>;
static_assert(DqTf32Plan::kSmemBytes <= 232448 &&
                  DkvTf32Plan::kSmemBytes <= 232448,
              "over a block's shared memory");

struct Tf32Bars {
  uint64_t* res_full;
  uint64_t* first_full;
  uint64_t* first_empty;
  uint64_t* second_full;
  uint64_t* second_empty;
};

template <typename P>
__device__ __forceinline__ Tf32Bars init_tf32_bars(unsigned char* smem) {
  uint64_t* b = reinterpret_cast<uint64_t*>(smem + P::kBars);
  Tf32Bars bars{b, b + 1, b + 1 + P::kFirst, b + 1 + 2 * P::kFirst,
                b + 1 + 2 * P::kFirst + P::kSecond};
  if (threadIdx.x == 0) {
    mbar_init(bars.res_full, 1);
    for (int s = 0; s < P::kFirst; ++s) {
      mbar_init(&bars.first_full[s], P::kFullArrivals);
      mbar_init(&bars.first_empty[s], P::kConsumers);
    }
    for (int s = 0; s < P::kSecond; ++s) {
      mbar_init(&bars.second_full[s], 1);
      mbar_init(&bars.second_empty[s], P::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return bars;
}

// Rows r0 .. of head h of two split operands (maps over [2 * bh, T, 64]:
// hi at h, lo at h + bh) into four arrays of `array` bytes (boxes `box`
// bytes apart): a_hi, a_lo, b_hi, b_lo.
__device__ __forceinline__ void load_split_rows(unsigned char* dst,
                                                const CUtensorMap* a,
                                                const CUtensorMap* b,
                                                uint64_t* bar, int r0, int h,
                                                int bh, int array, int box) {
  mbar_expect_tx(bar, 4 * array);
  for (int i = 0; i < 4; ++i)
    for (int x = 0; x < 2; ++x)
      tma_load(dst + i * array + x * box, i < 2 ? a : b, bar, x * kBoxF32, r0,
               h + (i & 1) * bh);
}

// Tokens t0 .. t0 + 31 of head h of `count` transposed split operands
// (maps over [2 * bh, 64, tp]) into [64, 32] arrays: hi, lo of each.
template <typename P>
__device__ __forceinline__ void load_transposed(unsigned char* dst,
                                                const CUtensorMap* a,
                                                const CUtensorMap* b,
                                                uint64_t* bar, int t0, int h,
                                                int bh) {
  mbar_expect_tx(bar, P::kSecondBytes);
  for (int i = 0; i < P::kTArrays; ++i)
    tma_load(dst + i * P::kTArray, i < 2 ? a : b, bar, t0, 0,
             h + (i & 1) * bh);
}

// acc (m64n32) = A B^T over d = 64 in three TF32 passes, the small terms
// first: A the consumer's 64 rows of a resident array pair (hi at a_hi, lo
// one array later), B the 32 rows of a first-slot pair, both K-major.
template <typename P>
__device__ __forceinline__ void logits_tf32(float (&acc)[16], uint32_t a_hi,
                                            uint32_t b_hi) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t a = pass == 1 ? a_hi + P::kResArray : a_hi;
    const uint32_t b = pass == 0 ? b_hi + P::kFirstArray : b_hi;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_tf32_n32(acc, desc128(a + (kk / 4) * P::kResBox + off, 16),
                        desc128(b + (kk / 4) * P::kFirstBox + off, 16),
                        pass > 0 || kk > 0);
    }
  }
}

// acc (m64n64) = A B over 32 tokens in three TF32 passes into a fresh
// accumulator: A in registers (four k8 steps, hi and lo), B a [64, 32]
// second-slot pair (hi at b_hi, lo one array later), K-major.
template <typename P>
__device__ __forceinline__ void output_tf32(float (&acc)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4],
                                            uint32_t b_hi) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t b = pass == 1 ? b_hi + P::kTArray : b_hi;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tf32_n64(acc, pass == 0 ? lo[kk] : hi[kk],
                        desc128(b + kk * 32, 16), pass > 0 || kk > 0);
  }
}

// An m64n32 accumulator fragment as the TF32 A fragments of four k8 steps
// (in perm8's token order), split into hi and lo.
__device__ __forceinline__ void split_fragment(const float (&x)[16],
                                               uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h, l;
      split_tf32(x[a_frag_index(j, e)], h, l);
      hi[j][e] = __float_as_uint(h);
      lo[j][e] = __float_as_uint(l);
    }
}

// K3a, f32: one block a (b*h, 128 query rows). Maps over the pre-pass's
// scratch: qf, dO, K, V split [2 * bh, T, 64]; K^T split [2 * bh, 64, tp].
__global__ void __launch_bounds__(DqTf32Plan::kThreads, 1)
flash_bwd_dq_tf32(__grid_constant__ const CUtensorMap qf_map,
                  __grid_constant__ const CUtensorMap do_map,
                  __grid_constant__ const CUtensorMap k_map,
                  __grid_constant__ const CUtensorMap v_map,
                  __grid_constant__ const CUtensorMap kt_map,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int bh, int tq, int tk, float nat_scale) {
  using P = DqTf32Plan;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Tf32Bars bars = init_tf32_bars<P>(smem);
  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * P::kRows, h = blockIdx.y;
  const int n_kt = (tk + kTf32Tile - 1) / kTf32Tile;

  if (wg == 0) {  // producer: one thread starts every copy
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      load_split_rows(smem, &qf_map, &do_map, bars.res_full, q0, h, bh,
                      P::kResArray, P::kResBox);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int f = kt % P::kFirst, s = kt % P::kSecond;
        mbar_wait(&bars.first_empty[f], ((kt / P::kFirst) & 1) ^ 1);
        load_split_rows(smem + P::kFirst0 + f * P::kFirstBytes, &k_map,
                        &v_map, &bars.first_full[f], kt * kTf32Tile, h, bh,
                        P::kFirstArray, P::kFirstBox);
        mbar_wait(&bars.second_empty[s], ((kt / P::kSecond) & 1) ^ 1);
        load_transposed<P>(smem + P::kSecond0 + s * P::kSecondBytes, &kt_map,
                           nullptr, &bars.second_full[s], kt * kTf32Tile, h,
                           bh);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int c = wg - 1;  // this warpgroup's rows: q0 + 64c .. + 63
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const uint32_t qf_hi = smem_u32(smem) + c * 64 * kRowBytes;
  const uint32_t do_hi = qf_hi + 2 * P::kResArray;

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

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mbar_wait(bars.res_full, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int f = kt % P::kFirst, s = kt % P::kSecond;
    const uint32_t first = smem_u32(smem + P::kFirst0 + f * P::kFirstBytes);
    const uint32_t kt_hi = smem_u32(smem + P::kSecond0 + s * P::kSecondBytes);
    const int k0 = kt * kTf32Tile;

    // S = qf K^T, then dP = dO V^T: two groups
    float sc[16], dp[16];
    mbar_wait(&bars.first_full[f], (kt / P::kFirst) & 1);
    wgmma_fence();
    logits_tf32<P>(sc, qf_hi, first);
    wgmma_commit();
    logits_tf32<P>(dp, do_hi, first + 2 * P::kFirstArray);
    wgmma_commit();

    // p = exp2(s - lse) while dP is in flight; s[4j + e] is row r + 8 (e
    // >> 1), key k0 + 8j + 2tg + (e & 1)
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = exp2_ftz(sc[i] - lse_r[(i >> 1) & 1]);
    if (k0 + kTf32Tile > tk || !rows_ok) {  // a tile past an edge
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!row_ok[e >> 1] || k0 + 8 * j + 2 * tg + (e & 1) >= tk)
            sc[4 * j + e] = 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    mbar_arrive(&bars.first_empty[f]);

    // dz = p (dP - delta), split into the TF32 A fragments of dq += dz K
    uint32_t z_hi[4][4], z_lo[4][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] *= dp[i] - delta_r[(i >> 1) & 1];
    split_fragment(sc, z_hi, z_lo);
    fence_regs(z_hi);
    fence_regs(z_lo);

    // this tile's dz K into a fresh accumulator, added to dq on the FMA
    // pipes
    float fresh[32];
    mbar_wait(&bars.second_full[s], (kt / P::kSecond) & 1);
    wgmma_fence();
    output_tf32<P>(fresh, z_hi, z_lo, kt_hi);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(fresh);
    fence_regs(z_hi);
    fence_regs(z_lo);
    mbar_arrive(&bars.second_empty[s]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += fresh[i];
  }

  store_scaled(acc, dq + (size_t)h * tq * 64, 64, r, tq, tg, nat_scale);
}

// K3b, f32: one block a (b*h, 128 keys), in the transposed frame. Maps
// over the pre-pass's scratch: K, V, qf, dO split [2 * bh, T, 64]; qf^T,
// dO^T split [2 * bh, 64, tp]; lse and delta [B*H, tq].
__global__ void __launch_bounds__(DkvTf32Plan::kThreads, 1)
flash_bwd_dkv_tf32(__grid_constant__ const CUtensorMap k_map,
                   __grid_constant__ const CUtensorMap v_map,
                   __grid_constant__ const CUtensorMap qf_map,
                   __grid_constant__ const CUtensorMap do_map,
                   __grid_constant__ const CUtensorMap qft_map,
                   __grid_constant__ const CUtensorMap dot_map,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int bh,
                   int tq, int tk) {
  using P = DkvTf32Plan;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Tf32Bars bars = init_tf32_bars<P>(smem);
  const int wg = threadIdx.x / 128;
  const int k0 = blockIdx.x * P::kRows, h = blockIdx.y;
  const int n_qt = (tq + kTf32Tile - 1) / kTf32Tile;

  if (wg == 0) {  // producer: one thread starts every copy, one warp
    setmaxnreg_dec<24>();  // stores the rows' lse and delta
    if (threadIdx.x == 0) {
      load_split_rows(smem, &k_map, &v_map, bars.res_full, k0, h, bh,
                      P::kResArray, P::kResBox);
      for (int qt = 0; qt < n_qt; ++qt) {
        const int f = qt % P::kFirst, s = qt % P::kSecond;
        mbar_wait(&bars.first_empty[f], ((qt / P::kFirst) & 1) ^ 1);
        load_split_rows(smem + P::kFirst0 + f * P::kFirstBytes, &qf_map,
                        &do_map, &bars.first_full[f], qt * kTf32Tile, h, bh,
                        P::kFirstArray, P::kFirstBox);
        mbar_wait(&bars.second_empty[s], ((qt / P::kSecond) & 1) ^ 1);
        load_transposed<P>(smem + P::kSecond0 + s * P::kSecondBytes, &qft_map,
                           &dot_map, &bars.second_full[s], qt * kTf32Tile, h,
                           bh);
      }
    } else if (threadIdx.x / 32 == kVectorWarp) {
      for (int qt = 0; qt < n_qt; ++qt) {
        const int f = qt % P::kFirst;
        mbar_wait(&bars.first_empty[f], ((qt / P::kFirst) & 1) ^ 1);
        float* vec =
            reinterpret_cast<float*>(smem + P::kVec0 + f * P::kVecBytes);
        store_row_vectors<kTf32Tile>(vec, vec + kTf32Tile, lse, delta, h, tq,
                                     qt * kTf32Tile, threadIdx.x % 32);
        mbar_arrive(&bars.first_full[f]);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int c = wg - 1;  // this warpgroup's keys: k0 + 64c .. + 63
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const uint32_t k_hi = smem_u32(smem) + c * 64 * kRowBytes;
  const uint32_t v_hi = k_hi + 2 * P::kResArray;

  // keys r and r + 8 of this thread (rows of the transposed frame)
  const int r = k0 + 64 * c + 16 * warp + g;
  const bool key_ok[2] = {r < tk, r + 8 < tk};

  float adk[32], adv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) adk[i] = adv[i] = 0.f;
  mbar_wait(bars.res_full, 0);

  for (int qt = 0; qt < n_qt; ++qt) {
    const int f = qt % P::kFirst, s = qt % P::kSecond;
    const uint32_t first = smem_u32(smem + P::kFirst0 + f * P::kFirstBytes);
    const uint32_t qft_hi = smem_u32(smem + P::kSecond0 + s * P::kSecondBytes);
    const uint32_t dot_hi = qft_hi + 2 * P::kTArray;
    const float* s_lse =
        reinterpret_cast<const float*>(smem + P::kVec0 + f * P::kVecBytes);
    const float* s_delta = s_lse + kTf32Tile;
    const int q0 = qt * kTf32Tile;

    // S^T = K qf^T, then dP^T = V dO^T: two groups
    float sc[16], dp[16];
    mbar_wait(&bars.first_full[f], (qt / P::kFirst) & 1);
    wgmma_fence();
    logits_tf32<P>(sc, k_hi, first);
    wgmma_commit();
    logits_tf32<P>(dp, v_hi, first + 2 * P::kFirstArray);
    wgmma_commit();

    // p^T = exp2(s^T - lse) while dP^T is in flight; s[4j + e] is key r + 8
    // (e >> 1), query row q0 + 8j + 2tg + (e & 1)
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(s_lse + 8 * j + 2 * tg);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = exp2_ftz(sc[4 * j + e] - ((e & 1) ? l.y : l.x));
    }
    if (q0 + kTf32Tile > tq || !(key_ok[0] && key_ok[1])) {  // past an edge
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!key_ok[e >> 1] || q0 + 8 * j + 2 * tg + (e & 1) >= tq)
            sc[4 * j + e] = 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dz^T = p^T (dP^T - delta), in dP^T's registers
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 dl =
          *reinterpret_cast<const float2*>(s_delta + 8 * j + 2 * tg);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
    }
    mbar_arrive(&bars.first_empty[f]);
    uint32_t p_hi[4][4], p_lo[4][4], z_hi[4][4], z_lo[4][4];
    split_fragment(sc, p_hi, p_lo);
    split_fragment(dp, z_hi, z_lo);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(z_hi);
    fence_regs(z_lo);

    // this tile's p^T dO and dz^T qf into fresh accumulators, added to dv
    // and dk on the FMA pipes
    float fv[32], fk[32];
    mbar_wait(&bars.second_full[s], (qt / P::kSecond) & 1);
    wgmma_fence();
    output_tf32<P>(fv, p_hi, p_lo, dot_hi);
    output_tf32<P>(fk, z_hi, z_lo, qft_hi);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(fv);
    fence_regs(fk);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(z_hi);
    fence_regs(z_lo);
    mbar_arrive(&bars.second_empty[s]);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      adv[i] += fv[i];
      adk[i] += fk[i];
    }
  }

  store_scaled(adk, dk + (size_t)h * tk * 64, 64, r, tk, tg, kInvLog2e);
  store_scaled(adv, dv + (size_t)h * tk * 64, 64, r, tk, tg, 1.f);
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
  CUtensorMap qf_map, do_map, k_map, v_map;
  cudaError_t err = make_map(&qf_map, qf, false, bh, tq, D, kTileRows);
  if (err == cudaSuccess)
    err = make_map(&do_map, dout, false, bh, tq, D, kTileRows);
  if (err == cudaSuccess)
    err = make_map(&k_map, k, false, bh, tk, D, P::kRows);
  if (err == cudaSuccess)
    err = make_map(&v_map, v, false, bh, tk, D, P::kRows);
  if (err == cudaSuccess)
    err = allow_smem_once(flash_bwd_dkv_wgmma<D>, P::kSmemBytes, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + P::kRows - 1) / P::kRows, bh);
  flash_bwd_dkv_wgmma<D><<<grid, P::kThreads, P::kSmemBytes, s>>>(
      qf_map, do_map, k_map, v_map, lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), tq,
      tk);
  return cudaGetLastError();
}

// The f32 kernels' scratch, in floats from its start: qf, dO, K and V
// each split [2, bh, T, 64] (hi, then lo), then the transposed copies,
// each split [2, bh, 64, tp] (tp = T rounded up to 8): K^T for K3a; qf^T,
// then dO^T for K3b.
struct Tf32Scratch {
  float *qf, *dout, *k, *v, *t0, *t1;
  int tpq, tpk;
  Tf32Scratch(void* base, int bh, int tq, int tk)
      : tpq((tq + 7) / 8 * 8), tpk((tk + 7) / 8 * 8) {
    qf = static_cast<float*>(base);
    dout = qf + (size_t)2 * bh * tq * 64;
    k = dout + (size_t)2 * bh * tq * 64;
    v = k + (size_t)2 * bh * tk * 64;
    t0 = v + (size_t)2 * bh * tk * 64;
    t1 = t0 + (size_t)2 * bh * 64 * tpq;
  }
};

cudaError_t launch_dq_tf32(const void* qf, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, void* scratch,
                           int bh, int tq, int tk, float nat_scale,
                           cudaStream_t s) {
  using P = DqTf32Plan;
  static std::atomic<unsigned long long> smem_set{0};
  const Tf32Scratch sc(scratch, bh, tq, tk);
  SplitJobs jobs{};
  jobs.job[0] = {static_cast<const float*>(qf), sc.qf, nullptr, tq, sc.tpq};
  jobs.job[1] = {static_cast<const float*>(dout), sc.dout, nullptr, tq,
                 sc.tpq};
  jobs.job[2] = {static_cast<const float*>(k), sc.k, sc.t0, tk, sc.tpk};
  jobs.job[3] = {static_cast<const float*>(v), sc.v, nullptr, tk, sc.tpk};
  CUtensorMap qf_map, do_map, k_map, v_map, kt_map;
  cudaError_t err = make_map(&qf_map, sc.qf, true, 2 * bh, tq, 64, P::kRows);
  if (err == cudaSuccess)
    err = make_map(&do_map, sc.dout, true, 2 * bh, tq, 64, P::kRows);
  if (err == cudaSuccess)
    err = make_map(&k_map, sc.k, true, 2 * bh, tk, 64, kTf32Tile);
  if (err == cudaSuccess)
    err = make_map(&v_map, sc.v, true, 2 * bh, tk, 64, kTf32Tile);
  if (err == cudaSuccess)
    err = make_map(&kt_map, sc.t0, true, 2 * bh, 64, sc.tpk, 64);
  if (err == cudaSuccess)
    err = allow_smem_once(flash_bwd_dq_tf32, P::kSmemBytes, &smem_set);
  if (err == cudaSuccess) err = launch_split_tf32(jobs, 4, bh, s);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + P::kRows - 1) / P::kRows, bh);
  flash_bwd_dq_tf32<<<grid, P::kThreads, P::kSmemBytes, s>>>(
      qf_map, do_map, k_map, v_map, kt_map, lse, delta,
      static_cast<float*>(dq), bh, tq, tk, nat_scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv_tf32(const void* qf, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv,
                            void* scratch, int bh, int tq, int tk,
                            cudaStream_t s) {
  using P = DkvTf32Plan;
  static std::atomic<unsigned long long> smem_set{0};
  const Tf32Scratch sc(scratch, bh, tq, tk);
  SplitJobs jobs{};
  jobs.job[0] = {static_cast<const float*>(qf), sc.qf, sc.t0, tq, sc.tpq};
  jobs.job[1] = {static_cast<const float*>(dout), sc.dout, sc.t1, tq,
                 sc.tpq};
  jobs.job[2] = {static_cast<const float*>(k), sc.k, nullptr, tk, sc.tpk};
  jobs.job[3] = {static_cast<const float*>(v), sc.v, nullptr, tk, sc.tpk};
  CUtensorMap k_map, v_map, qf_map, do_map, qft_map, dot_map;
  cudaError_t err = make_map(&k_map, sc.k, true, 2 * bh, tk, 64, P::kRows);
  if (err == cudaSuccess)
    err = make_map(&v_map, sc.v, true, 2 * bh, tk, 64, P::kRows);
  if (err == cudaSuccess)
    err = make_map(&qf_map, sc.qf, true, 2 * bh, tq, 64, kTf32Tile);
  if (err == cudaSuccess)
    err = make_map(&do_map, sc.dout, true, 2 * bh, tq, 64, kTf32Tile);
  if (err == cudaSuccess)
    err = make_map(&qft_map, sc.t0, true, 2 * bh, 64, sc.tpq, 64);
  if (err == cudaSuccess)
    err = make_map(&dot_map, sc.t1, true, 2 * bh, 64, sc.tpq, 64);
  if (err == cudaSuccess)
    err = allow_smem_once(flash_bwd_dkv_tf32, P::kSmemBytes, &smem_set);
  if (err == cudaSuccess) err = launch_split_tf32(jobs, 4, bh, s);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + P::kRows - 1) / P::kRows, bh);
  flash_bwd_dkv_tf32<<<grid, P::kThreads, P::kSmemBytes, s>>>(
      k_map, v_map, qf_map, do_map, qft_map, dot_map, lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), bh, tq, tk);
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

// K3a and K3b f32, d = 64 (3xTF32): as the bf16 exports, on f32 buffers,
// with a scratch device buffer of 4 * B*H * 64 * (tq + tk) floats, plus 2 *
// B*H * 64 * tpk for K3a or 4 * B*H * 64 * tpq for K3b (tp = T rounded up
// to a multiple of 8), for the pre-pass's split copies.
extern "C" int sdxl_flash_attention_bwd_dq_f32(
    const void* qf, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* scratch, int bh,
    int tq, int tk, int d, float nat_scale, void* stream) {
  if (d != 64) return cudaErrorInvalidValue;
  return launch_dq_tf32(qf, k, v, dout, static_cast<const float*>(lse),
                        static_cast<const float*>(delta), dq, scratch, bh, tq,
                        tk, nat_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int sdxl_flash_attention_bwd_dkv_f32(
    const void* qf, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* scratch,
    int bh, int tq, int tk, int d, void* stream) {
  if (d != 64) return cudaErrorInvalidValue;
  return launch_dkv_tf32(qf, k, v, dout, static_cast<const float*>(lse),
                         static_cast<const float*>(delta), dk, dv, scratch,
                         bh, tq, tk, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory a kernel of this file launches with (for the
// build report), by its index and its leading int template arguments (the
// last two unused): kernel 0 flash_bwd_dq_wgmma<d>, 1
// flash_bwd_dkv_wgmma<d>, 2 flash_bwd_dq_tf32, 3 flash_bwd_dkv_tf32; 0 for
// any other.
extern "C" int flash_hopper_bwd_smem_bytes(int kernel, int d, int, int) {
  if (kernel == 2) return DqTf32Plan::kSmemBytes;
  if (kernel == 3) return DkvTf32Plan::kSmemBytes;
  if (kernel == 0 && d == 64) return DqPlan<64>::kSmemBytes;
  if (kernel == 0 && d == 128) return DqPlan<128>::kSmemBytes;
  if (kernel == 1 && d == 64) return DkvPlan<64>::kSmemBytes;
  if (kernel == 1 && d == 128) return DkvPlan<128>::kSmemBytes;
  return 0;
}
