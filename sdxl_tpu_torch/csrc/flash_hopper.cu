// The flash-attention forwards on Hopper's own machinery (sm_90a): TMA
// loads into a ring of shared-memory stages tracked by mbarriers, warpgroup
// matrix products (wgmma), and a producer warpgroup that hands its
// registers to the consumers (setmaxnreg). Bound to Python with ctypes.
//
// Replaces the Pallas TPU kernels of sdxl_tpu/ops/flash_attention.py
// `flash_attention_bhtd` (:140; pallas_call :207): K1 (return_lse=False,
// `_flash_kernel` :92, `_flash_kernel_core` :40) on every route (bf16 d
// 64, 128 and 512, f32 d 64, 128 and 512), and K2 (return_lse=True, bf16
// and f32 d 64 and 128; `_flash_kernel_lse` :102,
// which also stores the row's base-2 log-sum-exp m + log2(l) for the
// backward; here one f32 per row, [B*H, tq], without the TPU's lane
// replication). Unmasked softmax(q k^T / sqrt(d)) v over [B,H,T,D] with
// the reference's numerics kept:
//   - q is multiplied by d^-0.5 * log2(e) in f32 and rounded to q's dtype
//     before any product (flash_attention.py:185);
//   - the online softmax runs in base 2 with f32 logits, running max m,
//     normaliser l and accumulator (exp2 flushes results below 2^-126 to
//     zero, as the TPU's f32 does); p is rounded to v's dtype before P V
//     while l sums the f32 p;
//   - the output is acc / l rounded to v's dtype.
// Ragged token counts: the tensor maps are 3-D over [B*H, T, D], so a tile
// that runs past T is zero-filled by the TMA unit and never reads the next
// head's rows; keys >= tk still get a -inf logit (a zero key would give
// logit 0), and query rows >= tq are never stored.
//
// flash_fwd_wgmma<D, NC, BK, LSE, kPrescaleQ> (the UNet's bf16
// self-attention, d = 64 or 128: K1 without the lse, K2 with it) is
// flash_fwd_wgmma.cuh's kernel, which the experiments X1 and X2
// (flash_experiments.cu) instantiate too; its design is described there.
//   Bound: 4*B*H*T^2*D operations at the bf16 tensor-core rate (989
//   TFLOP/s). The mma.sync kernel it replaces sat at 11% of it, its time
//   in synchronous, transposing loads (PERF.md, X2 and X3).
//   Tiles: three consumer warpgroups of 64 query rows at d = 64 (192 rows
//   a tile), two at d = 128 (128 rows); 128 keys a stage. X1 sweeps this
//   kernel's tile (PERF.md): 128 keys beat 64 at every row count, and 64
//   rows (one consumer, two blocks an SM) were 5.6% faster than 192 at
//   T = 4096 and 7.2% slower at T = 1024. One block a (q-tile, b*h) tile: at
//   T = 1024, 240 tiles of 192 rows on 132 SMs (a persistent grid walking
//   the tiles measured no faster, PERF.md). Shared memory 88 KB (d 64) or
//   160 KB, one block per SM. K2 runs at batch 1, where 192-row tiles
//   leave more of the last wave idle; 128-row tiles (two consumers) were
//   still slower there (0.132 against 0.109 ms at [1,10,4096,64], 0.030
//   against 0.021 at [1,20,1024,64]; PERF.md), so K2 keeps K1's tiles.
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
//
// flash_fwd_tf32<D, LSE> (f32 d = 64: the f32 UNet's self-attention, K1
// without the lse, K2 of the f32 trainer with it; f32 d = 128: Flux's head
// width, which no SDXL path takes) on the TF32 tensor cores in three
// passes (3xTF32, CUTLASS's OpMultiplyAddFastF32). One TF32 product keeps
// 10 mantissa bits of each operand: its relative error, about 2^-11, puts
// f32 attention about 4e-4 (relative L2) off the f32 result, four times
// the route's 1e-4 bound. So each f32 operand x is split into x_hi =
// rna(x) and x_lo = rna(x - x_hi), both TF32 (`cvt.rna.tf32.f32`, rounded
// to nearest, ties away from zero), and a b is taken as a_hi b_hi + a_hi
// b_lo + a_lo b_hi summed in f32: the dropped a_lo b_lo and the rounding
// of x_lo leave about 2^-21 of each product, near f32's own 2^-24
// (tests/test_torch_flash_attention.py pins this arithmetic on the CPU).
//   Bound: three TF32 passes of 4*B*H*T^2*D operations at 495 TFLOP/s,
//   0.521 ms at [2,10,4096,64]; the FMA route it replaces ran on the f32
//   pipes (bound 1.28 ms) at 24% of that.
//   wgmma takes 32-bit operands only K-major. Q and K ([T, D], d
//   contiguous) already are for S = Q K^T; for P V the operand is V^T with
//   keys contiguous. The f32 routes' pre-pass (split_tf32_pass,
//   hopper_common.cuh) writes K_hi, K_lo ([B*H, tk, D]) and V^T_hi,
//   V^T_lo ([B*H, D, tp], tp = tk rounded up to 8, keys in perm8's order)
//   to a scratch buffer the wrapper allocates: 4 x B*H*T*D floats, 84 MB
//   at [2,10,4096,64] and 226 MB at [1,24,4608,128], about 0.04 and 0.1
//   ms of the call's bytes. The consumers split their pre-scaled Q rows
//   in shared memory after the TMA load (hi in place, lo beside it). P
//   stays in registers: in perm8's order S's accumulator fragment is P V's
//   A fragment (hopper_common.cuh), split into hi and lo in registers.
//   Each key tile's P V goes to a fresh accumulator that is added to O
//   on the FMA pipes (O = alpha O + PV in one fmaf): with O itself
//   accumulated in the tensor cores, T/8 x 3 products summed there drifted
//   linearly in T (relative L2 2.9e-5 at T = 4096 against 1.3e-6 this
//   way; PERF.md).
//   Tiles at d = 64: three consumer warpgroups of 64 query rows (192 rows
//   a tile), 64 keys a stage (P hi and lo take 64 registers beside S's 32,
//   O's 32 and the tile's P V 32; the consumers rise to 160). Two
//   consumers were 2% faster at T = 4096 and 10% slower at T = 1024, where
//   60 of the f32 UNet's 70 calls run. Shared memory: Q hi and lo, 32 KB a
//   consumer; two stages of K_hi, K_lo, V^T_hi, V^T_lo, 16 KB each, all in
//   128-byte-swizzled boxes of 32 floats: 225 KB, one block per SM. With
//   LSE one lane of each quad stores m + log2(l) of its rows, as K2's bf16
//   kernel does. K2 runs at batch 1 (at T = 1024, 6 tiles x 20 heads = 120
//   blocks on 132 SMs); two consumers (128-row tiles) were still slower
//   there than three (0.103 against 0.077 ms at [1,20,1024,64], 0.503
//   against 0.448-0.456 at [1,10,4096,64]; scripts/probe_f32_kernels.py,
//   PERF.md), so K2 keeps K1's tiles.
//   Tiles at d = 128 (bound: 1.581 ms at [1,24,4608,128], an f32 Flux-dev
//   forward's joint attention at 1024x1024; the FMA kernel it replaces
//   took 12.7 ms there): 64 query rows hold 64 KB of Q hi and lo, so a
//   block keeps one 64-row group and one consumer warpgroup (O and the
//   tile's fresh P V 64 registers each, S 32, P hi and lo 64), and one
//   64-key stage (128 KB: K_hi, K_lo, V^T_hi, V^T_lo) beside it: 192 KB,
//   one block per SM. The stage's K is freed as soon as the logits have
//   read it and V is loaded by a second producer thread, so that the next
//   tile's K lands under this tile's softmax and P V, and its V under the
//   next logits. Two consumers taking turns at two 32-key stages over the
//   same rows (FlashAttention-3's ping-pong between warpgroups, each with
//   its own m, l and O, merged at the end in a fixed order), one consumer
//   at two 32-key stages, and K freed with V were each slower (PERF.md). The m64n64 logits read their
//   Q operand from shared memory anew for each of their 48 k8 steps a tile
//   (192 KB, against 96 KB of K), and each block streams all of K and V,
//   hi and lo (9.4 MB at T = 4608), for its 64 rows.
//
// flash_fwd_f32_d512 (the f32 VAE's mid-block attention, f32 d = 512, in
// every f32 decode and in the training set's encode) on the TF32 tensor
// cores in three passes, through mma.sync.m16n8k8.
//   Bound: 3 x 4*T^2*512 TF32 operations at 495 TFLOP/s, 3.33 ms at T =
//   16384; the FMA kernel it replaces (8.21 ms bound) took 26.6 ms.
//   Three passes need a high and a low part of every operand, and a 64-row
//   Q tile's alone are 256 KB at d = 512, more than a block's 227 KB, so
//   wgmma (64-row tiles, 32-bit operands K-major in shared memory) would
//   need the head dim split over a cluster. Here the operands stay f32 in
//   shared memory and are split in registers (mma.sync reads its operands
//   from registers, in any majorness): hi = x with its 13 low mantissa bits
//   cleared, lo = x - hi, which the tensor core truncates to TF32 in turn
//   (about 2^-20 of each product; tests/test_torch_flash_attention.py
//   pins this arithmetic on the CPU). Two instructions a split, no
//   conversion.
//   A block: 32 query rows, 8 warps, 32 keys a tile. For S each warp takes
//   64 of the 512 head-dim columns (8 k8 steps, 2 x 4 m16n8 tiles: the
//   operands of one k-step feed 24 products) and writes its partial S
//   fragments to shared memory; every thread then sums one fragment
//   position over the 8 warps in warp order (the same order for every
//   element), so the softmax sees one S, and 16 lanes of a warp hold a
//   row pair. They write P's hi and lo A fragments to shared memory in
//   V's key order: V's rows are permuted by perm8 within each group of 8
//   keys as they are loaded, so the S fragment (keys 2tg, 2tg + 1) is the
//   A fragment (k-columns tg, tg + 4) as it stands. For P V each warp owns
//   64 output columns (2 x 8 m16n8 tiles, 64 accumulators); each 8-column
//   tile's P V over the 32 keys goes to a fresh accumulator added to O by
//   fmaf (O summed inside the tensor core drifts linearly in T; PERF.md).
//   K and V tiles come by cp.async (zero fill past tk): K(t + 1) during
//   the softmax and P V of tile t, V(t + 1) during S of t + 1.
//   Shared memory: Q 32 x 516 f32 (rows padded by 4 floats: conflict-free
//   fragment loads) 64.5 KB, K 32 x 516 64.5 KB, V 32 x 520 65 KB, the
//   partial S 32 KB (P's fragments reuse its first 8 KB), alpha and l
//   256 B: 231,680 bytes, one block per SM, 512 blocks at T = 16384.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"
#include "flash_fwd_wgmma.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;
using namespace flash_fwd;
using flash::allow_smem_once;
using flash::cp_async_commit;
using flash::cp_async_wait;

// The f32 counterpart of store_rows.
template <int N>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[N], float* o,
                                               int d, int r, int tq, int tg,
                                               const float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= tq) continue;
    float* row = o + (size_t)(r + 8 * h) * d + 2 * tg;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(
          acc[4 * j + 2 * h] / l[h], acc[4 * j + 2 * h + 1] / l[h]);
  }
}

// K1's and K2's bf16 kernel (flash_fwd_wgmma.cuh) at their tiles: three
// consumer warpgroups at d = 64, two at d = 128, 128 keys a stage.
template <int D>
constexpr int kK1Consumers = D == 64 ? 3 : 2;
constexpr int kK1Keys = 128;

template <int D, bool LSE>
cudaError_t launch_k1(const void* q, const void* k, const void* v, void* o,
                      float* lse, int bh, int tq, int tk, float scale,
                      cudaStream_t s) {
  return launch_fwd_wgmma<D, kK1Consumers<D>, kK1Keys, LSE, kPrescaleQ>(
      q, k, v, o, lse, bh, tq, tk, scale, s);
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
    wgmma_wait<0>();
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
    wgmma_wait<0>();
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
// f32, d = 64 and 128, on TF32 tensor cores in three passes
// ---------------------------------------------------------------------------

// flash_fwd_tf32<D, LSE>'s tiles and shared memory. Every array, hi and lo,
// is boxes of 32 f32 columns, 128-byte swizzled: Q hi, then Q lo (the
// block's rows), then kRing stages of K_hi, K_lo ([kKeys, D]), V^T_hi and
// V^T_lo ([D, kKeys]).
template <int D>
struct Tf32Plan {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  // consumer warpgroups, each owning 64 query rows: three at d = 64, one
  // at d = 128
  static constexpr int kNC = D == 64 ? 3 : 1;
  static constexpr int kKeys = 64;               // keys a stage
  static constexpr int kRing = D == 64 ? 2 : 1;  // stages
  static constexpr int kThreads = 128 * (kNC + 1);
  static constexpr int kConsumers = 128 * kNC;
  static constexpr int kRowsQ = 64 * kNC;
  static constexpr int kBoxes = D / kBoxF32;
  static constexpr int kQBox = kRowsQ * kRowBytes;  // 32 columns of Q
  static constexpr int kQBytes = kBoxes * kQBox;    // Q hi (or lo)
  static constexpr int kKBox = kKeys * kRowBytes;   // 32 columns of K
  static constexpr int kVBox = D * kRowBytes;       // 32 keys of V^T
  static constexpr int kPart = kKeys * D * 4;  // K_hi, K_lo, V^T_hi or V^T_lo
  static constexpr int kKV = 2 * kQBytes;
  static constexpr int kBars = kKV + kRing * 4 * kPart;
  // a stage's K freed once the logits have read it, and V loaded by a
  // second producer thread (one empty barrier a stage for each): at d =
  // 128's one stage the next tile's K then loads under this tile's softmax
  // and P V, and its V under the next logits
  static constexpr bool kFreeKApart = D == 128;
  // q_full, then k_full, v_full, the K (and V) empty barriers of each stage
  static constexpr int kSmemBytes =
      kBars + 8 * (1 + (kFreeKApart ? 4 : 3) * kRing) + 1024;
  // registers a consumer thread after the hand-over (one consumer: none)
  static constexpr bool kHandOver = kNC > 1;
  static constexpr int kConsumerRegs = 160;
  static_assert(kSmemBytes <= 232448, "over a block's shared memory");
};

// Pre-scale `bytes` of f32 Q in shared memory and split each value: hi in
// place, lo at the same offset in `lo`, `threads` threads from thread t.
__device__ __forceinline__ void prescale_split(unsigned char* hi,
                                               unsigned char* lo, int bytes,
                                               float scale, int t,
                                               int threads) {
  for (int i = t * 16; i < bytes; i += threads * 16) {
    float4 x = *reinterpret_cast<float4*>(hi + i);
    float4 h, l;
    split_tf32(x.x * scale, h.x, l.x);
    split_tf32(x.y * scale, h.y, l.y);
    split_tf32(x.z * scale, h.z, l.z);
    split_tf32(x.w * scale, h.w, l.w);
    *reinterpret_cast<float4*>(hi + i) = h;
    *reinterpret_cast<float4*>(lo + i) = l;
  }
}

// One block a (b*h, q-tile) tile; with LSE also lse ([B*H, tq] f32).
template <int D, bool LSE>
__global__ void __launch_bounds__(Tf32Plan<D>::kThreads, 1)
flash_fwd_tf32(__grid_constant__ const CUtensorMap q_map,
               __grid_constant__ const CUtensorMap khi_map,
               __grid_constant__ const CUtensorMap klo_map,
               __grid_constant__ const CUtensorMap vthi_map,
               __grid_constant__ const CUtensorMap vtlo_map,
               float* __restrict__ o, float* __restrict__ lse, int tq, int tk,
               float scale) {
  using P = Tf32Plan<D>;
  constexpr int kSteps = P::kKeys / 8;  // k8 steps of P V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + P::kRing;
  uint64_t* kv_empty = v_full + P::kRing;   // K's alone with kFreeKApart
  uint64_t* v_empty = kv_empty + P::kRing;  // kFreeKApart only

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * P::kRowsQ, h = blockIdx.y;
  const int n_kt = (tk + P::kKeys - 1) / P::kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < P::kRing; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], P::kConsumers);
      if constexpr (P::kFreeKApart) mbar_init(&v_empty[s], P::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread starts every copy (kFreeKApart:
    // thread 0 Q and K, thread 32 V)
    if constexpr (P::kHandOver) setmaxnreg_dec<24>();
    auto load_v = [&](int kt) {
      const int s = kt % P::kRing, k0 = kt * P::kKeys;
      unsigned char* st = smem + P::kKV + s * 4 * P::kPart;
      mbar_expect_tx(&v_full[s], 2 * P::kPart);
      for (int b = 0; b < P::kKeys / kBoxF32; ++b) {
        tma_load(st + 2 * P::kPart + b * P::kVBox, &vthi_map, &v_full[s],
                 k0 + b * kBoxF32, 0, h);
        tma_load(st + 3 * P::kPart + b * P::kVBox, &vtlo_map, &v_full[s],
                 k0 + b * kBoxF32, 0, h);
      }
    };
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, P::kQBytes);
      for (int b = 0; b < P::kBoxes; ++b)
        tma_load(smem + b * P::kQBox, &q_map, q_full, b * kBoxF32, q0, h);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % P::kRing, k0 = kt * P::kKeys;
        mbar_wait(&kv_empty[s], ((kt / P::kRing) & 1) ^ 1);
        unsigned char* st = smem + P::kKV + s * 4 * P::kPart;
        mbar_expect_tx(&k_full[s], 2 * P::kPart);
        for (int b = 0; b < P::kBoxes; ++b) {
          tma_load(st + b * P::kKBox, &khi_map, &k_full[s], b * kBoxF32, k0,
                   h);
          tma_load(st + P::kPart + b * P::kKBox, &klo_map, &k_full[s],
                   b * kBoxF32, k0, h);
        }
        if constexpr (!P::kFreeKApart) load_v(kt);
      }
    } else if (P::kFreeKApart && threadIdx.x == 32) {
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&v_empty[kt % P::kRing], ((kt / P::kRing) & 1) ^ 1);
        load_v(kt);
      }
    }
    return;
  }

  if constexpr (P::kHandOver) setmaxnreg_inc<P::kConsumerRegs>();
  const int c = wg - 1;  // this warpgroup's rows: q0 + 64c .. + 63
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const uint32_t qhi_addr = smem_u32(smem) + c * 64 * kRowBytes;
  const uint32_t qlo_addr = qhi_addr + P::kQBytes;

  // each consumer pre-scales and splits its own Q rows
  mbar_wait(q_full, 0);
  for (int b = 0; b < P::kBoxes; ++b) {
    unsigned char* rows = smem + b * P::kQBox + c * 64 * kRowBytes;
    prescale_split(rows, rows + P::kQBytes, 64 * kRowBytes, scale, t, 128);
  }
  fence_proxy_async();
  bar_sync(1 + c, 128);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % P::kRing;
    const uint32_t parity = (kt / P::kRing) & 1;
    const uint32_t khi = smem_u32(smem + P::kKV + s * 4 * P::kPart);
    const uint32_t klo = khi + P::kPart;
    const uint32_t vthi = khi + 2 * P::kPart, vtlo = khi + 3 * P::kPart;

    // S = Q_hi K_lo + Q_lo K_hi + Q_hi K_hi over kKeys keys, the small
    // terms first: D / 8 k8 steps each, four to a 32-column box.
    float sc[P::kKeys / 2];
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const uint32_t qa = pass == 1 ? qlo_addr : qhi_addr;
      const uint32_t kb = pass == 0 ? klo : khi;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t qd = desc128(qa + (kk / 4) * P::kQBox + off, 16);
        const uint64_t kd = desc128(kb + (kk / 4) * P::kKBox + off, 16);
        wgmma_ss_tf32_n64(sc, qd, kd, pass > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if constexpr (P::kFreeKApart) mbar_arrive(&kv_empty[s]);

    float alpha[2];
    softmax_step<P::kKeys>(sc, kt * P::kKeys, tk, tg, m_run, l_run, alpha);

    // pv = P_lo V_hi + P_hi V_lo + P_hi V_hi: kKeys / 8 k8 steps of 8 keys
    // each, the A fragment in V^T's permuted key order; a fresh
    // accumulator, added to O on the FMA pipes below.
    uint32_t p_hi[kSteps][4], p_lo[kSteps][4];
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float hi, lo;
        split_tf32(sc[a_frag_index(j, e)], hi, lo);
        p_hi[j][e] = __float_as_uint(hi);
        p_lo[j][e] = __float_as_uint(lo);
      }
    fence_regs(p_hi);
    fence_regs(p_lo);
    float pv[D / 2];
    mbar_wait(&v_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
      const uint32_t vb = pass == 1 ? vtlo : vthi;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint64_t vd =
            desc128(vb + (kk / 4) * P::kVBox + (kk % 4) * 32, 16);
        if constexpr (D == 64) {
          wgmma_rs_tf32_n64(pv, pass == 0 ? p_lo[kk] : p_hi[kk], vd,
                            pass > 0 || kk > 0);
        } else {
          wgmma_rs_tf32_n128(pv, pass == 0 ? p_lo[kk] : p_hi[kk], vd,
                             pass > 0 || kk > 0);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
    fence_regs(p_hi);
    fence_regs(p_lo);
    mbar_arrive(P::kFreeKApart ? &v_empty[s] : &kv_empty[s]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
  }

  const int r = q0 + 64 * c + 16 * warp + g;
  store_rows_f32(acc, o + (size_t)h * tq * D, D, r, tq, tg, l_run);
  if constexpr (LSE) store_lse(lse + (size_t)h * tq, r, tq, tg, m_run, l_run);
}

// ---------------------------------------------------------------------------
// f32, d = 512, on TF32 tensor cores in three passes (mma.sync)
// ---------------------------------------------------------------------------

constexpr int kRowsF512 = 32;     // query rows a block
constexpr int kKeysF512 = 32;     // keys a tile
constexpr int kWarpsF512 = 8;     // each owns 64 head-dim columns
constexpr int kThreadsF512 = 32 * kWarpsF512;

struct F512Plan {
  static constexpr int kLdQK = 512 + 4;  // Q, K row stride (floats)
  static constexpr int kLdV = 512 + 8;   // V row stride
  static constexpr int kK = kRowsF512 * kLdQK * 4;          // Q at 0: 64.5 KB
  static constexpr int kV = kK + kKeysF512 * kLdQK * 4;     // K: 64.5 KB
  static constexpr int kX = kV + kKeysF512 * kLdV * 4;      // V: 65 KB
  // the warps' partial S fragments [warp][m-tile][n-tile][lane] (float4),
  // then P's hi and lo A fragments [8-key step][m-tile][lane] in its first
  // 8 KB: 32 KB
  static constexpr int kXBytes = kWarpsF512 * 2 * 4 * 32 * 16;
  static constexpr int kRow = kX + kXBytes;  // alpha[32], then l[32]
  static constexpr int kSmemBytes = kRow + 2 * kRowsF512 * 4;  // 231,680
};
static_assert(F512Plan::kSmemBytes <= 232448, "over a block's shared memory");

// D[16x8] += A[16x8] B[8x8] in TF32 (mma.sync; A row-major, B column-major
// fragments in registers): a0 = A[g][tg], a1 = A[g + 8][tg], a2 = A[g][tg +
// 4], a3 = A[g + 8][tg + 4]; b0 = B[tg][g], b1 = B[tg + 4][g]; d0, d1 =
// D[g][2tg, 2tg + 1], d2, d3 = D[g + 8][2tg, 2tg + 1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo exactly, hi = x with its 13 low mantissa bits cleared (a TF32
// value, x truncated), lo = x - hi; the tensor core reads lo's top 10
// mantissa bits (it ignores the 13 low bits of a TF32 operand, truncating
// lo as well).
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 16 bytes from device memory to shared memory, zeros where !valid.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// One key tile into shared memory by cp.async (one group): K rows in key
// order, or (PERM) V rows with each group of 8 keys permuted by perm8.
template <bool PERM>
__device__ __forceinline__ void load_kv_f512(float* dst, const float* src,
                                             int k0, int tk, int ld) {
  for (int i = threadIdx.x; i < kKeysF512 * 128; i += kThreadsF512) {
    const int r = i / 128, c = (i % 128) * 4;
    const int key = k0 + (PERM ? (r & ~7) + perm8(r & 7) : r);
    const bool ok = key < tk;
    cp_async16_zfill(dst + r * ld + c, src + (ok ? (size_t)key * 512 + c : 0),
                     ok);
  }
  cp_async_commit();
}

// One block a (b*h, 32 query rows) tile, 8 warps.
__global__ void __launch_bounds__(kThreadsF512, 1)
flash_fwd_f32_d512(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int tq,
                   int tk, float scale) {
  using P = F512Plan;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = reinterpret_cast<float*>(smem + P::kK);
  float* sV = reinterpret_cast<float*>(smem + P::kV);
  float4* sX = reinterpret_cast<float4*>(smem + P::kX);
  uint4* sPhi = reinterpret_cast<uint4*>(smem + P::kX);
  uint4* sPlo = sPhi + 4 * 2 * 32;
  float* sAlpha = reinterpret_cast<float*>(smem + P::kRow);
  float* sL = sAlpha + kRowsF512;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int q0 = blockIdx.x * kRowsF512;
  const float* kb = k + (size_t)blockIdx.y * tk * 512;
  const float* vb = v + (size_t)blockIdx.y * tk * 512;
  const int n_kt = (tk + kKeysF512 - 1) / kKeysF512;

  load_kv_f512<false>(sK, kb, 0, tk, P::kLdQK);
  load_kv_f512<true>(sV, vb, 0, tk, P::kLdV);
  // Q, pre-scaled in f32; rows >= tq zero
  for (int i = threadIdx.x; i < kRowsF512 * 128; i += kThreadsF512) {
    const int r = i / 128, c = (i % 128) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < tq) {
      x = *reinterpret_cast<const float4*>(
          q + ((size_t)blockIdx.y * tq + q0 + r) * 512 + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(sQ + r * P::kLdQK + c) = x;
  }

  // The softmax's share of this thread: S rows r0 = 16 mt + g and r0 + 8,
  // keys 8 nt + 2 tg + (0, 1) of each tile: the sum of the warps' partial
  // fragments (mt, nt) at lane sl; the 16 threads of a row pair are 16
  // consecutive lanes of one warp.
  const int smt = threadIdx.x / 128, sg = (threadIdx.x / 16) % 8;
  const int snt = (threadIdx.x / 4) % 4, stg = threadIdx.x % 4;
  const int sl = sg * 4 + stg;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  float acc[2][8][4];  // O rows 16 mt + g (+ 8), columns 64 warp + 8 nt + 2 tg
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<1>();  // K(kt) (and Q's stores) done; V(kt) may be in flight
    __syncthreads();

    // This warp's partial S over head-dim columns 64 warp .. + 63: 8 k8
    // steps, Q_lo K_hi + Q_hi K_lo + Q_hi K_hi each.
    {
      float sp[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sp[mt][nt][e] = 0.f;
      const float* qw = sQ + g * P::kLdQK + 64 * warp + tg;
      const float* kw = sK + g * P::kLdQK + 64 * warp + tg;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* p = qw + 16 * mt * P::kLdQK + 8 * kk;
          split_trunc(p[0], ah[mt][0], al[mt][0]);
          split_trunc(p[8 * P::kLdQK], ah[mt][1], al[mt][1]);
          split_trunc(p[4], ah[mt][2], al[mt][2]);
          split_trunc(p[8 * P::kLdQK + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* p = kw + 8 * nt * P::kLdQK + 8 * kk;
          uint32_t bh0, bl0, bh1, bl1;
          split_trunc(p[0], bh0, bl0);
          split_trunc(p[4], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(sp[mt][nt], al[mt], bh0, bh1);
            mma_tf32(sp[mt][nt], ah[mt], bl0, bl1);
            mma_tf32(sp[mt][nt], ah[mt], bh0, bh1);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          sX[((warp * 2 + mt) * 4 + nt) * 32 + lane] = make_float4(
              sp[mt][nt][0], sp[mt][nt][1], sp[mt][nt][2], sp[mt][nt][3]);
    }
    __syncthreads();  // K(kt) read, the partials written
    if (kt + 1 < n_kt) {
      load_kv_f512<false>(sK, kb, (kt + 1) * kKeysF512, tk, P::kLdQK);
    } else {
      cp_async_commit();
    }

    // S = the partials summed in warp order (the same order for every
    // element), then the online softmax of rows r0 and r0 + 8.
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kWarpsF512; ++w) {
      const float4 x = sX[((w * 2 + smt) * 4 + snt) * 32 + sl];
      s[0] += x.x;
      s[1] += x.y;
      s[2] += x.z;
      s[3] += x.w;
    }
    const int key = kt * kKeysF512 + 8 * snt + 2 * stg;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key + (e & 1) >= tk) s[e] = -INFINITY;
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(s[2 * h], s[2 * h + 1]);
#pragma unroll
      for (int x = 1; x < 16; x *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m_run[h], mx);
      alpha[h] = exp2_ftz(m_run[h] - m_new);
      m_run[h] = m_new;
      s[2 * h] = exp2_ftz(s[2 * h] - m_new);
      s[2 * h + 1] = exp2_ftz(s[2 * h + 1] - m_new);
      float sum = s[2 * h] + s[2 * h + 1];
#pragma unroll
      for (int x = 1; x < 16; x *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, x);
      l_run[h] = alpha[h] * l_run[h] + sum;
    }
    __syncthreads();  // every partial read before P overwrites them
    // P's A fragment of (8-key step snt, m-tile smt) at lane sl, in V's
    // permuted key order: {P[r0][2tg], P[r0 + 8][2tg], P[r0][2tg + 1],
    // P[r0 + 8][2tg + 1]}, split into hi and lo
    {
      uint4 hi, lo;
      split_trunc(s[0], hi.x, lo.x);
      split_trunc(s[2], hi.y, lo.y);
      split_trunc(s[1], hi.z, lo.z);
      split_trunc(s[3], hi.w, lo.w);
      sPhi[(snt * 2 + smt) * 32 + sl] = hi;
      sPlo[(snt * 2 + smt) * 32 + sl] = lo;
      if (snt == 0 && stg == 0) {
        sAlpha[16 * smt + sg] = alpha[0];
        sAlpha[16 * smt + sg + 8] = alpha[1];
      }
    }
    cp_async_wait<1>();  // V(kt) done; K(kt + 1) may be in flight
    __syncthreads();

    // O columns 64 warp .. + 63: per 8-column n-tile, P V over the 32 keys
    // (P_lo V_hi + P_hi V_lo + P_hi V_hi) into a fresh accumulator, then O
    // = alpha O + PV on the FMA pipes.
    {
      uint32_t ph[4][2][4], pl[4][2][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint4 h = sPhi[(ks * 2 + mt) * 32 + lane];
          const uint4 l = sPlo[(ks * 2 + mt) * 32 + lane];
          ph[ks][mt][0] = h.x, ph[ks][mt][1] = h.y, ph[ks][mt][2] = h.z,
          ph[ks][mt][3] = h.w;
          pl[ks][mt][0] = l.x, pl[ks][mt][1] = l.y, pl[ks][mt][2] = l.z,
          pl[ks][mt][3] = l.w;
        }
      float a[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) a[mt][h] = sAlpha[16 * mt + g + 8 * h];
      const float* vw = sV + tg * P::kLdV + 64 * warp + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float pv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const float* p = vw + 8 * ks * P::kLdV + 8 * nt;
          uint32_t bh0, bl0, bh1, bl1;
          split_trunc(p[0], bh0, bl0);
          split_trunc(p[4 * P::kLdV], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(pv[mt], pl[ks][mt], bh0, bh1);
            mma_tf32(pv[mt], ph[ks][mt], bl0, bl1);
            mma_tf32(pv[mt], ph[ks][mt], bh0, bh1);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] = fmaf(acc[mt][nt][e], a[mt][e >> 1], pv[mt][e]);
      }
    }
    __syncthreads();  // V(kt), P and alpha read
    if (kt + 1 < n_kt) {
      load_kv_f512<true>(sV, vb, (kt + 1) * kKeysF512, tk, P::kLdV);
    } else {
      cp_async_commit();
    }
  }

  if (snt == 0 && stg == 0) {
    sL[16 * smt + sg] = l_run[0];
    sL[16 * smt + sg + 8] = l_run[1];
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + g + 8 * h;
      if (q0 + r >= tq) continue;
      const float l = sL[r];
      float* row = o + ((size_t)blockIdx.y * tq + q0 + r) * 512 + 64 * warp +
                   2 * tg;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(row + 8 * nt) = make_float2(
            acc[mt][nt][2 * h] / l, acc[mt][nt][2 * h + 1] / l);
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Launch flash_fwd_tf32<D, LSE> and its pre-pass; scratch holds K_hi,
// K_lo ([B*H, tk, D]), V^T_hi and V^T_lo ([B*H, D, tp]).
template <int D, bool LSE>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        float* lse, void* scratch, int bh, int tq, int tk,
                        float scale, cudaStream_t s) {
  using P = Tf32Plan<D>;
  static std::atomic<unsigned long long> smem_set{0};
  const int tp = (tk + 7) / 8 * 8;
  float* k_hi = static_cast<float*>(scratch);
  float* k_lo = k_hi + (size_t)bh * tk * D;
  float* vt_hi = k_lo + (size_t)bh * tk * D;
  float* vt_lo = vt_hi + (size_t)bh * D * tp;
  CUtensorMap q_map, khi_map, klo_map, vthi_map, vtlo_map;
  cudaError_t err = make_map(&q_map, q, true, bh, tq, D, P::kRowsQ);
  if (err == cudaSuccess)
    err = make_map(&khi_map, k_hi, true, bh, tk, D, P::kKeys);
  if (err == cudaSuccess)
    err = make_map(&klo_map, k_lo, true, bh, tk, D, P::kKeys);
  if (err == cudaSuccess)
    err = make_map(&vthi_map, vt_hi, true, bh, D, tp, D);
  if (err == cudaSuccess)
    err = make_map(&vtlo_map, vt_lo, true, bh, D, tp, D);
  if (err == cudaSuccess)
    err = allow_smem_once(flash_fwd_tf32<D, LSE>, P::kSmemBytes, &smem_set);
  if (err != cudaSuccess) return err;
  SplitJobs jobs{};
  jobs.job[0] = {static_cast<const float*>(k), k_hi, nullptr, tk, tp};
  jobs.job[1] = {static_cast<const float*>(v), nullptr, vt_hi, tk, tp};
  err = launch_split_tf32<D>(jobs, 2, bh, s);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + P::kRowsQ - 1) / P::kRowsQ, bh);
  flash_fwd_tf32<D, LSE><<<grid, P::kThreads, P::kSmemBytes, s>>>(
      q_map, khi_map, klo_map, vthi_map, vtlo_map, static_cast<float*>(o), lse,
      tq, tk, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous [B*H, T, D] device buffers of the route's dtype,
// 16-byte aligned; scale = d^-0.5*log2(e). Each returns a cudaError_t; 0
// means launched.

// K1, bf16 d 64/128.
extern "C" int sdxl_flash_attention_bf16(const void* q, const void* k,
                                         const void* v, void* o, int bh,
                                         int tq, int tk, int d, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_k1<64, false>(q, k, v, o, nullptr, bh, tq, tk, scale, s);
  if (d == 128)
    return launch_k1<128, false>(q, k, v, o, nullptr, bh, tq, tk, scale, s);
  return cudaErrorInvalidValue;
}

// K2: K1's bf16 d 64/128 output and lse ([B*H, tq] f32 device buffer).
extern "C" int sdxl_flash_attention_lse_bf16(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int bh, int tq,
                                             int tk, int d, float scale,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (d == 64)
    return launch_k1<64, true>(q, k, v, o, l, bh, tq, tk, scale, s);
  if (d == 128)
    return launch_k1<128, true>(q, k, v, o, l, bh, tq, tk, scale, s);
  return cudaErrorInvalidValue;
}

// K1, bf16 d 512.
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

// K1, f32 d 64 (3xTF32). scratch: a device buffer of 2 * B*H * d * (tk +
// tp) floats, tp = tk rounded up to a multiple of 8, for the pre-pass's
// K_hi, K_lo, V^T_hi and V^T_lo.
extern "C" int sdxl_flash_attention_f32_d64(const void* q, const void* k,
                                            const void* v, void* o,
                                            void* scratch, int bh, int tq,
                                            int tk, int d, float scale,
                                            void* stream) {
  if (d != 64) return cudaErrorInvalidValue;
  return launch_tf32<64, false>(q, k, v, o, nullptr, scratch, bh, tq, tk,
                                scale, static_cast<cudaStream_t>(stream));
}

// K2, f32 d 64: K1's f32 d=64 output and lse ([B*H, tq] f32), scratch as
// above.
extern "C" int sdxl_flash_attention_lse_f32_d64(const void* q, const void* k,
                                                const void* v, void* o,
                                                void* lse, void* scratch,
                                                int bh, int tq, int tk, int d,
                                                float scale, void* stream) {
  if (d != 64) return cudaErrorInvalidValue;
  return launch_tf32<64, true>(q, k, v, o, static_cast<float*>(lse), scratch,
                               bh, tq, tk, scale,
                               static_cast<cudaStream_t>(stream));
}

// K1, f32 d 128 (3xTF32), scratch as above.
extern "C" int sdxl_flash_attention_f32_d128(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* scratch, int bh, int tq,
                                             int tk, int d, float scale,
                                             void* stream) {
  if (d != 128) return cudaErrorInvalidValue;
  return launch_tf32<128, false>(q, k, v, o, nullptr, scratch, bh, tq, tk,
                                 scale, static_cast<cudaStream_t>(stream));
}

// K2, f32 d 128: K1's f32 d=128 output and lse, scratch as above.
extern "C" int sdxl_flash_attention_lse_f32_d128(const void* q, const void* k,
                                                 const void* v, void* o,
                                                 void* lse, void* scratch,
                                                 int bh, int tq, int tk,
                                                 int d, float scale,
                                                 void* stream) {
  if (d != 128) return cudaErrorInvalidValue;
  return launch_tf32<128, true>(q, k, v, o, static_cast<float*>(lse), scratch,
                                bh, tq, tk, scale,
                                static_cast<cudaStream_t>(stream));
}

// K1, f32 d 512 (3xTF32 on mma.sync).
extern "C" int sdxl_flash_attention_f32_d512(const void* q, const void* k,
                                             const void* v, void* o, int bh,
                                             int tq, int tk, int d,
                                             float scale, void* stream) {
  if (d != 512) return cudaErrorInvalidValue;
  constexpr int smem = F512Plan::kSmemBytes;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(flash_fwd_f32_d512, smem, &smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + kRowsF512 - 1) / kRowsF512, bh);
  flash_fwd_f32_d512<<<grid, kThreadsF512, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), tq, tk, scale);
  return cudaGetLastError();
}

// The dynamic shared memory a kernel of this file launches with (for the
// build report), by its index and its leading int template arguments:
// kernel 0 flash_fwd_wgmma<d, nc, bk, ...>, 1 flash_fwd_d512, 2
// flash_fwd_tf32<d, ...>, 3 flash_fwd_f32_d512; 0 for any other.
extern "C" int flash_hopper_smem_bytes(int kernel, int d, int nc, int bk) {
  if (kernel == 0) return fwd_smem_bytes(d, nc, bk);
  if (kernel == 1) return D512Plan::kSmemBytes;
  if (kernel == 2 && d == 64) return Tf32Plan<64>::kSmemBytes;
  if (kernel == 2 && d == 128) return Tf32Plan<128>::kSmemBytes;
  if (kernel == 3) return F512Plan::kSmemBytes;
  return 0;
}
