"""Design probes of the f32 flash kernels in csrc/flash_hopper.cu, on the
card: each variant is the source with one edit, built into its own library
beside the kernels' and timed in turns against the kernel as it is.

  k2_nc2          K2 f32 d=64 (`flash_fwd_tf32<64, true>`) with two
                  consumer warpgroups (128-row tiles) in place of three,
                  at the training path's batch-1 shapes;
  d64_k_apart     K1 and K2 f32 d=64 with d=128's release of a stage: K
                  freed once the logits have read it and V loaded by a
                  second producer thread, in place of K and V freed
                  together after P V (timed at K1's and K2's d=64 shapes);
  d128_turns      K1 f32 d=128 (`flash_fwd_tf32<128, false>`) with two
                  consumer warpgroups that take turns at two 32-key stages
                  over the block's 64 rows, each with its own m, l and O,
                  merged at the end through the second's stage in a fixed
                  order (FlashAttention-3's ping-pong between
                  warpgroups), in place of one consumer and one 64-key
                  stage;
  d128_k32        K1 f32 d=128 with one consumer and two 32-key stages;
  d128_kv_freed   the kept kernel with the stage's K freed together with
                  its V after P V, both loaded by one producer thread, in
                  place of K freed once the logits have read it and V
                  loaded by a second thread (so that the next K loads under
                  the softmax and P V, the next V under the next logits);
  d128_no_softmax the kept kernel without its softmax (the logits go to
                  P V as they are; alpha and l stay 1), so base -
                  d128_no_softmax is what the softmax adds;
  d128_no_s       the kept kernel without the products of S (K still
                  loaded and waited for), and
  d128_no_pv      without the products of P V (V still loaded and waited
                  for): what each product adds on top of the rest;
  d128_tail       the kept kernel with its key mask left out (keys past tk
                  get logit 0 in place of -inf): a planted fault that K1's
                  card checks must catch;
  d512_pass1      K1 f32 d=512 (`flash_fwd_f32_d512`) with one TF32 pass of
                  each product in place of three (its error printed);
  d512_no_s       the same kernel without the products of S (the operands
                  still loaded and split);
  d512_no_pv      the same kernel without the products of P V.

base - d512_pass1 is the cost of two thirds of the tensor-core products,
base - d512_no_s and base - d512_no_pv what each product adds on top of
the rest of the kernel (loads, splits, the partial-S reduction, the
softmax, the barriers). The d=128 variants run at [1,24,4608,128] (an f32
Flux-dev forward's joint attention at 1024x1024) and [1,2,1000,128]; each
correct variant's relative L2 error against the plain version is printed,
and d128_tail is also held to chip_smoke.py's K1 limits at [1,3,333,128]
and [1,2,1000,128]. The d=128 times are per call inside one CUDA graph of
20 calls, in turns.

Run on the card: python -m sdxl_tpu_torch.scripts.probe_f32_kernels
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess

import torch

from ..ops import flash_attention as fa
from .exp_flash_exp2 import require_card
from .timing import graph_time, timeit

_S_PRODUCTS = """\
            mma_tf32(sp[mt][nt], al[mt], bh0, bh1);
            mma_tf32(sp[mt][nt], ah[mt], bl0, bl1);
            mma_tf32(sp[mt][nt], ah[mt], bh0, bh1);"""
_PV_PRODUCTS = """\
            mma_tf32(pv[mt], pl[ks][mt], bh0, bh1);
            mma_tf32(pv[mt], ph[ks][mt], bl0, bl1);
            mma_tf32(pv[mt], ph[ks][mt], bh0, bh1);"""
_TF32_CONSUMERS = "static constexpr int kNC = D == 64 ? 3 : 1;"
_TF32_REGISTERS = "static constexpr int kConsumerRegs = 160;"
_TF32_PLAN = """\
  static constexpr int kNC = D == 64 ? 3 : 1;
  static constexpr int kKeys = 64;               // keys a stage
  static constexpr int kRing = D == 64 ? 2 : 1;  // stages
  static constexpr int kThreads = 128 * (kNC + 1);
  static constexpr int kConsumers = 128 * kNC;
  static constexpr int kRowsQ = 64 * kNC;"""
_TF32_KEYS = "static constexpr int kKeys = 64;               // keys a stage"
_TF32_RING = "static constexpr int kRing = D == 64 ? 2 : 1;  // stages"
_TF32_ROWS = "  const int c = wg - 1;  // this warpgroup's rows: q0 + 64c .. + 63"
_TF32_SPLIT_Q = """\
    prescale_split(rows, rows + P::kQBytes, 64 * kRowBytes, scale, t, 128);
  }
  fence_proxy_async();
  bar_sync(1 + c, 128);"""
_TF32_LOOP = """\
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % P::kRing;"""
_TF32_STORE = "  const int r = q0 + 64 * c + 16 * warp + g;"
_TF32_FREE_K = "static constexpr bool kFreeKApart = D == 128;"
_TF32_S_BY_KEYS = """\
        if constexpr (P::kKeys == 64) {
          wgmma_ss_tf32_n64(sc, qd, kd, pass > 0 || kk > 0);
        } else {
          wgmma_ss_tf32_n32(sc, qd, kd, pass > 0 || kk > 0);
        }"""
# the second consumer's O, m and l reach the first through the second's own
# stage (whose every load it has consumed), and the first merges them into
# its own in that order: m = max(m0, m1), each side rescaled by 2^(m_i - m)
_TF32_MERGE = """\
  if constexpr (P::kTurns > 1) {
    static_assert((D / 2 + 4) * 128 * 4 <= 4 * P::kPart, "merge fits");
    float* red = reinterpret_cast<float*>(smem + P::kKV + 4 * P::kPart);
    if (turn == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) red[i * 128 + t] = acc[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        red[(D / 2 + r) * 128 + t] = m_run[r];
        red[(D / 2 + 2 + r) * 128 + t] = l_run[r];
      }
    }
    bar_sync(2, 128 * P::kTurns);
    if (turn == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = red[(D / 2 + r) * 128 + t];
      const float m = fmaxf(m_run[r], m1);
      a0[r] = exp2_ftz(m_run[r] - m);
      a1[r] = exp2_ftz(m1 - m);
      l_run[r] = a0[r] * l_run[r] + a1[r] * red[(D / 2 + 2 + r) * 128 + t];
      m_run[r] = m;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      acc[i] = fmaf(acc[i], a0[(i >> 1) & 1],
                    a1[(i >> 1) & 1] * red[i * 128 + t]);
  }
"""
_TF32_SOFTMAX = """\
    softmax_step<P::kKeys>(sc, kt * P::kKeys, tk, tg, m_run, l_run, alpha);"""
_TF32_S = "        wgmma_ss_tf32_n64(sc, qd, kd, pass > 0 || kk > 0);"
_TF32_PV = """\
          wgmma_rs_tf32_n128(pv, pass == 0 ? p_lo[kk] : p_hi[kk], vd,
                             pass > 0 || kk > 0);"""

# variant -> [(text of flash_hopper.cu, its replacement)]; a product left
# out still reads its operands, so that the compiler keeps their loads
VARIANTS = {
    "k2_nc2": [(_TF32_CONSUMERS, _TF32_CONSUMERS.replace("3 : 1", "2 : 1")),
               (_TF32_REGISTERS, _TF32_REGISTERS.replace("160", "232"))],
    "d128_turns": [
        (_TF32_PLAN, """\
  static constexpr int kNC = D == 64 ? 3 : 2;
  static constexpr int kGroups = D == 64 ? 3 : 1;  // 64-row groups a block
  static constexpr int kTurns = kNC / kGroups;     // consumers a group
  static constexpr int kKeys = D == 64 ? 64 : 32;
  static constexpr int kRing = 2;
  static constexpr int kThreads = 128 * (kNC + 1);
  static constexpr int kConsumers = 128 * kGroups;  // readers of a stage
  static constexpr int kRowsQ = 64 * kGroups;"""),
        (_TF32_REGISTERS,
         _TF32_REGISTERS.replace("160", "kNC == 3 ? 160 : 240")),
        (_TF32_ROWS, "  const int c = P::kGroups > 1 ? wg - 1 : 0, "
                     "turn = P::kTurns > 1 ? wg - 1 : 0;"),
        (_TF32_SPLIT_Q, """\
    prescale_split(rows, rows + P::kQBytes, 64 * kRowBytes, scale,
                   turn * 128 + t, 128 * P::kTurns);
  }
  fence_proxy_async();
  bar_sync(1 + c, 128 * P::kTurns);"""),
        (_TF32_LOOP, _TF32_LOOP.replace(
            "kt = 0; kt < n_kt; ++kt", "kt = turn; kt < n_kt; kt += P::kTurns")),
        (_TF32_S, _TF32_S_BY_KEYS),
        (_TF32_STORE, _TF32_MERGE + _TF32_STORE)],
    "d128_k32": [
        (_TF32_KEYS, _TF32_KEYS.replace("= 64;", "= D == 64 ? 64 : 32;")),
        (_TF32_RING, _TF32_RING.replace("D == 64 ? 2 : 1;", "2;")),
        (_TF32_S, _TF32_S_BY_KEYS)],
    "d64_k_apart": [(_TF32_FREE_K, _TF32_FREE_K.replace("D == 128", "true"))],
    "d128_kv_freed": [(_TF32_FREE_K,
                       _TF32_FREE_K.replace("D == 128", "false"))],
    "d128_no_softmax": [(_TF32_SOFTMAX, """\
    alpha[0] = alpha[1] = l_run[0] = l_run[1] = 1.f;""")],
    "d128_no_s": [(_TF32_S, """\
        if (pass == 0 && kk == 0)
          for (int i = 0; i < P::kKeys / 2; ++i) sc[i] = 0.f;
        sc[kk % 32] += __uint_as_float((uint32_t)(qd ^ kd));""")],
    "d128_no_pv": [(_TF32_PV, """\
          if (pass == 0 && kk == 0)
            for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
          pv[kk] += __uint_as_float(p_lo[kk][0] ^ p_hi[kk][1] ^
                                    (uint32_t)vd);""")],
    "d128_tail": [(_TF32_SOFTMAX,
                   _TF32_SOFTMAX.replace("tk, tg", "1 << 30, tg"))],
    "d512_pass1": [
        (_S_PRODUCTS, "            mma_tf32(sp[mt][nt], ah[mt], bh0, bh1);"),
        (_PV_PRODUCTS, "            mma_tf32(pv[mt], ph[ks][mt], bh0, bh1);")],
    "d512_no_s": [(_S_PRODUCTS, "            sp[mt][nt][0] += "
                   "__uint_as_float(ah[mt][0] ^ al[mt][1] ^ bh0 ^ bl1);")],
    "d512_no_pv": [(_PV_PRODUCTS, "            pv[mt][0] += __uint_as_float("
                    "ph[ks][mt][0] ^ pl[ks][mt][1] ^ bh0 ^ bl1);")],
}
D128_TIMED = ("d128_turns", "d128_k32", "d128_kv_freed", "d128_no_softmax",
              "d128_no_s", "d128_no_pv")
D128_WRONG = ("d128_no_softmax", "d128_no_s", "d128_no_pv")  # not attention
D128_SHAPES = [(1, 24, 4608, 128), (1, 2, 1000, 128)]
# the planted tail's cases and K1's f32 limits there (chip_smoke.py):
# max abs error within 1e-3 of min(1, max|o|), relative L2 within 1e-4
TAIL_SHAPES = [(1, 3, 333, 128), (1, 2, 1000, 128)]
K1_F32_TOL, K1_F32_REL_TOL = 1e-3, 1e-4
GRAPH_CALLS = 20
K2_SHAPES = [(1, 10, 4096, 64), (1, 20, 1024, 64)]
K1_D64_SHAPES = [(2, 10, 4096, 64), (2, 20, 1024, 64)]
D512_SHAPE = (1, 1, 16384, 512)


def variant_sources(source: str = "flash_hopper.cu",
                    variants: dict = VARIANTS) -> dict:
    """{variant: `source` (a file of csrc/) with the variant's edits}."""
    src = (fa.CSRC / source).read_text()
    sources = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edited text is not in "
                                   f"{source} once")
            text = text.replace(old, new)
        sources[name] = text
    return sources


def build_variants(source: str = "flash_hopper.cu",
                   variants: dict = VARIANTS) -> dict:
    """{variant: its library}, one nvcc per variant, all started together,
    into build/kernels/probe/."""
    out = fa.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, text in variant_sources(source, variants).items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *fa.NVCC_FLAGS, "-I", str(fa.CSRC),
             "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def bind_export(lib, name: str, n_ptr: int, n_float: int = 1):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    return fn


def variant_k2(lib, q, k, v):
    """K2 f32 d=64 (o, lse) from a variant's library."""
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    scratch = fa._tf32_scratch(b * h, t, d, q.device)
    err = bind_export(lib, "sdxl_flash_attention_lse_f32_d64", 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), b * h, t, t, d,
        d ** -0.5 * fa._LOG2E, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return o, lse


def variant_k1(lib, q, k, v):
    """K1 f32 d=64 or d=128 from a variant's library."""
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    scratch = fa._tf32_scratch(b * h, t, d, q.device)
    err = bind_export(lib, f"sdxl_flash_attention_f32_d{d}", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        scratch.data_ptr(), b * h, t, t, d, d ** -0.5 * fa._LOG2E,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return o


def variant_d512(lib, q, k, v):
    """K1 f32 d=512 from a variant's library."""
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    err = bind_export(lib, "sdxl_flash_attention_f32_d512", 4)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, t, t,
        d, d ** -0.5 * fa._LOG2E, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return o


def in_turns(fns: dict, iters: int, graph: bool = False) -> dict:
    """ms per call of each function, timed in turns (a, b, ..., b, a): by
    CUDA events over `iters` calls, or (graph) inside one CUDA graph of
    GRAPH_CALLS calls replayed `iters` times."""
    order = list(fns) + list(fns)[::-1]
    times = {name: [] for name in fns}
    for name in order:
        if graph:
            f = fns[name]
            ms = graph_time(lambda: [f() for _ in range(GRAPH_CALLS)],
                            iters) * 1e3 / GRAPH_CALLS
        else:
            ms = timeit(fns[name], iters=iters) * 1e3
        times[name].append(ms)
    return times


def random_qkv(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda") for _ in range(3)]


def readings(o, ref):
    """(max abs error, its limit, relative L2 error) against K1's f32
    limits."""
    diff = (o - ref).float()
    limit = K1_F32_TOL * min(1.0, ref.abs().max().item())
    return (diff.abs().max().item(), limit,
            (diff.norm() / ref.norm()).item())


def probe_d128(libs) -> dict:
    """The d=128 variants' errors and times beside the kernel's, and the
    planted tail against K1's limits."""
    rows = {}
    for shape in D128_SHAPES:
        q, k, v = random_qkv(shape, 42)
        ref = fa.flash_attention_plain(q, k, v)
        errs = {name: readings(variant_k1(libs[name], q, k, v), ref)[2]
                for name in D128_TIMED if name not in D128_WRONG}
        errs["base"] = readings(fa.flash_attention_bhtd(q, k, v), ref)[2]
        fns = {"base": lambda: fa.flash_attention_bhtd(q, k, v)}
        fns.update({name: functools.partial(variant_k1, libs[name], q, k,
                                            v) for name in D128_TIMED})
        rows[shape] = in_turns(fns, 5, graph=True)
        print(f"K1 f32 {shape}: relative L2 {errs}; graph ms {rows[shape]}",
              flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()
    for shape in TAIL_SHAPES:
        q, k, v = random_qkv(shape, 42)
        ref = fa.flash_attention_plain(q, k, v)
        err, limit, rel = readings(variant_k1(libs["d128_tail"], q, k, v),
                                   ref)
        caught = not (err < limit and rel < K1_F32_REL_TOL)
        print(f"d128_tail {shape}: max abs error {err:.3e} (limit "
              f"{limit:.3e}), relative L2 {rel:.3e} (limit "
              f"{K1_F32_REL_TOL:g}): {'caught' if caught else 'NOT caught'}",
              flush=True)
    return rows


def main() -> dict:
    """Build the variants, print each one's times beside the kernel's;
    returns {shape: {variant: [ms, ...]}}."""
    require_card()
    fa.build_kernels()
    libs = build_variants()
    rows = {}
    k2_variants = ("k2_nc2", "d64_k_apart")
    for shape in K2_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(43)
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   for _ in range(3))
        ref_o, ref_lse = fa.flash_attention_lse_plain(q, k, v)
        for name in k2_variants:
            o, lse = variant_k2(libs[name], q, k, v)
            rel = ((o - ref_o).norm() / ref_o.norm()).item()
            lse_err = (lse - ref_lse).abs().max().item()
            print(f"K2 f32 {shape}: {name} o relative L2 {rel:.3e}, lse "
                  f"{lse_err:.3e}", flush=True)
        fns = {"base": lambda: fa.flash_attention_lse(q, k, v)}
        fns.update({name: functools.partial(variant_k2, libs[name], q, k, v)
                    for name in k2_variants})
        rows[shape] = in_turns(fns, 20)
        print(f"K2 f32 {shape}: ms {rows[shape]}", flush=True)
    for shape in K1_D64_SHAPES:
        q, k, v = random_qkv(shape, 42)
        rel = readings(variant_k1(libs["d64_k_apart"], q, k, v),
                       fa.flash_attention_plain(q, k, v))[2]
        rows[shape] = in_turns({
            "base": lambda: fa.flash_attention_bhtd(q, k, v),
            "d64_k_apart": functools.partial(
                variant_k1, libs["d64_k_apart"], q, k, v)}, 20)
        print(f"K1 f32 {shape}: d64_k_apart relative L2 {rel:.3e}; ms "
              f"{rows[shape]}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(42)
    q, k, v = (torch.randn(D512_SHAPE, generator=g, device="cuda")
               for _ in range(3))
    ref = fa.flash_attention_plain(q, k, v)
    o = variant_d512(libs["d512_pass1"], q, k, v)
    rel = ((o - ref).norm() / ref.norm()).item()
    fns = {"base": lambda: fa.flash_attention_bhtd(q, k, v)}
    fns.update({name: functools.partial(variant_d512, libs[name], q, k, v)
                for name in VARIANTS if name.startswith("d512")})
    rows[D512_SHAPE] = in_turns(fns, 5)
    print(f"K1 f32 {D512_SHAPE}: d512_pass1 relative L2 {rel:.3e}; ms "
          f"{rows[D512_SHAPE]}", flush=True)
    rows.update(probe_d128(libs))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return rows


if __name__ == "__main__":
    main()
