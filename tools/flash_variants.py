#!/usr/bin/env python3
"""Variants of the flash kernel's bf16 bodies, built and timed on one GPU.

Run from the repository root::

    python3 tools/flash_variants.py [--parent DIR] [--body mma]
                                    [--variants NAME ...]

Each variant is the committed ``csrc/flash_attention.cu`` with the edits
listed in ``VARIANTS`` (and, where ``KV_TILES`` names it, the wrapper's
key tile of a pair changed to match).  All are built at once, with the
repository's nvcc flags, into ``build/variants/``; each prints its ptxas
report, is held against the plain version at the bf16 shapes of
``chip_smoke.py`` phase 5 and at paligemma's served prefix-LM shape
(``||Δ|| <= 5e-3·||plain||``), and is then timed with CUDA events beside
``scaled_dot_product_attention`` (with the same boolean mask where the
shape has a prefix), every entry twice in turns (one order, then the
reverse; each reading queued behind a spin kernel, ``chip_smoke.
queued_ms``), at the served shape, at ``prefill_32k``, at two dh = 128
shapes, at minicpm3's MLA heads (dh 96, dv 64) and at paligemma's
(8, 320, 1 KV, G 8, dh = dv = 256, prefix 256).  With ``--parent DIR``
(an earlier commit unpacked by ``git archive``), that tree's own
wrapper, on its own source built here, is checked and timed in the same
turns (entry ``parent``).  With ``--body mma`` every bf16 call goes to the
mma body (the shape rule is replaced for the run, so aligned tensors take
its 16-byte loads, as a served call does).  ``--variants`` picks the
entries to build.  The last line is one JSON object of the mean times.
It needs a CUDA card and ``nvcc``, and imports nothing of the JAX
package.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
import variant_build as vb  # noqa: E402

fa = cs.fa
build = fa._build
SOURCE = build.CSRC / "flash_attention.cu"

STAGES = "  static constexpr int STAGES = DV == 256 ? 2 : 3;"
BK = "  static constexpr int BK = DV == 256 ? 64 : 128;"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
# S at other key tiles: an m64n{BK}k16 wrapper beside the built n64 and
# n128 ones.
QK_ASSERT = "  static_assert(BK == 64 || BK == 128,"
SS_N64 = "  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);\n"
SS_TEMPLATE = ("template <int N>\n__device__ __forceinline__ void wgmma_ss("
               "float (&d)[N / 2], uint64_t da,\n")
# O += P V at DV = 256 as two m64n128k16 products on column boxes 0-1 and
# 2-3, the descriptor's leading byte offset (two boxes) apart.
RS_N256 = "  else wgmma_rs_n256(d, a, db);\n"
RS_TWO_N128 = (
    "  else {\n"
    "    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, db);\n"
    "    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a,\n"
    "                  db + 2 * ((db >> 16) & 0x3FFF));\n"
    "  }\n")
# The mma body's Q fragments: read from shared memory each step (built),
# or held in registers across the key loop.
LAST_ROW = "  const int warp_last_row = q0 + warp * 16 + 15;\n"
QREAD = ("      const bf16* qp = Qs + (warp * 16 + gr) * QS + kk * 16 + 2 * tq;\n"
         "      const uint32_t a[4] = {ld32(qp), ld32(qp + 8 * QS), "
         "ld32(qp + 8),\n                             ld32(qp + 8 * QS + 8)};\n")
QHOLD = ("  uint32_t qf[KD][4];\n#pragma unroll\n"
         "  for (int kk = 0; kk < KD; ++kk) {\n"
         "    const bf16* qp = Qs + (warp * 16 + gr) * QS + kk * 16 + 2 * tq;\n"
         "    qf[kk][0] = ld32(qp);\n    qf[kk][1] = ld32(qp + 8 * QS);\n"
         "    qf[kk][2] = ld32(qp + 8);\n    qf[kk][3] = ld32(qp + 8 * QS + 8);\n"
         "  }\n")


def ss_wrapper(n: int) -> str:
    """CUDA text of an ``m64n{n}k16`` wrapper with both operands in
    shared memory, in the form of the built ``wgmma_ss_n64``."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"__device__ __forceinline__ void wgmma_ss_n{n}(float (&d)[{r}],"
            f" uint64_t da, uint64_t db, int scale_d) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, '
            f'%{r + 2}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "'
            f'\n      "{{{regs}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
            f"      : {outs}\n"
            f'      : "l"(da), "l"(db), "r"(scale_d));\n}}\n\n')


# name -> [(text in the committed source, its replacement)]
VARIANTS = {
    "built": [],
    "exp2f": [(EX2, "y = exp2f(x);")],
    "2 stages": [(STAGES, "  static constexpr int STAGES = 2;")],
    "4 stages at dh 64": [(STAGES, "  static constexpr int STAGES = "
                                   "DH == 64 ? 4 : DV == 256 ? 2 : 3;")],
    "4 stages at (96, 64)": [(STAGES, "  static constexpr int STAGES = "
                                      "DH == 96 ? 4 : DV == 256 ? 2 : 3;")],
    "Q held": [(LAST_ROW, LAST_ROW + QHOLD),
               (QREAD, "      const uint32_t* a = qf[kk];\n")],
    "P·V two n128 at 256": [(RS_N256, RS_TWO_N128)],
}


def key_tile(bk: int, stages: int) -> list:
    """Edits that put (256, 256) on ``bk``-key tiles in a ring of
    ``stages``: an ``m64n{bk}k16`` S product beside the built ones."""
    return [(BK, f"  static constexpr int BK = DV == 256 ? {bk} : 128;"),
            (STAGES, f"  static constexpr int STAGES = DV == 256 ? {stages}"
                     f" : 3;"),
            (QK_ASSERT, f"  static_assert(BK == 64 || BK == 128 || "
                        f"BK == {bk},"),
            (SS_N64, SS_N64 + f"  else if constexpr (N == {bk}) "
                              f"wgmma_ss_n{bk}(d, da, db, scale_d);\n"),
            (SS_TEMPLATE, ss_wrapper(bk) + SS_TEMPLATE)]


# (256, 256) on other key tiles, with the stages that fit 232,448 bytes
# beside the 64 KB q tile: 32 keys (16 KB of K and 16 of V) four, 48
# three, 80 two (230,528 bytes).
for _bk, _stages in ((32, 4), (48, 3), (80, 2)):
    VARIANTS[f"BK {_bk} at 256"] = key_tile(_bk, _stages)
# The wrapper's key tile of a pair, where a variant changes the kernel's.
KV_TILES = {f"BK {bk} at 256": {(256, 256): bk} for bk in (32, 48, 80)}
# (name, b, s, kv heads, g, dh, dv, prefix_len) of the timings; causal.
SHAPES = (("smoke", 4, 2000, 16, 1, 64, 64, 0),
          ("prefill_32k", 1, 32768, 16, 1, 64, 64, 0),
          ("chatglm3 S 4096", 1, 4096, 2, 16, 128, 128, 0),
          ("dh 128 S 16384", 1, 16384, 8, 1, 128, 128, 0),
          ("minicpm3 MLA", 4, 2000, 40, 1, 96, 64, 0),
          ("paligemma", 8, 320, 1, 8, 256, 256, 256))


variant_source = functools.partial(vb.variant_source, SOURCE)


def build_variant(name: str):
    """nvcc of one variant; returns (library, ptxas summary of each wgmma
    and mma build)."""
    lib, report = vb.nvcc_build(
        name, variant_source(VARIANTS[name]),
        r"flash_fwd_(wgmma|mma)_kernelILi(\d+)E(?:Li(\d+)E)?",
        lambda hit: f"{hit[1]} " + (f"(dh, dv) = ({hit[2]}, {hit[3]})"
                                    if hit[3] else f"at {hit[2]} columns"))
    fa._declare(lib)
    return lib, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--parent", help="an unpacked tree of an earlier commit "
                    "whose own flash wrapper is timed beside the variants")
    ap.add_argument("--body", choices=("wgmma", "mma"), default="wgmma",
                    help="the body every bf16 call runs")
    ap.add_argument("--variants", nargs="+", choices=sorted(VARIANTS),
                    default=sorted(VARIANTS), help="the entries to build")
    args = ap.parse_args(argv)
    if args.parent and args.body != "wgmma":
        ap.error("--parent runs its own tree's shape rule: wgmma only")
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    names = [n for n in VARIANTS if n in args.variants]
    jobs = {name: (build_variant, name) for name in names}
    if args.parent:
        jobs["parent"] = (functools.partial(
            vb.tree_module, module="kernels.flash_attention",
            stem="flash_attention",
            pattern=r"flash_fwd_(?:wgmma|mma)_kernelI(?:Li\d+E)+"),
            args.parent)
    built = vb.build_all(jobs)
    # Each entry's wrapper module and library: the variants run this
    # tree's wrapper, the parent its own.
    wrappers = {name: fa for name in names}
    libs = {name: lib for name, (lib, _) in built.items()}
    if args.parent:
        wrappers["parent"] = built["parent"][0]
        libs["parent"] = wrappers["parent"]._library()
    for name, (_, report) in built.items():
        print(f"[variants] {name}: " + "; ".join(sorted(report)), flush=True)

    tiles = dict(fa._WG_KV_TILE)

    def use(name):
        build._libs["flash_attention"] = libs[name]
        fa._WG_KV_TILE.update(tiles)
        fa._WG_KV_TILE.update(KV_TILES.get(name, {}))

    if args.body == "mma":
        fa.flash_body = lambda q, k, v: ("fma" if q.dtype == torch.float32
                                         else "mma")

    prefix = cs.get_config(cs.PALI_ARCH).vision_tokens
    cases = [(case, 0) for case in cs.FLASH_CASES] + [(cs.PALI_FLASH, prefix)]
    for case, pre in cases:
        _, b, s, kvh, g, dh, dv, causal, dt = case
        if dt != torch.bfloat16:
            continue
        q, k, v = cs.attention_inputs(b, s, kvh, g, dh, dv, dt, dev, s)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        prefix_len=pre)
        for name in libs:
            use(name)
            if name == "parent":        # the earlier tree's rule picks
                got = wrappers[name].flash_attention(q, k, v, causal=causal,
                                                     prefix_len=pre)
                torch.cuda.synchronize()
            else:
                got, body = cs.launch_body(q, k, v, causal, pre)
                if body != args.body:
                    raise AssertionError(f"{name} at {case[0]}: {body}")
            r = cs.rel_err(got, want)
            if not r <= cs.FLASH_BF16_REL:
                raise AssertionError(f"{name} at {case[0]}: {r}")
        print(f"[variants] {case[0]}: every entry within "
              f"{cs.FLASH_BF16_REL} of plain in norm", flush=True)

    times = {}
    for key, b, s, kvh, g, dh, dv, pre in SHAPES:
        q, k, v = cs.attention_inputs(b, s, kvh, g, dh, dv, torch.bfloat16,
                                      dev, 5)
        runs = {name: functools.partial(wrappers[name].flash_attention, q, k,
                                        v, prefix_len=pre)
                for name in libs}
        sdpa = functools.partial(
            torch.nn.functional.scaled_dot_product_attention,
            q.view(b, s, kvh * g, dh).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), enable_gqa=g > 1)
        pos = torch.arange(s, device=dev)
        runs["sdpa"] = (functools.partial(
            sdpa, attn_mask=(pos[None, :] <= pos[:, None]) |
            (pos[None, :] < pre)) if pre else
            functools.partial(sdpa, is_causal=True))
        for name in libs:
            runs[name] = functools.partial(
                lambda name, run: (use(name), run()), name, runs[name])
        parent = wrappers.get("parent")
        before = dict(parent.flash_launches_by_body) if parent else {}
        # Each reading queued behind a spin kernel and long enough to span
        # FLASH_READ_MS, as chip_smoke.py's: the card's pace, not the host's.
        fastest = min(cs.queued_ms(fn, 3) for fn in runs.values())
        times[key] = cs.in_turns(
            runs, max(10, math.ceil(cs.FLASH_READ_MS / fastest)),
            timer=cs.queued_ms)
        times[key].pop("reads")
        # The body the parent ran, from its own wrapper's counters.
        ran = ""
        if parent:
            now = parent.flash_launches_by_body
            ran = f"; parent ran {[n for n in before if now[n] != before[n]]}"
        bound = cs.flash_bound(b, s, kvh, g, dh, dv, True, prefix=pre)[0]
        print(f"[variants] {key} (B={b}, S={s}, KV={kvh}, G={g}, dh={dh}, "
              f"dv={dv}, causal, prefix_len={pre}; bound {bound:.4f} ms): "
              + ", ".join(
                  f"{n} {t:.4f} ms" for n, t in times[key].items())
              + ran + f"  [{card}]", flush=True)
        del q, k, v, runs
    build._libs.pop("flash_attention", None)
    fa._WG_KV_TILE.update(tiles)
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
