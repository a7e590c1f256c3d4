"""What sets the pace of K1's f32 backward kernels: their source against
edited copies of itself, on one GPU, in turns.

    python3 scripts/torch_k1_f32_bwd_variants.py [--out FILE] [--only NAME ...]

Each variant is `csrc/flash_attention_f32_bwd_wgmma.cu` with edits (the
`VARIANTS` table below: text replaced, each anchor asserted to occur as
often as listed), built with the library's nvcc flags into its own shared
library in a temporary directory, all builds started together, and called
through `flash_attention_grad` with the library's entry point replaced
(and, for a variant of other shapes, `F32_BWD_SHAPES` as it plans them).
Ablations remove work the result needs (their output is wrong; their
time says what that work costs):

    no_mma    the tile kernels issue no wgmma (loads, barriers and the
              softmax's arithmetic stay)
    one_pass  one TF32 pass (big.big) per product in place of three
    no_load   the producer copies nothing (each unit's barrier completes
              at once; the products read whatever the ring holds)
    depth3    three units' products in flight ahead of the oldest (kDepth
              3, not 1)
    bn32      at D = 32 dq's key tiles of 32 keys (not 64), nine ring
              slots
    nw1       at D = 128 one consumer warpgroup a block over all of its
              streamed tiles (not two, each over half of them with half of
              the ring, beside a producer warpgroup)

At the F0 predictor's cross-attention (B = 32, 8 heads of 32 over 272
keys, key padding), three of the f32 gradient checks' geometries at B = 2
(8 heads of 32 and of 16 over 272 queries, 8 of 32 over 136) and the op
registry's ids 14/15 (4 x 2 x 400 x 128), it times the unedited kernels
and each variant in the order base, variant, variant, base (10 calls
captured as one CUDA graph each, `chip_smoke.graph_ms`), TF32 off, and
reports each variant's largest error against the plain backward. Prints a
line per geometry and a JSON line {"k1_f32_bwd_variants": ...} last (also
to --out); every time carries the card's name and power limit. Card only;
imports nothing of JAX.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

SOURCE = "flash_attention_f32_bwd_wgmma.cu"
ENTRY = "ns2vc_flash_attention_f32_bwd_wgmma"
PASSES_SS = """      wgmma_tf32_ss<N>(d, a_s, b_b, 1);
      wgmma_tf32_ss<N>(d, a_b, b_s, 1);
      wgmma_tf32_ss<N>(d, a_b, b_b, 1);"""
PASSES_RS = """    wgmma_tf32_rs<T::PC>(dc, small[kk], b_b, 1);
    wgmma_tf32_rs<T::PC>(dc, big[kk], b_s, 1);
    wgmma_tf32_rs<T::PC>(dc, big[kk], b_b, 1);"""
# variant -> ([(anchor, replacement, occurrences)], F32_BWD_SHAPES edits)
VARIANTS = {
    "no_mma": ([(PASSES_SS, "", 1), (PASSES_RS, "", 1)], {}),
    "one_pass": ([(PASSES_SS, "      wgmma_tf32_ss<N>(d, a_b, b_b, 1);", 1),
                  (PASSES_RS,
                   "    wgmma_tf32_rs<T::PC>(dc, big[kk], b_b, 1);", 1)],
                 {}),
    "no_load": ([("  mbar_arrive_expect_tx(r.full(u), r.unit);",
                  "  mbar_arrive(r.full(u));", 1),
                 ("    tma_load_4d(slot + pl * T::Panel, map, r.full(u), "
                  "c * T::PC, row0, bh,\n                pl);",
                  "    (void)slot;", 1),
                 ("      tma_load_4d(slot + pl * T::TChunk + p * T::TSub, "
                  "map, r.full(u),\n                  key0 + p * T::KP, "
                  "c * T::PC, bh, pl);", "      (void)slot;", 1)], {}),
    "depth3": ([("constexpr int kDepth = 1;", "constexpr int kDepth = 3;",
                 1)], {}),
    "nw1": ([("""  static constexpr int BN = 64, KBN = 32, DqSlots = 6, KvSlots = 12,
                       Blocks = 1;
  static constexpr int NW = 2;""",
              """  static constexpr int BN = 64, KBN = 32, DqSlots = 6, KvSlots = 12,
                       Blocks = 1;
  static constexpr int NW = 1;""", 1)], {}),
    "bn32": ([("""  static constexpr int BN = 64, KBN = 32, DqSlots = 4, KvSlots = 9,
                       Blocks = 2;""",
               """  static constexpr int BN = 32, KBN = 32, DqSlots = 9, KvSlots = 9,
                       Blocks = 2;""", 1)], {32: (32, 32, 2)}),
}
# (name, B, H, Tq, Tk, D, calls)
GEOMETRIES = [("f0_cross", 32, 8, 272, 272, 32, 10),
              ("grad_check", 2, 8, 272, 272, 32, 12),
              ("grad_check_d16", 2, 8, 272, 272, 16, 10),
              ("grad_check_136", 2, 8, 136, 272, 32, 5),
              ("registry_d128", 4, 2, 400, 400, 128, 2)]


def build(names, tmp):
    """Each variant's entry point, built in parallel."""
    from ns2vc_tpu_torch.ops import _build

    base = (_build.CSRC_DIR / SOURCE).read_text()
    jobs = {}
    for name in ["base", *names]:
        src = base
        for old, new, times in VARIANTS.get(name, ([], {}))[0]:
            if src.count(old) != times:
                cs.fail(f"variant {name}: anchor found {src.count(old)} "
                        f"times (want {times}): {old[:60]!r}")
            src = src.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = os.path.join(tmp, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
               str(_build.CSRC_DIR), cu, "-o", so, *_build.LINK_FLAGS]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    fns = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            cs.fail(f"variant {name} does not build:\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(so), ENTRY)
        fn.argtypes, fn.restype = _build._SIGNATURES[ENTRY], ctypes.c_int
        fns[name] = fn
    return fns


def caller(fn, shapes, q, k, v, bias, do):
    """flash_attention_grad on these inputs through a variant's entry."""
    import ns2vc_tpu_torch.ops.flash_attention as fa

    lib = type("Lib", (), {ENTRY: staticmethod(fn)})()

    def run():
        with mock.patch.object(fa._build, "library", lambda: lib), \
                mock.patch.dict(fa.F32_BWD_SHAPES, shapes):
            return fa.flash_attention_grad(q, k, v, bias,
                                           q.shape[-1] ** -0.5, do)
    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_f32_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention_backward

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cs.CARD = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; {cs.CARD}")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 92)
    out = {"card": cs.CARD, "variants": args.only, "rows": []}
    with tempfile.TemporaryDirectory() as tmp, cs.no_tf32():
        fns = build(args.only, tmp)
        for name, b, h, tq, tk, d, calls in GEOMETRIES:
            q, do = (torch.randn(b, h, tq, d, generator=g, device=dev)
                     for _ in range(2))
            k, v = (torch.randn(b, h, tk, d, generator=g, device=dev)
                    for _ in range(2))
            keep = torch.arange(tk, device=dev)[None] < torch.randint(
                tk // 2, tk + 1, (b, 1), generator=g, device=dev)
            bias = (1.0 - keep.float()) * -1e4
            want = flash_attention_backward(q, k, v, bias, d ** -0.5, do)
            runs = {vn: caller(fns[vn], VARIANTS.get(vn, ([], {}))[1],
                               q, k, v, bias, do)
                    for vn in ["base", *args.only]}
            row = {"name": name, "shape": [b, h, tq, tk, d], "calls": calls,
                   "ms": {}, "err": {}}
            for vn, run in runs.items():
                got = run()
                row["err"][vn] = max(
                    ((a - w).abs().max() / w.abs().max()).item()
                    for a, w in zip(got, want))
            base = []
            for vn in args.only:
                t = [cs.graph_ms(runs[side])
                     for side in ("base", vn, vn, "base")]
                base += [t[0], t[3]]
                row["ms"][vn] = (t[1] + t[2]) / 2
            row["ms"]["base"] = sum(base) / len(base)
            out["rows"].append(row)
            cs.say(f"K1 f32 backward variants {name} {tuple(row['shape'])} "
                   f"x{calls}: " + ", ".join(
                       f"{vn} {ms:.4f} ms (err {row['err'][vn]:.1e})"
                       for vn, ms in sorted(row["ms"].items()))
                   + f" [{cs.CARD}]")
    line = json.dumps({"k1_f32_bwd_variants": out})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
