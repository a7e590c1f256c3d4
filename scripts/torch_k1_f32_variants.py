"""What sets the pace of K1's f32 wgmma kernel: its source against edited
copies of itself, on one GPU, in turns.

    python3 scripts/torch_k1_f32_variants.py [--out FILE] [--only NAME ...]

Each variant is `csrc/flash_attention_f32_wgmma.cu` with one edit (the
`VARIANTS` table below: text replaced, each anchor asserted to occur
once), built with the library's nvcc flags into its own shared library in
a temporary directory, all builds started together. Some edits remove work
the result needs (an ablation: its output is wrong, its time says what
that work costs); the others compute the same function another way:

    noexp     the softmax's exponential replaced by its argument (no
              MUFU.EX2)
    one_pass  one TF32 pass (big.big) per product in place of three
    no_pv     the P.V products reduced to one pass of one k-step
    no_split  the converting warpgroup stores no planes of K and V (the
              consumers read whatever the stages hold)
    cvt       TF32 rounding by the conversion instruction (cvt.rna) in
              place of the integer rounding the kernel uses
    raw_big   each raw value its own big plane (wgmma truncates it) and
              the exact remainder unrounded as the small one
    no_zero   S and the P.V partial not zeroed before their first product
              (wgmma overwrites them; the zeros end their live ranges)

At every K1 call of one f32 UNet step at B=16 and at B=1
(`chip_smoke.attention_cases`), ContentVec's (1, 12, T, 64) at T = 400 and
3000, the F0 predictor's cross-attention and the op registry's D = 128,
each at the plan `plan_f32_wgmma` gives, it times the unedited kernel and
each variant in the order base, variant, variant, base (20 calls captured
as one CUDA graph each, `chip_smoke.graph_ms`), TF32 off, and reports each
variant's error against the plain version. Prints a line per geometry, the
sums per group and a JSON line {"k1_f32_variants": ...} last (also to
--out); every time carries the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from scripts.torch_k1_f32_compare import inputs  # noqa: E402

ITERS = 20
THREE_PASS_QK = """          wgmma_tf32_ss<BN>(S, as, bb, kst > 0);
          wgmma_tf32_ss<BN>(S, ab, bsm, 1);
          wgmma_tf32_ss<BN>(S, ab, bb, 1);"""
THREE_PASS_PV = """        wgmma_tf32_rs<DP>(Op, Ps[kk], vbd, kk > 0);
        wgmma_tf32_rs<DP>(Op, Pb[kk], vsd, 1);
        wgmma_tf32_rs<DP>(Op, Pb[kk], vbd, 1);"""
VARIANTS = {
    "noexp": [("""        S[e] = ex2_approx(kBias ? S[e] - ref[r]
                                : fmaf(S[e], scale_log2, -ref[r]));""",
               """        S[e] = kBias ? S[e] - ref[r]
                     : fmaf(S[e], scale_log2, -ref[r]);""")],
    "one_pass": [(THREE_PASS_QK,
                  "          wgmma_tf32_ss<BN>(S, ab, bb, kst > 0);"),
                 (THREE_PASS_PV,
                  "        wgmma_tf32_rs<DP>(Op, Pb[kk], vbd, kk > 0);")],
    "no_pv": [(THREE_PASS_PV, """        if (kk == 0)
          wgmma_tf32_rs<DP>(Op, Pb[kk], vbd, 0);""")],
    "no_split": [("""          split4(kr[t], big, small);
          sts128(kb + off, big);
          sts128(ks + off, small);""", ""),
                 ("""            split4(vals, big, small);
            const uint32_t off =
                swz128(vpanel, 4 * vch + dd, 2 * (g8 % 4) + half);
            sts128(vb + off, big);
            sts128(vs + off, small);""", "")],
    "cvt": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
             """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;""")],
    "raw_big": [("""  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));""",
                 """  big = __float_as_uint(x);
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));""")],
    "no_zero": [("      for (int e = 0; e < BN / 2; ++e) S[e] = 0.f;   "
                 "// ends S's live range\n", ""),
                ("      for (int e = 0; e < DP / 2; ++e) Op[e] = 0.f;\n",
                 "")],
}


def build(names, tmp):
    """Each variant's entry point, built in parallel."""
    from ns2vc_tpu_torch.ops import _build

    base = (_build.CSRC_DIR / "flash_attention_f32_wgmma.cu").read_text()
    jobs = {}
    for name in ["base", *names]:
        src = base
        for old, new in VARIANTS.get(name, []):
            if src.count(old) != 1:
                cs.fail(f"variant {name}: anchor found {src.count(old)} "
                        f"times: {old[:60]!r}")
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
    sig = _build._SIGNATURES["ns2vc_flash_attention_f32_wgmma_fwd"]
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            cs.fail(f"variant {name} does not build:\n{log[-3000:]}")
        fn = ctypes.CDLL(so).ns2vc_flash_attention_f32_wgmma_fwd
        fn.argtypes, fn.restype = sig, ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, q, k, v, bias, plan):
    from ns2vc_tpu_torch.ops import _build

    b, h, tq, d = q.shape
    out = torch.empty((b, tq, h, d), device=q.device)
    o = out.permute(0, 2, 1, 3)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if bias is None else bias.data_ptr(), o.data_ptr(),
                    b, h, tq, k.shape[2], d, *strides, d ** -0.5, *plan,
                    _build.stream_of(q)), "f32 wgmma variant")
    return o


def geometries(cfg):
    out = {f"unet_B{bsz}": [c for c in cs.attention_cases(cfg, bsz)
                            if c[7] > 0] for bsz in (cs.B, 1)}
    out["other"] = [
        ("contentvec_T400", 1, 12, 400, 400, 64, None, 12, "cross"),
        ("contentvec_T3000", 1, 12, 3000, 3000, 64, None, 12, "cross"),
        ("f0_cross", cs.B, 8, cs.T_PAD, cs.TP_PAD, 32, cs.TP_REFER, 10,
         "cross"),
        ("registry_d128", 4, 2, 400, 400, 128, "odd_items", 1, "self")]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_f32_variants: no CUDA device", file=sys.stderr)
        return 2
    import ns2vc_tpu_torch.ops.flash_attention as fa
    from ns2vc_tpu_torch.config import Config

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cs.CARD = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; {cs.CARD}")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 91)
    out = {"card": cs.CARD, "variants": args.only}
    with tempfile.TemporaryDirectory() as tmp, cs.no_tf32():
        fns = build(args.only, tmp)
        for label, geos in geometries(Config()).items():
            sums = dict.fromkeys(["base", *args.only], 0.0)
            rows = []
            for name, b, h, tq, tk, d, valid, calls, layout in geos:
                q, k, v, bias = inputs(b, h, tq, tk, d, valid, layout, g,
                                       dev)
                plan = fa.plan_f32_wgmma(b * h, tq, tk, d)
                want = fa.flash_attention_plain(q, k, v, bias)
                row = {"name": name, "calls": calls, "plan": plan,
                       "ms": {}, "err": {}}
                for vn in ["base", *args.only]:
                    row["err"][vn] = (launch(fns[vn], q, k, v, bias, plan)
                                      - want).abs().max().item()
                for vn in args.only:
                    t = [cs.graph_ms(lambda f=fns[side]: launch(
                        f, q, k, v, bias, plan), ITERS)
                        for side in ("base", vn, vn, "base")]
                    row["ms"].setdefault("base", []).extend((t[0], t[3]))
                    row["ms"][vn] = (t[1] + t[2]) / 2
                row["ms"]["base"] = (sum(row["ms"]["base"])
                                     / len(row["ms"]["base"]))
                for vn, ms in row["ms"].items():
                    sums[vn] += calls * ms
                rows.append(row)
                cs.say(f"K1 f32 variants {label} {name:18s} x{calls} plan "
                       f"{plan}: " + ", ".join(
                           f"{vn} {ms:.4f} ms (err {row['err'][vn]:.1e})"
                           for vn, ms in row["ms"].items())
                       + f" [{cs.CARD}]")
            cs.say(f"K1 f32 variants {label} summed over its calls: "
                   + ", ".join(
                       f"{vn} {ms:.4f} ms "
                       f"({100 * (ms / sums['base'] - 1):+.1f} %)"
                       for vn, ms in sums.items()) + f" [{cs.CARD}]")
            out[label] = {"sums": sums, "rows": rows}
    line = json.dumps({"k1_f32_variants": out})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
