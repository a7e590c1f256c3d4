"""What sets the pace of K1's bf16 backward kernels: their source (or an
older one) against edited copies of itself, on one GPU, in turns.

    python3 scripts/torch_k1_bwd_variants.py [--source OLD.cu] [--out FILE]
        [--only NAME ...]

Each variant is `csrc/flash_attention_bwd_wgmma.cu` (or --source) with
edits (the `VARIANTS` table below: text replaced, each anchor asserted to
occur as often as listed; a variant whose anchors a source lacks is
skipped and said so), built with the library's nvcc flags into its own
shared library in a temporary directory, all builds started together, and
called through `flash_attention_grad` with the library's entry point
replaced. Ablations remove work the result needs (their output is wrong;
their time says what that work costs):

    no_mma      the kernels issue no wgmma (loads, barriers and the
                softmax's arithmetic stay)
    no_exp      every exponential a multiply (the MUFU's share)
    one_plane   dS enters dQ and dK as one bf16 plane (the second plane's
                products gone)
Other variants change the design, not the work:
    no_sweep1   (commit 7602d88's dq kernel) its first sweep issues no
                products (an ablation)
    occ3        (commit 7602d88's kernels) `__launch_bounds__(..., 3)`:
                three blocks an SM by registers (at most 136 a thread;
                spills where more)
    per1        one item (64 fixed rows of one batch*head) a run, as the
                grids of commit 7602d88 had one a block
    dq_per1     one item a run in the dq kernel only
    double1     dq's first sweep issuing tile j+1's products into a second
                set of accumulators before summing tile j's

At the 11 geometries of one `Config()` training step's bf16 K1 backward
calls of more than one query (scripts/torch_k1_bwd_compare.py's
`step_calls`, laid out as the step lays them out), it times the unedited
kernels and each variant in the order base, variant, variant, base (10
calls captured as one CUDA graph each, `chip_smoke.graph_ms`) and reports
each variant's largest error against the plain backward, and the sums
over the step's calls. Prints a line per geometry and a JSON line
{"k1_bwd_variants": ...} last (also to --out); every time carries the
card's name and power limit. Card only; imports nothing of JAX.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from collections import defaultdict
from unittest import mock

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from torch_k1_bwd_compare import inputs, step_calls  # noqa: E402

SOURCE = "flash_attention_bwd_wgmma.cu"
ENTRY = "ns2vc_flash_attention_bwd_wgmma"
SWEEP1_DOUBLE = (
    '    mbar_wait(L.fixed_full(f), (n >> 1) & 1);\n'
    '    ready(it);\n'
    '    scores(S, dP, it % ST);\n'
    '    for (int j = 0; j < n_tiles; j += 2, it += 2) {\n'
    '      const bool two = j + 1 < n_tiles;\n'
    '      if (two) {\n'
    '        ready(it + 1);\n'
    '        scores(S2, dP2, (it + 1) % ST);\n'
    '        wgmma_wait<1>();\n'
    '      } else {\n'
    '        wgmma_wait<0>();\n'
    '      }\n'
    '      logits(S, dP, it % ST);\n'
    '      mbar_arrive(L.empty(it % ST));\n'
    '      online(S, dP);\n'
    '      if (!two) {\n'
    '        ++it;\n'
    '        break;\n'
    '      }\n'
    '      if (j + 2 < n_tiles) {\n'
    '        ready(it + 2);\n'
    '        scores(S, dP, (it + 2) % ST);\n'
    '        wgmma_wait<1>();\n'
    '      } else {\n'
    '        wgmma_wait<0>();\n'
    '      }\n'
    '      logits(S2, dP2, (it + 1) % ST);\n'
    '      mbar_arrive(L.empty((it + 1) % ST));\n'
    '      online(S2, dP2);\n'
    '    }\n')
SWEEP1_SERIAL = (
    '    mbar_wait(L.fixed_full(f), (n >> 1) & 1);\n'
    '    for (int j = 0; j < n_tiles; ++j, ++it) {\n'
    '      ready(it);\n'
    '      scores(S, dP, it % ST);\n'
    '      wgmma_wait<0>();\n'
    '      logits(S, dP, it % ST);\n'
    '      mbar_arrive(L.empty(it % ST));\n'
    '      online(S, dP);\n'
    '    }\n')


# dq's first sweep as kept (SWEEP1_SERIAL) and with a second set of
# accumulators (SWEEP1_DOUBLE), for "double1"
DQ_ACCS = ("  float S[32], dP[32];\n  int it = 0;\n"
           "  for (int n = 0; n < count; ++n) {\n"
           "    const int item = first + n, bh = item / q_tiles,",
           "  float S[32], dP[32], S2[32], dP2[32];\n  int it = 0;\n"
           "  for (int n = 0; n < count; ++n) {\n"
           "    const int item = first + n, bh = item / q_tiles,", 1)
DQ_ZERO = ("    for (int e = 0; e < 32; ++e) S[e] = dP[e] = 0.f;\n\n"
           "    // S = Q.K^T",
           "    for (int e = 0; e < 32; ++e) S[e] = dP[e] = S2[e] = dP2[e] = "
           "0.f;\n\n    // S = Q.K^T", 1)
def per_one(real, bh, tq, tk, d):
    """A run per item (as the grids of commit 7602d88 had one a
    block)."""
    from ns2vc_tpu_torch.ops.flash_attention import BWD_ROWS

    return tuple(-(-n // BWD_ROWS) * bh for n in (tq, tk))


def dq_one(real, bh, tq, tk, d):
    return per_one(real, bh, tq, tk, d)[0], real(bh, tq, tk, d)[1]


# variant -> ([alternative lists of (anchor, replacement, occurrences)],
# the plan it launches with: None for the wrapper's)
VARIANTS = {
    "no_mma": ([
        [("      wgmma_m64n64k16_ss(\n"
          "          d, wgmma_desc<C::W>(a + pnl * C::Panel + off, 16, "
          "8 * C::W),\n"
          "          wgmma_desc<C::W>(b + pnl * C::Panel + off, 16, "
          "8 * C::W), ks > 0);",
          "      (void)off; (void)pnl;", 1),
         ("    wgmma_rs_mn<DP>(d, a[kk],\n"
          "                    wgmma_desc<C::W>(b + kk * 16 * C::W, "
          "C::Panel, 8 * C::W));", "    (void)kk;", 1)],
        [("      wgmma_ss_n<N>(\n", "      if (false) wgmma_ss_n<N>(\n", 1),
         ("      wgmma_rs_mn<DP>(d, a[kk],\n", "      if (false) "
          "wgmma_rs_mn<DP>(d, a[kk],\n", 1)],
    ], None),
    "no_exp": ([[('#include "mma.cuh"\n',
                  '#include "mma.cuh"\n#define ex2_approx(x) ((x) * 0.5f)\n',
                  1)]], None),
    "one_plane": ([
        [("    product_mn<DP>(dQ, lo, k_tile(s));\n", "", 1),
         ("    product_mn<DP>(dK, lo, q_tile(s));\n", "", 1)],
        [("      product_mn<DP>(dQ, lo, L.s0(s));\n", "", 1),
         ("      product_mn<DP>(dK, lo, L.s0(s));\n", "", 1)],
    ], None),
    "no_sweep1": ([[("    scores(s);\n    wgmma_wait<0>();\n    logits(s);\n",
                     "    logits(s);\n", 1)]], None),
    "occ3": ([[("__launch_bounds__(kThreads, 1)",
                "__launch_bounds__(kThreads, 3)", 2)]], None),
    # one item a block (no runs)
    "per1": ([[]], per_one),
    "dq_per1": ([[]], dq_one),
    "double1": ([[(SWEEP1_SERIAL, SWEEP1_DOUBLE, 1), DQ_ACCS, DQ_ZERO]],
                None),
}


def edit(src: str, name: str):
    """The source with variant `name`'s edits, or None where no spelling of
    its anchors occurs as listed."""
    for alt in VARIANTS[name][0]:
        if all(src.count(old) == n for old, _, n in alt):
            for old, new, _ in alt:
                src = src.replace(old, new)
            return src
    return None


def build(base, names, tmp, warnings=False):
    """Each variant's entry point, built in parallel (None: not
    applicable to this source)."""
    from ns2vc_tpu_torch.ops import _build

    jobs, fns = {}, {}
    for name in ["base", *names]:
        src = base if name == "base" else edit(base, name)
        if src is None:
            cs.say(f"variant {name}: its anchors are not in this source; "
                   "skipped")
            fns[name] = None
            continue
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = os.path.join(tmp, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
               str(_build.CSRC_DIR), cu, "-o", so, *_build.LINK_FLAGS]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    # a source before the runs (commit 7602d88's) takes no dq_runs, kv_runs
    older = "int dq_runs" not in base
    argtypes = _build._SIGNATURES[ENTRY]
    if older:
        argtypes = argtypes[:-3] + argtypes[-1:]
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            cs.fail(f"variant {name} does not build:\n{log[-3000:]}")
        if warnings:
            for line in log.splitlines():
                if "warning" in line.lower():
                    cs.say(f"  {name}: {line.strip()[:300]}")
        fn = getattr(ctypes.CDLL(so), ENTRY)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = (lambda f: lambda *a: f(*a[:-3], a[-1]))(fn) if older \
            else fn
    return fns


def caller(fn, plan_fn, q, k, v, bias, scale, do):
    """flash_attention_grad on these inputs through a variant's entry (and
    its plan, where it has one)."""
    import ns2vc_tpu_torch.ops.flash_attention as fa

    main = fa._build.library()
    lib = type("Lib", (), {ENTRY: staticmethod(fn),
                           "__getattr__": lambda self, n: getattr(main, n)})()
    real = fa.plan_backward
    planned = real if plan_fn is None else (
        lambda *a: plan_fn(real, *a))

    def run():
        with mock.patch.object(fa._build, "library", lambda: lib), \
                mock.patch.object(fa, "plan_backward", planned):
            return fa.flash_attention_grad(q, k, v, bias, scale, do)
    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--source", default=None,
                    help="another flash_attention_bwd_wgmma.cu to edit")
    ap.add_argument("--only", nargs="*", default=list(VARIANTS))
    ap.add_argument("--warnings", action="store_true",
                    help="print nvcc's warnings of each build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    from ns2vc_tpu_torch.ops import _build
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention_backward

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cs.CARD = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; {cs.CARD}")
    src = open(args.source or (_build.CSRC_DIR / SOURCE)).read()
    calls = step_calls(cs.TRAIN_B, cs.TRAIN_T, cs.TRAIN_T)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 93)
    out = {"card": cs.CARD, "source": args.source or SOURCE,
           "variants": args.only, "rows": []}
    sums = defaultdict(float)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(src, args.only, tmp, args.warnings)
        names = [n for n in args.only if fns[n] is not None]
        for key, n in calls.items():
            q, k, v, bias, do = inputs(key, g, dev)
            if q.shape[2] == 1:
                continue   # the pools: the single-query kernel
            scale = q.shape[-1] ** -0.5 if key[1] is None else key[1]
            want = flash_attention_backward(q, k, v, bias, scale, do)
            runs = {vn: caller(fns[vn], VARIANTS.get(vn, (0, None))[1],
                               q, k, v, bias, scale, do)
                    for vn in ["base", *names]}
            row = {"q": list(q.shape), "k": list(k.shape),
                   "bias": bias is not None, "calls": n, "ms": {}, "err": {}}
            for vn, run in runs.items():
                got = run()
                row["err"][vn] = max(
                    ((a.float() - w.float()).abs().max()
                     / w.float().abs().max()).item()
                    for a, w in zip(got, want))
            base = []
            for vn in names:
                t = [cs.graph_ms(runs[side])
                     for side in ("base", vn, vn, "base")]
                base += [t[0], t[3]]
                row["ms"][vn] = (t[1] + t[2]) / 2
            row["ms"]["base"] = (sum(base) / len(base) if base
                                 else cs.graph_ms(runs["base"]))
            for vn, ms in row["ms"].items():
                sums[vn] += n * ms
            out["rows"].append(row)
            cs.say(f"K1 bf16 backward variants q{tuple(q.shape)} "
                   f"k{tuple(k.shape)} bias={int(bias is not None)} x{n}: "
                   + ", ".join(f"{vn} {ms:.4f} ms (err {row['err'][vn]:.1e})"
                               for vn, ms in sorted(row["ms"].items()))
                   + f" [{cs.CARD}]")
    out["per_step"] = dict(sums)
    cs.say("K1 bf16 backward variants, the step's tile calls: " + ", ".join(
        f"{vn} {ms:.4f} ms" for vn, ms in sorted(sums.items()))
        + f" [{cs.CARD}]")
    line = json.dumps({"k1_bwd_variants": out})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
