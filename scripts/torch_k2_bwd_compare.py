"""K2's bf16 backward (the wgmma kernels) against the FFMA kernels they
replaced, on one GPU, in turns, at a training step's 45 K2 geometries;
with --f32, K2's f32 backward (3xTF32 on tf32 wgmma) against the f32 FFMA
kernels it replaced, the same way.

    git show fadfcc3:ns2vc_tpu_torch/csrc/affine_silu_conv1d_bwd.cu \\
        > .scratch/affine_silu_conv1d_bwd_ffma.cu
    python3 scripts/torch_k2_bwd_compare.py \\
        --old-source .scratch/affine_silu_conv1d_bwd_ffma.cu [--out FILE]
    git show 3eefe3f:ns2vc_tpu_torch/csrc/affine_silu_conv1d_bwd.cu \\
        > .scratch/affine_silu_conv1d_bwd_f32_ffma.cu
    python3 scripts/torch_k2_bwd_compare.py --f32 \\
        --old-source .scratch/affine_silu_conv1d_bwd_f32_ffma.cu [--out FILE]

With --f32 the inputs are f32 (not bf16 values), TF32 is off for the
plain backward, and each side is also held against the plain backward in
f64 (`chip_smoke.k2_f32_holds`: max(1e-4, 4 x the plain f32 backward's own
error) of max|f64| per gradient); the old source is the f32 route as the
port had it before the tf32 design (its entry without the vec and keep_f32
arguments), its splits and workspace planned as its wrapper planned them
(`ffma_plan`, `ffma_workspace` below).

The old source is the bf16 backward as the port had it before the wgmma
design (dgrad, wgrad and finalize in f32 FFMA on the CUDA cores, 64-frame
tiles per batch row): it is compiled with nvcc into the gitignored
`.scratch/` and bound with ctypes, its splits and workspace planned as its
wrapper planned them (`plan_backward`, `backward_workspace`, which the f32
route still uses).

At every K2 call of a `Config()` training step (`chip_smoke.resnet_cases`
at 32 x 272: the 44 resnet epilogues and the output conv), on seeded bf16
x, w, dy and f32 a, b laid out as the step's, it
- holds both kernels' f32 sums (`keep_f32`) against the plain backward
  (`affine_silu_conv1d_backward`, TF32 off) within `chip_smoke.
  K2_BWD_RTOL` of max|plain| per gradient, and each to be bitwise
  repeatable;
- times old, new, new, old, each as the device time of 10 calls captured
  as one CUDA graph (`chip_smoke.graph_ms`), then cuDNN's path (the plain
  backward under the step's cuDNN flags, TF32 on) and the same under
  `cudnn.deterministic`, and the bound (`chip_smoke.k2_backward_bound`);
- and the device time of each kernel a call launches (dgrad, wgrad,
  finalize; old and new) from torch.profiler over eager calls.
Every time carries the card's name and power limit. Prints a line per
geometry, the sums per training step, and a JSON line
{"k2_bwd_compare": ...} last (also to --out). Card only; imports nothing
of JAX.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ffma_plan(bsz: int, t: int, c: int, co: int) -> int:
    """The FFMA kernels' weight-gradient splits, as their wrapper planned
    them: (64 x 64) dw tiles times splits for two blocks per SM, at most 64
    and at most the B * ceil(T / 16) frame chunks."""
    tiles = -(-c // 64) * -(-co // 64)
    return max(1, min(bsz * -(-t // 16), 64, round(2 * 132 / tiles)))


def ffma_workspace(bsz: int, t: int, c: int, co: int, splits: int) -> int:
    """f32 values of the FFMA kernels' workspace: each split's dw and dbias
    partials, each 64-frame tile's da and db partials."""
    return splits * (3 * co * c + co) + 2 * bsz * -(-t // 64) * c


def build_old(source: str, f32: bool = False):
    """The FFMA kernels' library, compiled once per source into .scratch/;
    the f32 route's entry takes no vec and keep_f32 arguments."""
    from ns2vc_tpu_torch.ops import _build

    text = open(source, "rb").read()
    tag = hashlib.sha256(text).hexdigest()[:12]
    out = os.path.join(ROOT, ".scratch", f"libk2_bwd_old_{tag}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", source, "-o",
               out]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            cs.fail(f"old kernel build: {proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    fn = lib.ns2vc_affine_silu_conv1d_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * (
        5 if f32 else 7) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def old_grad(fn, x, a, b, w, dy, keep_f32):
    """A closure that launches the FFMA kernels on these bf16 (or, for the
    f32 entry, f32) inputs (their workspace and outputs made once): (dx,
    da, db, dw, dbias)."""
    bsz, t, c = x.shape
    co = w.shape[0]
    f32 = x.dtype == torch.float32
    splits = ffma_plan(bsz, t, c, co)
    ws = torch.empty(ffma_workspace(bsz, t, c, co, splits),
                     dtype=torch.float32, device=x.device)
    out = torch.float32 if keep_f32 or f32 else torch.bfloat16
    outs = (torch.empty(bsz, t, c, dtype=out, device=x.device),
            torch.empty(bsz, c, device=x.device),
            torch.empty(bsz, c, device=x.device),
            torch.empty(co, c, 3, dtype=out, device=x.device),
            torch.empty(co, dtype=out, device=x.device))

    def run():
        dx, da, db, dw, dbias = outs
        tail = () if f32 else (1, int(keep_f32))
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), da.data_ptr(), db.data_ptr(),
                 dw.data_ptr(), dbias.data_ptr(), ws.data_ptr(), bsz, t, c,
                 co, splits, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            cs.fail(f"old kernels: CUDA error {err}")
        return outs
    return run


def rel_err(got, want):
    return max((g - e).abs().max().item() / max(e.abs().max().item(), 1e-30)
               for g, e in zip(got, want))


def cudnn(det):
    # the training step's cuDNN flags (TF32 on), deterministic as asked
    return torch.backends.cudnn.flags(
        enabled=True, benchmark=torch.backends.cudnn.benchmark,
        deterministic=det, allow_tf32=True)


def kernel_ms(run, reps=3):
    """Device ms of each kernel one call launches (dgrad, wgrad, finalize),
    from torch.profiler over `reps` eager calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        name = next((k for k in ("dgrad", "wgrad", "finalize", "pack")
                     if f"{k}_" in e.key), "other")
        out[name] += us / 1e3 / reps
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-source", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--f32", action="store_true",
                    help="the f32 route against the f32 FFMA kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_bwd_compare: no CUDA device", file=sys.stderr)
        return 2
    import ns2vc_tpu_torch.ops.fused_resnet as fr
    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.CARD = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; {cs.CARD}")
    fn = build_old(args.old_source, args.f32)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    with torch.device("meta"):
        unet = NaturalSpeech2(Config()).diff_model.unet
    bsz = cs.TRAIN_B
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 80)
    rows = []
    sums = defaultdict(float)
    per_kernel = {"old": defaultdict(float), "new": defaultdict(float)}
    f64_errs = {"old": 0.0, "new": 0.0, "plain": 0.0}
    for name, t, c, co, _ in cs.resnet_cases(unet):
        t = t * cs.TRAIN_T // cs.T_PAD
        x = torch.randn(bsz, t, c, generator=g, device=dev).to(dtype)
        a = 1 + 0.3 * torch.randn(bsz, c, generator=g, device=dev)
        b = 0.3 * torch.randn(bsz, c, generator=g, device=dev)
        w = (torch.randn(co, c, 3, generator=g, device=dev)
             / (3 * c) ** 0.5).to(dtype)
        bias = (0.1 * torch.randn(co, generator=g, device=dev)).to(dtype)
        dy = torch.randn(bsz, t, co, generator=g, device=dev).to(dtype)
        want = fr.affine_silu_conv1d_backward(x.float(), a, b, w.float(),
                                              bias.float(), dy.float())
        old_f32 = old_grad(fn, x, a, b, w, dy, True)
        og = [v.clone() for v in old_f32()]
        og2 = old_f32()
        ng = fr.affine_silu_conv1d_grad(x, a, b, w, bias, dy, keep_f32=True)
        ng2 = fr.affine_silu_conv1d_grad(x, a, b, w, bias, dy, keep_f32=True)
        torch.cuda.synchronize()
        errs = (rel_err(og, want), rel_err(ng, want))
        repeat = (all(torch.equal(p, r) for p, r in zip(og, og2)),
                  all(torch.equal(p, r) for p, r in zip(ng, ng2)))
        held = True
        if args.f32:
            f64 = fr.affine_silu_conv1d_backward(
                *(v.double() for v in (x, a, b, w, bias, dy)))
            e_old, plain = cs.k2_f32_errors(og, want, f64)
            e_new, _ = cs.k2_f32_errors(ng, want, f64)
            held = cs.k2_f32_holds(e_old, plain) and cs.k2_f32_holds(
                e_new, plain)
            for side, e in (("old", e_old), ("new", e_new),
                            ("plain", plain)):
                f64_errs[side] = max(f64_errs[side], max(e))
        if not (max(errs) <= cs.K2_BWD_RTOL and all(repeat) and held):
            cs.fail(f"{name} T={t} C={c} Co={co}: errors old/new {errs} of "
                    f"max|plain| (tol {cs.K2_BWD_RTOL}), bitwise repeat "
                    f"{repeat}, f64 bound held {held}")
        old = old_grad(fn, x, a, b, w, dy, False)
        new = lambda: fr.affine_silu_conv1d_grad(  # noqa: E731
            x, a, b, w, bias, dy)
        kernels = {"old": kernel_ms(old), "new": kernel_ms(new)}
        for side, ms in kernels.items():
            for k, v in ms.items():
                per_kernel[side][k] += v
        turns = [cs.graph_ms(old), cs.graph_ms(new), cs.graph_ms(new),
                 cs.graph_ms(old)]
        lib = {}
        for det in (False, True, True, False):
            with cudnn(det):
                lib.setdefault(det, []).append(cs.graph_ms(
                    lambda: fr.affine_silu_conv1d_backward(
                        x, a, b, w, bias, dy)))
        bound = cs.k2_backward_bound(bsz, t, c, co, dtype)[0]
        row = {"name": name, "t": t, "c": c, "co": co,
               "old_ms": (turns[0] + turns[3]) / 2,
               "new_ms": (turns[1] + turns[2]) / 2, "turns": turns,
               "cudnn_ms": sum(lib[False]) / 2,
               "cudnn_det_ms": sum(lib[True]) / 2, "bound_ms": bound,
               "splits": (fr.plan_wgrad_f32 if args.f32 else fr.plan_wgrad)(
                   bsz, t, c, co),
               "old_err": errs[0], "new_err": errs[1],
               "kernels": kernels}
        rows.append(row)
        for key in ("old_ms", "new_ms", "cudnn_ms", "cudnn_det_ms",
                    "bound_ms"):
            sums[key] += row[key]
        cs.say(f"K2 backward {dtype} B={bsz} {name:18s} T={t} C={c} "
               f"Co={co}: FFMA "
               f"{turns[0]:.4f}/{turns[3]:.4f} wgmma {turns[1]:.4f}/"
               f"{turns[2]:.4f} ms (splits {row['splits']}), cuDNN's path "
               f"{row['cudnn_ms']:.4f} (deterministic "
               f"{row['cudnn_det_ms']:.4f}), bound {bound:.5f}; err of "
               f"max|plain| FFMA {errs[0]:.2e} wgmma {errs[1]:.2e}; wgmma "
               "profiled: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
                   kernels["new"].items())))
    if args.f32:
        cs.say(f"K2 f32 backward against the plain backward in f64, worst "
               f"of max|f64| over the calls: FFMA {f64_errs['old']:.2e}, "
               f"tf32 wgmma {f64_errs['new']:.2e}, the plain f32 backward "
               f"{f64_errs['plain']:.2e}")
    cs.say(f"K2 backward, one training step's {len(rows)} calls (B={bsz} x "
           f"{cs.TRAIN_T}, {dtype}): FFMA {sums['old_ms']:.4f} ms -> wgmma "
           f"{sums['new_ms']:.4f} ms; cuDNN's path {sums['cudnn_ms']:.4f} "
           f"(deterministic {sums['cudnn_det_ms']:.4f}); bound "
           f"{sums['bound_ms']:.5f} ({100 * sums['bound_ms'] / sums['new_ms']:.1f}"
           f" % of it); worst err of max|plain| FFMA "
           f"{max(r['old_err'] for r in rows):.2e}, wgmma "
           f"{max(r['new_err'] for r in rows):.2e} [{cs.CARD}]")
    for side, ms in per_kernel.items():
        cs.say(f"  profiled per step, {'FFMA' if side == 'old' else 'wgmma'}"
               ": " + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(
                   ms.items())) + f" [{cs.CARD}]")
    out = {"card": cs.CARD, "dtype": str(dtype), "per_step": dict(sums),
           "f64_errs": f64_errs if args.f32 else None,
           "per_kernel": {k: dict(v) for k, v in per_kernel.items()},
           "rows": rows}
    line = json.dumps({"k2_bwd_compare": out})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
