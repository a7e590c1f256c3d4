"""The GroupNorm statistics' backward (the hand-written kernel,
`csrc/group_norm_affine_bwd.cu`) against what it replaced, on one GPU, in
turns, at every statistics call of a `Config()` training step.

    git show 7602d88:ns2vc_tpu_torch/csrc/group_norm_affine_bwd.cu \
        > .scratch/group_norm_affine_bwd_old.cu
    python3 scripts/torch_gn_bwd_compare.py [--old-source OLD.cu]
        [--launch-floor] [--out FILE]

The calls are enumerated from the step itself (scripts/torch_k1_bwd_
compare.py's `step_calls`: the step body on the meta device at
`chip_smoke.TRAIN_B` x `TRAIN_T`, bf16, remat off, one call per backward):
45 calls in 21 geometries of x (B, T, C), with FiLM or without. At each,
on seeded bf16 x, gamma and beta, FiLM as two chunks of one (B, 2C)
projection where the step has one, and f32 da, db, it
- holds the kernel (`group_norm_affine_grad`, over the mean and rstd the
  forward kernel keeps) against its plain version (`group_norm_affine_
  backward` on the same mean and rstd) per gradient (`chip_smoke.
  gn_grad_error` within `gn_grad_rtol`), and two launches bit for bit;
- times, each the device time of 10 calls captured as one CUDA graph, in
  turns (`chip_smoke.gn_backward_case`): the kernel, the autograd
  recompute of `group_norm_affine_plain` that the step ran before the
  kernels (the old path), the closed form in torch ops, and back; the
  bound is `chip_smoke.gn_backward_bound` (x read and dx written once);
- with --old-source, an older `group_norm_affine_bwd.cu` (commit
  7602d88's two kernels, a coefficient kernel then a dx kernel; its entry
  takes a workspace of 4 B G floats and the dx kernel's blocks of the
  whole tensor), built with nvcc into the gitignored `.scratch/`, bound
  with ctypes and called with its own wrapper's arguments: held to the
  same bound and bitwise repeat, and timed in turns, old, new, new, old;
- with --launch-floor, the current source with the kernel's body taken out
  (every block waits on the kernel before it and returns; the same grid):
  the least a launch of this shape costs in a graph, in turns with the
  kernel;
- and the device time of each kernel a call launches (gn_bwd; the old
  source's coef and dx) from torch.profiler over eager calls.
Every time carries the card's name and power limit. Prints a line per
geometry, the sums per training step, and a JSON line
{"gn_bwd_compare": ...} last (also to --out). Card only; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from collections import Counter, defaultdict

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from torch_k1_bwd_compare import step_calls  # noqa: E402


def kernel_ms(run, reps=3) -> dict:
    """Device ms of each kernel one call launches (gn_bwd; the older
    source's coef and dx; other) from torch.profiler over `reps` eager
    calls."""
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
        name = next((k for k in ("coef", "dx") if f"gn_bwd_{k}_kernel"
                     in e.key), "gn_bwd" if "gn_bwd_kernel" in e.key
                    else "other")
        out[name] += us / 1e3 / reps
    return dict(out)


# the older entry: a coefficient workspace (4 B G floats) after dshift
OLD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p]
                * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def build(name: str, source: str):
    """`ns2vc_group_norm_affine_bwd` of a source, compiled once per source
    text into .scratch/ (the current csrc/ on the include path)."""
    from ns2vc_tpu_torch.ops import _build

    text = open(source, "rb").read()
    tag = hashlib.sha256(text).hexdigest()[:12]
    out = os.path.join(cs_root(), ".scratch", f"lib{name}_{tag}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
               str(_build.CSRC_DIR), source, "-o", out, *_build.LINK_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            cs.fail(f"{name} build: {proc.stdout}{proc.stderr}")
    return ctypes.CDLL(out).ns2vc_group_norm_affine_bwd


def cs_root() -> str:
    return os.path.dirname(HERE)


def floor_source() -> str:
    """The current source with the kernel's body taken out: every block
    waits on the kernel before it and returns (written into .scratch/)."""
    from ns2vc_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / "group_norm_affine_bwd.cu").read_text()
    anchor = ("  extern __shared__ float4 coef[];   // G per-group "
              "coefficients\n")
    if src.count(anchor) != 1:
        cs.fail("launch floor: the kernel's first line is not in the source")
    src = src.replace(anchor, anchor + "  if constexpr (kPdl) "
                      "grid_dependency_wait();\n  if (a.B >= 0) return;\n")
    out = os.path.join(cs_root(), ".scratch", "group_norm_affine_bwd_floor.cu")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        fh.write(src)
    return out


def old_grad(fn, x, gamma, beta, fs, mean, rstd, da, db):
    """A closure that runs the older kernels on these inputs as their
    wrapper called them (parameters checked and cast by the current
    `_gn_params`, a fresh coefficient workspace, the dx kernel's blocks
    over the whole tensor): (dx, dgamma, dbeta, dscale, dshift)."""
    from ns2vc_tpu_torch.ops import _build
    from ns2vc_tpu_torch.ops.fused_resnet import (
        GN_BWD_THREADS, GN_BWD_VECS, _gn_params,
    )

    params, film_stride = _gn_params(x, gamma, beta, *fs, "old")
    bsz, t, c = x.shape
    film = len(params) == 4
    per = 16 // x.element_size()
    vec = (c // 8) % per == 0 and x.data_ptr() % 16 == 0
    width = per if vec else 1
    blocks = -(-bsz * t * c // (width * GN_BWD_THREADS * GN_BWD_VECS))
    pdt = params[0].dtype

    def run():
        dx = torch.empty_like(x)
        dgamma, dbeta = torch.empty((2, c), dtype=pdt, device=x.device)
        dscale = dshift = None
        if film:
            dscale, dshift = torch.empty((2, bsz, c), dtype=pdt,
                                         device=x.device)
        coef = torch.empty((bsz, 8, 4), dtype=torch.float32,
                           device=x.device)
        err = fn(x.data_ptr(), params[0].data_ptr(), params[1].data_ptr(),
                 *((params[2].data_ptr(), params[3].data_ptr()) if film
                   else (None, None)), film_stride, mean.data_ptr(),
                 rstd.data_ptr(), da.data_ptr(), db.data_ptr(),
                 dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                 *((dscale.data_ptr(), dshift.data_ptr()) if film
                   else (None, None)), coef.data_ptr(), bsz, t, c, 8,
                 blocks, int(x.dtype == torch.bfloat16),
                 int(pdt == torch.bfloat16), int(vec), _build.stream_of(x))
        if err:
            cs.fail(f"older statistics backward: CUDA error {err}")
        return dx, dgamma, dbeta, dscale, dshift
    return run


def with_entry(fn):
    """The wrappers' library with `ns2vc_group_norm_affine_bwd` replaced."""
    from unittest import mock

    from ns2vc_tpu_torch.ops import _build

    main = _build.library()
    lib = type("Lib", (), {"ns2vc_group_norm_affine_bwd": staticmethod(fn),
                           "__getattr__": lambda self, n: getattr(main, n)})()
    return mock.patch.object(_build, "library", lambda: lib)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--old-source", default=None,
                    help="an older csrc/group_norm_affine_bwd.cu (commit "
                         "7602d88's two kernels), timed in turns at every "
                         "call")
    ap.add_argument("--launch-floor", action="store_true",
                    help="also time the kernel with its body taken out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gn_bwd_compare: no CUDA device", file=sys.stderr)
        return 2
    from ns2vc_tpu_torch.ops import _build
    from ns2vc_tpu_torch.ops.fused_resnet import (
        _gn_launch, group_norm_affine_backward, group_norm_affine_grad,
    )

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.CARD = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; {cs.CARD}")
    old_fn = floor_fn = None
    if args.old_source:
        old_fn = build("gn_bwd_old", args.old_source)
        old_fn.argtypes, old_fn.restype = OLD_ARGTYPES, ctypes.c_int
    if args.launch_floor:
        floor_fn = build("gn_bwd_floor", floor_source())
        floor_fn.argtypes = _build._SIGNATURES["ns2vc_group_norm_affine_bwd"]
        floor_fn.restype = ctypes.c_int
    calls = Counter()
    step_calls(cs.TRAIN_B, cs.TRAIN_T, cs.TRAIN_T, calls)
    cs.say(f"statistics calls of one bf16 training step (B={cs.TRAIN_B} x "
           f"{cs.TRAIN_T}, remat off): {sum(calls.values())} in "
           f"{len(calls)} geometries")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 95)
    rows, sums, per_kernel = [], defaultdict(float), defaultdict(float)
    for ((bsz, t, c), film), n in sorted(calls.items()):
        x = (0.5 + torch.randn(bsz, t, c, generator=g, device=dev)).bfloat16()
        gamma = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).bfloat16()
        beta = (0.1 * torch.randn(c, generator=g, device=dev)).bfloat16()
        fs = [None, None]
        if film:
            fs = list((0.2 * torch.randn(bsz, 2 * c, generator=g, device=dev))
                      .bfloat16().chunk(2, dim=-1))
        da, db = (torch.randn(bsz, c, generator=g, device=dev)
                  for _ in range(2))
        r = cs.gn_backward_case(x, gamma, beta, fs, da, db)
        if not (r["ok"] and r["repeat"]):
            cs.fail(f"statistics backward x{(bsz, t, c)} film={film}: error "
                    f"{r['err']:.3e} of max|plain|, bitwise repeat "
                    f"{r['repeat']}")
        _, _, mean, rstd = _gn_launch(x, gamma, beta, 8, 1e-5, *fs,
                                      stats=True)

        def new():
            return group_norm_affine_grad(x, gamma, beta, 8, *fs, mean,
                                          rstd, da, db)
        kernels = kernel_ms(new)
        row = {"x": [bsz, t, c], "film": film, "calls": n, "ms": r["ms"],
               "recompute_ms": r["recompute"], "plain_ms": r["plain"],
               "turns": r["turns"], "bound_ms": r["bound"],
               "bound_by": r["bound_by"], "err": r["err"],
               "abs_err": r["abs_err"], "kernels": kernels}
        more = ""
        if old_fn is not None:
            run_old = old_grad(old_fn, x, gamma, beta, fs, mean, rstd, da,
                               db)
            og, og2 = run_old(), run_old()
            want = group_norm_affine_backward(x, gamma, beta, 8, 1e-5, *fs,
                                              da, db, mean, rstd)
            torch.cuda.synchronize()
            pairs = [(a, w) for a, w in zip(og, want) if w is not None]
            ok = all(cs.gn_grad_error(a, w) <= cs.gn_grad_rtol(w.dtype)
                     for a, w in pairs)
            same = all(torch.equal(a, b) for a, b in zip(og, og2)
                       if a is not None)
            if not (ok and same):
                cs.fail(f"older statistics backward x{(bsz, t, c)}: within "
                        f"the bound {ok}, bitwise repeat {same}")
            tt = [cs.graph_ms(f) for f in (run_old, new, new, run_old)]
            row["old"] = {"old_ms": (tt[0] + tt[3]) / 2,
                          "new_ms": (tt[1] + tt[2]) / 2, "turns": tt,
                          "kernels": kernel_ms(run_old)}
            for k, ms in row["old"]["kernels"].items():
                per_kernel["old_" + k] += n * ms
            sums["old_ms"] += n * row["old"]["old_ms"]
            sums["new_ms"] += n * row["old"]["new_ms"]
            more += (f"; the older kernels {tt[0]:.4f}/{tt[3]:.4f} ms, this "
                     f"{tt[1]:.4f}/{tt[2]:.4f} in turns")
        if floor_fn is not None:
            def floor():
                with with_entry(floor_fn):
                    return new()
            tt = [cs.graph_ms(f) for f in (new, floor, floor, new)]
            row["floor"] = {"floor_ms": (tt[1] + tt[2]) / 2,
                            "new_ms": (tt[0] + tt[3]) / 2, "turns": tt}
            sums["floor_ms"] += n * row["floor"]["floor_ms"]
            sums["floor_new_ms"] += n * row["floor"]["new_ms"]
            more += (f"; the launch floor (body taken out) {tt[1]:.4f}/"
                     f"{tt[2]:.4f} ms, this {tt[0]:.4f}/{tt[3]:.4f}")
        for k, ms in kernels.items():
            per_kernel[k] += n * ms
        rows.append(row)
        for k in ("ms", "recompute_ms", "plain_ms", "bound_ms"):
            sums[k] += n * row[k]
        tr = r["turns"]
        cs.say(f"statistics backward x{(bsz, t, c)} film={int(film)} x{n}: "
               f"kernel {tr['ms'][0]:.4f}/{tr['ms'][1]:.4f} ms, autograd "
               f"recompute {tr['recompute'][0]:.4f}/{tr['recompute'][1]:.4f}"
               f", closed form in torch ops {r['plain']:.4f}, bound "
               f"{r['bound']:.5f} ({r['bound_by']}); err {r['err']:.2e} of "
               f"max|plain|; profiled: " + ", ".join(
                   f"{k} {v:.4f}" for k, v in sorted(kernels.items()))
               + more + f" [{cs.CARD}]")
    cs.say(f"statistics backward, one training step's "
           f"{sum(calls.values())} calls (B={cs.TRAIN_B} x {cs.TRAIN_T}, "
           f"bf16): kernel {sums['ms']:.4f} ms, the autograd recompute "
           f"{sums['recompute_ms']:.4f}, the closed form in torch ops "
           f"{sums['plain_ms']:.4f}; bound {sums['bound_ms']:.5f} "
           f"({100 * sums['bound_ms'] / sums['ms']:.1f} % of the kernel's); "
           f"worst err {max(r['err'] for r in rows):.2e}; profiled per "
           f"step: " + ", ".join(f"{k} {v:.4f}"
                                 for k, v in sorted(per_kernel.items()))
           + f" [{cs.CARD}]")
    if old_fn is not None:
        cs.say(f"statistics backward in turns, the older kernels -> this: "
               f"{sums['old_ms']:.4f} -> {sums['new_ms']:.4f} ms per step "
               f"[{cs.CARD}]")
    if floor_fn is not None:
        cs.say(f"statistics backward, the launch floor (same grid, body "
               f"taken out) {sums['floor_ms']:.4f} ms per step against this "
               f"kernel's {sums['floor_new_ms']:.4f} in turns [{cs.CARD}]")
    out = {"card": cs.CARD, "per_step": dict(sums),
           "per_kernel": dict(per_kernel), "rows": rows}
    line = json.dumps({"gn_bwd_compare": out})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
