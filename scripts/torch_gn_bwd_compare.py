"""The GroupNorm statistics' backward (the hand-written kernels,
`csrc/group_norm_affine_bwd.cu`) against what it replaced, on one GPU, in
turns, at every statistics call of a `Config()` training step.

    python3 scripts/torch_gn_bwd_compare.py [--out FILE]

The calls are enumerated from the step itself (scripts/torch_k1_bwd_
compare.py's `step_calls`: the step body on the meta device at
`chip_smoke.TRAIN_B` x `TRAIN_T`, bf16, remat off, one call per backward):
45 calls in 21 geometries of x (B, T, C), with FiLM or without. At each,
on seeded bf16 x, gamma and beta, FiLM as two chunks of one (B, 2C)
projection where the step has one, and f32 da, db, it
- holds the kernels (`group_norm_affine_grad`, over the mean and rstd the
  forward kernel keeps) against their plain version (`group_norm_affine_
  backward` on the same mean and rstd) per gradient (`chip_smoke.
  gn_grad_error` within `gn_grad_rtol`), and two launches bit for bit;
- times, each the device time of 10 calls captured as one CUDA graph, in
  turns (`chip_smoke.gn_backward_case`): the kernels, the autograd
  recompute of `group_norm_affine_plain` that the step ran before them
  (the old path), the closed form in torch ops, and back; the bound is
  `chip_smoke.gn_backward_bound` (x read and dx written once);
- and the device time of each of the two kernels a call launches (coef,
  dx) from torch.profiler over eager calls.
Every time carries the card's name and power limit. Prints a line per
geometry, the sums per training step, and a JSON line
{"gn_bwd_compare": ...} last (also to --out). Card only; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter, defaultdict

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from torch_k1_bwd_compare import step_calls  # noqa: E402


def kernel_ms(run, reps=3) -> dict:
    """Device ms of each kernel one call launches (gn_bwd_coef, gn_bwd_dx,
    other) from torch.profiler over `reps` eager calls."""
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
                     in e.key), "other")
        out[name] += us / 1e3 / reps
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gn_bwd_compare: no CUDA device", file=sys.stderr)
        return 2
    from ns2vc_tpu_torch.ops.fused_resnet import (
        _gn_launch, group_norm_affine_grad,
    )

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.CARD = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; {cs.CARD}")
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
        kernels = kernel_ms(lambda: group_norm_affine_grad(
            x, gamma, beta, 8, *fs, mean, rstd, da, db))
        for k, ms in kernels.items():
            per_kernel[k] += n * ms
        row = {"x": [bsz, t, c], "film": film, "calls": n, "ms": r["ms"],
               "recompute_ms": r["recompute"], "plain_ms": r["plain"],
               "turns": r["turns"], "bound_ms": r["bound"],
               "bound_by": r["bound_by"], "err": r["err"],
               "abs_err": r["abs_err"], "kernels": kernels}
        rows.append(row)
        for k in ("ms", "recompute_ms", "plain_ms", "bound_ms"):
            sums[k] += n * row[k]
        tr = r["turns"]
        cs.say(f"statistics backward x{(bsz, t, c)} film={int(film)} x{n}: "
               f"kernels {tr['ms'][0]:.4f}/{tr['ms'][1]:.4f} ms, autograd "
               f"recompute {tr['recompute'][0]:.4f}/{tr['recompute'][1]:.4f}"
               f", closed form in torch ops {r['plain']:.4f}, bound "
               f"{r['bound']:.5f} ({r['bound_by']}); err {r['err']:.2e} of "
               f"max|plain|; profiled: " + ", ".join(
                   f"{k} {v:.4f}" for k, v in sorted(kernels.items()))
               + f" [{cs.CARD}]")
    cs.say(f"statistics backward, one training step's "
           f"{sum(calls.values())} calls (B={cs.TRAIN_B} x {cs.TRAIN_T}, "
           f"bf16): kernels {sums['ms']:.4f} ms, the autograd recompute "
           f"{sums['recompute_ms']:.4f}, the closed form in torch ops "
           f"{sums['plain_ms']:.4f}; bound {sums['bound_ms']:.5f} "
           f"({100 * sums['bound_ms'] / sums['ms']:.1f} % of the kernels'); "
           f"worst err {max(r['err'] for r in rows):.2e}; profiled per "
           f"step: " + ", ".join(f"{k} {v:.4f}"
                                 for k, v in sorted(per_kernel.items()))
           + f" [{cs.CARD}]")
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
