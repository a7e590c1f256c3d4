"""Time the Trainer's replayed training step of one tree of the port, and
say whether two eager steps from one state agree bit for bit (card only).

    python3 scripts/torch_train_step_determinism.py --root DIR --label NAME \\
        --out FILE [--cudnn-deterministic] [--f0] [--steps 12] [--warmup 3]

Imports `ns2vc_tpu_torch` from `--root` (this checkout by default; an
older commit unpacked with `git archive` into a gitignored directory for a
comparison), builds its kernels, and trains `Config()` at full width
(seed-0 weights, AdamW, EMA) on seeded random batches of 32 x 272 content
and 272 refer frames, bf16, remat "dots" (with `--f0`, the F0 predictor
on), through `Trainer.train_step`:

- two eager steps (`Trainer._train_step_eager`) from one state on one
  batch: whether the loss, the grad norm, every parameter, both AdamW
  moments and the EMA agree bit for bit;
- the step key's first call (the eager warm-up and the CUDA-graph
  capture), then the median wall ms of `--steps` replays after `--warmup`,
  each synchronised, and the peak memory.

`--cudnn-deterministic` sets `torch.backends.cudnn.deterministic` for the
whole process before anything runs (the older tree's only way to a
deterministic step). To compare trees or modes, run them in turns in one
call on one card (A, B, C, C, B, A). Appends one JSON line to `--out` and
prints it, with the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

B, T, TP = 32, 272, 272


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def host_batch(seed: int) -> dict:
    r = np.random.default_rng(seed)
    return {"c": r.standard_normal((B, T, 256)).astype(np.float32),
            "refer": r.standard_normal((B, TP, 100)).astype(np.float32),
            "spec": r.standard_normal((B, T, 100)).astype(np.float32),
            "f0": (120 + 200 * r.random((B, T))).astype(np.float32),
            "uv": (r.random((B, T)) > 0.2).astype(np.float32),
            "lengths": r.integers(T // 2, T + 1, B).astype(np.int32),
            "refer_lengths": r.integers(TP // 2, TP + 1, B).astype(np.int32)}


def snapshot(tr) -> dict:
    opt = tr.state.optimizer.state
    return {"model": {k: v.detach().clone()
                      for k, v in tr.model.state_dict().items()},
            "opt": [{k: v.clone() for k, v in opt[p].items()}
                    for g in tr.state.optimizer.param_groups
                    for p in g["params"]],
            "ema": {k: v.clone() for k, v in tr.state.ema_params.items()},
            "step": tr.state.step}


def restore(tr, snap: dict) -> None:
    """Copy a snapshot into the live tensors (a step program's graph holds
    their addresses); an optimizer that had no state for a parameter
    loses what it has since made."""
    import torch

    tr.model.load_state_dict(snap["model"])
    opt = tr.state.optimizer.state
    params = [p for g in tr.state.optimizer.param_groups for p in g["params"]]
    with torch.no_grad():
        for p, saved in zip(params, snap["opt"]):
            if not saved:
                opt.pop(p, None)
            for k, v in saved.items():
                opt[p][k].copy_(v)
        for k, v in snap["ema"].items():
            tr.state.ema_params[k].copy_(v)
    tr.state.step = snap["step"]


def differing(a: dict, b: dict) -> list:
    import torch

    out = [f"parameter {k}" for k in a["model"]
           if not torch.equal(a["model"][k], b["model"][k])]
    out += [f"AdamW {k} of parameter {i}" for i, (x, y) in
            enumerate(zip(a["opt"], b["opt"])) for k in x
            if not torch.equal(x[k], y[k])]
    out += [f"EMA {k}" for k in a["ema"]
            if not torch.equal(a["ema"][k], b["ema"][k])]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cudnn-deterministic", action="store_true")
    ap.add_argument("--f0", action="store_true",
                    help="Config() with the F0 predictor")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_train_step_determinism: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import ns2vc_tpu_torch
    from ns2vc_tpu_torch.config import (
        Config, DataConfig, F0PredictorConfig, TrainConfig,
    )
    from ns2vc_tpu_torch.ops import _build
    from ns2vc_tpu_torch.train.trainer import Trainer

    if not os.path.abspath(ns2vc_tpu_torch.__file__).startswith(root):
        raise SystemExit(f"imported {ns2vc_tpu_torch.__file__}, not {root}")
    if args.cudnn_deterministic:
        torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    tmp = tempfile.TemporaryDirectory()
    empty = os.path.join(tmp.name, "empty")
    os.makedirs(empty)
    cfg = Config(train=TrainConfig(train_batch_size=B, num_workers=0,
                                   use_ema=True,
                                   logs_folder=os.path.join(tmp.name, "logs")),
                 data=DataConfig(training_files=empty, val_files=empty),
                 f0_predictor=F0PredictorConfig(enabled=args.f0))
    tr = Trainer(cfg, logs_folder=os.path.join(tmp.name, "run"),
                 device="cuda")
    batches = [tr.device_batch(host_batch(s)) for s in range(4)]

    # two eager steps from one state
    start = snapshot(tr)
    runs = []
    for _ in range(2):
        restore(tr, start)
        m = tr._train_step_eager(batches[0])
        torch.cuda.synchronize()
        runs.append((m["loss"].item(), m["grad_norm"].item(), snapshot(tr)))
    restore(tr, start)
    diff = differing(runs[0][2], runs[1][2])
    repeat = {"bitwise": not diff and runs[0][:2] == runs[1][:2],
              "losses": [r[0] for r in runs],
              "grad_norms": [r[1] for r in runs],
              "tensors_differing": len(diff), "first": diff[:4]}
    del runs, start

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tr.train_step(batches[0])
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1e3
    for i in range(args.warmup):
        tr.train_step(batches[i % len(batches)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(args.steps):
        t1 = time.perf_counter()
        m = tr.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    out = {"label": args.label, "root": root,
           "cudnn_deterministic_set": args.cudnn_deterministic,
           "f0": args.f0,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "card": card_line(), "build_s": build_s,
           "eager_repeat": repeat, "first_call_ms": first_ms,
           "replay_ms": times, "replay_median_ms": float(np.median(times)),
           "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "loss": m["loss"].item(), "programs": len(tr._step_programs)}
    tr.close()
    tmp.cleanup()
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
