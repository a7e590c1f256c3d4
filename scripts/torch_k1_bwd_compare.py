"""K1's bf16 backward (the hand-written kernels) against the plain torch-ops
backward it replaced and SDPA's backward, on one GPU, in turns, at every K1
call of a `Config()` training step; with --f32, K1's f32 backward kernels
the same way (TF32 off) at the F0 predictor's cross-attention (B = 32 x
272, 8 heads of 32, key padding: its 10 calls a step) and at every K1
geometry of the step at B = 2 (the f32 gradient checks').

    python3 scripts/torch_k1_bwd_compare.py [--f32] [--old-source OLD.cu]
        [--out FILE]

With --f32 the op registry's f32 layers whose backward takes the 128-wide
instantiation ("f32tc_d128": ids 14 and 15 at C = 256, two heads of 128)
and unaligned rows ("f32tc_pad": id 14 at C = 198, two heads of 99) are
timed too, their calls recorded from one training step of each layer at
`chip_smoke.MODULE_B` x `MODULE_T` (`chip_smoke.REGISTRY_BWD_CASES`).
--old-source builds an older source of the dtype's kernels: with --f32
`csrc/flash_attention_f32_bwd_wgmma.cu` (`git show 3eefe3f:ns2vc_tpu_torch/
csrc/flash_attention_f32_bwd_wgmma.cu > .scratch/k1_f32_bwd_old.cu` before
the chip call: the copy there has no .git), else `csrc/flash_attention_
bwd_wgmma.cu` (the earlier design: `git show 7602d88:ns2vc_tpu_torch/csrc/
flash_attention_bwd_wgmma.cu > .scratch/k1_bwd_old.cu`), bound with ctypes
as its wrapper launched it (rows TMA cannot take on zero-padded contiguous
copies, dO made contiguous where TMA cannot read it, lse and Delta in
`bwd_workspace`), and times it at every call of more than one query in
turns with the current kernels (old, new, new, old), held to the same
bound (f32: against f64; bf16: K1_BWD_RTOL and K1_BWD_RMS against the
plain backward) and a bitwise repeat, each of its kernels profiled; f32
rows whose plan splits a kernel over a cluster are also timed with the
splits at 1, in turns.

The calls are enumerated from the step itself: the step body of
`train/trainer.py::make_train_step` runs once on the meta device (no
memory, no card) at `chip_smoke.TRAIN_B` x `TRAIN_T`, bf16, remat off (one
call per backward), with `ops/attention.py`'s `flash_attention` replaced
by a recorder of each call's q, k, v layout (shape, strides, storage
offset and size), scale and whether a key bias came: 46 calls in 11
geometries. At each geometry, on seeded bf16 q, k, v laid out as the
step's, a key-padding bias where the step has one and dO laid out as
autograd hands it (a head view of a (B, Tq, C) gradient), it
- holds the kernels (`flash_attention_grad`) against the plain backward
  (`flash_attention_backward`) per gradient (`chip_smoke.k1_grad_errors`):
  the largest error within `chip_smoke.K1_BWD_RTOL` of each batch row's
  max|plain|, the relative RMS error within `K1_BWD_RMS` of the
  gradient's norm; and two launches bit for bit;
- reads the same errors of faulty backwards (`faulty_backward`, torch
  ops): dV from P not rounded to bf16, dS in one bf16 plane, Delta from
  the bf16 O, and each gradient 10 % off in one batch row (the kernels and
  this one also by the older metric, of max(1, max|plain|) per tensor), so
  the bounds can be set between what the kernels read and what a wrong
  backward reads;
- times kernels, plain, SDPA, SDPA, plain, kernels, each the device time of
  10 calls captured as one CUDA graph (`chip_smoke.k1_backward_case`);
  SDPA's backward is `scaled_dot_product_attention` with the bias as an
  additive mask, forward and backward through autograd, less its forward
  (timing only: the port never calls it); the bound is `chip_smoke.
  k1_backward_bound`;
- and the device time of each kernel a call launches (dq, dkdv, q1) from
  torch.profiler over eager calls.
In f32 the faulty backwards are not read: the kernels and the plain f32
backward are read against the plain backward in f64, within
`chip_smoke.k1_f32_holds`. Last, ptxas's registers and spills of
every instantiation of `csrc/flash_attention_bwd_wgmma.cu` (--f32:
`csrc/flash_attention_f32_bwd_wgmma.cu`; compiled once more with
-Xptxas=-v into the gitignored `.scratch/`), and the blocks an SM holds by
registers. Every time carries the card's name and
power limit. Prints a line per geometry, the sums per training step, and a
JSON line {"k1_bwd_compare": ...} last (also to --out). Card only; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from collections import Counter, defaultdict
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {dtype: os.path.join(ROOT, "ns2vc_tpu_torch", "csrc", name)
           for dtype, name in (("bf16", "flash_attention_bwd_wgmma.cu"),
                               ("f32", "flash_attention_f32_bwd_wgmma.cu"))}
F0_CALLS = 10   # the F0 predictor's f32 cross-attentions per step


def step_calls(bsz: int, t: int, tp: int, gn: Counter | None = None
               ) -> Counter:
    """The K1 calls of one bf16 `Config()` training step, remat off, by
    (layout of q, k, v; scale; bias given): the step body run on the meta
    device, dropout off (its draws need a generator on the device). With
    `gn`, the GroupNorm statistics' calls into it too, by (x's shape,
    whether FiLM came)."""
    import ns2vc_tpu_torch.ops.attention as attention
    import ns2vc_tpu_torch.ops.flash_attention as fa
    import ns2vc_tpu_torch.ops.fused_resnet as fr
    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
    from ns2vc_tpu_torch.train.trainer import (
        TrainState, make_optimizer, make_train_step,
    )

    calls = Counter()

    def record(q, k, v, bias=None, scale=None):
        geo = tuple((tuple(x.shape), x.stride(), x.storage_offset(),
                     x.untyped_storage().nbytes() // x.element_size())
                    for x in (q, k, v))
        calls[(geo, scale, bias is not None)] += 1
        return fa.flash_attention_plain(q, k, v, bias, scale)

    def record_gn(x, gamma, beta, groups, eps, film_scale=None,
                  film_shift=None):
        if gn is not None:
            gn[(tuple(x.shape), film_scale is not None)] += 1
        return fr.group_norm_affine_plain(x, gamma, beta, groups, eps,
                                          film_scale, film_shift)
    meta = torch.device("meta")
    cfg = Config()
    with torch.device(meta):
        model = NaturalSpeech2(cfg, remat=False)
    for m in model.modules():
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    batch = {"c": torch.randn(bsz, t, 256, device=meta),
             "refer": torch.randn(bsz, tp, 100, device=meta),
             "spec": torch.randn(bsz, t, 100, device=meta),
             "lengths": torch.full((bsz,), t, device=meta),
             "refer_lengths": torch.full((bsz,), tp, device=meta)}
    state = TrainState(model, make_optimizer(cfg, model.parameters()))
    step = make_train_step(compute_dtype=torch.bfloat16)
    with mock.patch.object(attention, "flash_attention", record), \
            mock.patch.object(fr, "affine_silu_conv1d",
                              fr.affine_silu_conv1d_plain), \
            mock.patch.object(fr, "group_norm_affine", record_gn), \
            mock.patch.object(fr, "gn_route", lambda device: "plain"):
        step.body(state, batch, None, torch.zeros(bsz, device=meta),
                  torch.randn(bsz, t, 100, device=meta), None,
                  torch.zeros((), dtype=torch.int64, device=meta))
    return calls


def f0_call(bsz: int, t: int, tp: int) -> tuple:
    """The F0 predictor's cross-attention as a step_calls key: q, k and v
    head views of their own (B, T, 256) projections (k and v upcast from
    bf16, as the wrapper does), 8 heads of 32, a key bias."""
    def view(n):
        return ((bsz, 8, n, 32), (n * 256, 32, 256, 1), 0, bsz * n * 256)
    return (view(t), view(tp), view(tp)), None, True


def inputs(key, g, dev, dtype=torch.bfloat16):
    """Seeded q, k, v in the call's layout, a key-padding bias (first
    row whole) where it had one, dO as a head view of (B, Tq, H*D)."""
    geo, _, with_bias = key
    bufs = [torch.randn(size, generator=g, device=dev).to(dtype)
            for _, _, _, size in geo]
    q, k, v = (b.as_strided(shape, stride, offset)
               for b, (shape, stride, offset, _) in zip(bufs, geo))
    bsz, h, tq, d = q.shape
    tk = k.shape[2]
    bias = None
    if with_bias:
        lengths = torch.randint(1, tk + 1, (bsz,), generator=g, device=dev)
        lengths[0] = tk
        keep = torch.arange(tk, device=dev)[None, :] < lengths[:, None]
        bias = (1.0 - keep.float()) * -1e4
    do = torch.randn(bsz, tq, h * d, generator=g, device=dev).to(dtype) \
        .view(bsz, tq, h, d).transpose(1, 2)
    return q, k, v, bias, do


FAULTS = ("dV from P unrounded", "dS in one bf16 plane",
          "Delta from the bf16 O", "10 % off in one batch row")


def faulty_backward(q, k, v, bias, scale, do, fault):
    """`flash_attention_backward` with one of FAULTS, in torch ops, its
    outputs in bf16."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    logits = qf @ kf.transpose(-1, -2) * scale
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    pv = p if fault == FAULTS[0] else p.bfloat16().float()
    dv = pv.transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    if fault == FAULTS[2]:
        o = (p.bfloat16().float() @ vf).bfloat16().float()
        delta = (dof * o).sum(-1, keepdim=True)
    else:
        delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if fault == FAULTS[1]:
        ds = ds.bfloat16().float()
    out = [ds @ kf * scale, ds.transpose(-1, -2) @ qf * scale, dv]
    if fault == FAULTS[3]:
        for t in out:
            t[-1] *= 1.1
    return [t.bfloat16() for t in out]


def old_errors(got, want):
    """The bound's older metric: max |got - want| of max(1, max|want|) per
    gradient."""
    return [((a.float() - b.float()).abs().max()
             / max(1.0, b.float().abs().max().item())).item()
            for a, b in zip(got, want)]


def kernel_ms(run, reps=3):
    """Device ms of each kernel one call launches, from torch.profiler over
    `reps` eager calls: the tile kernels (dq, dkdv), the single-query
    kernel (q1), and the rest (other)."""
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
        m = re.search(r"flash_bwd_(?:f32_)?(dq|dkdv|q1|convert)_kernel",
                      e.key)
        name = m.group(1) if m else "other"
        out[name] += us / 1e3 / reps
    return dict(out)


def build_old(source: str, f32: bool):
    """An older backward's entry point (f32 or bf16), compiled once per
    source into .scratch/ (the current csrc/ on the include path)."""
    from ns2vc_tpu_torch.ops import _build

    text = open(source, "rb").read()
    tag = hashlib.sha256(text).hexdigest()[:12]
    out = os.path.join(ROOT, ".scratch", f"libk1_bwd_old_{tag}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
               str(_build.CSRC_DIR), source, "-o", out, *_build.LINK_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            cs.fail(f"old kernel build: {proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(out), "ns2vc_flash_attention_f32_bwd_wgmma"
                 if f32 else "ns2vc_flash_attention_bwd_wgmma")
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_int64] * 21 + [ctypes.c_float,
                                              ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def old_grad(fn, q, k, v, bias, scale, do):
    """A closure that runs the older kernels on these inputs as their
    wrapper did: rows TMA cannot take as zero-padded contiguous copies (in
    the call), dO contiguous where TMA cannot read it; (dq, dk, dv)."""
    import ns2vc_tpu_torch.ops.flash_attention as fa
    from ns2vc_tpu_torch.ops import _build

    b, h, tq, d = q.shape
    tk = k.shape[2]
    route, dp = fa.grad_route(q, k, v)
    if not (_build.aligned16(do) and all(
            s > 0 for s, n in zip(do.stride()[:-1], do.shape) if n > 1)):
        do = do.contiguous()
    ws = torch.empty(fa.bwd_workspace(b, h, tq), dtype=torch.float32,
                     device=q.device)

    def run():
        ins = (q, k, v, do)
        if route.endswith("_pad"):
            ins = tuple(fa._padded(t, dp) for t in ins)
        grads = [torch.empty((b, t, h, dp), dtype=q.dtype, device=q.device)
                 .permute(0, 2, 1, 3) for t in (tq, tk, tk)]
        err = fn(*(t.data_ptr() for t in ins[:3]),
                 None if bias is None else bias.data_ptr(), ins[3].data_ptr(),
                 *(t.data_ptr() for t in grads), ws.data_ptr(), b, h, tq, tk,
                 dp, *(s for t in (*ins, *grads) for s in t.stride()[:3]),
                 float(scale), torch.cuda.current_stream().cuda_stream)
        if err:
            cs.fail(f"old kernels: CUDA error {err}")
        return tuple(g[..., :d] for g in grads)
    return run


def registry_calls(dev) -> list:
    """The f32 K1 backward calls of one training step through each f32
    layer of `chip_smoke.REGISTRY_BWD_CASES` (TF32 off): (label, q, k, v,
    bias, scale, do) as recorded."""
    from ns2vc_tpu_torch.convert import init_module_
    from ns2vc_tpu_torch.models.op_registry import OPERATIONS_ENCODER

    out = []
    lengths = torch.tensor([cs.MODULE_T - (i % 2) * cs.MODULE_T // 4
                            for i in range(cs.MODULE_B)])
    mask = (torch.arange(cs.MODULE_T)[None] < lengths[:, None]).to(dev)
    for op_id, c, dt, sub in cs.REGISTRY_BWD_CASES:
        if dt != "float32":
            continue
        layer = init_module_(OPERATIONS_ENCODER[op_id](c, 0.0),
                             torch.Generator().manual_seed(op_id)).to(
            dev).train()
        g = torch.Generator(device=dev).manual_seed(cs.SEED + 62 + op_id)
        x = torch.randn(cs.MODULE_B, cs.MODULE_T, c, generator=g,
                        device=dev).requires_grad_()
        store = {}
        with cs.no_tf32(), cs.record_k1_grads(store):
            layer(x, mask).float().square().mean().backward()
        torch.cuda.synchronize()
        for _, (q, k, v, bias, scale, do) in store.values():
            out.append((f"op {op_id} C={c} {sub}", q, k, v, bias, scale, do))
    return out


def blocks_by_registers(regs: int, threads: int) -> int:
    """Blocks an H100 SM holds by its 64K registers: each warp's are
    allocated in units of 256 (8 a thread)."""
    per_warp = -(-regs * 32 // 256) * 256
    return 65536 // (per_warp * -(-threads // 32))


def ptxas_report(f32: bool = False) -> list:
    """(kernel, registers, spill stores, spill loads, blocks an SM holds by
    registers) of every instantiation in the source, from nvcc
    -Xptxas=-v: the tile kernels run 160 threads (a consumer warpgroup and
    a producer warp; bf16 at heads of 32 or fewer 512, three consumer
    warpgroups and a producer warpgroup, the registers reported those a
    thread enters with, the consumers' raised by setmaxnreg), the f32
    converting pass and the single-query kernel 256."""
    from ns2vc_tpu_torch.ops import _build

    source = SOURCES["f32" if f32 else "bf16"]
    obj = os.path.join(ROOT, ".scratch", "flash_attention_bwd_ptxas.o")
    os.makedirs(os.path.dirname(obj), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", source,
                           "-o", obj], capture_output=True, text=True,
                          cwd=os.path.dirname(source))
    if proc.returncode != 0:
        cs.fail(f"nvcc: {proc.stdout}{proc.stderr}")
    out, name, spills = [], None, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(flash_bwd_\w+?_kernel)I((?:Li\d+E)*)((?:Lb\dE)*)",
                          m.group(1))
            dims = re.findall(r"Li(\d+)E", k.group(2))
            flags = re.findall(r"Lb(\d)E", k.group(3))
            name = k.group(1) + (f"<{', '.join(dims)}>" if dims else "") \
                + "".join(f" bias={f}" for f in flags)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            threads = 256 if name.startswith(("flash_bwd_q1",
                                              "flash_bwd_f32_convert")) \
                else 512 if not f32 and ("<16>" in name or "<32>" in name) \
                else 160
            row = (name, int(m.group(1)), *spills,
                   blocks_by_registers(int(m.group(1)), threads))
            if row not in out:
                out.append(row)
    return out


def fa_plan(q, k) -> tuple:
    """`plan_f32_backward` of an f32 call: (DP, dq's key tile, dkdv's query
    tile, dq's and dkdv's splits)."""
    from ns2vc_tpu_torch.ops.flash_attention import plan_f32_backward

    b, h, tq, d = q.shape
    return plan_f32_backward(b * h, tq, k.shape[2], d)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--f32", action="store_true",
                    help="K1's f32 backward kernels at the F0 predictor's "
                         "cross-attention, the step's geometries at B=2 and "
                         "the op registry's f32 layers")
    ap.add_argument("--old-source", default=None,
                    help="an older csrc/flash_attention_bwd_wgmma.cu (with "
                         "--f32: _f32_bwd_wgmma.cu), timed in turns at "
                         "every call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_bwd_compare: no CUDA device", file=sys.stderr)
        return 2
    from ns2vc_tpu_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_grad,
    )

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.CARD = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; {cs.CARD}")
    if args.f32:
        calls = Counter({f0_call(cs.TRAIN_B, cs.TRAIN_T, cs.TRAIN_T):
                         F0_CALLS})
        calls.update(step_calls(2, cs.TRAIN_T, cs.TRAIN_T))
        cs.say(f"K1 f32 calls: the F0 predictor's {F0_CALLS} cross-"
               f"attentions (B={cs.TRAIN_B}) and the step's at B=2: "
               f"{sum(calls.values())} in {len(calls)} geometries")
    else:
        calls = step_calls(cs.TRAIN_B, cs.TRAIN_T, cs.TRAIN_T)
        cs.say(f"K1 calls of one bf16 training step (B={cs.TRAIN_B} x "
               f"{cs.TRAIN_T}, remat off): {sum(calls.values())} in "
               f"{len(calls)} geometries")
    dtype = torch.float32 if args.f32 else torch.bfloat16
    f0_sums = defaultdict(float)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 90)
    cases = []   # (label, calls, q, k, v, bias, scale, do)
    for key, n in calls.items():
        q, k, v, bias, do = inputs(key, g, dev, dtype)
        scale = q.shape[-1] ** -0.5 if key[1] is None else key[1]
        label = "F0" if args.f32 and q.shape[0] == cs.TRAIN_B else "step"
        cases.append((label, n, q, k, v, bias, scale, do))
    if args.f32:
        cases += [(label, 1, *call) for label, *call in registry_calls(dev)]
    old_fn = build_old(args.old_source, args.f32) if args.old_source \
        else None
    old_sums = defaultdict(float)
    rows = []
    sums = defaultdict(float)
    per_kernel = defaultdict(float)
    worst = {}
    for label, n, q, k, v, bias, scale, do in cases:
        r = cs.k1_backward_case(q, k, v, bias, scale, do)
        old = None
        if old_fn is not None and not r["name"].endswith("_q1"):
            # (a call of one query takes the single-query kernel, which
            # the older source does not hold: it is the same kernel)
            run_old = old_grad(old_fn, q, k, v, bias, scale, do)
            og = [t.clone() for t in run_old()]
            og2 = run_old()
            torch.cuda.synchronize()
            if args.f32:
                errs, plain_errs = cs.k1_f32_errors(og, q, k, v, bias, scale,
                                                    do)
                old_ok = cs.k1_f32_holds(errs, plain_errs)
            else:
                errs, rms = cs.k1_grad_errors(og, flash_attention_backward(
                    q, k, v, bias, scale, do))
                old_ok = max(errs) <= cs.K1_BWD_RTOL \
                    and max(rms) <= cs.K1_BWD_RMS
            new = lambda: flash_attention_grad(  # noqa: E731
                q, k, v, bias, scale, do)
            turns = [cs.graph_ms(run_old), cs.graph_ms(new),
                     cs.graph_ms(new), cs.graph_ms(run_old)]
            old = {"old_ms": (turns[0] + turns[3]) / 2,
                   "new_ms": (turns[1] + turns[2]) / 2, "turns": turns,
                   "old_err" + ("64" if args.f32 else ""): max(errs),
                   "old_ok": old_ok,
                   "old_repeat": all(torch.equal(a_, b_)
                                     for a_, b_ in zip(og, og2)),
                   "old_kernels": kernel_ms(run_old)}
            for kname, ms in old["old_kernels"].items():
                per_kernel["old_" + kname] += n * ms
            old_sums[label + "_old"] += n * old["old_ms"]
            old_sums[label + "_new"] += n * old["new_ms"]
            old_sums["old"] += n * old["old_ms"]
            old_sums["new"] += n * old["new_ms"]
            cs.say(f"  {label} q{tuple(q.shape)} k{tuple(k.shape)} x{n}: "
                   f"the older kernels {turns[0]:.4f}/{turns[3]:.4f} ms, "
                   f"these {turns[1]:.4f}/{turns[2]:.4f} in turns; the older "
                   f"{'against f64' if args.f32 else 'against plain'} "
                   f"{max(errs):.2e}, bitwise repeat {old['old_repeat']}; "
                   "the older profiled: " + ", ".join(
                       f"{k_} {v_:.4f}" for k_, v_ in sorted(
                           old["old_kernels"].items())) + f" [{cs.CARD}]")
        if not (r["ok"] and r["repeat"]) or (old is not None and not (
                old["old_ok"] and old["old_repeat"])):
            cs.fail(f"K1 backward q{tuple(q.shape)} k{tuple(k.shape)}: "
                    f"error {r['err']} of the batch row's max|plain| (tol "
                    f"{cs.K1_BWD_RTOL}), relative RMS {r['rms']} (tol "
                    f"{cs.K1_BWD_RMS}), bitwise repeat {r['repeat']}")
        want = flash_attention_backward(q, k, v, bias, scale, do)
        got = flash_attention_grad(q, k, v, bias, scale, do)
        # per backward, (dq, dk, dv) by each metric
        controls = {"kernels": dict(zip(("max", "rms"), cs.k1_grad_errors(
            got, want)), older=old_errors(got, want))}
        for fault in () if args.f32 else FAULTS:
            bad = faulty_backward(q, k, v, bias, scale, do, fault)
            controls[fault] = dict(zip(("max", "rms"),
                                       cs.k1_grad_errors(bad, want)))
            if fault == FAULTS[3]:
                controls[fault]["older"] = old_errors(bad, want)
        # over the geometries: the least and the largest of each reading
        for name, errs in controls.items():
            for metric, e in errs.items():
                lo, hi = worst.get((name, metric), (1e9, 0.0))
                worst[(name, metric)] = (min(lo, max(e)), max(hi, max(e)))
        kernels = kernel_ms(lambda: flash_attention_grad(
            q, k, v, bias, scale, do))
        unsplit = None
        if args.f32 and max(fa_plan(q, k)[3:]) > 1:
            # the same kernels with the clusters' splits at 1, in turns
            import ns2vc_tpu_torch.ops.flash_attention as fa_mod

            real_plan = fa_mod.plan_f32_backward

            def one(*a):
                return (*real_plan(*a)[:3], 1, 1)
            new = lambda: flash_attention_grad(  # noqa: E731
                q, k, v, bias, scale, do)
            times = []
            for which in ("split", "one", "one", "split"):
                with mock.patch.object(fa_mod, "plan_f32_backward",
                                       one if which == "one" else real_plan):
                    times.append(cs.graph_ms(new))
            unsplit = {"split_ms": (times[0] + times[3]) / 2,
                       "one_ms": (times[1] + times[2]) / 2}
            cs.say(f"  {label} q{tuple(q.shape)}: plan {fa_plan(q, k)} "
                   f"{unsplit['split_ms']:.4f} ms, unsplit "
                   f"{unsplit['one_ms']:.4f} in turns [{cs.CARD}]")
        for kname, ms in kernels.items():
            per_kernel[kname] += n * ms
            if label == "F0":
                f0_sums["profiled_" + kname] += n * ms
        bound, by = cs.k1_backward_bound(q, k, bias)
        row = {"label": label, "q": list(q.shape), "k": list(k.shape),
               "plan": (list(fa_plan(q, k)) if args.f32 else None),
               "old": old, "unsplit": unsplit,
               "bias": bias is not None, "calls": n, "sub": r["name"],
               "ms": r["ms"], "plain_ms": r["plain"], "sdpa_ms": r["lib"],
               "turns": r["turns"],
               "sdpa_backend": cs.sdpa_backend(q, k, v, bias, scale),
               "bound_ms": bound, "bound_by": by, "err": r["err"],
               "rms": r["rms"], "err64": r.get("err64"),
               "plain_err64": r.get("plain_err64"),
               "abs_err": r["abs_err"], "kernels": kernels,
               "controls": controls}
        rows.append(row)
        for name in ("ms", "plain_ms", "sdpa_ms", "bound_ms"):
            sums[name] += n * row[name]
            if label == "F0":
                f0_sums[name] += n * row[name]
            f0_sums[label + "_" + name] += n * row[name]
        t = r["turns"]
        cs.say(f"K1 backward q{tuple(q.shape)} k{tuple(k.shape)} bias="
               f"{int(bias is not None)} x{n}: kernels "
               f"{t['ms'][0]:.4f}/{t['ms'][1]:.4f} ms, plain "
               f"{t['plain'][0]:.4f}/{t['plain'][1]:.4f}, SDPA's backward "
               f"{r['lib']:.4f} ({row['sdpa_backend']}), bound {bound:.5f} "
               f"({by}); err {r['err']:.2e}, rms {r['rms']:.2e}"
               + (f", against f64 {r['err64']:.2e} (plain f32 "
                  f"{r['plain_err64']:.2e})" if "err64" in r else "")
               + "; (dq, dk, "
               f"dv) " + "; ".join(
                   f"{name} {metric} " + "/".join(f"{e:.2e}" for e in errs)
                   for name, m in controls.items()
                   for metric, errs in m.items())
               + "; profiled: "
               + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in sorted(
                   kernels.items())) + f" [{cs.CARD}]")
    if args.f32:
        cs.say(f"K1 f32 backward, the F0 predictor's {F0_CALLS} calls of a "
               f"step (B={cs.TRAIN_B} x {cs.TRAIN_T}): kernels "
               f"{f0_sums['ms']:.4f} ms, plain (torch ops) "
               f"{f0_sums['plain_ms']:.4f}, SDPA's f32 backward "
               f"{f0_sums['sdpa_ms']:.4f}; bound {f0_sums['bound_ms']:.5f}; "
               "profiled: " + ", ".join(
                   f"{k[9:]} {v:.4f}" for k, v in sorted(f0_sums.items())
                   if k.startswith("profiled_")) + f" [{cs.CARD}]")
    if old_sums:
        cs.say(f"K1 {'f32' if args.f32 else 'bf16'} backward in turns, the "
               "older kernels -> these, per "
               "group of calls: " + "; ".join(
                   f"{lab} {old_sums[lab + '_old']:.4f} -> "
                   f"{old_sums[lab + '_new']:.4f} ms (SDPA's "
                   f"{f0_sums[lab + '_sdpa_ms']:.4f})"
                   for lab in dict.fromkeys(c[0] for c in cases))
               + f" [{cs.CARD}]")
    cs.say(f"K1 backward, {'all' if args.f32 else 'one training step'}'s "
           f"{sum(calls.values())} calls ("
           + ("the F0 calls and B=2, f32" if args.f32 else
              f"B={cs.TRAIN_B} x {cs.TRAIN_T}, bf16") + "): kernels "
           f"{sums['ms']:.4f} ms, plain (torch ops) {sums['plain_ms']:.4f}, "
           f"SDPA's backward {sums['sdpa_ms']:.4f}; bound "
           f"{sums['bound_ms']:.5f} ({100 * sums['bound_ms'] / sums['ms']:.1f}"
           f" % of it); worst err {max(r['err'] for r in rows):.2e}, rms "
           f"{max(r['rms'] for r in rows):.2e} "
           f"[{cs.CARD}]")
    cs.say("  profiled per step: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in sorted(per_kernel.items()))
        + f" [{cs.CARD}]")
    cs.say("  over the step's geometries, least / largest reading of each "
           f"backward: max (of the batch row's max|plain|, bound "
           f"{cs.K1_BWD_RTOL}), rms (of the gradient's norm, bound "
           f"{cs.K1_BWD_RMS}), "
           "older (of max(1, max|plain|) per tensor, bound 3e-2): "
           + "; ".join(f"{name} {metric} {lo:.3e} / {hi:.3e}"
                       for (name, metric), (lo, hi) in worst.items()))
    regs = ptxas_report(args.f32)
    for name, r, st, ld, blocks in regs:
        cs.say(f"  ptxas {name}: {r} registers, spills {st} / {ld} bytes, "
               f"{blocks} blocks per SM by registers")
    out = {"card": cs.CARD, "dtype": str(dtype), "per_step": dict(sums),
           "f0_per_step": dict(f0_sums), "old_in_turns": dict(old_sums),
           "readings": {f"{name}, {metric}": v
                        for (name, metric), v in worst.items()},
           "per_kernel": dict(per_kernel), "ptxas": regs, "rows": rows}
    line = json.dumps({"k1_bwd_compare": out})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
