"""K2's bf16 route against the kernel it replaced, and the GroupNorm
statistics kernel against the torch ops it replaced, on one GPU, in turns.

    git show REV:ns2vc_tpu_torch/csrc/gn_silu_conv1d_tc.cu \\
        > .scratch/gn_silu_conv1d_tc_old.cu
    python3 scripts/torch_k2_bf16_compare.py \\
        --old-source .scratch/gn_silu_conv1d_tc_old.cu [--out FILE]

The old source is the bf16 kernel as the port had it before the wgmma
design (mma.sync m16n8k16, 64 x 64 output tiles, 32-channel chunks, the
channel split into an f32 workspace and a reduce kernel): it is compiled
with nvcc next to this tree's `csrc/` headers into the gitignored
`.scratch/` and bound with ctypes, with its weights packed in its own
layout (3, Co_pad 64, C_pad 32) and its split planned as its wrapper
planned it (`old_plan`: 64 x 64 tiles and 32-channel chunks).

At every resnet epilogue of one UNet step (`chip_smoke.resnet_cases`, the
448-frame serving bucket) at B=16 and at B=1, and at the training step's
geometry (B=32, the 272-frame bucket), in bf16, it times the two convs on
the same x, a, b, w, bias in the order old, new, new, old, each as the
device time of 10 calls captured as one CUDA graph (`chip_smoke.graph_ms`),
beside cuDNN's conv1d of the pre-activated input alone and the plain
version (`affine_silu_conv1d_plain`); both outputs are
held against the plain version (`chip_smoke.RESNET_BF16_RTOL`). At the
B=16 and B=1 serving geometries it times the statistics: the torch ops
(`group_norm_affine_plain`), the kernel, the kernel, the torch ops, and
`torch.var_mean` over the f32 grouped view alone; and it counts, with
torch.profiler, the device kernels of one B=16 UNet step's 45 epilogues
the old way (torch-ops statistics and the old kernel) and the new way.
Every time carries the card's name and power limit.

Prints a line per geometry, the sums per UNet step (x 50 per serving
call) and a JSON line {"k2_bf16_compare": ...} last (also to --out).
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OLD_BK = 32     # the old kernel's channel chunk (its tile is 64 x 64)


def old_plan(bsz: int, t: int, c: int, co: int, bk: int) -> tuple[int, int]:
    """(splits, chunks per split) as the mma.sync kernels' wrapper planned
    them over 64 x 64 output tiles and `bk`-channel chunks: the fewest
    splits whose tiles times splits reach the H100's 132 SMs, or one chunk
    per split where even that falls short, dealt evenly, none empty."""
    tiles = -(-t // 64) * -(-co // 64) * bsz
    n_chunks = -(-c // bk)
    for want in range(1, n_chunks + 1):
        cps = -(-n_chunks // want)
        splits = -(-n_chunks // cps)
        if tiles * splits >= 132:
            return splits, cps
    return n_chunks, 1


def build_old(source: str):
    """The old kernel's library, compiled once per source into .scratch/."""
    from ns2vc_tpu_torch.ops import _build

    csrc = os.path.join(ROOT, "ns2vc_tpu_torch", "csrc")
    text = open(source, "rb").read()
    tag = hashlib.sha256(text).hexdigest()[:12]
    out = os.path.join(ROOT, ".scratch", f"libk2_old_{tag}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", csrc,
               source, "-o", out]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            cs.fail(f"old kernel build: {proc.stdout}{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "ptxas info" in line and "Used" in line:
                cs.say(f"  old kernel: {line.strip()}")
    lib = ctypes.CDLL(out)
    fn = lib.ns2vc_affine_silu_conv1d_tc
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def old_conv(fn, x, a, b, w, bias):
    """A closure that launches the old kernel on these inputs (its packed
    weights, workspace and output made once)."""
    bsz, t, c = x.shape
    co = w.shape[0]
    cop, cp = -(-co // 64) * 64, -(-c // OLD_BK) * OLD_BK
    wp = torch.zeros(3, cop, cp, dtype=torch.bfloat16, device=x.device)
    wp[:, :co, :c] = w.permute(2, 0, 1)
    splits, cps = old_plan(bsz, t, c, co, OLD_BK)   # its own planner
    ws = None if splits == 1 else torch.empty(
        (splits, bsz, t, co), dtype=torch.float32, device=x.device)
    y = torch.empty(bsz, t, co, dtype=torch.bfloat16, device=x.device)
    vec = int(c % 8 == 0)

    def run():
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), wp.data_ptr(),
                 bias.data_ptr(), y.data_ptr(),
                 None if ws is None else ws.data_ptr(), bsz, t, c, co, cp,
                 cop, cps, splits, vec, torch.cuda.current_stream().cuda_stream)
        if err:
            cs.fail(f"old kernel: CUDA error {err}")
        return y
    return run, splits


def conv_cases(fn, unet, dev, bsz, t_bucket):
    """Old vs new (and cuDNN alone) at one UNet step's epilogues."""
    import ns2vc_tpu_torch.ops.fused_resnet as fr

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 50 + bsz)
    rows, sums = [], {"old": 0.0, "new": 0.0, "conv": 0.0, "plain": 0.0,
                      "bound": 0.0}
    for name, t, c, co, film in cs.resnet_cases(unet):
        t = t * t_bucket // cs.T_PAD
        x = torch.randn(bsz, t, c, generator=g, device=dev).bfloat16()
        w = (torch.randn(co, c, 3, generator=g, device=dev)
             / (3 * c) ** 0.5).bfloat16()
        bias = (0.1 * torch.randn(co, generator=g, device=dev)).bfloat16()
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        beta = 0.1 * torch.randn(c, generator=g, device=dev)
        f = (0.2 * torch.randn(bsz, 2 * c, generator=g, device=dev)
             ).bfloat16().chunk(2, dim=-1) if film else (None, None)
        a, b = fr.group_norm_affine(x, gamma, beta, 8, 1e-5, *f)
        old, old_splits = old_conv(fn, x, a, b, w, bias)
        want = fr.affine_silu_conv1d_plain(x, a, b, w, bias).float()
        tol = cs.RESNET_BF16_RTOL * max(1.0, want.abs().max().item())
        errs = [(y.float() - want).abs().max().item() for y in
                (old(), fr.affine_silu_conv1d(x, a, b, w, bias))]
        torch.cuda.synchronize()
        if not max(errs) <= tol:
            cs.fail(f"{name} B={bsz} T={t}: errors old/new {errs} > {tol}")
        new = lambda: fr.affine_silu_conv1d(x, a, b, w, bias)  # noqa: E731
        turns = [cs.graph_ms(old), cs.graph_ms(new), cs.graph_ms(new),
                 cs.graph_ms(old)]
        h = F.silu(x.float() * a[:, None, :] + b[:, None, :]).bfloat16() \
            .transpose(1, 2).contiguous()
        conv = cs.graph_ms(lambda: F.conv1d(h, w, bias, padding=1))
        plain = cs.graph_ms(lambda: fr.affine_silu_conv1d_plain(
            x, a, b, w, bias))
        bound = cs.k2_bound(bsz, t, c, co, torch.bfloat16)[0]
        row = {"name": name, "t": t, "c": c, "co": co,
               "old_ms": (turns[0] + turns[3]) / 2,
               "new_ms": (turns[1] + turns[2]) / 2, "turns": turns,
               "conv_alone_ms": conv, "plain_ms": plain, "bound_ms": bound,
               "old_splits": old_splits,
               "new_splits": fr.plan_wgmma(bsz, t, c, co)[0],
               "old_err": errs[0], "new_err": errs[1]}
        rows.append(row)
        for key, val in (("old", row["old_ms"]), ("new", row["new_ms"]),
                         ("conv", conv), ("plain", plain),
                         ("bound", bound)):
            sums[key] += val
        cs.say(f"K2 bf16 B={bsz} {name:18s} T={t} C={c} Co={co}: old "
               f"{turns[0]:.4f}/{turns[3]:.4f} new {turns[1]:.4f}/"
               f"{turns[2]:.4f} ms (splits {old_splits} -> "
               f"{row['new_splits']}), cuDNN conv alone {conv:.4f}, plain "
               f"{plain:.4f}, bound "
               f"{bound:.5f}; err old {errs[0]:.2e} new {errs[1]:.2e}")
    cs.say(f"K2 bf16 one UNet step, B={bsz} x {t_bucket}: old kernel "
           f"{sums['old']:.4f} ms -> wgmma {sums['new']:.4f} ms; cuDNN conv "
           f"alone {sums['conv']:.4f}; plain {sums['plain']:.4f}; bound "
           f"{sums['bound']:.5f} "
           f"({100 * sums['bound'] / sums['new']:.1f} % of it) [{cs.CARD}]")
    return {"per_step": sums, "rows": rows}


def stats_cases(unet, dev, bsz):
    """The statistics: torch ops, kernel, kernel, torch ops, var_mean."""
    import ns2vc_tpu_torch.ops.fused_resnet as fr

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 60 + bsz)
    sums = {"plain": 0.0, "kernel": 0.0, "var_mean": 0.0, "bound": 0.0}
    worst = 0.0
    for name, t, c, co, film in cs.resnet_cases(unet):
        x = torch.randn(bsz, t, c, generator=g, device=dev).bfloat16()
        gamma, beta = (torch.randn(c, generator=g, device=dev).bfloat16()
                       for _ in range(2))
        f = (0.2 * torch.randn(bsz, 2 * c, generator=g, device=dev)
             ).bfloat16().chunk(2, dim=-1) if film else (None, None)
        args = (x, gamma, beta, 8, 1e-5, *f)
        ka, kb = fr.group_norm_affine(*args)
        pa, pb = fr.group_norm_affine_plain(*args)
        scale = max(1.0, pa.abs().max().item(), pb.abs().max().item())
        err = max((ka - pa).abs().max().item(), (kb - pb).abs().max().item())
        worst = max(worst, err / scale)
        if not err <= cs.GN_RTOL * scale:
            cs.fail(f"statistics {name} B={bsz}: error {err} > "
                    f"{cs.GN_RTOL * scale}")
        xf = x.float().view(bsz, t, 8, c // 8)
        turns = [cs.graph_ms(lambda: fr.group_norm_affine_plain(*args)),
                 cs.graph_ms(lambda: fr.group_norm_affine(*args)),
                 cs.graph_ms(lambda: fr.group_norm_affine(*args)),
                 cs.graph_ms(lambda: fr.group_norm_affine_plain(*args))]
        vm = cs.graph_ms(lambda: torch.var_mean(xf, dim=(1, 3), correction=0))
        sums["plain"] += (turns[0] + turns[3]) / 2
        sums["kernel"] += (turns[1] + turns[2]) / 2
        sums["var_mean"] += vm
        sums["bound"] += cs.gn_bound(bsz, t, c, torch.bfloat16,
                                     torch.bfloat16, film)[0]
    cs.say(f"GroupNorm statistics, one UNet step at B={bsz} (45 calls, bf16):"
           f" torch ops {sums['plain']:.4f} ms -> kernel {sums['kernel']:.4f}"
           f" ms (x{cs.STEPS} per serving call: {cs.STEPS * sums['plain']:.2f}"
           f" -> {cs.STEPS * sums['kernel']:.2f}); torch.var_mean alone "
           f"{sums['var_mean']:.4f}; bound {sums['bound']:.5f} "
           f"(x{cs.STEPS}: {cs.STEPS * sums['bound']:.3f}); worst error "
           f"{worst:.2e} of max(1, |a|, |b|) [{cs.CARD}]")
    return {"per_step": sums, "worst_rel_err": worst}


def step_kernels(fn, unet, dev):
    """Device kernels of one B=16 UNet step's 45 epilogues, old and new."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ns2vc_tpu_torch.ops.fused_resnet as fr

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 70)
    calls = []
    for _, t, c, co, film in cs.resnet_cases(unet):
        x = torch.randn(cs.B, t, c, generator=g, device=dev).bfloat16()
        w = (torch.randn(co, c, 3, generator=g, device=dev)
             / (3 * c) ** 0.5).bfloat16()
        gamma, beta, bias = (torch.randn(n, generator=g, device=dev)
                             .bfloat16() for n in (c, c, co))
        f = (torch.randn(cs.B, 2 * c, generator=g, device=dev).bfloat16()
             .chunk(2, dim=-1) if film else (None, None))
        a, b = fr.group_norm_affine_plain(x, gamma, beta, 8, 1e-5, *f)
        calls.append(((x, gamma, beta, 8, 1e-5, *f),
                      old_conv(fn, x, a, b, w, bias)[0], (w, bias)))

    def old_step():
        for args, old, _ in calls:
            fr.group_norm_affine_plain(*args)
            old()

    def new_step():
        for args, _, (w, bias) in calls:
            fr.gn_silu_conv1d(args[0], args[1], args[2], w, bias, 8, 1e-5,
                              *args[5:])

    def count(step):
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    before, after = count(old_step), count(new_step)
    cs.say(f"kernels per B={cs.B} bf16 UNet step for its {len(calls)} resnet "
           f"epilogues: {before} (torch-ops statistics, old kernel) -> "
           f"{after} (statistics kernel, wgmma kernel)")
    return {"before": before, "after": after}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-source", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_bf16_compare: no CUDA device", file=sys.stderr)
        return 2
    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cs.CARD = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; {cs.CARD}")
    fn = build_old(args.old_source)
    with torch.device("meta"):
        unet = NaturalSpeech2(Config()).diff_model.unet
    out = {"card": cs.CARD,
           "conv": {"B16": conv_cases(fn, unet, dev, cs.B, cs.T_PAD),
                    "B1": conv_cases(fn, unet, dev, 1, cs.T_PAD),
                    "train_B32": conv_cases(fn, unet, dev, cs.TRAIN_B,
                                            cs.TRAIN_T)},
           "stats": {"B16": stats_cases(unet, dev, cs.B),
                     "B1": stats_cases(unet, dev, 1)},
           "kernels_per_step": step_kernels(fn, unet, dev)}
    line = json.dumps({"k2_bf16_compare": out})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
