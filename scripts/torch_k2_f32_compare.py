"""K2's f32 route against the kernel it replaced, on one GPU, in turns.

    git show 6e00b6c:ns2vc_tpu_torch/csrc/gn_silu_conv1d.cu \\
        > .scratch/gn_silu_conv1d_f32_old.cu
    python3 scripts/torch_k2_f32_compare.py \\
        --old-source .scratch/gn_silu_conv1d_f32_old.cu [--out FILE] \\
        [--cli B,T ...]

The old source is the f32 kernel as the port had it before the wgmma
design (mma.sync m16n8k8 TF32 in three passes, 64 x 64 output tiles of 4
warps, 16-channel chunks by cp.async, the channel split into an f32
workspace and a reduce kernel): it is compiled with nvcc next to this
tree's `csrc/` headers into the gitignored `.scratch/` and bound with
ctypes, with its weights packed in its own layout (2 TF32 planes, 3 taps,
Co_pad 64, C_pad 16) and its split planned as its wrapper planned it
(`old_plan`: the fewest splits that reach 132 blocks).

With TF32 off (cuDNN and cuBLAS in full f32), at every resnet epilogue of
one UNet step (`chip_smoke.resnet_cases`, the 448-frame serving bucket) at
B=16 and at B=1, and at the f32 CLI run's device batches (`--cli`, each a
batch size and a frame bucket; the default, CLI_BATCHES, is the two
batches the CLI phase of `chip_smoke.py` records: B=2 at 704 frames and
B=1 at 832), it times the two convs on the same x, a, b, w, bias in the
order old, new, new, old, each as the device time of 10 calls captured as
one CUDA graph (`chip_smoke.graph_ms`), beside cuDNN's conv1d of the
pre-activated input alone and the plain version
(`affine_silu_conv1d_plain`), with the bound
(`chip_smoke.k2_bound`: 3 TF32 passes at 494.7 TFLOP/s). Both outputs are
held against the plain version within `chip_smoke.RESNET_F32_ATOL`, and two
launches of the new kernel must be bitwise equal. Every time carries the
card's name and power limit.

Prints a line per geometry, the sums per UNet step (x 50 per serving call,
x 30 per CLI batch) and a JSON line {"k2_f32_compare": ...} last (also to
--out).
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
OLD_BK = 16     # the old kernel's channel chunk (its tile is 64 x 64)
# the f32 CLI run's device batches (batch, frame bucket), as chip_smoke's
# CLI phase records them ("K2 CLI B=.. T=.." at the UNet's first level)
CLI_BATCHES = ((2, 704), (1, 832))


def old_plan(bsz: int, t: int, c: int, co: int, bk: int) -> tuple[int, int]:
    """(splits, chunks per split) as the old kernel's wrapper planned them
    over 64 x 64 output tiles and `bk`-channel chunks: the fewest splits
    whose tiles times splits reach the H100's 132 SMs, or one chunk per
    split where even that falls short, dealt evenly, none empty."""
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
    out = os.path.join(ROOT, ".scratch", f"libk2f32_old_{tag}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", csrc,
               source, "-o", out]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            cs.fail(f"old kernel build: {proc.stdout}{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                cs.say(f"  old kernel: {line.strip()}")
    lib = ctypes.CDLL(out)
    fn = lib.ns2vc_affine_silu_conv1d_f32tc
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def old_conv(fn, x, a, b, w, bias):
    """A closure that launches the old kernel on these inputs (its packed
    planes, workspace and output made once)."""
    from ns2vc_tpu_torch.ops.fused_resnet import tf32_round

    bsz, t, c = x.shape
    co = w.shape[0]
    cop, cp = -(-co // 64) * 64, -(-c // OLD_BK) * OLD_BK
    taps = w.permute(2, 0, 1)
    wp = torch.zeros(2, 3, cop, cp, dtype=torch.float32, device=x.device)
    big = tf32_round(taps.contiguous())
    wp[0, :, :co, :c] = big
    wp[1, :, :co, :c] = tf32_round(taps - big)
    splits, cps = old_plan(bsz, t, c, co, OLD_BK)
    ws = None if splits == 1 else torch.empty(
        (splits, bsz, t, co), dtype=torch.float32, device=x.device)
    y = torch.empty(bsz, t, co, dtype=torch.float32, device=x.device)
    vec = int(c % 4 == 0)

    def run():
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), wp.data_ptr(),
                 bias.data_ptr(), y.data_ptr(),
                 None if ws is None else ws.data_ptr(), bsz, t, c, co, cp,
                 cop, cps, splits, vec, torch.cuda.current_stream().cuda_stream)
        if err:
            cs.fail(f"old kernel: CUDA error {err}")
        return y
    return run, splits


def conv_cases(fn, unet, dev, bsz, t_bucket, label):
    """Old vs new (and cuDNN alone, the plain version) at one UNet step's
    epilogues at batch `bsz` and frame bucket `t_bucket`."""
    import ns2vc_tpu_torch.ops.fused_resnet as fr

    g = torch.Generator(device=dev).manual_seed(cs.SEED + 80 + bsz + t_bucket)
    rows, sums = [], {"old": 0.0, "new": 0.0, "conv": 0.0, "plain": 0.0,
                      "bound": 0.0}
    for name, t, c, co, film in cs.resnet_cases(unet):
        t = t * t_bucket // cs.T_PAD
        x = torch.randn(bsz, t, c, generator=g, device=dev)
        w = torch.randn(co, c, 3, generator=g, device=dev) / (3 * c) ** 0.5
        bias = 0.1 * torch.randn(co, generator=g, device=dev)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        beta = 0.1 * torch.randn(c, generator=g, device=dev)
        f = (0.2 * torch.randn(bsz, 2 * c, generator=g, device=dev)
             ).chunk(2, dim=-1) if film else (None, None)
        a, b = fr.group_norm_affine(x, gamma, beta, 8, 1e-5, *f)
        old, old_splits = old_conv(fn, x, a, b, w, bias)
        want = fr.affine_silu_conv1d_plain(x, a, b, w, bias)
        new = lambda: fr.affine_silu_conv1d(x, a, b, w, bias)  # noqa: E731
        y_old, y_new, y_again = old().clone(), new(), new()
        torch.cuda.synchronize()
        errs = [(y - want).abs().max().item() for y in (y_old, y_new)]
        if not max(errs) <= cs.RESNET_F32_ATOL:
            cs.fail(f"{name} B={bsz} T={t}: errors old/new {errs} > "
                    f"{cs.RESNET_F32_ATOL}")
        if not torch.equal(y_new, y_again):
            cs.fail(f"{name} B={bsz} T={t}: two launches differ")
        turns = [cs.graph_ms(old), cs.graph_ms(new), cs.graph_ms(new),
                 cs.graph_ms(old)]
        h = F.silu(x * a[:, None, :] + b[:, None, :]).transpose(1, 2) \
            .contiguous()
        conv = cs.graph_ms(lambda: F.conv1d(h, w, bias, padding=1))
        plain = cs.graph_ms(lambda: fr.affine_silu_conv1d_plain(
            x, a, b, w, bias))
        bound = cs.k2_bound(bsz, t, c, co, torch.float32)[0]
        row = {"name": name, "t": t, "c": c, "co": co,
               "old_ms": (turns[0] + turns[3]) / 2,
               "new_ms": (turns[1] + turns[2]) / 2, "turns": turns,
               "conv_alone_ms": conv, "plain_ms": plain, "bound_ms": bound,
               "old_splits": old_splits,
               "new_splits": fr.plan_tc(bsz, t, c, co)[0],
               "old_err": errs[0], "new_err": errs[1]}
        rows.append(row)
        for key, val in (("old", row["old_ms"]), ("new", row["new_ms"]),
                         ("conv", conv), ("plain", plain),
                         ("bound", bound)):
            sums[key] += val
        cs.say(f"K2 f32 {label} {name:18s} T={t} C={c} Co={co}: old "
               f"{turns[0]:.4f}/{turns[3]:.4f} new {turns[1]:.4f}/"
               f"{turns[2]:.4f} ms (splits {old_splits} -> "
               f"{row['new_splits']}), cuDNN conv alone {conv:.4f}, plain "
               f"{plain:.4f}, bound {bound:.5f}; err old {errs[0]:.2e} new "
               f"{errs[1]:.2e}")
    slower = [r["name"] for r in rows if r["new_ms"] > r["old_ms"]]
    cs.say(f"K2 f32 one UNet step, {label} (B={bsz} x {t_bucket}): old "
           f"kernel {sums['old']:.4f} ms -> wgmma {sums['new']:.4f} ms; cuDNN "
           f"conv alone {sums['conv']:.4f}; plain {sums['plain']:.4f}; bound "
           f"{sums['bound']:.5f} ({100 * sums['bound'] / sums['new']:.1f} % "
           f"of it); epilogues where the new kernel is slower: "
           f"{slower or 'none'} [{cs.CARD}]")
    return {"batch": bsz, "t_bucket": t_bucket, "per_step": sums,
            "slower": slower, "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-source", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cli", nargs="*", default=None,
                    help="the CLI run's device batches as B,T")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_f32_compare: no CUDA device", file=sys.stderr)
        return 2
    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2

    cli = CLI_BATCHES if args.cli is None else tuple(
        tuple(int(n) for n in v.split(",")) for v in args.cli)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cs.CARD = cs.card_line()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; {cs.CARD}")
    fn = build_old(args.old_source)
    with torch.device("meta"):
        unet = NaturalSpeech2(Config()).diff_model.unet
    with cs.no_tf32():
        out = {"card": cs.CARD,
               "B16": conv_cases(fn, unet, dev, cs.B, cs.T_PAD, "B16"),
               "B1": conv_cases(fn, unet, dev, 1, cs.T_PAD, "B1"),
               "cli": [conv_cases(fn, unet, dev, bsz, t, f"CLI B{bsz}")
                       for bsz, t in cli]}
    steps = cs.CLI_STEPS
    cli_sum = {k: steps * sum(r["per_step"][k] for r in out["cli"])
               for k in ("old", "new", "conv", "plain", "bound")}
    out["cli_run"] = {"steps": steps, "batches": cli, **cli_sum}
    cs.say(f"K2 f32 over the CLI run's {len(cli)} batches x {steps} steps: "
           f"old {cli_sum['old']:.3f} ms -> wgmma {cli_sum['new']:.3f} ms; "
           f"cuDNN conv alone {cli_sum['conv']:.3f}; plain "
           f"{cli_sum['plain']:.3f}; bound {cli_sum['bound']:.4f} "
           f"[{cs.CARD}]")
    line = json.dumps({"k2_f32_compare": out})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
