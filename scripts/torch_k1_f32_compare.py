"""K1's f32 route against the kernel it replaced, on one GPU, in turns.

    python3 scripts/torch_k1_f32_compare.py [--out FILE] [--cli T ...]

The kernel it replaced is the mma.sync 3xTF32 kernel
(`csrc/flash_attention.cu`), which stays in the library (its element-load
path is the sub-route "f32tc_narrow"): `chip_smoke.mma_sync_kernel()`
answers the f32 wgmma kernel's entry with it, 16-byte cp.async tiles and
its own key split (`plan_f32tc`, with its workspace and merge kernel), so
both sides go through the same wrapper and no older source is built.

Geometries, all in f32 with TF32 off (cuBLAS and cuDNN), at the calls
each makes: every K1 call of one UNet step at B=16 and at B=1 over the
448-frame bucket and its 320-frame prompt (`chip_smoke.attention_cases`),
ContentVec's self-attention (1, 12, T, 64) at the T given by --cli (by
default 50, 400, 850 and 3000 frames), the F0 predictor's cross-attention
(16 x 8 x 448 over the 320-frame prompt, 272 valid, D = 32) and the op
registry's ids 14/15 (4 x 2 x 400 x 400 x 128, every other item's last
100 keys masked). For each it times the mma.sync kernel and the wgmma
kernel (`csrc/flash_attention_f32_wgmma.cu`, at the plan
`plan_f32_wgmma` gives) on the same q, k, v and key bias in the order
old, new, new, old, each as the device time of 20 calls captured as one
CUDA graph (`chip_smoke.graph_ms`); beside them SDPA with the key bias as
its mask (timed only), the plain version, the bound (`chip_smoke.k1_bound`:
three TF32 passes at 494.7 TFLOP/s, or bytes at 3.35 TB/s), the exp floor
(one exponential per score at 16 per SM and clock on 132 SMs at
`nvidia-smi --query-gpu=clocks.max.sm`) and both kernels' errors against
the plain version (`chip_smoke.ATTN_F32_ATOL`, 2e-5). The wgmma kernel's
two launches must agree bit for bit. Every time carries the card's name
and power limit.

First it compiles `csrc/flash_attention_f32_wgmma.cu` alone to a cubin
(the library's flags) and reports, per instantiation (head dim padded to
DP, key tile BN, consumer warpgroups NC, with or without a key bias), what
`-Xptxas -v` says: registers, shared memory, spills.

Prints a line per geometry, the sums per group (one UNet step at B=16 and
at B=1, ContentVec's calls) and a JSON line {"k1_f32_compare": ...} last
(also to --out).
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

ITERS = 20      # calls per captured graph
KERNEL = re.compile(r"flash_fwd_f32_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                    r"ELb(\d)E")


def ptxas_report() -> list:
    """Per instantiation of the f32 wgmma kernel: ptxas's registers,
    shared memory and spills."""
    from ns2vc_tpu_torch.ops import _build

    src = _build.CSRC_DIR / "flash_attention_f32_wgmma.cu"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._nvcc(), *flags, "-cubin", str(src), "-o",
             os.path.join(tmp, "k1.cubin")],
            capture_output=True, text=True, cwd=tmp)
    if proc.returncode != 0:
        cs.fail(f"nvcc -cubin: {proc.stdout}{proc.stderr}")
    rows, row = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = KERNEL.search(line)
        if m and "Compiling entry" in line:
            dp, bn, nc, bias = map(int, m.groups())
            row = {"dp": dp, "bn": bn, "nc": nc, "bias": bool(bias)}
            rows.append(row)
        elif row is not None and "Used" in line:
            row["ptxas"] = line.split(":", 1)[1].strip()
        elif row is not None and "spill" in line:
            row["spills"] = line.strip()
    rows.sort(key=lambda r: (r["dp"], r["bn"], r["nc"], r["bias"]))
    for r in rows:
        cs.say(f"flash_fwd_f32_wgmma_kernel<DP={r['dp']}, BN={r['bn']}, "
               f"NC={r['nc']}, bias={r['bias']}>: {r.get('ptxas')}; "
               f"{r.get('spills')}")
    return rows


def geometries(cfg, cli_ts) -> dict:
    """(name, B, H, Tq, Tk, D, valid keys or a mask row pattern, calls,
    layout) per group."""
    out = {f"unet_B{bsz}": [c for c in cs.attention_cases(cfg, bsz)
                            if c[7] > 0] for bsz in (cs.B, 1)}
    out["contentvec"] = [(f"contentvec_T{t}", 1, 12, t, t, 64, None, 12,
                          "cross") for t in cli_ts]
    out["f0_predictor"] = [("f0_cross", cs.B, 8, cs.T_PAD, cs.TP_PAD, 32,
                            cs.TP_REFER, 10, "cross")]
    out["op_registry"] = [("registry_d128", 4, 2, 400, 400, 128, "odd_items",
                           1, "self")]
    return out


def inputs(b, h, tq, tk, d, valid, layout, g, dev):
    from ns2vc_tpu_torch.ops.attention import split_heads

    c = h * d
    if layout == "self":
        q, k, v = torch.randn(b, tq, 3 * c, generator=g,
                              device=dev).split(c, dim=-1)
    else:
        q = torch.randn(b, tq, c, generator=g, device=dev)
        k, v = (torch.randn(b, tk, c, generator=g, device=dev)
                for _ in range(2))
    q, k, v = (split_heads(x, h) for x in (q, k, v))
    bias = None
    if valid == "odd_items":        # the op registry's padded items
        bias = torch.zeros(b, tk, device=dev)
        bias[1::2, tk - tk // 4:] = -1e4
    elif valid is not None:
        bias = torch.zeros(b, tk, device=dev)
        bias[:, valid:] = -1e4
    return q, k, v, bias


def compare(label, geos, dev, g):
    import ns2vc_tpu_torch.ops.flash_attention as fa

    keys = ("old", "new", "sdpa", "plain", "bound", "exp")
    sums, rows = dict.fromkeys(keys, 0.0), []
    for name, b, h, tq, tk, d, valid, calls, layout in geos:
        q, k, v, bias = inputs(b, h, tq, tk, d, valid, layout, g, dev)
        plan = fa.plan_f32_wgmma(b * h, tq, tk, d)
        call = lambda: fa.flash_attention(q, k, v, bias)  # noqa: E731
        want = fa.flash_attention_plain(q, k, v, bias)
        with cs.mma_sync_kernel():
            old_out = call()
        new_out, again = call(), call()
        torch.cuda.synchronize()
        errs = {"old": (old_out - want).abs().max().item(),
                "new": (new_out - want).abs().max().item()}
        if not max(errs.values()) <= cs.ATTN_F32_ATOL:
            cs.fail(f"{label} {name}: errors {errs} > {cs.ATTN_F32_ATOL}")
        if not torch.equal(new_out, again):
            cs.fail(f"{label} {name}: two launches of the wgmma kernel "
                    f"differ")
        turns = []
        for side in ("old", "new", "new", "old"):
            if side == "old":
                with cs.mma_sync_kernel():
                    turns.append(cs.graph_ms(call, ITERS))
            else:
                turns.append(cs.graph_ms(call, ITERS))
        bound, bound_by = cs.k1_bound(q, k, bias)
        row = {"name": name, "b": b, "h": h, "tq": tq, "tk": tk, "d": d,
               "calls": calls, "plan": plan, "turns": turns,
               "old": (turns[0] + turns[3]) / 2,
               "new": (turns[1] + turns[2]) / 2,
               "sdpa": cs.graph_ms(cs.sdpa_call(q, k, v, bias, d ** -0.5),
                                   ITERS),
               "plain": cs.graph_ms(lambda: fa.flash_attention_plain(
                   q, k, v, bias), ITERS),
               "bound": bound, "bound_by": bound_by,
               "exp": cs.exp_floor(q, k),
               "err_old": errs["old"], "err_new": errs["new"]}
        rows.append(row)
        for key in keys:
            sums[key] += calls * row[key]
        cs.say(f"K1 f32 {label} {name:18s} B={b} H={h} Tq={tq} Tk={tk} "
               f"D={d} x{calls}: mma.sync {turns[0]:.4f}/{turns[3]:.4f} "
               f"wgmma {turns[1]:.4f}/{turns[2]:.4f} ms (key tile, "
               f"consumers, splits {plan}); SDPA {row['sdpa']:.4f}, plain "
               f"{row['plain']:.4f}, bound {bound:.5f} ({bound_by}), exp "
               f"floor {row['exp']:.5f}; err mma.sync {errs['old']:.2e} "
               f"wgmma {errs['new']:.2e} [{cs.CARD}]")
    cs.say(f"K1 f32 {label}, {sum(r['calls'] for r in rows)} calls: the "
           f"mma.sync kernel {sums['old']:.4f} ms -> wgmma {sums['new']:.4f}"
           f" ({100 * sums['bound'] / sums['new']:.1f} % of the bound); "
           f"SDPA {sums['sdpa']:.4f}; plain {sums['plain']:.4f}; bound "
           f"{sums['bound']:.5f}, exp floor {sums['exp']:.5f} [{cs.CARD}]")
    return {"sums": sums, "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--cli", type=int, nargs="*", default=[50, 400, 850,
                                                            3000],
                    help="ContentVec frame counts to compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_f32_compare: no CUDA device", file=sys.stderr)
        return 2
    from ns2vc_tpu_torch.config import Config

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cs.CARD = cs.card_line()
    cs.SM_CLOCK_MHZ = cs.sm_clock_mhz()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; {cs.CARD}; SM clock "
           f"max {cs.SM_CLOCK_MHZ:g} MHz")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 90)
    out = {"card": cs.CARD, "sm_clock_mhz": cs.SM_CLOCK_MHZ,
           "instantiations": ptxas_report()}
    with cs.no_tf32():
        for label, geos in geometries(Config(), args.cli).items():
            out[label] = compare(label, geos, dev, g)
    line = json.dumps({"k1_f32_compare": out})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
