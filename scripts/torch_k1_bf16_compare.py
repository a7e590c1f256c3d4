"""K1's bf16 route against the kernel it replaced, on one GPU, in turns.

    python3 scripts/torch_k1_bf16_compare.py [--out FILE]

The kernel it replaced is the mma.sync kernel (`csrc/flash_attention_tc.cu`),
which stays in the library (its element-load path is the sub-route
"tc_narrow"): `chip_smoke.mma_sync_kernel()` answers the wgmma kernel's entry
with it, 16-byte cp.async tiles, so both sides go through the same
wrapper and pay the same Python costs, and no older source is built.

At every K1 geometry of one UNet step (`chip_smoke.attention_cases`) at
B=16 and at B=1 over the 448-frame bucket and its 320-frame prompt, and of
the training forward's UNet at B=32 x 272 (prompt 272), in bf16, it times
the mma.sync kernel and the wgmma kernel (`csrc/flash_attention_wgmma.cu`) on the
same q, k, v and key bias in the order old, new, new, old, each as the
device time of 20 calls captured as one CUDA graph
(`chip_smoke.graph_ms`), the wgmma kernel at the key tile
`plan_wgmma_attention` picks. Beside each: SDPA with the key bias as its
mask (timed only), the plain version (`flash_attention_plain`), the bound (`chip_smoke.k1_bound`: bytes or operations at
the H100's peaks), the exp floor (one exponential per score at 16 per SM
and clock on 132 SMs, at the SM clock `nvidia-smi --query-gpu=clocks.max.sm`
reports), the eager host time per call of both (back-to-back wrapper
calls: the tensor maps' encoding included), and both outputs' errors
against the plain version (`chip_smoke.ATTN_BF16_ATOL`). The bf16 CLI
run's geometries are compared the same way by `chip_smoke.py` itself
(`check_path_calls`), which records them. Every time carries the card's
name and power limit.

First it compiles `csrc/flash_attention_wgmma.cu` alone to a cubin (the
library's flags) and reports, per instantiation (head dim padded to DP,
key tile BN, with or without a key bias), what `-Xptxas -v` says
(registers, shared memory, spills) and what `cuobjdump -sass` shows: its
MUFU.EX2 operations against the exponentials its code takes (BN / 2
probabilities and 2 rescale factors per thread at each of its two softmax
sites) and any exp2f range fix-up (an FSETP against -126).

Prints a line per geometry, the sums per UNet step and a JSON line
{"k1_bf16_compare": ...} last (also to --out).
"""

import argparse
import contextlib
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


def sass_report() -> list:
    """Per wgmma instantiation: ptxas's registers, shared memory and
    spills, and the SASS's MUFU.EX2 count against the code's exponentials
    (and any exp2f range fix-up)."""
    from ns2vc_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    src = _build.CSRC_DIR / "flash_attention_wgmma.cu"
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k1.cubin")
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler",
                                                           "-fPIC")]
        proc = subprocess.run([nvcc, *flags, "-cubin", str(src), "-o", cubin],
                              capture_output=True, text=True, cwd=tmp)
        if proc.returncode != 0:
            cs.fail(f"nvcc -cubin: {proc.stdout}{proc.stderr}")
        name = None
        for line in (proc.stdout + proc.stderr).splitlines():
            m = re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELi(\d+)ELb(\d)E",
                          line)
            if m and "Compiling entry" in line:
                name = m.groups()
                rows[name] = {"dp": int(name[0]), "bn": int(name[1]),
                              "bias": bool(int(name[2]))}
            elif name and "Used" in line:
                rows[name]["ptxas"] = line.split(":", 1)[1].strip()
            elif name and "spill" in line:
                rows[name]["spills"] = line.strip()
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
             cubin], capture_output=True, text=True).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELi(\d+)ELb(\d)E",
                      func.split("\n", 1)[0])
        if not m:
            continue
        row = rows.setdefault(m.groups(), {})
        row["mufu_ex2"] = len(re.findall(r"MUFU\.EX2", func))
        row["exps_in_code"] = 2 * (int(m.group(2)) // 2 + 2)
        row["range_fixups"] = len(re.findall(r"FSETP\.\w+\.AND.*-126", func))
    out = []
    for key in sorted(rows, key=lambda k: tuple(map(int, k))):
        r = rows[key]
        out.append(r)
        cs.say(f"flash_fwd_wgmma_kernel<DP={r.get('dp')}, BN={r.get('bn')}, "
               f"bias={r.get('bias')}>: {r.get('ptxas')}; {r.get('spills')};"
               f" MUFU.EX2 {r.get('mufu_ex2')} for {r.get('exps_in_code')} "
               f"exponentials in the code, exp2f range fix-ups "
               f"{r.get('range_fixups')}")
    return out


def cases(cfg, bsz, t_pad, tp_pad, tp_refer):
    """The UNet's K1 geometries at this batch and bucket (calls > 0)."""
    saved = cs.B, cs.T_PAD, cs.TP_PAD, cs.TP_REFER
    cs.B, cs.T_PAD, cs.TP_PAD, cs.TP_REFER = bsz, t_pad, tp_pad, tp_refer
    try:
        return [c for c in cs.attention_cases(cfg) if c[7] > 0]
    finally:
        cs.B, cs.T_PAD, cs.TP_PAD, cs.TP_REFER = saved


def inputs(b, h, tq, tk, d, valid, layout, g, dev):
    from ns2vc_tpu_torch.ops.attention import split_heads

    c = h * d
    if layout == "self":
        q, k, v = torch.randn(b, tq, 3 * c, generator=g,
                              device=dev).bfloat16().split(c, dim=-1)
    else:
        q = torch.randn(b, tq, c, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(b, tk, c, generator=g, device=dev).bfloat16()
                for _ in range(2))
    q, k, v = (split_heads(x, h) for x in (q, k, v))
    bias = None
    if valid is not None:
        bias = torch.zeros(b, tk, device=dev)
        bias[:, valid:] = -1e4
    return q, k, v, bias


def compare(label, geos, dev, g):
    import ns2vc_tpu_torch.ops.flash_attention as fa

    keys = ("old", "new", "sdpa", "plain", "bound", "exp", "eager_old",
            "eager_new")
    sums, rows = dict.fromkeys(keys, 0.0), []
    for name, b, h, tq, tk, d, valid, calls, layout in geos:
        q, k, v, bias = inputs(b, h, tq, tk, d, valid, layout, g, dev)
        key_tile = fa.plan_wgmma_attention(b * h, tq, tk, d)

        def timed(side, fn):
            with (cs.mma_sync_kernel() if side == "old"
                  else contextlib.nullcontext()):
                return fn(lambda: fa.flash_attention(q, k, v, bias))
        want = fa.flash_attention_plain(q, k, v, bias).float()
        errs = {side: timed(side, lambda f: (f().float() - want).abs().max()
                            .item()) for side in ("old", "new")}
        torch.cuda.synchronize()
        if not max(errs.values()) <= cs.ATTN_BF16_ATOL:
            cs.fail(f"{label} {name}: errors {errs} > {cs.ATTN_BF16_ATOL}")
        turns = [timed(side, lambda f: cs.graph_ms(f, ITERS))
                 for side in ("old", "new", "new", "old")]
        row = {"name": name, "b": b, "h": h, "tq": tq, "tk": tk, "d": d,
               "calls": calls, "key_tile": key_tile,
               "turns": turns, "old": (turns[0] + turns[3]) / 2,
               "new": (turns[1] + turns[2]) / 2,
               "sdpa": cs.graph_ms(cs.sdpa_call(q, k, v, bias, d ** -0.5),
                                   ITERS),
               "plain": cs.graph_ms(lambda: fa.flash_attention_plain(
                   q, k, v, bias), ITERS),
               "bound": cs.k1_bound(q, k, bias)[0],
               "bound_by": cs.k1_bound(q, k, bias)[1],
               "exp": cs.exp_floor(q, k),
               "eager_old": timed("old", lambda f: cs.time_ms(f, iters=50)),
               "eager_new": timed("new", lambda f: cs.time_ms(f, iters=50)),
               "err_old": errs["old"], "err_new": errs["new"]}
        rows.append(row)
        for key in keys:
            sums[key] += calls * row[key]
        cs.say(f"K1 bf16 {label} {name:16s} B={b} H={h} Tq={tq} Tk={tk} "
               f"D={d} x{calls}: mma.sync {turns[0]:.4f}/{turns[3]:.4f} wgmma "
               f"{turns[1]:.4f}/{turns[2]:.4f} ms (key tile {key_tile}); "
               f"SDPA {row['sdpa']:.4f}, plain {row['plain']:.4f}, bound "
               f"{row['bound']:.5f} ({row['bound_by']}), exp floor "
               f"{row['exp']:.5f}; eager per call mma.sync {row['eager_old']:.4f}"
               f" wgmma {row['eager_new']:.4f}; err mma.sync {errs['old']:.2e} "
               f"wgmma {errs['new']:.2e}")
    cs.say(f"K1 bf16 one UNet step, {label}: the mma.sync kernel {sums['old']:.4f} "
           f"ms -> wgmma {sums['new']:.4f}; SDPA {sums['sdpa']:.4f}; plain "
           f"{sums['plain']:.4f}; bound "
           f"{sums['bound']:.5f}, exp floor {sums['exp']:.5f} "
           f"({100 * sums['exp'] / sums['new']:.1f} % of wgmma's time); "
           f"eager mma.sync {sums['eager_old']:.4f} wgmma {sums['eager_new']:.4f}"
           f" [{cs.CARD}]")
    return {"per_step": sums, "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_bf16_compare: no CUDA device", file=sys.stderr)
        return 2
    from ns2vc_tpu_torch.config import Config

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cs.CARD = cs.card_line()
    cs.SM_CLOCK_MHZ = cs.sm_clock_mhz()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; {cs.CARD}; SM clock "
           f"max {cs.SM_CLOCK_MHZ:g} MHz")
    cfg = Config()
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 80)
    out = {"card": cs.CARD, "sm_clock_mhz": cs.SM_CLOCK_MHZ,
           "instantiations": sass_report()}
    for label, geo in (
            ("B16", (cs.B, cs.T_PAD, cs.TP_PAD, cs.TP_REFER)),
            ("B1", (1, cs.T_PAD, cs.TP_PAD, cs.TP_REFER)),
            ("train_B32", (cs.TRAIN_B, cs.TRAIN_T, cs.TRAIN_T, cs.TRAIN_T))):
        out[label] = compare(label, cases(cfg, *geo), dev, g)
    line = json.dumps({"k1_bf16_compare": out})
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
