"""Smoke run of the PyTorch/CUDA port (`ns2vc_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from `ns2vc_tpu_torch/csrc/`, holds each
against its plain PyTorch version at the shapes the serving path gives it,
checks the full-width model on the card against the same model on the CPU,
and drives the serving path (`Svc.infer_batch` / `infer_from_features`) at
full width in bf16, with launch counters that show the path went through
both kernels. Every phase passes or the script exits non-zero; there is no
CPU fallback. It imports no JAX.

Output: one line per phase result, then a JSON line
{"kernels": [...]} (per kernel: launches counted in the 16-request serving
call; max_abs_err, the largest f32 error against the plain version over the
path shapes; ms / plain_ms, the time of one UNet step's calls at B=16 in
bf16, kernel vs plain, from CUDA events after warm-up), then the card's name
and power limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B, T_CLIP, TP_REFER, STEPS = 16, 400, 272, 50  # the serving workload
T_PAD, TP_PAD = 448, 320                       # their 64-frame buckets
SEED = 0

# f32 (TF32 off): the kernels and the plain versions sum in other orders
ATTN_F32_ATOL = 2e-5       # the JAX suite's bound for the Pallas kernel
RESNET_F32_ATOL = 1e-4     # sums of up to 3*1024 products of O(1) terms
# bf16: K1's plain version rounds the probabilities to bf16 before the PV
# product and the kernel keeps them f32 (the JAX suite's bf16 bound is
# 0.03); K2's two sides differ in summation order before one bf16 rounding
ATTN_BF16_ATOL = 3e-2
RESNET_BF16_RTOL = 1e-2    # of max |plain|, floored at 1
UNET_ATOL, MODEL_ATOL = 5e-4, 1e-3   # full-width f32, card vs CPU


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi: {out.returncode} {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# -- the path's shapes ------------------------------------------------------

def attention_cases(cfg):
    """(name, B, H, Tq, Tk, D, valid keys or None, calls per UNet step,
    layout) of every attention the serving path runs. layout: 'self' reads
    q/k/v from one packed (B, T, 3C) projection, 'cross' q from (B, Tq, C)
    and k/v from (B, Tk, C)."""
    d = cfg.diffusion_encoder
    enc = cfg.phoneme_encoder
    lpb, n = d.layers_per_block, len(d.block_out_channels)
    out = []
    for lvl, ch in enumerate(d.block_out_channels):
        t = T_PAD // 2 ** lvl
        # self/cross calls per step at this level: down (not the last
        # level), mid (last level), up (all but the first up block)
        calls = (lpb if lvl < n - 1 else 1) + (lpb + 1 if lvl < n - 1 else 0)
        hd = ch // d.n_heads
        out.append((f"unet_self_L{lvl}", B, d.n_heads, t, t, hd, None,
                    calls, "self"))
        out.append((f"unet_cross_L{lvl}", B, d.n_heads, t, TP_PAD, hd,
                    TP_REFER, calls, "cross"))
    hd = enc.hidden_channels // enc.n_heads
    out.append(("enc_content_self", B, enc.n_heads, T_PAD, T_PAD, hd, T_CLIP,
                0, "self"))
    out.append(("enc_prompt_self", B, enc.n_heads, TP_PAD, TP_PAD, hd,
                TP_REFER, 0, "self"))
    pr = cfg.prompt_encoder.in_channels
    out.append(("pool_ref_enc", B, 1, 1, TP_PAD + 1, pr, None, 0, "cross"))
    out.append(("pool_add_embedding", B, d.addition_embed_heads, 1,
                TP_PAD + 1, d.hidden_channels // d.addition_embed_heads,
                None, 0, "cross"))
    return out


def resnet_cases(unet):
    """(name, T, C, Co, film) of both epilogues of every resnet block, and
    the output tail, at the serving bucket."""
    from ns2vc_tpu_torch.models.unet import ResnetBlock1D

    n = len(unet.chans)
    out = []
    for name, m in unet.named_children():
        if not isinstance(m, ResnetBlock1D):
            continue
        part, lvl = name.split("_")[:2]
        level = n - 1 if part == "mid" else (
            int(lvl) if part == "down" else n - 1 - int(lvl))
        t = T_PAD // 2 ** level
        cin, co = m.conv1.in_channels, m.conv1.out_channels
        out.append((f"{name}.1", t, cin, co, False))
        out.append((f"{name}.2", t, co, co, True))
    out.append(("conv_out", T_PAD, unet.chans[0],
                unet.conv_out.out_channels, False))
    return out


# -- phases -----------------------------------------------------------------

def check_attention(cfg, dev):
    import torch

    from ns2vc_tpu_torch.ops.attention import split_heads
    from ns2vc_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    worst, ms_step, plain_step = 0.0, 0.0, 0.0
    for name, b, h, tq, tk, d, valid, calls, layout in attention_cases(cfg):
        c = h * d
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape):
                return torch.randn(shape, generator=g, device=dev).to(dtype)
            if layout == "self":
                q, k, v = rnd(b, tq, 3 * c).split(c, dim=-1)
            else:
                q, k, v = rnd(b, tq, c), rnd(b, tk, c), rnd(b, tk, c)
            q, k, v = (split_heads(x, h) for x in (q, k, v))
            bias = None
            if valid is not None:
                bias = torch.zeros(b, tk, device=dev)
                bias[:, valid:] = -1e4
            got = flash_attention(q, k, v, bias)
            want = flash_attention_plain(q, k, v, bias)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = ATTN_F32_ATOL if dtype == torch.float32 else ATTN_BF16_ATOL
            ms = time_ms(lambda: flash_attention(q, k, v, bias))
            pms = time_ms(lambda: flash_attention_plain(q, k, v, bias))
            say(f"K1 {name:20s} {str(dtype)[6:]:8s} B={b} H={h} Tq={tq} "
                f"Tk={tk} D={d} max_abs_err={err:.3e} (tol {tol:g}) "
                f"kernel_ms={ms:.4f} plain_ms={pms:.4f}")
            if not err <= tol:
                fail(f"K1 {name} {dtype}: error {err} > {tol}")
            if dtype == torch.float32:
                worst = max(worst, err)
            else:
                ms_step += calls * ms
                plain_step += calls * pms
    # a batch row whose keys are all masked stays finite
    q = torch.randn(2, 4, 37, 32, generator=g, device=dev)
    k = torch.randn(2, 4, 50, 32, generator=g, device=dev)
    for fill in (-1e4, -1e30):
        bias = torch.zeros(2, 50, device=dev)
        bias[1] = fill
        out = flash_attention(q, k, k, bias)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"K1 fully masked row (bias {fill}) is not finite")
    say("K1 fully masked batch rows: finite")
    return worst, ms_step, plain_step


def check_resnet(unet, dev):
    import torch

    from ns2vc_tpu_torch.ops.fused_resnet import (
        affine_silu_conv1d, affine_silu_conv1d_plain, group_norm_affine,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = resnet_cases(unet) + [("ragged_T", 437, 128, 128, True)]
    worst, ms_step, plain_step = 0.0, 0.0, 0.0
    for name, t, c, co, film in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(B, t, c, generator=g, device=dev).to(dtype)
            w = (torch.randn(co, c, 3, generator=g, device=dev)
                 / (3 * c) ** 0.5).to(dtype)
            bias = (0.1 * torch.randn(co, generator=g, device=dev)).to(dtype)
            gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
            beta = 0.1 * torch.randn(c, generator=g, device=dev)
            s = sh = None
            if film:
                s = 0.2 * torch.randn(B, c, generator=g, device=dev)
                sh = 0.2 * torch.randn(B, c, generator=g, device=dev)
            a, b = group_norm_affine(x, gamma, beta, 8, 1e-5, s, sh)
            got = affine_silu_conv1d(x, a, b, w, bias)
            want = affine_silu_conv1d_plain(x, a, b, w, bias)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                tol = RESNET_F32_ATOL
            else:
                tol = RESNET_BF16_RTOL * max(1.0, want.float().abs().max()
                                             .item())
            ms = time_ms(lambda: affine_silu_conv1d(x, a, b, w, bias))
            pms = time_ms(lambda: affine_silu_conv1d_plain(x, a, b, w, bias))
            say(f"K2 {name:18s} {str(dtype)[6:]:8s} B={B} T={t} C={c} "
                f"Co={co} film={int(film)} max_abs_err={err:.3e} "
                f"(tol {tol:.3g}) kernel_ms={ms:.4f} plain_ms={pms:.4f}")
            if not err <= tol:
                fail(f"K2 {name} {dtype}: error {err} > {tol}")
            if dtype == torch.float32:
                worst = max(worst, err)
            elif name != "ragged_T":
                ms_step += ms
                plain_step += pms
    return worst, ms_step, plain_step


def check_full_model(cfg, sd, vsd, dev):
    """Full width, f32, TF32 off: encode, precompute, one denoise and a
    Vocos decode on the card (kernels) against the CPU (plain versions)."""
    import torch

    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
    from ns2vc_tpu_torch.models.vocos import vocos_from_state_dict
    from ns2vc_tpu_torch.ops.masking import sequence_mask

    r = np.random.default_rng(SEED)
    b, t, tp = 2, 64, 48
    inputs = {
        "c": 0.1 * r.standard_normal((b, t, 256)),
        "refer": r.standard_normal((b, tp, 100)),
        "x": r.standard_normal((b, t, 100)),
        "ts": np.array([500.0, 20.0]),
    }
    lengths, refer_lengths = torch.tensor([64, 45]), torch.tensor([48, 30])
    outs = {}
    for where in ("cuda", "cpu"):
        device = dev if where == "cuda" else torch.device("cpu")
        model = NaturalSpeech2(cfg)
        model.load_state_dict(sd)
        model.to(device).eval()
        vocos = vocos_from_state_dict(vsd, cfg.data.hop_length)
        vocos.load_state_dict(vsd)
        vocos.to(device).eval()
        c, refer, x, ts = (torch.tensor(inputs[k], dtype=torch.float32,
                                        device=device)
                           for k in ("c", "refer", "x", "ts"))
        with torch.no_grad():
            c_mask = sequence_mask(lengths.to(device), t)
            r_mask = sequence_mask(refer_lengths.to(device), tp)
            content, prompt = model.encode(c, refer, c_mask, r_mask)
            aug, kvs = model.precompute_conditioning(prompt)
            x0 = model.denoise(x, content, prompt, r_mask, ts, cross_kv=kvs,
                               aug_emb=aug)
            wav = vocos(x0)
        outs[where] = {"content": content, "prompt": prompt, "unet": x0,
                       "wav": wav}
    errs = {}
    for key in outs["cpu"]:
        a, b_ = outs["cuda"][key].cpu(), outs["cpu"][key]
        if not torch.isfinite(a).all():
            fail(f"full model: {key} not finite on the card")
        errs[key] = (a - b_).abs().max().item()
        say(f"full-width f32 {key:8s} shape={tuple(a.shape)} max_abs_err="
            f"{errs[key]:.3e} max_abs={b_.abs().max().item():.3e}")
    wav_scale = max(1.0, outs["cpu"]["wav"].abs().max().item())
    if not errs["unet"] <= UNET_ATOL:
        fail(f"full model: UNet error {errs['unet']} > {UNET_ATOL}")
    for key in ("content", "prompt"):
        if not errs[key] <= MODEL_ATOL:
            fail(f"full model: {key} error {errs[key]} > {MODEL_ATOL}")
    if not errs["wav"] <= MODEL_ATOL * wav_scale:
        fail(f"full model: waveform error {errs['wav']} > {MODEL_ATOL} x "
             f"{wav_scale}")
    say(f"full-width f32 card vs CPU: UNet {errs['unet']:.3e} <= "
        f"{UNET_ATOL}, waveform {errs['wav']:.3e} <= {MODEL_ATOL} x "
        f"max(1, max|wav|)={wav_scale:.3g}")


def check_serving(cfg, sd, vsd, dev):
    import torch

    from ns2vc_tpu_torch.infer.svc import Svc
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention
    from ns2vc_tpu_torch.ops.fused_resnet import affine_silu_conv1d

    svc = Svc(cfg, params=sd, vocos_params=vsd, compute_dtype="bfloat16",
              device=dev)
    r = np.random.default_rng(SEED + 2)
    clips = [(0.1 * r.standard_normal((T_CLIP, 256))).astype(np.float32)
             for _ in range(B)]
    refer = r.standard_normal((TP_REFER, 100)).astype(np.float32)
    hop = cfg.data.hop_length
    n_samples = T_CLIP * hop

    def run(output):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = svc.infer_batch(clips, refer, sampling_timesteps=STEPS,
                               order=2, output=output)
        torch.cuda.synchronize()
        return outs, (time.perf_counter() - t0) * 1e3

    outs, warm_ms = run("float32")   # warm-up call, checked in f32
    if len(outs) != B or any(o.shape != (n_samples,) or o.dtype != np.float32
                             or not np.isfinite(o).all() for o in outs):
        fail("serving warm-up (float32): wrong count, shape, dtype or "
             "non-finite output")
    flash_attention.launches = affine_silu_conv1d.launches = 0
    outs, ms = run("pcm16")
    counts = {"flash_attention": flash_attention.launches,
              "affine_silu_conv1d": affine_silu_conv1d.launches}
    if len(outs) != B or any(o.shape != (n_samples,) or o.dtype != np.int16
                             for o in outs):
        fail("serving (pcm16): wrong count, shape or dtype")
    n_levels = len(cfg.diffusion_encoder.block_out_channels)
    want = {"flash_attention": 14 + STEPS * 32,
            "affine_silu_conv1d": STEPS * 45}
    if n_levels != 4 or counts != want:
        fail(f"launch counts {counts}, expected {want}")
    audio_s = B * n_samples / cfg.data.sampling_rate
    say(f"serving B={B} T={T_CLIP} Tp={TP_REFER} steps={STEPS} bf16 pcm16: "
        f"{B} x int16 ({n_samples},) finite; warm-up {warm_ms:.1f} ms, "
        f"call {ms:.1f} ms = {audio_s / (ms / 1e3):.2f}x real time; launches "
        f"{counts}")
    single_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = svc.infer_from_features(clips[0], refer, sampling_timesteps=STEPS,
                                    order=2)
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t0) * 1e3)
        if w.shape != (n_samples,) or w.dtype != np.float32 \
                or not np.isfinite(w).all():
            fail("single request: wrong shape, dtype or non-finite output")
    say(f"single request B=1 T={T_CLIP} steps={STEPS} bf16: f32 "
        f"({n_samples},) finite; first {single_ms[0]:.1f} ms, second "
        f"{single_ms[1]:.1f} ms = "
        f"{n_samples / cfg.data.sampling_rate / (single_ms[1] / 1e3):.2f}x "
        f"real time")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    try:
        from ns2vc_tpu.config import Config
        from ns2vc_tpu_torch.convert import init_params, init_vocos_params
        from ns2vc_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 2

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    say(f"build: {info.path.name} in {info.seconds:.1f} s "
        f"(first use {time.perf_counter() - t0:.1f} s)")
    for line in info.log.splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line):
            say(f"  {line.strip()}")

    cfg = Config()
    gen = torch.Generator().manual_seed(SEED)
    sd = init_params(cfg, gen)
    vsd = init_vocos_params(gen, hop_length=cfg.data.hop_length)
    with torch.device("meta"):
        from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
        unet = NaturalSpeech2(cfg).diff_model.unet

    k1_err, k1_ms, k1_plain = check_attention(cfg, dev)
    k2_err, k2_ms, k2_plain = check_resnet(unet, dev)
    check_full_model(cfg, sd, vsd, dev)
    counts = check_serving(cfg, sd, vsd, dev)

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "ns2vc_tpu_torch/csrc/flash_attention.cu",
         "replaces": "ns2vc_tpu/ops/pallas_attention.py:92",
         "launches": counts["flash_attention"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "affine_silu_conv1d", "route": "cuda",
         "source": "ns2vc_tpu_torch/csrc/gn_silu_conv1d.cu",
         "replaces": "ns2vc_tpu/ops/pallas_resnet.py:71",
         "launches": counts["affine_silu_conv1d"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
