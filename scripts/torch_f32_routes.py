"""Device times of the port's f32 kernel routes (K1 and K2) at the f32
serving geometry, and one f32 `Svc.infer_batch` call, on one GPU.

    python3 scripts/torch_f32_routes.py [--out FILE]

`Svc(compute_dtype=None)` serves in f32, so every UNet call of such a
serving call runs K1 and K2 on their f32 routes. At B=16 x 400 frames (the
448-frame bucket) over a 272-frame reference (320-frame bucket), `Config()`
at full width with seed-0 weights, this script times, with TF32 off:

- K1 at each attention geometry of one UNet step (32 calls), the encoders'
  and pooling calls, ContentVec's (1, 12, T, 64) at T = 400, the F0
  predictor's cross-attention (16 x 8 heads of 32, 448 over 320 keys, 272
  valid) and the op registry's D = 128 (4 x 2 heads, 400 x 400): the
  kernel, its plain version and `F.scaled_dot_product_attention`;
- K2 at each of one UNet step's 45 epilogues: the kernel, its plain
  version and cuDNN's conv1d of the pre-activated input alone;

each as the device time of 10 calls captured as a CUDA graph
(`chip_smoke.graph_ms`), beside chip_smoke's bound (3xTF32 for f32) and
the f32 CUDA cores' 67 TFLOP/s bound. Then one `Svc.infer_batch` f32 call
(50 UniPC steps, PyTorch's default TF32 settings, as served) after a
warm-up call: its wall time, and under torch.profiler its device time by
kernel (`chip_smoke.serving_profile`).

It prints one line per geometry and a JSON line {"f32_routes": ...} last
(also written to --out). Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

F32_CORES = 67e12   # H100 SXM f32 FMA peak, the f32 bound before 3xTF32


def cores_ms(flops, nbytes):
    """The bound at the f32 CUDA cores' rate, against the bytes' time."""
    return max(flops / F32_CORES, nbytes / cs.PEAK_BYTES) * 1e3


def k1_row(name, q, k, v, bias, calls=1):
    r = cs.k1_case(q, k, v, bias)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    flops = 4.0 * b * h * tq * tk * d
    nbytes = q.element_size() * 2 * b * h * (tq + tk) * d + (
        0 if bias is None else 4 * b * tk)
    cores, bound = cores_ms(flops, nbytes), r["bound"]
    row = {"name": name, "route": r["route"], "dtype": str(q.dtype)[6:],
           "shape": [b, h, tq, tk, d], "calls": calls, "err": r["err"],
           "ms": r["ms"], "plain_ms": r["plain"], "library_ms": r["lib"],
           "bound_f32_cores_ms": cores, "bound_ms": bound}
    cs.say(f"K1 {name:20s} {row['dtype']} {row['shape']} x{calls} "
           f"{r['route']} err {r['err']:.2e} ms {r['ms']:.4f} plain "
           f"{r['plain']:.4f} sdpa {r['lib']:.4f} bound {cores:.5f} / "
           f"{bound:.5f} [{cs.CARD}]")
    return row


def k2_row(name, bsz, t, c, co, film, g, dev):
    r = cs.k2_case(bsz, t, c, co, film, torch.float32, g, dev)
    flops = 6.0 * bsz * t * c * co
    nbytes = 4 * (bsz * t * c + 3 * co * c + co + bsz * t * co) + 8 * bsz * c
    cores, bound = cores_ms(flops, nbytes), r["bound"]
    row = {"name": name, "route": r["route"], "shape": [bsz, t, c, co],
           "calls": 1, "err": r["err"], "ms": r["ms"], "plain_ms": r["plain"],
           "conv_alone_ms": r["conv"], "bound_f32_cores_ms": cores,
           "bound_ms": bound}
    cs.say(f"K2 {name:18s} {row['shape']} {r['route']} err {r['err']:.2e} "
           f"ms {r['ms']:.4f} plain {r['plain']:.4f} conv alone "
           f"{r['conv']:.4f} bound {cores:.5f} / {bound:.5f} [{cs.CARD}]")
    return row


def total(rows, key):
    return sum(r["calls"] * r[key] for r in rows)


def svc_call(cfg, sd, vsd, dev):
    """One f32 Svc.infer_batch call at B=16 x 400, 50 steps, after a
    warm-up call: wall ms and launches, then the profiled device time."""
    from ns2vc_tpu_torch.infer.svc import Svc

    svc = Svc(config=cfg, params=sd, vocos_params=vsd, compute_dtype=None,
              device=dev)
    r = np.random.default_rng(cs.SEED + 2)
    clips = [(0.1 * r.standard_normal((cs.T_CLIP, 256))).astype(np.float32)
             for _ in range(cs.B)]
    refer = r.standard_normal((cs.TP_REFER, 100)).astype(np.float32)

    def call():
        return svc.infer_batch(clips, refer, sampling_timesteps=cs.STEPS,
                               order=2, output="float32")
    outs, warm = cs.wall_ms(call)
    if not all(np.isfinite(o).all() for o in outs):
        cs.fail("f32 serving: non-finite output")
    cs.reset_launches()
    _, wall = cs.wall_ms(call)
    launches = cs.route_counts()
    cs.say(f"Svc.infer_batch f32 B={cs.B} T={cs.T_CLIP} steps={cs.STEPS}: "
           f"warm-up {warm:.1f} ms, call {wall:.1f} ms; launches {launches} "
           f"[{cs.CARD}]")
    return {"warmup_ms": warm, "launches": launches,
            **cs.serving_profile(call, wall, f"serving B={cs.B} f32")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_f32_routes: no CUDA device", file=sys.stderr)
        return 2
    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.convert import init_params, init_vocos_params
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
    from ns2vc_tpu_torch.ops import _build
    from ns2vc_tpu_torch.ops.attention import split_heads

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cs.CARD = cs.card_line()
    t0 = time.perf_counter()
    _build.library()
    cs.say(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
           f"; build {time.perf_counter() - t0:.1f} s; {cs.CARD}")
    cfg = Config()
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    k1_rows, k2_rows = [], []
    with cs.no_tf32():
        for name, b, h, tq, tk, d, valid, calls, layout in \
                cs.attention_cases(cfg):
            if name.startswith("contentvec"):
                continue
            c = h * d
            if layout == "self":
                q, k, v = torch.randn(b, tq, 3 * c, generator=g,
                                      device=dev).split(c, dim=-1)
            else:
                q, k, v = (torch.randn(b, n, c, generator=g, device=dev)
                           for n in (tq, tk, tk))
            q, k, v = (split_heads(x, h) for x in (q, k, v))
            bias = None
            if valid is not None:
                bias = torch.zeros(b, tk, device=dev)
                bias[:, valid:] = -1e4
            k1_rows.append(k1_row(name, q, k, v, bias, calls))
        extra = []
        q, k, v = (torch.randn(1, 12, 400, 64, generator=g, device=dev)
                   for _ in range(3))
        extra.append(k1_row("contentvec_T400", q, k, v, None))
        bias = torch.zeros(cs.B, cs.TP_PAD, device=dev)
        bias[:, cs.TP_REFER:] = -1e4
        q, k, v = (split_heads(torch.randn(cs.B, n, 256, generator=g,
                                           device=dev), 8)
                   for n in (cs.T_PAD, cs.TP_PAD, cs.TP_PAD))
        extra.append(k1_row("f0_predictor_cross", q, k, v, bias))
        bias = torch.zeros(4, 400, device=dev)
        bias[1::2, 300:] = -1e4
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(4, 400, 768, generator=g, device=dev).to(dtype)
            q, k, v = (split_heads(x, 2) for x in qkv.split(256, dim=-1))
            extra.append(k1_row(f"d128_{str(dtype)[6:]}", q, k, v, bias))
        with torch.device("meta"):
            unet = NaturalSpeech2(cfg).diff_model.unet
        for name, t, c, co, film in cs.resnet_cases(unet):
            k2_rows.append(k2_row(name, cs.B, t, c, co, film, g, dev))
    step = {"k1": {key: total(k1_rows, key) for key in
                   ("ms", "plain_ms", "library_ms", "bound_f32_cores_ms",
                    "bound_ms")},
            "k2": {key: total(k2_rows, key) for key in
                   ("ms", "plain_ms", "conv_alone_ms", "bound_f32_cores_ms",
                    "bound_ms")}}
    step["k1"]["calls"] = sum(r["calls"] for r in k1_rows)
    step["k2"]["calls"] = len(k2_rows)
    for k in ("k1", "k2"):
        cs.say(f"one f32 UNet step at B={cs.B}, {k.upper()}: "
               + ", ".join(f"{key} {v:.4f}" for key, v in step[k].items())
               + f" [{cs.CARD}]")
    out = {"card": cs.CARD, "unet_step": step, "k1": k1_rows + extra,
           "k2": k2_rows}
    sd = init_params(cfg, torch.Generator().manual_seed(cs.SEED))
    vsd = init_vocos_params(torch.Generator().manual_seed(cs.SEED),
                            hop_length=cfg.data.hop_length)
    out["svc_f32"] = svc_call(cfg, sd, vsd, dev)
    line = json.dumps({"f32_routes": out})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
