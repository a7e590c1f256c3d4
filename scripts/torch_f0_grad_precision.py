"""How far f32 gradients of the port's F0 predictor are from each other and
from f64, on a card, with and without shared ReLU gates.

    python3 scripts/torch_f0_grad_precision.py [--batches N]

`Config()` with the F0 predictor (seed-0 weights, dropout off), one
training-loss step at B=2 x 272 on N seeded random batches (random valid
lengths, synthesized F0 contours; t, noise and the contour scale fixed).
For each batch, the gradients of the predictor's and the F0 embedding's
parameters: on the card in f32 (TF32 off), recording its ReLU gates; on
the CPU in f32 with its own gates; and on the CPU in f32 and in f64 with
the card's gates (`chip_smoke.relu_gates`). It prints, per pair, the
largest max|a - b| / max(1e-3, max|b|) over the tensors but the prenet's
LayerNorm scale (whose exact gradient is 0: its values are printed apart),
and how many of the CPU's own pre-activations would set a gate otherwise
than the card's.
Needs a CUDA device.
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from ns2vc_tpu_torch.convert import init_module_  # noqa: E402
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2  # noqa: E402

T = 272


def batch_for(seed: int) -> dict:
    r = np.random.default_rng(seed)
    f0s, uvs = chip_smoke.contours(2, T, seed + 1000)
    lengths = r.integers(150, T + 1, size=2)
    for f0, uv, n in zip(f0s, uvs, lengths):
        f0[n:], uv[n:] = 0.0, 0.0
    return {"c": torch.tensor(0.1 * r.standard_normal((2, T, 256)),
                              dtype=torch.float32),
            "refer": torch.tensor(r.standard_normal((2, T, 100)),
                                  dtype=torch.float32),
            "spec": torch.tensor(r.standard_normal((2, T, 100)),
                                 dtype=torch.float32),
            "f0": torch.tensor(np.stack(f0s)),
            "uv": torch.tensor(np.stack(uvs)),
            "lengths": torch.tensor(lengths),
            "refer_lengths": torch.tensor(r.integers(120, T + 1, size=2))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cfg = chip_smoke.f0_config()
    cfg = dataclasses.replace(
        cfg, phoneme_encoder=dataclasses.replace(cfg.phoneme_encoder,
                                                 p_dropout=0.0),
        prompt_encoder=dataclasses.replace(cfg.prompt_encoder,
                                           p_dropout=0.0),
        f0_predictor=dataclasses.replace(cfg.f0_predictor, p_dropout=0.0))
    sd = init_module_(NaturalSpeech2(cfg),
                      torch.Generator().manual_seed(0)).state_dict()
    g = torch.Generator().manual_seed(49)
    t = torch.randint(0, 1000, (2,), generator=g)
    noise = torch.randn(2, T, 100, generator=g)
    factor = 0.8 + 0.4 * torch.rand(2, generator=g)

    def grads(batch, device, dtype=torch.float32):
        m = NaturalSpeech2(cfg)
        m.load_state_dict(sd)
        m.to(device, dtype).train()
        b = {k: v.to(device, dtype) if v.is_floating_point() else
             v.to(device) for k, v in batch.items()}
        loss, _ = m(b, t=t.to(device), noise=noise.to(device, dtype),
                    f0_factor=factor.to(device, dtype))
        loss.backward()
        return {n: p.grad.detach().cpu().double()
                for n, p in m.named_parameters()
                if n.startswith(("pre_model.f0_predictor.",
                                 "pre_model.f0_emb."))}

    def furthest(a, b):
        w = {n: ((a[n] - b[n]).abs().max()
                 / max(1e-3, b[n].abs().max().item())).item() for n in b
             if n != chip_smoke.PRENET_LN_SCALE}
        worst = max(w, key=w.get)
        return f"{w[worst]:.2e} ({worst.split('pre_model.')[-1]})"

    dev = torch.device("cuda")
    zero = chip_smoke.PRENET_LN_SCALE
    for i in range(args.batches):
        batch = batch_for(i)
        t0 = time.perf_counter()
        gates, flips, flips64 = [], [], []
        with chip_smoke.no_tf32():
            with chip_smoke.relu_gates(gates):
                card = grads(batch, dev)
            cpu_own = grads(batch, "cpu")
            with chip_smoke.relu_gates(gates, flips):
                cpu = grads(batch, "cpu")
            with chip_smoke.relu_gates(gates, flips64):
                f64 = grads(batch, "cpu", torch.float64)
        print(f"batch {i} (lengths {batch['lengths'].tolist()}, "
              f"{time.perf_counter() - t0:.1f} s): own gates: card vs CPU "
              f"f32 {furthest(card, cpu_own)}; the card's gates: card vs CPU "
              f"f32 {furthest(card, cpu)}, card vs CPU f64 "
              f"{furthest(card, f64)}, "
              f"CPU f32 vs f64 {furthest(cpu, f64)}; gates the CPU would set "
              f"otherwise: f32 {sum(flips)}, f64 {sum(flips64)} of "
              f"{sum(x.numel() for x in gates)}; the prenet's LayerNorm "
              f"scale (zero in exact arithmetic), max|g|: card "
              f"{card[zero].abs().max().item():.2e}, CPU f32 "
              f"{cpu[zero].abs().max().item():.2e}, f64 "
              f"{f64[zero].abs().max().item():.2e}", flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
