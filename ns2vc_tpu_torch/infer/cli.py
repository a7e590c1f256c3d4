"""Batch voice-conversion CLI of the port (counterpart of
ns2vc_tpu/infer/cli.py, with the same flags):

    python -m ns2vc_tpu_torch.infer.cli -m model.pt -n src.wav -r refer.wav \\
        --vocos_ckpt vocos/pytorch_model.bin

slice on silence -> pad 0.5 s -> `Svc.slice_inference` (batched chunks) ->
unpad -> optional linear-gradient crossfade of forced clips -> write
`{out_dir}/{name}_{key}_{refer}.wav`. `-d/--device` defaults to cuda; with
no card the CLI exits non-zero, and running on the CPU takes `-d cpu`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def crossfade_concat(pieces: list[np.ndarray], cross_len: int,
                     retain: float = 1.0) -> np.ndarray:
    """Linear-gradient crossfade between consecutive (overlapping) clips
    with `retain` (-lgr) retention: of the cross_len overlap, the middle
    retain-fraction is blended and the flanks are discarded."""
    if not pieces:
        return np.zeros(0, np.float32)
    out = pieces[0]
    r = int(cross_len * retain)
    c_l = (cross_len - r) // 2
    c_r = cross_len - r - c_l
    ramp = np.linspace(0, 1, r, dtype=np.float32) if r > 0 else None
    for nxt in pieces[1:]:
        if r <= 0 or len(out) < r + c_r or len(nxt) < c_l + r:
            out = np.concatenate([out, nxt])
            continue
        lg1 = out[-(r + c_r): len(out) - c_r] if c_r else out[-r:]
        lg2 = nxt[c_l: c_l + r]
        merged = lg1 * (1 - ramp) + lg2 * ramp
        out = np.concatenate([out[: -(r + c_r)], merged, nxt[c_l + r:]])
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ns2vc inference (PyTorch/CUDA)")
    p.add_argument("-m", "--model_path", type=str, required=True,
                   help="reference model-{N}.pt, or a port state dict "
                        "saved with torch.save")
    p.add_argument("-c", "--config_path", type=str, default=None)
    p.add_argument("-n", "--clean_names", type=str, nargs="+", required=True)
    p.add_argument("-r", "--refer_names", type=str, nargs="+", required=True)
    p.add_argument("-t", "--trans", type=int, nargs="+", default=[0])
    p.add_argument("-a", "--auto_predict_f0", action="store_true",
                   default=False,
                   help="condition on the F0 the model's predictor makes "
                        "from content and the reference instead of the "
                        "source pitch (checkpoints with f0_predictor "
                        "enabled; others ignore it)")
    p.add_argument("-fmp", "--f0_mean_pooling", action="store_true",
                   default=False,
                   help="use CREPE F0 with mean-pooling decode (needs "
                        "--crepe_ckpt)")
    p.add_argument("-ft", "--f0_filter_threshold", type=float, default=0.05,
                   help="CREPE voicing threshold, valid with -fmp")
    p.add_argument("-sd", "-s", "--slice_db", type=int, default=-40)
    p.add_argument("-cl", "--clip", type=float, default=0,
                   help="force-clip long segments to this many seconds")
    p.add_argument("-lg", "--linear_gradient", type=float, default=0,
                   help="crossfade seconds between forced clips")
    p.add_argument("-lgr", "--linear_gradient_retain", type=float,
                   default=0.75,
                   help="retained fraction of the crossfade overlap, "
                        "range (0-1]")
    p.add_argument("-p", "--pad_seconds", type=float, default=0.5)
    p.add_argument("-d", "--device", type=str, default="cuda",
                   help="torch device (default cuda; without a card the "
                        "CLI exits, use -d cpu to run on the CPU)")
    p.add_argument("--contentvec_ckpt", type=str,
                   default="hubert/checkpoint_best_legacy_500.pt")
    p.add_argument("--vocos_ckpt", type=str, default=None)
    p.add_argument("--crepe_ckpt", type=str, default="crepe/full.pth")
    p.add_argument("--sample_method", type=str, default="unipc",
                   choices=["ddpm", "ddim", "dpmsolver", "unipc"])
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--sampling_timesteps", type=int, default=30)
    p.add_argument("--solver_order", type=int, default=2, choices=[1, 2, 3],
                   help="multistep order for dpmsolver/unipc")
    p.add_argument("--no_ema", action="store_true", default=False,
                   help="deploy a trainer checkpoint's raw parameters "
                        "instead of its EMA parameters")
    p.add_argument("-wf", "--wav_format", type=str, default="wav")
    p.add_argument("--raw_dir", type=str, default="raw")
    p.add_argument("--out_dir", type=str, default="output")
    return p


def main(argv=None) -> int:
    import torch

    from ns2vc_tpu_torch.audio.host import write_wav
    from ns2vc_tpu_torch.infer.svc import Svc

    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit(f"ns2vc_tpu_torch.infer.cli: device "
                         f"{args.device!r} requested but no CUDA device is "
                         f"available; pass -d cpu to run on the CPU")
    svc = Svc(args.model_path, args.config_path,
              contentvec_ckpt=args.contentvec_ckpt,
              vocos_ckpt=args.vocos_ckpt, crepe_ckpt=args.crepe_ckpt,
              compute_dtype=args.compute_dtype, device=args.device,
              use_ema_params=not args.no_ema)
    os.makedirs(args.out_dir, exist_ok=True)

    trans = args.trans * len(args.clean_names) if len(args.trans) == 1 \
        else args.trans
    for clean_name, tran in zip(args.clean_names, trans):
        raw_path = os.path.join(args.raw_dir, clean_name)
        if not os.path.splitext(raw_path)[1]:
            raw_path += ".wav"
        for refer_name in args.refer_names:
            refer_path = os.path.join(args.raw_dir, refer_name)
            if not os.path.splitext(refer_path)[1]:
                refer_path += ".wav"
            audio = svc.slice_inference(
                raw_path, refer_path, tran=tran, slice_db=args.slice_db,
                pad_seconds=args.pad_seconds,
                sample_method=args.sample_method,
                sampling_timesteps=args.sampling_timesteps,
                clip_seconds=args.clip, lg_seconds=args.linear_gradient,
                lgr=args.linear_gradient_retain, order=args.solver_order,
                auto_predict_f0=args.auto_predict_f0,
                f0_mean_pooling=args.f0_mean_pooling,
                cr_threshold=args.f0_filter_threshold)
            base = os.path.splitext(os.path.basename(clean_name))[0]
            rbase = os.path.splitext(os.path.basename(refer_name))[0]
            key = "auto" if args.auto_predict_f0 else f"{tran}key"
            out = os.path.join(
                args.out_dir, f"{base}_{key}_{rbase}.{args.wav_format}")
            write_wav(out, audio, svc.target_sample)
            print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
