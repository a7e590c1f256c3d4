"""Mel + F0 -> waveform reconstruction through the port's NSF-HiFiGAN
(`ns2vc_tpu_torch`; counterpart of scripts/reconstruct_nsf.py, the
reference's test.py:165-192).

    python scripts/torch_reconstruct_nsf.py --wav input.wav \
        --ckpt nsf_hifigan/model --config nsf_hifigan/config.json \
        --out recon.wav [-d cuda|cpu]

The wav is read, mixed to mono and resampled to the config's rate; its
log-mel (n_fft from the config, default 2048; hop = prod(upsample_rates);
num_mels) and its DIO F0 (unvoiced frames interpolated) feed the generator,
whose sine source takes its initial phases from a seed-0 generator. It runs
on `cuda` unless given `-d cpu`, and exits with an error without a card.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ns2vc_tpu_torch.audio.f0 import (  # noqa: E402
    compute_f0_dio, interpolate_f0,
)
from ns2vc_tpu_torch.audio.mel import log_mel_spectrogram  # noqa: E402
from ns2vc_tpu_torch.audio.resample import resample  # noqa: E402
from ns2vc_tpu_torch.infer.svc import resolve_device  # noqa: E402
from ns2vc_tpu_torch.models.nsf_hifigan import load_nsf_hifigan  # noqa: E402
from ns2vc_tpu_torch.utils.wavio import read_wav, write_wav  # noqa: E402


def main(argv=None) -> np.ndarray:
    """Run the reconstruction; returns the written waveform (f32)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--wav", required=True)
    p.add_argument("--ckpt", required=True, help="NSF-HiFiGAN generator ckpt")
    p.add_argument("--config", required=True, help="its config.json")
    p.add_argument("--out", default="recon.wav")
    p.add_argument("-d", "--device", default="cuda", help="cuda (default) or "
                   "cpu")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"torch_reconstruct_nsf: device {args.device!r} "
                         f"requested but no CUDA device is available; pass "
                         f"-d cpu to run on the CPU")
    dev = resolve_device(args.device)

    with open(args.config) as f:
        cfg = json.load(f)
    sr = cfg["sampling_rate"]
    hop = int(np.prod(cfg["upsample_rates"]))

    wav, in_sr = read_wav(args.wav)
    if wav.ndim > 1:
        wav = wav.mean(axis=0)
    with torch.no_grad():
        x = resample(torch.from_numpy(np.ascontiguousarray(
            wav, np.float32)).to(dev), in_sr, sr)
        mel = log_mel_spectrogram(x, sr, cfg.get("n_fft", 2048), hop,
                                  cfg["num_mels"])                # (M, T)
        f0 = compute_f0_dio(x.cpu().numpy(), p_len=mel.shape[1],
                            sampling_rate=sr, hop_length=hop)
        f0, _ = interpolate_f0(f0)
        gen = load_nsf_hifigan(args.ckpt, cfg).to(dev)
        out = gen(mel.T[None], torch.from_numpy(f0)[None].to(dev),
                  generator=torch.Generator().manual_seed(0))[0]
        out = out.cpu().numpy()
    write_wav(args.out, out, sr)
    print(f"wrote {args.out} ({len(out) / sr:.2f}s)")
    return out


if __name__ == "__main__":
    main()
