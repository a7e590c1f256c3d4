"""Offline feature extraction (counterpart of ns2vc_tpu/data/preprocess.py).

    python -m ns2vc_tpu_torch.data.preprocess --in_dir DIR [--config CFG]
        [--contentvec_ckpt PT] [--num_workers N] [-d cuda|cpu]

Walks a dataset directory and writes, next to each wav in a mirrored
`<in_dir>_processed` tree (reference preprocess.py:26-83):
  - the 24 kHz mono wav (PCM 16),
  - `.wav.f0.npy`  DIO + StoneMask F0 at the mel hop (the port's DIO),
  - `.spec.npy`    (1, 100, T) log-mel,
  - `.soft.npy`    (1, 256, T50) ContentVec features, when a ContentVec is
                   given (a fairseq checkpoint path, or a module).

Reading the wavs and the F0 tracker run on the host, in a process pool
that never touches CUDA. Resampling, the log-mel and ContentVec run on the
device; ContentVec takes padded batches of up to 8 files per 4-second
length bucket with their lengths, so its attention (K1's f32 route on a
card) masks the padding. It runs on `cuda` unless given `device="cpu"`
(`-d cpu`), and raises without a card.
"""

from __future__ import annotations

import argparse
import glob
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ns2vc_tpu_torch.audio.f0 import compute_f0_dio
from ns2vc_tpu_torch.config import Config, load_config
from ns2vc_tpu_torch.utils.wavio import read_wav, write_wav

CONTENTVEC_BUCKET = 16000 * 4   # 4-second sample buckets
CONTENTVEC_BATCH = 8


def _out_path(filename: str, in_dir: str) -> str:
    out = filename.replace(in_dir, in_dir.rstrip("/\\") + "_processed", 1)
    return out.replace(".flac", ".wav").replace(".mp3", ".wav")


def _read(filename: str):
    """(mono f32 samples, rate), or None for an unreadable file."""
    try:
        wav, sr = read_wav(filename)
    except Exception as e:  # unsupported container (flac/mp3)
        print(f"skip {filename}: {e}")
        return None
    if wav.ndim > 1:
        wav = wav.mean(axis=0)
    return wav, sr


def _host_stage(out: str, wav24: np.ndarray, cfg: Config) -> None:
    """Write the 24 kHz wav and its DIO F0 (numpy only)."""
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    write_wav(out, wav24, cfg.data.sampling_rate)
    f0 = compute_f0_dio(wav24, sampling_rate=cfg.data.sampling_rate,
                        hop_length=cfg.data.hop_length)
    np.save(out + ".f0.npy", f0)


def _save_spec(out: str, wav24: torch.Tensor, cfg: Config) -> None:
    """The (1, n_mels, T) log-mel of the 24 kHz wav, beside it."""
    from ns2vc_tpu_torch.audio.mel import log_mel_spectrogram

    spec = log_mel_spectrogram(wav24, cfg.data.sampling_rate,
                               cfg.data.n_fft, cfg.data.hop_length,
                               cfg.data.n_mels)
    np.save(out.replace(".wav", "") + ".spec.npy", spec.cpu().numpy()[None])


def _pool(num_workers: int, n: int):
    """A spawned process pool for the host stages (the caller holds CUDA
    and its threads, which a fork would copy), or None to run them in this
    process."""
    if num_workers > 1 and n > 1:
        return ProcessPoolExecutor(
            max_workers=num_workers,
            mp_context=multiprocessing.get_context("spawn"))
    return None


def preprocess_dataset(in_dir: str, cfg: Optional[Config] = None,
                       contentvec_ckpt: Optional[str] = None,
                       num_workers: int = 8,
                       files: Optional[Sequence[str]] = None,
                       contentvec=None,
                       device: str | torch.device = "cuda") -> list[str]:
    """Process every wav (and flac) under in_dir; returns the output wav
    paths. `contentvec` (a ContentVec module) may be given instead of
    `contentvec_ckpt`; without either no `.soft.npy` is written."""
    from ns2vc_tpu_torch.audio.resample import resample
    from ns2vc_tpu_torch.features.contentvec import content_frames
    from ns2vc_tpu_torch.infer.svc import resolve_device

    cfg = cfg or Config()
    dev = resolve_device(device)
    if files is None:
        files = (glob.glob(f"{in_dir}/**/*.wav", recursive=True)
                 + glob.glob(f"{in_dir}/**/*.flac", recursive=True))
    if contentvec is None and contentvec_ckpt:
        if os.path.exists(contentvec_ckpt):
            from ns2vc_tpu_torch.features.contentvec import load_contentvec

            contentvec = load_contentvec(contentvec_ckpt)
        else:
            print(f"contentvec checkpoint {contentvec_ckpt} not found; "
                  "skipping .soft.npy extraction")
    if contentvec is not None:
        contentvec = contentvec.to(dev, torch.float32).eval()

    pool = _pool(num_workers, len(files))
    try:
        raw = list(pool.map(_read, files) if pool else map(_read, files))
        staged = []   # (out path, wav16 (numpy), wav24 (device))
        for filename, item in zip(files, raw):
            if item is None:
                continue
            wav, sr = item
            x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(dev)
            with torch.no_grad():
                wav16 = resample(x, sr, cfg.data.content_sr)
                wav24 = resample(x, sr, cfg.data.sampling_rate)
            staged.append((_out_path(filename, in_dir),
                           wav16.cpu().numpy(), wav24))
        outs = [s[0] for s in staged]
        host = [(out, w24.cpu().numpy(), cfg) for out, _, w24 in staged]
        if pool:
            list(pool.map(_host_stage, *zip(*host)))
        else:
            for args in host:
                _host_stage(*args)
    finally:
        if pool:
            pool.shutdown()

    with torch.no_grad():
        for out, _, wav24 in staged:
            _save_spec(out, wav24, cfg)
        if contentvec is None:
            return outs
        by_bucket: dict[int, list] = {}
        for idx, (_, wav16, _) in enumerate(staged):
            n = -(-len(wav16) // CONTENTVEC_BUCKET) * CONTENTVEC_BUCKET
            by_bucket.setdefault(n, []).append(idx)
        for n, idxs in sorted(by_bucket.items()):
            for i0 in range(0, len(idxs), CONTENTVEC_BATCH):
                group = idxs[i0: i0 + CONTENTVEC_BATCH]
                wavs = np.zeros((len(group), n), np.float32)
                lengths = []
                for row, idx in enumerate(group):
                    w = staged[idx][1]
                    wavs[row, : len(w)] = w
                    lengths.append(len(w))
                feats = contentvec(torch.from_numpy(wavs).to(dev),
                                   torch.tensor(lengths, device=dev))
                feats = feats.float().cpu().numpy()
                for row, idx in enumerate(group):
                    t = content_frames(lengths[row])
                    np.save(staged[idx][0] + ".soft.npy",
                            feats[row: row + 1, :t].transpose(0, 2, 1))
    return outs


def process_one(filename: str, in_dir: str, cfg: Config,
                contentvec=None, device: str | torch.device = "cuda"
                ) -> Optional[str]:
    """One file through the whole pipeline, unbatched (reference
    process_one, preprocess.py:26-60): the 24 kHz wav, its F0 and log-mel,
    and with a ContentVec module its `.soft.npy`, as `preprocess_dataset`
    writes them; the output wav path, or None for an unreadable file.
    Prefer `preprocess_dataset` for throughput."""
    from ns2vc_tpu_torch.audio.resample import resample
    from ns2vc_tpu_torch.infer.svc import resolve_device

    dev = resolve_device(device)
    item = _read(filename)
    if item is None:
        return None
    wav, sr = item
    out = _out_path(filename, in_dir)
    x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(dev)
    with torch.no_grad():
        wav24 = resample(x, sr, cfg.data.sampling_rate)
        _host_stage(out, wav24.cpu().numpy(), cfg)
        _save_spec(out, wav24, cfg)
        if contentvec is not None:
            contentvec = contentvec.to(dev, torch.float32).eval()
            feats = contentvec(resample(x, sr, cfg.data.content_sr)[None])
            np.save(out + ".soft.npy",
                    feats.float().cpu().numpy().transpose(0, 2, 1))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Offline feature extraction (reference preprocess.py)")
    parser.add_argument("--in_dir", type=str, default="dataset")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--contentvec_ckpt", type=str,
                        default="hubert/checkpoint_best_legacy_500.pt")
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("-d", "--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"ns2vc_tpu_torch.data.preprocess: device "
                         f"{args.device!r} requested but no CUDA device is "
                         f"available; pass -d cpu to run on the CPU")
    cfg = load_config(args.config)
    outs = preprocess_dataset(args.in_dir, cfg, args.contentvec_ckpt,
                              args.num_workers, device=args.device)
    print(f"processed {len(outs)} files -> {args.in_dir}_processed")


if __name__ == "__main__":
    main()
