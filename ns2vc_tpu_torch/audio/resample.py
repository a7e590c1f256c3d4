"""Polyphase windowed-sinc resampling as one strided conv1d (counterpart of
ns2vc_tpu/audio/resample.py: `sinc_resample_kernel`, `Resampler`,
`resample`, `resample_np`).

torchaudio's Resample defaults (sinc interpolation, hann window,
lowpass_filter_width 6, rolloff 0.99). The kernel bank is built on the host
in float64 and applied on the waveform's device: pad (width, width + orig),
conv1d with stride orig into `new` phases, interleave, and keep
ceil(new * L / orig) samples.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def sinc_resample_kernel(orig_freq: int, new_freq: int,
                         lowpass_filter_width: int = 6,
                         rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """(kernel (new_r, 2*width + orig_r) f32, width) with the rates reduced
    by their gcd; `width` is the left padding at apply time."""
    gcd = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // gcd, new_freq // gcd
    if lowpass_filter_width <= 0:
        raise ValueError("lowpass_filter_width must be positive")
    base_freq = min(orig, new) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig / base_freq))
    idx = np.arange(-width, width + orig, dtype=np.float64) / orig
    t = (-np.arange(new, dtype=np.float64) / new)[:, None] + idx[None, :]
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel *= window * base_freq / orig
    return kernel.astype(np.float32), width


class Resampler:
    """Fixed-rate-pair resampler, (..., L) -> (..., ceil(L * new / orig))
    in f32 on the waveform's device; the kernel bank is built once, on the
    host. `resample` is this class's call, cached per rate pair."""

    def __init__(self, orig_freq: int, new_freq: int,
                 lowpass_filter_width: int = 6, rolloff: float = 0.99):
        self.orig_freq, self.new_freq = orig_freq, new_freq
        gcd = math.gcd(orig_freq, new_freq)
        self.orig, self.new = orig_freq // gcd, new_freq // gcd
        kernel, self.width = sinc_resample_kernel(
            orig_freq, new_freq, lowpass_filter_width, rolloff)
        self.kernel = torch.from_numpy(kernel[:, None, :])   # (new, 1, W)

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        if self.orig == self.new:
            return wav
        length = wav.shape[-1]
        x = wav.reshape(-1, 1, length).float()
        x = F.pad(x, (self.width, self.width + self.orig))
        y = F.conv1d(x, self.kernel.to(x.device), stride=self.orig)
        y = y.transpose(1, 2).reshape(x.shape[0], -1)      # (B, T' * new)
        target = -(-self.new * length // self.orig)
        return y[:, :target].reshape(wav.shape[:-1] + (target,))


@functools.lru_cache(maxsize=16)
def _get_resampler(orig_freq: int, new_freq: int) -> Resampler:
    return Resampler(orig_freq, new_freq)


def resample_np(wav: np.ndarray, orig_freq: int, new_freq: int
                ) -> np.ndarray:
    """numpy twin of `resample` for a 1-D waveform (the same kernel bank, a
    host matmul; ns2vc_tpu/audio/resample.py:112-124), for device-free
    callers such as the data loader's forked workers."""
    if orig_freq == new_freq:
        return wav
    r = _get_resampler(orig_freq, new_freq)
    kernel = r.kernel[:, 0, :].numpy()
    length = wav.shape[-1]
    x = np.pad(np.asarray(wav, np.float32), (r.width, r.width + r.orig))
    frames = np.lib.stride_tricks.sliding_window_view(
        x, kernel.shape[1])[::r.orig]
    y = (frames @ kernel.T).reshape(-1)   # (n_pos, new) -> interleaved
    return y[: -(-r.new * length // r.orig)]


def resample(wav: torch.Tensor, orig_freq: int, new_freq: int
             ) -> torch.Tensor:
    """(..., L) -> (..., ceil(L * new / orig)) in f32, on wav's device."""
    if orig_freq == new_freq:
        return wav
    return _get_resampler(orig_freq, new_freq)(wav)
