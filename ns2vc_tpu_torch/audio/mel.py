"""STFT, log-mel, the inverse STFT and the overlap-add of the Vocos head
(counterpart of ns2vc_tpu/audio/mel.py).

Log-mel semantics are torchaudio's MelSpectrogram(sample_rate=24000,
n_fft=1024, hop_length=256, n_mels=100, center=True, power=1) followed by
log(clamp(., 1e-7)): periodic hann window, reflect centre padding,
magnitude spectrogram, HTK mel scale, no filterbank norm. The filterbank
and window are host constants; the STFT and the projection run on the
waveform's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(freq) -> np.ndarray:
    """HTK mel scale (torchaudio's default for MelSpectrogram)."""
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_to_hz(mel) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: float | None = None
                   ) -> np.ndarray:
    """Triangular HTK filterbank without norm, (n_freqs, n_mels) f32."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic hann window (torch.hann_window default), float32."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
        np.float32)


def _pad_window(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    """torch centre-pads a window shorter than n_fft to n_fft."""
    if window.shape[-1] < n_fft:
        lpad = (n_fft - window.shape[-1]) // 2
        window = F.pad(window, (lpad, n_fft - window.shape[-1] - lpad))
    return window


def stft(x: torch.Tensor, window: torch.Tensor, n_fft: int = 1024,
         hop: int = 256, center: bool = True) -> torch.Tensor:
    """Complex STFT of (..., L) -> (..., 1 + L//hop, n_fft//2 + 1); center
    pads n_fft//2 per side by reflection (torch.stft semantics)."""
    window = _pad_window(window, n_fft)
    x = x.float()
    if center:
        shape = x.shape
        x = F.pad(x.reshape(-1, 1, shape[-1]), (n_fft // 2, n_fft // 2),
                  mode="reflect").reshape(shape[:-1] + (-1,))
    frames = x.unfold(-1, n_fft, hop) * window.to(x.device)
    return torch.fft.rfft(frames, dim=-1)


class MelSpectrogram:
    """(..., L) waveform at `sample_rate` -> (..., n_mels, 1 + L//hop)
    log-mel (or linear mel with log=False)."""

    def __init__(self, sample_rate: int = 24000, n_fft: int = 1024,
                 hop_length: int = 256, win_length: int | None = None,
                 n_mels: int = 100, f_min: float = 0.0,
                 f_max: float | None = None, power: float = 1.0,
                 log_clip: float = 1e-7):
        self.n_fft, self.hop_length = n_fft, hop_length
        self.power, self.log_clip = power, log_clip
        self.window = torch.from_numpy(hann_window(win_length or n_fft))
        self.fbank = torch.from_numpy(mel_filterbank(
            n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max))

    def __call__(self, wav: torch.Tensor, log: bool = True) -> torch.Tensor:
        mag = stft(wav, self.window, self.n_fft, self.hop_length).abs()
        if self.power != 1.0:
            mag = mag ** self.power
        mel = torch.matmul(mag, self.fbank.to(mag.device)).transpose(-1, -2)
        return torch.log(mel.clamp(min=self.log_clip)) if log else mel


@functools.lru_cache(maxsize=8)
def _get_mel(sample_rate: int, n_fft: int, hop_length: int,
             n_mels: int) -> MelSpectrogram:
    return MelSpectrogram(sample_rate=sample_rate, n_fft=n_fft,
                          hop_length=hop_length, n_mels=n_mels)


def log_mel_spectrogram(wav: torch.Tensor, sample_rate: int = 24000,
                        n_fft: int = 1024, hop_length: int = 256,
                        n_mels: int = 100) -> torch.Tensor:
    """One-shot log-mel (constants cached per geometry)."""
    return _get_mel(sample_rate, n_fft, hop_length, n_mels)(wav)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """OLA of (..., T, n_fft) -> (..., (T-1)*hop + n_fft), scatter-free:
    split each frame into K = n_fft/hop hop blocks and sum K shifted
    slices."""
    n_fft, num_frames = frames.shape[-1], frames.shape[-2]
    if n_fft % hop:
        raise ValueError(f"overlap_add needs hop | n_fft, got {hop}, {n_fft}")
    k = n_fft // hop
    out_blocks = num_frames + k - 1
    out = frames.new_zeros(frames.shape[:-2] + (out_blocks, hop))
    split = frames.reshape(frames.shape[:-1] + (k, hop))
    for i in range(k):
        out[..., i:i + num_frames, :] += split[..., i, :]
    return out.reshape(frames.shape[:-2] + (out_blocks * hop,))


def istft(spec: torch.Tensor, window: torch.Tensor, n_fft: int = 1024,
          hop: int = 256, center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT with torch.istft's semantics: (..., T, n_fft//2 + 1)
    complex -> (..., samples) f32. Each frame's irfft times the window
    (centre-padded to n_fft), overlap-added, divided by the overlap-added
    squared window floored at 1e-11; center drops n_fft//2 samples at the
    start and, unless `length` is given, at the end; `length` cuts the
    result to that many samples."""
    window = _pad_window(window, n_fft).to(spec.device, torch.float32)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    sig = overlap_add(frames, hop)
    env = overlap_add((window * window).expand(frames.shape[-2:]), hop)
    sig = sig / env.clamp(min=1e-11)
    if center:
        sig = sig[..., n_fft // 2:]
        if length is None:
            return sig[..., : sig.shape[-1] - n_fft // 2]
    return sig if length is None else sig[..., :length]
