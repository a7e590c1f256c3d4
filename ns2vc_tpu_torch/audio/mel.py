"""The iSTFT pieces the Vocos head needs (counterpart of
ns2vc_tpu/audio/mel.py::hann_window and `_overlap_add`). The rest of that
module (STFT, log-mel, the feature front end) belongs to a later slice."""

from __future__ import annotations

import numpy as np
import torch


def hann_window(win_length: int) -> np.ndarray:
    """Periodic hann window (torch.hann_window default), float32."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
        np.float32)


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
