"""Sequence utilities (counterpart of ns2vc_tpu/ops/sequence.py).

The TTS-branch helpers (segment slicing, timing signals, the duration ->
alignment path, KL divergence, gumbel noise, the WaveNet gate) and the F0
conditioning helpers of the F0-predictor branch. (B, T, C) layout. Random
draws take an explicit `torch.Generator` in place of JAX's key; their values
are not JAX's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F0_BIN = 256
_F0_MEL_MIN = 1127.0 * np.log(1.0 + 50.0 / 700.0)
_F0_MEL_MAX = 1127.0 * np.log(1.0 + 1100.0 / 700.0)


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor,
                   segment_size: int = 4) -> torch.Tensor:
    """Gather fixed-size segments: x (B, T, C), ids_str (B,) start frames."""
    idx = ids_str[:, None] + torch.arange(segment_size, device=x.device)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


def rand_slice_segments(x: torch.Tensor,
                        generator: torch.Generator | None = None,
                        x_lengths: torch.Tensor | None = None,
                        segment_size: int = 4):
    """A random segment start per item, then the slice: (segments,
    ids_str)."""
    b, t, _ = x.shape
    lengths = x_lengths if x_lengths is not None else torch.full(
        (b,), t, device=x.device)
    max_start = torch.clamp(lengths - segment_size + 1, min=1)
    u = torch.rand((b,), generator=generator, device=x.device)
    ids_str = (u * max_start).to(torch.int64)
    return slice_segments(x, ids_str, segment_size), ids_str


def get_timing_signal_1d(length: int, channels: int,
                         min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4) -> torch.Tensor:
    """Tensor2Tensor sinusoidal timing signal, (1, length, channels) f32."""
    position = torch.arange(length, dtype=torch.float32)
    num_timescales = channels // 2
    log_timescale_increment = (math.log(max_timescale / min_timescale)
                               / max(num_timescales - 1, 1))
    inv_timescales = min_timescale * torch.exp(
        torch.arange(num_timescales, dtype=torch.float32)
        * -log_timescale_increment)
    scaled = position[:, None] * inv_timescales[None, :]
    signal = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
    signal = torch.nn.functional.pad(signal, (0, channels % 2))
    return signal[None]


def add_timing_signal_1d(x: torch.Tensor, min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4) -> torch.Tensor:
    """(B, T, C) + the timing signal."""
    _, t, c = x.shape
    return x + get_timing_signal_1d(t, c, min_timescale, max_timescale).to(
        x.device, x.dtype)


def cat_timing_signal_1d(x: torch.Tensor, min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4) -> torch.Tensor:
    """The timing signal concatenated on the channels: (B, T, 2C)."""
    b, t, c = x.shape
    sig = get_timing_signal_1d(t, c, min_timescale, max_timescale).to(
        x.device, x.dtype).expand(b, t, c)
    return torch.cat([x, sig], dim=-1)


def subsequent_mask(length: int) -> torch.Tensor:
    """Causal mask (1, 1, T, T), True = visible."""
    return torch.tril(torch.ones((length, length), dtype=torch.bool))[
        None, None]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Monotonic duration -> alignment path: duration (B, 1, T_text), mask
    (B, 1, T_mel, T_text) -> path (B, 1, T_mel, T_text), 1 where mel frame
    t belongs to text token s (cum[s-1] <= t < cum[s])."""
    t_y = mask.shape[2]
    cum = torch.cumsum(duration, dim=-1)
    frames = torch.arange(t_y, device=cum.device, dtype=cum.dtype)
    path = (frames[None, None, :, None] < cum[:, :, None, :]).to(mask.dtype)
    path = path - torch.nn.functional.pad(path, (1, 0))[..., :-1]
    return path * mask


def kl_divergence(m_p, logs_p, m_q, logs_q):
    """KL(P || Q) for diagonal gaussians."""
    kl = (logs_q - logs_p) - 0.5
    kl = kl + 0.5 * (torch.exp(2.0 * logs_p) + (m_p - m_q) ** 2) \
        * torch.exp(-2.0 * logs_q)
    return kl


def rand_gumbel(shape, generator: torch.Generator | None = None,
                device=None) -> torch.Tensor:
    """Gumbel noise from a uniform clipped to [1e-5, 0.99999]."""
    u = torch.rand(shape, generator=generator, device=device) * 0.99998 \
        + 0.00001
    return -torch.log(-torch.log(u))


def fused_add_tanh_sigmoid_multiply(a: torch.Tensor, b: torch.Tensor,
                                    n_channels: int) -> torch.Tensor:
    """WaveNet gate on channels-last halves: tanh(x[:n]) * sigmoid(x[n:])
    of x = a + b."""
    x = a + b
    return torch.tanh(x[..., :n_channels]) * torch.sigmoid(
        x[..., n_channels:])


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """256-bin mel-scale F0 quantisation, int64. Computed in f0's own dtype
    as the JAX package does (its scalars are weak), rounded half to even
    like `jnp.rint` (`torch.round`)."""
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = ((f0_mel - float(_F0_MEL_MIN)) * (F0_BIN - 2)
              / float(_F0_MEL_MAX - _F0_MEL_MIN) + 1.0)
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    return torch.round(torch.clamp(f0_mel, 1.0, F0_BIN - 1)).to(torch.int64)


def normalize_f0(f0: torch.Tensor, uv: torch.Tensor,
                 factor: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Masked mean-centring of f0 (B, T, 1) over the voiced frames of uv
    (B, T), times a per-item scale: `factor` (B,) when given, else drawn
    uniform in [0.8, 1.2) from `generator` when given, else 1. The centring
    runs in f0's dtype and the product in f32 (f64 for f64 inputs), as the
    JAX package multiplies by an f32 factor (or an f32 1) whatever f0's
    dtype: a bf16 f0 gives an f32 result."""
    uv_sum = uv.sum(dim=1, keepdim=True)
    uv_sum = torch.where(uv_sum == 0, torch.full_like(uv_sum, 9999.0), uv_sum)
    means = (f0[..., 0] * uv).sum(dim=1, keepdim=True) / uv_sum
    if factor is None and generator is not None:
        factor = 0.8 + 0.4 * torch.rand((f0.shape[0],), generator=generator,
                                        device=f0.device)
    acc = torch.promote_types(f0.dtype, torch.float32)
    centred = (f0 - means[..., None]).to(acc)
    if factor is None:
        return centred
    return centred * factor.to(acc).reshape(-1, 1, 1)
