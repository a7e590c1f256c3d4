"""Sequence masking utilities (counterpart of ns2vc_tpu/ops/masking.py).

(B, T, C) layout with boolean validity masks (True = valid frame); the
attention bias follows the -1e4 drop convention."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) bool, True where t < length."""
    pos = torch.arange(max_length, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """bool keep-mask -> f32 additive attention bias (0 keep, -1e4 drop)."""
    return (1.0 - mask.float()) * -10000.0


def apply_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero padded frames: x (B, T, C) * mask (B, T)."""
    return x * mask.to(x.dtype)[..., None]
