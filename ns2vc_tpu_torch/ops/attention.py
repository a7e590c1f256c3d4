"""Multi-head attention core (counterpart of ns2vc_tpu/ops/attention.py).

`multihead_attention` is the projected attention used by the encoder layers,
the attention pooling and the UNet attention blocks. Every call goes through
`ops/flash_attention.py::flash_attention`: a CUDA kernel (chosen by dtype)
for a CUDA tensor, its plain version for a CPU tensor. The JAX package's
XLA fusion experiments and their environment knobs are not carried over.
"""

from __future__ import annotations

import torch

from ns2vc_tpu_torch.ops.flash_attention import flash_attention


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, C) -> (B, H, T, C/H), a strided view where x allows one."""
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, key_bias: torch.Tensor | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Projected multi-head attention on (B, T, C) tensors. `key_bias` is the
    (B, Tk) additive key-padding bias (the JAX core's (B, 1, 1, Tk) bias
    without its broadcast axes)."""
    out = flash_attention(split_heads(q, num_heads), split_heads(k, num_heads),
                          split_heads(v, num_heads), bias=key_bias,
                          scale=scale)
    return merge_heads(out)
