"""Encoder-layer operation registry (counterpart of
ns2vc_tpu/models/op_registry.py): the 15 numbered layer constructors of the
reference's OPERATIONS_ENCODER, each (channels, dropout) -> a layer taking
(x (B, T, C), mask (B, T) bool, generator=None) -> (B, T, C).

Attention routes (`ops/attention.py`): the self-attention layers (ids 8-10,
14, 15) have a key-padding bias and go to K1 on a card (ids 14 and 15 at
C = 256 have D = 128, which bf16 runs on K1's CUDA-core kernel); the local
layer's banded bias (id 11) and the Gaussian layer's one head of D = C
(id 13) take the plain route. The BiLSTM (id 12) is `torch.nn.LSTM`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ns2vc_tpu_torch.models.encoders import (
    LN_EPS, ConvFFN, Dropout, EncSALayer, WNConvResidual,
)
from ns2vc_tpu_torch.ops.attention import multihead_attention
from ns2vc_tpu_torch.ops.masking import apply_mask, mask_to_bias


class EncLocalSALayer(nn.Module):
    """Chunked local self-attention + conv FFN: queries in block b (width
    chunk_size // 2 + 1) attend the keys in [s - chunk_size // 2, s +
    chunk_size), as one attention with a banded bias. The attention output
    is zeroed on padded rows (the reference's `1 - q_nonpadding` zeroes the
    valid ones, a sign slip the JAX package corrects too)."""

    def __init__(self, channels: int, num_heads: int = 2,
                 chunk_size: int = 101, dropout: float = 0.2):
        super().__init__()
        self.channels, self.num_heads = channels, num_heads
        self.chunk_size = chunk_size
        self.layer_norm1 = nn.LayerNorm(channels, eps=LN_EPS)
        self.in_proj = nn.Linear(channels, 3 * channels, bias=False)
        self.out_proj = nn.Linear(channels, channels, bias=False)
        self.layer_norm2 = nn.LayerNorm(channels, eps=LN_EPS)
        self.ffn = ConvFFN(channels, 9, dropout)
        self.dropout = Dropout(dropout)

    def band_bias(self, t: int, device) -> torch.Tensor:
        """(1, 1, T, T): 0 inside each query block's key band, -1e9 out."""
        half = self.chunk_size // 2
        pos = np.arange(t)
        start = (pos // (half + 1)) * (half + 1)
        allowed = ((pos[None, :] >= start[:, None] - half)
                   & (pos[None, :] < start[:, None] + self.chunk_size))
        return torch.as_tensor(np.where(allowed, 0.0, -1e9)[None, None],
                               dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q, k, v = self.in_proj(self.layer_norm1(x)).split(self.channels,
                                                          dim=-1)
        bias = self.band_bias(x.shape[1], x.device) \
            + mask_to_bias(mask)[:, None, None, :]
        out = apply_mask(self.out_proj(multihead_attention(
            q, k, v, self.num_heads, bias=bias)), mask)
        x = x + self.dropout(out, generator)
        h = self.ffn(self.layer_norm2(x), generator)
        return x + self.dropout(h, generator)


class EncLSTMLayer(nn.Module):
    """LN -> BiLSTM over every frame (no mask, as JAX) -> Linear(2C -> C)
    -> dropout -> residual. `convert.py` maps flax's two
    OptimizedLSTMCells (forward, reverse) onto `lstm`."""

    def __init__(self, channels: int, dropout: float = 0.2):
        super().__init__()
        self.layer_norm = nn.LayerNorm(channels, eps=LN_EPS)
        self.lstm = nn.LSTM(channels, channels, batch_first=True,
                            bidirectional=True)
        self.out_proj = nn.Linear(2 * channels, channels)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        self.lstm.flatten_parameters()   # cuDNN's one weight buffer
        h, _ = self.lstm(self.layer_norm(x))
        return x + self.dropout(self.out_proj(h), generator)


class EncGausSALayer(nn.Module):
    """Self-attention with biased projections and, with `gaus_bias`, a
    learnable per-head Gaussian distance bias -(i-j)^2 / 2 * tao_h^-4,
    then a conv FFN."""

    def __init__(self, channels: int, num_heads: int = 1,
                 dropout: float = 0.2, gaus_bias: bool = False,
                 gaus_tao: float = 10.0):
        super().__init__()
        self.num_heads = num_heads
        self.layer_norm1 = nn.LayerNorm(channels, eps=LN_EPS)
        self.w_q = nn.Linear(channels, channels)
        self.w_k = nn.Linear(channels, channels)
        self.w_v = nn.Linear(channels, channels)
        self.fc = nn.Linear(channels, channels)
        self.tao = (nn.Parameter(torch.full((num_heads,), float(gaus_tao)))
                    if gaus_bias else None)
        self.layer_norm2 = nn.LayerNorm(channels, eps=LN_EPS)
        self.ffn = ConvFFN(channels, 9, dropout)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        t = x.shape[1]
        h = self.layer_norm1(x)
        bias = mask_to_bias(mask)[:, None, None, :]
        if self.tao is not None:
            pos = torch.arange(t, device=x.device, dtype=torch.float32)
            dist = -(pos[:, None] - pos[None, :]).abs() ** 2 / 2.0
            bias = bias + dist[None, None] * (
                self.tao.float() ** -4)[None, :, None, None]
        out = multihead_attention(self.w_q(h), self.w_k(h), self.w_v(h),
                                  self.num_heads, bias=bias)
        x = x + self.dropout(self.fc(out), generator)
        h = self.ffn(self.layer_norm2(x), generator)
        return x + self.dropout(h, generator)


# id -> constructor(channels, dropout), the reference's numbering
OPERATIONS_ENCODER = {
    1: lambda c, p: WNConvResidual(c, 1, p),
    2: lambda c, p: WNConvResidual(c, 5, p),
    3: lambda c, p: WNConvResidual(c, 9, p),
    4: lambda c, p: WNConvResidual(c, 13, p),
    5: lambda c, p: WNConvResidual(c, 17, p),
    6: lambda c, p: WNConvResidual(c, 21, p),
    7: lambda c, p: WNConvResidual(c, 25, p),
    8: lambda c, p: EncSALayer(c, 8, ffn_kernel=9, dropout=p),
    9: lambda c, p: EncSALayer(c, 4, ffn_kernel=9, dropout=p),
    10: lambda c, p: EncSALayer(c, 8, ffn_kernel=9, dropout=p),
    11: lambda c, p: EncLocalSALayer(c, 2, dropout=p),
    12: lambda c, p: EncLSTMLayer(c, p),
    13: lambda c, p, g_bias=False, tao=10.0: EncGausSALayer(
        c, 1, p, gaus_bias=g_bias, gaus_tao=tao),
    14: lambda c, p: EncSALayer(c, 2, ffn_kernel=1, dropout=p),
    15: lambda c, p: EncSALayer(c, 2, ffn_kernel=15, dropout=p),
}
