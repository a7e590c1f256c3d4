"""Conditioning encoders (counterpart of ns2vc_tpu/models/encoders.py, the
serving-path subset): content (PhoneEncoder), reference-mel (PromptEncoder),
attention pooling and TextTimeEmbedding.

Submodule names follow the flax parameter tree, including flax's automatic
names (`LayerNorm_0`, `Conv_0`, `layers_{i}`), so `convert.py` maps a JAX
checkpoint by path. Inference only: dropout is the identity.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ns2vc_tpu_torch.models.layers import Conv1d
from ns2vc_tpu_torch.ops.attention import multihead_attention
from ns2vc_tpu_torch.ops.masking import apply_mask, mask_to_bias

LN_EPS = 1e-5  # torch nn.LayerNorm default, as the JAX package sets it


class LNConv(nn.Module):
    """LayerNorm then conv; padded frames are zeroed before the norm.
    `init_std` is the encoders' conv init N(0, sqrt(4(1-p)/(k c_in)))."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, dropout: float = 0.0):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(in_channels, eps=LN_EPS)
        self.Conv_0 = Conv1d(in_channels, out_channels, kernel_size)
        self.init_std = math.sqrt(4 * (1.0 - dropout)
                                  / (kernel_size * in_channels))

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        if mask is not None:
            x = apply_mask(x, mask)
        return self.Conv_0(self.LayerNorm_0(x))


class MultiheadSelfAttention(nn.Module):
    """Packed-projection self-attention, no biases."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.channels, self.num_heads = channels, num_heads
        self.in_proj = nn.Linear(channels, 3 * channels, bias=False)
        self.out_proj = nn.Linear(channels, channels, bias=False)

    def forward(self, x: torch.Tensor,
                key_mask: torch.Tensor | None = None) -> torch.Tensor:
        q, k, v = self.in_proj(x).split(self.channels, dim=-1)
        bias = None if key_mask is None else mask_to_bias(key_mask)
        out = multihead_attention(q, k, v, self.num_heads, key_bias=bias)
        return self.out_proj(out)


class ConvFFN(nn.Module):
    """conv(C -> 4C, k, SAME) * k^-0.5 -> relu -> dense."""

    def __init__(self, channels: int, kernel_size: int = 9):
        super().__init__()
        self.kernel_size = kernel_size
        self.ffn_1 = Conv1d(channels, 4 * channels, kernel_size)
        self.ffn_2 = nn.Linear(4 * channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ffn_1(x)
        if self.kernel_size > 1:
            h = h * self.kernel_size ** -0.5
        return self.ffn_2(torch.relu(h))


class EncSALayer(nn.Module):
    """Pre-LN self-attention + conv-FFN block, masked after each residual."""

    def __init__(self, channels: int, num_heads: int = 8,
                 ffn_kernel: int = 9):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(channels, eps=LN_EPS)
        self.self_attn = MultiheadSelfAttention(channels, num_heads)
        self.layer_norm2 = nn.LayerNorm(channels, eps=LN_EPS)
        self.ffn = ConvFFN(channels, ffn_kernel)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.self_attn(self.layer_norm1(x), key_mask=mask)
        x = apply_mask(x + h, mask)
        h = self.ffn(self.layer_norm2(x))
        return apply_mask(x + h, mask)


class _EncoderStack(nn.Module):
    """pre LNConv -> n x EncSALayer -> out LNConv -> final LN."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, n_layers: int, p_dropout: float,
                 n_heads: int = 8, ffn_kernel: int = 9, last_ln: bool = True):
        super().__init__()
        self.n_layers = n_layers
        self.pre = LNConv(in_channels, hidden_channels, 1, p_dropout)
        for i in range(n_layers):
            self.add_module(f"layers_{i}", EncSALayer(hidden_channels, n_heads,
                                                      ffn_kernel))
        self.out_proj = LNConv(hidden_channels, out_channels, 1, p_dropout)
        self.layer_norm = (nn.LayerNorm(out_channels, eps=LN_EPS)
                           if last_ln else None)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = apply_mask(self.pre(x, mask), mask)
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x, mask)
        x = self.out_proj(x, mask)
        if self.layer_norm is not None:
            x = apply_mask(self.layer_norm(x), mask)
        return x


class PhoneEncoder(nn.Module):
    """Content encoder over contentvec features plus the pooled speaker
    embedding g (B, g_channels). x (B, T, in_channels)."""

    def __init__(self, in_channels: int = 256, hidden_channels: int = 256,
                 out_channels: int = 256, n_layers: int = 6,
                 p_dropout: float = 0.2, n_heads: int = 8,
                 ffn_kernel: int = 9, last_ln: bool = True,
                 g_channels: int = 100):
        super().__init__()
        self.spk_proj = nn.Linear(g_channels, hidden_channels)
        self.stack = _EncoderStack(in_channels, hidden_channels, out_channels,
                                   n_layers, p_dropout, n_heads, ffn_kernel,
                                   last_ln)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
        return self.stack(x + self.spk_proj(g)[:, None, :], mask)


class PromptEncoder(nn.Module):
    """Reference-mel encoder. x (B, Tp, in_channels)."""

    def __init__(self, in_channels: int = 100, hidden_channels: int = 256,
                 out_channels: int = 256, n_layers: int = 6,
                 p_dropout: float = 0.2, n_heads: int = 8,
                 ffn_kernel: int = 9, last_ln: bool = True):
        super().__init__()
        self.stack = _EncoderStack(in_channels, hidden_channels, out_channels,
                                   n_layers, p_dropout, n_heads, ffn_kernel,
                                   last_ln)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.stack(x, mask)


class AttentionPooling(nn.Module):
    """Mean-token attention pooling, x (B, T, C) -> (B, C): one query (the
    mean token) over T+1 keys."""

    def __init__(self, num_heads: int, embed_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.zeros(1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cls = x.mean(dim=1, keepdim=True) + self.positional_embedding.to(
            x.dtype)
        xc = torch.cat([cls, x], dim=1)
        out = multihead_attention(self.q_proj(cls), self.k_proj(xc),
                                  self.v_proj(xc), self.num_heads)
        return out[:, 0, :]


class TextTimeEmbedding(nn.Module):
    """LN -> attention pool -> proj -> LN: the speaker reference pooler
    (`ref_enc`) and the UNet's pooled-prompt `add_embedding`."""

    def __init__(self, encoder_dim: int, time_embed_dim: int,
                 num_heads: int = 64):
        super().__init__()
        self.norm1 = nn.LayerNorm(encoder_dim, eps=LN_EPS)
        self.pool = AttentionPooling(num_heads, encoder_dim)
        self.proj = nn.Linear(encoder_dim, time_embed_dim)
        self.norm2 = nn.LayerNorm(time_embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm2(self.proj(self.pool(self.norm1(x))))
