"""Conditioning encoders (counterpart of ns2vc_tpu/models/encoders.py):
content (PhoneEncoder), reference-mel (PromptEncoder), attention pooling and
TextTimeEmbedding, and the F0 predictor with its weight-normed conv layers
and cross-attention.

Submodule names follow the flax parameter tree, including flax's automatic
names (`LayerNorm_0`, `Conv_0`, `layers_{i}`), so `convert.py` maps a JAX
checkpoint by path.

Dropout sits where flax applies it (after the ConvFFN ReLU, on both
EncSALayer residual branches, after each WNConvResidual's ReLU), is active
only under `module.train()`, scales the kept values by 1/(1-p) as flax does,
and draws its mask from the `generator` passed down the forward: in training
mode with p > 0 and no generator it raises rather than use the global RNG.
The masks are not JAX's: the generators differ.

The F0 predictor's layers take flax's dtype promotion: a layer whose dtype
is unset computes in the common type of its input and its parameters, so
under a bf16 model the predictor's trunk, fed the f32 normalised F0, runs
in f32 (`LayerNorm`, `Linear` and `LNConv` here promote; the other modules'
inputs and parameters share one dtype, where promotion changes nothing).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ns2vc_tpu_torch.models.layers import Conv1d
from ns2vc_tpu_torch.ops.attention import multihead_attention
from ns2vc_tpu_torch.ops.masking import apply_mask, mask_to_bias

LN_EPS = 1e-5  # torch nn.LayerNorm default, as the JAX package sets it


def _promoted(x: torch.Tensor, *params: torch.Tensor | None):
    """x and the parameters cast to their common type (flax's promotion
    of a layer whose dtype is unset); None stays None."""
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return [None if t is None else t.to(dt) for t in (x, *params)]


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm in the common type of its input and parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _promoted(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


class Linear(nn.Linear):
    """nn.Linear in the common type of its input and parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*_promoted(x, self.weight, self.bias))


class Dropout(nn.Dropout):
    """flax's inverted dropout (keep with probability 1-p, kept values
    x / (1-p)) with the mask drawn from an explicit generator."""

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout in training mode needs a generator")
        keep = torch.empty(x.shape, device=x.device).bernoulli_(
            1.0 - self.p, generator=generator)
        return torch.where(keep.bool(), x / (1.0 - self.p), 0.0).to(x.dtype)


class LNConv(nn.Module):
    """LayerNorm then conv, in the common type of the input and the
    parameters; padded frames are zeroed before the norm. `init_std` is the
    encoders' conv init N(0, sqrt(4(1-p)/(k c_in)))."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, dropout: float = 0.0):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(in_channels, eps=LN_EPS)
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
        bias = None if key_mask is None else \
            mask_to_bias(key_mask)[:, None, None, :]
        out = multihead_attention(q, k, v, self.num_heads, bias=bias)
        return self.out_proj(out)


class ConvFFN(nn.Module):
    """conv(C -> 4C, k) * k^-0.5 -> relu -> dropout -> dense. `padding`
    "SAME" or "LEFT" (causal: k-1 zeros before the first frame).

    `step` is the streaming form of the LEFT-padded layer: one frame
    against an explicit (B, k-1, C) buffer of the previous inputs (zeros at
    the start, which is the causal pad), frame for frame the full
    sequence's output."""

    def __init__(self, channels: int, kernel_size: int = 9,
                 dropout: float = 0.0, padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "LEFT"):
            raise ValueError(f"padding must be 'SAME' or 'LEFT', got "
                             f"{padding!r}")
        self.channels, self.kernel_size = channels, kernel_size
        self.causal = padding == "LEFT"
        self.ffn_1 = Conv1d(channels, 4 * channels, kernel_size,
                            padding=0 if self.causal else None)
        self.ffn_2 = nn.Linear(4 * channels, channels)
        self.dropout = Dropout(dropout)

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        if self.kernel_size > 1:
            h = h * self.kernel_size ** -0.5
        return torch.relu(h)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.causal:
            x = F.pad(x, (0, 0, self.kernel_size - 1, 0))
        h = self._head(self.ffn_1(x))
        return self.ffn_2(self.dropout(h, generator))

    def init_buffer(self, batch: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
        """(B, k-1, C) zeros: the causal pad the first steps see."""
        return torch.zeros((batch, self.kernel_size - 1, self.channels),
                           dtype=dtype, device=device)

    def step(self, x_new: torch.Tensor, buffer: torch.Tensor):
        """x_new (B, 1, C), buffer (B, k-1, C) -> (y (B, 1, C), the next
        buffer). Inference only: no dropout."""
        window = torch.cat([buffer, x_new], dim=1)
        h = F.conv1d(window.transpose(1, 2), self.ffn_1.weight,
                     self.ffn_1.bias).transpose(1, 2)
        return self.ffn_2(self._head(h)), window[:, 1:]


class EncSALayer(nn.Module):
    """Pre-LN self-attention + conv-FFN block, masked after each residual."""

    def __init__(self, channels: int, num_heads: int = 8,
                 ffn_kernel: int = 9, dropout: float = 0.0):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(channels, eps=LN_EPS)
        self.self_attn = MultiheadSelfAttention(channels, num_heads)
        self.layer_norm2 = nn.LayerNorm(channels, eps=LN_EPS)
        self.ffn = ConvFFN(channels, ffn_kernel, dropout)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.self_attn(self.layer_norm1(x), key_mask=mask)
        x = apply_mask(x + self.dropout(h, generator), mask)
        h = self.ffn(self.layer_norm2(x), generator)
        return apply_mask(x + self.dropout(h, generator), mask)


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
                                                      ffn_kernel, p_dropout))
        self.out_proj = LNConv(hidden_channels, out_channels, 1, p_dropout)
        self.layer_norm = (nn.LayerNorm(out_channels, eps=LN_EPS)
                           if last_ln else None)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = apply_mask(self.pre(x, mask), mask)
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x, mask, generator)
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

    def forward(self, x: torch.Tensor, mask: torch.Tensor, g: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.stack(x + self.spk_proj(g)[:, None, :], mask, generator)


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

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.stack(x, mask, generator)


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


class WNConvResidual(nn.Module):
    """mask -> LN -> weight-normed conv (SAME) -> ReLU -> dropout, plus the
    residual. The weight is computed in the forward from `conv_v` (Cout,
    Cin, K) and `conv_g` (Cout,), normed per output channel over (Cin, K),
    so training differentiates through the norm as JAX does."""

    def __init__(self, channels: int, kernel_size: int = 5,
                 dropout: float = 0.5):
        super().__init__()
        self.kernel_size = kernel_size
        self.layer_norm = LayerNorm(channels, eps=LN_EPS)
        self.conv_v = nn.Parameter(torch.zeros(channels, channels,
                                               kernel_size))
        self.conv_g = nn.Parameter(torch.ones(channels))
        self.conv_b = nn.Parameter(torch.zeros(channels))
        self.dropout = Dropout(dropout)
        self.init_std = math.sqrt(4 * (1.0 - dropout)
                                  / (kernel_size * channels))

    def weight(self) -> torch.Tensor:
        v = self.conv_v
        norm = torch.linalg.vector_norm(v.flatten(1), dim=1)
        return v * (self.conv_g / norm)[:, None, None]

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.layer_norm(apply_mask(x, mask))
        h = F.conv1d(h.transpose(1, 2), self.weight().to(h.dtype),
                     self.conv_b.to(h.dtype),
                     padding=(self.kernel_size - 1) // 2).transpose(1, 2)
        return self.dropout(torch.relu(h), generator) + x


class CrossAttention(nn.Module):
    """Multi-head cross-attention without biases; the memory's padding is
    a key-padding bias, so on a card the attention is K1. Each projection
    promotes: an f32 x with a bf16 memory and parameters gives an f32 q and
    bf16 k, v, and the attention's output and `out_proj` are bf16. The
    memory has `mem_channels` (default `channels`), projected to
    `channels` as flax's Dense infers its input width."""

    def __init__(self, channels: int, num_heads: int,
                 mem_channels: int | None = None):
        super().__init__()
        self.num_heads = num_heads
        mem_channels = mem_channels or channels
        self.q_proj = Linear(channels, channels, bias=False)
        self.k_proj = Linear(mem_channels, channels, bias=False)
        self.v_proj = Linear(mem_channels, channels, bias=False)
        self.out_proj = Linear(channels, channels, bias=False)

    def forward(self, x: torch.Tensor, mem: torch.Tensor,
                mem_mask: torch.Tensor | None = None) -> torch.Tensor:
        bias = None if mem_mask is None else \
            mask_to_bias(mem_mask)[:, None, None, :]
        out = multihead_attention(self.q_proj(x), self.k_proj(mem),
                                  self.v_proj(mem), self.num_heads, bias=bias)
        return self.out_proj(out)


class F0Predictor(nn.Module):
    """Prompt-conditioned F0 predictor: content (B, T, C) and prompt (B, Tp,
    C), both detached, C = `in_channels`, and the normalised log-F0
    (B, T, 1) -> (B, T, out).
    `attention_layers` x [3 WNConvResidual -> LN -> + cross-attention into
    the prompt].

    Two behaviours are the JAX package's on purpose. `f0_prenet` is an
    LNConv over one channel: its LayerNorm outputs its bias whatever the
    contour, so the prediction depends on content, prompt and masks only.
    And the predictor's dtypes follow flax's promotion: under a bf16 model,
    `pre` runs in bf16 on the bf16 content, `f0_prenet` takes the f32
    `norm_f0` (f32 whatever f0's dtype, see `ops/sequence.py::
    normalize_f0`) with its parameters upcast, and from there the trunk is
    f32: the weight-normed convs, the LayerNorms, `q_proj`, `proj` and the
    output. `k_proj`/`v_proj` of the bf16 prompt stay bf16, the attention
    takes q in f32 with k, v in bf16 and returns bf16 (on a card K1's f32
    route over the exactly upcast k, v, without the plain version's bf16
    rounding of the probabilities), and `out_proj` runs in bf16 before its
    output joins the f32 trunk."""

    def __init__(self, in_channels: int = 256, hidden_channels: int = 256,
                 out_channels: int = 1, attention_layers: int = 10,
                 n_heads: int = 8, p_dropout: float = 0.5):
        super().__init__()
        self.attention_layers = attention_layers
        self.pre = LNConv(in_channels, hidden_channels, 5, p_dropout)
        self.f0_prenet = LNConv(1, hidden_channels, 3, p_dropout)
        for i in range(attention_layers):
            for j in range(3):
                self.add_module(f"conv_{i}_{j}", WNConvResidual(
                    hidden_channels, 5, p_dropout))
            self.add_module(f"norm_{i}", LayerNorm(hidden_channels,
                                                   eps=LN_EPS))
            self.add_module(f"attn_{i}", CrossAttention(
                hidden_channels, n_heads, in_channels))
        self.proj = LNConv(hidden_channels, out_channels, 5, p_dropout)

    def forward(self, x: torch.Tensor, prompt: torch.Tensor,
                norm_f0: torch.Tensor, x_mask: torch.Tensor,
                prompt_mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x, prompt = x.detach(), prompt.detach()
        x = self.pre(x, x_mask)
        x = apply_mask(x + self.f0_prenet(norm_f0, x_mask), x_mask)
        prompt = apply_mask(prompt, prompt_mask)
        for i in range(self.attention_layers):
            for j in range(3):
                x = getattr(self, f"conv_{i}_{j}")(x, x_mask, generator)
            x = getattr(self, f"norm_{i}")(x)
            x = x + getattr(self, f"attn_{i}")(x, prompt, prompt_mask)
        x = self.proj(apply_mask(x, x_mask), x_mask)
        return apply_mask(x, x_mask)
