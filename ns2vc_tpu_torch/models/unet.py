"""Conditional 1D UNet denoiser (counterpart of ns2vc_tpu/models/unet.py).

    conv_in(k3) -> [CrossAttnDown x3, Down] -> CrossAttnMid
                -> [Up, CrossAttnUp x3] -> GN+SiLU+conv_out(k3)

Block channels (128, 256, 384, 512) by default, 2 resnets per block,
GroupNorm(8), 8 attention heads at every level (head_dim = C/8),
cross-attention to a 256-d prompt, FiLM time conditioning and a pooled-prompt
addition embedding. Layout (B, T, C).

Kernels: every attention goes through K1 (`ops/flash_attention.py`); both
GroupNorm(+FiLM) -> SiLU -> conv-k3 epilogues of all 22 resnet blocks, and
the output tail GN -> SiLU -> conv_out, go through K2
(`ops/fused_resnet.py`). Submodule names follow the flax parameter tree; the
one difference is self-attention's fused `to_qkv` (C -> 3C) weight, which
`convert.py` builds from flax's to_q/to_k/to_v kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ns2vc_tpu_torch.models.encoders import TextTimeEmbedding
from ns2vc_tpu_torch.models.layers import Conv1d, GroupNorm
from ns2vc_tpu_torch.ops.attention import multihead_attention
from ns2vc_tpu_torch.ops.fused_resnet import gn_silu_conv1d
from ns2vc_tpu_torch.ops.masking import mask_to_bias


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0,
                           max_period: int = 10000) -> torch.Tensor:
    """DDPM sinusoidal embedding in f32: (B,) (may be fractional) ->
    (B, embedding_dim)."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    return emb


class TimestepEmbedding(nn.Module):
    """linear -> SiLU -> linear."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class Attention(nn.Module):
    """No q/k/v bias, biased out projection. Self-attention (`cross_dim`
    None) runs one fused (C, 3C) projection; cross-attention keeps to_q and
    the to_k/to_v pair whose outputs `compute_kv` hoists out of the sampler
    loop (passed back as `kv=`)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.inner = heads, dim_head, inner
        if cross_dim is None:
            self.to_qkv = nn.Linear(query_dim, 3 * inner, bias=False)
        else:
            self.to_q = nn.Linear(query_dim, inner, bias=False)
            self.to_k = nn.Linear(cross_dim, inner, bias=False)
            self.to_v = nn.Linear(cross_dim, inner, bias=False)
        self.to_out_0 = nn.Linear(inner, query_dim)

    def compute_kv(self, context: torch.Tensor):
        return self.to_k(context), self.to_v(context)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                key_bias: torch.Tensor | None = None,
                kv: tuple | None = None) -> torch.Tensor:
        if hasattr(self, "to_qkv"):
            q, k, v = self.to_qkv(x).split(self.inner, dim=-1)
        else:
            q = self.to_q(x)
            k, v = self.compute_kv(context) if kv is None else kv
        out = multihead_attention(q, k, v, self.heads, key_bias=key_bias,
                                  scale=self.dim_head ** -0.5)
        return self.to_out_0(out)


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward, mult 4. The GELU is the exact erf form in f32 and
    the tanh form in bf16, as in the JAX package."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj = nn.Linear(dim, inner * 2)
        self.out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        approx = "tanh" if gate.dtype == torch.bfloat16 else "none"
        return self.out(h * F.gelu(gate, approximate=approx))


class BasicTransformerBlock(nn.Module):
    """pre-LN self-attn -> cross-attn -> GEGLU FF."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context, context_bias=None, kv=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context,
                           key_bias=context_bias, kv=kv)
        return x + self.ff(self.norm3(x))


class Transformer1D(nn.Module):
    """GN(eps 1e-6) -> proj in -> transformer block -> proj out + residual."""

    def __init__(self, channels: int, heads: int, cross_attention_dim: int,
                 norm_num_groups: int = 8):
        super().__init__()
        self.norm = GroupNorm(norm_num_groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.blocks_0 = BasicTransformerBlock(channels, heads,
                                              channels // heads,
                                              cross_attention_dim)
        self.proj_out = nn.Linear(channels, channels)

    def cross_kv(self, context: torch.Tensor):
        return self.blocks_0.attn2.compute_kv(context)

    def forward(self, x, context, context_bias=None, kv=None):
        h = self.proj_in(self.norm(x))
        h = self.blocks_0(h, context, context_bias, kv=kv)
        return self.proj_out(h) + x


class ResnetBlock1D(nn.Module):
    """GN -> SiLU -> conv(k3) -> GN -> FiLM(temb) -> SiLU -> conv(k3)
    + 1x1 shortcut. Both epilogues run as K2; norm1/conv1/norm2/conv2 hold
    the parameters in torch's GroupNorm / Conv1d layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv1d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, 2 * out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv1d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv1d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.time_emb_proj(F.silu(temb)).chunk(2, dim=-1)
        x = x.contiguous()
        h = gn_silu_conv1d(x, self.norm1.weight, self.norm1.bias,
                           self.conv1.weight, self.conv1.bias, self.groups,
                           self.eps)
        h = gn_silu_conv1d(h, self.norm2.weight, self.norm2.bias,
                           self.conv2.weight, self.conv2.bias, self.groups,
                           self.eps, film_scale=scale, film_shift=shift)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample1D(nn.Module):
    """conv k3 stride 2, padding (1, 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv1d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample1D(nn.Module):
    """nearest x2 then conv k3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv1d(channels, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=1))


class UNet1DConditionModel(nn.Module):
    """sample (B, T, in_channels) with T % 2^(levels-1) == 0, timesteps (B,),
    encoder_hidden_states (B, Tp, cross_attention_dim),
    encoder_attention_mask (B, Tp) bool (True = keep) -> (B, T, out)."""

    def __init__(self, in_channels: int = 356, out_channels: int = 100,
                 block_out_channels: tuple = (128, 256, 384, 512),
                 layers_per_block: int = 2, norm_num_groups: int = 8,
                 norm_eps: float = 1e-5, cross_attention_dim: int = 256,
                 num_attention_heads: int = 8, addition_embed_heads: int = 64,
                 freq_shift: float = 0.0, flip_sin_to_cos: bool = True):
        super().__init__()
        chans = tuple(block_out_channels)
        self.chans, self.layers_per_block = chans, layers_per_block
        self.groups, self.norm_eps = norm_num_groups, norm_eps
        self.freq_shift, self.flip_sin_to_cos = freq_shift, flip_sin_to_cos
        ted = chans[0] * 4
        n_levels = len(chans)

        def resnet(name, cin, cout):
            self.add_module(name, ResnetBlock1D(cin, cout, ted,
                                                norm_num_groups, norm_eps))

        def transformer(name, ch):
            self.add_module(name, Transformer1D(
                ch, num_attention_heads, cross_attention_dim,
                norm_num_groups))

        self.time_embedding = TimestepEmbedding(chans[0], ted)
        self.add_embedding = TextTimeEmbedding(cross_attention_dim, ted,
                                               addition_embed_heads)
        self.conv_in = Conv1d(in_channels, chans[0], 3)
        cur, skips = chans[0], [chans[0]]
        for i, ch in enumerate(chans):
            for j in range(layers_per_block):
                resnet(f"down_{i}_resnet_{j}", cur, ch)
                cur = ch
                if i < n_levels - 1:
                    transformer(f"down_{i}_attn_{j}", ch)
                skips.append(ch)
            if i < n_levels - 1:
                self.add_module(f"down_{i}_downsample", Downsample1D(ch))
                skips.append(ch)
        resnet("mid_resnet_0", chans[-1], chans[-1])
        transformer("mid_attn_0", chans[-1])
        resnet("mid_resnet_1", chans[-1], chans[-1])
        for i, ch in enumerate(reversed(chans)):
            for j in range(layers_per_block + 1):
                resnet(f"up_{i}_resnet_{j}", cur + skips.pop(), ch)
                cur = ch
                if i > 0:
                    transformer(f"up_{i}_attn_{j}", ch)
            if i < n_levels - 1:
                self.add_module(f"up_{i}_upsample", Upsample1D(ch))
        self.conv_norm_out = nn.GroupNorm(norm_num_groups, chans[0],
                                          eps=norm_eps)
        self.conv_out = nn.Conv1d(chans[0], out_channels, 3, padding=1)

    def cross_attn_layout(self) -> list[str]:
        """Names of the cross-attention transformers in forward order, shared
        by the forward pass and the K/V precompute."""
        n_levels = len(self.chans)
        out = [f"down_{i}_attn_{j}" for i in range(n_levels - 1)
               for j in range(self.layers_per_block)]
        out.append("mid_attn_0")
        out += [f"up_{i}_attn_{j}" for i in range(1, n_levels)
                for j in range(self.layers_per_block + 1)]
        return out

    def precompute(self, encoder_hidden_states: torch.Tensor):
        """Step-invariant conditioning: the pooled-prompt embedding and every
        cross-attention (k, v) pair, in `cross_attn_layout` order."""
        aug = self.add_embedding(encoder_hidden_states)
        kvs = tuple(getattr(self, name).cross_kv(encoder_hidden_states)
                    for name in self.cross_attn_layout())
        return aug, kvs

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                encoder_attention_mask: torch.Tensor | None = None,
                cross_kv: tuple | None = None,
                aug_emb: torch.Tensor | None = None) -> torch.Tensor:
        chans = self.chans
        n_levels = len(chans)
        if sample.shape[1] % (2 ** (n_levels - 1)):
            raise ValueError(f"T={sample.shape[1]} must be divisible by "
                             f"{2 ** (n_levels - 1)}")
        context_bias = (None if encoder_attention_mask is None
                        else mask_to_bias(encoder_attention_mask))
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = get_timestep_embedding(timesteps, chans[0],
                                       self.flip_sin_to_cos, self.freq_shift)
        emb = self.time_embedding(t_emb.to(sample.dtype))
        if aug_emb is None:
            aug_emb = self.add_embedding(encoder_hidden_states)
        emb = emb + aug_emb

        kv_iter = iter(cross_kv) if cross_kv is not None else None

        def attn(name, h):
            kv = next(kv_iter) if kv_iter is not None else None
            return getattr(self, name)(h, encoder_hidden_states, context_bias,
                                       kv=kv)

        h = self.conv_in(sample)
        skips = [h]
        for i in range(n_levels):
            for j in range(self.layers_per_block):
                h = getattr(self, f"down_{i}_resnet_{j}")(h, emb)
                if i < n_levels - 1:
                    h = attn(f"down_{i}_attn_{j}", h)
                skips.append(h)
            if i < n_levels - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)

        h = self.mid_resnet_0(h, emb)
        h = attn("mid_attn_0", h)
        h = self.mid_resnet_1(h, emb)

        for i in range(n_levels):
            for j in range(self.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = getattr(self, f"up_{i}_resnet_{j}")(h, emb)
                if i > 0:
                    h = attn(f"up_{i}_attn_{j}", h)
            if i < n_levels - 1:
                h = getattr(self, f"up_{i}_upsample")(h)

        return gn_silu_conv1d(h.contiguous(), self.conv_norm_out.weight,
                              self.conv_norm_out.bias, self.conv_out.weight,
                              self.conv_out.bias, self.groups, self.norm_eps)
