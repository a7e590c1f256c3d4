"""ContentVec (HuBERT-base) content encoder (counterpart of
ns2vc_tpu/features/contentvec.py).

    wav 16 kHz (B, N)
      -> 7 conv feature extractor (512 ch, strides 5,2,2,2,2,2,2 = 320x;
         GroupNorm(512) on the first conv only; exact GELU; no bias)
      -> LayerNorm -> Linear 512 -> 768
      -> + positional conv (k 128, groups 16, SamePad trim, GELU) -> LayerNorm
      -> 12 post-LN transformer layers (768, 12 heads, FFN 3072, exact GELU)
      -> final_proj 768 -> 256                           (B, T50, 256)

Submodule names follow the flax parameter tree, so `convert.from_flax`
maps a JAX tree by path. The self-attention goes through
`ops.attention.multihead_attention`: kernel K1 on a CUDA tensor, at head
width 64 in f32.

`contentvec_from_fairseq` reads a fairseq contentvec state dict
(`checkpoint_best_legacy_500.pt`) into this module's layout, mirroring the
JAX package's `convert_fairseq_hubert`: the weight norm of `pos_conv`
(dim=2) is folded, and a key neither read nor training-only raises.
`contentvec_to_fairseq` writes the same layout from one key table.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
from torch import nn

from ns2vc_tpu_torch.ops.attention import multihead_attention
from ns2vc_tpu_torch.ops.masking import mask_to_bias

CONV_LAYERS = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2


def content_frames(num_samples):
    """Output frame count of the conv extractor for a 16 kHz sample count
    (an int, or a tensor of lengths)."""
    t = num_samples
    for _, k, s in CONV_LAYERS:
        t = (t - k) // s + 1
    return t


class ConvFeatureExtractor(nn.Module):
    """fairseq ConvFeatureExtractionModel, mode 'default', no conv bias."""

    def __init__(self):
        super().__init__()
        cin = 1
        for i, (dim, k, s) in enumerate(CONV_LAYERS):
            self.add_module(f"conv_{i}", nn.Conv1d(cin, dim, k, stride=s,
                                                   bias=False))
            cin = dim
        self.group_norm = nn.GroupNorm(CONV_LAYERS[0][0], CONV_LAYERS[0][0],
                                       eps=1e-5)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, N) -> (B, T, 512)."""
        h = wav[:, None, :]
        for i in range(len(CONV_LAYERS)):
            h = getattr(self, f"conv_{i}")(h)
            if i == 0:
                h = self.group_norm(h)
            h = F.gelu(h)
        return h.transpose(1, 2)


class PositionalConv(nn.Conv1d):
    """Grouped conv positional encoding with fairseq SamePad (an even kernel
    drops its last output step), then exact GELU; the weight norm is folded
    into the plain weight by the loaders."""

    def __init__(self, dim: int = 768, kernel: int = 128, groups: int = 16):
        super().__init__(dim, dim, kernel, padding=kernel // 2, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = super().forward(x.transpose(1, 2))
        if self.kernel_size[0] % 2 == 0:
            h = h[..., :-1]
        return F.gelu(h).transpose(1, 2)


class TransformerLayer(nn.Module):
    """fairseq post-LN encoder layer: x + attn -> LN -> x + FFN -> LN."""

    def __init__(self, dim: int = 768, heads: int = 12, ffn_dim: int = 3072):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.self_attn_layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, dim)
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor,
                key_bias: torch.Tensor | None = None) -> torch.Tensor:
        attn = multihead_attention(self.q_proj(x), self.k_proj(x),
                                   self.v_proj(x), self.heads,
                                   bias=key_bias)
        x = self.self_attn_layer_norm(x + self.out_proj(attn))
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.final_layer_norm(x + h)


class ContentVec(nn.Module):
    """wav 16 kHz (B, N) -> (B, T50, final_dim) content features (the
    `output_layer` tap + final_proj)."""

    def __init__(self, dim: int = 768, heads: int = 12, ffn_dim: int = 3072,
                 num_layers: int = 12, output_layer: int = 12,
                 final_dim: int = 256):
        super().__init__()
        self.heads, self.output_layer = heads, output_layer
        self.feature_extractor = ConvFeatureExtractor()
        self.layer_norm = nn.LayerNorm(CONV_LAYERS[-1][0], eps=1e-5)
        self.post_extract_proj = nn.Linear(CONV_LAYERS[-1][0], dim)
        self.pos_conv = PositionalConv(dim)
        self.encoder_layer_norm = nn.LayerNorm(dim, eps=1e-5)
        for i in range(output_layer):
            self.add_module(f"layers_{i}",
                            TransformerLayer(dim, heads, ffn_dim))
        self.final_proj = nn.Linear(dim, final_dim)
        self.num_layers = num_layers

    def forward(self, wav: torch.Tensor,
                lengths: torch.Tensor | None = None) -> torch.Tensor:
        x = self.post_extract_proj(self.layer_norm(
            self.feature_extractor(wav)))
        key_bias = None
        if lengths is not None:
            pos = torch.arange(x.shape[1], device=x.device)
            mask = pos[None, :] < content_frames(lengths)[:, None]
            key_bias = mask_to_bias(mask)[:, None, None, :]
            x = x * mask[..., None].to(x.dtype)
        x = self.encoder_layer_norm(x + self.pos_conv(x))
        for i in range(self.output_layer):
            x = getattr(self, f"layers_{i}")(x, key_bias)
        return self.final_proj(x)


# -- fairseq checkpoints ------------------------------------------------------

def _fairseq_names(n_layers: int) -> list[tuple[str, str]]:
    """(fairseq key, port key) of every tensor the two layouts share as is;
    only pos_conv's weight norm is not among them."""
    names = [(f"feature_extractor.conv_layers.{i}.0.weight",
              f"feature_extractor.conv_{i}.weight")
             for i in range(len(CONV_LAYERS))]
    names.append(("encoder.pos_conv.0.bias", "pos_conv.bias"))
    for p in ("weight", "bias"):
        names += [(f"feature_extractor.conv_layers.0.2.{p}",
                   f"feature_extractor.group_norm.{p}"),
                  (f"layer_norm.{p}", f"layer_norm.{p}"),
                  (f"post_extract_proj.{p}", f"post_extract_proj.{p}"),
                  (f"encoder.layer_norm.{p}", f"encoder_layer_norm.{p}"),
                  (f"final_proj.{p}", f"final_proj.{p}")]
        for i in range(n_layers):
            for m in ("self_attn.q_proj", "self_attn.k_proj",
                      "self_attn.v_proj", "self_attn.out_proj",
                      "self_attn_layer_norm", "fc1", "fc2",
                      "final_layer_norm"):
                names.append((f"encoder.layers.{i}.{m}.{p}",
                              f"layers_{i}.{m.removeprefix('self_attn.')}"
                              f".{p}"))
    return names


def contentvec_from_fairseq(sd, strict: bool = True) -> dict:
    """fairseq HubertModel state dict (checkpoint['model']) -> this
    module's state dict. With `strict`, a source key neither converted nor
    training-only (`label_embs_concat`, `mask_emb`) raises."""
    from ns2vc_tpu_torch.utils.convert_reference import (
        TrackedStateDict, assert_fully_consumed,
    )

    sd = TrackedStateDict(sd)

    def t(key):
        return torch.as_tensor(sd[key]).float()

    n_layers = 0
    while f"encoder.layers.{n_layers}.self_attn.q_proj.weight" in sd:
        n_layers += 1
    out = {port: t(fs) for fs, port in _fairseq_names(n_layers)}
    # torch weight_norm(dim=2): one gain per kernel position, the norm
    # taken over the (out, in) dims at each position
    wg = t("encoder.pos_conv.0.weight_g")                  # (1, 1, K)
    wv = t("encoder.pos_conv.0.weight_v")                  # (O, I/g, K)
    norm = torch.sqrt(torch.sum(wv * wv, dim=(0, 1), keepdim=True))
    out["pos_conv.weight"] = wv * (wg / torch.clamp(norm, min=1e-12))
    if strict:
        assert_fully_consumed(sd, ignore=(r"label_embs_concat", r"mask_emb"),
                              context="contentvec_from_fairseq")
    return out


# the JAX package's name (features/contentvec.py:149); it returns this
# module's state dict, not flax params
convert_fairseq_hubert = contentvec_from_fairseq


def contentvec_to_fairseq(sd: dict) -> dict:
    """This module's state dict -> the fairseq HubertModel layout that
    `contentvec_from_fairseq` reads, pos_conv split into a weight norm whose
    gain is the weight's norm (no training-only tensors)."""
    n_layers = 0
    while f"layers_{n_layers}.fc1.weight" in sd:
        n_layers += 1
    out = {fs: sd[port] for fs, port in _fairseq_names(n_layers)}
    w = sd["pos_conv.weight"]
    out["encoder.pos_conv.0.weight_g"] = torch.sqrt(
        torch.sum(w * w, dim=(0, 1), keepdim=True))
    out["encoder.pos_conv.0.weight_v"] = w
    return out


def _heads_from_metadata(data) -> int | None:
    """encoder_attention_heads from a fairseq checkpoint's 'cfg' (dict or
    OmegaConf) or 'args' (argparse Namespace), else None."""
    cfg = data.get("cfg") if hasattr(data, "get") else None
    if cfg is not None:
        model_cfg = cfg.get("model") if hasattr(cfg, "get") \
            else getattr(cfg, "model", None)
        for source in (model_cfg, cfg):
            if source is None:
                continue
            h = (source.get("encoder_attention_heads")
                 if hasattr(source, "get")
                 else getattr(source, "encoder_attention_heads", None))
            if h is not None:
                return int(h)
    args = data.get("args") if hasattr(data, "get") else None
    h = getattr(args, "encoder_attention_heads", None)
    return int(h) if h is not None else None


def contentvec_from_state_dict(sd: dict, heads: int | None = None
                               ) -> ContentVec:
    """A loaded ContentVec whose widths are read off the port state dict;
    `heads` (which no tensor encodes) defaults to fairseq's 64-wide heads."""
    dim = int(sd["post_extract_proj.weight"].shape[0])
    n_layers = 0
    while f"layers_{n_layers}.fc1.weight" in sd:
        n_layers += 1
    model = ContentVec(dim=dim, heads=heads or max(1, dim // 64),
                       ffn_dim=int(sd["layers_0.fc1.weight"].shape[0]),
                       num_layers=n_layers, output_layer=n_layers,
                       final_dim=int(sd["final_proj.weight"].shape[0]))
    model.load_state_dict(sd)
    return model.eval()


def load_contentvec(ckpt_path: str, heads: int | None = None) -> ContentVec:
    """torch.load a fairseq contentvec checkpoint -> a loaded ContentVec
    (CPU, f32). The head count comes from the checkpoint's metadata, else
    fairseq's 64-wide-head convention with a warning."""
    try:
        data = torch.load(ckpt_path, map_location="cpu")
    except Exception:
        # legacy fairseq checkpoints pickle an argparse.Namespace, which
        # torch's weights_only default rejects
        data = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = data.get("model", data)
    if heads is None:
        heads = _heads_from_metadata(data)
    if heads is None:
        heads = max(1, int(sd["post_extract_proj.weight"].shape[0]) // 64)
        warnings.warn(
            f"load_contentvec: checkpoint carries no encoder_attention_heads "
            f"metadata; assuming fairseq's 64-wide-head convention ({heads} "
            f"heads); pass heads= if this checkpoint deviates", stacklevel=2)
    return contentvec_from_state_dict(contentvec_from_fairseq(sd), heads)
