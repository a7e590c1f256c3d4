"""Vocos vocoder, mel -> waveform (counterpart of
ns2vc_tpu/models/vocos.py): ConvNeXt-1D backbone (dim 512 x 8 blocks,
intermediate 1536) and an iSTFT head with n_fft 1024 / hop 256 and 'same'
padding. Submodule names follow the flax parameter tree."""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from ns2vc_tpu_torch.audio.mel import hann_window, overlap_add
from ns2vc_tpu_torch.models.layers import Conv1d


class ConvNeXtBlock(nn.Module):
    """dwconv(k7) -> LN -> pw -> exact GELU -> pw -> layer scale -> residual."""

    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init_value: float):
        super().__init__()
        self.layer_scale_init_value = layer_scale_init_value
        self.dwconv = Conv1d(dim, dim, 7, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pwconv1(self.norm(self.dwconv(x)))
        h = self.pwconv2(F.gelu(h))
        return x + self.gamma * h


class VocosBackbone(nn.Module):
    """embed conv(k7) -> LN -> ConvNeXt x num_layers -> LN."""

    def __init__(self, input_channels: int = 100, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8):
        super().__init__()
        self.num_layers = num_layers
        self.embed = Conv1d(input_channels, dim, 7)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        for i in range(num_layers):
            self.add_module(f"convnext_{i}", ConvNeXtBlock(
                dim, intermediate_dim, 1.0 / num_layers))
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(self.embed(x))
        for i in range(self.num_layers):
            h = getattr(self, f"convnext_{i}")(h)
        return self.final_layer_norm(h)


class ISTFTHead(nn.Module):
    """Linear -> (log-mag, phase) -> complex spectrum -> iSTFT, 'same'
    padding: output length T * hop. The synthesis runs in f32: exp(mag)
    clipped at 1e2, irfft, window, overlap-add, division by the window
    envelope floored at 1e-11, trim of (n_fft - hop)/2 per side."""

    def __init__(self, dim: int = 512, n_fft: int = 1024,
                 hop_length: int = 256):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.out = nn.Linear(dim, n_fft + 2)
        self.register_buffer("window", torch.from_numpy(hann_window(n_fft)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mag, phase = self.out(x).chunk(2, dim=-1)
        mag = torch.exp(mag.float()).clamp(max=1e2)
        spec = torch.polar(mag, phase.float())
        window = self.window.float()
        frames = torch.fft.irfft(spec, n=self.n_fft, dim=-1) * window
        sig = overlap_add(frames, self.hop_length)
        env = overlap_add((window * window).expand(frames.shape[-2:]),
                          self.hop_length)
        sig = sig / env.clamp(min=1e-11)
        pad = (self.n_fft - self.hop_length) // 2
        return sig[..., pad:-pad]


class Vocos(nn.Module):
    """(B, T, 100) or (B, 100, T) log-mel -> (B, T*hop) f32 waveform."""

    def __init__(self, input_channels: int = 100, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8,
                 n_fft: int = 1024, hop_length: int = 256):
        super().__init__()
        self.input_channels = input_channels
        self.backbone = VocosBackbone(input_channels, dim, intermediate_dim,
                                      num_layers)
        self.head = ISTFTHead(dim, n_fft, hop_length)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        if mel.shape[-1] != self.input_channels:
            mel = mel.transpose(-1, -2)
        dtype = self.head.out.weight.dtype
        return self.head(self.backbone(mel.to(dtype)))


def vocos_from_state_dict(sd: dict, hop_length: int = 256) -> Vocos:
    """A Vocos module whose hyperparameters are read off a state dict
    (embed weight -> input channels and dim, pwconv1 -> intermediate dim,
    ConvNeXt count -> layers, head.out -> n_fft); the hop length is the one
    setting a state dict cannot encode."""
    embed = sd["backbone.embed.weight"]                   # (dim, n_mels, 7)
    n_layers = 0
    while f"backbone.convnext_{n_layers}.dwconv.weight" in sd:
        n_layers += 1
    return Vocos(input_channels=int(embed.shape[1]), dim=int(embed.shape[0]),
                 intermediate_dim=int(
                     sd["backbone.convnext_0.pwconv1.weight"].shape[0]),
                 num_layers=n_layers,
                 n_fft=int(sd["head.out.weight"].shape[0]) - 2,
                 hop_length=hop_length)


# the one key that differs: (pattern, replacement) each way
_PUBLIC_TO_PORT = (r"backbone\.convnext\.(\d+)\.", r"backbone.convnext_\1.")
_PORT_TO_PUBLIC = (r"backbone\.convnext_(\d+)\.", r"backbone.convnext.\1.")


def vocos_from_public(sd, strict: bool = True) -> dict:
    """Public charactr/vocos state dict (`pytorch_model.bin`) -> this
    module's state dict: `backbone.convnext.{i}.*` -> `backbone.convnext_{i}.*`,
    every other parameter keeps its name. Under `strict` a key neither
    converted nor a buffer recomputed here (the feature extractor's mel
    filterbank and windows, the iSTFT window) raises."""
    from ns2vc_tpu_torch.utils.convert_reference import (
        TrackedStateDict, assert_fully_consumed,
    )

    sd = TrackedStateDict(sd)
    out = {}
    names = [f"backbone.{m}.{p}" for m in ("embed", "norm", "final_layer_norm")
             for p in ("weight", "bias")] + ["head.out.weight", "head.out.bias"]
    names += [k for k in sd if re.fullmatch(r"backbone\.convnext\.\d+\..*", k)]
    for key in names:
        out[re.sub(*_PUBLIC_TO_PORT, key)] = torch.as_tensor(sd[key]).float()
    if strict:
        assert_fully_consumed(
            sd, ignore=(r"feature_extractor\..*", r"head\.istft\.window"),
            context="vocos_from_public")
    return out


# the JAX package's name (models/vocos.py:120); it returns this module's
# state dict, not flax params
convert_vocos_state_dict = vocos_from_public


def vocos_to_public(sd: dict) -> dict:
    """This module's state dict -> the public charactr/vocos layout that
    `vocos_from_public` reads (without the buffers it recomputes)."""
    return {re.sub(*_PORT_TO_PUBLIC, k): v for k, v in sd.items()}


def load_vocos(ckpt_path: str, hop_length: int = 256) -> Vocos:
    """torch.load a public Vocos checkpoint -> a loaded Vocos (CPU, f32)
    whose widths are read off the state dict."""
    sd = torch.load(ckpt_path, map_location="cpu")
    sd = vocos_from_public(sd.get("state_dict", sd))
    vocos = vocos_from_state_dict(sd, hop_length)
    vocos.load_state_dict(sd)
    return vocos.eval()
