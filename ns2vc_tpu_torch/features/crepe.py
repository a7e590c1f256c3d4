"""CREPE pitch estimator for the `--f0_mean_pooling` path (counterpart of
ns2vc_tpu/features/crepe.py).

1024-sample 16 kHz frames, normalised per frame -> six conv + ReLU +
BatchNorm (eval) + maxpool(2) blocks with torchcrepe's paddings (254, 254)
on the first conv and (31, 32) on the others -> a 2048 -> 360 sigmoid
classifier over 20-cent pitch bins. Decoding is the local weighted average
around the argmax bin ("mean pooling") with a periodicity threshold for
voicing.

Submodule names follow the flax tree (`conv{i}`, `conv{i}_BN`,
`classifier`); `crepe_from_torchcrepe` reads torchcrepe's `full.pth`, and
`crepe_to_torchcrepe` writes its layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FULL_FILTERS = (1024, 128, 128, 128, 256, 512)
TINY_FILTERS = (128, 16, 16, 16, 32, 64)
WINDOW = 1024
PITCH_BINS = 360
CENTS_PER_BIN = 20.0


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the channel axis of (N, C, T): weight,
    bias, running_mean, running_var (no batch counter)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class Crepe(nn.Module):
    """(N, 1024) normalised frames -> (N, 360) bin probabilities."""

    def __init__(self, model: str = "full"):
        super().__init__()
        self.filters = FULL_FILTERS if model == "full" else TINY_FILTERS
        cin = 1
        for i, ch in enumerate(self.filters):
            k, s = (512, 4) if i == 0 else (64, 1)
            self.add_module(f"conv{i + 1}", nn.Conv1d(cin, ch, k, stride=s))
            self.add_module(f"conv{i + 1}_BN", BatchNorm(ch))
            cin = ch
        self.classifier = nn.Linear(4 * self.filters[-1], PITCH_BINS)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames[:, None, :]
        for i in range(len(self.filters)):
            x = F.pad(x, (254, 254) if i == 0 else (31, 32))
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
            x = getattr(self, f"conv{i + 1}_BN")(x)
            x = F.max_pool1d(x, 2, 2)
        # flatten time-major, as the flax (N, T, C) layout and torchcrepe do
        x = x.transpose(1, 2).reshape(x.shape[0], -1)
        return torch.sigmoid(self.classifier(x))


def bins_to_cents(bins: torch.Tensor) -> torch.Tensor:
    return CENTS_PER_BIN * bins + 1997.3794084376191


def cents_to_frequency(cents: torch.Tensor) -> torch.Tensor:
    return 10.0 * 2.0 ** (cents / 1200.0)


def decode_weighted(probs: torch.Tensor, radius: int = 4):
    """Weighted average of the bins within `radius` of the argmax
    (torchcrepe's weighted_argmax) -> (f0 Hz, periodicity), each (N,)."""
    bins = torch.argmax(probs, dim=-1)
    periodicity = torch.gather(probs, -1, bins[:, None])[:, 0]
    idx = bins[:, None] + torch.arange(-radius, radius + 1,
                                       device=probs.device)[None, :]
    idx = idx.clamp(0, PITCH_BINS - 1)
    w = torch.gather(probs, -1, idx)
    cents = torch.sum(bins_to_cents(idx.float()) * w, dim=-1) \
        / torch.clamp(torch.sum(w, dim=-1), min=1e-8)
    return cents_to_frequency(cents), periodicity


@torch.no_grad()
def compute_f0_uv_crepe(wav, p_len: int | None = None,
                        sampling_rate: int = 44100, hop_length: int = 512,
                        threshold: float = 0.05,
                        model: Crepe | None = None):
    """(f0, uv) at the mel frame rate with unvoiced gaps interpolated: the
    waveform (numpy) is resampled to 16 kHz and framed on the model's
    device, CREPE runs there, and the decode's host tail (threshold,
    resize, interpolate) is the JAX package's numpy code."""
    from ns2vc_tpu_torch.audio.host import interpolate_f0, resize_f0
    from ns2vc_tpu_torch.audio.resample import resample

    if model is None:
        raise RuntimeError("crepe weights required: pass model= from "
                           "load_crepe()")
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(wav, np.float32)).to(dev)
    if p_len is None:
        p_len = x.shape[0] // hop_length
    x16 = resample(x, sampling_rate, 16000)
    hop16 = int(round(hop_length * 16000 / sampling_rate))
    x16 = F.pad(x16, (WINDOW // 2, WINDOW // 2))
    frames = x16.unfold(0, WINDOW, hop16)
    frames = frames - frames.mean(dim=1, keepdim=True)
    # numpy's std: the population (ddof 0) standard deviation
    frames = frames / torch.clamp(frames.std(dim=1, keepdim=True,
                                             correction=0), min=1e-10)
    dtype = next(model.parameters()).dtype
    f0, periodicity = decode_weighted(model(frames.to(dtype)).float())
    f0 = np.where(periodicity.cpu().numpy() > threshold, f0.cpu().numpy(),
                  0.0)
    return interpolate_f0(resize_f0(f0, p_len))


def crepe_from_torchcrepe(sd, strict: bool = True) -> dict:
    """torchcrepe state dict -> this module's state dict: conv weights
    (O, 1|I, K, 1) lose their trailing axis; a key neither converted nor a
    BatchNorm `num_batches_tracked` counter raises under `strict`."""
    from ns2vc_tpu_torch.utils.convert_reference import (
        TrackedStateDict, assert_fully_consumed,
    )

    sd = TrackedStateDict(sd)
    out = {}
    i = 1
    while f"conv{i}.weight" in sd:
        out[f"conv{i}.weight"] = torch.as_tensor(
            sd[f"conv{i}.weight"]).float()[..., 0]
        out[f"conv{i}.bias"] = torch.as_tensor(sd[f"conv{i}.bias"]).float()
        for p in ("weight", "bias", "running_mean", "running_var"):
            out[f"conv{i}_BN.{p}"] = torch.as_tensor(
                sd[f"conv{i}_BN.{p}"]).float()
        i += 1
    for p in ("weight", "bias"):
        out[f"classifier.{p}"] = torch.as_tensor(
            sd[f"classifier.{p}"]).float()
    if strict:
        assert_fully_consumed(sd, ignore=(r".*\.num_batches_tracked",),
                              context="crepe_from_torchcrepe")
    return out


# the JAX package's name (features/crepe.py:116); it returns this module's
# state dict and reads 'full' or 'tiny' off the keys
convert_torchcrepe = crepe_from_torchcrepe


def crepe_to_torchcrepe(sd: dict) -> dict:
    """This module's state dict -> the torchcrepe layout that
    `crepe_from_torchcrepe` reads: conv weights gain their trailing axis,
    and each BatchNorm a zero `num_batches_tracked` counter."""
    out = {}
    for k, v in sd.items():
        conv = k.startswith("conv") and "_BN." not in k
        out[k] = v[..., None] if conv and k.endswith(".weight") else v
        if k.endswith("_BN.running_var"):
            out[k.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(0)
    return out


def crepe_from_state_dict(sd: dict) -> Crepe:
    """A loaded Crepe ('full' or 'tiny', read off conv1's width)."""
    model = Crepe("full" if sd["conv1.weight"].shape[0] == FULL_FILTERS[0]
                  else "tiny")
    model.load_state_dict(sd)
    return model.eval()


def load_crepe(ckpt_path: str) -> Crepe:
    """torch.load torchcrepe's `full.pth` (or `tiny.pth`) -> a loaded
    Crepe (CPU, f32)."""
    return crepe_from_state_dict(crepe_from_torchcrepe(
        torch.load(ckpt_path, map_location="cpu")))
