"""NSF-HiFiGAN: the source-filter HiFiGAN vocoder, 44.1 kHz log-mel + F0
-> waveform (counterpart of ns2vc_tpu/models/nsf_hifigan.py; the
reference's nsf_hifigan/models.py:101-434).

- `sine_source` / `SourceModuleHnNSF`: harmonic sines from frame-rate F0,
  a random initial phase per harmonic, the phase accumulated blockwise mod
  1 (`_mod1_cumsum`, in f64: see `sine_source`), merged by a linear layer
  and tanh;
- `NSFHiFiGANGenerator`: conv_pre -> [LeakyReLU -> ConvTranspose upsample
  + the source through a strided conv -> the mean of the multi-receptive-
  field ResBlocks] per stage -> LeakyReLU (slope 0.01) -> conv_post -> tanh;
- `MultiPeriodDiscriminator` / `MultiScaleDiscriminator` and the LSGAN and
  feature-matching losses, for training.

The public API keeps the JAX package's layout: mel (B, T, num_mels), f0
(B, T), waveform (B, T * prod(upsample_rates)); discriminators take
(B, T) waveforms. Inside, the modules work in (B, C, T) (the period
discriminator in (B, C, T/p, p)), so every convolution is one cuDNN call;
no hand-written kernel is on this path (the JAX module reaches no Pallas
kernel). Submodule names follow the flax parameter tree, except that the
generator's strided noise convs, raw parameters `noise_convs_{i}_kernel` /
`_bias` in flax, are Conv1d submodules `noise_convs_{i}` here
(`convert.nsf_hifigan_from_flax` maps them).

`convert_nsf_hifigan` reads the reference checkpoint's generator
(`cp_dict['generator']`, weight-normed convs) into this module's state
dict, folding each weight norm as the JAX converter does;
`nsf_hifigan_to_reference` writes that layout back (tests and the smoke);
`load_nsf_hifigan` builds the generator from a reference `config.json`.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1
HARMONIC_NUM = 8


# -- source module ----------------------------------------------------------

def _mod1_cumsum(x: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Fractional part of the running sum of (B, N, H) along N, taken
    blockwise (a local cumsum, the block totals mod 1, their exclusive
    running sum mod 1, then mod 1) so that f32 never holds a large
    magnitude: sin(2 pi x) needs x mod 1 only, and taking mod 1 at any
    point is exact. A plain cumsum over 440 k samples in f32 loses the
    phase. `torch.remainder` is floor-mod, as `jnp.mod`."""
    b, n, h = x.shape
    xp = F.pad(x, (0, 0, 0, (-n) % block))
    nb = xp.shape[1] // block
    local = torch.cumsum(xp.reshape(b, nb, block, h), dim=2)
    totals = torch.remainder(local[:, :, -1, :], 1.0)
    offsets = torch.remainder(torch.cumsum(totals, dim=1) - totals, 1.0)
    phase = torch.remainder(local + offsets[:, :, None, :], 1.0)
    return phase.reshape(b, nb * block, h)[:, :n]


def initial_phase(batch: int, harmonics: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Uniform [0, 1) initial phases (B, H), the fundamental's column zero,
    drawn on the generator's device: with a CPU generator (seed 0 without
    one, as the JAX module's default key is PRNGKey(0)) a card and the CPU
    start from the same phases."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    r = torch.rand((batch, harmonics), generator=generator,
                   device=generator.device)
    r[:, 0] = 0.0
    return r


def sine_source(f0: torch.Tensor, upp: int, sampling_rate: int,
                harmonic_num: int, generator: torch.Generator | None = None,
                sine_amp: float = 0.1, rand_ini: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Frame-rate f0 (B, L) -> sample-rate harmonic sines (B, L*upp, H+1)
    in f32, whatever f0's dtype (f0 is taken in f32, as JAX takes it). The
    phase increments are held per frame (nearest upsampling), the initial
    phases (B, H+1) are `rand_ini` or drawn by `initial_phase` from
    `generator`.

    The increments and their blocked mod-1 running sum are taken in f64,
    where the JAX module takes them in f32: an f32 running sum of held
    increments rounds by an amount that depends on the summation order.
    On 2 s at 44.1 kHz the f32 sines were 1.1e-2 (of an amplitude of 0.1)
    from the exact ones with the card's parallel scan and 3.1e-5 with the
    CPU's sequential sum (chip_smoke.py's NSF phase, NVIDIA H100 80GB
    HBM3, 700 W); in f64 the two sides agree to 7.5e-9."""
    b, _ = f0.shape
    h = harmonic_num + 1
    harmonics = torch.arange(1, h + 1, dtype=torch.float64, device=f0.device)
    rad = torch.remainder(
        f0.float().double()[..., None] * harmonics / sampling_rate, 1.0)
    if rand_ini is None:
        rand_ini = initial_phase(b, h, generator)
    rand_ini = rand_ini.to(rad.device, torch.float32).double()
    rad = torch.cat([rad[:, :1] + rand_ini[:, None], rad[:, 1:]], dim=1)
    phase = _mod1_cumsum(rad.repeat_interleave(upp, dim=1)).float()
    return torch.sin(phase * (2 * math.pi)) * sine_amp


class SourceModuleHnNSF(nn.Module):
    """harmonic sines -> Linear(H+1 -> 1) -> tanh (nsf_hifigan/models.py:
    175-213); (B, L) f0 -> (B, L*upp, 1)."""

    def __init__(self, sampling_rate: int, harmonic_num: int = HARMONIC_NUM,
                 sine_amp: float = 0.1):
        super().__init__()
        self.sampling_rate, self.harmonic_num = sampling_rate, harmonic_num
        self.sine_amp = sine_amp
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0: torch.Tensor, upp: int,
                generator: torch.Generator | None = None,
                rand_ini: torch.Tensor | None = None) -> torch.Tensor:
        sines = sine_source(f0, upp, self.sampling_rate, self.harmonic_num,
                            generator, self.sine_amp, rand_ini)
        return torch.tanh(self.l_linear(sines))


# -- generator ----------------------------------------------------------------

def _same(kernel_size: int, dilation: int = 1) -> int:
    """flax "SAME" for an odd kernel at stride 1: symmetric d*(k-1)/2."""
    if kernel_size % 2 == 0:
        raise ValueError(f"SAME padding needs an odd kernel, got "
                         f"{kernel_size}")
    return dilation * (kernel_size - 1) // 2


def _conv(cin: int, cout: int, k: int, dilation: int = 1) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, k, dilation=dilation,
                     padding=_same(k, dilation))


class ConvTranspose1D(nn.ConvTranspose1d):
    """torch ConvTranspose1d with padding (k - u) // 2: (B, In, L) ->
    (B, Out, (L-1)*u + k - 2*((k-u)//2)), L*u for the configurations'
    (16, 8) and (4, 2). Its weight is (In, Out, K), unflipped; the JAX
    kernel (K, In, Out) is stored flipped for correlation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=(kernel_size - stride) // 2)


class ResBlock1(nn.Module):
    """[lrelu -> dilated conv -> lrelu -> conv] per dilation, residual
    (nsf_hifigan/models.py:37-75)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: tuple = (1, 3, 5)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs1_{i}",
                            _conv(channels, channels, kernel_size, d))
            self.add_module(f"convs2_{i}",
                            _conv(channels, channels, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            h = getattr(self, f"convs1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            h = getattr(self, f"convs2_{i}")(F.leaky_relu(h, LRELU_SLOPE))
            x = x + h
        return x


class ResBlock2(nn.Module):
    """[lrelu -> dilated conv] per dilation, residual
    (nsf_hifigan/models.py:78-100)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: tuple = (1, 3)):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs_{i}",
                            _conv(channels, channels, kernel_size, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = x + getattr(self, f"convs_{i}")(F.leaky_relu(x, LRELU_SLOPE))
        return x


class NSFHiFiGANGenerator(nn.Module):
    """mel (B, T, num_mels) + f0 (B, T) -> waveform (B, T*prod(rates)) in
    f32. Defaults: the community 44.1 kHz NSF-HiFiGAN configuration the
    reference loads (128 mels, 512 channels, rates (8, 8, 2, 2, 2),
    ResBlock1 (3, 7, 11) x (1, 3, 5); 14 M parameters)."""

    def __init__(self, num_mels: int = 128,
                 upsample_initial_channel: int = 512,
                 upsample_rates: tuple = (8, 8, 2, 2, 2),
                 upsample_kernel_sizes: tuple = (16, 16, 4, 4, 4),
                 resblock: str = "1",
                 resblock_kernel_sizes: tuple = (3, 7, 11),
                 resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5),
                                                   (1, 3, 5)),
                 sampling_rate: int = 44100):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.upp = int(np.prod(self.upsample_rates))
        self.n_kernels = len(resblock_kernel_sizes)
        self.m_source = SourceModuleHnNSF(sampling_rate)
        c0 = upsample_initial_channel
        self.conv_pre = _conv(num_mels, c0, 7)
        res_cls = ResBlock1 if str(resblock) == "1" else ResBlock2
        n_up = len(self.upsample_rates)
        for i, (u, k) in enumerate(zip(self.upsample_rates,
                                       upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.add_module(f"ups_{i}", ConvTranspose1D(2 * ch, ch, k, u))
            if i + 1 < n_up:
                s = int(np.prod(self.upsample_rates[i + 1:]))
                noise = nn.Conv1d(1, ch, 2 * s, stride=s, padding=s // 2)
            else:
                noise = nn.Linear(1, ch)   # flax Dense over the source
            self.add_module(f"noise_convs_{i}", noise)
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes,
                                             resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i}_{j}",
                                res_cls(ch, rk, tuple(rd)))
        self.conv_post = _conv(c0 // (2 ** n_up), 1, 7)

    def forward(self, mel: torch.Tensor, f0: torch.Tensor,
                generator: torch.Generator | None = None,
                rand_ini: torch.Tensor | None = None) -> torch.Tensor:
        source = self.m_source(f0, self.upp, generator, rand_ini)  # (B,N,1)
        source_t = source.transpose(1, 2)                          # (B,1,N)
        x = self.conv_pre(mel.float().transpose(1, 2))
        n_up = len(self.upsample_rates)
        for i in range(n_up):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            noise = getattr(self, f"noise_convs_{i}")
            x = x + (noise(source_t) if i + 1 < n_up
                     else noise(source).transpose(1, 2))
            xs = getattr(self, f"resblocks_{i}_0")(x)
            for j in range(1, self.n_kernels):
                xs = xs + getattr(self, f"resblocks_{i}_{j}")(x)
            x = xs / self.n_kernels
        x = self.conv_post(F.leaky_relu(x))   # flax's default slope, 0.01
        return torch.tanh(x)[:, 0]


# -- discriminators and GAN losses (nsf_hifigan/models.py:283-434) -----------

def _pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax "SAME" padding of (..., n) for a strided window: the total is
    max((ceil(n/s) - 1)*s + k - n, 0), the low side gets total // 2."""
    n = x.shape[-1]
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return F.pad(x, (total // 2, total - total // 2))


class DiscriminatorP(nn.Module):
    """Period discriminator: the waveform reflect-padded to a multiple of
    the period, folded to (B, 1, T/p, p), strided (k, 1) 2D convs. Feature
    maps are (B, C, T', p) (JAX's are (B, T', p, C)); the flattened output
    keeps JAX's element order."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024)
        for i in range(4):
            self.add_module(f"convs_{i}", nn.Conv2d(
                chans[i], chans[i + 1], (kernel_size, 1), (stride, 1),
                padding=(2, 0)))
        self.convs_4 = nn.Conv2d(1024, 1024, (kernel_size, 1),
                                 padding=(2, 0))
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, x: torch.Tensor):
        b, t = x.shape
        pad = (-t) % self.period
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
        x = x.reshape(b, 1, -1, self.period)
        fmaps = []
        for i in range(5):
            x = F.leaky_relu(getattr(self, f"convs_{i}")(x), LRELU_SLOPE)
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.reshape(b, -1), fmaps


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped strided 1D convs with flax's "SAME"
    padding (asymmetric at stride 2 and 4: padded explicitly). Feature maps
    are (B, C, T')."""

    SPECS = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16),
             (512, 41, 4, 16), (1024, 41, 4, 16), (1024, 41, 1, 16),
             (1024, 5, 1, 1))   # (channels, kernel, stride, groups)

    def __init__(self):
        super().__init__()
        cin = 1
        for i, (ch, k, s, g) in enumerate(self.SPECS):
            self.add_module(f"convs_{i}", nn.Conv1d(
                cin, ch, k, stride=s, groups=g if cin % g == 0 else 1))
            cin = ch
        self.conv_post = nn.Conv1d(cin, 1, 3)

    def forward(self, x: torch.Tensor):
        b = x.shape[0]
        h = x[:, None]
        fmaps = []
        for i, (_, k, s, _) in enumerate(self.SPECS):
            h = getattr(self, f"convs_{i}")(_pad_same(h, k, s))
            h = F.leaky_relu(h, LRELU_SLOPE)
            fmaps.append(h)
        h = self.conv_post(_pad_same(h, 3, 1))
        fmaps.append(h)
        return h.reshape(b, -1), fmaps


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: tuple = (2, 3, 5, 7, 11)):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"disc_{p}", DiscriminatorP(p))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for p in self.periods:
            d = getattr(self, f"disc_{p}")
            r, fr = d(y)
            g, fg = d(y_hat)
            outs_r.append(r)
            outs_g.append(g)
            fmaps_r.append(fr)
            fmaps_g.append(fg)
        return outs_r, outs_g, fmaps_r, fmaps_g


def _pool(y: torch.Tensor) -> torch.Tensor:
    """JAX's reduce_window sum, window 4, stride 2, "SAME", over 4: zero
    padding (low 1; high 1 for an even length, 2 for an odd one), then the
    mean of 4 samples counting the pads (not torch's AvgPool1d(4, 2, 2))."""
    return F.avg_pool1d(_pad_same(y[:, None], 4, 2), 4, 2)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, num_scales: int = 3):
        super().__init__()
        self.num_scales = num_scales
        for i in range(num_scales):
            self.add_module(f"disc_{i}", DiscriminatorS())

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
        for i in range(self.num_scales):
            d = getattr(self, f"disc_{i}")
            r, fr = d(y)
            g, fg = d(y_hat)
            outs_r.append(r)
            outs_g.append(g)
            fmaps_r.append(fr)
            fmaps_g.append(fg)
            if i + 1 < self.num_scales:
                y, y_hat = _pool(y), _pool(y_hat)
        return outs_r, outs_g, fmaps_r, fmaps_g


def feature_loss(fmaps_r, fmaps_g) -> torch.Tensor:
    """L1 feature matching x 2 (nsf_hifigan/models.py:391-398)."""
    loss = 0.0
    for fr, fg in zip(fmaps_r, fmaps_g):
        for r, g in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(r - g))
    return loss * 2.0


def discriminator_loss(outs_r, outs_g) -> torch.Tensor:
    """LSGAN discriminator loss (nsf_hifigan/models.py:401-413)."""
    loss = 0.0
    for r, g in zip(outs_r, outs_g):
        loss = loss + torch.mean((1.0 - r) ** 2) + torch.mean(g ** 2)
    return loss


def generator_loss(outs_g) -> torch.Tensor:
    """LSGAN generator loss (nsf_hifigan/models.py:416-424)."""
    loss = 0.0
    for g in outs_g:
        loss = loss + torch.mean((1.0 - g) ** 2)
    return loss


# -- the reference checkpoint ----------------------------------------------

def generator_kwargs(cfg: dict) -> dict:
    """A reference `config.json` (dict) -> NSFHiFiGANGenerator's keywords
    (scripts/reconstruct_nsf.py:55-64)."""
    return dict(
        num_mels=cfg["num_mels"],
        upsample_initial_channel=cfg["upsample_initial_channel"],
        upsample_rates=tuple(cfg["upsample_rates"]),
        upsample_kernel_sizes=tuple(cfg["upsample_kernel_sizes"]),
        resblock=str(cfg.get("resblock", "1")),
        resblock_kernel_sizes=tuple(cfg["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(
            tuple(d) for d in cfg["resblock_dilation_sizes"]),
        sampling_rate=cfg["sampling_rate"])


def _convs_of(cfg: dict, p: str, j: int) -> list[tuple[str, str]]:
    """(reference prefix, port prefix) of the convs of resblock kernel j."""
    dil = cfg["resblock_dilation_sizes"][j]
    if str(cfg.get("resblock", "1")) == "1":
        return [(f"{p}.convs{a}.{c}", f"convs{a}_{c}")
                for c in range(len(dil)) for a in (1, 2)]
    return [(f"{p}.convs.{c}", f"convs_{c}") for c in range(len(dil))]


def _layers(cfg: dict) -> list[tuple[str, str, bool]]:
    """(reference prefix, port prefix, weight-normed) of every layer with
    a weight and a bias."""
    out = [("conv_pre", "conv_pre", True), ("conv_post", "conv_post", True),
           ("m_source.l_linear", "m_source.l_linear", False)]
    n_up, n_k = len(cfg["upsample_rates"]), len(cfg["resblock_kernel_sizes"])
    for i in range(n_up):
        out += [(f"ups.{i}", f"ups_{i}", True),
                (f"noise_convs.{i}", f"noise_convs_{i}", False)]
        for j in range(n_k):
            p = f"resblocks.{i * n_k + j}"
            out += [(ref, f"resblocks_{i}_{j}.{port}", True)
                    for ref, port in _convs_of(cfg, p, j)]
    return out


def _fold(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Weight norm g * v / max(|v|, 1e-12), the norm over every axis but 0
    (torch's weight_norm at dim 0; the JAX converter's fold)."""
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())),
                                keepdim=True))
    return v * g / torch.clamp(norm, min=1e-12)


def convert_nsf_hifigan(sd, cfg: dict, strict: bool = True) -> dict:
    """Reference generator state dict (`cp_dict['generator']`; weight-normed
    convs as `weight_g` / `weight_v`, or folded as `weight`) -> this
    module's state dict, the weight norms folded. The last noise conv, a
    (ch, 1, 1) Conv1d there, is a Linear here. Under `strict` a key left
    unconsumed raises."""
    from ns2vc_tpu_torch.utils.convert_reference import (
        TrackedStateDict, assert_fully_consumed,
    )

    sd = TrackedStateDict(sd)

    def t(key):
        return torch.as_tensor(sd[key]).float()

    out = {}
    last = f"noise_convs_{len(cfg['upsample_rates']) - 1}"
    for ref, port, _ in _layers(cfg):
        w = (_fold(t(f"{ref}.weight_g"), t(f"{ref}.weight_v"))
             if f"{ref}.weight_g" in sd else t(f"{ref}.weight"))
        out[f"{port}.weight"] = w[:, :, 0] if port == last else w
        out[f"{port}.bias"] = t(f"{ref}.bias")
    if strict:
        assert_fully_consumed(sd, context="convert_nsf_hifigan")
    return out


def nsf_hifigan_to_reference(sd: dict, cfg: dict) -> dict:
    """This module's state dict -> the reference generator's layout that
    `convert_nsf_hifigan` reads: weight-normed layers as `weight_g` (the
    norm over every axis but 0) and `weight_v` (the weight), the last noise
    conv as a (ch, 1, 1) Conv1d."""
    out = {}
    last = f"noise_convs_{len(cfg['upsample_rates']) - 1}"
    for ref, port, normed in _layers(cfg):
        w = sd[f"{port}.weight"]
        w = w[:, :, None] if port == last else w
        if normed:
            out[f"{ref}.weight_g"] = torch.sqrt(torch.sum(
                w * w, dim=tuple(range(1, w.dim())), keepdim=True))
            out[f"{ref}.weight_v"] = w.clone()
        else:
            out[f"{ref}.weight"] = w.clone()
        out[f"{ref}.bias"] = sd[f"{port}.bias"].clone()
    return out


def load_nsf_hifigan(ckpt_path: str, config: dict | str
                     ) -> NSFHiFiGANGenerator:
    """A reference NSF-HiFiGAN checkpoint ({'generator': state dict}) and
    its `config.json` (a path or the dict) -> the loaded generator (CPU,
    f32, eval)."""
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    data = torch.load(ckpt_path, map_location="cpu")
    gen = NSFHiFiGANGenerator(**generator_kwargs(config))
    gen.load_state_dict(convert_nsf_hifigan(data["generator"], config))
    return gen.eval()

