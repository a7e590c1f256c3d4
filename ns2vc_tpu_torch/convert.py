"""Weights across the frameworks, and a seeded initialiser.

`from_flax` maps the JAX package's parameter tree (nested dicts of numpy
arrays, as `NaturalSpeech2.init` makes them) onto the port's modules, whose
submodule names follow the flax paths; `vocos_from_flax`,
`contentvec_from_flax`, `crepe_from_flax`, `nsf_hifigan_from_flax`,
`mpd_from_flax` and `msd_from_flax` do the same for the other models
(CREPE's `batch_stats` become BatchNorm running statistics). Leaf rules:

    Dense kernel (in, out)            -> Linear weight (out, in)
    Conv kernel (K, Cin/g, Cout)      -> Conv1d weight (Cout, Cin/g, K)
    Conv kernel (KH, KW, Cin, Cout)   -> Conv2d weight (Cout, Cin, KH, KW)
    depthwise kernel (K, 1, C)        -> Conv1d weight (C, 1, K)
    DenseGeneral in_proj (C, 3, C)    -> Linear weight (3C, C)
    norm scale                        -> weight
    weight-norm conv_v (K, Cin, Cout) -> conv_v (Cout, Cin, K)
    Embed embedding                   -> nn.Embedding weight
    UNet self-attention to_q/to_k/to_v kernels -> one fused to_qkv weight
    OptimizedLSTMCell_0 / _1 (the forward and reverse cells of a BiLSTM):
        input kernels ii/if/ig/io     -> weight_ih (4C, C), gates i, f, g, o
        hidden kernels hi/hf/hg/ho    -> weight_hh, their biases -> bias_hh
        (flax's input kernels have no bias: bias_ih is zero)
    bias, positional_embedding, gamma, conv_g, conv_b, tao -> as they are
    NSF-HiFiGAN's ups_{i} kernel (K, In, Out), flipped for correlation
                                      -> ConvTranspose1d weight (In, Out, K)
    its raw noise_convs_{i}_kernel / _bias (K, 1, C) -> the Conv1d
                                      noise_convs_{i}'s weight / bias

The mapping is strict: a leaf that no port parameter takes, a port
parameter that no leaf fills, or a shape that disagrees raises.

`from_flax_sharded` gives one rank's state dict of the model split over a
mesh's 'model' axis (`from_flax`, then the rank's blocks of what
`parallel.mesh.param_shardings` splits).

`load_checkpoint` reads a `.pt` file into the port's NaturalSpeech2 state
dict: a checkpoint of the port's trainer (tagged `TRAINER_FORMAT`; its EMA
parameters when present), the reference NS2VC `model-N.pt` through the
port's copy of the JAX package's converter (`utils/convert_reference.py`)
and `from_flax`, or a port state dict saved with `torch.save`.

`init_params` draws a state dict from a `torch.Generator` in flax's
initialiser families (lecun-normal kernels, zero biases, unit norms, the
encoders' conv init, normal(embed^-0.5) pooling positions, Vocos layer
scale 1/num_layers; NSF-HiFiGAN's upsampling and strided noise kernels
normal(0.01)), so activations at full width sit on the JAX model's scale.
The values are not those `jax.random` would give.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from ns2vc_tpu_torch.config import Config
from ns2vc_tpu_torch.features.contentvec import ContentVec
from ns2vc_tpu_torch.features.crepe import BatchNorm, Crepe
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
from ns2vc_tpu_torch.models.encoders import (
    AttentionPooling, LNConv, WNConvResidual,
)
from ns2vc_tpu_torch.models.nsf_hifigan import (
    MultiPeriodDiscriminator, MultiScaleDiscriminator, NSFHiFiGANGenerator,
)
from ns2vc_tpu_torch.models.vocos import ConvNeXtBlock, Vocos
from ns2vc_tpu_torch.parallel.mesh import param_shardings, shard_state

_QKV = ("to_q", "to_k", "to_v")
_LSTM_GATES = ("i", "f", "g", "o")    # torch's order of the four gates


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _leaf(path: tuple, arr: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, name = path
    if name == "kernel":
        if mods[-1] == "in_proj" and arr.ndim == 3:   # DenseGeneral (C, 3, C)
            arr = arr.reshape(arr.shape[0], -1).T
        elif arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        elif arr.ndim == 4:                            # Conv 2D, HWIO
            arr = arr.transpose(3, 2, 0, 1)
        name = "weight"
    elif name == "conv_v":
        arr = arr.transpose(2, 1, 0)
    elif name in ("scale", "embedding"):
        name = "weight"
    return ".".join(mods + [name]), arr


def _lstm(flat: dict, base: tuple) -> dict:
    """Pop the two flax cells of the BiLSTM at `base` and build nn.LSTM's
    parameters (names relative to the LSTM module)."""
    out = {}
    for suffix, cell in (("_l0", "OptimizedLSTMCell_0"),
                         ("_l0_reverse", "OptimizedLSTMCell_1")):
        def take(src, leaf):
            parts = [flat.pop(base + (cell, src + g, leaf), None)
                     for g in _LSTM_GATES]
            if any(p is None for p in parts):
                raise ValueError(f"from_flax: missing {'/'.join(base)}/"
                                 f"{cell}/{src}i|f|g|o/{leaf}")
            return np.concatenate(parts, axis=-1)
        out[f"weight_ih{suffix}"] = take("i", "kernel").T
        out[f"weight_hh{suffix}"] = take("h", "kernel").T
        out[f"bias_hh{suffix}"] = take("h", "bias")
        out[f"bias_ih{suffix}"] = np.zeros_like(out[f"bias_hh{suffix}"])
    return out


def from_flax_tree(tree: dict, module: nn.Module,
                   mapped: dict | None = None) -> dict:
    """Strictly map a flax parameter tree onto `module`'s state dict keys;
    `mapped` holds port keys already mapped by a model's own rules."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    sd = dict(mapped or {})
    # fused self-attention projections: concat (C, inner) kernels along out
    for key in expected:
        if key.endswith(".to_qkv.weight"):
            base = tuple(key[:-len(".to_qkv.weight")].split("."))
            parts = [flat.pop(base + (n, "kernel"), None) for n in _QKV]
            if any(p is None for p in parts):
                raise ValueError(f"from_flax: missing {'/'.join(base)}/"
                                 f"to_q|to_k|to_v kernels for {key}")
            sd[key] = np.concatenate(parts, axis=1).T
    for key in expected:
        if key.rsplit(".", 2)[-2:] == ["lstm", "weight_ih_l0"]:
            mod = key[:-len(".weight_ih_l0")]
            for name, arr in _lstm(flat, tuple(mod.split(".")[:-1])).items():
                sd[f"{mod}.{name}"] = arr
    for path, arr in flat.items():
        key, arr = _leaf(path, arr)
        if key not in expected:
            raise ValueError(f"from_flax: leaf {'/'.join(path)} has no port "
                             f"parameter ({key})")
        sd[key] = arr
    missing = sorted(set(expected) - set(sd))
    if missing:
        raise ValueError(f"from_flax: port parameters not assigned: "
                         f"{missing[:8]}{' ...' if len(missing) > 8 else ''}")
    for key, arr in sd.items():
        if key not in expected:
            raise ValueError(f"from_flax: {key} is no port parameter")
        if tuple(arr.shape) != expected[key]:
            raise ValueError(f"from_flax: {key} has shape {tuple(arr.shape)}, "
                             f"the port expects {expected[key]}")
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def _skeleton(factory):
    with torch.device("meta"):
        return factory()


def from_flax(params_np: dict, cfg: Config) -> dict:
    """NaturalSpeech2 flax params -> the port's NaturalSpeech2 state dict."""
    return from_flax_tree(params_np, _skeleton(lambda: NaturalSpeech2(cfg)))


def from_flax_sharded(params_np: dict, cfg: Config, mesh) -> dict:
    """NaturalSpeech2 flax params -> one rank's state dict of the port's
    model split over `mesh`'s model axis: `from_flax`, then the rank's
    block of every parameter `param_shardings` splits (the state dict of
    a model after `parallel.mesh.shard_parameters`)."""
    skeleton = _skeleton(lambda: NaturalSpeech2(cfg))
    return shard_state(from_flax_tree(params_np, skeleton),
                       param_shardings(skeleton, mesh), mesh)


def vocos_from_flax(params_np: dict, **vocos_kwargs) -> dict:
    """Vocos flax params -> the port's Vocos state dict; `vocos_kwargs` are
    the Vocos hyperparameters (defaults: the 24 kHz, 100-mel model)."""
    return from_flax_tree(params_np, _skeleton(lambda: Vocos(**vocos_kwargs)))


def contentvec_from_flax(params_np: dict, **contentvec_kwargs) -> dict:
    """ContentVec flax params -> the port's ContentVec state dict;
    `contentvec_kwargs` are its widths (defaults: HuBERT-base)."""
    return from_flax_tree(params_np,
                          _skeleton(lambda: ContentVec(**contentvec_kwargs)))


def crepe_from_flax(variables: dict, model: str = "full") -> dict:
    """CREPE flax variables {'params', 'batch_stats'} -> the port's Crepe
    state dict (batch_stats mean/var -> running_mean/running_var)."""
    tree = {k: dict(v) for k, v in variables["params"].items()}
    for name, st in variables["batch_stats"].items():
        tree[name].update(running_mean=st["mean"], running_var=st["var"])
    return from_flax_tree(tree, _skeleton(lambda: Crepe(model)))


def nsf_hifigan_from_flax(params_np: dict, **generator_kwargs) -> dict:
    """NSFHiFiGANGenerator flax params -> the port's state dict;
    `generator_kwargs` are its hyperparameters (defaults: 44.1 kHz). The
    upsampling kernels and the raw strided noise-conv parameters take
    their own rules (module docstring)."""
    tree = dict(params_np.get("params", params_np))
    mapped = {}
    for name in list(tree):
        if name.startswith("ups_"):
            leaves = dict(tree.pop(name))
            kernel = np.asarray(leaves.pop("kernel"))
            mapped[f"{name}.weight"] = np.ascontiguousarray(
                kernel[::-1].transpose(1, 2, 0))
            mapped[f"{name}.bias"] = np.asarray(leaves.pop("bias"))
            if leaves:
                raise ValueError(f"from_flax: {name}/{list(leaves)} has no "
                                 f"port parameter")
        elif name.startswith("noise_convs_") and name.endswith("_kernel"):
            mapped[f"{name[:-len('_kernel')]}.weight"] = np.asarray(
                tree.pop(name)).transpose(2, 1, 0)
        elif name.startswith("noise_convs_") and name.endswith("_bias"):
            mapped[f"{name[:-len('_bias')]}.bias"] = np.asarray(
                tree.pop(name))
    return from_flax_tree(tree, _skeleton(
        lambda: NSFHiFiGANGenerator(**generator_kwargs)), mapped)


def mpd_from_flax(params_np: dict, **kw) -> dict:
    """MultiPeriodDiscriminator flax params -> the port's state dict."""
    return from_flax_tree(params_np,
                          _skeleton(lambda: MultiPeriodDiscriminator(**kw)))


def msd_from_flax(params_np: dict, **kw) -> dict:
    """MultiScaleDiscriminator flax params -> the port's state dict."""
    return from_flax_tree(params_np,
                          _skeleton(lambda: MultiScaleDiscriminator(**kw)))


TRAINER_FORMAT = "ns2vc_tpu_torch.trainer"   # the trainer's checkpoints


def save_trainer_checkpoint(path: str, cfg: Config, params: dict,
                            step: int = 0, opt_state: dict | None = None,
                            ema_params: dict | None = None) -> str:
    """Write a checkpoint in the layout of the port's trainer: the step,
    the parameters (a state dict on the CPU), the optimizer's state dict
    (None: the trainer resumes with a fresh AdamW), the EMA parameters
    (None: none kept) and the config. `load_checkpoint` (so `Svc`) and
    `Trainer.load` read it. The file appears whole or not at all."""
    import dataclasses

    payload = {"format": TRAINER_FORMAT, "step": int(step),
               "params": params, "opt_state": opt_state,
               "ema_params": ema_params,
               "config": dataclasses.asdict(cfg)}
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_checkpoint(path: str, cfg: Config, use_ema: bool = True) -> dict:
    """A `.pt` file -> the port's NaturalSpeech2 state dict: a checkpoint
    of the port's trainer (its EMA parameters when it holds them and
    `use_ema`, else its parameters), a reference `model-N.pt` ({'step',
    'model'}) or a port state dict. Orbax checkpoint directories of the
    JAX package are not read here: `scripts/orbax_to_torch.py` turns one
    into a checkpoint of the port's trainer."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: the port does not read orbax "
            f"checkpoints of the JAX package; convert the JAX run with "
            f"scripts/orbax_to_torch.py, or pass a reference model-N.pt, a "
            f"checkpoint of the port's trainer or a port state dict saved "
            f"with torch.save")
    data = torch.load(path, map_location="cpu")
    if data.get("format") == TRAINER_FORMAT:
        ema = data.get("ema_params")
        return ema if use_ema and ema is not None else data["params"]
    if "model" in data:
        from ns2vc_tpu_torch.utils.convert_reference import natural_speech2

        return from_flax(natural_speech2(data["model"]), cfg)
    return data


# -- seeded initialiser ------------------------------------------------------

_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _normal(shape, std: float, g: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).normal_(0.0, std, generator=g)


def _lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    """flax lecun_normal: truncated normal with variance 1/fan_in."""
    t = torch.empty(shape).normal_(generator=g)
    bad = t.abs() > 2.0
    while bad.any():
        t[bad] = torch.empty(int(bad.sum())).normal_(generator=g)
        bad = t.abs() > 2.0
    return t * (math.sqrt(1.0 / fan_in) / _TRUNC)


@torch.no_grad()
def init_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise `module` (on the CPU, f32) in place, flax-style."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            w = m.weight
            fan_in = math.prod(w.shape[1:])
            w.copy_(_lecun_normal(w.shape, fan_in, generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            # flax Embed: variance scaling 1 over the embedding count
            m.weight.copy_(_lecun_normal(m.weight.shape, m.weight.shape[0],
                                         generator))
        elif isinstance(m, nn.LSTM):
            for name, p in m.named_parameters():
                if name.startswith("weight"):
                    p.copy_(_lecun_normal(p.shape, p.shape[1], generator))
                else:
                    p.zero_()
    for m in module.modules():
        if isinstance(m, WNConvResidual):
            m.conv_v.copy_(_normal(m.conv_v.shape, m.init_std, generator))
            m.conv_g.copy_(torch.linalg.vector_norm(m.conv_v.flatten(1),
                                                    dim=1))
            m.conv_b.zero_()
        elif isinstance(m, LNConv):
            m.Conv_0.weight.copy_(_normal(m.Conv_0.weight.shape, m.init_std,
                                          generator))
        elif isinstance(m, AttentionPooling):
            pos = m.positional_embedding
            pos.copy_(_normal(pos.shape, pos.shape[-1] ** -0.5, generator))
        elif isinstance(m, ConvNeXtBlock):
            m.gamma.fill_(m.layer_scale_init_value)
    return module


def init_params(cfg: Config, generator: torch.Generator) -> dict:
    """A seeded NaturalSpeech2 state dict (CPU, f32)."""
    return init_module_(NaturalSpeech2(cfg), generator).state_dict()


def init_vocos_params(generator: torch.Generator, **vocos_kwargs) -> dict:
    """A seeded Vocos state dict (CPU, f32)."""
    return init_module_(Vocos(**vocos_kwargs), generator).state_dict()


def init_contentvec_params(generator: torch.Generator,
                           **contentvec_kwargs) -> dict:
    """A seeded ContentVec state dict (CPU, f32)."""
    return init_module_(ContentVec(**contentvec_kwargs),
                        generator).state_dict()


def init_crepe_params(generator: torch.Generator, model: str = "full"
                      ) -> dict:
    """A seeded Crepe state dict (CPU, f32; unit BatchNorm statistics)."""
    return init_module_(Crepe(model), generator).state_dict()


def init_nsf_hifigan_params(generator: torch.Generator,
                            **generator_kwargs) -> dict:
    """A seeded NSFHiFiGANGenerator state dict (CPU, f32): lecun-normal
    Conv and Dense kernels, normal(0.01) upsampling and strided noise-conv
    kernels (flax's inits there), zero biases."""
    gen = init_module_(NSFHiFiGANGenerator(**generator_kwargs), generator)
    with torch.no_grad():
        for name, m in gen.named_modules():
            if isinstance(m, nn.ConvTranspose1d) or (
                    name.startswith("noise_convs_")
                    and isinstance(m, nn.Conv1d)):
                m.weight.copy_(_normal(m.weight.shape, 0.01, generator))
                m.bias.zero_()
    return gen.state_dict()
