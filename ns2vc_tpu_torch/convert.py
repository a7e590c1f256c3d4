"""Weights across the frameworks, and a seeded initialiser.

`from_flax` maps the JAX package's parameter tree (nested dicts of numpy
arrays, as `NaturalSpeech2.init` makes them) onto the port's modules, whose
submodule names follow the flax paths. Leaf rules:

    Dense kernel (in, out)            -> Linear weight (out, in)
    Conv kernel (K, Cin, Cout)        -> Conv1d weight (Cout, Cin, K)
    depthwise kernel (K, 1, C)        -> Conv1d weight (C, 1, K)
    DenseGeneral in_proj (C, 3, C)    -> Linear weight (3C, C)
    norm scale                        -> weight
    UNet self-attention to_q/to_k/to_v kernels -> one fused to_qkv weight
    bias, positional_embedding, gamma -> as they are

The mapping is strict: a leaf that no port parameter takes, a port
parameter that no leaf fills, or a shape that disagrees raises.

`init_params` draws a state dict from a `torch.Generator` in flax's
initialiser families (lecun-normal kernels, zero biases, unit norms, the
encoders' conv init, normal(embed^-0.5) pooling positions, Vocos layer
scale 1/num_layers), so activations at full width sit on the JAX model's
scale. The values are not those `jax.random` would give.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ns2vc_tpu.config import Config
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
from ns2vc_tpu_torch.models.encoders import AttentionPooling, LNConv
from ns2vc_tpu_torch.models.vocos import ConvNeXtBlock, Vocos

_QKV = ("to_q", "to_k", "to_v")


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
        name = "weight"
    elif name == "scale":
        name = "weight"
    return ".".join(mods + [name]), arr


def from_flax_tree(tree: dict, module: nn.Module) -> dict:
    """Strictly map a flax parameter tree onto `module`'s state dict keys."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    sd = {}
    # fused self-attention projections: concat (C, inner) kernels along out
    for key in expected:
        if key.endswith(".to_qkv.weight"):
            base = tuple(key[:-len(".to_qkv.weight")].split("."))
            parts = [flat.pop(base + (n, "kernel"), None) for n in _QKV]
            if any(p is None for p in parts):
                raise ValueError(f"from_flax: missing {'/'.join(base)}/"
                                 f"to_q|to_k|to_v kernels for {key}")
            sd[key] = np.concatenate(parts, axis=1).T
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


def vocos_from_flax(params_np: dict, **vocos_kwargs) -> dict:
    """Vocos flax params -> the port's Vocos state dict; `vocos_kwargs` are
    the Vocos hyperparameters (defaults: the 24 kHz, 100-mel model)."""
    return from_flax_tree(params_np, _skeleton(lambda: Vocos(**vocos_kwargs)))


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
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            w = m.weight
            fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
            w.copy_(_lecun_normal(w.shape, fan_in, generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in module.modules():
        if isinstance(m, LNConv):
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
