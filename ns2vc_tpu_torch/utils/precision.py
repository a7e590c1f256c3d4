"""Mixed-precision policy (counterpart of ns2vc_tpu/utils/precision.py).

Serving in bf16 casts the parameters and activations to bfloat16 while:
- LayerNorm / GroupNorm compute their statistics in f32 (torch does so for
  bf16 inputs on CUDA, as flax forces f32 reductions),
- attention logits and softmax run in f32 (K1 and its plain version),
- the K2 wrapper computes the GroupNorm statistics and the folded affine in
  f32,
- the timestep embedding, the sampler constants and the iSTFT synthesis
  stay f32.

Training keeps f32 master parameters and runs its forward on bf16 copies
of them (`cast_floating` + `parameters_as`), as the JAX trainer casts its
parameter tree inside the loss: the gradients reach the masters through the
casts. `torch.autocast` is not used: it would leave mixed dtypes at the
kernels' inputs.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_dtype(name: str | torch.dtype | None) -> torch.dtype:
    """'bfloat16' | 'float32' | a torch dtype | None (float32)."""
    if name is None:
        return torch.float32
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return _DTYPES[name]


def cast_floating(tensors: dict, dtype: torch.dtype) -> dict:
    """Cast the floating-point values of a {name: tensor} dict to `dtype`,
    leaving integer and bool tensors alone. The casts stay differentiable:
    a gradient taken through a cast reaches the tensor it was cast from."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tensors.items()}


@contextlib.contextmanager
def parameters_as(module: nn.Module, tensors: dict):
    """Within the context, `module`'s submodules read the given tensors
    ({parameter name: tensor}, e.g. `cast_floating` of its named
    parameters) in place of their parameters, while `named_parameters()`
    still lists the masters. Keep the backward pass inside the context when
    the forward was checkpointed: its recomputation reads the parameters
    again."""
    installed = []
    try:
        for name, value in tensors.items():
            owner, _, attr = name.rpartition(".")
            sub = module.get_submodule(owner)
            if attr not in sub._parameters:
                raise KeyError(f"parameters_as: {name} is not a parameter")
            # an instance attribute shadows nn.Module.__getattr__'s lookup
            # of _parameters; the master stays registered
            sub.__dict__[attr] = value
            installed.append((sub, attr))
        yield module
    finally:
        for sub, attr in installed:
            del sub.__dict__[attr]
