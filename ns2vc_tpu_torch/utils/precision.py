"""Mixed-precision policy (counterpart of ns2vc_tpu/utils/precision.py).

Serving in bf16 casts the parameters and activations to bfloat16 while:
- LayerNorm / GroupNorm compute their statistics in f32 (torch does so for
  bf16 inputs on CUDA, as flax forces f32 reductions),
- attention logits and softmax run in f32 (K1 and its plain version),
- the K2 wrapper computes the GroupNorm statistics and the folded affine in
  f32,
- the timestep embedding, the sampler constants and the iSTFT synthesis
  stay f32.
"""

from __future__ import annotations

import torch

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

