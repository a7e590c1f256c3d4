"""LoRA adapters for fine-tuning (counterpart of ns2vc_tpu/models/lora.py).

A LoRA tree maps a Linear weight's state-dict name to its low-rank factors
{"down": (in, rank), "up": (rank, out)}, the JAX package's layout, so that
`lora_from_flax` only renames keys. Merging adds scale * (down @ up), an
(in, out) delta, transposed onto the port's (out, in) weight.

The UNet's self-attention keeps to_q, to_k and to_v in one fused `to_qkv`
weight (3 inner, C); a tree names them as the JAX tree does ("...attn1.
to_q.weight"), and `apply_lora` adds each delta to its rows of the fused
weight.

    lora = init_lora(model.state_dict(), torch.Generator().manual_seed(0))
    merged = apply_lora(model.state_dict(), lora, scale=1.0)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_FUSED = ("to_q", "to_k", "to_v")
DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out_0")


def _fused_part(name: str, params: dict) -> tuple[str, int] | None:
    """(fused weight name, part index) when `name` is one third of a fused
    to_qkv weight in params, else None."""
    base, _, leaf = name.rpartition(".")
    mod, _, part = base.rpartition(".")
    fused = f"{mod}.to_qkv.{leaf}"
    if leaf == "weight" and part in _FUSED and fused in params:
        return fused, _FUSED.index(part)
    return None


def _target_weights(params: dict, targets: Sequence[str]) -> dict:
    """{LoRA key: (in, out, dtype)} of every 2-D weight whose module name
    contains a target, as the JAX `_is_target` matches kernels; a fused
    to_qkv weight yields its parts that are targets."""
    out = {}
    for name, w in params.items():
        mod, _, leaf = name.rpartition(".")
        if leaf != "weight" or w.dim() != 2:
            continue
        module = mod.rpartition(".")[2]
        if module == "to_qkv":
            inner = w.shape[0] // 3
            for part in _FUSED:
                if any(t in part for t in targets):
                    out[f"{mod[:-len('to_qkv')]}{part}.weight"] = (
                        w.shape[1], inner, w.dtype)
        elif any(t in module for t in targets):
            out[name] = (w.shape[1], w.shape[0], w.dtype)
    return out


def init_lora(params: dict, generator: torch.Generator, rank: int = 4,
              targets: Sequence[str] = DEFAULT_TARGETS) -> dict:
    """A LoRA tree over `params` (a state dict): for each targeted weight,
    down (in, rank) ~ N(0, 1/rank) and up (rank, out) zeros, so the merged
    weights start equal to the base ones."""
    lora = {}
    for name, (d_in, d_out, dtype) in sorted(
            _target_weights(params, targets).items()):
        lora[name] = {
            "down": torch.randn((d_in, rank), generator=generator,
                                dtype=dtype) / rank ** 0.5,
            "up": torch.zeros((rank, d_out), dtype=dtype)}
    return lora


def apply_lora(params: dict, lora: dict, scale: float = 1.0) -> dict:
    """A copy of `params` with every LoRA delta merged:
    W' = W + scale * (down @ up)^T on the (out, in) weight (its rows of a
    fused to_qkv weight). Raises for a key that names no weight."""
    out = dict(params)
    for name, ab in lora.items():
        fused = None if name in params else _fused_part(name, params)
        if name not in params and fused is None:
            raise KeyError(f"apply_lora: {name} names no weight")
        key = name if fused is None else fused[0]
        w = out[key]
        delta = (scale * (ab["down"] @ ab["up"])).T.to(w.device, w.dtype)
        if fused is None:
            out[key] = w + delta
        else:
            rows = delta.shape[0]
            i = fused[1]
            out[key] = torch.cat([w[:i * rows], w[i * rows:(i + 1) * rows]
                                  + delta, w[(i + 1) * rows:]])
    return out


def count_lora_params(lora: dict) -> int:
    return sum(t.numel() for ab in lora.values() for t in ab.values())


def lora_from_flax(lora: dict) -> dict:
    """A JAX LoRA tree (keys `jax.tree_util.keystr` paths of the flax
    params, "['params'][...]['kernel']") -> the port's tree; the factors
    keep their layout."""
    out = {}
    for key, ab in lora.items():
        path = [p.strip("'\"") for p in key.strip("[]").split("][")]
        if path and path[0] == "params":
            path = path[1:]
        if path[-1] != "kernel":
            raise ValueError(f"lora_from_flax: {key} is not a kernel")
        name = ".".join(path[:-1] + ["weight"])
        out[name] = {k: torch.tensor(np.asarray(v, np.float32))
                     for k, v in ab.items()}
    return out
