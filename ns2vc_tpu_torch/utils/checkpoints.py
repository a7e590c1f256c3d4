"""Checkpoint utilities over state dicts (counterpart of
ns2vc_tpu/utils/checkpoints.py, which works on flax parameter trees).

- `mix_models`: weight-space mixing (reference utils.py:499-510);
- `partial_restore`: a shape-tolerant restore that keeps the target's value
  where a saved tensor's shape disagrees or it is missing (reference
  utils.py:247-277);
- `latest_checkpoint_path`: the newest checkpoint by step (reference
  utils.py:323-328).
The trainer's own garbage collection of old checkpoints (`keep_ckpts`) is
in train/trainer.py.
"""

from __future__ import annotations

import os
import re
from typing import Sequence


def mix_models(state_dicts: Sequence[dict], ratios: Sequence[float]) -> dict:
    """sum_i ratios[i] * state_dicts[i], key by key; floating tensors are
    mixed in f32 and cast back, other tensors come from the first."""
    if not state_dicts or len(state_dicts) != len(ratios):
        raise ValueError("mix_models: one ratio per state dict, at least one")
    out = {}
    for key, first in state_dicts[0].items():
        if not first.is_floating_point():
            out[key] = first
            continue
        acc = first.float() * float(ratios[0])
        for sd, r in zip(state_dicts[1:], ratios[1:]):
            acc = acc + sd[key].float() * float(r)
        out[key] = acc.to(first.dtype)
    return out


def partial_restore(target: dict, restored: dict, verbose: bool = True
                    ) -> dict:
    """`target` with each entry replaced by `restored`'s where that exists
    with the same shape; mismatched or missing entries keep the target's
    value (and are reported when `verbose`)."""
    out = {}
    for key, value in target.items():
        new = restored.get(key)
        if new is not None and tuple(new.shape) == tuple(value.shape):
            out[key] = new
            continue
        if verbose:
            if new is None:
                print(f"partial_restore: missing {key}, keeping target")
            else:
                print(f"partial_restore: shape mismatch at {key}: "
                      f"{tuple(new.shape)} vs {tuple(value.shape)}, keeping "
                      f"target")
        out[key] = value
    return out


def latest_checkpoint_path(dir_path: str, regex: str = r"model-(\d+)"
                           ) -> str | None:
    """The highest-step checkpoint path under dir_path (names matching
    `regex`, or bare step numbers), or None."""
    best_step, best = -1, None
    if not os.path.isdir(dir_path):
        return None
    for name in os.listdir(dir_path):
        m = re.match(regex, name) or re.fullmatch(r"(\d+)", name)
        if m:
            step = int(m.group(1))
            if step > best_step:
                best_step, best = step, os.path.join(dir_path, name)
    return best
