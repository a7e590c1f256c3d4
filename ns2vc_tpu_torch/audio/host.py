"""The host (numpy) DSP that the port's serving and CLI call, in one place.

The modules are the port's own copies of the JAX package's numpy-only
files, each naming the file it mirrors:

    audio/f0.py        compute_f0_dio, interpolate_f0, resize_f0
    audio/pitch_ac.py  compute_f0_ac (the parselmouth-equivalent AC tracker)
    audio/slicer.py    Slicer
    utils/wavio.py     read_wav, write_wav

`compute_f0_dio` uses the port's C++ DIO (`ns2vc_tpu_torch/native/`, built
by g++ at first use into `ns2vc_tpu_torch/_build/`) when it builds.
`repeat_expand_2d` is a copy of `ns2vc_tpu/data/dataset.py:102-115`.
"""

from __future__ import annotations

import numpy as np

from ns2vc_tpu_torch.audio.f0 import (  # noqa: F401
    compute_f0_dio, interpolate_f0, resize_f0,
)
from ns2vc_tpu_torch.audio.pitch_ac import compute_f0_ac  # noqa: F401
from ns2vc_tpu_torch.audio.slicer import Slicer  # noqa: F401
from ns2vc_tpu_torch.utils.wavio import read_wav, write_wav  # noqa: F401


def repeat_expand_2d(content: np.ndarray, target_len: int) -> np.ndarray:
    """Nearest-neighbour frame-rate expansion, time-major: content
    (T_src, C) -> (target_len, C), idx[i] = max j with j*target/src <= i."""
    src_len = content.shape[0]
    pos = np.arange(src_len) * target_len / src_len
    idx = np.searchsorted(pos, np.arange(target_len), side="right") - 1
    np.maximum(idx, 0, out=idx)
    return content[idx]
