"""The JAX package's host (numpy) DSP, without JAX.

`ns2vc_tpu/audio/__init__.py` imports its mel and resample modules, which
import jax, so `import ns2vc_tpu.audio.f0` would pull JAX in. The numpy-only
files are loaded here by path instead (`importlib.util.spec_from_file_location`),
so that package `__init__` never runs and one copy of the DSP serves both
packages:

    f0.py        compute_f0_dio, interpolate_f0, resize_f0
    pitch_ac.py  compute_f0_ac (the parselmouth-equivalent AC tracker)
    slicer.py    Slicer
    wavio.py     read_wav, write_wav

Their own lazy imports (`ns2vc_tpu.native`, the ctypes DIO) are jax-free.
`repeat_expand_2d` is a copy of `ns2vc_tpu/data/dataset.py:102-115`, whose
module imports the audio package.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np

_JAX_PKG = Path(__file__).resolve().parents[2] / "ns2vc_tpu"


def _load(rel: str):
    name = "ns2vc_tpu_torch.audio._host_" + Path(rel).stem
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, _JAX_PKG / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_f0 = _load("audio/f0.py")
_pitch_ac = _load("audio/pitch_ac.py")
_slicer = _load("audio/slicer.py")
_wavio = _load("utils/wavio.py")

compute_f0_dio = _f0.compute_f0_dio
interpolate_f0 = _f0.interpolate_f0
resize_f0 = _f0.resize_f0
compute_f0_ac = _pitch_ac.compute_f0_ac
Slicer = _slicer.Slicer
read_wav = _wavio.read_wav
write_wav = _wavio.write_wav


def repeat_expand_2d(content: np.ndarray, target_len: int) -> np.ndarray:
    """Nearest-neighbour frame-rate expansion, time-major: content
    (T_src, C) -> (target_len, C), idx[i] = max j with j*target/src <= i."""
    src_len = content.shape[0]
    pos = np.arange(src_len) * target_len / src_len
    idx = np.searchsorted(pos, np.arange(target_len), side="right") - 1
    np.maximum(idx, 0, out=idx)
    return content[idx]
