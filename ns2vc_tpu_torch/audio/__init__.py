"""Audio front end of the port: STFT, log-mel and the inverse STFT,
resampling, the host F0 trackers and their post-processing, the Slicer.

The names are the JAX package's (`ns2vc_tpu.audio.__all__`), loaded at
first use: the data loader's spawned workers import this package for its
numpy-only modules (`f0`, `slicer`) and do not import torch.
"""

import importlib

_FROM = {
    "mel": ("MelSpectrogram", "log_mel_spectrogram", "stft", "istft"),
    "resample": ("Resampler", "resample"),
    "f0": ("compute_f0_dio", "interpolate_f0", "resize_f0", "f0_to_coarse",
           "normalize_f0"),
    "slicer": ("Slicer", "cut", "chunks2audio"),
}
_MODULE = {name: mod for mod, names in _FROM.items() for name in names}
__all__ = list(_MODULE)


def __getattr__(name: str):
    if name in _MODULE:
        return getattr(importlib.import_module(f"{__name__}.{_MODULE[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
