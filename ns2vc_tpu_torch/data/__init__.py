"""Training data: feature datasets, fixed-shape collation, the batch loader
and the offline preprocess driver.

The names are the JAX package's (`ns2vc_tpu.data.__all__`), loaded at
first use: the loader's spawned workers import `data.dataset`, which needs
numpy only, and do not import torch (`preprocess` does).
"""

import importlib

_FROM = {
    "dataset": ("VCDataset", "EvalDataset", "FixedShapeCollator",
                "data_loader"),
    "preprocess": ("preprocess_dataset", "process_one"),
}
_MODULE = {name: mod for mod, names in _FROM.items() for name in names}
__all__ = list(_MODULE)


def __getattr__(name: str):
    if name in _MODULE:
        return getattr(importlib.import_module(f"{__name__}.{_MODULE[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
