# The port's copy of ns2vc_tpu/utils/logger.py: the port imports nothing of the JAX package.
"""File logger (reference get_logger, utils.py:467-479)."""

from __future__ import annotations

import logging
import os


def get_logger(model_dir: str, filename: str = "train.log") -> logging.Logger:
    logger = logging.getLogger(os.path.basename(model_dir))
    logger.setLevel(logging.DEBUG)
    formatter = logging.Formatter(
        "%(asctime)s\t%(name)s\t%(levelname)s\t%(message)s")
    os.makedirs(model_dir, exist_ok=True)
    if not logger.handlers:
        h = logging.FileHandler(os.path.join(model_dir, filename))
        h.setLevel(logging.DEBUG)
        h.setFormatter(formatter)
        logger.addHandler(h)
    return logger
