# The port's copy of ns2vc_tpu/utils/plotting.py: the port imports nothing of the JAX package.
"""Matplotlib-Agg pictures of spectrograms and curves as HWC uint8 arrays
(reference utils.py:331-383); matplotlib is imported at the first call."""

from __future__ import annotations

import numpy as np


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """(n_mels, T) -> HWC uint8 RGB image (reference utils.py:331-354)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pylab as plt

    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(np.asarray(spectrogram), aspect="auto", origin="lower",
                   interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return data


def plot_data_to_numpy(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Two curves -> HWC image (reference utils.py:96-116, used for F0)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pylab as plt

    fig, ax = plt.subplots(figsize=(10, 2))
    plt.plot(x)
    plt.plot(y)
    plt.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return data


def plot_alignment_to_numpy(alignment: np.ndarray, info: str | None = None
                            ) -> np.ndarray:
    """(T_dec, T_enc) alignment matrix -> HWC image (reference
    utils.py:357-383; TTS-branch attention/duration visualizer)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pylab as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(np.asarray(alignment).T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    xlabel = "Decoder timestep"
    if info is not None:
        xlabel += "\n\n" + info
    plt.xlabel(xlabel)
    plt.ylabel("Encoder timestep")
    plt.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return data


def write_png(path: str, image: np.ndarray) -> str:
    """An HWC uint8 image (as the functions above return) -> a PNG file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.image

    matplotlib.image.imsave(path, image)
    return path
