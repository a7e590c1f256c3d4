# The port's copy of ns2vc_tpu/utils/wavio.py: the port imports nothing of the JAX package.
"""Minimal dependency-free WAV I/O (PCM 8/16/24/32 and float32).

The reference leans on torchaudio/librosa/soundfile for file I/O
(preprocess.py:27, infer.py:92, inference/infer_tool.py:143); here we read
RIFF/WAVE directly with the stdlib + numpy so the framework has no audio-IO
dependency at all.
"""

from __future__ import annotations

import struct
import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples in [-1, 1] shaped (C, N) for
    multichannel or (N,) for mono, sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE and len(data) > 0:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1  # assume PCM subformat
    if audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif audio_format == 1:
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            vals = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels).T
    return x, sample_rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int,
              subtype: str = "PCM_16") -> None:
    """Write float samples in [-1, 1]; (N,) mono or (C, N) multichannel."""
    x = np.asarray(samples, dtype=np.float32)
    if x.ndim == 2:
        channels = x.shape[0]
        interleaved = x.T.reshape(-1)
    else:
        channels = 1
        interleaved = x
    if subtype == "FLOAT":
        payload = interleaved.astype("<f4").tobytes()
        fmt_code, bits = 3, 32
    elif subtype == "PCM_16":
        clipped = np.clip(interleaved, -1.0, 1.0)
        payload = (clipped * 32767.0).astype("<i2").tobytes()
        fmt_code, bits = 1, 16
    else:
        raise ValueError(f"unsupported subtype {subtype}")
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_code, channels, sample_rate,
                            byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
