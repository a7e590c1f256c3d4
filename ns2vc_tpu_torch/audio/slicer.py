# The port's copy of ns2vc_tpu/audio/slicer.py: the port imports nothing of the JAX package.
"""RMS-threshold silence slicing for long-audio inference.

Host-side NumPy (slicing is not perf-critical; reference uses
librosa.feature.rms — inference/slicer.py:6-142). The chunk-dict format
(`{"slice": bool, "split_time": "start,end"}`) is kept API-compatible so the
infer CLI behaves like the reference's.

Provenance: the hysteresis state machine's *behavioral contract* (the
min_length / min_interval / max_sil_kept split rules and the chunk-dict
output) originates in the MIT-licensed openvpi/audio-slicer project, which
the reference vendors verbatim as inference/slicer.py. This file is an
independent rewrite against that contract (O(N) cumsum RMS frontend, no
librosa), kept branch-compatible so sliced inference splits audio at the
same points as the reference.
"""

from __future__ import annotations

import numpy as np


def _rms_frames(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Centered RMS per frame (librosa.feature.rms semantics: zero pad
    frame_length//2 both sides, frame count = 1 + len//hop)."""
    pad = frame_length // 2
    y = np.pad(y.astype(np.float64), (pad, pad))
    n_frames = 1 + (len(y) - frame_length) // hop_length
    # cumulative-sum based sliding energy: O(N)
    sq = np.concatenate([[0.0], np.cumsum(y * y)])
    starts = np.arange(n_frames) * hop_length
    energy = sq[starts + frame_length] - sq[starts]
    return np.sqrt(energy / frame_length)


class Slicer:
    """Silence-based splitter with min-length / min-interval / max-silence
    hysteresis (same parameters and chunk semantics as reference
    inference/slicer.py:6-117)."""

    def __init__(self, sr: int, threshold: float = -40.0, min_length: int = 5000,
                 min_interval: int = 300, hop_size: int = 20,
                 max_sil_kept: int = 5000):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("min_length >= min_interval >= hop_size required")
        if not max_sil_kept >= hop_size:
            raise ValueError("max_sil_kept >= hop_size required")
        min_interval_samples = sr * min_interval / 1000
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(min_interval_samples), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(min_interval_samples / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)

    def slice(self, waveform: np.ndarray) -> dict:
        samples = waveform.mean(axis=0) if waveform.ndim > 1 else waveform
        if samples.shape[0] <= self.min_length:
            return {"0": {"slice": False, "split_time": f"0,{len(waveform)}"}}
        rms = _rms_frames(samples, self.win_size, self.hop_size)

        sil_tags: list[tuple[int, int]] = []
        silence_start = None
        clip_start = 0
        for i, r in enumerate(rms):
            if r < self.threshold:
                if silence_start is None:
                    silence_start = i
                continue
            if silence_start is None:
                continue
            is_leading = silence_start == 0 and i > self.max_sil_kept
            need_mid = (i - silence_start >= self.min_interval
                        and i - clip_start >= self.min_length)
            if not is_leading and not need_mid:
                silence_start = None
                continue
            if i - silence_start <= self.max_sil_kept:
                pos = int(rms[silence_start : i + 1].argmin()) + silence_start
                if silence_start == 0:
                    sil_tags.append((0, pos))
                else:
                    sil_tags.append((pos, pos))
                clip_start = pos
            elif i - silence_start <= self.max_sil_kept * 2:
                pos = int(rms[i - self.max_sil_kept : silence_start
                              + self.max_sil_kept + 1].argmin())
                pos += i - self.max_sil_kept
                pos_l = (int(rms[silence_start : silence_start
                                 + self.max_sil_kept + 1].argmin()) + silence_start)
                pos_r = (int(rms[i - self.max_sil_kept : i + 1].argmin())
                         + i - self.max_sil_kept)
                if silence_start == 0:
                    sil_tags.append((0, pos_r))
                    clip_start = pos_r
                else:
                    sil_tags.append((min(pos_l, pos), max(pos_r, pos)))
                    clip_start = max(pos_r, pos)
            else:
                pos_l = (int(rms[silence_start : silence_start
                                 + self.max_sil_kept + 1].argmin()) + silence_start)
                pos_r = (int(rms[i - self.max_sil_kept : i + 1].argmin())
                         + i - self.max_sil_kept)
                if silence_start == 0:
                    sil_tags.append((0, pos_r))
                else:
                    sil_tags.append((pos_l, pos_r))
                clip_start = pos_r
            silence_start = None

        total = rms.shape[0]
        if silence_start is not None and total - silence_start >= self.min_interval:
            silence_end = min(total, silence_start + self.max_sil_kept)
            pos = int(rms[silence_start : silence_end + 1].argmin()) + silence_start
            sil_tags.append((pos, total + 1))

        if not sil_tags:
            return {"0": {"slice": False, "split_time": f"0,{len(waveform)}"}}
        chunks = []
        n = waveform.shape[-1] if waveform.ndim > 1 else waveform.shape[0]
        if sil_tags[0][0]:
            chunks.append({"slice": False,
                           "split_time": f"0,{min(n, sil_tags[0][0] * self.hop_size)}"})
        for i in range(len(sil_tags)):
            if i:
                chunks.append({"slice": False,
                               "split_time": f"{sil_tags[i-1][1] * self.hop_size},"
                                             f"{min(n, sil_tags[i][0] * self.hop_size)}"})
            chunks.append({"slice": True,
                           "split_time": f"{sil_tags[i][0] * self.hop_size},"
                                         f"{min(n, sil_tags[i][1] * self.hop_size)}"})
        if sil_tags[-1][1] * self.hop_size < n:
            chunks.append({"slice": False,
                           "split_time": f"{sil_tags[-1][1] * self.hop_size},{n}"})
        return {str(i): c for i, c in enumerate(chunks)}


def cut(audio_path: str, db_thresh: float = -30, min_len: int = 5000) -> dict:
    """Slice an audio file into silence/voiced chunk descriptors
    (reference inference/slicer.py:120-128)."""
    from ns2vc_tpu_torch.utils.wavio import read_wav

    audio, sr = read_wav(audio_path)
    if audio.ndim > 1:
        audio = audio.mean(axis=0)
    return Slicer(sr=sr, threshold=db_thresh, min_length=min_len).slice(audio)


def chunks2audio(audio_path: str, chunks: dict):
    """Materialize chunk descriptors into (is_silence, samples) pairs
    (reference inference/slicer.py:131-142)."""
    from ns2vc_tpu_torch.utils.wavio import read_wav

    audio, sr = read_wav(audio_path)
    if audio.ndim == 2 and audio.shape[0] >= 2:
        audio = audio.mean(axis=0)
    elif audio.ndim == 2:
        audio = audio[0]
    result = []
    for v in dict(chunks).values():
        start, end = (int(t) for t in v["split_time"].split(","))
        if start != end:
            result.append((v["slice"], audio[start:end]))
    return result, sr
