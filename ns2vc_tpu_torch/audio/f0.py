# The port's copy of ns2vc_tpu/audio/f0.py: the port imports nothing of the JAX package.
"""F0 extraction and F0 utilities.

`compute_f0_dio` is a from-scratch NumPy implementation of the DIO
fundamental-frequency estimator + StoneMask refinement (M. Morise,
"DIO: a fast and reliable F0 estimator", and the WORLD vocoder paper,
IEICE 2016). The reference calls the pyworld C++ binding with
f0_ceil=800 and frame_period = 1000*hop/sr, rounds to 0.1 Hz, and
nan-interp-resizes to the mel frame count (reference utils.py:182-195,
175-180). This module reproduces that contract; a C++ fast path lives in
ns2vc_tpu_torch/native (same algorithm, used when built).

The small host utilities (`interpolate_f0`, `resize_f0`, `f0_to_coarse`,
`normalize_f0`) match reference utils.py:120-206 semantics exactly,
including edge-case quirks (a trailing unvoiced gap is held at the last
voiced value; a gap ending at the final frame is held rather than
interpolated), since they feed the uv masks used in training.
"""

from __future__ import annotations

import numpy as np

# f0 quantization constants (reference utils.py:25-29)
F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
F0_MEL_MIN = 1127.0 * np.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * np.log(1.0 + F0_MAX / 700.0)

_TINY = 1e-12


# ---------------------------------------------------------------------------
# DIO
# ---------------------------------------------------------------------------

def _nuttall(n: int) -> np.ndarray:
    t = np.arange(n) / (n - 1.0)
    return (0.355768
            - 0.487396 * np.cos(2 * np.pi * t)
            + 0.144232 * np.cos(4 * np.pi * t)
            - 0.012604 * np.cos(6 * np.pi * t))


def _low_cut_filter(x: np.ndarray, fs: float, cutoff: float = 50.0) -> np.ndarray:
    """Linear-phase FIR high-pass (spectral inversion of a hann moving
    average) removing DC/rumble below `cutoff`."""
    n = int(round(fs / cutoff)) * 2 + 1
    lcf = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(1, n + 1) / (n + 1))
    lcf = -lcf / np.sum(lcf)
    lcf[(n - 1) // 2] += 1.0
    y = np.convolve(x, lcf)
    delay = (n - 1) // 2
    return y[delay : delay + len(x)]


def _lowpass(x_spec: np.ndarray, fft_size: int, n: int, half_average_length: int,
             length: int) -> np.ndarray:
    """Low-pass `x` (given as its rfft over fft_size) with a Nuttall window of
    length 4*half_average_length, compensating the group delay."""
    lpf = np.zeros(fft_size)
    win = _nuttall(4 * half_average_length)
    lpf[: len(win)] = win
    lpf_spec = np.fft.rfft(lpf)
    y = np.fft.irfft(x_spec * lpf_spec, fft_size)
    bias = half_average_length * 2
    return y[bias : bias + length]


def _zero_crossing_intervals(y: np.ndarray, fs: float):
    """Negative-going zero-crossing interval f0s and their midpoint times."""
    sign_change = np.nonzero((y[:-1] > 0.0) & (y[1:] <= 0.0))[0]
    if len(sign_change) < 2:
        return np.zeros(0), np.zeros(0)
    i = sign_change.astype(np.float64)
    fine = i + y[sign_change] / (y[sign_change] - y[sign_change + 1])
    locations = (fine[:-1] + fine[1:]) / 2.0 / fs
    intervals = fs / np.diff(fine)
    return intervals, locations


def _four_zero_crossings(y: np.ndarray, fs: float):
    dy = np.diff(y)
    return [
        _zero_crossing_intervals(y, fs),         # negative-going crossings
        _zero_crossing_intervals(-y, fs),        # positive-going crossings
        _zero_crossing_intervals(dy, fs),        # peaks
        _zero_crossing_intervals(-dy, fs),       # dips
    ]


def _interp1(x: np.ndarray, y: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """Linear interpolation with linear extrapolation at the edges
    (matlab interp1 'linear','extrap' — what DIO effectively relies on)."""
    idx = np.clip(np.searchsorted(x, xi) - 1, 0, len(x) - 2)
    x0, x1 = x[idx], x[idx + 1]
    y0, y1 = y[idx], y[idx + 1]
    w = (xi - x0) / np.maximum(x1 - x0, _TINY)
    return y0 + w * (y1 - y0)


def _band_candidate(filtered: np.ndarray, fs: float, boundary_f0: float,
                    f0_floor: float, f0_ceil: float,
                    positions: np.ndarray):
    events = _four_zero_crossings(filtered, fs)
    n = len(positions)
    if any(len(iv) < 2 for iv, _ in events):
        return np.zeros(n), np.full(n, 1e5)
    interp = np.stack([_interp1(loc, iv, positions) for iv, loc in events])
    cand = np.mean(interp, axis=0)
    dev = np.sqrt(np.sum((interp - cand) ** 2, axis=0) / 3.0)
    bad = ((cand > boundary_f0) | (cand < boundary_f0 / 2.0)
           | (cand > f0_ceil) | (cand < f0_floor))
    cand = np.where(bad, 0.0, cand)
    dev = np.where(bad, 1e5, dev)
    return cand, dev


def _fix_step1(f0: np.ndarray, voice_range_minimum: int,
               allowed_range: float) -> np.ndarray:
    out = np.zeros_like(f0)
    prev = np.roll(f0, 1)
    ok = np.abs((f0 - prev) / (f0 + _TINY)) < allowed_range
    out[voice_range_minimum:] = np.where(ok[voice_range_minimum:],
                                         f0[voice_range_minimum:], 0.0)
    return out


def _fix_step2(f0: np.ndarray, voice_range_minimum: int) -> np.ndarray:
    """Erode voiced runs shorter than voice_range_minimum."""
    out = f0.copy()
    center = (voice_range_minimum - 1) // 2
    voiced = f0 > 0
    for i in range(center, len(f0) - center):
        if not np.all(voiced[i - center : i + center + 1]):
            out[i] = 0.0
    out[:center] = 0.0
    out[len(f0) - center :] = 0.0
    return out


def _voiced_sections(f0: np.ndarray):
    v = (f0 > 0).astype(np.int8)
    dv = np.diff(np.concatenate([[0], v, [0]]))
    starts = np.nonzero(dv == 1)[0]
    ends = np.nonzero(dv == -1)[0]  # exclusive
    return list(zip(starts, ends))


def _extend(f0: np.ndarray, candidates: np.ndarray, allowed_range: float,
            forward: bool) -> np.ndarray:
    """FixStep3/4: grow each voiced section by snapping the linear
    extrapolation of its edge to the nearest per-frame band candidate."""
    out = f0.copy()
    n = len(f0)
    sections = _voiced_sections(out)
    if not forward:
        sections = sections[::-1]
    for start, end in sections:
        if forward:
            edge, step, limit = end - 1, 1, n
        else:
            edge, step, limit = start, -1, -1
        if end - start < 2:
            continue
        cur = out[edge]
        slope = out[edge] - out[edge - step]
        i = edge + step
        while i != limit and out[i] == 0.0:
            ref = cur + slope
            cands = candidates[:, i]
            err = np.abs(cands - ref) / (ref + _TINY)
            best = int(np.argmin(err))
            if cands[best] <= 0 or err[best] >= allowed_range:
                break
            out[i] = cands[best]
            slope = out[i] - cur
            cur = out[i]
            i += step
    return out


def dio(
    x: np.ndarray,
    fs: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    channels_in_octave: float = 2.0,
    frame_period: float = 10.0,
    allowed_range: float = 0.1,
):
    """DIO F0 estimation. Returns (f0, temporal_positions).

    Parameters/defaults follow pyworld.dio (the reference passes
    f0_ceil=800, frame_period=1000*hop/sr; utils.py:185-190).
    """
    x = np.asarray(x, dtype=np.float64)
    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    positions = np.arange(n_frames) * frame_period / 1000.0

    y = _low_cut_filter(x, fs, cutoff=50.0)
    fft_size = 1 << int(np.ceil(np.log2(len(y) + int(round(fs / f0_floor * 4)) + 1)))
    y_spec = np.fft.rfft(y, fft_size)

    n_bands = 1 + int(np.log2(f0_ceil / f0_floor) * channels_in_octave)
    boundary_f0s = f0_floor * 2.0 ** ((np.arange(n_bands) + 1) / channels_in_octave)

    cands = np.zeros((n_bands, n_frames))
    scores = np.full((n_bands, n_frames), 1e5)
    for b, bf0 in enumerate(boundary_f0s):
        half_avg = int(round(fs / bf0 / 2.0))
        filtered = _lowpass(y_spec, fft_size, len(y), half_avg, len(y))
        cands[b], scores[b] = _band_candidate(filtered, fs, bf0, f0_floor,
                                              f0_ceil, positions)

    norm_scores = scores / (cands + _TINY)
    best_band = np.argmin(norm_scores, axis=0)
    best_f0 = cands[best_band, np.arange(n_frames)]

    voice_range_minimum = int(0.5 + 1000.0 / frame_period / f0_floor) * 2 + 1
    if n_frames > voice_range_minimum:
        f0 = _fix_step1(best_f0, voice_range_minimum, allowed_range)
        f0 = _fix_step2(f0, voice_range_minimum)
        f0 = _extend(f0, cands, allowed_range, forward=True)
        f0 = _extend(f0, cands, allowed_range, forward=False)
    else:
        f0 = best_f0
    return f0, positions


# ---------------------------------------------------------------------------
# StoneMask
# ---------------------------------------------------------------------------

def _refine_f0_once(x: np.ndarray, fs: int, position: float,
                    f0_initial: float, f0_floor: float,
                    f0_ceil: float) -> float:
    if f0_initial <= 0.0:
        return 0.0
    half_window = int(1.5 * fs / f0_initial + 1.0)
    window_time = (2 * half_window + 1) / fs
    base_time = np.arange(-half_window, half_window + 1) / fs
    fft_size = 1 << int(np.ceil(np.log2(2 * half_window + 1)) + 1)

    index_raw = np.round((position + base_time) * fs + 0.001).astype(np.int64)
    index_time = index_raw / fs
    wt = index_time - position
    main_window = (0.42 + 0.5 * np.cos(2 * np.pi * wt / window_time)
                   + 0.08 * np.cos(4 * np.pi * wt / window_time))
    diff_window = np.zeros_like(main_window)
    diff_window[1:-1] = -(main_window[2:] - main_window[:-2]) / 2.0
    diff_window[0] = -main_window[1] / 2.0
    diff_window[-1] = main_window[-2] / 2.0

    idx = np.clip(index_raw, 0, len(x) - 1)
    seg = x[idx]
    spec = np.fft.rfft(seg * main_window, fft_size)
    diff_spec = np.fft.rfft(seg * diff_window, fft_size)
    power = np.abs(spec) ** 2
    numerator = spec.real * diff_spec.imag - spec.imag * diff_spec.real
    freq_axis = np.arange(len(power)) * fs / fft_size
    inst_freq = freq_axis + numerator / np.maximum(power, _TINY) * fs / (2 * np.pi)

    n_harm = min(int(fs / 2.0 / f0_initial), 6)
    if n_harm < 1:
        return 0.0
    ks = np.arange(1, n_harm + 1)
    bins = np.minimum(np.round(f0_initial * ks * fft_size / fs).astype(np.int64),
                      len(power) - 1)
    amps = np.sqrt(power[bins])
    num = np.sum(amps * inst_freq[bins])
    den = np.sum(amps * ks)
    refined = num / max(den, _TINY)
    if refined < f0_floor or refined > f0_ceil:
        return 0.0
    return refined


def stonemask(x: np.ndarray, f0: np.ndarray, positions: np.ndarray, fs: int,
              f0_floor: float = 40.0, f0_ceil: float = 1100.0) -> np.ndarray:
    """StoneMask F0 refinement (two instantaneous-frequency passes per frame,
    amplitude-weighted over <=6 harmonics). Mirrors pyworld.stonemask's
    contract (reference utils.py:193)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.array(f0, dtype=np.float64)
    for i in range(len(f0)):
        if f0[i] <= 0.0:
            continue
        r1 = _refine_f0_once(x, fs, positions[i], f0[i], f0_floor, f0_ceil)
        r2 = _refine_f0_once(x, fs, positions[i], r1, f0_floor, f0_ceil)
        # keep the initial estimate if refinement drifted implausibly far
        if r2 > 0 and abs(r2 - f0[i]) / f0[i] < 0.2:
            out[i] = r2
        elif r1 > 0 and abs(r1 - f0[i]) / f0[i] < 0.2:
            out[i] = r1
    return out


# ---------------------------------------------------------------------------
# reference-exact host utilities
# ---------------------------------------------------------------------------

def resize_f0(x: np.ndarray, target_len: int) -> np.ndarray:
    """Nearest/linear resize with unvoiced (<1e-3) treated as NaN then zeroed
    (exact port of reference utils.py:175-180 semantics)."""
    source = np.array(x, dtype=np.float64)
    source[source < 0.001] = np.nan
    xi = np.arange(0, len(source) * target_len, len(source)) / target_len
    target = np.interp(xi, np.arange(len(source), dtype=np.float64), source)
    return np.nan_to_num(target)


def compute_f0_dio(wav: np.ndarray, p_len: int | None = None,
                   sampling_rate: int = 44100, hop_length: int = 512,
                   use_native: bool | None = None) -> np.ndarray:
    """DIO + StoneMask + 0.1 Hz rounding + resize, matching the reference's
    offline F0 pipeline (utils.py:182-195). Uses the C++ implementation
    (ns2vc_tpu_torch/native/dio.cc) when built, NumPy otherwise."""
    import os

    wav = np.asarray(wav, dtype=np.float64)
    if p_len is None:
        p_len = wav.shape[0] // hop_length
    frame_period = 1000.0 * hop_length / sampling_rate

    if use_native is None:
        use_native = os.environ.get("NS2VC_NO_NATIVE", "0") != "1"
    native = None
    if use_native:
        try:
            from ns2vc_tpu_torch import native as native_mod

            if native_mod.available():
                native = native_mod
        except Exception:
            native = None

    if native is not None:
        f0, t = native.dio(wav, fs=sampling_rate, f0_ceil=800.0,
                           frame_period=frame_period)
        f0 = native.stonemask(wav, f0, t, sampling_rate)
    else:
        f0, t = dio(wav, fs=sampling_rate, f0_ceil=800.0,
                    frame_period=frame_period)
        f0 = stonemask(wav, f0, t, sampling_rate)
    f0 = np.round(f0, 1)
    return resize_f0(f0, p_len)


def interpolate_f0(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Fill unvoiced gaps and return (interpolated_f0, uv mask).

    Exact port of reference utils.py:120-153 including its edge cases:
    leading gaps take the first voiced value; a gap whose next voiced frame
    is the *final* frame, and trailing gaps, are held at the last voiced
    value; interior gaps interpolate linearly but reach the next voiced
    value one frame early."""
    data = np.asarray(f0, dtype=np.float64).reshape(-1)
    n = data.size
    uv = (data > 0.0).astype(np.float32)
    out = data.copy()

    voiced_idx = np.nonzero(data > 0.0)[0]
    if len(voiced_idx) == 0:
        return out.astype(np.float32), uv

    # Vectorized per unvoiced frame i (no Python loop over frames/gaps —
    # this runs per training item in the loader hot path): with prv/nxt
    # the surrounding voiced indices (-1 / n when absent) and the gap
    # starting at prv+1, the reference's rules reduce to
    #   nxt <  n-1, prv >= 0: data[prv] + (data[nxt]-data[prv])
    #                          / (nxt-prv-1) * (i-prv)   (reaches data[nxt]
    #                          one frame early — denominator nxt-start)
    #   nxt <  n-1, prv <  0: data[nxt]        (leading gap)
    #   else:                 data[prv] or 0.0 (trailing gap, or the next
    #                          voiced frame is the final frame: hold)
    unv = np.nonzero(data <= 0.0)[0]
    if unv.size:
        j = np.searchsorted(voiced_idx, unv)
        has_nxt = j < len(voiced_idx)
        has_prv = j > 0
        nxt = np.where(has_nxt, voiced_idx[np.minimum(j, len(voiced_idx) - 1)], n)
        prv = np.where(has_prv, voiced_idx[np.maximum(j - 1, 0)], -1)
        d_prv = data[np.maximum(prv, 0)]
        d_nxt = data[np.minimum(nxt, n - 1)]
        denom = np.maximum(nxt - prv - 1, 1).astype(np.float64)
        lin = d_prv + (d_nxt - d_prv) / denom * (unv - prv)
        interior = nxt < n - 1
        out[unv] = np.where(
            interior & has_prv, lin,
            np.where(interior, d_nxt, np.where(has_prv, d_prv, 0.0)))
    return out.astype(np.float32), uv


def f0_to_coarse(f0: np.ndarray) -> np.ndarray:
    """256-bin mel-scale F0 quantization (reference utils.py:197-206)."""
    f0 = np.asarray(f0)
    f0_mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) + 1.0
    f0_mel = np.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = np.where(f0_mel <= 1.0, 1.0, f0_mel)
    f0_mel = np.where(f0_mel > F0_BIN - 1, F0_BIN - 1, f0_mel)
    coarse = np.rint(f0_mel).astype(np.int32)
    assert coarse.max() <= 255 and coarse.min() >= 1, (coarse.max(), coarse.min())
    return coarse


def normalize_f0(f0: np.ndarray, uv: np.ndarray, random_scale: bool = True,
                 rng: np.random.Generator | None = None) -> np.ndarray:
    """Masked mean-centering with optional random scale in [0.8, 1.2]
    (reference utils.py:66-80). f0: (B, 1, T), uv: (B, T)."""
    f0 = np.asarray(f0, dtype=np.float32)
    uv = np.asarray(uv, dtype=np.float32)
    uv_sum = np.sum(uv, axis=1, keepdims=True)
    uv_sum[uv_sum == 0] = 9999.0
    means = np.sum(f0[:, 0, :] * uv, axis=1, keepdims=True) / uv_sum
    if random_scale:
        rng = rng or np.random.default_rng()
        factor = rng.uniform(0.8, 1.2, size=(f0.shape[0], 1)).astype(np.float32)
    else:
        factor = np.ones((f0.shape[0], 1), dtype=np.float32)
    f0_norm = (f0 - means[:, None, :]) * factor[:, None, :]
    assert not np.isnan(f0_norm).any()
    return f0_norm
