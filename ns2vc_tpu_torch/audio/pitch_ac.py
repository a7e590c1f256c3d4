# The port's copy of ns2vc_tpu/audio/pitch_ac.py: the port imports nothing of the JAX package.
"""Autocorrelation pitch tracking (Boersma 1993, the algorithm behind
Praat's `to_pitch_ac`).

The reference's *online* F0 default calls praat-parselmouth with
time_step = hop/sr, voicing_threshold=0.6, floor 50 Hz, ceil 1100 Hz and
center-pads the result to the mel frame count (reference utils.py:156-173).
This is a from-scratch NumPy implementation of the published algorithm:
window-normalized autocorrelation candidates with parabolic interpolation
and a Viterbi path over voiced/unvoiced candidates with octave and
transition costs.

Host-side NumPy by design (like the C++ Praat it replaces): frame-level
FFTs on a few hundred frames are microseconds-level work and feed the
device pipeline."""

from __future__ import annotations

import numpy as np

# Praat defaults (ac method)
SILENCE_THRESHOLD = 0.03
OCTAVE_COST = 0.01
OCTAVE_JUMP_COST = 0.35
VOICED_UNVOICED_COST = 0.14
MAX_CANDIDATES = 15
PERIODS_PER_WINDOW = 3.0
SINC_DEPTH = 70  # Praat's NUM_PEAK_INTERPOLATE_SINC70 half-width


def _sinc_interp(r: np.ndarray, x: np.ndarray,
                 depth: int = SINC_DEPTH) -> np.ndarray:
    """Windowed-sinc interpolation of the sampled sequence `r` at
    fractional positions `x` (Boersma's NUM_interpolate_sinc: a sinc
    kernel tapered by a raised cosine over `depth` samples each side —
    Praat refines autocorrelation peaks with this rather than a parabola,
    which matters because the parabola systematically flattens sharp
    normalized-ac maxima and biases the period estimate)."""
    x = np.asarray(x, np.float64)
    base = np.floor(x).astype(np.int64)
    ks = base[:, None] + np.arange(-depth + 1, depth + 1)[None, :]
    valid = (ks >= 0) & (ks < len(r))
    d = x[:, None] - ks  # signed distance, in (-depth, depth]
    taper = 0.5 + 0.5 * np.cos(np.pi * d / (depth + 0.5))
    vals = np.where(valid, r[np.clip(ks, 0, len(r) - 1)], 0.0)
    return np.sum(vals * np.sinc(d) * np.maximum(taper, 0.0), axis=1)


def _refine_peaks(r: np.ndarray, lags: np.ndarray):
    """Maximize the sinc-interpolated autocorrelation near each integer
    lag (vectorized over candidates): a parabolic seed from the integer
    samples, a 9-point sinc grid (+-0.25 samples) around the seed, then a
    parabolic step on that grid — ~1e-3-sample accuracy, equivalent to
    Praat's Brent search on the same interpolant. Returns (lag_f, value)
    arrays."""
    a0, b0, c0 = r[lags - 1], r[lags], r[lags + 1]
    denom = a0 - 2 * b0 + c0
    seed = np.where(np.abs(denom) > 1e-12,
                    0.5 * (a0 - c0) / np.where(np.abs(denom) > 1e-12,
                                               denom, 1.0), 0.0)
    seed = lags + np.clip(seed, -0.5, 0.5)
    step = 0.0625
    offs = np.arange(-4, 5) * step
    grid = seed[:, None] + offs[None, :]          # (n_cand, 9)
    vals = _sinc_interp(r, grid.ravel()).reshape(grid.shape)
    j = np.clip(np.argmax(vals, axis=1), 1, grid.shape[1] - 2)
    rows = np.arange(len(lags))
    a, b, c = vals[rows, j - 1], vals[rows, j], vals[rows, j + 1]
    denom = a - 2 * b + c
    shift = np.where(np.abs(denom) > 1e-12,
                     0.5 * (a - c) / np.where(np.abs(denom) > 1e-12,
                                              denom, 1.0), 0.0)
    shift = np.clip(shift, -1.0, 1.0)
    return grid[rows, j] + shift * step, b - 0.25 * (a - c) * shift


def _frame_candidates(frame: np.ndarray, fs: float, floor: float,
                      ceil: float, global_peak: float,
                      voicing_threshold: float):
    """One analysis frame -> list of (frequency, strength) candidates,
    beginning with the unvoiced candidate (freq 0)."""
    n = len(frame)
    frame = frame - frame.mean()
    local_peak = np.abs(frame).max()

    # Praat's analysis window: w_i = 0.5 - 0.5 cos(2 pi i / (n+1)),
    # i = 1..n (Sound_to_Pitch's Hanning, which skips the zero endpoint)
    window = np.hanning(n + 2)[1 : n + 1]
    x = frame * window
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    # normalized autocorrelation of the windowed signal
    spec = np.fft.rfft(x, nfft)
    r = np.fft.irfft(spec * np.conj(spec))[:n]
    if r[0] <= 0:
        return [(0.0, voicing_threshold + 2.0)], local_peak
    r = r / r[0]
    # divide by the window's own autocorrelation
    wspec = np.fft.rfft(window, nfft)
    rw = np.fft.irfft(wspec * np.conj(wspec))[:n]
    rw = rw / rw[0]
    valid = rw > 1e-6
    rx = np.where(valid, r / np.where(valid, rw, 1.0), 0.0)

    lag_min = max(2, int(np.floor(fs / ceil)))
    lag_max = min(n - 1, int(np.ceil(fs / floor)))
    sl = slice(lag_min + 1, lag_max)
    peaks = np.nonzero((rx[sl] > rx[lag_min : lag_max - 1])
                       & (rx[sl] >= rx[lag_min + 2 : lag_max + 1]))[0] \
        + lag_min + 1
    cands = []
    if len(peaks):
        # rank raw peaks by their parabolic strength and keep the top
        # MAX_CANDIDATES-1 *before* the expensive sinc pass (selection is
        # insensitive to the ~1e-2 refinement delta; refining all ~100
        # raw peaks would cost 10x for nothing)
        if len(peaks) > MAX_CANDIDATES - 1:
            a0, b0, c0 = rx[peaks - 1], rx[peaks], rx[peaks + 1]
            rough = b0 + 0.125 * (a0 - c0) ** 2 / np.maximum(
                np.abs(b0 * 2 - a0 - c0), 1e-12)
            # apply the same octave-cost term the final ranking uses so
            # the pre-cut candidate order matches refining all peaks
            # (without it, a low-lag peak just past the cut could oust a
            # high-lag one the final octave-weighted order would keep)
            rough = rough - OCTAVE_COST * np.log2(floor * peaks / fs)
            peaks = peaks[np.argsort(-rough)[: MAX_CANDIDATES - 1]]
        # sinc-interpolated peak refinement (Praat's improve_maximum with
        # SINC70 + Brent; a plain parabola under-resolves the sharp
        # normalized-ac peak and biases the period)
        lag_f, strengths = _refine_peaks(rx, peaks)
        for lag_i, strength in zip(lag_f, strengths):
            freq = fs / lag_i
            if floor <= freq <= ceil and strength > 0:
                if strength > 1.0:  # Praat: R > 1 folds to 1/R
                    strength = 1.0 / strength
                # octave cost favours higher candidates (Boersma 1993 eq. 23)
                strength -= OCTAVE_COST * np.log2(floor * lag_i / fs)
                cands.append((float(freq), float(strength)))
    cands.sort(key=lambda fc: -fc[1])

    intensity = local_peak / global_peak if global_peak > 0 else 0.0
    # unvoiced candidate strength (Boersma 1993 eq. 22)
    unvoiced_strength = voicing_threshold + max(
        0.0,
        2.0 - intensity / (SILENCE_THRESHOLD / (1.0 + voicing_threshold)))
    return [(0.0, unvoiced_strength)] + cands, local_peak


def _viterbi(frames_cands: list, dt: float):
    """Max-sum path over candidates with Praat's transition costs.
    Praat's path finder defines the octave-jump and voiced/unvoiced costs
    per 10 ms and scales them by 0.01/dt for other time steps
    (Pitch_pathFinder's timeStepCorrection), so a contour's total
    transition cost is invariant to the analysis rate."""
    n = len(frames_cands)
    if n == 0:
        return np.zeros(0)
    tsc = 0.01 / dt if dt > 0 else 1.0
    vuv_cost = VOICED_UNVOICED_COST * tsc
    jump_cost = OCTAVE_JUMP_COST * tsc
    costs = None
    back: list[np.ndarray] = []
    for i, cands in enumerate(frames_cands):
        strengths = np.array([c[1] for c in cands])
        freqs = np.array([c[0] for c in cands])
        if costs is None:
            costs = strengths
            prev_freqs = freqs
            back.append(np.zeros(len(cands), np.int64))
            continue
        trans = np.zeros((len(prev_freqs), len(freqs)))
        for a, fa in enumerate(prev_freqs):
            for b, fb in enumerate(freqs):
                if fa == 0.0 and fb == 0.0:
                    trans[a, b] = 0.0
                elif fa == 0.0 or fb == 0.0:
                    trans[a, b] = vuv_cost
                else:
                    trans[a, b] = jump_cost * abs(np.log2(fa / fb))
        total = costs[:, None] - trans + strengths[None, :]
        back.append(np.argmax(total, axis=0))
        costs = np.max(total, axis=0)
        prev_freqs = freqs

    path = np.zeros(n, np.int64)
    path[-1] = int(np.argmax(costs))
    for i in range(n - 1, 0, -1):
        path[i - 1] = back[i][path[i]]
    return np.array([frames_cands[i][path[i]][0] for i in range(n)])


def compute_f0_ac(wav: np.ndarray, sampling_rate: int, hop_length: int,
                  p_len: int | None = None, f0_min: float = 50.0,
                  f0_max: float = 1100.0,
                  voicing_threshold: float = 0.6) -> np.ndarray:
    """Praat-ac-equivalent F0 contour, padded to p_len like the reference's
    compute_f0_parselmouth (utils.py:156-173)."""
    x = np.asarray(wav, np.float64)
    if p_len is None:
        p_len = x.shape[0] // hop_length
    dt = hop_length / sampling_rate
    win_len = int(round(PERIODS_PER_WINDOW / f0_min * sampling_rate))
    win_len = min(win_len, len(x))
    global_peak = np.abs(x - x.mean()).max()

    # praat centers the analysis span within the signal
    n_frames = int((len(x) - win_len) / (dt * sampling_rate)) + 1
    n_frames = max(n_frames, 0)
    t0 = (len(x) - ((n_frames - 1) * dt * sampling_rate + win_len)) / 2 \
        if n_frames > 0 else 0

    frames_cands = []
    for i in range(n_frames):
        start = int(round(t0 + i * dt * sampling_rate))
        frame = x[start : start + win_len]
        cands, _ = _frame_candidates(frame, sampling_rate, f0_min, f0_max,
                                     global_peak, voicing_threshold)
        frames_cands.append(cands)

    f0 = _viterbi(frames_cands, dt)
    pad = (p_len - len(f0) + 1) // 2
    if pad > 0 or p_len - len(f0) - pad > 0:
        f0 = np.pad(f0, (max(pad, 0), max(p_len - len(f0) - pad, 0)))
    return f0[:p_len]
