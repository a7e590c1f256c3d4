# The port's copy of ns2vc_tpu/native/__init__.py: the port imports nothing of the JAX package.
"""Native (C++) host DSP ops with ctypes bindings.

`dio.cc` implements the DIO+StoneMask F0 estimator (the preprocess hot
loop — the role pyworld's C++ fills for the reference, utils.py:182-195).
The library is built on demand with g++; `compute_f0_dio` in audio/f0.py
uses it automatically when available and falls back to the NumPy
implementation otherwise (identical algorithm, validated against each
other and against the checked-in pyworld goldens).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

__all__ = ["build", "available", "dio", "stonemask"]

_DIR = os.path.dirname(os.path.abspath(__file__))
# the port's gitignored build directory, shared with ops/_build.py
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_lib = None
_load_failed = False

# Portable default (-O3, no ISA-specific codegen); opt into native tuning
# with NS2VC_NATIVE_CFLAGS="-march=native" where the .so never leaves the
# build host.
_CFLAGS = os.environ.get("NS2VC_NATIVE_CFLAGS", "-O3").split()


def _stamp_value(src: str) -> str:
    """Cache key: source hash + flags + host arch. A .so from a different
    machine/arch (or stale flags) never loads — it rebuilds instead."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CFLAGS).encode())
    h.update(platform.machine().encode())
    return h.hexdigest()


def build(force: bool = False) -> str | None:
    """Compile dio.cc into `ns2vc_tpu_torch/_build/libns2vc_dsp_<hash>.so`
    (written to a temporary name and renamed, so concurrent builds never
    load a half-written file). Returns the path or None."""
    src = os.path.join(_DIR, "dio.cc")
    so = os.path.join(_BUILD_DIR,
                      f"libns2vc_dsp_{_stamp_value(src)[:16]}.so")
    if os.path.exists(so) and not force:
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", *_CFLAGS, "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-o", tmp, src],
            check=True, capture_output=True, text=True)
        os.replace(tmp, so)
        return so
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        msg = getattr(e, "stderr", str(e))
        print(f"ns2vc_tpu_torch.native: build failed, using NumPy "
              f"fallback:\n{msg}")
        return None


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    path = build()
    if path is None:
        _load_failed = True
        return None
    lib = ctypes.CDLL(path)
    lib.ns2vc_dio.restype = ctypes.c_int
    lib.ns2vc_dio.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    lib.ns2vc_stonemask.restype = ctypes.c_int
    lib.ns2vc_stonemask.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def dio(x: np.ndarray, fs: int, f0_floor: float = 71.0,
        f0_ceil: float = 800.0, channels_in_octave: float = 2.0,
        frame_period: float = 10.0, allowed_range: float = 0.1):
    """Native DIO. Returns (f0, temporal_positions)."""
    lib = _load()
    assert lib is not None
    x = np.ascontiguousarray(x, dtype=np.float64)
    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    f0 = np.zeros(n_frames, np.float64)
    ret = lib.ns2vc_dio(_ptr(x), len(x), fs, f0_floor, f0_ceil,
                        channels_in_octave, frame_period, allowed_range,
                        _ptr(f0), n_frames)
    assert ret == n_frames, ret
    positions = np.arange(n_frames) * frame_period / 1000.0
    return f0, positions


def stonemask(x: np.ndarray, f0: np.ndarray, positions: np.ndarray, fs: int,
              f0_floor: float = 40.0, f0_ceil: float = 1100.0) -> np.ndarray:
    lib = _load()
    assert lib is not None
    x = np.ascontiguousarray(x, dtype=np.float64)
    f0 = np.ascontiguousarray(f0, dtype=np.float64)
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    out = np.zeros(len(f0), np.float64)
    lib.ns2vc_stonemask(_ptr(x), len(x), fs, _ptr(f0), _ptr(positions),
                        len(f0), f0_floor, f0_ceil, _ptr(out))
    return out
