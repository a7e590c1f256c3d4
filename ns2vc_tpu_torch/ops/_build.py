"""Build and bind the port's CUDA kernels.

The sources under `ns2vc_tpu_torch/csrc/` are compiled by `nvcc` for
`sm_90a`, one `nvcc -c` per source, all started together, and linked into
one shared library with a plain C interface, at first use, into
`ns2vc_tpu_torch/_build/` (listed in .gitignore). The library name
carries a hash of the sources and flags, so an edit rebuilds. It is loaded
with ctypes: every pointer and the stream go as `c_void_p`, the kernels
launch on PyTorch's current stream, allocate nothing, and return
`cudaGetLastError()`, which `check` turns into an exception.

Nothing here runs at import time: importing the package never reaches
`nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
# dlopen: hopper.cuh reaches libcuda's tensor-map encoder through it
LINK_FLAGS = ("-ldl",)

# the dtypes the kernels take: f32 (the 3xTF32 kernels) and bf16
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
H100_SMS = 132   # the card the kernels' split planners fill

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "ns2vc_flash_attention_tc_fwd":
        [_P] * 5 + [_I] * 5 + [_I64] * 12 + [ctypes.c_float, _I, _P],
    "ns2vc_flash_attention_wgmma_fwd":
        [_P] * 5 + [_I] * 5 + [_I64] * 12 + [ctypes.c_float, _I, _P],
    "ns2vc_flash_attention_f32_wgmma_fwd":
        [_P] * 5 + [_I] * 5 + [_I64] * 12 + [ctypes.c_float] + [_I] * 3
        + [_P],
    "ns2vc_flash_attention_f32tc_fwd":
        [_P] * 5 + [_I] * 5 + [_I64] * 12 + [ctypes.c_float] + [_I] * 3
        + [_P] * 3,
    "ns2vc_flash_attention_q1_fwd":
        [_P] * 5 + [_I] * 5 + [_I64] * 12 + [ctypes.c_float] + [_I] * 5
        + [_P],
    "ns2vc_flash_attention_bwd_wgmma":
        [_P] * 9 + [_I] * 5 + [_I64] * 21 + [ctypes.c_float, _I, _I, _P],
    "ns2vc_flash_attention_bwd_q1":
        [_P] * 9 + [_I] * 5 + [_I64] * 21 + [ctypes.c_float] + [_I] * 4
        + [_P],
    "ns2vc_flash_attention_bwd_q1_f32":
        [_P] * 9 + [_I] * 5 + [_I64] * 21 + [ctypes.c_float] + [_I] * 4
        + [_P],
    "ns2vc_flash_attention_f32_bwd_wgmma":
        [_P] * 9 + [_I] * 5 + [_I64] * 21 + [ctypes.c_float, _I, _I, _P],
    "ns2vc_affine_silu_conv1d_f32tc": [_P] * 6 + [_I] * 9 + [_P],
    "ns2vc_affine_silu_conv1d_tc": [_P] * 6 + [_I] * 9 + [_P],
    "ns2vc_affine_silu_conv1d_f32_bwd_wgmma": [_P] * 11 + [_I] * 6 + [_P],
    "ns2vc_affine_silu_conv1d_bwd_wgmma": [_P] * 11 + [_I] * 8 + [_P],
    "ns2vc_encode_weight_map": [_P, _I, _I, _P],
    "ns2vc_encode_weight_map_f32": [_P, _I, _I, _P],
    "ns2vc_group_norm_affine":
        [_P] * 5 + [_I] + [_P] * 4 + [_I] * 4 + [ctypes.c_float] + [_I] * 5
        + [_P],
    "ns2vc_group_norm_affine_bwd": [_P] * 5 + [_I] + [_P] * 9 + [_I] * 8
    + [_P],
}


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's output (ptxas register / spill report)


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def build() -> BuildInfo:
    """Compile the kernels if this source hash has no library yet."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libns2vc_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in srcs if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=CSRC_DIR)))
    log, failed = "", None
    for cmd, _, proc in jobs:
        log += proc.communicate()[0]
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if failed is None:
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs],
               *LINK_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = (proc.returncode, cmd)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed is not None:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n"
                           f"{' '.join(failed[1])}\n{log}")
    os.replace(tmp, out)
    return BuildInfo(out, seconds, log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build().path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.ns2vc_cuda_error_string.argtypes = [ctypes.c_int]
                lib.ns2vc_cuda_error_string.restype = ctypes.c_char_p
                _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise for a kernel entry point's nonzero return: a CUDA error, or
    (negative) a tensor map that libcuda's encoder refused."""
    if err < 0:
        why = ("cuTensorMapEncodeTiled not found in libcuda.so.1"
               if err == -1 else f"cuTensorMapEncodeTiled returned CUresult "
               f"{-err - 1000}")
        raise RuntimeError(f"{what}: {why}")
    if err != 0:
        msg = library().ns2vc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned16(t: torch.Tensor) -> bool:
    """Every row of t (unit stride on the last axis) starts on a 16-byte
    boundary and holds whole 16-byte chunks: the kernels may stage it with
    16-byte cp.async copies."""
    per = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] % per == 0
            and all(s % per == 0 for s, n in zip(t.stride()[:-1], t.shape)
                    if n > 1))


def require_current_device(*tensors: torch.Tensor) -> None:
    """Kernels launch on the current device; refuse tensors elsewhere."""
    cur = torch.cuda.current_device()
    for t in tensors:
        if t.device.index != cur:
            raise ValueError(f"tensor on {t.device}, current CUDA device is "
                             f"cuda:{cur}")
