"""The port stands alone: nothing of `ns2vc_tpu`, JAX or flax is imported
or loaded by path by any module of `ns2vc_tpu_torch/`, by `chip_smoke.py`
or by the port's scripts (`scripts/torch_*.py`).

Two checks: every source file's imports, read with `ast` (one case per
file); and a copy of the package, the smoke script and the port's scripts
alone in an empty directory, imported (every subpackage, with every public
name resolved, building nothing) and run (config, the AC and numpy DIO F0
trackers, the Slicer) in a fresh interpreter that refuses to import
`ns2vc_tpu`, `jax` or `flax`.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in
                 (ROOT / "ns2vc_tpu_torch").rglob("*.py")
                 if "_build" not in p.parts) + ["chip_smoke.py"] + sorted(
    p.relative_to(ROOT).as_posix() for p in
    (ROOT / "scripts").glob("torch_*.py"))
SUBPACKAGES = sorted(p.parent.name for p in
                     (ROOT / "ns2vc_tpu_torch").glob("*/__init__.py"))
FORBIDDEN = ("ns2vc_tpu", "jax", "jaxlib", "flax")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("rel", SOURCES)
def test_source_imports_nothing_of_the_jax_package(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Attribute) and \
                node.attr == "spec_from_file_location":
            bad.append("importlib.util.spec_from_file_location")
        elif isinstance(node, ast.Name) and node.id == "spec_from_file_location":
            bad.append("spec_from_file_location")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                _forbidden(node.args[0].value):
            bad.append(node.args[0].value)
    assert not bad, f"{rel}: {bad}"


def test_sources_cover_the_package():
    assert "ns2vc_tpu_torch/config.py" in SOURCES
    assert "ns2vc_tpu_torch/native/__init__.py" in SOURCES
    assert "ns2vc_tpu_torch/train/trainer.py" in SOURCES
    assert "ns2vc_tpu_torch/data/preprocess.py" in SOURCES
    for rel in ("ops/sequence.py", "diffusion/wrappers.py", "models/lora.py",
                "models/op_registry.py", "models/nsf_hifigan.py"):
        assert f"ns2vc_tpu_torch/{rel}" in SOURCES
    for script in ("torch_reconstruct_nsf.py", "torch_f32_routes.py",
                   "torch_f0_grad_precision.py"):
        assert f"scripts/{script}" in SOURCES
    for rel in ("parallel/mesh.py", "utils/plotting.py"):
        assert f"ns2vc_tpu_torch/{rel}" in SOURCES
    for script in ("torch_convert_checkpoint.py", "torch_mix_models.py"):
        assert f"scripts/{script}" in SOURCES
    assert len(SOURCES) >= 56
    assert len(SUBPACKAGES) == 11


_ALONE = """
import importlib.abc, pathlib, sys
here = pathlib.Path.cwd().resolve()

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {forbidden!r}:
            raise ImportError(f'{{name}} is refused: the port stands alone')
        return None

sys.meta_path.insert(0, Refuse())
import importlib
import numpy as np
import ns2vc_tpu_torch, chip_smoke
for pkg in {subpackages!r}:
    mod = importlib.import_module(f'ns2vc_tpu_torch.{{pkg}}')
    for name in mod.__all__:
        getattr(mod, name)
sys.path.insert(0, str(here / 'scripts'))
import torch_reconstruct_nsf, torch_convert_checkpoint, torch_mix_models
import ns2vc_tpu_torch.models.nsf_hifigan
assert not (here / 'ns2vc_tpu_torch' / '_build').exists(), 'import built'
import ns2vc_tpu_torch.convert, ns2vc_tpu_torch.infer.cli
import ns2vc_tpu_torch.infer.serve, ns2vc_tpu_torch.ops.fused_resnet
import ns2vc_tpu_torch.data.dataset, ns2vc_tpu_torch.data.preprocess
import ns2vc_tpu_torch.train.trainer, ns2vc_tpu_torch.train.cli
import ns2vc_tpu_torch.utils.checkpoints, ns2vc_tpu_torch.utils.logger
import ns2vc_tpu_torch.ops.sequence, ns2vc_tpu_torch.diffusion.wrappers
import ns2vc_tpu_torch.models.lora, ns2vc_tpu_torch.models.op_registry
import ns2vc_tpu_torch.parallel.mesh, ns2vc_tpu_torch.utils.plotting
from ns2vc_tpu_torch.audio.host import (
    Slicer, compute_f0_ac, compute_f0_dio, interpolate_f0)
from ns2vc_tpu_torch.config import Config, load_config
assert pathlib.Path(ns2vc_tpu_torch.__file__).resolve().is_relative_to(here)
assert pathlib.Path(chip_smoke.__file__).resolve().is_relative_to(here)
cfg = Config()
assert cfg.data.hop_length == 256 and load_config(None) == cfg
sr = 24000
t = np.arange(sr) / sr
x = 0.3 * np.sin(2 * np.pi * 200 * t)
x = np.concatenate([x, np.zeros(sr // 2), x]).astype(np.float32)
ac = compute_f0_ac(x, sr, 256)
dio = compute_f0_dio(x, sampling_rate=sr, hop_length=256, use_native=False)
for f0 in (ac, dio):
    assert abs(np.median(f0[f0 > 0]) - 200) < 5, np.median(f0[f0 > 0])
f0i, uv = interpolate_f0(dio)
assert (f0i > 0).all() and uv.sum() > 0
chunks = Slicer(sr=sr, threshold=-40.0, min_length=500, min_interval=300,
                hop_size=20, max_sil_kept=500).slice(x)
assert len(chunks) >= 2, chunks
print('alone ok')
"""


def test_package_and_smoke_run_alone(tmp_path):
    """ns2vc_tpu_torch/, chip_smoke.py and scripts/torch_*.py copied alone
    into an empty directory import and run with ns2vc_tpu, jax and flax
    refused; importing every subpackage and resolving its names builds
    nothing."""
    shutil.copytree(ROOT / "ns2vc_tpu_torch", tmp_path / "ns2vc_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    (tmp_path / "scripts").mkdir()
    for script in (ROOT / "scripts").glob("torch_*.py"):
        shutil.copy(script, tmp_path / "scripts")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _ALONE.format(forbidden=set(FORBIDDEN),
                                             subpackages=SUBPACKAGES)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("alone ok")
