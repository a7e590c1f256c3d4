"""The port's own copies of the JAX package's numpy-only modules against
the originals, on the CPU.

The port imports nothing of `ns2vc_tpu`: it keeps copies of the
configuration, the reference-checkpoint converter, the F0 trackers (AC and
DIO, numpy and the C++ DIO), the Slicer and wav I/O. Each is held here
against the module it mirrors on the same seeded inputs, and must agree
bit for bit (the same code on the same data).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from ns2vc_tpu import config as jconfig
from ns2vc_tpu.audio import f0 as jf0
from ns2vc_tpu.audio import pitch_ac as jpitch
from ns2vc_tpu.audio import slicer as jslicer
from ns2vc_tpu.utils import convert_reference as jcr
from ns2vc_tpu.utils import wavio as jwavio
from ns2vc_tpu_torch import config as pconfig
from ns2vc_tpu_torch.audio import f0 as pf0
from ns2vc_tpu_torch.audio import pitch_ac as ppitch
from ns2vc_tpu_torch.audio import slicer as pslicer
from ns2vc_tpu_torch.utils import convert_reference as pcr
from ns2vc_tpu_torch.utils import wavio as pwavio


def _tone(n, sr, seed, f=200.0):
    """A voiced-like signal with vibrato and noise, and a silent gap."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / sr
    ph = 2 * np.pi * f * t + 2.0 * np.sin(2 * np.pi * 4 * t)
    x = 0.3 * np.sin(ph) + 0.1 * np.sin(2 * ph) + 0.01 * r.standard_normal(n)
    x[n // 3: n // 2] *= 1e-3
    return x.astype(np.float32)


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


def test_config_copy_matches(tmp_path):
    assert dataclasses.asdict(pconfig.Config()) == \
        dataclasses.asdict(jconfig.Config())
    raw = {"train": {"train_batch_size": 8},
           "data": {"hop_length": 320, "sampling_rate": 16000},
           "diffusion_encoder": {"block_out_channels": [16, 24, 32, 40]},
           "phoneme_encoder": {"n_layers": 2}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    got, want = pconfig.load_config(str(path)), jconfig.load_config(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.data.hop_length == 320
    pconfig.save_config(got, str(tmp_path / "saved.json"))
    assert dataclasses.asdict(jconfig.load_config(
        str(tmp_path / "saved.json"))) == dataclasses.asdict(want)


@pytest.mark.parametrize("sr,hop,seed", [(24000, 256, 0), (16000, 320, 1)])
def test_f0_ac_copy_is_bit_equal(sr, hop, seed):
    x = _tone(sr, sr, seed)
    np.testing.assert_array_equal(ppitch.compute_f0_ac(x, sr, hop),
                                  jpitch.compute_f0_ac(x, sr, hop))


@pytest.mark.parametrize("use_native", [False, True])
def test_f0_dio_copy_is_bit_equal(use_native):
    sr, hop = 24000, 256
    x = _tone(sr // 2, sr, 2, f=180.0)
    got = pf0.compute_f0_dio(x, sampling_rate=sr, hop_length=hop,
                             use_native=use_native)
    want = jf0.compute_f0_dio(x, sampling_rate=sr, hop_length=hop,
                              use_native=use_native)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > len(got) // 3


def test_native_dio_builds_in_the_port():
    """The port's DIO library builds from its own source into its own
    build directory, and its DIO and StoneMask give the JAX package's
    native results bit for bit (the same C++ source and flags)."""
    from ns2vc_tpu import native as jnative
    from ns2vc_tpu_torch import native

    path = native.build()
    assert path is not None and "ns2vc_tpu_torch" in path
    assert "/_build/" in path.replace("\\", "/")
    assert jnative.available()
    x = _tone(12000, 24000, 3).astype(np.float64)
    f0, pos = native.dio(x, 24000)
    jf0_, jpos = jnative.dio(x, 24000)
    np.testing.assert_array_equal(f0, jf0_)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(native.stonemask(x, f0, pos, 24000),
                                  jnative.stonemask(x, f0, pos, 24000))


def test_f0_utilities_copy_is_bit_equal():
    r = np.random.default_rng(4)
    f0 = np.abs(200 + 30 * r.standard_normal(97))
    f0[[0, 1, 10, 11, 12, 50, 95, 96]] = 0.0   # leading, interior, trailing
    for got, want in zip(pf0.interpolate_f0(f0), jf0.interpolate_f0(f0)):
        np.testing.assert_array_equal(got, want)
    for n in (50, 97, 211):
        np.testing.assert_array_equal(pf0.resize_f0(f0, n),
                                      jf0.resize_f0(f0, n))


def test_slicer_copy_gives_the_same_chunks():
    sr = 16000
    x = np.concatenate([_tone(sr, sr, 5), np.zeros(sr // 2, np.float32),
                        _tone(sr, sr, 6, 240.0)])
    kw = dict(sr=sr, threshold=-40.0, min_length=500, min_interval=300,
              hop_size=20, max_sil_kept=500)
    got, want = pslicer.Slicer(**kw).slice(x), jslicer.Slicer(**kw).slice(x)
    assert got == want and len(got) >= 2


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
def test_wavio_copy_round_trips_both_ways(tmp_path, subtype):
    x = _tone(4000, 16000, 7)
    stereo = np.stack([x, -x])
    for samples in (x, stereo):
        pwavio.write_wav(str(tmp_path / "p.wav"), samples, 16000, subtype)
        jwavio.write_wav(str(tmp_path / "j.wav"), samples, 16000, subtype)
        assert (tmp_path / "p.wav").read_bytes() == \
            (tmp_path / "j.wav").read_bytes()
        for path in ("p.wav", "j.wav"):
            got, sr = pwavio.read_wav(str(tmp_path / path))
            want, jsr = jwavio.read_wav(str(tmp_path / path))
            assert sr == jsr == 16000
            np.testing.assert_array_equal(got, want)


def _reference_state_dict(n_layers=1, seed=0):
    """A reference-layout NaturalSpeech2 state dict: the keys the JAX
    converter consumes, recorded by running it on a dict that makes each
    key on first access, with a shape its layout takes, then filled with
    seeded values; one resnet gets a 1x1 shortcut."""
    made = {}

    def shape(key):
        parts = key.split(".")
        if key.endswith("in_proj_weight"):
            return (24, 8)
        if parts[-1] == "bias" or "norm" in parts[-2]:
            return (8,)
        if parts[-1] == "positional_embedding":
            return (5, 8)
        if parts[-2] in ("conv1", "conv2", "conv_in", "conv_out", "conv",
                         "proj_in", "proj_out", "spk_proj"):
            return (8, 8, 3)
        return (8, 8)

    class Recorder(jcr.TrackedStateDict):
        def __getitem__(self, key):
            if not dict.__contains__(self, key):
                self[key] = made[key] = np.zeros(shape(key), np.float32)
            return super().__getitem__(key)

    real = jcr.TrackedStateDict
    jcr.TrackedStateDict = Recorder
    try:
        jcr.natural_speech2({}, n_encoder_layers=n_layers, strict=False)
    finally:
        jcr.TrackedStateDict = real
    r = np.random.default_rng(seed)
    sd = {k: torch.from_numpy(r.standard_normal(v.shape).astype(np.float32))
          for k, v in made.items()}
    p = "diff_model.unet.down_blocks.0.resnets.0.conv_shortcut"
    sd[f"{p}.weight"] = torch.from_numpy(
        r.standard_normal((8, 8, 1)).astype(np.float32))
    sd[f"{p}.bias"] = torch.from_numpy(r.standard_normal(8).astype(np.float32))
    sd["betas"] = torch.zeros(4)   # a schedule buffer both converters skip
    return sd


@pytest.mark.parametrize("variant", ["plain", "ddp_prefix", "drifted_key"])
def test_natural_speech2_copy_gives_the_same_tree(variant):
    sd = _reference_state_dict()
    assert len(sd) > 100
    if variant == "ddp_prefix":
        sd = {f"module.{k}": v for k, v in sd.items()}
    if variant == "drifted_key":
        sd["diff_model.unet.renamed_module.weight"] = torch.zeros(2)
        for cr in (pcr, jcr):
            with pytest.raises(ValueError, match="not consumed"):
                cr.natural_speech2(sd, n_encoder_layers=1)
        return
    got = pcr.natural_speech2(sd, n_encoder_layers=1)
    want = jcr.natural_speech2(sd, n_encoder_layers=1)
    _equal_trees(got, want)
    assert "conv_shortcut" in got["diff_model"]["unet"]["down_0_resnet_0"]


def test_tracked_state_dict_copy_reports_the_same_leftovers():
    sd = {"a.weight": 1, "b.weight": 2, "c.num_batches_tracked": 3}
    mine, ref = pcr.TrackedStateDict(sd), jcr.TrackedStateDict(sd)
    for d in (mine, ref):
        _ = d["a.weight"]
        _ = d.get("missing")
    ignore = (r".*\.num_batches_tracked",)
    assert mine.unconsumed(ignore) == ref.unconsumed(ignore) == ["b.weight"]
    with pytest.raises(ValueError, match="b.weight"):
        pcr.assert_fully_consumed(mine, ignore=ignore, context="t")
