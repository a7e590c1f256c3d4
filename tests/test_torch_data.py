"""The port's training data (`ns2vc_tpu_torch/data/`) against the JAX
package's.

Synthetic feature files in the preprocessor's layout stand in for a
processed dataset. The port's numpy copy must give the JAX package's items,
eval pairs and batches bit for bit from the same seeds, through the serial
loader and through the process pool, fixed-shape and bucketed. The port's
preprocess runs on the CPU here (`device="cpu"`) and is held against the
JAX driver on synthesized 24 kHz tones with a seeded tiny ContentVec: the
wav and the F0 bit-equal, the log-mel and the ContentVec features within
1e-3.
"""

import os

import numpy as np
import pytest
import torch

from ns2vc_tpu.config import Config as JConfig, TrainConfig as JTrainConfig
from ns2vc_tpu.data import dataset as jds
from ns2vc_tpu_torch.config import Config, TrainConfig
from ns2vc_tpu_torch.data import dataset as tds
from ns2vc_tpu_torch.utils.wavio import read_wav, write_wav

SPEC_ATOL, SOFT_ATOL = 1e-3, 1e-3
LENGTHS = [40, 56, 64, 48, 36, 60, 44, 20, 90, 52]


def write_features(root, lengths, seed=0, hop=256, audio_rates=None):
    """Utterances in the preprocessor's layout: `<i>/<i>.wav` (a tone at
    the given rate, long enough for T frames at 24 kHz, or an empty
    placeholder), `.spec.npy` (100, T), `.wav.f0.npy` (T,) with unvoiced
    stretches, `.wav.soft.npy` (256, ceil(T/2))."""
    rng = np.random.default_rng(seed)
    for i, t in enumerate(lengths):
        d = os.path.join(root, str(i))
        os.makedirs(d, exist_ok=True)
        wav = os.path.join(d, f"{i}.wav")
        if audio_rates is None:
            open(wav, "wb").close()
        else:
            sr = audio_rates[i % len(audio_rates)]
            n = t * hop * sr // 24000
            write_wav(wav, 0.3 * np.sin(0.05 * np.arange(n)), sr)
        np.save(os.path.join(d, f"{i}.spec.npy"),
                rng.standard_normal((100, t)).astype(np.float32))
        f0 = (np.abs(rng.standard_normal(t)) * 100 + 50).astype(np.float32)
        f0[rng.random(t) < 0.2] = 0.0
        np.save(os.path.join(d, f"{i}.wav.f0.npy"), f0)
        np.save(os.path.join(d, f"{i}.wav.soft.npy"),
                rng.standard_normal((256, (t + 1) // 2)).astype(np.float32))
    return root


def _configs(**train):
    return (JConfig(train=JTrainConfig(**train)),
            Config(train=TrainConfig(**train)))


def _assert_same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
        return
    assert (a is None) == (b is None)
    if a is None:
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    return write_features(str(tmp_path_factory.mktemp("feats")), LENGTHS,
                          audio_rates=(24000, 16000))


@pytest.mark.parametrize("load_audio", [False, True])
def test_dataset_items_are_the_jax_ones(feature_dir, load_audio):
    """Two passes over the set (the slice rng runs on) give the JAX items;
    the 16 kHz files go through the numpy resampler."""
    jcfg, cfg = _configs()
    jd = jds.VCDataset(feature_dir, jcfg, seed=4, load_audio=load_audio)
    td = tds.VCDataset(feature_dir, cfg, seed=4, load_audio=load_audio)
    assert td.audiopaths == jd.audiopaths
    for i in list(range(len(jd))) * 2:
        _assert_same(td[i], jd[i])
    ev_j = jds.EvalDataset(feature_dir, jcfg, seed=5, load_audio=load_audio)
    ev_t = tds.EvalDataset(feature_dir, cfg, seed=5, load_audio=load_audio)
    for i in range(3):
        _assert_same(ev_t[i], ev_j[i])


def test_resample_np_is_the_jax_one():
    from ns2vc_tpu.audio.resample import resample_np as j_resample_np
    from ns2vc_tpu_torch.audio.resample import resample_np

    x = np.random.default_rng(1).standard_normal(7919).astype(np.float32)
    for orig, new in ((16000, 24000), (44100, 24000), (24000, 24000)):
        np.testing.assert_array_equal(resample_np(x, orig, new),
                                      j_resample_np(x, orig, new))


@pytest.mark.parametrize("buckets", [(), (32, 64)])
@pytest.mark.parametrize("num_workers", [0, 1])
def test_loader_batches_are_the_jax_ones(feature_dir, buckets, num_workers):
    """data_loader: the same batches in the same order from the same seed,
    serially and through one worker process."""
    jcfg, cfg = _configs(max_content_frames=64, max_refer_frames=48)

    def collator(mod, c):
        if buckets:
            return mod.BucketedCollator(c, buckets, include_wav=False)
        return mod.FixedShapeCollator(c, include_wav=False)
    jl = jds.data_loader(jds.VCDataset(feature_dir, jcfg, seed=1,
                                       load_audio=False),
                         collator(jds, jcfg), 3, seed=2,
                         num_workers=num_workers, shard_index=0,
                         shard_count=1)
    tl = tds.data_loader(tds.VCDataset(feature_dir, cfg, seed=1,
                                       load_audio=False),
                         collator(tds, cfg), 3, seed=2,
                         num_workers=num_workers)
    try:
        for _ in range(5):
            _assert_same(next(tl), next(jl))
    finally:
        tl.close()


def _fake_item(t_c, t_r, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((t_r, 100)).astype(np.float32),
            r.standard_normal((t_c, 256)).astype(np.float32),
            r.standard_normal((t_c,)).astype(np.float32),
            r.standard_normal((t_c, 100)).astype(np.float32),
            r.standard_normal((t_c * 256,)).astype(np.float32),
            (r.random((t_c,)) > 0.5).astype(np.float32))


@pytest.mark.parametrize("buckets,refer_buckets", [
    ((48, 96, 160), ()), ((48, 96, 160), (48, 96)), ((96, 160), (40,))])
def test_bucketed_collator_geometries_are_the_jax_ones(buckets,
                                                       refer_buckets):
    jcfg, cfg = _configs(max_content_frames=160, max_refer_frames=96)
    j = jds.BucketedCollator(jcfg, buckets, refer_buckets=refer_buckets)
    t = tds.BucketedCollator(cfg, buckets, refer_buckets=refer_buckets)
    assert t.geometries() == j.geometries()
    for tc, tr in ((30, 30), (49, 90), (100, 100), (500, 500), (8, 200)):
        assert t.bucket_of(_fake_item(tc, tr)) == j.bucket_of(
            _fake_item(tc, tr))
    items = [_fake_item(30, 30), _fake_item(40, 44, seed=1)]
    _assert_same(t(items), j(items))
    _assert_same(tds.FixedShapeCollator(cfg)(items),
                 jds.FixedShapeCollator(jcfg)(items))
    with pytest.raises(AssertionError):
        tds.BucketedCollator(cfg, (50, 96))


# -- preprocess -----------------------------------------------------------------

def _tone(n, sr, seed, f):
    r = np.random.default_rng(seed)
    t = np.arange(n) / sr
    ph = 2 * np.pi * f * t + 3.0 * np.sin(2 * np.pi * 5 * t)
    return (0.3 * np.sin(ph) + 0.1 * np.sin(2 * ph)
            + 0.01 * r.standard_normal(n)).astype(np.float32)


def _raw_dir(root):
    for i, (seconds, f) in enumerate(((1.5, 200.0), (4.5, 150.0))):
        os.makedirs(os.path.join(root, str(i)), exist_ok=True)
        write_wav(os.path.join(root, str(i), f"{i}.wav"),
                  _tone(int(seconds * 24000), 24000, i, f), 24000)
    return root


def _outputs(processed):
    out = {}
    for dirpath, _, names in os.walk(processed):
        for name in names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, processed)
            if name.endswith(".npy"):
                out[rel] = np.load(path)
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def test_preprocess_matches_jax(tmp_path):
    from ns2vc_tpu.data.preprocess import preprocess_dataset as j_preprocess
    from ns2vc_tpu_torch.data.preprocess import preprocess_dataset
    from test_torch_frontend import CV_SMALL, _contentvec_pair

    jcv, tree, cv = _contentvec_pair(np.random.default_rng(21), CV_SMALL)
    jin, tin = (_raw_dir(str(tmp_path / name)) for name in ("j", "t"))
    j_preprocess(jin, JConfig(), num_workers=1, contentvec=jcv,
                 contentvec_params=tree)
    outs = preprocess_dataset(tin, Config(), num_workers=1, contentvec=cv,
                              device="cpu")
    assert sorted(outs) == sorted(
        os.path.join(tin + "_processed", str(i), f"{i}.wav")
        for i in range(2))
    want, got = _outputs(jin + "_processed"), _outputs(tin + "_processed")
    assert sorted(got) == sorted(want) and len(got) == 8
    for rel, w in want.items():
        g = got[rel]
        if rel.endswith(".wav") or rel.endswith(".f0.npy"):
            assert np.array_equal(g, w) if rel.endswith(".npy") else g == w
        else:
            assert g.shape == w.shape, rel
            np.testing.assert_allclose(
                g, w, atol=SPEC_ATOL if rel.endswith(".spec.npy")
                else SOFT_ATOL, err_msg=rel)
    spec = got[os.path.join("1", "1.spec.npy")]
    soft = got[os.path.join("1", "1.wav.soft.npy")]
    assert spec.shape[:2] == (1, 100) and soft.shape[:2] == (1, 256)
    wav, sr = read_wav(os.path.join(tin + "_processed", "1", "1.wav"))
    assert sr == 24000 and abs(len(wav) // 256 - spec.shape[2]) <= 1
    # the host stages through a process pool write the same files
    pooled = _raw_dir(str(tmp_path / "p"))
    preprocess_dataset(pooled, Config(), num_workers=2, contentvec=cv,
                       device="cpu")
    for rel, g in _outputs(pooled + "_processed").items():
        assert np.array_equal(g, got[rel]) if rel.endswith(".npy") \
            else g == got[rel], rel


def test_preprocess_refuses_without_a_card(tmp_path, monkeypatch):
    from ns2vc_tpu_torch.data import preprocess

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = _raw_dir(str(tmp_path / "raw"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess.preprocess_dataset(raw, Config(), num_workers=1)
    with pytest.raises(SystemExit) as e:
        preprocess.main(["--in_dir", raw, "--num_workers", "1"])
    assert e.value.code not in (0, None) and "-d cpu" in str(e.value.code)
    assert not os.path.exists(raw + "_processed")
