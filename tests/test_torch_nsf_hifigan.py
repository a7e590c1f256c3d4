"""The port's NSF-HiFiGAN (`ns2vc_tpu_torch.models.nsf_hifigan`) against the
JAX package's on the CPU, at small widths.

Both sides take the same seeded numpy inputs; the JAX parameters reach the
port through `convert.nsf_hifigan_from_flax` / `mpd_from_flax` /
`msd_from_flax`, and the sine source's random initial phases are JAX's
`jax.random.uniform(rng, (B, H))` injected as `rand_ini`. The generator is
8 mels, 16 channels, rates (2, 2), kernels (4, 4), one resblock of kernel
3 with dilations (1, 3), of either type, over 12 frames; the MPD has
periods (2, 3); the MSD 2 scales over 1000 samples (even, and odd after
one pooling). Tolerances (f32; JAX at `highest` matmul precision):
`_mod1_cumsum` 1e-6 on the circle on inputs whose partial sums are exact
in f32 (multiples of 2^-10), and within 1e-4 of the f64 oracle on uniform
inputs, where XLA and torch sum in other orders; the sines 2e-5 (the
port takes the phase in f64, JAX in f32: 1.2e-5 apart here); the
waveform, the discriminators' outputs and feature maps 2e-5 (the JAX
suite's bound for a conv stack); the losses rtol 1e-5; the reference
checkpoint's conversion rtol 1e-6 (the same weight-norm fold in another
order). Last, scripts/torch_reconstruct_nsf.py on the CPU, and its refusal
without a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu.models import nsf_hifigan as jnsf
from ns2vc_tpu_torch.convert import (
    init_nsf_hifigan_params, mpd_from_flax, msd_from_flax,
    nsf_hifigan_from_flax,
)
from ns2vc_tpu_torch.models import nsf_hifigan as tnsf


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tests: their models are small,
    and the suite's test workers share the host's cores, where several
    OpenMP teams per core stall at their barriers (on an 8-core CPU host,
    alone, 1 thread runs `test_torch_f0.py::test_trainer_serves_a_
    predictor_checkpoint` in 14.7 s against 45.3 with 8)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


ATOL = 2e-5
LOSS_RTOL = 1e-5
CONVERT_RTOL = 1e-6
SR = 8000
FRAMES = 12


def _kw(resblock):
    return dict(num_mels=8, upsample_initial_channel=16,
                upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                resblock=resblock, resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 3),), sampling_rate=SR)


def _config(kw):
    """The reference `config.json` keys of a generator's keywords."""
    return {**{k: list(v) if isinstance(v, tuple) else v
               for k, v in kw.items()},
            "resblock_dilation_sizes": [list(d) for d in
                                        kw["resblock_dilation_sizes"]]}


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed=0, b=2):
    r = np.random.default_rng(seed)
    mel = r.standard_normal((b, FRAMES, 8)).astype(np.float32)
    f0 = r.uniform(80.0, 600.0, (b, FRAMES)).astype(np.float32)
    f0[:, 4:6] = 0.0                                  # an unvoiced stretch
    return mel, f0


def _rand_ini(rng, b, h):
    return np.asarray(jax.random.uniform(rng, (b, h), dtype=jnp.float32)
                      .at[:, 0].set(0.0))


def _circle(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 1.0 - d).max()


@pytest.mark.parametrize("dyadic", [True, False])
def test_mod1_cumsum_matches_jax(dyadic):
    """On multiples of 2^-10 every partial sum is exact in f32 whatever the
    order, so the blocked algorithms (offsets, mod 1) must agree to 1e-6.
    On uniform f32 inputs the two sum in other orders (XLA's cumsum is a
    reduce_window per output on the CPU, torch's a running sum): each is
    then held against the f64 oracle within 1e-4 of a cycle, 7 ulps of
    the largest local sum (~128), and the two within 2e-4."""
    x = np.random.default_rng(0).uniform(0, 1, (2, 5000, 3))
    if dyadic:
        x = np.round(x * 1024) / 1024
    x = x.astype(np.float32)
    got = tnsf._mod1_cumsum(_t(x), block=256).numpy()
    want = np.asarray(jnsf._mod1_cumsum(jnp.asarray(x), block=256))
    assert got.shape == want.shape == x.shape
    exact = np.mod(np.cumsum(x.astype(np.float64), axis=1), 1.0)
    if dyadic:
        assert _circle(got, want) < 1e-6
        assert _circle(got, exact) < 1e-6
    else:
        assert _circle(got, exact) < 1e-4
        assert _circle(want, exact) < 1e-4
        assert _circle(got, want) < 2e-4


@pytest.mark.parametrize("f0_dtype", [np.float32, np.float64])
def test_sine_source_matches_jax(f0_dtype):
    _, f0 = _inputs()
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jnsf.sine_source(jnp.asarray(f0), 40, SR, 8, rng))
    got = tnsf.sine_source(_t(f0.astype(f0_dtype)), 40, SR, 8,
                           rand_ini=_t(_rand_ini(rng, 2, 9)))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, FRAMES * 40, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_initial_phase_is_seeded():
    a = tnsf.initial_phase(3, 9, torch.Generator().manual_seed(5))
    b = tnsf.initial_phase(3, 9, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and (a[:, 0] == 0).all()
    assert ((a[:, 1:] >= 0) & (a[:, 1:] < 1)).all()


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator_matches_jax(resblock):
    kw = _kw(resblock)
    mel, f0 = _inputs()
    jm = jnsf.NSFHiFiGANGenerator(**kw)
    params = jm.init(jax.random.PRNGKey(1), mel, f0)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jm.apply(params, mel, f0, rng))
    tm = tnsf.NSFHiFiGANGenerator(**kw)
    tm.load_state_dict(nsf_hifigan_from_flax(_np_tree(params), **kw))
    with torch.no_grad():
        got = tm.eval()(_t(mel), _t(f0),
                        rand_ini=_t(_rand_ini(rng, 2, 9))).numpy()
    assert got.shape == want.shape == (2, FRAMES * 4)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _fmaps_nhwc(fmaps):
    """The port's feature maps in JAX's layout: (B, C, T) -> (B, T, C),
    (B, C, H, W) -> (B, H, W, C)."""
    return [np.moveaxis(f.numpy(), 1, -1) for f in fmaps]


def _disc_inputs():
    r = np.random.default_rng(2)
    y = r.standard_normal((2, 1000)).astype(np.float32)
    return y, (0.5 * y + 0.3 * r.standard_normal((2, 1000))).astype(
        np.float32)


@pytest.fixture(scope="module")
def discriminators():
    """Each discriminator's JAX and port outputs on the same inputs."""
    y, y_hat = _disc_inputs()
    out = {}
    for name, jm, tm, conv in (
            ("mpd", jnsf.MultiPeriodDiscriminator(periods=(2, 3)),
             tnsf.MultiPeriodDiscriminator(periods=(2, 3)),
             lambda p: mpd_from_flax(p, periods=(2, 3))),
            ("msd", jnsf.MultiScaleDiscriminator(num_scales=2),
             tnsf.MultiScaleDiscriminator(num_scales=2),
             lambda p: msd_from_flax(p, num_scales=2))):
        params = jm.init(jax.random.PRNGKey(4), y, y_hat)
        want = jm.apply(params, y, y_hat)
        tm.load_state_dict(conv(_np_tree(params)))
        with torch.no_grad():
            got = tm.eval()(_t(y), _t(y_hat))
        out[name] = (want, got)
    return out


@pytest.mark.parametrize("name", ["mpd", "msd"])
def test_discriminator_matches_jax(discriminators, name):
    (jr, jg, jfr, jfg), (tr, tg, tfr, tfg) = discriminators[name]
    assert len(tr) == len(jr) == 2
    for want, got in zip(jr + jg, tr + tg):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for want_maps, got_maps in zip(jfr + jfg, tfr + tfg):
        assert len(got_maps) == len(want_maps)
        for want, got in zip(want_maps, _fmaps_nhwc(got_maps)):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_msd_pooling_matches_reduce_window():
    """JAX's "SAME" window-4 stride-2 sum over 4, at even and odd lengths."""
    for n in (1000, 501, 7):
        y = np.random.default_rng(n).standard_normal((2, n)).astype(
            np.float32)
        want = np.asarray(jax.lax.reduce_window(
            jnp.asarray(y), 0.0, jax.lax.add, (1, 4), (1, 2), "SAME") / 4.0)
        got = tnsf._pool(_t(y)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("name", ["mpd", "msd"])
def test_losses_match_jax(discriminators, name):
    (jr, jg, jfr, jfg), (tr, tg, tfr, tfg) = discriminators[name]
    for jfn, tfn, jargs, targs in (
            (jnsf.discriminator_loss, tnsf.discriminator_loss, (jr, jg),
             (tr, tg)),
            (jnsf.generator_loss, tnsf.generator_loss, (jg,), (tg,)),
            (jnsf.feature_loss, tnsf.feature_loss, (jfr, jfg),
             (tfr, tfg))):
        np.testing.assert_allclose(float(tfn(*targs)), float(jfn(*jargs)),
                                   rtol=LOSS_RTOL)


def _reference_sd(kw, seed=9):
    """A seeded reference-layout generator dict: weight-normed convs with
    gains that are not the norms of their directions (so the fold moves
    every weight)."""
    sd = init_nsf_hifigan_params(torch.Generator().manual_seed(seed), **kw)
    ref = tnsf.nsf_hifigan_to_reference(sd, _config(kw))
    r = np.random.default_rng(seed)
    for k, v in ref.items():
        if k.endswith(".weight_g"):
            ref[k] = torch.from_numpy(
                r.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif k.endswith(".bias"):
            ref[k] = torch.from_numpy(
                r.standard_normal(v.shape).astype(np.float32) * 0.1)
    return ref


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_convert_nsf_hifigan_matches_jax(resblock):
    # the JAX converter reads 3 convs per ResBlock1 and 2 per ResBlock2
    kw = {**_kw(resblock), "resblock_dilation_sizes": (
        (1, 3, 5),) if resblock == "1" else ((1, 3),)}
    cfg = _config(kw)
    ref = _reference_sd(kw)
    got = tnsf.convert_nsf_hifigan(ref, cfg)
    want = nsf_hifigan_from_flax(jnsf.convert_nsf_hifigan(ref, cfg), **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=CONVERT_RTOL, atol=1e-7, err_msg=k)
    gen = tnsf.NSFHiFiGANGenerator(**kw)
    gen.load_state_dict(got)             # strict: every parameter filled


def test_nsf_hifigan_reference_round_trip():
    kw = _kw("1")
    sd = init_nsf_hifigan_params(torch.Generator().manual_seed(1), **kw)
    back = tnsf.convert_nsf_hifigan(
        tnsf.nsf_hifigan_to_reference(sd, _config(kw)), _config(kw))
    for k in sd:
        np.testing.assert_allclose(back[k].numpy(), sd[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_convert_nsf_hifigan_is_strict():
    kw = _kw("1")
    cfg = _config(kw)
    ref = _reference_sd(kw)
    renamed = dict(ref)
    renamed["resblocks.0.convs1.0.weight_gain"] = renamed.pop(
        "resblocks.0.convs1.0.weight_g")
    with pytest.raises(KeyError):
        tnsf.convert_nsf_hifigan(renamed, cfg)
    extra = {**ref, "stray.weight": torch.ones(3)}
    with pytest.raises(ValueError, match="not consumed"):
        tnsf.convert_nsf_hifigan(extra, cfg)
    tnsf.convert_nsf_hifigan(extra, cfg, strict=False)


def test_load_nsf_hifigan_from_files(tmp_path):
    import json

    kw = _kw("1")
    cfg = _config(kw)
    ref = _reference_sd(kw)
    torch.save({"generator": ref}, tmp_path / "model")
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    gen = tnsf.load_nsf_hifigan(str(tmp_path / "model"),
                                str(tmp_path / "config.json"))
    want = tnsf.convert_nsf_hifigan(ref, cfg)
    for k, v in gen.state_dict().items():
        assert torch.equal(v, want[k]), k
    mel, f0 = _inputs(b=1)
    with torch.no_grad():
        wav = gen(_t(mel), _t(f0), torch.Generator().manual_seed(0))
    assert wav.shape == (1, FRAMES * 4) and torch.isfinite(wav).all()
    assert wav.abs().max() <= 1.0


def _script():
    import importlib
    import pathlib
    import sys

    scripts = str(pathlib.Path(__file__).resolve().parent.parent / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module("torch_reconstruct_nsf")


def _script_files(tmp_path, kw):
    import json

    from ns2vc_tpu_torch.utils.wavio import write_wav

    cfg = {**_config(kw), "n_fft": 64}
    torch.save({"generator": _reference_sd(kw)}, tmp_path / "model")
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    t = np.arange(12000) / 12000
    write_wav(str(tmp_path / "in.wav"),
              (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 12000)
    return ["--wav", str(tmp_path / "in.wav"), "--ckpt",
            str(tmp_path / "model"), "--config", str(tmp_path / "config.json"),
            "--out", str(tmp_path / "out.wav")]


def test_reconstruct_script_on_the_cpu(tmp_path):
    """The script's pipeline at the small widths: 1 s at 12 kHz resampled to
    8 kHz, a 64-point log-mel at hop 4, DIO F0, the generator with seed-0
    phases; the written wav is the generator's output."""
    from ns2vc_tpu_torch.audio.f0 import compute_f0_dio, interpolate_f0
    from ns2vc_tpu_torch.audio.mel import log_mel_spectrogram
    from ns2vc_tpu_torch.audio.resample import resample
    from ns2vc_tpu_torch.utils.wavio import read_wav

    kw = _kw("1")
    argv = _script_files(tmp_path, kw)
    out = _script().main(argv + ["-d", "cpu"])
    frames = 8000 // 4 + 1
    assert out.shape == (frames * 4,) and np.isfinite(out).all()
    assert np.abs(out).max() <= 1.0
    wav, sr = read_wav(str(tmp_path / "out.wav"))
    assert sr == SR and len(wav) == len(out)
    x, _ = read_wav(str(tmp_path / "in.wav"))
    x = resample(torch.from_numpy(x), 12000, SR)
    mel = log_mel_spectrogram(x, SR, 64, 4, 8)
    f0, _ = interpolate_f0(compute_f0_dio(x.numpy(), p_len=mel.shape[1],
                                          sampling_rate=SR, hop_length=4))
    gen = tnsf.load_nsf_hifigan(str(tmp_path / "model"),
                                str(tmp_path / "config.json"))
    with torch.no_grad():
        want = gen(mel.T[None], torch.from_numpy(f0)[None],
                   torch.Generator().manual_seed(0))[0].numpy()
    np.testing.assert_array_equal(out, want)


def test_reconstruct_script_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _script_files(tmp_path, _kw("1"))
    with pytest.raises(SystemExit) as e:
        _script().main(argv)
    assert e.value.code not in (0, None) and "-d cpu" in str(e.value.code)
    assert not (tmp_path / "out.wav").exists()
