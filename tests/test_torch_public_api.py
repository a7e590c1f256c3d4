"""The port's subpackages carry the JAX package's public names, and the
functions behind the names the port lacked agree with their JAX
counterparts.

- Every JAX subpackage's `__all__` (its public functions where it has no
  `__all__`: `native`), read with `ast`, is the port subpackage's
  `__all__`, and every name resolves; none is exempt.
- `istft` against JAX's `istft` and `torch.istft` (1e-5: one irfft and an
  overlap-add in f32); `Resampler` against the port's `resample`
  (bit-equal: one implementation) and JAX's `Resampler` (1e-5, the resample
  tests' bound); `make_x0_fn` against `NaturalSpeech2.denoise` and
  `generate_mel` against the sampler over the closure it used to build
  (bit-equal); `process_one` against `preprocess_dataset`'s files for the
  same wav; `Svc.clear_empty` on the CPU; the JAX converter names are the
  port's converters.
"""

import ast
import importlib
import os
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXEMPT: dict = {}    # subpackage -> why the port lacks its names
SUBPACKAGES = sorted(p.parent.name for p in
                     (ROOT / "ns2vc_tpu").glob("*/__init__.py"))
ISTFT_ATOL = 1e-5
RESAMPLE_ATOL = 1e-5


def _jax_names(pkg: str) -> list[str]:
    """The JAX subpackage's `__all__`, or its public top-level functions
    and classes where it has none, read without importing it."""
    tree = ast.parse((ROOT / "ns2vc_tpu" / pkg / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def test_subpackages_are_all_compared():
    assert len(SUBPACKAGES) == 11 and "parallel" in SUBPACKAGES
    assert set(EXEMPT) <= set(SUBPACKAGES)


@pytest.mark.parametrize("pkg", [p for p in SUBPACKAGES if p not in EXEMPT])
def test_port_subpackage_carries_the_jax_names(pkg):
    want = _jax_names(pkg)
    assert want, pkg
    mod = importlib.import_module(f"ns2vc_tpu_torch.{pkg}")
    assert sorted(mod.__all__) == sorted(want)
    for name in want:
        assert getattr(mod, name) is not None, f"{pkg}.{name}"


def test_converter_names_are_the_ports_converters():
    from ns2vc_tpu_torch.features import contentvec, crepe
    from ns2vc_tpu_torch.models import vocos

    assert contentvec.convert_fairseq_hubert is \
        contentvec.contentvec_from_fairseq
    assert crepe.convert_torchcrepe is crepe.crepe_from_torchcrepe
    assert vocos.convert_vocos_state_dict is vocos.vocos_from_public


@pytest.mark.parametrize("n_fft,hop,win,center,length", [
    (64, 16, 64, True, None),
    (64, 16, 48, True, 300),
    (32, 8, 32, False, None),
    (32, 8, 32, False, 200),
])
def test_istft_matches_jax_and_torch(n_fft, hop, win, center, length):
    from ns2vc_tpu.audio.mel import istft as j_istft
    from ns2vc_tpu_torch.audio.mel import hann_window, istft

    r = np.random.default_rng(n_fft + win)
    spec = (r.standard_normal((2, 30, n_fft // 2 + 1))
            + 1j * r.standard_normal((2, 30, n_fft // 2 + 1))).astype(
                np.complex64)
    spec[..., 0] = spec[..., 0].real          # real DC and Nyquist bins
    spec[..., -1] = spec[..., -1].real
    w = hann_window(win)
    got = istft(torch.from_numpy(spec), torch.from_numpy(w), n_fft, hop,
                center=center, length=length).numpy()
    want = np.asarray(j_istft(jnp.asarray(spec), jnp.asarray(w), n_fft, hop,
                              win, center, length))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ISTFT_ATOL)
    if center:   # torch.istft refuses a window whose envelope has zeros
        ref = torch.istft(torch.from_numpy(spec).transpose(-1, -2), n_fft,
                          hop, win, torch.from_numpy(w), center=True,
                          length=length).numpy()
        np.testing.assert_allclose(got, ref, atol=ISTFT_ATOL)


@pytest.mark.parametrize("orig,new", [(44100, 24000), (48000, 16000),
                                      (16000, 44100), (24000, 24000)])
def test_resampler_matches_resample_and_jax(orig, new):
    from ns2vc_tpu.audio.resample import Resampler as JResampler
    from ns2vc_tpu_torch.audio.resample import Resampler, resample

    x = np.random.default_rng(orig % 97).standard_normal((2, 3001)).astype(
        np.float32)
    r = Resampler(orig, new)
    got = r(torch.from_numpy(x))
    assert torch.equal(got, resample(torch.from_numpy(x), orig, new))
    want = np.asarray(JResampler(orig, new)(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=RESAMPLE_ATOL)


def _tiny_model():
    from ns2vc_tpu_torch.config import (
        Config, DiffusionEncoderConfig, EncoderConfig,
    )
    from ns2vc_tpu_torch.convert import init_params
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2

    cfg = Config(phoneme_encoder=EncoderConfig(n_layers=1),
                 prompt_encoder=EncoderConfig(in_channels=100, n_layers=1),
                 diffusion_encoder=DiffusionEncoderConfig(
                     block_out_channels=(16, 24, 32, 40)))
    model = NaturalSpeech2(cfg)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    return model.eval()


def _conditioning(model):
    from ns2vc_tpu_torch.ops.masking import sequence_mask

    r = np.random.default_rng(0)
    c = torch.from_numpy(r.standard_normal((2, 16, 256)).astype(np.float32))
    refer = torch.from_numpy(r.standard_normal((2, 12, 100)).astype(
        np.float32))
    lengths, refer_lengths = torch.tensor([16, 11]), torch.tensor([12, 7])
    c_mask = sequence_mask(lengths, 16)
    refer_mask = sequence_mask(refer_lengths, 12)
    x_T = torch.from_numpy(r.standard_normal((2, 16, 100)).astype(
        np.float32))
    return c, refer, lengths, refer_lengths, c_mask, refer_mask, x_T


@torch.no_grad()
def test_make_x0_fn_is_denoise():
    from ns2vc_tpu_torch.models.diffusion import make_x0_fn

    model = _tiny_model()
    c, refer, _, _, c_mask, refer_mask, x_T = _conditioning(model)
    content, prompt = model.encode(c, refer, c_mask, refer_mask)
    cached = model.precompute_conditioning(prompt)
    t = torch.tensor([700.0, 20.0])
    aug_emb, cross_kv = cached
    want = model.denoise(x_T, content, prompt, refer_mask, t,
                         cross_kv=cross_kv, aug_emb=aug_emb)
    got = make_x0_fn(model, content, prompt, refer_mask, cached)(x_T, t)
    assert torch.equal(got, want)
    uncached = make_x0_fn(model, content, prompt, refer_mask)(x_T, t)
    assert torch.equal(uncached,
                       model.denoise(x_T, content, prompt, refer_mask, t))
    np.testing.assert_allclose(uncached.numpy(), want.numpy(), atol=1e-5)


@torch.no_grad()
def test_generate_mel_is_unchanged():
    """generate_mel through make_x0_fn gives, bit for bit, the sampler over
    the closure it built before."""
    from ns2vc_tpu_torch.diffusion.samplers import sample
    from ns2vc_tpu_torch.models.diffusion import generate_mel

    model = _tiny_model()
    c, refer, lengths, refer_lengths, c_mask, refer_mask, x_T = \
        _conditioning(model)
    got = generate_mel(model, c, refer, lengths, refer_lengths, x_T=x_T,
                       steps=4)
    content, prompt = model.encode(c, refer, c_mask, refer_mask)
    aug_emb, cross_kv = model.precompute_conditioning(prompt)

    def x0_fn(x, t):
        return model.denoise(x, content, prompt, refer_mask, t,
                             cross_kv=cross_kv, aug_emb=aug_emb)
    want = sample("unipc", x0_fn, x_T, model.schedule, 4, order=2).float()
    assert torch.equal(got, want)


def test_process_one_writes_what_preprocess_dataset_writes(tmp_path):
    """A 4.0 s wav at 24 kHz: 64000 samples at 16 kHz, exactly one of
    preprocess_dataset's ContentVec buckets, so its batch holds no padding
    and both write the same files."""
    from test_torch_frontend import CV_SMALL, _contentvec_pair, _signal

    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.data.preprocess import (
        preprocess_dataset, process_one,
    )
    from ns2vc_tpu_torch.utils.wavio import write_wav

    _, _, cv = _contentvec_pair(np.random.default_rng(21), CV_SMALL)
    files = {}
    for name in ("a", "b"):
        raw = tmp_path / name / "raw"
        (raw / "spk").mkdir(parents=True)
        write_wav(str(raw / "spk" / "x.wav"), _signal(96000, 24000, 3),
                  24000)
        files[name] = str(raw / "spk" / "x.wav"), str(raw)
    out_a = process_one(*files["a"], Config(), contentvec=cv, device="cpu")
    outs_b = preprocess_dataset(files["b"][1], Config(), num_workers=1,
                                contentvec=cv, device="cpu")
    assert outs_b == [out_a.replace(os.sep + "a" + os.sep,
                                    os.sep + "b" + os.sep)]
    for suffix in ("", ".f0.npy", ".soft.npy"):
        pa, pb = out_a + suffix, outs_b[0] + suffix
        if suffix:
            assert np.array_equal(np.load(pa), np.load(pb)), suffix
        else:
            assert open(pa, "rb").read() == open(pb, "rb").read()
    spec = [np.load(p.replace(".wav", "") + ".spec.npy")
            for p in (out_a, outs_b[0])]
    assert spec[0].shape == (1, 100, 376)
    assert np.array_equal(*spec)
    assert np.load(out_a + ".soft.npy").shape == (1, 256, 199)
    # without a ContentVec no .soft.npy
    raw = tmp_path / "c" / "raw"
    (raw / "spk").mkdir(parents=True)
    write_wav(str(raw / "spk" / "y.wav"), _signal(24000, 24000, 4), 24000)
    out_c = process_one(str(raw / "spk" / "y.wav"), str(raw), Config(),
                        device="cpu")
    assert os.path.exists(out_c + ".f0.npy")
    assert not os.path.exists(out_c + ".soft.npy")


def test_svc_clear_empty_runs_on_the_cpu():
    from test_torch_slice import VOCOS_KW

    from ns2vc_tpu_torch.convert import init_params, init_vocos_params
    from ns2vc_tpu_torch.infer.svc import Svc

    model = _tiny_model()
    g = torch.Generator().manual_seed(1)
    svc = Svc(config=model.cfg, params=init_params(model.cfg, g),
              vocos_params=init_vocos_params(g, **VOCOS_KW), device="cpu")
    assert svc.clear_empty() is None
