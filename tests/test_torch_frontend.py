"""The port's audio front end, feature models, loaders and Svc against the
JAX package, on the CPU.

Inputs come from a numpy seed; each model runs in both packages on the
same weights (shared through `ns2vc_tpu_torch.convert.*_from_flax`), in
f32. Tolerances:
- resampler 1e-5;
- log-mel 1e-4, where the mel power is above the 1e-7 clip;
- ContentVec 1e-4 at dim 64, 4 heads, 2 layers;
- the fairseq ContentVec loader against `convert_fairseq_hubert` 1e-6 on a
  synthetic fairseq-layout state dict;
- CREPE probabilities (tiny model) 1e-5; the torchcrepe and public Vocos
  loaders against the JAX converters 1e-5 (the public layouts are written
  by the port's `*_to_*` writers and read independently by the JAX
  converters); each writer then its loader returns the port state dict
  to 1e-6;
- `Svc.compute_features` against the JAX Svc's with full-width
  ContentVec on 1 s of audio: f0/uv exact (24 kHz input, so both F0
  trackers see the same samples), content 1e-4;
- wav -> features -> generate_mel (shared x_T) -> Vocos on the tiny
  configuration 1e-3;
- `slice_inference`'s plan and assembly, with both Svcs' `infer_batch`
  replaced by one deterministic stub: exact.
"""

import argparse
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu.audio.mel import log_mel_spectrogram as j_log_mel
from ns2vc_tpu.audio.mel import mel_filterbank as j_filterbank
from ns2vc_tpu.audio.resample import resample as j_resample
from ns2vc_tpu.config import Config, save_config
from ns2vc_tpu.features.contentvec import ContentVec as JContentVec
from ns2vc_tpu.features.contentvec import convert_fairseq_hubert
from ns2vc_tpu.features.crepe import Crepe as JCrepe
from ns2vc_tpu.features.crepe import compute_f0_uv_crepe as j_crepe_f0
from ns2vc_tpu.features.crepe import convert_torchcrepe
from ns2vc_tpu.infer import cli as jcli
from ns2vc_tpu.infer.svc import Svc as JSvc
from ns2vc_tpu.models import diffusion as jdiff
from ns2vc_tpu.models.vocos import Vocos as JVocos
from ns2vc_tpu.models.vocos import convert_vocos_state_dict
from ns2vc_tpu.utils.wavio import write_wav
from ns2vc_tpu_torch.audio.host import compute_f0_ac, repeat_expand_2d
from ns2vc_tpu_torch.audio.mel import log_mel_spectrogram, mel_filterbank
from ns2vc_tpu_torch.audio.resample import resample
from ns2vc_tpu_torch.convert import (
    contentvec_from_flax, crepe_from_flax, from_flax, vocos_from_flax,
)
from ns2vc_tpu_torch.features.contentvec import (
    ContentVec, contentvec_from_fairseq, contentvec_to_fairseq,
    load_contentvec,
)
from ns2vc_tpu_torch.features.crepe import (
    Crepe, compute_f0_uv_crepe, crepe_from_torchcrepe, crepe_to_torchcrepe,
)
from ns2vc_tpu_torch.infer import cli
from ns2vc_tpu_torch.infer.svc import RealTimeVC, Svc
from ns2vc_tpu_torch.models.diffusion import generate_mel
from ns2vc_tpu_torch.models.vocos import (
    Vocos, load_vocos, vocos_from_public, vocos_to_public,
)
from test_torch_slice import VOCOS_KW, _filled_tree, tiny_config


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


RESAMPLE_ATOL, MEL_ATOL, CV_ATOL, LOADER_ATOL = 1e-5, 1e-4, 1e-4, 1e-6
CREPE_ATOL, VOCOS_LOADER_ATOL, PATH_ATOL = 1e-5, 1e-5, 1e-3
CV_SMALL = dict(dim=64, heads=4, ffn_dim=128, num_layers=2, output_layer=2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _signal(n, sr, seed=0, f=220.0):
    """A voiced-like test signal: a harmonic tone with vibrato and noise."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / sr
    phase = 2 * np.pi * f * t + 3.0 * np.sin(2 * np.pi * 5 * t)
    x = 0.3 * np.sin(phase) + 0.15 * np.sin(2 * phase) + 0.05 * np.sin(
        3 * phase)
    return (x + 0.01 * r.standard_normal(n)).astype(np.float32)


# -- resampling and log-mel --------------------------------------------------

@pytest.mark.parametrize("orig,new", [(44100, 24000), (44100, 16000),
                                      (24000, 16000), (16000, 24000),
                                      (22050, 22050)])
def test_resample_matches_jax(orig, new):
    x = np.random.default_rng(1).standard_normal((2, 7919)).astype(np.float32)
    got = resample(torch.from_numpy(x), orig, new).numpy()
    want = np.asarray(j_resample(jnp.asarray(x), orig, new))
    assert got.shape == want.shape == (2, -(-new * 7919 // orig))
    np.testing.assert_allclose(got, want, atol=RESAMPLE_ATOL)


def test_mel_filterbank_is_the_jax_one():
    np.testing.assert_array_equal(mel_filterbank(513, 100, 24000),
                                  j_filterbank(513, 100, 24000))


@pytest.mark.parametrize("shape", [(24000,), (2, 12345)])
def test_log_mel_matches_jax(shape):
    x = _signal(int(np.prod(shape)), 24000).reshape(shape)
    x[..., 3000:6000] *= 1e-6                          # near-silent stretch
    got = log_mel_spectrogram(torch.from_numpy(x)).numpy()
    want = np.asarray(j_log_mel(jnp.asarray(x)))
    assert got.shape == want.shape == shape[:-1] + (100, 1 + shape[-1] // 256)
    above = want > np.log(1e-7) + 1e-3
    assert above.mean() > 0.5
    np.testing.assert_allclose(got[above], want[above], atol=MEL_ATOL)


def test_repeat_expand_is_the_jax_one():
    from ns2vc_tpu.data.dataset import repeat_expand_2d as j_expand

    c = np.random.default_rng(2).standard_normal((37, 5))
    for n in (37, 50, 111):
        np.testing.assert_array_equal(repeat_expand_2d(c, n), j_expand(c, n))


# -- ContentVec --------------------------------------------------------------

def _contentvec_pair(r, kw, n=16000):
    jcv = JContentVec(**kw)
    tree = _filled_tree(lambda k, w: jcv.init(k, w), r,
                        np.zeros((1, n), np.float32))
    cv = ContentVec(**kw)
    cv.load_state_dict(contentvec_from_flax(_np_tree(tree), **kw))
    return jcv, tree, cv.eval()


def test_contentvec_matches_jax():
    r = np.random.default_rng(3)
    jcv, tree, cv = _contentvec_pair(r, CV_SMALL)
    wav = (0.1 * r.standard_normal((2, 16000))).astype(np.float32)
    lengths = np.array([16000, 9000])
    with torch.no_grad():
        got = cv(torch.from_numpy(wav)).numpy()
        got_len = cv(torch.from_numpy(wav), torch.from_numpy(lengths)).numpy()
    want = np.asarray(jcv.apply(tree, wav))
    want_len = np.asarray(jcv.apply(tree, wav, jnp.asarray(lengths)))
    assert got.shape == want.shape == (2, 49, 256)
    np.testing.assert_allclose(got, want, atol=CV_ATOL)
    np.testing.assert_allclose(got_len, want_len, atol=CV_ATOL)


def _randomised(sd, g, scale=1.0):
    return {k: scale * torch.randn(v.shape, generator=g) for k, v in sd.items()}


def _fairseq_sd(g, dim=96, ffn=192, layers=2, final=64, scale=1.0):
    """A synthetic state dict in the fairseq HubertModel key layout of
    contentvec's checkpoint_best_legacy_500.pt (written by the port's
    `contentvec_to_fairseq`, read independently by the JAX converter),
    with a weight-norm gain that is not the direction's norm and the
    training-only tensors."""
    port = ContentVec(dim=dim, heads=1, ffn_dim=ffn, num_layers=layers,
                      output_layer=layers, final_dim=final).state_dict()
    sd = contentvec_to_fairseq(_randomised(port, g, scale))
    sd["encoder.pos_conv.0.weight_g"] = scale * torch.randn(1, 1, 128,
                                                            generator=g)
    sd["label_embs_concat"] = torch.randn(504, final, generator=g)
    sd["mask_emb"] = torch.randn(dim, generator=g)
    return sd


def test_fairseq_loader_matches_jax_converter():
    sd = _fairseq_sd(torch.Generator().manual_seed(4))
    got = contentvec_from_fairseq(sd)
    want = contentvec_from_flax(
        convert_fairseq_hubert(sd), dim=96, heads=4, ffn_dim=192,
        num_layers=2, output_layer=2, final_dim=64)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=LOADER_ATOL, err_msg=k)
    bad = dict(sd)
    bad["encoder.layers.0.self_attn.renamed_upstream.weight"] = \
        torch.zeros(2, 2)
    with pytest.raises(ValueError, match="not consumed"):
        contentvec_from_fairseq(bad)


def test_load_contentvec_reads_heads_from_metadata(tmp_path):
    sd = _fairseq_sd(torch.Generator().manual_seed(5))
    path = tmp_path / "cv.pt"
    torch.save({"model": sd, "cfg": {"model": {"encoder_attention_heads": 6}}},
               path)
    assert load_contentvec(str(path)).heads == 6
    torch.save({"model": sd, "args": argparse.Namespace(
        encoder_attention_heads=3)}, path)
    assert load_contentvec(str(path)).heads == 3
    torch.save({"model": sd}, path)
    with pytest.warns(UserWarning, match="64-wide-head"):
        model = load_contentvec(str(path))
    assert model.heads == 1 and model.final_proj.out_features == 64


# -- CREPE -------------------------------------------------------------------

def _crepe_pair(r):
    jcr = JCrepe(model="tiny")
    variables = _filled_tree(jcr.init, r, np.zeros((1, 1024), np.float32))
    variables = jax.tree.map(np.array, variables)
    for st in variables["batch_stats"].values():   # variances must be > 0
        st["var"] = 1.0 + np.abs(st["var"] - 1.0)
    cr = Crepe("tiny")
    cr.load_state_dict(crepe_from_flax(variables, "tiny"))
    return jcr, variables, cr.eval()


def test_crepe_probabilities_match_jax():
    r = np.random.default_rng(6)
    jcr, variables, cr = _crepe_pair(r)
    frames = r.standard_normal((8, 1024)).astype(np.float32)
    with torch.no_grad():
        got = cr(torch.from_numpy(frames)).numpy()
    want = np.asarray(jcr.apply(variables, frames))
    assert got.shape == want.shape == (8, 360)
    np.testing.assert_allclose(got, want, atol=CREPE_ATOL)


def test_crepe_f0_matches_jax():
    r = np.random.default_rng(7)
    jcr, variables, cr = _crepe_pair(r)
    wav = _signal(24000, 24000)
    for threshold in (0.0, 0.5):
        f0, uv = compute_f0_uv_crepe(wav, sampling_rate=24000,
                                     hop_length=256, threshold=threshold,
                                     model=cr)
        jf0, juv = j_crepe_f0(wav, sampling_rate=24000, hop_length=256,
                              threshold=threshold, model=jcr,
                              params=variables)
        assert f0.shape == (24000 // 256,)
        np.testing.assert_array_equal(uv, juv)
        np.testing.assert_allclose(f0, jf0, rtol=1e-4)


def test_torchcrepe_loader_matches_jax_converter():
    g = torch.Generator().manual_seed(8)
    sd = crepe_to_torchcrepe(_randomised(Crepe("tiny").state_dict(), g))
    for k in [k for k in sd if k.endswith("num_batches_tracked")]:
        sd[k] = torch.tensor(7)
    got = crepe_from_torchcrepe(sd)
    want = crepe_from_flax(convert_torchcrepe(sd, "tiny"), "tiny")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=CREPE_ATOL, err_msg=k)
    sd["conv7.extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="not consumed"):
        crepe_from_torchcrepe(sd)


# -- Vocos public layout -----------------------------------------------------

def _public_vocos_sd(g, dim=32, inter=48, layers=2, n_fft=64, mels=100,
                     scale=1.0):
    """Random weights in the public charactr/vocos layout (written by the
    port's `vocos_to_public`, read independently by the JAX converter),
    with the buffers the loaders recompute."""
    port = Vocos(input_channels=mels, dim=dim, intermediate_dim=inter,
                 num_layers=layers, n_fft=n_fft).state_dict()
    sd = vocos_to_public(_randomised(port, g, scale))
    sd["feature_extractor.mel_spec.spectrogram.window"] = torch.randn(
        n_fft, generator=g)
    sd["head.istft.window"] = torch.randn(n_fft, generator=g)
    return sd


@pytest.mark.parametrize("model", ["contentvec", "crepe", "vocos"])
def test_public_layout_writers_invert_the_loaders(model):
    """Each port state dict survives a trip through its public layout."""
    g = torch.Generator().manual_seed(12)
    if model == "contentvec":
        sd = _randomised(ContentVec(**CV_SMALL).state_dict(), g)
        back = contentvec_from_fairseq(contentvec_to_fairseq(sd))
    elif model == "crepe":
        sd = _randomised(Crepe("tiny").state_dict(), g)
        back = crepe_from_torchcrepe(crepe_to_torchcrepe(sd))
    else:
        sd = _randomised(Vocos(dim=32, intermediate_dim=48, num_layers=2,
                               n_fft=64).state_dict(), g)
        back = vocos_from_public(vocos_to_public(sd))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_allclose(back[k].numpy(), sd[k].numpy(),
                                   atol=LOADER_ATOL, err_msg=k)


def test_vocos_public_loader_matches_jax_converter(tmp_path):
    sd = _public_vocos_sd(torch.Generator().manual_seed(9))
    got = vocos_from_public(sd)
    want = vocos_from_flax(convert_vocos_state_dict(sd), **VOCOS_KW)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=VOCOS_LOADER_ATOL, err_msg=k)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    vocos = load_vocos(str(tmp_path / "pytorch_model.bin"), hop_length=16)
    assert vocos.head.n_fft == 64 and vocos.backbone.num_layers == 2
    sd["backbone.renamed_upstream.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="not consumed"):
        vocos_from_public(sd)


# -- Svc: features, the whole path, slice_inference ---------------------------

class _JittedApply:
    """A flax module's `apply` under one jax.jit: the JAX Svc calls only
    `contentvec.apply`, and op by op it compiles every primitive of the
    model anew for each clip length (~360 compiles per slice_inference)."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply)


def _jax_svc(cfg, params, cv_tree, cv_module=None):
    s = JSvc(config=cfg, params=params, contentvec_ckpt="",
             contentvec_params=cv_tree)
    if cv_module is not None:   # the JAX Svc builds a full-width ContentVec
        s.contentvec = _JittedApply(cv_module)
    return s


def test_compute_features_matches_jax_full_width_contentvec():
    r = np.random.default_rng(10)
    jcv, tree, cv = _contentvec_pair(r, {})
    cfg = Config()
    jsvc = _jax_svc(cfg, {"params": {}}, tree)
    from ns2vc_tpu_torch.convert import init_params

    svc = Svc(config=cfg, params=init_params(cfg, torch.Generator()),
              contentvec_params=cv.state_dict(), device="cpu")
    wav = _signal(24000, 24000, seed=11)
    c, f0, uv, wav24 = svc.compute_features(wav, 24000, tran=2)
    jc, jf0, juv, jwav24 = jsvc.compute_features(wav, 24000, tran=2)
    np.testing.assert_array_equal(wav24, jwav24)
    np.testing.assert_array_equal(f0, jf0)
    np.testing.assert_array_equal(uv, juv)
    assert c.shape == jc.shape == (len(f0), 256)
    np.testing.assert_allclose(c, jc, atol=CV_ATOL)
    # from 44.1 kHz the resamplers differ in rounding only
    wav44 = _signal(44100, 44100, seed=12)
    c, f0, _, wav24 = svc.compute_features(wav44, 44100)
    jc, jf0, _, jwav24 = jsvc.compute_features(wav44, 44100)
    np.testing.assert_allclose(wav24, jwav24, atol=RESAMPLE_ATOL)
    np.testing.assert_allclose(c, jc, atol=CV_ATOL)
    np.testing.assert_allclose(f0, jf0, rtol=1e-3)


@pytest.fixture(scope="module")
def tiny_pair():
    """A JAX Svc and a port Svc on the tiny configuration with the same
    NaturalSpeech2, ContentVec (dim 64) and Vocos weights."""
    cfg = tiny_config()
    r = np.random.default_rng(13)
    jmodel = jdiff.NaturalSpeech2(cfg)
    batch = {"c": np.zeros((1, 16, 256), np.float32),
             "refer": np.zeros((1, 16, 100), np.float32),
             "spec": np.zeros((1, 16, 100), np.float32),
             "lengths": np.array([16]), "refer_lengths": np.array([16])}
    params = _filled_tree(lambda k: jmodel.init(k, batch, k), r)
    jcv, cv_tree, cv = _contentvec_pair(r, CV_SMALL)
    vkw = dict(VOCOS_KW, n_fft=1024, hop_length=256)
    jvocos = JVocos(**vkw)
    vparams = _filled_tree(jvocos.init, r, np.zeros((1, 16, 100), np.float32))
    jsvc = _jax_svc(cfg, params, cv_tree, jcv)
    jsvc.vocos, jsvc.vocos_params = jvocos, vparams
    svc = Svc(config=cfg, params=from_flax(_np_tree(params), cfg),
              contentvec_params=cv.state_dict(),
              vocos_params=vocos_from_flax(_np_tree(vparams), **vkw),
              device="cpu")
    svc.contentvec = cv             # 4 heads; a state dict implies 1
    return jsvc, svc, jmodel, params, jvocos, vparams


def test_wav_to_wav_path_matches_jax(tiny_pair):
    jsvc, svc, jmodel, params, jvocos, vparams = tiny_pair
    wav = _signal(24000, 24000, seed=14)
    refer = _signal(12000, 24000, seed=15, f=150.0)
    c, _, _, _ = svc.compute_features(wav, 24000)
    jc, _, _, _ = jsvc.compute_features(wav, 24000)
    mel_r, jmel_r = svc.compute_refer_mel(refer, 24000), \
        jsvc.compute_refer_mel(refer, 24000)
    np.testing.assert_allclose(mel_r, jmel_r, atol=MEL_ATOL)
    # padded to 64-frame buckets and masked by length, as Svc serves them
    t, tp = len(c), len(mel_r)
    c_in, jc_in = np.zeros((2, 1, 128, 256), np.float32)
    c_in[0, :t], jc_in[0, :t] = c, jc
    r_in, jr_in = np.zeros((2, 1, 64 * -(-tp // 64), 100), np.float32)
    r_in[0, :tp], jr_in[0, :tp] = mel_r, jmel_r
    rng, steps = jax.random.PRNGKey(3), 4
    want_mel = jdiff.generate_mel(
        jmodel, params, jnp.asarray(jc_in), jnp.asarray(jr_in),
        jnp.asarray([t]), jnp.asarray([tp]), rng, method="unipc",
        steps=steps)
    want_wav = jvocos.apply(vparams, want_mel)
    x_T = np.array(jax.random.normal(jax.random.split(rng)[0],
                                     (1, 128, 100), jnp.float32))
    mel = generate_mel(svc.model, torch.from_numpy(c_in),
                       torch.from_numpy(r_in), torch.tensor([t]),
                       torch.tensor([tp]), x_T=torch.from_numpy(x_T),
                       steps=steps)
    with torch.no_grad():
        got_wav = svc.vocos(mel)
    np.testing.assert_allclose(mel.numpy(), np.asarray(want_mel),
                               atol=PATH_ATOL)
    np.testing.assert_allclose(got_wav.numpy(), np.asarray(want_wav),
                               atol=PATH_ATOL)


def _stub(hop):
    """A deterministic infer_batch: each clip's waveform is a function of
    its frame count only."""
    def infer_batch(clips, refer_mel, **kw):
        return [np.sin(0.01 * np.arange(c.shape[0] * hop) + c.shape[0])
                .astype(np.float32) for c in clips]
    return infer_batch


def _source_wav(sr=44100):
    """~15 s of tone bursts between silences, long enough that the Slicer
    (5 s minimum chunk) cuts it."""
    parts = []
    for i, (tone_s, gap_s) in enumerate([(5.5, 1.0), (6.0, 1.0),
                                         (1.5, 0.5)]):
        parts.append(_signal(int(tone_s * sr), sr, seed=20 + i,
                             f=180.0 + 40 * i))
        parts.append(np.zeros(int(gap_s * sr), np.float32))
    return np.concatenate(parts)


@pytest.mark.parametrize("clip_seconds,lg_seconds", [(0, 0), (2.5, 0.3)])
def test_slice_inference_plan_and_assembly_match_jax(tiny_pair, tmp_path,
                                                     monkeypatch, clip_seconds,
                                                     lg_seconds):
    jsvc, svc, *_ = tiny_pair
    src, ref = tmp_path / "src.wav", tmp_path / "ref.wav"
    write_wav(str(src), _source_wav(), 44100)
    write_wav(str(ref), _signal(24000, 24000, seed=30), 24000)
    calls = {"jax": [], "port": []}
    for name, s in (("jax", jsvc), ("port", svc)):
        stub = _stub(s.hop_size)

        def spy(clips, refer_mel, _stub=stub, _name=name, **kw):
            calls[_name].append([c.shape[0] for c in clips])
            return _stub(clips, refer_mel, **kw)
        monkeypatch.setattr(s, "infer_batch", spy)
    kw = dict(clip_seconds=clip_seconds, lg_seconds=lg_seconds, max_batch=2)
    got = svc.slice_inference(str(src), str(ref), **kw)
    want = jsvc.slice_inference(str(src), str(ref), **kw)
    assert calls["port"] == calls["jax"] and len(calls["port"]) >= 2
    np.testing.assert_array_equal(got, want)
    assert abs(len(got) - int(np.ceil(len(_source_wav()) * 24000 / 44100))) \
        <= 1


def test_load_checkpoint_reads_reference_and_port_files(tiny_pair, tmp_path,
                                                       monkeypatch):
    """A reference model-N.pt goes through the port's copy of the reference
    converter and `from_flax`; a port state dict loads as saved; an orbax
    directory and an F0-predictor configuration raise."""
    from ns2vc_tpu_torch.convert import load_checkpoint
    from ns2vc_tpu_torch.utils import convert_reference

    _, svc, _, params, *_ = tiny_pair
    cfg = svc.cfg
    seen = []

    def natural_speech2(sd):   # stands in for the reference key mapping
        seen.append(sorted(sd))
        return _np_tree(params)["params"]
    monkeypatch.setattr(convert_reference, "natural_speech2", natural_speech2)
    torch.save({"step": 7, "model": {"pre_model.x": torch.zeros(1)}},
               tmp_path / "model-7.pt")
    got = load_checkpoint(str(tmp_path / "model-7.pt"), cfg)
    assert seen == [["pre_model.x"]]
    want = svc.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    torch.save(want, tmp_path / "port.pt")
    port = Svc(str(tmp_path / "port.pt"), config=cfg, contentvec_ckpt="",
               device="cpu")
    assert all(torch.equal(v, want[k])
               for k, v in port.model.state_dict().items())
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(str(tmp_path), cfg)
    f0_cfg = dataclasses.replace(cfg, f0_predictor=dataclasses.replace(
        cfg.f0_predictor, enabled=True))
    # a checkpoint without the F0 predictor's parameters does not load
    # into a model that has it
    with pytest.raises(RuntimeError, match="f0_predictor"):
        Svc(config=f0_cfg, params=want, contentvec_ckpt="", device="cpu")


def test_realtime_vc_crossfades_chunks(tiny_pair):
    _, svc, *_ = tiny_pair
    refer = svc.compute_refer_mel(_signal(12000, 24000, seed=31), 24000)
    rt = RealTimeVC(svc, chunk_seconds=0.5, crossfade_seconds=0.05)
    outs = [rt.process(_signal(12000, 24000, seed=32 + i), 24000, refer,
                       sampling_timesteps=3) for i in range(2)]
    assert [o.shape for o in outs] == [(12000 // 256 * 256,)] * 2
    assert rt.last_tail is not None and len(rt.last_tail) == rt.pre_len
    assert all(np.isfinite(o).all() for o in outs)


def test_f0_filter_and_ac_default(tiny_pair):
    from ns2vc_tpu_torch.infer.svc import F0FilterException

    _, svc, *_ = tiny_pair
    with pytest.raises(F0FilterException):
        svc.compute_f0(np.zeros(24000, np.float32), f0_filter=True)
    from ns2vc_tpu_torch.audio.host import interpolate_f0

    wav = _signal(24000, 24000, seed=33)
    f0, uv = svc.compute_f0(wav, tran=12)
    want_f0, want_uv = interpolate_f0(compute_f0_ac(wav, 24000, 256))
    np.testing.assert_array_equal(f0, want_f0 * 2.0)
    np.testing.assert_array_equal(uv, want_uv)
    assert np.median(f0[uv > 0]) == pytest.approx(440.0, rel=0.05)


# -- the CLI -----------------------------------------------------------------

def test_cli_flags_are_the_jax_clis():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.choices, a.nargs)
                for a in parser._actions}
    assert flags(cli.build_parser()) == flags(jcli.build_parser())
    defaults = vars(cli.build_parser().parse_args(["-m", "x", "-n", "a",
                                                   "-r", "b"]))
    jdefaults = vars(jcli.build_parser().parse_args(["-m", "x", "-n", "a",
                                                     "-r", "b"]))
    assert defaults.pop("device") == "cuda" and jdefaults.pop("device") is None
    assert defaults == jdefaults


def _cli_files(tmp_path):
    """A tiny model, contentvec (fairseq layout with head metadata), Vocos
    (public layout) and config on disk, and a source/refer wav pair."""
    from ns2vc_tpu_torch.convert import init_params

    cfg = dataclasses.replace(tiny_config(), train=Config().train)
    g = torch.Generator().manual_seed(40)
    torch.save(init_params(cfg, g), tmp_path / "model.pt")
    save_config(cfg, str(tmp_path / "config.json"))
    sd = _fairseq_sd(g, dim=64, ffn=128, layers=1, final=256, scale=0.05)
    torch.save({"model": sd, "cfg": {"model": {"encoder_attention_heads": 4}}},
               tmp_path / "cv.pt")
    torch.save(_public_vocos_sd(g, n_fft=1024), tmp_path / "vocos.bin")
    raw = tmp_path / "raw"
    raw.mkdir()
    write_wav(str(raw / "src.wav"), _source_wav()[: 3 * 44100], 44100)
    write_wav(str(raw / "ref.wav"), _signal(24000, 24000, seed=41), 24000)
    return ["-m", str(tmp_path / "model.pt"),
            "-c", str(tmp_path / "config.json"), "-n", "src.wav",
            "-r", "ref", "--contentvec_ckpt", str(tmp_path / "cv.pt"),
            "--vocos_ckpt", str(tmp_path / "vocos.bin"),
            "--raw_dir", str(raw), "--out_dir", str(tmp_path / "out"),
            "--sampling_timesteps", "3", "--compute_dtype", "float32"]


def test_cli_runs_on_cpu_with_explicit_device(tmp_path):
    from ns2vc_tpu_torch.audio.host import read_wav

    argv = _cli_files(tmp_path)
    assert cli.main(argv + ["-d", "cpu", "--sample_method", "ddim"]) == 0
    out, sr = read_wav(str(tmp_path / "out" / "src_0key_ref.wav"))
    assert sr == 24000 and np.isfinite(out).all()
    assert abs(len(out) - int(np.ceil(3 * 44100 * 24000 / 44100))) <= 1


def test_cli_default_device_exits_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = _cli_files(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code not in (0, None) and "-d cpu" in str(e.value.code)
    proc = subprocess.run(
        [sys.executable, "-m", "ns2vc_tpu_torch.infer.cli", *argv],
        capture_output=True, text=True, timeout=300,
        cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not (tmp_path / "out").exists()
