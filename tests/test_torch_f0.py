"""The port's F0-predictor branch against the JAX package's, on the CPU.

Tiny configurations (encoders of one layer, a two-level UNet, a predictor
of one or two attention layers, T <= 64), weights shared through
`convert.from_flax`, numpy inputs from a seed, f32. Tolerances (the JAX
suite's): `f0_to_coarse` bit-equal; the other sequence helpers 1e-6;
`WNConvResidual`, `CrossAttention`, `F0Predictor` and `encode` 2e-5;
`generate_mel`, the loss with `loss_f0` and `Svc.infer` 1e-3; every
gradient within 1e-4 of max(1e-3, max|g_jax|), with dropout off and t,
noise and the F0 scale factor JAX draws injected into the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu import config as jconfig
from ns2vc_tpu.infer.svc import Svc as JSvc
from ns2vc_tpu.models import diffusion as jdiff
from ns2vc_tpu.models import encoders as jenc
from ns2vc_tpu.models.vocos import Vocos as JVocos
from ns2vc_tpu.ops import sequence as jseq
from ns2vc_tpu_torch import config as tconfig
from ns2vc_tpu_torch.convert import (
    from_flax, from_flax_tree, init_params, init_vocos_params, vocos_from_flax,
)
from ns2vc_tpu_torch.infer import svc as svc_mod
from ns2vc_tpu_torch.infer.serve import MicroBatcher
from ns2vc_tpu_torch.infer.svc import Svc
from ns2vc_tpu_torch.models import encoders as tenc
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2, generate_mel
from ns2vc_tpu_torch.ops import sequence as tseq
from test_torch_frontend import CV_SMALL, _contentvec_pair, _signal
from test_torch_slice import VOCOS_KW, _filled_tree


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


ENC_ATOL, PATH_ATOL, GRAD_RTOL, HELPER_ATOL = 2e-5, 1e-3, 1e-4, 1e-6
B, T, TP = 2, 16, 12
LENGTHS, REFER_LENGTHS = np.array([16, 11], np.int32), np.array([12, 7],
                                                                np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def configs(attention_layers=2, p_dropout=0.5, hop_length=256):
    """The F0-predictor configuration, tiny, in both packages."""
    def make(m):
        return m.Config(
            data=m.DataConfig(hop_length=hop_length),
            phoneme_encoder=m.EncoderConfig(n_layers=1),
            prompt_encoder=m.EncoderConfig(in_channels=100, n_layers=1),
            diffusion_encoder=m.DiffusionEncoderConfig(
                block_out_channels=(16, 24)),
            f0_predictor=m.F0PredictorConfig(
                enabled=True, attention_layers=attention_layers,
                p_dropout=p_dropout))
    return make(jconfig), make(tconfig)


def contour(r, b, t):
    """F0 (Hz) with unvoiced stretches, and its voicing."""
    f0 = 120.0 + 150.0 * r.random((b, t))
    f0[:, 3:6] = 0.0
    return f0.astype(np.float32), (f0 > 0).astype(np.float32)


def _batch(r):
    f0, uv = contour(r, B, T)
    return {"c": r.standard_normal((B, T, 256)).astype(np.float32),
            "refer": r.standard_normal((B, TP, 100)).astype(np.float32),
            "spec": r.standard_normal((B, T, 100)).astype(np.float32),
            "f0": f0, "uv": uv, "lengths": LENGTHS,
            "refer_lengths": REFER_LENGTHS}


@pytest.fixture(scope="module")
def pair():
    """The JAX model, filled parameters and the port model on them."""
    jcfg, cfg = configs()
    r = np.random.default_rng(0)
    batch = _batch(r)
    jm = jdiff.NaturalSpeech2(jcfg)
    params = _filled_tree(lambda k: jm.init(k, batch, k), r)
    model = NaturalSpeech2(cfg)
    model.load_state_dict(from_flax(_np(params), cfg))
    return {"jm": jm, "params": params, "model": model.eval(), "cfg": cfg,
            "batch": batch}


# -- sequence helpers ------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_f0_to_coarse_is_bit_equal(dtype):
    r = np.random.default_rng(1)
    f0 = np.concatenate([np.zeros(5), r.uniform(20.0, 2000.0, 4000),
                         [50.0, 1100.0, 3000.0]]).astype(np.float32)
    want = np.asarray(jseq.f0_to_coarse_jnp(jnp.asarray(f0)))
    got = tseq.f0_to_coarse(torch.from_numpy(f0).to(
        torch.float32 if dtype == np.float32 else torch.float64)).numpy()
    if dtype == np.float32:
        np.testing.assert_array_equal(got, want)
    assert got.min() >= 1 and got.max() <= 255
    assert got[:5].tolist() == [1] * 5


def test_normalize_f0_matches_jax():
    r = np.random.default_rng(2)
    lf0 = r.standard_normal((3, 10, 1)).astype(np.float32)
    uv = (r.random((3, 10)) > 0.3).astype(np.float32)
    uv[2] = 0.0                       # all unvoiced: the 9999 guard
    rng = jax.random.PRNGKey(4)
    want = np.asarray(jseq.normalize_f0_jnp(jnp.asarray(lf0),
                                            jnp.asarray(uv), rng))
    factor = np.asarray(jax.random.uniform(rng, (3, 1), minval=0.8,
                                           maxval=1.2))[:, 0]
    got = tseq.normalize_f0(_t(lf0), _t(uv), factor=_t(factor))
    np.testing.assert_allclose(got.numpy(), want, atol=HELPER_ATOL)
    plain = tseq.normalize_f0(_t(lf0), _t(uv))
    np.testing.assert_allclose(plain.numpy(), np.asarray(
        jseq.normalize_f0_jnp(jnp.asarray(lf0), jnp.asarray(uv))),
        atol=HELPER_ATOL)
    drawn = tseq.normalize_f0(_t(lf0), _t(uv),
                              generator=torch.Generator().manual_seed(0))
    ratio = drawn[:, :, 0] / plain[:, :, 0]
    assert ((ratio > 0.8) & (ratio < 1.2)).all()


def _helper_cases():
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 12, 6)).astype(np.float32)
    ids = np.array([0, 7])
    dur = np.array([[[2.0, 0.0, 3.0, 1.0]], [[1.0, 4.0, 1.0, 0.0]]],
                   np.float32)
    mask = np.ones((2, 1, 8, 4), np.float32)
    mask[1, :, 6:] = 0.0
    m = [r.standard_normal((2, 5)).astype(np.float32) for _ in range(4)]
    a, b = (r.standard_normal((2, 5, 8)).astype(np.float32) for _ in range(2))
    return {
        "slice_segments": (lambda: tseq.slice_segments(_t(x), _t(ids), 5),
                           lambda: jseq.slice_segments(x, ids, 5)),
        "timing_signal": (lambda: tseq.get_timing_signal_1d(9, 7),
                          lambda: jseq.get_timing_signal_1d(9, 7)),
        "add_timing_signal": (lambda: tseq.add_timing_signal_1d(_t(x)),
                              lambda: jseq.add_timing_signal_1d(x)),
        "cat_timing_signal": (lambda: tseq.cat_timing_signal_1d(_t(x)),
                              lambda: jseq.cat_timing_signal_1d(x)),
        "subsequent_mask": (lambda: tseq.subsequent_mask(6),
                            lambda: jseq.subsequent_mask(6)),
        "generate_path": (lambda: tseq.generate_path(_t(dur), _t(mask)),
                          lambda: jseq.generate_path(dur, mask)),
        "kl_divergence": (lambda: tseq.kl_divergence(*map(_t, m)),
                          lambda: jseq.kl_divergence(*m)),
        "wavenet_gate": (
            lambda: tseq.fused_add_tanh_sigmoid_multiply(_t(a), _t(b), 4),
            lambda: jseq.fused_add_tanh_sigmoid_multiply(a, b, 4)),
    }


@pytest.mark.parametrize("name", sorted(_helper_cases()))
def test_sequence_helper_matches_jax(name):
    got, want = (f() for f in _helper_cases()[name])
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               np.asarray(want).astype(np.float64),
                               atol=HELPER_ATOL)


def test_random_helpers_draw_in_range():
    x = torch.arange(40.0).reshape(2, 20, 1)
    g = torch.Generator().manual_seed(0)
    seg, ids = tseq.rand_slice_segments(x, g, torch.tensor([20, 6]), 4)
    assert seg.shape == (2, 4, 1) and 0 <= ids[1] <= 2
    assert torch.equal(seg[:, :, 0], x[0, 0, 0] + ids[:, None].float()
                       + torch.arange(4.0) + torch.tensor([[0.0], [20.0]]))
    gum = tseq.rand_gumbel((1000,), torch.Generator().manual_seed(1))
    assert torch.isfinite(gum).all() and abs(gum.mean().item() - 0.5772) < 0.1


# -- modules -----------------------------------------------------------------


def _module_pair(jmod, tmod, *args):
    r = np.random.default_rng(5)
    params = _filled_tree(lambda k, *a: jmod.init(k, *a), r, *args)
    tmod.load_state_dict(from_flax_tree(_np(params), tmod))
    return params, tmod.eval()


def test_wn_conv_residual_matches_jax():
    r = np.random.default_rng(6)
    x = r.standard_normal((B, T, 32)).astype(np.float32)
    mask = np.arange(T)[None] < LENGTHS[:, None]
    jm = jenc.WNConvResidual(32, 5, 0.5)
    params, tm = _module_pair(jm, tenc.WNConvResidual(32, 5, 0.5), x, mask)
    want = jm.apply(params, x, mask)
    with torch.no_grad():
        got = tm(_t(x), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ENC_ATOL)


def test_cross_attention_matches_jax():
    r = np.random.default_rng(7)
    x = r.standard_normal((B, T, 32)).astype(np.float32)
    mem = r.standard_normal((B, TP, 32)).astype(np.float32)
    mem_mask = np.arange(TP)[None] < REFER_LENGTHS[:, None]
    jm = jenc.CrossAttention(32, 4)
    params, tm = _module_pair(jm, tenc.CrossAttention(32, 4), x, mem,
                              mem_mask)
    want = jm.apply(params, x, mem, mem_mask)
    with torch.no_grad():
        got = tm(_t(x), _t(mem), _t(mem_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ENC_ATOL)


def _predictor_pair():
    r = np.random.default_rng(8)
    x = r.standard_normal((B, T, 32)).astype(np.float32)
    prompt = r.standard_normal((B, TP, 32)).astype(np.float32)
    f0 = r.standard_normal((B, T, 1)).astype(np.float32)
    x_mask = np.arange(T)[None] < LENGTHS[:, None]
    p_mask = np.arange(TP)[None] < REFER_LENGTHS[:, None]
    kw = dict(in_channels=32, hidden_channels=32, attention_layers=2,
              n_heads=4)
    jm = jenc.F0Predictor(**kw)
    params, tm = _module_pair(jm, tenc.F0Predictor(**kw), x, prompt, f0,
                              x_mask, p_mask)
    return jm, params, tm, (x, prompt, f0, x_mask, p_mask)


def test_f0_predictor_matches_jax():
    jm, params, tm, args = _predictor_pair()
    want = jm.apply(params, *args)
    with torch.no_grad():
        got = tm(*map(_t, args))
    assert got.shape == (B, T, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ENC_ATOL)


def test_the_predictor_never_sees_the_contour():
    """f0_prenet's LayerNorm over one channel outputs its bias: two
    contours give the same prediction, in both packages."""
    jm, params, tm, (x, prompt, f0, x_mask, p_mask) = _predictor_pair()
    other = 5.0 * np.random.default_rng(9).standard_normal(f0.shape).astype(
        np.float32)
    a = np.asarray(jm.apply(params, x, prompt, f0, x_mask, p_mask))
    b = np.asarray(jm.apply(params, x, prompt, other, x_mask, p_mask))
    np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        ta = tm(_t(x), _t(prompt), _t(f0), _t(x_mask), _t(p_mask))
        tb = tm(_t(x), _t(prompt), _t(other), _t(x_mask), _t(p_mask))
    assert torch.equal(ta, tb)


# -- the model --------------------------------------------------------------


def _masks(batch):
    return (np.arange(T)[None] < batch["lengths"][:, None],
            np.arange(TP)[None] < batch["refer_lengths"][:, None])


@pytest.mark.parametrize("auto", [False, True])
def test_encode_matches_jax(pair, auto):
    b = pair["batch"]
    cm, rm = _masks(b)
    want = pair["jm"].apply(pair["params"], b["c"], b["refer"], cm, rm,
                            f0=b["f0"], uv=b["uv"], auto_predict_f0=auto,
                            method=jdiff.NaturalSpeech2.encode)
    with torch.no_grad():
        got = pair["model"].encode(_t(b["c"]), _t(b["refer"]), _t(cm),
                                   _t(rm), f0=_t(b["f0"]), uv=_t(b["uv"]),
                                   auto_predict_f0=auto)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ENC_ATOL)
    # the F0 embedding is on the content: without f0 it differs
    with torch.no_grad():
        bare, _, lf0, pred = pair["model"].pre_model(
            _t(b["c"]), _t(b["refer"]), _t(cm), _t(rm))
    assert lf0 is None and pred is None
    assert not torch.allclose(bare, got[0])


@pytest.mark.parametrize("auto", [False, True])
def test_generate_mel_matches_jax(pair, auto):
    b = pair["batch"]
    rng, steps = jax.random.PRNGKey(7), 4
    want = jdiff.generate_mel(
        pair["jm"], pair["params"], b["c"], b["refer"], b["lengths"],
        b["refer_lengths"], rng, method="unipc", steps=steps, f0=b["f0"],
        uv=b["uv"], auto_predict_f0=auto)
    x_T = np.array(jax.random.normal(jax.random.split(rng)[0], (B, T, 100),
                                     jnp.float32))
    got = generate_mel(pair["model"], _t(b["c"]), _t(b["refer"]),
                       _t(b["lengths"]), _t(b["refer_lengths"]),
                       x_T=_t(x_T), steps=steps, f0=_t(b["f0"]),
                       uv=_t(b["uv"]), auto_predict_f0=auto)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PATH_ATOL)


@pytest.fixture(scope="module")
def grad_pair(pair):
    """JAX's loss (deterministic) and its gradients, and the draws of t,
    noise and the F0 scale factor it made."""
    rng = jax.random.PRNGKey(3)
    jm, params, b = pair["jm"], pair["params"], pair["batch"]

    def loss_fn(p):
        loss, aux = jm.apply(p, b, rng, deterministic=True)
        return loss, aux["loss_f0"]
    (loss, loss_f0), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    t_rng, n_rng, f0_rng = jax.random.split(rng, 3)
    return {"loss": float(loss), "loss_f0": float(loss_f0),
            "grads": from_flax(_np(grads), pair["cfg"]),
            "t": np.asarray(jax.random.randint(t_rng, (B,), 0, 1000)),
            "noise": np.asarray(jax.random.normal(n_rng, (B, T, 100))),
            "factor": np.asarray(jax.random.uniform(
                f0_rng, (B, 1), minval=0.8, maxval=1.2))[:, 0]}


def test_loss_with_loss_f0_and_gradients_match_jax(pair, grad_pair):
    model = pair["model"]
    model.zero_grad(set_to_none=True)
    loss, aux = model({k: _t(v) for k, v in pair["batch"].items()},
                      t=_t(grad_pair["t"]), noise=_t(grad_pair["noise"]),
                      f0_factor=_t(grad_pair["factor"]))
    loss.backward()
    assert abs(loss.item() - grad_pair["loss"]) <= PATH_ATOL
    assert abs(aux["loss_f0"].item() - grad_pair["loss_f0"]) <= PATH_ATOL
    assert aux["loss_f0"].item() > 0
    want = grad_pair["grads"]
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    assert any(n.startswith("pre_model.f0_predictor.") for n in grads)
    bad = {}
    for name, g in grads.items():
        scale = max(1e-3, want[name].abs().max().item())
        err = (g - want[name]).abs().max().item() / scale
        if not err <= GRAD_RTOL:
            bad[name] = err
    assert not bad, bad
    # the predictor reads content and prompt detached: its loss reaches
    # only its own parameters
    model.zero_grad(set_to_none=True)
    _, aux = model({k: _t(v) for k, v in pair["batch"].items()},
                   t=_t(grad_pair["t"]), noise=_t(grad_pair["noise"]))
    aux["loss_f0"].backward()
    moved = {n for n, p in model.named_parameters()
             if p.grad is not None and p.grad.abs().max() > 0}
    assert moved and all(n.startswith("pre_model.f0_predictor.")
                         for n in moved)


def test_training_mode_draws_dropout_and_factor(pair):
    model = NaturalSpeech2(pair["cfg"])
    model.load_state_dict(pair["model"].state_dict())
    model.train()
    batch = {k: _t(v) for k, v in pair["batch"].items()}
    losses = [model(batch, torch.Generator().manual_seed(s))[1]["loss_f0"]
              for s in (0, 0, 1)]
    assert losses[0].item() == losses[1].item() != losses[2].item()
    with pytest.raises(ValueError, match="generator"):
        model(batch, t=torch.zeros(B, dtype=torch.long),
              noise=torch.zeros(B, T, 100))


# -- serving -----------------------------------------------------------------


@pytest.fixture(scope="module")
def svc_pair():
    """A JAX Svc and a port Svc on the predictor configuration with the
    same model, ContentVec (dim 64) and Vocos weights."""
    jcfg, cfg = configs(attention_layers=1)
    r = np.random.default_rng(13)
    jmodel = jdiff.NaturalSpeech2(jcfg)
    batch = _batch(r)
    params = _filled_tree(lambda k: jmodel.init(k, batch, k), r)
    jcv, cv_tree, cv = _contentvec_pair(r, CV_SMALL)
    vkw = dict(VOCOS_KW, n_fft=1024, hop_length=256)
    jvocos = JVocos(**vkw)
    vparams = _filled_tree(jvocos.init, r, np.zeros((1, 16, 100), np.float32))
    jsvc = JSvc(config=jcfg, params=params, contentvec_ckpt="",
                contentvec_params=cv_tree)
    jsvc.contentvec = jcv
    jsvc.vocos, jsvc.vocos_params = jvocos, vparams
    svc = Svc(config=cfg, params=from_flax(_np(params), cfg),
              contentvec_params=cv.state_dict(),
              vocos_params=vocos_from_flax(_np(vparams), **vkw),
              device="cpu")
    svc.contentvec = cv
    return jsvc, svc


def _jax_noise(monkeypatch, seed):
    """The port Svc's sampler starts from the x_T the JAX Svc draws from
    PRNGKey(seed), in place of the one its serving program drew."""
    real = svc_mod.generate_mel

    def gm(model, c, *args, **kwargs):
        x_T = jax.random.normal(jax.random.split(jax.random.PRNGKey(seed))[0],
                                (c.shape[0], c.shape[1], 100), jnp.float32)
        return real(model, c, *args, **{**kwargs, "x_T": _t(np.array(x_T))})
    monkeypatch.setattr(svc_mod, "generate_mel", gm)


@pytest.mark.parametrize("auto", [False, True])
def test_svc_infer_matches_jax(svc_pair, tmp_path, monkeypatch, auto):
    from ns2vc_tpu_torch.utils.wavio import write_wav

    jsvc, svc = svc_pair
    write_wav(str(tmp_path / "src.wav"), _signal(24000, 24000, seed=14),
              24000)
    write_wav(str(tmp_path / "ref.wav"), _signal(12000, 24000, seed=15,
                                                 f=150.0), 24000)
    _jax_noise(monkeypatch, 0)
    kw = dict(auto_predict_f0=auto, sampling_timesteps=3, seed=0)
    want, n = jsvc.infer(0, str(tmp_path / "src.wav"),
                         str(tmp_path / "ref.wav"), **kw)
    got, m = svc.infer(0, str(tmp_path / "src.wav"),
                       str(tmp_path / "ref.wav"), **kw)
    assert n == m and got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=PATH_ATOL)


def test_svc_needs_f0_with_the_predictor(svc_pair):
    _, svc = svc_pair
    r = np.random.default_rng(9)
    c = r.standard_normal((40, 256)).astype(np.float32)
    refer = r.standard_normal((30, 100)).astype(np.float32)
    for kw in ({}, {"auto_predict_f0": True}):
        with pytest.raises(ValueError, match="f0_predictor.enabled"):
            svc.infer_from_features(c, refer, sampling_timesteps=3, **kw)
    with pytest.raises(ValueError, match="f0_predictor.enabled"):
        svc.infer_batch([c], refer, sampling_timesteps=3)


def _tiny_svc(**cfg_kw):
    _, cfg = configs(attention_layers=1, hop_length=VOCOS_KW["hop_length"],
                     **cfg_kw)
    g = torch.Generator().manual_seed(0)
    return Svc(config=cfg, params=init_params(cfg, g),
               vocos_params=init_vocos_params(g, **VOCOS_KW), device="cpu")


def test_f0_reaches_the_model_on_every_serving_path():
    """infer_batch, infer_from_features and the MicroBatcher (whose mixed
    batches pad missing contours with unvoiced zeros) condition on the
    clips' f0; with auto_predict_f0 the given contour stops mattering."""
    svc = _tiny_svc()
    r = np.random.default_rng(10)
    clips = [r.standard_normal((n, 256)).astype(np.float32) for n in (40, 30)]
    refer = r.standard_normal((20, 100)).astype(np.float32)
    f0s = [contour(r, 1, len(c))[0][0] for c in clips]
    uvs = [(f > 0).astype(np.float32) for f in f0s]
    kw = dict(sampling_timesteps=3, seed=3)
    base = svc.infer_batch(clips, refer, f0s=f0s, uvs=uvs, **kw)
    high = svc.infer_batch(clips, refer, f0s=[4 * f for f in f0s], uvs=uvs,
                           **kw)
    assert not np.allclose(base[0], high[0])
    auto = [svc.infer_batch(clips, refer, f0s=f, uvs=uvs,
                            auto_predict_f0=True, **kw)
            for f in (f0s, [4 * f for f in f0s])]
    np.testing.assert_array_equal(auto[0][0], auto[1][0])
    single = svc.infer_from_features(clips[0], refer, f0=f0s[0], uv=uvs[0],
                                     **kw)
    np.testing.assert_array_equal(single, svc.infer_batch(
        clips[:1], refer, f0s=f0s[:1], uvs=uvs[:1], **kw)[0])
    # max_batch 2: each pair of submissions is one batch of two
    with MicroBatcher(svc, refer, max_batch=2, flush_ms=5e3, pad_batch=None,
                      **kw) as mb:
        futs = [mb.submit(c, f, u) for c, f, u in zip(clips, f0s, uvs)]
        got = [f.result(timeout=120) for f in futs]
    for g, w in zip(got, base):
        np.testing.assert_allclose(g, w, atol=1e-5)
    with MicroBatcher(svc, refer, max_batch=2, flush_ms=5e3, pad_batch=None,
                      **kw) as mb:
        futs = [mb.submit(clips[0], f0s[0], uvs[0]), mb.submit(clips[1])]
        mixed = [f.result(timeout=120) for f in futs]
    zero = svc.infer_batch(clips, refer, f0s=[f0s[0], np.zeros(30)],
                           uvs=[uvs[0], None], **kw)
    for g, w in zip(mixed, zero):
        np.testing.assert_allclose(g, w, atol=1e-5)


def test_trainer_serves_a_predictor_checkpoint(tmp_path):
    """The Trainer with the predictor on: loss_f0 logged beside loss_diff,
    the predictor's parameters in the optimizer, EMA and checkpoint, and
    Svc serving the checkpoint with f0."""
    import json
    import os

    from test_torch_train import _trainer_config
    from ns2vc_tpu_torch.train.trainer import Trainer

    cfg = _trainer_config(str(tmp_path))
    cfg = dataclasses.replace(cfg, f0_predictor=dataclasses.replace(
        cfg.f0_predictor, enabled=True, attention_layers=1))
    vsd = init_vocos_params(torch.Generator().manual_seed(3), dim=32,
                            intermediate_dim=48, num_layers=1,
                            hop_length=256)
    tr = Trainer(cfg, logs_folder=str(tmp_path / "run"), vocos_params=vsd,
                 device="cpu")
    names = {n for n, _ in tr.model.named_parameters()}
    assert "pre_model.f0_emb.weight" in names
    opt = {id(p) for g in tr.state.optimizer.param_groups
           for p in g["params"]}
    assert all(id(p) in opt for n, p in tr.model.named_parameters()
               if "f0_" in n)
    assert set(tr.state.ema_params) == names
    batch = tr.device_batch(next(tr.loader()))
    assert "f0" in batch and "uv" in batch
    m = tr.train_step(batch)
    assert m["loss_f0"].item() > 0
    assert m["loss"].item() == pytest.approx(
        m["loss_diff"].item() + m["loss_f0"].item(), rel=1e-6)
    tr.train()
    with open(os.path.join(tr.logs_folder, "scalars.jsonl")) as f:
        records = [json.loads(ln) for ln in f if "loss/f0" in ln]
    assert records and all(r["loss/f0"] > 0 and np.isfinite(r["loss/diff"])
                           for r in records)
    path = tr.save()
    tr.close()
    svc = Svc(path, config=cfg, vocos_params=vsd, contentvec_ckpt="",
              device="cpu")
    got = svc.model.state_dict()
    for k, v in tr.state.ema_params.items():
        assert torch.equal(got[k], v), k
    r = np.random.default_rng(6)
    f0, uv = contour(r, 1, 30)
    wav = svc.infer_from_features(
        r.standard_normal((30, 256)).astype(np.float32),
        r.standard_normal((20, 100)).astype(np.float32),
        sampling_timesteps=3, f0=f0[0], uv=uv[0], auto_predict_f0=True)
    assert wav.shape == (30 * 256,) and np.isfinite(wav).all()
