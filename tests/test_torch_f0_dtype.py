"""The F0 predictor's dtypes under a bf16 model, and when it runs at all,
against the JAX package on the CPU.

Under bf16, JAX's F0 predictor promotes: `f0_prenet` takes the f32
normalised F0, so the trunk, `q_proj`, `proj` and the prediction are f32
while `pre`, `k_proj`, `v_proj` and `out_proj` stay bf16. The port's bf16
PreModel and `encode` are held against JAX's bf16 ones (parameters cast
with `cast_floating`, content and reference in bf16, F0 and voicing in
f32) on seeded weights of a small model (encoders of one layer, a
predictor of 2 layers at hidden 64), and the bf16 predictor alone on the
same bf16 inputs. Tolerances:
- content and prompt, ENC_BF16_ATOL: both packages round the same bf16
  encoders in other orders (values up to ~4, where a bf16 step is 2^-6);
  with `auto_predict_f0` the content is compared on the frames whose
  predicted coarse F0 bin (which picks the F0 embedding) is the same;
- lf0_pred of the whole PreModel, PRED_ENC_ATOL: the f32 trunk carries
  those bf16 differences of its inputs (and its own bf16 `pre` layer's)
  40 layers deep (0.020 here). This limit would pass a bf16 trunk too
  (0.027 at hidden 256): what holds the predictor's dtype to JAX's is
  PRED_ATOL below, with the dtype asserts here;
- lf0_pred of the predictor alone, PRED_ATOL, with JAX's output of the
  bf16 `pre` layer and its bf16 weight-normed conv kernels (XLA sums the
  bf16 norm in another order than torch: a step of 2^-8 in a channel's
  scale) given to both, as their rounding differences would otherwise
  dominate: what is left is the trunk's precision and the rare bf16
  rounding flips of the projections (f32 trunk: 4.8e-7 at hidden 64,
  6.5e-4 at 256; a bf16 trunk 1.0e-2 and 1.4e-2).

In eval with `auto_predict_f0` False, `encode` and `generate_mel` discard
the prediction, so the port skips the predictor there, as XLA drops it from
the JAX program; training and a PreModel call, which read it, still run it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from ns2vc_tpu.models import diffusion as jdiff
from ns2vc_tpu.models import encoders as jenc
from ns2vc_tpu.ops import sequence as jseq
from ns2vc_tpu.utils.precision import cast_floating
from ns2vc_tpu_torch.convert import from_flax, init_module_
from ns2vc_tpu_torch.models import encoders as tenc
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2, generate_mel
from ns2vc_tpu_torch.ops.sequence import f0_to_coarse
from test_torch_f0 import (
    B, LENGTHS, REFER_LENGTHS, T, TP, _batch, _masks, _module_pair, _np, _t,
    configs,
)
from test_torch_slice import _filled_tree

ENC_BF16_ATOL = 6e-2
PRED_ENC_ATOL = 5e-2
PRED_ATOL = 2e-3


def _small(cfgs):
    """Both configurations with the predictor at hidden 64."""
    return [dataclasses.replace(c, f0_predictor=dataclasses.replace(
        c.f0_predictor, hidden_channels=64)) for c in cfgs]


@pytest.fixture(scope="module")
def bf16_pair():
    jcfg, cfg = _small(configs(attention_layers=2))
    r = np.random.default_rng(11)
    batch = _batch(r)
    jm = jdiff.NaturalSpeech2(jcfg)
    params = _filled_tree(lambda k: jm.init(k, batch, k), r)
    model = NaturalSpeech2(cfg)
    model.load_state_dict(from_flax(_np(params), cfg))
    return {"jm": jm, "params": cast_floating(params, jax.numpy.bfloat16),
            "model": model.to(torch.bfloat16).eval(), "batch": batch}


def _jax_pre_model(pair, auto):
    b = pair["batch"]
    cm, rm = _masks(b)
    bf16 = jax.numpy.bfloat16
    return pair["jm"].apply(
        pair["params"], b["c"].astype(bf16), b["refer"].astype(bf16), cm, rm,
        f0=b["f0"], uv=b["uv"], auto_predict_f0=auto,
        method=lambda m, *a, **k: m.pre_model(*a, **k))


def _port_inputs(pair):
    b = pair["batch"]
    cm, rm = _masks(b)
    return ((_t(b["c"]).bfloat16(), _t(b["refer"]).bfloat16(), _t(cm),
             _t(rm)), {"f0": _t(b["f0"]), "uv": _t(b["uv"])})


def _err(got, want):
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


def _coarse(lf0_pred):
    """The coarse F0 bins the F0 embedding takes from a prediction."""
    lf0 = torch.from_numpy(np.array(lf0_pred, np.float32)[..., 0])
    return f0_to_coarse(700.0 * (10.0 ** (lf0 * 500.0 / 2595.0) - 1.0))


@pytest.mark.parametrize("auto", [False, True])
def test_bf16_encode_matches_jax(bf16_pair, auto):
    """bf16 PreModel and encode: content and prompt in bf16, the
    prediction in f32 as JAX's, each within its tolerance of JAX's."""
    content, prompt, _, pred = _jax_pre_model(bf16_pair, auto)
    assert pred.dtype == np.float32 and content.dtype == jax.numpy.bfloat16
    args, kw = _port_inputs(bf16_pair)
    with torch.no_grad():
        got = bf16_pair["model"].pre_model(*args, auto_predict_f0=auto, **kw)
        enc = bf16_pair["model"].encode(*args, auto_predict_f0=auto, **kw)
    assert got[0].dtype == torch.bfloat16 and got[3].dtype == torch.float32
    assert got[3].shape == (B, T, 1)
    same = torch.ones(B, T, dtype=torch.bool)
    if auto:   # the embedding follows each package's own prediction
        same = _coarse(got[3]) == _coarse(pred)
        assert same.float().mean() >= 0.75
    diff = (got[0].float() - torch.from_numpy(np.asarray(content,
                                                         np.float32))).abs()
    errs = {"content": diff[same].max().item(),
            "prompt": _err(got[1], prompt), "lf0_pred": _err(got[3], pred)}
    assert errs["content"] <= ENC_BF16_ATOL, errs
    assert errs["prompt"] <= ENC_BF16_ATOL, errs
    assert errs["lf0_pred"] <= PRED_ENC_ATOL, errs
    for g, w in zip(enc, got[:2]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("hidden", [64, 256])
def test_bf16_predictor_matches_jax(monkeypatch, hidden):
    """The predictor alone under bf16 parameters, on the same bf16 content
    and prompt and f32 normalised F0 in both packages, each given JAX's
    output of the bf16 `pre` layer and JAX's bf16 weight-normed kernels:
    an f32 prediction within PRED_ATOL."""
    r = np.random.default_rng(13)
    bf16 = jax.numpy.bfloat16
    x, prompt = (np.asarray(jax.numpy.asarray(
        r.standard_normal((B, n, hidden)), bf16), np.float32)
        for n in (T, TP))
    x_mask = np.arange(T)[None] < LENGTHS[:, None]
    p_mask = np.arange(TP)[None] < REFER_LENGTHS[:, None]
    uv = (r.random((B, T)) > 0.2).astype(np.float32)
    norm = np.asarray(jseq.normalize_f0_jnp(
        r.standard_normal((B, T, 1)).astype(np.float32), uv))
    kw = dict(in_channels=hidden, hidden_channels=hidden, attention_layers=2,
              n_heads=8)
    jm = jenc.F0Predictor(**kw)
    params, tm = _module_pair(jm, tenc.F0Predictor(**kw), x, prompt, norm,
                              x_mask, p_mask)
    want, inter = jm.apply(cast_floating(params, bf16), x.astype(bf16),
                           prompt.astype(bf16), norm, x_mask, p_mask,
                           capture_intermediates=True,
                           mutable=["intermediates"])
    pre = torch.from_numpy(np.asarray(
        inter["intermediates"]["pre"]["__call__"][0], np.float32)).bfloat16()
    tm.to(torch.bfloat16)
    monkeypatch.setattr(tm.pre, "forward", lambda h, mask=None: pre)
    for name, p in cast_floating(params, bf16)["params"].items():
        if name.startswith("conv_"):   # XLA's bf16 weight norm, as applied
            v, g = p["conv_v"], p["conv_g"]
            kernel = v * (g / jax.numpy.linalg.norm(
                v.reshape(-1, v.shape[-1]), axis=0))[None, None, :]
            w = torch.from_numpy(np.asarray(kernel, np.float32)).bfloat16()
            monkeypatch.setattr(getattr(tm, name), "weight",
                                lambda w=w.permute(2, 1, 0): w)
    with torch.no_grad():
        got = tm(_t(x).bfloat16(), _t(prompt).bfloat16(), _t(norm),
                 _t(x_mask), _t(p_mask))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert _err(got, want) <= PRED_ATOL


def test_bf16_predictor_trunk_is_f32(bf16_pair, monkeypatch):
    """Under the bf16 model every cross-attention takes q in f32 and k, v
    in bf16 and returns bf16; the projections promote as flax's Dense."""
    seen = []
    attention = tenc.multihead_attention

    def record(q, k, v, heads, bias=None):
        out = attention(q, k, v, heads, bias=bias)
        seen.append((q.dtype, k.dtype, v.dtype, out.dtype))
        return out
    monkeypatch.setattr(tenc, "multihead_attention", record)
    args, kw = _port_inputs(bf16_pair)
    with torch.no_grad():
        bf16_pair["model"].pre_model(*args, **kw)
    bf16, f32 = torch.bfloat16, torch.float32
    # 2 predictor cross-attentions; the encoders' self-attention stays bf16
    assert seen.count((f32, bf16, bf16, bf16)) == 2
    assert all(s == (bf16,) * 4 for s in seen if s[0] != f32)


def _count_predictor_calls(monkeypatch):
    calls = []
    forward = tenc.F0Predictor.forward

    def counted(self, *a, **k):
        calls.append(1)
        return forward(self, *a, **k)
    monkeypatch.setattr(tenc.F0Predictor, "forward", counted)
    return calls


@pytest.mark.parametrize("auto", [False, True])
def test_encode_skips_the_unused_predictor(bf16_pair, monkeypatch, auto):
    """Eval without auto_predict_f0: encode never runs the predictor and
    gives the content of a PreModel call that runs it; with auto on it
    runs once."""
    args, kw = _port_inputs(bf16_pair)
    model = bf16_pair["model"]
    with torch.no_grad():
        full = model.pre_model(*args, auto_predict_f0=auto, **kw)
    calls = _count_predictor_calls(monkeypatch)
    with torch.no_grad():
        content, prompt = model.encode(*args, auto_predict_f0=auto, **kw)
    assert len(calls) == int(auto)
    assert torch.equal(content, full[0]) and torch.equal(prompt, full[1])
    b = bf16_pair["batch"]
    generate_mel(model, args[0], args[1], _t(b["lengths"]),
                 _t(b["refer_lengths"]), x_T=torch.zeros(B, T, 100),
                 method="ddim", steps=1, auto_predict_f0=auto, **kw)
    assert len(calls) == 2 * int(auto)


def test_training_still_runs_the_predictor(monkeypatch):
    """The training loss reads lf0_pred: with auto_predict_f0 off (as
    training passes it) the predictor runs in train mode, and its f32 L1
    enters the loss; a PreModel call in eval that asks for the prediction
    runs it too."""
    _, cfg = _small(configs(attention_layers=1, p_dropout=0.0))
    model = init_module_(NaturalSpeech2(cfg), torch.Generator().manual_seed(0))
    b = _batch(np.random.default_rng(12))
    batch = {k: _t(v) for k, v in b.items()}
    calls = _count_predictor_calls(monkeypatch)
    loss, aux = model.train()(batch, torch.Generator().manual_seed(0))
    assert len(calls) == 1 and aux["loss_f0"].dtype == torch.float32
    assert torch.isfinite(loss)
    args, kw = _port_inputs({"batch": b})
    with torch.no_grad():
        pred = model.eval().pre_model(args[0].float(), args[1].float(),
                                      *args[2:], auto_predict_f0=False,
                                      **kw)[3]
    assert len(calls) == 2 and pred.shape == (B, T, 1)
