"""The F0 embedding's lookup with a backward in a fixed order, on the CPU.

`ops/embedding.py::embedding_lookup` against `nn.Embedding` (forward bit
for bit, backward allclose 1e-6, with repeated bins), and the F0
PreModel's gradients through it against `jax.grad` of the JAX PreModel on
the same weights, each within 1e-4 of max(1e-3, max|g_jax|) (the F0
suite's bound); K2's backward wrapper on the CPU is its plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu.models import diffusion as jdiff
from ns2vc_tpu.ops.masking import sequence_mask as jsequence_mask
from ns2vc_tpu_torch.convert import _skeleton, from_flax_tree
from ns2vc_tpu_torch.models.diffusion import PreModel
from ns2vc_tpu_torch.ops import embedding as temb
from ns2vc_tpu_torch.ops.embedding import embedding_backward, embedding_lookup
from ns2vc_tpu_torch.ops.fused_resnet import (
    affine_silu_conv1d_backward, affine_silu_conv1d_grad,
)
from ns2vc_tpu_torch.ops.masking import sequence_mask
from test_torch_f0 import configs
from test_torch_slice import _filled_tree

GRAD_RTOL = 1e-4
# gradients that are zero in exact arithmetic, rounding noise on both
# sides: a key projection's bias shifts every score of a query alike (the
# softmax ignores it), and the F0 prenet's LayerNorm normalises one
# channel (x - mean(x) = 0). Held instead to EXACT_ZERO_RTOL of the
# largest gradient of the model
EXACT_ZERO = ("ref_enc.pool.k_proj.bias",
              "f0_predictor.f0_prenet.LayerNorm_0.weight")
EXACT_ZERO_RTOL = 1e-5
B, T, TP = 2, 48, 12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lookup_matches_nn_embedding_with_repeated_bins(dtype):
    r = np.random.default_rng(0)
    # 256 bins, most rows in a few: every bin that occurs repeats
    idx = torch.from_numpy(np.concatenate([
        r.integers(1, 6, (3, 40)), r.integers(0, 256, (3, 24))], axis=1))
    emb = torch.nn.Embedding(256, 24).to(dtype)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(r.standard_normal((256, 24))))
    dy = torch.from_numpy(r.standard_normal((3, 64, 24))).to(dtype)
    w = emb.weight.detach().clone().requires_grad_()
    got = embedding_lookup(idx, w)
    want = emb(idx)
    assert torch.equal(got, want)
    got.backward(dy)
    want.backward(dy)
    assert w.grad.dtype == dtype
    torch.testing.assert_close(w.grad, emb.weight.grad, rtol=1e-6,
                               atol=1e-6)
    counts = torch.bincount(idx.reshape(-1), minlength=256)
    assert (counts > 1).sum() >= 5 and (counts == 0).any()
    assert torch.equal(w.grad[counts == 0], torch.zeros_like(
        w.grad[counts == 0]))


def test_backward_is_one_product_per_bin_and_repeats():
    r = np.random.default_rng(1)
    idx = torch.from_numpy(r.integers(0, 7, (5, 30)))
    dy = torch.from_numpy(r.standard_normal((5, 30, 8)).astype(np.float32))
    got = embedding_backward(idx, dy, 7)
    assert got.shape == (7, 8) and got.dtype == torch.float32
    want = torch.stack([dy.reshape(-1, 8)[idx.reshape(-1) == k].double()
                        .sum(0) for k in range(7)]).float()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, embedding_backward(idx, dy, 7))
    # the lookup's dtype rides back: a bf16 table gets a bf16 gradient
    w = torch.zeros(7, 8, dtype=torch.bfloat16, requires_grad=True)
    embedding_lookup(idx, w).backward(dy.to(torch.bfloat16))
    assert w.grad.dtype == torch.bfloat16


def test_backward_leaves_the_matmul_flags_as_it_found_them():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            embedding_backward(torch.zeros(4, dtype=torch.long),
                               torch.ones(4, 3), 2)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.fixture(scope="module")
def premodels():
    """The JAX PreModel with the F0 predictor, filled weights, and the
    port's PreModel on them (eval: dropout off)."""
    jcfg, cfg = configs()
    r = np.random.default_rng(2)
    c = r.standard_normal((B, T, 256)).astype(np.float32)
    refer = r.standard_normal((B, TP, 100)).astype(np.float32)
    lengths, refer_lengths = np.array([T, 35]), np.array([TP, 7])
    # long stretches on a few pitches: each bin repeats over many frames
    f0 = np.repeat(np.array([[110.0, 0.0, 220.0, 110.0, 330.0, 220.0],
                             [440.0, 110.0, 0.0, 440.0, 220.0, 110.0]],
                            np.float32), T // 6, axis=1)
    f0 = f0 * (1.0 + 1e-3 * r.random((B, T))).astype(np.float32)
    jm = jdiff.PreModel(jcfg)
    args = (c, refer, jsequence_mask(jnp.asarray(lengths), T),
            jsequence_mask(jnp.asarray(refer_lengths), TP))
    params = _filled_tree(lambda k: jm.init(k, *args, f0=f0), r)
    model = PreModel(cfg).eval()
    model.load_state_dict(from_flax_tree(
        jax.tree.map(np.asarray, params), _skeleton(lambda: PreModel(cfg))))
    return {"jm": jm, "params": params, "model": model, "args": args,
            "f0": f0, "lengths": lengths, "refer_lengths": refer_lengths,
            "w_content": r.standard_normal((B, T, 256)).astype(np.float32),
            "w_pred": r.standard_normal((B, T, 1)).astype(np.float32)}


def test_f0_premodel_gradients_through_the_lookup_match_jax(premodels,
                                                            monkeypatch):
    p = premodels
    jm, f0 = p["jm"], p["f0"]

    def loss_fn(params):
        content, _, _, pred = jm.apply(params, *p["args"], f0=f0,
                                       auto_predict_f0=False)
        return (jnp.sum(content * p["w_content"])
                + jnp.sum(pred * p["w_pred"]))
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(p["params"])
    want = from_flax_tree(jax.tree.map(np.asarray, jgrads),
                          _skeleton(lambda: PreModel(configs()[1])))

    backwards = []
    real = temb.embedding_backward

    def counted(*a):
        backwards.append(a[0].shape)
        return real(*a)
    monkeypatch.setattr(temb, "embedding_backward", counted)
    model = p["model"]
    model.zero_grad(set_to_none=True)
    c, refer = (torch.from_numpy(np.asarray(a)) for a in p["args"][:2])
    content, _, _, pred = model(
        c, refer, sequence_mask(torch.from_numpy(p["lengths"]), T),
        sequence_mask(torch.from_numpy(p["refer_lengths"]), TP),
        f0=torch.from_numpy(f0), auto_predict_f0=False)
    loss = (content * torch.from_numpy(p["w_content"])).sum() \
        + (pred * torch.from_numpy(p["w_pred"])).sum()
    loss.backward()
    assert backwards == [(B, T)]
    assert abs(loss.item() - float(jloss)) <= 1e-3 * max(1.0, abs(loss.item()))
    # a parameter the loss does not reach has no grad: JAX's is zero
    grads = {n: torch.zeros_like(q) if q.grad is None else q.grad
             for n, q in model.named_parameters()}
    assert set(grads) == set(want)
    g_emb = grads["f0_emb.weight"]
    assert (g_emb.abs().sum(1) > 0).sum() >= 4
    top = max(v.abs().max().item() for v in want.values())
    bad = {}
    for name, g in grads.items():
        err = (g - want[name]).abs().max().item() / (
            top * EXACT_ZERO_RTOL / GRAD_RTOL if name in EXACT_ZERO
            else max(1e-3, want[name].abs().max().item()))
        if not err <= GRAD_RTOL:
            bad[name] = err
    assert not bad, bad


@pytest.mark.parametrize("keep_f32", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_backward_wrapper_takes_the_plain_version_on_the_cpu(dtype,
                                                                keep_f32):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 20, generator=g).to(dtype)
    a, b = torch.randn(2, 20, generator=g), torch.randn(2, 20, generator=g)
    w = torch.randn(13, 20, 3, generator=g).to(dtype)
    bias = torch.randn(13, generator=g).to(dtype)
    dy = torch.randn(2, 9, 13, generator=g).to(dtype)
    got = affine_silu_conv1d_grad(x, a, b, w, bias, dy, keep_f32=keep_f32)
    args = [v.float() if keep_f32 else v for v in (x, a, b, w, bias, dy)]
    want = affine_silu_conv1d_backward(*args)
    for gv, wv, inp in zip(got, want, (x, a, b, w, bias)):
        assert gv.dtype == (torch.float32 if keep_f32 else inp.dtype)
        assert torch.equal(gv, wv)
