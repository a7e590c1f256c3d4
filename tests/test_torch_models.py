"""The port's modules against the JAX package's, module by module.

Each JAX module is initialised with flax, its parameters go through
`ns2vc_tpu_torch.convert`, and both sides run the same numpy inputs in f32
(JAX at the conftest's `highest` matmul precision). Tolerances: encoders
2e-5, one UNet forward 5e-4, Vocos 1e-4 on the waveform (the JAX suite's
own bounds for these modules).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu.models import encoders as jenc
from ns2vc_tpu.models import unet as junet
from ns2vc_tpu.models import vocos as jvocos
from ns2vc_tpu_torch.convert import from_flax_tree
from ns2vc_tpu_torch.models import encoders as tenc
from ns2vc_tpu_torch.models import unet as tunet
from ns2vc_tpu_torch.models import vocos as tvocos

ENC_ATOL, UNET_ATOL, VOCOS_ATOL = 2e-5, 5e-4, 1e-4


def _load(tmod, jparams):
    tmod.load_state_dict(from_flax_tree(jax.tree.map(np.asarray, jparams),
                                        tmod))
    return tmod.eval()


def _rand(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("kind", ["phone", "prompt"])
def test_encoders_match(kind, rng):
    b, t, hidden, n_layers = 2, 13, 32, 2
    lengths = np.array([13, 8])
    mask = np.arange(t)[None] < lengths[:, None]
    if kind == "phone":
        # the speaker projection adds onto x: in_channels == hidden
        x, g = _rand(rng, b, t, hidden), _rand(rng, b, 12)
        jm = jenc.PhoneEncoder(in_channels=hidden, hidden_channels=hidden,
                               out_channels=hidden, n_layers=n_layers)
        params = jm.init(jax.random.PRNGKey(1), x, mask, g)
        want = jm.apply(params, x, mask, g)
        tm = _load(tenc.PhoneEncoder(hidden, hidden, hidden, n_layers,
                                     g_channels=12), params)
        got = tm(_t(x), _t(mask), _t(g))
    else:
        x = _rand(rng, b, t, 20)
        jm = jenc.PromptEncoder(in_channels=20, hidden_channels=hidden,
                                out_channels=hidden, n_layers=n_layers)
        params = jm.init(jax.random.PRNGKey(1), x, mask)
        want = jm.apply(params, x, mask)
        tm = _load(tenc.PromptEncoder(20, hidden, hidden, n_layers), params)
        got = tm(_t(x), _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ENC_ATOL)


@pytest.mark.parametrize("enc_dim,ted,heads", [(20, 20, 1), (32, 16, 8)])
def test_text_time_embedding_matches(enc_dim, ted, heads, rng):
    x = _rand(rng, 3, 11, enc_dim)
    jm = jenc.TextTimeEmbedding(enc_dim, ted, heads)
    params = jm.init(jax.random.PRNGKey(2), x)
    tm = _load(tenc.TextTimeEmbedding(enc_dim, ted, heads), params)
    np.testing.assert_allclose(tm(_t(x)).detach().numpy(),
                               np.asarray(jm.apply(params, x)), atol=ENC_ATOL)


UNET_KW = dict(in_channels=12, out_channels=6, block_out_channels=(16, 24),
               cross_attention_dim=20, addition_embed_heads=4)


@pytest.fixture(scope="module")
def unet_pair():
    r = np.random.default_rng(5)
    b, t, tp = 2, 16, 10
    x = _rand(r, b, t, 12)
    ctx = _rand(r, b, tp, 20)
    mask = np.arange(tp)[None] < np.array([10, 6])[:, None]
    ts = np.array([3.0, 871.5], np.float32)
    jm = junet.UNet1DConditionModel(**UNET_KW)
    # the parameter tree of a flax init, filled from numpy (no zero biases
    # or unit norms, so every parameter matters to the comparison)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(3), x, ts, ctx, mask)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(_fill(r, path[-1].key, a.shape)), shapes)
    tm = _load(tunet.UNet1DConditionModel(**UNET_KW), params)
    return jm, params, tm, (x, ts, ctx, mask)


def _fill(r, name, shape):
    n = _rand(r, *shape)
    if name == "kernel":
        return n / np.sqrt(np.prod(shape[:-1]))
    return (1.0 if name == "scale" else 0.0) + 0.05 * n


def test_unet_forward_matches(unet_pair):
    jm, params, tm, (x, ts, ctx, mask) = unet_pair
    want = jax.jit(jm.apply)(params, x, ts, ctx, mask)
    with torch.no_grad():
        got = tm(_t(x), _t(ts), _t(ctx), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=UNET_ATOL)


def test_unet_precomputed_cross_kv_matches(unet_pair):
    jm, params, tm, (x, ts, ctx, mask) = unet_pair
    aug, kvs = jm.apply(params, x, ts, ctx, precompute_kv=True)
    want = jax.jit(jm.apply)(params, x, ts, ctx, mask, cross_kv=kvs,
                             aug_emb=aug)
    with torch.no_grad():
        t_aug, t_kvs = tm.precompute(_t(ctx))
        assert len(t_kvs) == len(kvs)
        for (jk, jv), (tk, tv) in zip(kvs, t_kvs):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
        got = tm(_t(x), _t(ts), _t(ctx), _t(mask), cross_kv=t_kvs,
                 aug_emb=t_aug)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=UNET_ATOL)


def test_vocos_matches(rng):
    kw = dict(dim=32, intermediate_dim=48, num_layers=2, n_fft=64,
              hop_length=16)
    mel = _rand(rng, 2, 9, 100)
    jm = jvocos.Vocos(**kw)
    params = jm.init(jax.random.PRNGKey(6), mel)
    want = np.asarray(jm.apply(params, mel))
    tm = _load(tvocos.Vocos(**kw), params)
    with torch.no_grad():
        got = tm(_t(mel)).numpy()
    assert got.shape == want.shape == (2, 9 * 16)
    np.testing.assert_allclose(got, want, atol=VOCOS_ATOL)


def test_converter_is_strict(rng):
    x = _rand(rng, 1, 5, 20)
    jm = jenc.TextTimeEmbedding(20, 20, 1)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
    tm = tenc.TextTimeEmbedding(20, 20, 1)
    from_flax_tree(params, tm)  # the exact tree converts

    extra = {"params": {**params["params"], "stray": {"kernel": np.ones(3)}}}
    with pytest.raises(ValueError, match="no port parameter"):
        from_flax_tree(extra, tm)
    missing = {"params": {k: v for k, v in params["params"].items()
                          if k != "proj"}}
    with pytest.raises(ValueError, match="not assigned"):
        from_flax_tree(missing, tm)
    bad = jax.tree.map(lambda a: a, params)
    bad["params"]["proj"]["kernel"] = np.ones((20, 21), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_flax_tree(bad, tm)
