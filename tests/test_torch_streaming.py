"""The port's streaming attention and ConvFFN step, and the attention
routing rule, against the JAX package, on the CPU.

`init_kv_cache` / `streaming_attention` step by step, in chunks, in
static_kv mode and with an extra bias, against JAX's at 2e-5; ConvFFN's
LEFT-padded forward and its `step` against JAX's at 2e-5 (the JAX suite's
bound for both). `multihead_attention` with a full (Tq, Tk) bias and at
D > 128 against JAX's, each counted on the plain route; key-padding calls
at D <= 128 are not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu.models.encoders import ConvFFN as JConvFFN
from ns2vc_tpu.ops import attention as jatt
from ns2vc_tpu_torch.convert import from_flax_tree
from ns2vc_tpu_torch.models.encoders import ConvFFN
from ns2vc_tpu_torch.ops import attention as tatt
from ns2vc_tpu_torch.ops.flash_attention import flash_attention

ATOL = 2e-5
B, T, C, H = 2, 24, 32, 4


@pytest.fixture(scope="module")
def qkv():
    r = np.random.default_rng(0)
    return tuple(r.standard_normal((B, T, C)).astype(np.float32)
                 for _ in range(3))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _stream(mod, q, k, v, s, to):
    """Feed q/k/v through mod's streaming_attention s frames at a time."""
    cache = mod.init_kv_cache(B, H, C // H, capacity=T)
    outs = []
    for i in range(0, T, s):
        out, cache = mod.streaming_attention(
            to(q[:, i:i + s]), to(k[:, i:i + s]), to(v[:, i:i + s]), cache, H)
        outs.append(np.asarray(out))
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("chunk", [1, 8])
def test_streaming_matches_jax_and_block_causal_attention(qkv, chunk):
    q, k, v = qkv
    want, jcache = _stream(jatt, q, k, v, chunk, jnp.asarray)
    got, cache = _stream(tatt, q, k, v, chunk, _t)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert cache["idx"] == int(jcache["idx"]) == T
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-7)
    blk = np.arange(T) // chunk
    bias = np.where(blk[:, None] >= blk[None, :], 0.0, -1e4)[None, None]
    full = tatt.multihead_attention(_t(q), _t(k), _t(v), H,
                                    bias=_t(bias.astype(np.float32)))
    np.testing.assert_allclose(got, full.numpy(), atol=ATOL)


def test_static_kv_and_extra_bias_match_jax(qkv):
    q, k, v = qkv
    jc = jatt.init_kv_cache(B, H, C // H, capacity=T + 4)
    tc = tatt.init_kv_cache(B, H, C // H, capacity=T + 4)
    _, jc = jatt.streaming_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                     jnp.asarray(v), jc, H)
    _, tc2 = tatt.streaming_attention(_t(q[:, :1]), _t(k), _t(v), tc, H)
    assert tc["idx"] == 0 and not tc["k"].any()   # the input cache is kept
    want, jc3 = jatt.streaming_attention(jnp.asarray(q), None, None, jc, H,
                                         static_kv=True)
    got, tc3 = tatt.streaming_attention(_t(q), None, None, tc2, H,
                                        static_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert tc3["idx"] == int(jc3["idx"]) == T
    extra = np.random.default_rng(1).standard_normal(
        (1, H, T, T + 4)).astype(np.float32)
    want = jatt.streaming_attention(jnp.asarray(q), None, None, jc, H,
                                    static_kv=True, bias=jnp.asarray(extra))[0]
    plain0 = flash_attention.route_launches["plain"]
    got = tatt.streaming_attention(_t(q), None, None, tc2, H, static_kv=True,
                                   bias=_t(extra))[0]
    assert flash_attention.route_launches["plain"] == plain0 + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="capacity"):
        tatt.streaming_attention(_t(q), _t(k), _t(v), tc2, H)


@pytest.mark.parametrize("k", [1, 9])
def test_conv_ffn_left_padding_and_step_match_jax(k):
    r = np.random.default_rng(2)
    x = r.standard_normal((B, 12, 16)).astype(np.float32)
    jm = JConvFFN(channels=16, kernel_size=k, padding="LEFT")
    params = jm.init(jax.random.PRNGKey(0), x)
    tm = ConvFFN(16, k, padding="LEFT")
    tm.load_state_dict(from_flax_tree(jax.tree.map(np.asarray, params), tm))
    tm.eval()
    want = np.asarray(jm.apply(params, x))
    buf, jbuf = tm.init_buffer(B), jm.init_buffer(B)
    assert buf.shape == jbuf.shape == (B, k - 1, 16)
    steps = []
    with torch.no_grad():
        full = tm(_t(x))
        for i in range(12):
            y, buf = tm.step(_t(x[:, i:i + 1]), buf)
            jy, jbuf = jm.apply(params, x[:, i:i + 1], jbuf,
                                method=JConvFFN.step)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
            steps.append(y)
    np.testing.assert_allclose(full.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), want, atol=ATOL)
    with pytest.raises(ValueError, match="padding"):
        ConvFFN(16, k, padding="RIGHT")


@pytest.mark.parametrize("case", ["full_bias", "wide_head", "key_padding",
                                  "no_bias", "query_row_bias"])
def test_multihead_attention_routes_by_bias_and_head_dim(case):
    r = np.random.default_rng(3)
    heads = 1 if case == "wide_head" else H
    c = 160 if case == "wide_head" else C
    q, k, v = (r.standard_normal((B, n, c)).astype(np.float32)
               for n in (10, 14, 14))
    bias = {
        "full_bias": r.standard_normal((10, 14)),
        "wide_head": np.where(np.arange(14) < 9, 0.0, -1e4)[None, None, None],
        "key_padding": np.where(np.arange(14)[None] < np.array([[14], [6]]),
                                0.0, -1e4)[:, None, None, :],
        "no_bias": None,
        "query_row_bias": r.standard_normal((B, 1, 10, 1)),
    }[case]
    bias = None if bias is None else bias.astype(np.float32)
    want = jatt.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
        bias=None if bias is None else jnp.asarray(bias), attn_impl="xla")
    plain0 = flash_attention.route_launches["plain"]
    got = tatt.multihead_attention(_t(q), _t(k), _t(v), heads,
                                   bias=None if bias is None else _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    on_plain = case in ("full_bias", "wide_head", "query_row_bias")
    assert flash_attention.route_launches["plain"] - plain0 == int(on_plain)
    assert tatt.is_key_padding(None if bias is None else _t(bias)) == (
        case in ("key_padding", "no_bias", "wide_head"))
