"""The port's two kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the Pallas kernel run in interpret mode, on the same
numpy inputs, in f32. Tolerances are the JAX suite's own
(tests/test_pallas_attention.py, tests/test_pallas_resnet.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ns2vc_tpu.ops import pallas_attention, pallas_resnet
from ns2vc_tpu_torch.ops import _build
from ns2vc_tpu_torch.ops.attention import multihead_attention
from ns2vc_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain,
)
from ns2vc_tpu_torch.ops.fused_resnet import (
    affine_silu_conv1d, affine_silu_conv1d_plain, gn_silu_conv1d,
)

ATTN_ATOL = 2e-5                 # f32, test_pallas_attention.py
RESNET_ATOL, RESNET_RTOL = 3e-5, 1e-4   # test_pallas_resnet.py


def _blocks(tq, tk):
    # as ops/attention.py::multihead_attention sizes the Pallas blocks
    return min(512, -(-tq // 128) * 128), min(1024, -(-tk // 128) * 128)


def _attn_case(b, h, tq, tk, d, lengths, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, tq, d)).astype(np.float32)
    k = r.standard_normal((b, h, tk, d)).astype(np.float32)
    v = r.standard_normal((b, h, tk, d)).astype(np.float32)
    bias = None
    if lengths is not None:
        keep = np.arange(tk)[None, :] < np.asarray(lengths)[:, None]
        bias = ((1.0 - keep) * -10000.0).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("b,h,tq,tk,d,lengths", [
    (2, 4, 128, 128, 64, None),          # exact blocks, no mask
    (2, 4, 100, 150, 64, [150, 90]),     # ragged + key padding
    (2, 4, 37, 260, 64, [260, 11]),      # small q, multiple k blocks
    (3, 1, 1, 33, 100, None),            # pooling: Tq=1, D=100 (ref_enc)
    (2, 64, 1, 17, 4, None),             # pooling: Tq=1, D=4 (add_embedding)
    (2, 8, 56, 40, 48, [40, 23]),        # UNet level 2 cross-attention width
])
def test_flash_attention_plain_matches_pallas(b, h, tq, tk, d, lengths):
    q, k, v, bias = _attn_case(b, h, tq, tk, d, lengths)
    bq, bk = _blocks(tq, tk)
    want = pallas_attention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias is None else jnp.asarray(bias),
        block_q=bq, block_k=bk, interpret=True)
    got = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL)


def test_multihead_attention_heads_roundtrip():
    """(B, T, C) projections through split/merge heads equal the per-head
    plain attention laid back out as (B, T, H*D)."""
    r = np.random.default_rng(3)
    b, t, heads, d = 2, 9, 4, 8
    qkv = torch.from_numpy(r.standard_normal((b, t, 3 * heads * d))
                           .astype(np.float32))
    q, k, v = qkv.split(heads * d, dim=-1)
    bias = torch.zeros(b, t)
    bias[1, 6:] = -1e4
    got = multihead_attention(q, k, v, heads, key_bias=bias)
    per_head = [flash_attention_plain(
        q[..., i * d:(i + 1) * d][:, None], k[..., i * d:(i + 1) * d][:, None],
        v[..., i * d:(i + 1) * d][:, None], bias)[:, 0] for i in range(heads)]
    np.testing.assert_allclose(got.numpy(), torch.cat(per_head, -1).numpy(),
                               atol=1e-6)


def _resnet_case(b, t, c, co, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, t, c)).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(c)).astype(np.float32)
    beta = (0.1 * r.standard_normal(c)).astype(np.float32)
    w = (r.standard_normal((3, c, co)) / np.sqrt(3 * c)).astype(np.float32)
    bias = (0.1 * r.standard_normal(co)).astype(np.float32)
    return x, gamma, beta, w, bias


def _torch_w(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))


@pytest.mark.parametrize("b,t,c,co,film", [
    (2, 50, 128, 256, False),
    (1, 37, 256, 128, False),
    (2, 24, 128, 128, True),
    (1, 13, 128, 128, False),   # T not a multiple of 8: no halo leak
    (2, 13, 128, 128, True),
])
def test_gn_silu_conv1d_plain_matches_pallas(b, t, c, co, film):
    x, gamma, beta, w, bias = _resnet_case(b, t, c, co, seed=c + t)
    s = sh = None
    if film:
        r = np.random.default_rng(8)
        s = (0.2 * r.standard_normal((b, c))).astype(np.float32)
        sh = (0.2 * r.standard_normal((b, c))).astype(np.float32)
    want = pallas_resnet.gn_silu_conv1d(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.asarray(w), jnp.asarray(bias),
        film_scale=None if s is None else jnp.asarray(s),
        film_shift=None if sh is None else jnp.asarray(sh), interpret=True)
    got = gn_silu_conv1d(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        _torch_w(w), torch.from_numpy(bias),
        film_scale=None if s is None else torch.from_numpy(s),
        film_shift=None if sh is None else torch.from_numpy(sh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=RESNET_ATOL, rtol=RESNET_RTOL)


def test_affine_silu_conv1d_plain_matches_pallas():
    b, t, c, co = 2, 40, 128, 128
    x, _, _, w, bias = _resnet_case(b, t, c, co)
    r = np.random.default_rng(1)
    a = (1 + 0.1 * r.standard_normal((b, c))).astype(np.float32)
    off = (0.1 * r.standard_normal((b, c))).astype(np.float32)
    want = pallas_resnet.affine_silu_conv1d(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(off), jnp.asarray(w),
        jnp.asarray(bias), interpret=True)
    got = affine_silu_conv1d_plain(
        torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(off),
        _torch_w(w), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=RESNET_ATOL, rtol=RESNET_RTOL)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel library (nor nvcc): the
    wrappers return the plain result and their launch counts stay put."""
    def refuse():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    n_attn, n_res = flash_attention.launches, affine_silu_conv1d.launches
    q, k, v, bias = (torch.from_numpy(a) for a in
                     _attn_case(2, 2, 5, 7, 16, [7, 3]))
    np.testing.assert_array_equal(flash_attention(q, k, v, bias).numpy(),
                                  flash_attention_plain(q, k, v, bias).numpy())
    x, _, _, w, cb = _resnet_case(1, 6, 16, 8)
    a, off = torch.ones(1, 16), torch.zeros(1, 16)
    args = (torch.from_numpy(x), a, off, _torch_w(w), torch.from_numpy(cb))
    np.testing.assert_array_equal(affine_silu_conv1d(*args).numpy(),
                                  affine_silu_conv1d_plain(*args).numpy())
    assert flash_attention.launches == n_attn
    assert affine_silu_conv1d.launches == n_res


def test_fully_masked_rows_are_finite():
    q, k, v, _ = _attn_case(2, 2, 8, 12, 16, None)
    bias = np.full((2, 12), -1e30, np.float32)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert torch.isfinite(out).all()
