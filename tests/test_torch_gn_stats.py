"""The GroupNorm statistics and fold of K2's wrapper against the JAX
package's, and the autograd Function around the statistics kernel.

`group_norm_affine_plain` (the kernel's plain version, what a CPU tensor
gets) is held against the fold of `ns2vc_tpu/ops/pallas_resnet.py::
gn_silu_conv1d` (its a, b: f32 mean and centred variance over (T, C / G),
rsqrt, gamma / beta, FiLM) on the same numpy inputs, with x in f32 and in
bf16: 2e-5 of max(1, |a|, |b|) (both sides take the statistics in f32, in
other summation orders). The whole epilogue goes through the Pallas kernel
in interpret mode, as tests/test_pallas_resnet.py runs it: f32 at the JAX
suite's tolerances; bf16 with the port's a, b rounded to bf16 as the JAX
wrapper rounds them, at K2's bf16 tolerance (1e-2 of max(1, max|y|): one
bf16 rounding of f32 sums taken in another order). The Function's backward
is `group_norm_affine_grad` over the mean and rstd its forward kept: on the
CPU (the launches replaced by the plain versions) its gradients equal
`group_norm_affine_backward`'s exactly and autograd's through the plain
version within 2e-5 of max|autograd|. `group_norm_affine_backward`, the
closed form the backward kernels compute, is held against autograd
through `group_norm_affine_plain` and against JAX's gradient (`jax.vjp`)
of the fold, in f32 with x in f32 and in bf16 (bf16: the same f32 closed
form on the upcast values, then one rounding to bf16), with and without
FiLM, FiLM as contiguous rows and as strided chunks of one projection:
2e-5 of max|reference| per gradient (f32 sums in other orders).
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu.ops import pallas_resnet
import ns2vc_tpu_torch.ops.fused_resnet as fr
from ns2vc_tpu_torch.ops.fused_resnet import (
    GN_BWD_THREADS, GN_BWD_VECS, GN_BWD_WAVE, affine_silu_conv1d_plain,
    gn_backward_blocks, gn_splits,
    group_norm_affine, group_norm_affine_backward, group_norm_affine_plain,
    group_norm_stats_plain,
)
from test_torch_kernels import card_routes  # noqa: F401 (a fixture)

STATS_RTOL = 2e-5                        # of max(1, |a|, |b|)
STATS_GRAD_RTOL = 2e-5                   # of max|reference| per gradient
RESNET_ATOL, RESNET_RTOL = 3e-5, 1e-4    # test_pallas_resnet.py
RESNET_BF16_RTOL = 1e-2                  # of max(1, max|y|)


def _inputs(b, t, c, co, film, seed):
    r = np.random.default_rng(seed)
    x = (0.5 + 2.0 * r.standard_normal((b, t, c))).astype(np.float32)
    gamma = (1 + 0.1 * r.standard_normal(c)).astype(np.float32)
    beta = (0.1 * r.standard_normal(c)).astype(np.float32)
    w = (r.standard_normal((3, c, co)) / np.sqrt(3 * c)).astype(np.float32)
    bias = (0.1 * r.standard_normal(co)).astype(np.float32)
    s = sh = None
    if film:
        s = (0.2 * r.standard_normal((b, c))).astype(np.float32)
        sh = (0.2 * r.standard_normal((b, c))).astype(np.float32)
    return x, gamma, beta, w, bias, s, sh


def _jax_fold(x, gamma, beta, groups, eps, s, sh):
    """a, b as ns2vc_tpu/ops/pallas_resnet.py:121-132 fold them (before
    their cast to x's dtype)."""
    bsz, t, c = x.shape
    xg = x.astype(jnp.float32).reshape(bsz, t, groups, c // groups)
    mean = xg.mean(axis=(1, 3))
    var = xg.var(axis=(1, 3))
    rstd = jax.lax.rsqrt(var + eps)
    a = jnp.repeat(rstd, c // groups, axis=1) * gamma[None, :]
    b = beta[None, :] - jnp.repeat(mean, c // groups, axis=1) * a
    if s is not None:
        a = a * (1.0 + s)
        b = b * (1.0 + s) + sh
    return np.asarray(a), np.asarray(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,c,film", [
    (2, 50, 128, False),
    (2, 24, 256, True),
    (1, 13, 64, True),    # T not a multiple of 8, eight channels a group
    (3, 7, 16, False),    # two channels a group
])
def test_statistics_match_the_jax_fold(dtype, b, t, c, film):
    x, gamma, beta, _, _, s, sh = _inputs(b, t, c, 8, film, seed=t + c)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    want_a, want_b = _jax_fold(xj, jnp.asarray(gamma), jnp.asarray(beta), 8,
                               1e-5, None if s is None else jnp.asarray(s),
                               None if sh is None else jnp.asarray(sh))
    got_a, got_b = group_norm_affine_plain(
        xt, torch.from_numpy(gamma), torch.from_numpy(beta), 8, 1e-5,
        None if s is None else torch.from_numpy(s),
        None if sh is None else torch.from_numpy(sh))
    assert got_a.dtype == got_b.dtype == torch.float32
    scale = max(1.0, np.abs(want_a).max(), np.abs(want_b).max())
    np.testing.assert_allclose(got_a.numpy(), want_a, rtol=0,
                               atol=STATS_RTOL * scale)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0,
                               atol=STATS_RTOL * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("film", [False, True])
def test_epilogue_with_the_statistics_matches_pallas(dtype, film):
    b, t, c, co = 2, 24, 128, 128
    x, gamma, beta, w, bias, s, sh = _inputs(b, t, c, co, film, seed=3)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))).to(tdt)
    bt = torch.from_numpy(bias).to(tdt)
    want = pallas_resnet.gn_silu_conv1d(
        jnp.asarray(xt.float().numpy()).astype(jdt), jnp.asarray(gamma),
        jnp.asarray(beta),
        jnp.asarray(wt.float().numpy().transpose(2, 1, 0)).astype(jdt),
        jnp.asarray(bt.float().numpy()).astype(jdt),
        film_scale=None if s is None else jnp.asarray(s),
        film_shift=None if sh is None else jnp.asarray(sh), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    a, off = group_norm_affine_plain(
        xt, torch.from_numpy(gamma), torch.from_numpy(beta), 8, 1e-5,
        None if s is None else torch.from_numpy(s),
        None if sh is None else torch.from_numpy(sh))
    if dtype == "bfloat16":   # the JAX wrapper hands a, b over in x's dtype
        a, off = a.bfloat16().float(), off.bfloat16().float()
    got = affine_silu_conv1d_plain(xt, a, off, wt, bt).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=RESNET_ATOL,
                                   rtol=RESNET_RTOL)
    else:
        tol = RESNET_BF16_RTOL * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@contextlib.contextmanager
def statistics_on_cpu():
    """group_norm_affine as it runs for a CUDA tensor, its launches (the
    statistics kernel's, with the mean and rstd it keeps, and the backward
    kernels') replaced by the plain versions (each counted as a launch)."""
    def launch(x, gamma, beta, groups, eps, s, sh, stats=False):
        group_norm_affine.launches += 1
        a, b = group_norm_affine_plain(x, gamma, beta, groups, eps, s, sh)
        if not stats:
            return a, b
        return (a, b, *group_norm_stats_plain(x, groups, eps))

    def grad_launch(x, gamma, beta, groups, s, sh, mean, rstd, da, db,
                    need_x):
        group_norm_affine.backward_launches += 1
        out = group_norm_affine_backward(x, gamma, beta, groups, 0.0, s, sh,
                                         da, db, mean, rstd)
        return (out[0] if need_x else None, *out[1:])
    with mock.patch.object(fr, "gn_route", lambda dev: "cuda"), \
            mock.patch.object(fr, "_gn_launch", launch), \
            mock.patch.object(fr, "_gn_grad_launch", grad_launch):
        yield


@pytest.mark.parametrize("film", [None, "chunk"])
def test_statistics_function_grads_are_the_plain_versions(film):
    r = np.random.default_rng(21)
    b, t, c = 2, 9, 16
    x = torch.from_numpy(r.standard_normal((b, t, c)).astype(np.float32))
    gamma = torch.from_numpy((1 + 0.1 * r.standard_normal(c))
                             .astype(np.float32))
    beta = torch.from_numpy((0.1 * r.standard_normal(c)).astype(np.float32))
    proj = torch.from_numpy((0.2 * r.standard_normal((b, 2 * c)))
                            .astype(np.float32))
    da = torch.from_numpy(r.standard_normal((b, c)).astype(np.float32))
    db = torch.from_numpy(r.standard_normal((b, c)).astype(np.float32))

    def grads(fn):
        leaves = [v.detach().requires_grad_() for v in (x, gamma, beta, proj)]
        film_args = (leaves[3].chunk(2, dim=-1) if film else (None, None))
        a, off = fn(*leaves[:3], 8, 1e-5, *film_args)
        torch.autograd.backward((a, off), (da, db))
        return a.detach(), off.detach(), [v.grad for v in leaves]

    want = grads(group_norm_affine_plain)
    with statistics_on_cpu():
        n0, b0 = group_norm_affine.launches, group_norm_affine.backward_calls
        k0 = group_norm_affine.backward_launches
        got = grads(group_norm_affine)
        assert group_norm_affine.launches == n0 + 1
        assert group_norm_affine.backward_calls == b0 + 1
        assert group_norm_affine.backward_launches == k0 + 1
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g, w)
    # the backward kernels' plain version on the forward's statistics,
    # bit for bit; autograd through the plain forward within f32 rounding
    film_args = proj.chunk(2, dim=-1) if film else (None, None)
    closed = group_norm_affine_backward(x, gamma, beta, 8, 1e-5, *film_args,
                                        da, db)
    closed = [*closed[:3], torch.cat(closed[3:], dim=-1) if film else None]
    for name, g, c, w in zip(("x", "gamma", "beta", "film"), got[2], closed,
                             want[2]):
        if name == "film" and not film:
            assert g is None and w is None
            continue
        assert torch.equal(g, c), name
        assert (g - w).abs().max() <= STATS_GRAD_RTOL * w.abs().max(), name


def _jax_fold_vjp(x, gamma, beta, s, sh, da, db, groups=8, eps=1e-5):
    """JAX's gradients of the fold (x, gamma, beta, scale, shift) given the
    cotangents of a, b: ns2vc_tpu/ops/pallas_resnet.py:121-130 under
    jax.vjp, jitted (one compile)."""
    film = s is not None

    def fold(x_, g_, b_, *f):
        xg = x_.reshape(x_.shape[0], x_.shape[1], groups, -1)
        mean = xg.mean(axis=(1, 3))
        var = xg.var(axis=(1, 3))
        rstd = jax.lax.rsqrt(var + eps)
        cg = x_.shape[2] // groups
        a = jnp.repeat(rstd, cg, axis=1) * g_[None, :]
        b = b_[None, :] - jnp.repeat(mean, cg, axis=1) * a
        if f:
            a = a * (1.0 + f[0])
            b = b * (1.0 + f[0]) + f[1]
        return a, b
    def grads(cot, *args):
        return jax.vjp(fold, *args)[1](cot)
    args = [jnp.asarray(v) for v in (x, gamma, beta)]
    if film:
        args += [jnp.asarray(s), jnp.asarray(sh)]
    out = jax.jit(grads)((jnp.asarray(da), jnp.asarray(db)), *args)
    return [np.asarray(v) for v in out] + ([] if film else [None, None])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,c,film", [
    (2, 24, 64, None),
    (3, 13, 128, "rows"),     # T not a multiple of 8
    (2, 9, 16, "chunk"),      # two channels a group; FiLM rows strided
])
def test_statistics_backward_matches_autograd_and_jax(dtype, b, t, c, film):
    x, gamma, beta, _, _, s, sh = _inputs(b, t, c, 8, film, seed=7 * t + c)
    r = np.random.default_rng(t)
    da = r.standard_normal((b, c)).astype(np.float32)
    db = r.standard_normal((b, c)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    params = [torch.from_numpy(v) for v in (gamma, beta)]
    film_args = [None, None]
    if film == "rows":
        film_args = [torch.from_numpy(v) for v in (s, sh)]
    elif film == "chunk":   # two chunks of one (B, 2C) projection
        film_args = list(torch.from_numpy(np.concatenate([s, sh], axis=1))
                         .chunk(2, dim=-1))
        assert film_args[0].stride() == (2 * c, 1)
    cot = [torch.from_numpy(v) for v in (da, db)]
    got = group_norm_affine_backward(xt, *params, 8, 1e-5, *film_args, *cot)
    # bf16: the f32 closed form on the upcast values, rounded once
    got32 = group_norm_affine_backward(xt.float(), *params, 8, 1e-5,
                                       *film_args, *cot)
    assert got[0].dtype == xt.dtype
    assert torch.equal(got[0], got32[0].to(xt.dtype))
    leaves = [v.detach().requires_grad_() for v in (xt.float(), *params,
                                                    *film_args)
              if v is not None]
    fa = leaves[3:] if film else [None, None]
    torch.autograd.backward(group_norm_affine_plain(*leaves[:3], 8, 1e-5,
                                                    *fa), cot)
    auto = [v.grad.numpy() for v in leaves] + ([] if film else [None, None])
    jx = _jax_fold_vjp(xt.float().numpy(), gamma, beta,
                       None if film is None else s,
                       None if film is None else sh, da, db)
    names = ("x", "gamma", "beta", "scale", "shift")
    for name, g, a, j in zip(names, got32, auto, jx):
        if a is None:
            assert g is None, name
            continue
        g = g.numpy()
        for ref in (a, j):
            tol = STATS_GRAD_RTOL * np.abs(ref).max()
            np.testing.assert_allclose(g, ref, rtol=0, atol=tol,
                                       err_msg=name)


@pytest.mark.parametrize("b,t,c,width,want", [
    (32, 272, 256, 8, 9),       # a training step's bf16 call: one round
    (32, 272, 128, 8, 5),       #   each (8.5 / 4.25 rounds a row)
    (32, 272, 1024, 8, 17),     # 34 rounds a row, 33 blocks fill a wave
    (1, 832, 1024, 8, 104),     # one row: one block per round
    (2, 9, 16, 1, 1),           # element loads
])
def test_statistics_backward_blocks(b, t, c, width, want):
    """The kernel's dx blocks per batch row: an even share of the row's
    rounds of GN_BWD_VECS vectors per thread of GN_BWD_THREADS each, one
    round a block while the rows' blocks fit one wave of the H100."""
    assert gn_backward_blocks(b, t, c, width) == want
    rounds = -(-t * c // (width * GN_BWD_THREADS * GN_BWD_VECS))
    per = -(-rounds // want)
    assert want * per >= rounds and (want - 1) * per < rounds
    assert b * want <= max(GN_BWD_WAVE, b)


def test_statistics_without_grad_launch_directly():
    x = torch.randn(1, 5, 16, requires_grad=True)
    gamma, beta = torch.ones(16), torch.zeros(16)
    with statistics_on_cpu():
        b0 = group_norm_affine.backward_calls
        with torch.no_grad():
            a, _ = group_norm_affine(x, gamma, beta, 8, 1e-5)
        assert a.grad_fn is None
        a, _ = group_norm_affine(x.detach(), gamma, beta, 8, 1e-5)
        assert a.grad_fn is None
        assert group_norm_affine.backward_calls == b0


def test_cpu_statistics_take_the_plain_version(monkeypatch):
    from ns2vc_tpu_torch.ops import _build

    def refuse():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", refuse)
    x = torch.randn(2, 7, 32)
    gamma, beta = torch.ones(32), torch.zeros(32)
    n0 = group_norm_affine.launches
    for got, want in zip(group_norm_affine(x, gamma, beta, 8, 1e-5),
                         group_norm_affine_plain(x, gamma, beta, 8, 1e-5)):
        assert torch.equal(got, want)
    assert group_norm_affine.launches == n0
    with pytest.raises(ValueError, match="unsupported device"):
        group_norm_affine(x.to("meta"), gamma, beta, 8, 1e-5)


@pytest.mark.parametrize("t,c,width,want", [
    (448, 128, 8, 1),       # B=16 serving, bf16: one round of loads
    (448, 384, 4, 2),       # f32 serving's widest level-0 slab
    (832, 384, 8, 2),       # the CLI's longest B=1 bucket
    (5, 16, 1, 1),          # two channels a group: element loads
    (40000, 1024, 8, 8),    # at most one portable cluster
    (2, 65536, 1, 2),       # never more blocks than frames
])
def test_statistics_split(t, c, width, want):
    """Blocks per slab: the fewest whose shares each take one round of 8
    loads per thread of 512."""
    assert gn_splits(t, c, 8, width) == want


@pytest.mark.parametrize("xdt,pdt,film", [
    (torch.bfloat16, torch.bfloat16, "chunk"),   # a training step's call
    (torch.float32, torch.float32, None),
    (torch.float32, "mixed", "chunk"),           # parameters cast to f32
])
def test_statistics_backward_launches_its_entry(card_routes, xdt, pdt, film):
    """As for a CUDA tensor (the library a recorder): one launch of the
    backward entry with the FiLM rows' stride, the dx kernel's blocks and
    the dtype flags; each gradient in its input's dtype and shape."""
    from ns2vc_tpu_torch.ops.fused_resnet import group_norm_affine_grad

    b, t, c = 2, 9, 64
    pd = torch.bfloat16 if pdt == "mixed" else pdt
    x = torch.zeros(b, t, c, dtype=xdt)
    gamma, beta = torch.ones(c, dtype=pdt if pdt != "mixed" else
                             torch.float32), torch.zeros(c, dtype=pd)
    fs = ((torch.zeros(b, 2 * c, dtype=pd).chunk(2, dim=-1))
          if film else (None, None))
    mean, rstd, da, db = (torch.zeros(b, n) for n in (8, 8, c, c))
    n0 = group_norm_affine.backward_launches
    grads = group_norm_affine_grad(x, gamma, beta, 8, *fs, mean, rstd, da,
                                   db)
    assert group_norm_affine.backward_launches == n0 + 1
    (name, args), = card_routes.calls
    assert name == "ns2vc_group_norm_affine_bwd"
    mixed = pdt == "mixed"
    assert args[5] == (0 if not film else c if mixed else 2 * c)
    width = 16 // x.element_size()
    assert args[15:] == (b, t, c, 8, gn_backward_blocks(b, t, c, width),
                         int(xdt == torch.bfloat16),
                         int(pdt == torch.bfloat16), 1, 0)
    want = [x, gamma, beta, *fs]
    for g, w in zip(grads, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
