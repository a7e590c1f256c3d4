"""K1's f32 backward kernels (csrc/flash_attention_f32_bwd_wgmma.cu and the
single-query kernel in f32) on the CPU: their routes, their workspace and
their arithmetic emulated in torch ops.

The kernels run only on a card (tests/test_torch_cuda.py holds them there
against `flash_attention_backward`). Here:
  - `grad_route` and the wrapper's refusals: f32 rows of more than one
    query take the tile kernels ("f32tc"), one query the single-query
    kernel ("f32tc_q1"); D > 128 or a head dim of other than unit stride
    raise before any launch; `plan_f32_backward` (the cluster splits of
    each kernel's streamed sweep, a pure function of the shape) and
    `f32_bwd_workspace` (lse and Delta, then the TF32 planes the converting
    pass writes: rows, and transposes with each 8 keys in the kernels'
    order) at the F0 predictor's cross-attention, the op registry's D =
    128 and the B = 2 gradient checks' widths;
  - `emulate_f32_backward` repeats the kernels' arithmetic: every product
    in three TF32 passes (small.big + big.small + big.big of each
    operand's halves, rounded as `tf32_round`, cvt.rna), products exact in
    f32 and summed in f32; the logits in the log2 domain with the key
    bias, keys padded to the kernels' tiles (`F32_BWD_SHAPES`) with a
    bias of -inf; the plan's key splits: each rank's online row max m, sum
    l and u = sum P dP over its tiles in order, merged in rank order
    (rescaled to the ranks' max), lse = m + log2(l), Delta = u / l (never
    rowsum(dO * O)); P = 2^(x - lse); dS = P (dP - Delta) in two TF32
    planes into dQ and dK, P in two into dV; each rank's partial dQ (its
    keys) and dK, dV (its queries) summed in rank order. The single-query
    kernel's calls in exact f32. It is held against `flash_attention_
    backward` in f32 and against JAX's gradient (`jax.vjp`) of
    ns2vc_tpu/ops/attention.py::scaled_dot_product_attention at the
    highest matmul precision on the same numpy inputs: a reduced F0
    cross-attention (Tq = Tk = 272, D = 32, key padding), the UNet's head
    widths of the f32 gradient checks (16, 48, 64), a fully masked batch
    row, and the pools (Tq = 1, D = 4 and 100); and the card's bound
    (`chip_smoke.k1_f32_holds`) where keys and values share a large
    component: the plain f32 backward itself errs there, and the emulated
    kernels stay within K1_F32_BWD_COND times its error against f64.

Tolerance, of max |reference| per gradient: 2e-5 (3xTF32 drops the
small.small term, ~2^-22 of each product, and sums in other orders; the
plain version's exp against the kernels' exp2; the f32 bound of K1's
forward). A fully masked row: the f32 logits carry steps of 2^-10 there,
so that row is held at 2e-3 (the bf16 emulation's masked bound) and the
other at 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import ns2vc_tpu_torch.ops.flash_attention as fa
from chip_smoke import K1_F32_BWD_RTOL, k1_f32_holds, k1_grad_errors
from ns2vc_tpu.ops.attention import scaled_dot_product_attention
from ns2vc_tpu_torch.ops import _build
from ns2vc_tpu_torch.ops.flash_attention import (
    BWD_ROWS, F32_BWD_MAX_SPLITS, F32_BWD_SHAPES, bwd_workspace,
    f32_bwd_workspace, flash_attention_backward, grad_route,
    plan_f32_backward,
)
from ns2vc_tpu_torch.ops.fused_resnet import tf32_round
from test_torch_kernels import card_routes  # noqa: F401 (a fixture)

LOG2E = 1.4426950408889634
RTOL = 2e-5
MASKED_RTOL = 2e-3


def _x3(a, b):
    """a @ b in three TF32 passes, each product exact in f32."""
    ab, bb = tf32_round(a.contiguous()), tf32_round(b.contiguous())
    as_, bs = tf32_round(a - ab), tf32_round(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _ranks(n, splits):
    """Rank r's tiles [r n / c, (r + 1) n / c), as the kernels take them."""
    return [range(r * n // splits, (r + 1) * n // splits)
            for r in range(splits)]


def emulate_f32_backward(q, k, v, bias, scale, do, plan=None):
    """(dq, dk, dv) in f32 as the f32 kernels compute them, on f32 q, k, v,
    do (B, H, T, D) and an f32 key bias (B, Tk) or None, under `plan`
    (`plan_f32_backward`'s by default)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if tq == 1:   # the single-query kernel: f32 on the CUDA cores
        return flash_attention_backward(q, k, v, bias, scale, do)
    _, bn, kbn, dq_splits, kv_splits = plan or plan_f32_backward(
        b * h, tq, tk, d)
    tiles, qtiles = -(-tk // bn), -(-tq // kbn)
    pad = tiles * bn - tk
    kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (k, v))
    kb = torch.zeros(q.shape[0], tk) if bias is None else bias * LOG2E
    kb = F.pad(kb, (0, pad), value=-float("inf"))[:, None, None, :]
    x = _x3(q, kp.transpose(-1, -2)) * (scale * LOG2E) + kb
    dp = _x3(do, vp.transpose(-1, -2))
    parts = []   # each rank's (m, l, u) over its key tiles
    for own in _ranks(tiles, dq_splits):
        m = torch.full(x.shape[:-1], -float("inf"))
        l = torch.zeros(x.shape[:-1])
        u = torch.zeros(x.shape[:-1])
        for j in own:   # sweep 1, the rank's key tiles in order
            xs, dps = (t[..., j * bn:(j + 1) * bn] for t in (x, dp))
            mx = torch.maximum(m, xs.amax(-1))
            ref = torch.where(mx == -float("inf"), 0.0, mx)
            alpha = torch.exp2(m - ref)
            p = torch.exp2(xs - ref[..., None])
            l = l * alpha + p.sum(-1)
            u = u * alpha + (p * dps).sum(-1)
            m = mx
        parts.append((m, l, u))
    if dq_splits > 1:   # the ranks' rows merged in rank order
        m = torch.stack([p_[0] for p_ in parts]).amax(0)
        ref = torch.where(m == -float("inf"), 0.0, m)
        l = torch.zeros_like(m)
        u = torch.zeros_like(m)
        for mr, lr, ur in parts:
            a = torch.exp2(mr - ref)
            l = lr * a + l
            u = ur * a + u
    lse = m + torch.log2(l)
    delta = u / l
    p = torch.exp2(x - lse[..., None])
    ds = p * (dp - delta[..., None])
    dq = torch.zeros_like(q)
    for own in _ranks(tiles, dq_splits):   # partial dQ over each rank's keys
        keys = slice(own[0] * bn, (own[-1] + 1) * bn)
        dq = dq + _x3(ds[..., keys], kp[..., keys, :])
    dk = torch.zeros_like(kp)
    dv = torch.zeros_like(vp)
    for own in _ranks(qtiles, kv_splits):   # over each rank's queries
        rows = slice(own[0] * kbn, min(tq, (own[-1] + 1) * kbn))
        dv = dv + _x3(p[..., rows, :].transpose(-1, -2), do[..., rows, :])
        dk = dk + _x3(ds[..., rows, :].transpose(-1, -2), q[..., rows, :])
    return dq * scale, (dk * scale)[..., :tk, :], dv[..., :tk, :]


def _inputs(rng, b, h, tq, tk, d, lengths=None):
    """Seeded f32 q, k, v, do and a key-padding bias (or None)."""
    q, k, v, do = (torch.tensor(rng.standard_normal((b, h, t, d)),
                                dtype=torch.float32)
                   for t in (tq, tk, tk, tq))
    bias = None
    if lengths is not None:
        keep = torch.arange(tk)[None, :] < torch.tensor(lengths)[:, None]
        bias = (1.0 - keep.float()) * -1e4
    return q, k, v, bias, do


def _errors(got, want):
    return [((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]


def _jax_grads(q, k, v, bias, scale, do):
    """jax.vjp of the JAX package's attention, jitted (one compile)."""
    def grads(q_, k_, v_, b_, do_):
        jb = None if b_ is None else b_[:, None, None]
        _, vjp = jax.vjp(lambda a, b2, c: scaled_dot_product_attention(
            a, b2, c, jb, scale), q_, k_, v_)
        return vjp(do_)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(grads)(*(None if t is None else jnp.asarray(t.numpy())
                               for t in (q, k, v, bias, do)))
    return [torch.tensor(np.asarray(g)) for g in out]


# (H, Tq, Tk, D, lengths of the two batch rows or None)
CASES = [
    (2, 272, 272, 32, [272, 150]),   # the F0 cross-attention, 2 of 8 heads
    (2, 70, 70, 16, None),           # the UNet's self-attention widths
    (2, 34, 90, 48, [90, 41]),       # D = 48: 64 wide, 32-key tiles
    (1, 40, 40, 64, None),
    (1, 1, 273, 100, None),          # ref_enc's pool
    (4, 1, 40, 4, [40, 9]),          # add_embedding's width, a key bias
]


@pytest.mark.parametrize("h,tq,tk,d,lengths", CASES)
def test_emulation_holds_the_plain_backward_and_jax(h, tq, tk, d, lengths):
    rng = np.random.default_rng(tq + tk + d)
    q, k, v, bias, do = _inputs(rng, 2, h, tq, tk, d, lengths)
    scale = d ** -0.5
    got = emulate_f32_backward(q, k, v, bias, scale, do)
    for want in (flash_attention_backward(q, k, v, bias, scale, do),
                 _jax_grads(q, k, v, bias, scale, do)):
        assert max(_errors(got, want)) <= RTOL, _errors(got, want)


def test_emulation_with_a_fully_masked_row():
    q, k, v, _, do = _inputs(np.random.default_rng(9), 2, 2, 70, 90, 32)
    bias = torch.zeros(2, 90)
    bias[1] = -1e4
    got = emulate_f32_backward(q, k, v, bias, 32 ** -0.5, do)
    want = flash_attention_backward(q, k, v, bias, 32 ** -0.5, do)
    assert all(torch.isfinite(g).all() for g in got)
    assert max(_errors(got, want)) <= MASKED_RTOL
    assert max(_errors([g[:1] for g in got], [w[:1] for w in want])) <= RTOL


@pytest.mark.parametrize("offset", [3.0, 10.0])
def test_card_bound_with_a_shared_key_component(offset):
    """Keys and values sharing a large component (as projections with a
    bias do): dS = P (dP - Delta) cancels, and the plain f32 backward
    itself errs by more than K1_F32_BWD_RTOL of a row's max dq against f64;
    the emulated kernels stay within K1_F32_BWD_COND times that error, the
    second term of the card's bound (`chip_smoke.k1_f32_holds`)."""
    r = np.random.default_rng(17)
    q = torch.from_numpy(0.3 * r.standard_normal((2, 4, 136, 32))).float()
    k, v = (torch.from_numpy(0.3 * r.standard_normal((2, 4, 272, 32))
                             + offset).float() for _ in range(2))
    do = torch.from_numpy(r.standard_normal((2, 4, 136, 32))).float()
    bias = torch.zeros(2, 272)
    bias[1, 150:] = -1e4
    scale = 32 ** -0.5
    got = emulate_f32_backward(q, k, v, bias, scale, do)
    f64 = flash_attention_backward(*(x.double() for x in (q, k, v)),
                                   bias.double(), scale, do.double())
    plain = k1_grad_errors(flash_attention_backward(q, k, v, bias, scale,
                                                    do), f64)[0]
    errs = k1_grad_errors(got, f64)[0]
    assert plain[0] > K1_F32_BWD_RTOL
    assert k1_f32_holds(errs, plain), (errs, plain)


def test_one_tf32_pass_misses_the_bound():
    """The three passes are what holds f32 accuracy: one TF32 pass per
    product (the rounded operands alone) misses the bound by far."""
    rng = np.random.default_rng(4)
    q, k, v, bias, do = _inputs(rng, 2, 2, 70, 70, 32, [70, 30])
    want = flash_attention_backward(q, k, v, bias, 32 ** -0.5, do)
    one = flash_attention_backward(*(tf32_round(t.contiguous())
                                     for t in (q, k, v)), bias, 32 ** -0.5,
                                   tf32_round(do.contiguous()))
    assert max(_errors(one, want)) > 10 * RTOL


@pytest.mark.parametrize("tq,tk,d,dtype,route", [
    (272, 272, 32, torch.float32, "f32tc"),
    (1, 273, 100, torch.float32, "f32tc_q1"),
    (1, 273, 4, torch.float32, "f32tc_q1"),
    (136, 272, 32, torch.bfloat16, "tc"),
    (1, 273, 100, torch.bfloat16, "tc_q1"),
])
def test_backward_routes(tq, tk, d, dtype, route):
    q, kv = (torch.zeros(2, 8, n, d, dtype=dtype) for n in (tq, tk))
    assert grad_route(q, kv, kv)[0] == route


def test_workspace_at_the_f0_cross_attention():
    """The bf16 kernels': lse and Delta of each of the 32 x 8 x 272 query
    rows, padded to 320: 655 KB. The f32 kernels' adds the TF32 planes:
    q, k, v, dO's rows (2 x 256 x 272 x 32 each) and q, k, dO's
    transposes (272 is a multiple of 8): 125 MB in all."""
    assert bwd_workspace(32, 8, 272) == 2 * 32 * 8 * 320
    planes = 2 * 256 * 272 * 32
    assert f32_bwd_workspace(32, 8, 272, 272, 32) == \
        2 * 32 * 8 * 320 + 7 * planes


@pytest.mark.parametrize("b,h,tq,tk,d", [
    (2, 2, 9, 30, 6),       # every part rounded up to 32 values
    (4, 2, 400, 400, 99),   # the op registry's unaligned rows, DP = 128
])
def test_f32_workspace_layout(b, h, tq, tk, d):
    """The `Planes` order: lse, Delta, the rows of q, k, v, dO at the
    padded head dim, the transposes of q, k, dO over T rounded up to 8;
    each part at a multiple of 32 values (TMA's 16-byte bases)."""
    dp = next(p for p in F32_BWD_SHAPES if d <= p)
    bh, tq_pad = b * h, -(-tq // BWD_ROWS) * BWD_ROWS
    parts = [bh * tq_pad, bh * tq_pad, 2 * bh * tq * dp, 2 * bh * tk * dp,
             2 * bh * tk * dp, 2 * bh * tq * dp,
             2 * bh * dp * -(-tq // 8) * 8, 2 * bh * dp * -(-tk // 8) * 8,
             2 * bh * dp * -(-tq // 8) * 8]
    assert f32_bwd_workspace(b, h, tq, tk, d) == sum(
        -(-n // 32) * 32 for n in parts)


@pytest.mark.parametrize("bh,tq,tk,d,want", [
    (256, 272, 272, 32, (32, 64, 32, 1, 1)),   # the F0 step: 1280 blocks
    (8, 400, 400, 128, (128, 64, 32, 2, 2)),   # ids 14/15: 56 blocks
    (8, 400, 400, 99, (128, 64, 32, 2, 2)),    # id 14 at C = 198
    (16, 272, 320, 16, (16, 64, 32, 2, 3)),    # B = 2 gradient checks'
    (16, 68, 320, 48, (64, 64, 32, 2, 1)),     # widths
    (2, 40, 40, 64, (64, 64, 32, 1, 1)),       # too few tiles to split
])
def test_plan_f32_backward(bh, tq, tk, d, want):
    """Splits only where the (64-row tiles x B*H) grid is under a wave of
    the H100's SMs times the blocks each holds, within a portable cluster,
    each rank with two streamed tiles or more; a pure function."""
    plan = plan_f32_backward(bh, tq, tk, d)
    assert plan == want == plan_f32_backward(bh, tq, tk, d)
    dp, bn, kbn, dq_splits, kv_splits = plan
    per_sm = F32_BWD_SHAPES[dp][2]
    for rows, streamed, tile, splits in ((tq, tk, bn, dq_splits),
                                         (tk, tq, kbn, kv_splits)):
        blocks = -(-rows // BWD_ROWS) * bh
        n = -(-streamed // tile)
        assert 1 <= splits <= F32_BWD_MAX_SPLITS
        assert splits == 1 or (blocks * splits <= per_sm * _build.H100_SMS
                               and all(len(r) >= 2 for r in _ranks(n, splits)))
        assert sum(len(r) for r in _ranks(n, splits)) == n


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_emulated_splits_hold_the_plain_backward(splits):
    """The rank-order merges of (m, l, u), dQ and dK, dV at any cluster
    size agree with the plain backward within the f32 bound; a forced
    plan, on a 128-wide head with a key bias."""
    rng = np.random.default_rng(20 + splits)
    q, k, v, bias, do = _inputs(rng, 2, 2, 290, 530, 128, [530, 77])
    scale = 128 ** -0.5
    got = emulate_f32_backward(q, k, v, bias, scale, do,
                               plan=(128, 64, 32, splits, splits))
    want = flash_attention_backward(q, k, v, bias, scale, do)
    assert max(_errors(got, want)) <= RTOL, _errors(got, want)


def test_transposed_planes_order_the_keys_as_the_fragments():
    """The transposes hold each 8 keys in the order 0, 2, 4, 6, 1, 3, 5,
    7: position p of a group is key 2p (p < 4) or 2 (p - 4) + 1, so the
    accumulator's column pair (2t, 2t + 1) of a thread is the A fragment's
    (t, t + 4)."""
    perm = [2 * p if p < 4 else 2 * (p - 4) + 1 for p in range(8)]
    assert perm == [0, 2, 4, 6, 1, 3, 5, 7]
    for t in range(4):   # lane q = t holds columns 2t, 2t + 1
        assert perm[t] == 2 * t and perm[t + 4] == 2 * t + 1


@pytest.mark.parametrize("d,tq,match", [
    (136, 40, "unsupported shape"),   # wider than any kernel's head
    (6, 40, "unit stride"),           # a head dim the kernels cannot step
])
def test_f32_tile_kernels_refuse_what_they_cannot_take(d, tq, match):
    """Refused before any launch (so here, on CPU tensors). D = 128 and
    rows TMA cannot take are not refused: they take the 128-wide
    instantiation and the zero-padded copies
    (tests/test_torch_k1_refused_geometries.py)."""
    q, k, v, do = (torch.zeros(2, 2, t, d) for t in (tq, 9, 9, tq))
    if match == "unit stride":
        q = torch.zeros(2, 2, tq, 2 * d)[..., ::2]
    with pytest.raises(ValueError, match=match):
        fa._grad_launch(q, k, v, None, 0.5, do)


@pytest.mark.parametrize("tq,d,entry", [
    (272, 32, "ns2vc_flash_attention_f32_bwd_wgmma"),   # the F0 geometry
    (1, 100, "ns2vc_flash_attention_bwd_q1_f32"),       # ref_enc's pool
])
def test_f32_backward_launches_its_entry(card_routes, tq, d, entry):
    """As for a CUDA tensor (the library a recorder): the entry point of
    the sub-route, its workspace (the tile kernels' lse and Delta; none
    for one query), the gradients as (B, H, T, D) views of (B, T, H, D)
    buffers in f32, and the counters."""
    import ns2vc_tpu_torch.ops.flash_attention as fa_mod

    q, do = (torch.zeros(2, 8, tq, d) for _ in range(2))
    k, v = (torch.zeros(2, 8, 40, d) for _ in range(2))
    route, _ = grad_route(q, k, v)
    n0 = dict(fa_mod.flash_attention_grad.route_launches)
    grads = fa_mod.flash_attention_grad(q, k, v, None, 0.5, do)
    assert fa_mod.flash_attention_grad.route_launches == {
        **n0, route: n0[route] + 1}
    (name, args), = card_routes.calls
    assert name == entry
    assert (args[8] is None) == route.endswith("_q1")
    assert args[9:14] == (2, 8, tq, 40, d)
    for g, t in zip(grads, (tq, 40, 40)):
        assert g.dtype == torch.float32 and g.shape == (2, 8, t, d)
        assert g.stride() == (t * 8 * d, d, 8 * d, 1)
