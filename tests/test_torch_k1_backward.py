"""K1's bf16 backward kernels (csrc/flash_attention_bwd_wgmma.cu) on the CPU:
their workspace and their arithmetic emulated in torch ops.

The kernels run only on a card (tests/test_torch_cuda.py holds them there
against `flash_attention_backward`). Here:
  - `plan_backward`, the runs each tile kernel's items go in, at the
    step's geometries and elsewhere: one per item or as many as the card
    works at once, even shares;
  - `bwd_workspace`, the wrapper's scratch, at every tile-kernel K1
    geometry of a `Config()` training step (B = 32 x 272, bf16: 46 calls in
    11 geometries): lse and Delta of each padded query row, fixed by the
    shapes, bounded;
  - `emulate_bf16_backward` repeats the kernels' arithmetic: the logits in
    the log2 domain with the key bias, keys padded to 64-key tiles with a
    bias of -inf; sweep 1's online row max m, sum l and u = sum P dP over
    the key tiles in order, lse = m + log2(l) and Delta = u / l (never
    rowsum(dO * O)); P = 2^(x - lse); dS = P (dP - Delta); dV from P
    rounded to bf16; dQ and dK from dS in BWD_DS_PLANES bf16 planes, bf16
    products exact in f32, f32 sums; the single-query kernel's calls in f32
    throughout (no planes). It is held against `flash_attention_backward`
    in f32 at each training geometry (B = 2), and against JAX's gradient
    (`jax.vjp`) of ns2vc_tpu/ops/attention.py::scaled_dot_product_attention,
    the XLA attention the JAX package trains through, at the highest matmul
    precision, on the same numpy inputs; with a fully masked batch row, the
    shared-key case of tests/test_torch_kernels.py (one plane loses dq
    there, two keep it), and the two pools (Tq = 1, D = 4 and 100);
  - the card's bounds (chip_smoke's K1_BWD_RTOL of each batch row's
    max, K1_BWD_RMS of each gradient's norm) at each training geometry: the emulation rounded to bf16 holds them against the plain
    backward in bf16 (as the card compares them); dS in one bf16 plane
    fails the RMS bound, a gradient 10 % off in one batch row the largest
    error's.

Tolerances, of max |reference| per gradient: dq, dk 2e-5 (f32 sums in
other orders, dS's two planes within 2^-17 of it, exp2 against exp);
dv 2^-8 (the kernels round P to bf16 before dV, as the plain version's bf16
PV product does; the f32 references do not: half a bf16 ulp, 2^-9 of each
probability, doubled).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import K1_BWD_RMS, K1_BWD_RTOL, k1_grad_errors
from ns2vc_tpu.ops.attention import scaled_dot_product_attention
from ns2vc_tpu_torch.ops import _build
from ns2vc_tpu_torch.ops.flash_attention import (
    BWD_ROWS, BWD_RUNS_PER_SM, bwd_workspace, flash_attention_backward,
    flash_attention_plain, plan_backward,
)

LOG2E = 1.4426950408889634
BWD_DS_PLANES = 2        # dS's bf16 planes in the dq and dk products
DQK_RTOL = 2e-5
DV_RTOL = 2.0 ** -8
TRAIN_B = 32
# every K1 geometry of a `Config()` training step at 32 x 272, bf16
# (scripts/torch_k1_bwd_compare.py enumerates them from the step on the
# meta device; tests/test_torch_cuda.py K1_TRAIN_GEOMETRIES): (H, Tq, Tk,
# D, key bias, calls)
TRAIN_GEOMETRIES = [
    (8, 272, 272, 16, False, 5), (8, 272, 272, 16, True, 5),
    (8, 136, 136, 32, False, 5), (8, 136, 272, 32, True, 5),
    (8, 68, 68, 48, False, 5), (8, 68, 272, 48, True, 5),
    (8, 34, 34, 64, False, 1), (8, 34, 272, 64, True, 1),
    (8, 272, 272, 32, True, 12),
    (1, 1, 273, 100, False, 1), (64, 1, 273, 4, False, 1),
]


def test_the_geometries_are_the_steps_46_calls():
    assert sum(g[-1] for g in TRAIN_GEOMETRIES) == 46


@pytest.mark.parametrize("geometry",
                         [g for g in TRAIN_GEOMETRIES if g[1] > 1])
def test_workspace_at_the_training_geometries(geometry):
    """lse and Delta of each query row padded to whole 64-row tiles (the
    single-query kernel takes none): at most 1 MB at the step's shapes."""
    h, tq, _, _, _, _ = geometry
    tiles = -(-tq // BWD_ROWS)
    assert (tiles - 1) * BWD_ROWS < tq <= tiles * BWD_ROWS
    ws = bwd_workspace(TRAIN_B, h, tq)
    assert ws == 2 * TRAIN_B * h * tiles * BWD_ROWS
    assert 4 * ws <= 2 ** 20


# (B*H, Tq, Tk, D) -> (dq's, dkdv's) runs at the step's tile calls: the
# runs the card works at once (three an SM at heads of 16 and 32, two at
# 48 and 64), or one per item where there are fewer
PLANS = {(256, 272, 272, 32): (396, 396), (256, 272, 272, 16): (396, 396),
         (256, 136, 136, 32): (396, 396), (256, 136, 272, 32): (396, 396),
         (256, 68, 68, 48): (264, 264), (256, 68, 272, 48): (264, 264),
         (256, 34, 34, 64): (256, 256), (256, 34, 272, 64): (256, 264)}


@pytest.mark.parametrize("geometry",
                         [g for g in TRAIN_GEOMETRIES if g[1] > 1])
def test_plan_at_the_training_geometries(geometry):
    """Each kernel's runs: at most one per item and within what the H100
    works at once; their even shares of the items differ by one at most."""
    h, tq, tk, d, _, _ = geometry
    bh = TRAIN_B * h
    plan = plan_backward(bh, tq, tk, d)
    assert plan == PLANS[(bh, tq, tk, d)]
    dp = 16 if d <= 16 else 32 if d <= 32 else 64
    for runs, rows in zip(plan, (tq, tk)):
        items = -(-rows // BWD_ROWS) * bh
        assert runs == min(items, _build.H100_SMS * BWD_RUNS_PER_SM[dp])
        shares = [(r + 1) * items // runs - r * items // runs
                  for r in range(runs)]
        assert sum(shares) == items and max(shares) - min(shares) <= 1


@pytest.mark.parametrize("bh,tq,tk,d,want", [
    (8, 400, 400, 128, (56, 56)),   # the op registry's ids 14 / 15 in bf16
    (2, 9, 30, 104, (2, 2)),        # "tc_pad" at D = 100, padded to 104
    (1, 40000, 64, 64, (264, 1)),   # one head, long queries: 625 q tiles
    (512, 1000, 1000, 16, (396, 396)),
    (2000, 64, 64, 128, (132, 132)),   # one block an SM at 128 columns
])
def test_plan_elsewhere(bh, tq, tk, d, want):
    """One run per item, or as many as the card works at once: one an SM
    at the 128-wide head, two at 48-64 columns, three at 32 or fewer."""
    assert plan_backward(bh, tq, tk, d) == want


def _planes(x, n):
    """x as n bf16 planes (each the remainder's rounding), as f32."""
    out, rest = [], x
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def emulate_bf16_backward(q, k, v, bias, scale, do, planes=BWD_DS_PLANES):
    """(dq, dk, dv) in f32 as the bf16 kernels compute them (before their
    rounding to bf16), on bf16 q, k, v, do (B, H, T, D) and an f32 key
    bias (B, Tk) or None: torch ops over 64-key tiles. One query: the
    single-query kernel, dS in f32."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    tq, tk = q.shape[2], k.shape[2]
    tiles = -(-tk // BWD_ROWS)
    pad = tiles * BWD_ROWS - tk
    kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (kf, vf))
    kb = torch.zeros(q.shape[0], tk) if bias is None else bias * LOG2E
    kb = F.pad(kb, (0, pad), value=-float("inf"))[:, None, None, :]
    # bf16 x bf16 products are exact in f32; the sums are f32
    x = qf @ kp.transpose(-1, -2) * (scale * LOG2E) + kb
    dp = dof @ vp.transpose(-1, -2)
    m = torch.full(x.shape[:-1], -float("inf"))
    l = torch.zeros(x.shape[:-1])
    u = torch.zeros(x.shape[:-1])
    for j in range(tiles):   # sweep 1, the key tiles in order
        xs = x[..., j * BWD_ROWS:(j + 1) * BWD_ROWS]
        dps = dp[..., j * BWD_ROWS:(j + 1) * BWD_ROWS]
        mx = torch.maximum(m, xs.amax(-1))
        ref = torch.where(mx == -float("inf"), 0.0, mx)
        alpha = torch.exp2(m - ref)
        p = torch.exp2(xs - ref[..., None])
        l = l * alpha + p.sum(-1)
        u = u * alpha + (p * dps).sum(-1)
        m = mx
    lse = m + torch.log2(l)
    delta = u / l
    p = torch.exp2(x - lse[..., None])
    ds = p * (dp - delta[..., None])
    dv = p.to(torch.bfloat16).float().transpose(-1, -2) @ dof
    parts = [ds] if tq == 1 else _planes(ds, planes)
    dq = sum(s @ kp for s in parts) * scale
    dk = sum(s.transpose(-1, -2) @ qf for s in parts) * scale
    return dq, dk[..., :tk, :], dv[..., :tk, :]


def _inputs(rng, b, h, tq, tk, d, lengths=None):
    """Seeded bf16 q, k, v, do and a key-padding bias (or None)."""
    q, k, v, do = (torch.tensor(rng.standard_normal((b, h, t, d)),
                                dtype=torch.float32).bfloat16()
                   for t in (tq, tk, tk, tq))
    bias = None
    if lengths is not None:
        keep = torch.arange(tk)[None, :] < torch.tensor(lengths)[:, None]
        bias = (1.0 - keep.float()) * -1e4
    return q, k, v, bias, do


def _errors(got, want):
    return [((g - w.float()).abs().max() / w.float().abs().max()).item()
            for g, w in zip(got, want)]


def _hold(got, want):
    dq, dk, dv = _errors(got, want)
    assert dq <= DQK_RTOL and dk <= DQK_RTOL, (dq, dk)
    assert dv <= DV_RTOL, dv


@pytest.mark.parametrize("geometry", TRAIN_GEOMETRIES)
def test_emulation_holds_the_plain_backward(geometry):
    """At each training geometry (B = 2; the second batch row's keys
    padded where the step has a key bias): the plain backward in f32 on
    the same bf16 values."""
    h, tq, tk, d, with_bias, _ = geometry
    rng = np.random.default_rng(tq + tk + d + h)
    q, k, v, bias, do = _inputs(rng, 2, h, tq, tk, d,
                                [tk, tk // 3] if with_bias else None)
    scale = d ** -0.5
    got = emulate_bf16_backward(q, k, v, bias, scale, do)
    want = flash_attention_backward(q.float(), k.float(), v.float(), bias,
                                    scale, do.float())
    _hold(got, want)


@pytest.mark.parametrize("h,tq,tk,d,lengths", [
    (2, 70, 90, 16, [90, 33]),     # ragged tiles, key padding
    (3, 136, 272, 32, None),       # a UNet level's cross shape
    (1, 1, 273, 100, None),        # ref_enc's pool
    (4, 1, 40, 4, [40, 9]),        # add_embedding's width, a key bias
])
def test_emulation_holds_jax_gradient(h, tq, tk, d, lengths):
    """Against jax.vjp of the JAX package's XLA attention (f32, highest
    precision) on the same bf16-valued inputs."""
    rng = np.random.default_rng(3 + tq + d)
    q, k, v, bias, do = _inputs(rng, 2, h, tq, tk, d, lengths)
    scale = d ** -0.5
    jb = None if bias is None else jnp.asarray(bias.numpy())[:, None, None]
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda a, b_, c: scaled_dot_product_attention(
            a, b_, c, jb, scale), *(jnp.asarray(t.float().numpy())
                                    for t in (q, k, v)))
        want = [torch.tensor(np.asarray(g))
                for g in vjp(jnp.asarray(do.float().numpy()))]
    got = emulate_bf16_backward(q, k, v, bias, scale, do)
    _hold(got, want)


@pytest.mark.parametrize("tq", [1, 70])
def test_emulation_with_a_fully_masked_row(tq):
    """A batch row whose every key is masked (-1e4): finite, and the plain
    version's (the softmax of the scores shifted by -1e4). Its f32 logits
    carry steps of 2^-10 (the kernels' log2-domain ones others): 2e-3 of
    max|grad| for dq and dk, as the card tests' masked bound; dv as
    everywhere."""
    q, k, v, _, do = _inputs(np.random.default_rng(9), 2, 2, tq, 90, 16)
    bias = torch.zeros(2, 90)
    bias[1] = -1e4
    got = emulate_bf16_backward(q, k, v, bias, 0.25, do)
    want = flash_attention_backward(q.float(), k.float(), v.float(), bias,
                                    0.25, do.float())
    assert all(torch.isfinite(g).all() for g in got)
    dq, dk, dv = _errors(got, want)
    assert dq <= 2e-3 and dk <= 2e-3 and dv <= DV_RTOL, (dq, dk, dv)
    # the unmasked row alone within the f32 bound
    _hold([g[:1] for g in got], [w[:1] for w in want])


def _shared_key_inputs():
    """tests/test_torch_kernels.py's case: keys and values that share a
    component, as projections of normalised features do."""
    r = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(0.3 * r.standard_normal((2, 4, 64, 16))
                                + off).bfloat16()
               for off in (0.0, 3.0, 3.0))
    do = torch.from_numpy(r.standard_normal((2, 4, 64, 16))).bfloat16()
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    flash_attention_plain(*leaves, None, 0.25).backward(do.double())
    return q, k, v, do, leaves[0].grad


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def test_emulated_planes_keep_dq_with_a_shared_key_component():
    q, k, v, do, want = _shared_key_inputs()
    dq = emulate_bf16_backward(q, k, v, None, 0.25, do)[0]
    assert _cosine(dq, want) > 0.9999
    # the kernels' bf16 output keeps it too
    assert _cosine(dq.bfloat16(), want) > 0.9999


def test_one_plane_loses_dq_with_a_shared_key_component():
    """dS rounded to bf16 once breaks each row's zero sum by ~2^-9 of |dS|,
    which the component the keys share turns into dq's error: the kernels
    take two planes."""
    q, k, v, do, want = _shared_key_inputs()
    assert BWD_DS_PLANES == 2
    one = emulate_bf16_backward(q, k, v, None, 0.25, do, planes=1)[0]
    two = emulate_bf16_backward(q, k, v, None, 0.25, do)[0]
    assert _cosine(one, want) < 0.9999 < _cosine(two, want)


@pytest.mark.parametrize("geometry", TRAIN_GEOMETRIES)
def test_card_bound_holds_the_emulation_and_fails_a_wrong_backward(
        geometry):
    h, tq, tk, d, with_bias, _ = geometry
    rng = np.random.default_rng(5 + tq + tk + d + h)
    q, k, v, bias, do = _inputs(rng, 2, h, tq, tk, d,
                                [tk, tk // 3] if with_bias else None)
    scale = d ** -0.5
    got = [g.bfloat16() for g in emulate_bf16_backward(q, k, v, bias, scale,
                                                       do)]
    want = flash_attention_backward(q, k, v, bias, scale, do)
    peak, rms = k1_grad_errors(got, want)
    assert max(peak) <= K1_BWD_RTOL and max(rms) <= K1_BWD_RMS, (peak, rms)
    for i in range(3):   # one gradient 10 % off in the second batch row
        wrong = [g.clone() for g in got]
        wrong[i][1] *= 1.1
        assert k1_grad_errors(wrong, want)[0][i] > K1_BWD_RTOL, i
    if tq > 1:           # the tile kernels' dS in one bf16 plane
        one = [g.bfloat16() for g in emulate_bf16_backward(
            q, k, v, bias, scale, do, planes=1)]
        rms = k1_grad_errors(one, want)[1]
        assert min(rms[:2]) > K1_BWD_RMS, rms
