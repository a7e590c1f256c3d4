"""K2's bf16 backward kernels (csrc/affine_silu_conv1d_bwd_wgmma.cu) on the
CPU: their planner, and their arithmetic emulated in torch ops.

The kernels run only on a card (tests/test_torch_cuda.py holds them there
against the plain backward). Here:
  - `plan_wgrad`, `frame_slots` and the workspace at every width of
    `Config()`'s UNet (C, Co of 128..1024 at T = 272 / 136 / 68 / 34, B =
    32): splits fixed by the shapes, none empty, within the card's SMs, a
    bounded workspace; every batch row's frame tiles within its slots;
  - `emulate_bf16_backward` repeats the kernels' arithmetic on the
    flattened B * T frames: the SAME halo masked at each batch row's edges
    (dy's rows in both products), h as BWD_H_PLANES bf16 planes, bf16
    products exact in f32, f32 sums, da / db per batch row. It is held
    within K2_BWD_RTOL (3e-5 of max|plain| per gradient, the card tests'
    bound) of `affine_silu_conv1d_backward` in f32 at each training
    geometry (B = 3: batch rows that straddle the 64-frame tiles), and of
    JAX's gradient of the XLA composite the Pallas kernel is tested
    against (tests/test_pallas_resnet.py), f32 at the highest precision.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ns2vc_tpu_torch.ops import _build
from ns2vc_tpu_torch.ops.fused_resnet import (
    BWD_H_PLANES, WG_COLS, WG_FRAMES, WG_MAX_SPLITS, WG_ROWS,
    affine_silu_conv1d_backward, frame_slots, plan_wgrad,
    wgmma_backward_workspace,
)

K2_BWD_RTOL = 3e-5
WIDTHS = range(128, 1025, 128)
LEVELS = (272, 136, 68, 34)
TRAIN_B = 32
# every (T, C, Co) of K2 in a `Config()` training step (tests/
# test_torch_cuda.py K2_TRAIN_GEOMETRIES)
TRAIN_GEOMETRIES = [
    (272, 128, 128), (272, 384, 128), (272, 256, 128), (272, 128, 100),
    (136, 128, 256), (136, 256, 256), (136, 640, 256), (136, 512, 256),
    (136, 384, 256),
    (68, 256, 384), (68, 384, 384), (68, 896, 384), (68, 768, 384),
    (68, 640, 384),
    (34, 384, 512), (34, 512, 512), (34, 1024, 512), (34, 896, 512),
]


def test_plan_wgrad_at_every_config_width():
    worst = 0
    for t in LEVELS:
        chunks = -(-TRAIN_B * t // WG_FRAMES)
        for c in WIDTHS:
            for co in WIDTHS:
                s = plan_wgrad(TRAIN_B, t, c, co)
                tiles = -(-c // WG_COLS) * -(-co // WG_ROWS)
                assert 1 <= s <= min(chunks, WG_MAX_SPLITS)
                assert s == 1 or tiles * s <= _build.H100_SMS
                # split z's chunks [z n / S, (z + 1) n / S): contiguous,
                # covering every chunk once, none empty
                bounds = [z * chunks // s for z in range(s + 1)]
                assert bounds[0] == 0 and bounds[-1] == chunks
                assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))
                assert plan_wgrad(TRAIN_B, t, c, co) == s   # shapes alone
                worst = max(worst, 4 * wgmma_backward_workspace(
                    TRAIN_B, t, c, co, s))
    # dw's partials: splits x tiles <= 132 SMs, or one split (at most 3 x
    # 1024 x 1024 f32, 12.6 MB); h's planes: 4 bytes per input value (at
    # most 8704 x 1024, 35.7 MB; the step's widest at T = 272, C = 384:
    # 13.4 MB); da / db: 1.5 MB
    assert worst <= 48 * 2 ** 20, worst


@pytest.mark.parametrize("t", [1, 5, 33, 34, 63, 64, 65, 68, 136, 272])
def test_frame_slots_cover_every_batch_row(t):
    for bsz in (1, 3, 32):
        for b in range(bsz):
            first = b * t // WG_FRAMES
            last = (b * t + t - 1) // WG_FRAMES
            assert last - first + 1 <= frame_slots(t)


def _planes(h, n):
    """h as n bf16 planes (each the remainder's rounding), as f32."""
    out, rest = [], h
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def emulate_bf16_backward(x, a, b, w, dy, planes=BWD_H_PLANES):
    """(dx, da, db, dw, dbias) in f32 as the bf16 kernels compute them, on
    bf16 x, w, dy and f32 a, b, h in `planes` bf16 planes: torch ops over
    the flattened frames."""
    bsz, t, c = x.shape
    co = w.shape[0]
    bt = bsz * t
    tpos = torch.arange(bt) % t
    row = torch.arange(bt) // t
    xf = x.float().reshape(bt, c)
    af, bf = a[row], b[row]
    z = xf * af + bf
    s = torch.sigmoid(z)
    h = z * s
    dyf = dy.float().reshape(bt, co)
    wf = w.float()
    pad = torch.zeros(1, co)
    dyp = torch.cat([pad, dyf, pad])            # frames -1 .. BT
    # dgrad: row offset r reads frame f + r - 1 through tap 2 - r, zero
    # where that frame lies in another batch row
    dh = torch.zeros(bt, c)
    for r in range(3):
        arows = dyp[r:r + bt].clone()
        if r == 0:
            arows[tpos == 0] = 0
        if r == 2:
            arows[tpos == t - 1] = 0
        dh += arows @ wf[:, :, 2 - r]
    dz = dh * (s * (1.0 + z * (1.0 - s)))
    dx = (dz * af).reshape(bsz, t, c)
    da = (dz * xf).reshape(bsz, t, c).sum(1)
    db = dz.reshape(bsz, t, c).sum(1)
    # wgrad: tap k pairs h[f] with dy[f - k + 1] (A, transposed), zero
    # where that frame lies in another batch row; the planes' products
    # (bf16 x bf16, exact in f32) summed in f32
    dw = torch.zeros(co, c, 3)
    for k in range(3):
        arows = dyp[2 - k:2 - k + bt].clone()
        if k == 0:
            arows[tpos == t - 1] = 0
        if k == 2:
            arows[tpos == 0] = 0
        for plane in _planes(h, planes):
            dw[:, :, k] += arows.t() @ plane
    return dx, da, db, dw, dyf.sum(0)


def _inputs(rng, bsz, t, c, co):
    x = torch.tensor(rng.standard_normal((bsz, t, c)), dtype=torch.float32)
    a = torch.tensor(1 + 0.3 * rng.standard_normal((bsz, c)),
                     dtype=torch.float32)
    b = torch.tensor(0.3 * rng.standard_normal((bsz, c)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((co, c, 3)) / np.sqrt(3 * c),
                     dtype=torch.float32)
    dy = torch.tensor(rng.standard_normal((bsz, t, co)), dtype=torch.float32)
    return (x.to(torch.bfloat16), a, b, w.to(torch.bfloat16),
            dy.to(torch.bfloat16))


def _rel_errors(got, want):
    return {name: ((g - e).abs().max() / e.abs().max()).item()
            for name, g, e in zip(("dx", "da", "db", "dw", "dbias"), got,
                                  want)}


@pytest.mark.parametrize("geometry", TRAIN_GEOMETRIES)
def test_emulated_planes_hold_the_plain_backward(geometry):
    t, c, co = geometry
    x, a, b, w, dy = _inputs(np.random.default_rng(t + c + co), 3, t, c, co)
    got = emulate_bf16_backward(x, a, b, w, dy)
    want = affine_silu_conv1d_backward(x.float(), a, b, w.float(),
                                       torch.zeros(co), dy.float())
    err = _rel_errors(got, want)
    assert max(err.values()) <= K2_BWD_RTOL, err


def test_one_plane_misses_the_bound():
    """h rounded to bf16 once moves dw by ~2^-9 of its terms: the kernels
    take two planes."""
    x, a, b, w, dy = _inputs(np.random.default_rng(5), 3, 68, 256, 128)
    want = affine_silu_conv1d_backward(x.float(), a, b, w.float(),
                                       torch.zeros(128), dy.float())
    assert BWD_H_PLANES == 2
    one = emulate_bf16_backward(x, a, b, w, dy, planes=1)
    assert _rel_errors(one, want)["dw"] > K2_BWD_RTOL


def test_emulated_planes_hold_jax_gradient():
    """The emulation against JAX's gradient of the XLA composite (flax's
    SAME conv over silu(x a + b)) in f32, highest precision, on the same
    numpy inputs; T = 34 over 3 batch rows crosses 64-frame tiles."""
    bsz, t, c, co = 3, 34, 128, 128
    x, a, b, w, dy = _inputs(np.random.default_rng(7), bsz, t, c, co)
    bias = np.zeros(co, np.float32)

    def chain(xj, aj, bj, wj, biasj):
        h = nn.silu(xj * aj[:, None, :] + bj[:, None, :])
        return nn.Conv(co, (3,), padding="SAME").apply(
            {"params": {"kernel": wj, "bias": biasj}}, h)
    args = (x.float().numpy(), a.numpy(), b.numpy(),
            np.transpose(w.float().numpy(), (2, 1, 0)), bias)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(chain, *map(jnp.asarray, args))
        gx, ga, gb, gw, gbias = vjp(jnp.asarray(dy.float().numpy()))
    want = [torch.tensor(np.asarray(v)) for v in (
        gx, ga, gb, np.transpose(np.asarray(gw), (2, 1, 0)), gbias)]
    got = emulate_bf16_backward(x, a, b, w, dy)
    err = _rel_errors(got, want)
    assert max(err.values()) <= K2_BWD_RTOL, err
