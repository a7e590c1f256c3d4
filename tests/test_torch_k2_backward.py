"""K2's backward kernels (bf16: csrc/affine_silu_conv1d_bwd_wgmma.cu; f32:
csrc/affine_silu_conv1d_f32_bwd_wgmma.cu) on the CPU: their planners, and
their arithmetic emulated in torch ops.

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
    against (tests/test_pallas_resnet.py), f32 at the highest precision;
  - `plan_wgrad_f32` and `f32_backward_workspace` likewise, and
    `emulate_f32_backward` repeats the f32 kernels' 3xTF32 arithmetic:
    each product's A from registers and B from its planes, both split into
    TF32 halves (`tf32_round`, cvt.rna), three passes small.big +
    big.small + big.big, exact in f32 and summed in f32; w's planes
    transposed (output channels contiguous), h's planes as dgrad's
    epilogue writes them (channels by frames), dy's rows at each tap's
    offset with the SAME halo masked, dbias from dy's raw values. It is
    held within K2_BWD_RTOL of the plain backward in f32 and of JAX's
    gradient, and within the card's f64 bound (`chip_smoke.k2_f32_holds`:
    max(1e-4, 4 x the plain f32 backward's own error) of max|f64|); one
    TF32 pass instead of three misses it.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import k2_f32_errors, k2_f32_holds
from ns2vc_tpu_torch.ops import _build
from ns2vc_tpu_torch.ops.fused_resnet import (
    BWD_H_PLANES, F32_CO_CHUNK, F32_WG_FRAMES, WG_COLS, WG_FRAMES,
    WG_MAX_SPLITS, WG_ROWS, affine_silu_conv1d_backward,
    f32_backward_workspace, frame_slots, plan_wgrad, plan_wgrad_f32,
    tf32_round, wgmma_backward_workspace,
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


# -- the f32 kernels (3xTF32 on tf32 wgmma) -----------------------------------

def test_plan_wgrad_f32_at_every_config_width():
    worst = 0
    for t in LEVELS:
        chunks = -(-TRAIN_B * t // F32_WG_FRAMES)
        for c in WIDTHS:
            for co in WIDTHS:
                s = plan_wgrad_f32(TRAIN_B, t, c, co)
                tiles = -(-c // WG_COLS) * -(-co // WG_ROWS)
                assert 1 <= s <= min(chunks, WG_MAX_SPLITS)
                assert s == 1 or tiles * s <= _build.H100_SMS
                bounds = [z * chunks // s for z in range(s + 1)]
                assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))
                worst = max(worst, 4 * f32_backward_workspace(
                    TRAIN_B, t, c, co, s))
    # dw's partials (at most 12.6 MB), w's planes (2 x 3 x 1024 x 1024 f32,
    # 25.2 MB), h's planes (8 bytes per input value: at most 71.3 MB at T =
    # 272, C = 1024)
    assert worst <= 112 * 2 ** 20, worst


def test_f32_workspace_layout():
    """Each part at a multiple of 32 values (128 bytes: TMA's 16-byte rule
    for the planes' bases), in the kernels' order."""
    bsz, t, c, co, s = 3, 37, 40, 100, 5
    cp, cop, btp = 64, 128, 112
    parts = [s * 3 * co * c, s * co, bsz * frame_slots(t) * c,
             bsz * frame_slots(t) * c, 2 * 3 * cp * cop, 2 * cp * btp]
    assert cop % F32_CO_CHUNK == 0
    assert f32_backward_workspace(bsz, t, c, co, s) == sum(
        -(-n // 32) * 32 for n in parts)


def _x3(a, b, passes=3):
    """a @ b with both operands split into TF32 halves: three passes
    (small.big + big.small + big.big), each product exact in f32; one pass
    is big.big alone."""
    ab, bb = tf32_round(a.contiguous()), tf32_round(b.contiguous())
    if passes == 1:
        return ab @ bb
    as_, bs = tf32_round(a - ab), tf32_round(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def emulate_f32_backward(x, a, b, w, dy, passes=3):
    """(dx, da, db, dw, dbias) in f32 as the f32 kernels compute them, on
    f32 x, a, b, w, dy: torch ops over the flattened frames."""
    bsz, t, c = x.shape
    co = w.shape[0]
    bt = bsz * t
    tpos = torch.arange(bt) % t
    row = torch.arange(bt) // t
    xf = x.reshape(bt, c)
    af, bf = a[row], b[row]
    z = xf * af + bf
    s = torch.sigmoid(z)
    h = z * s
    dyf = dy.reshape(bt, co)
    pad = torch.zeros(1, co)
    dyp = torch.cat([pad, dyf, pad])            # frames -1 .. BT

    def tap_rows(k):
        """dy[f - k + 1] for every frame f, zero across a batch row."""
        rows = dyp[2 - k:2 - k + bt].clone()
        if k == 0:
            rows[tpos == t - 1] = 0
        if k == 2:
            rows[tpos == 0] = 0
        return rows
    # dgrad: A = dy's rows at the tap's offset (K = Co), B = w's planes as
    # packed, (C, Co) per tap
    wt = w.permute(2, 1, 0)                     # (3, C, Co)
    dh = torch.zeros(bt, c)
    for k in range(3):
        dh += _x3(tap_rows(k), wt[k].t(), passes)
    dz = dh * (s * (1.0 + z * (1.0 - s)))
    dx = (dz * af).reshape(bsz, t, c)
    da = (dz * xf).reshape(bsz, t, c).sum(1)
    db = dz.reshape(bsz, t, c).sum(1)
    # wgrad: A = dy's rows transposed (o by frames), B = h's planes (K =
    # frames)
    dw = torch.stack([_x3(tap_rows(k).t(), h, passes) for k in range(3)],
                     dim=-1)
    return dx, da, db, dw, dyf.sum(0)


def _f32_inputs(rng, bsz, t, c, co):
    x, a, b, w, dy = _inputs(rng, bsz, t, c, co)
    return x.float(), a, b, w.float(), dy.float()


def _f32_raw_inputs(rng, bsz, t, c, co):
    """f32 inputs that are not bf16 values (every mantissa bit set)."""
    x = torch.tensor(rng.standard_normal((bsz, t, c)), dtype=torch.float32)
    a = torch.tensor(1 + 0.3 * rng.standard_normal((bsz, c)),
                     dtype=torch.float32)
    b = torch.tensor(0.3 * rng.standard_normal((bsz, c)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((co, c, 3)) / np.sqrt(3 * c),
                     dtype=torch.float32)
    dy = torch.tensor(rng.standard_normal((bsz, t, co)), dtype=torch.float32)
    return x, a, b, w, dy


@pytest.mark.parametrize("geometry", TRAIN_GEOMETRIES[::3] + [(37, 40, 100)])
def test_emulated_f32_kernels_hold_the_plain_backward(geometry):
    t, c, co = geometry
    x, a, b, w, dy = _f32_raw_inputs(np.random.default_rng(t + c), 3, t, c,
                                     co)
    got = emulate_f32_backward(x, a, b, w, dy)
    want = affine_silu_conv1d_backward(x, a, b, w, torch.zeros(co), dy)
    err = _rel_errors(got, want)
    assert max(err.values()) <= K2_BWD_RTOL, err
    f64 = affine_silu_conv1d_backward(x.double(), a.double(), b.double(),
                                      w.double(), torch.zeros(co).double(),
                                      dy.double())
    errs, plain = k2_f32_errors(got, want, f64)
    assert k2_f32_holds(errs, plain), (errs, plain)


def test_one_tf32_pass_misses_the_f32_bound():
    """The three passes are what holds f32 accuracy: one TF32 pass per
    product (the rounded operands alone) misses the bound by far."""
    x, a, b, w, dy = _f32_raw_inputs(np.random.default_rng(6), 3, 68, 256,
                                     128)
    want = affine_silu_conv1d_backward(x, a, b, w, torch.zeros(128), dy)
    f64 = affine_silu_conv1d_backward(x.double(), a.double(), b.double(),
                                      w.double(), torch.zeros(128).double(),
                                      dy.double())
    one = emulate_f32_backward(x, a, b, w, dy, passes=1)
    assert _rel_errors(one, want)["dw"] > 5 * K2_BWD_RTOL
    errs, plain = k2_f32_errors(one, want, f64)
    assert not k2_f32_holds(errs, plain)


def test_emulated_f32_kernels_hold_jax_gradient():
    """The f32 emulation against JAX's gradient of the XLA composite in
    f32, highest precision, on the same numpy inputs; T = 34 over 3 batch
    rows crosses the 32-frame chunks and 64-frame tiles."""
    bsz, t, c, co = 3, 34, 128, 96
    x, a, b, w, dy = _f32_raw_inputs(np.random.default_rng(8), bsz, t, c,
                                     co)
    bias = np.zeros(co, np.float32)

    def chain(xj, aj, bj, wj, biasj):
        h = nn.silu(xj * aj[:, None, :] + bj[:, None, :])
        return nn.Conv(co, (3,), padding="SAME").apply(
            {"params": {"kernel": wj, "bias": biasj}}, h)
    args = (x.numpy(), a.numpy(), b.numpy(),
            np.transpose(w.numpy(), (2, 1, 0)), bias)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(chain, *map(jnp.asarray, args))
        gx, ga, gb, gw, gbias = vjp(jnp.asarray(dy.numpy()))
    want = [torch.tensor(np.asarray(v)) for v in (
        gx, ga, gb, np.transpose(np.asarray(gw), (2, 1, 0)), gbias)]
    got = emulate_f32_backward(x, a, b, w, dy)
    err = _rel_errors(got, want)
    assert max(err.values()) <= K2_BWD_RTOL, err
