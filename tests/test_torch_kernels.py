"""The port's two kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the Pallas kernel run in interpret mode, on the same
numpy inputs, in f32. Tolerances are the JAX suite's own
(tests/test_pallas_attention.py, tests/test_pallas_resnet.py).
"""

import contextlib
import itertools
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ns2vc_tpu.ops import pallas_attention, pallas_resnet
from ns2vc_tpu_torch.ops import _build
from ns2vc_tpu_torch.ops.attention import multihead_attention
from ns2vc_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain, plan_f32_wgmma,
    plan_wgmma_attention,
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
    got = multihead_attention(q, k, v, heads, bias=bias[:, None, None, :])
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


# -- the tensor-core routes' Python: weight packing, planner, routing --------

@pytest.mark.parametrize("b,t,c,co", [
    (2, 9, 24, 40),       # C and Co no multiple of the tile
    (1, 5, 128, 100),     # the UNet output tail's Co
    (3, 70, 96, 136),
])
def test_packed_weights_give_conv1d(b, t, c, co):
    """The packed weights, used as the kernels use them (tap k multiplies
    the frames shifted by k - 1, zero padded), give F.conv1d's k=3 SAME
    product: bf16 (3, Co_pad, C_pad) in the wgmma kernel's 128-wide output
    tiles and 64-channel chunks (rows of 128 bytes for TMA); f32 (2, 3,
    Co_pad, C_pad) in 128 x 16 (rows of 64 bytes), TF32 big and small
    halves (the low 13 bits of each zero) that sum to w within 2^-22 of
    |w|."""
    import torch.nn.functional as F

    from ns2vc_tpu_torch.ops.fused_resnet import (
        F32_BK, F32_BN, TC_BK, TC_BN, pack_conv_weight,
    )

    r = np.random.default_rng(b * t)
    h = torch.from_numpy(r.standard_normal((b, t, c)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((co, c, 3)).astype(np.float32))
    packed = pack_conv_weight(w.bfloat16())
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (3, -(-co // TC_BN) * TC_BN, -(-c // TC_BK) * TC_BK)
    assert packed.shape[2] * packed.element_size() % 128 == 0
    assert not packed[:, co:].any() and not packed[:, :, c:].any()
    planes = pack_conv_weight(w)
    assert planes.dtype == torch.float32 and planes.is_contiguous()
    assert planes.shape == (2, 3, -(-co // F32_BN) * F32_BN,
                            -(-c // F32_BK) * F32_BK)
    assert (F32_BN, F32_BK * planes.element_size()) == (128, 64)
    assert not planes[:, :, co:].any() and not planes[:, :, :, c:].any()
    assert not (planes.view(torch.int32) & 0x1FFF).any()
    joined = planes[0] + planes[1]
    taps = w.permute(2, 0, 1)
    assert ((joined[:, :co, :c] - taps).abs()
            <= 2.0 ** -22 * taps.abs()).all()
    for wk, pk in ((w.bfloat16().float(), packed.float()), (w, joined)):
        hp = torch.nn.functional.pad(h, (0, pk.shape[2] - c, 1, 1))
        got = sum(hp[:, k:k + t] @ pk[k].T for k in range(3))[..., :co]
        want = F.conv1d(h.transpose(1, 2), wk, padding=1).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def _full_resnet_cases():
    import chip_smoke
    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2

    with torch.device("meta"):
        unet = NaturalSpeech2(Config()).diff_model.unet
    return chip_smoke.resnet_cases(unet)


@pytest.mark.parametrize("bsz", [1, 2, 16])
def test_planner_fills_the_card(bsz):
    """Every K2 geometry of the serving bucket at B in {1, 2, 16}: each
    split plan deals every chunk to exactly one non-empty split. Both conv
    kernels (f32: `plan_tc`, 16-channel chunks; bf16: `plan_wgmma`,
    64-channel chunks; 64 x 128 tiles, one block per SM) split into one
    cluster of at most 8 of two chunks or more each and stay within one
    wave of 132 blocks: as many splits as that allows, none once the
    tiles fill it."""
    from ns2vc_tpu_torch.ops.fused_resnet import (
        F32_BK, F32_BM, F32_BN, TC_BK, TC_BM, TC_BN, TC_MAX_SPLITS, plan_tc,
        plan_wgmma,
    )
    from ns2vc_tpu_torch.ops._build import H100_SMS

    cases = _full_resnet_cases()
    assert len(cases) == 45
    for (plan, bm, bn, bk), t_div in itertools.product(
            ((plan_tc, F32_BM, F32_BN, F32_BK),
             (plan_wgmma, TC_BM, TC_BN, TC_BK)), (1, 2)):
        for name, t, c, co, _ in cases:   # the bucket and a half-length one
            t //= t_div
            splits, cps = plan(bsz, t, c, co)
            n_chunks = -(-c // bk)
            tiles = -(-t // bm) * -(-co // bn) * bsz
            assert (splits - 1) * cps < n_chunks <= splits * cps, name
            assert splits <= TC_MAX_SPLITS, (name, bsz, t)
            assert splits == 1 or cps >= 2, (name, bsz, t)
            most = max(1, min(TC_MAX_SPLITS, n_chunks // 2,
                              H100_SMS // tiles))
            assert cps == -(-n_chunks // most), (name, bsz, t)
            assert tiles * splits <= max(tiles, H100_SMS), (name, bsz, t)
            if tiles >= H100_SMS // 2:
                assert splits <= 1 + (tiles < H100_SMS), (name, bsz, t)


@pytest.mark.parametrize("bh,tq,tk,d,want", [
    (12, 400, 400, 64, (3, 3)),       # ContentVec, 20 s: 84 blocks
    (8, 400, 400, 128, (2, 7)),       # op registry ids 14/15: 32-key tiles
    (12, 3000, 3000, 64, (1, 47)),    # 564 blocks fill the card
    (128, 448, 448, 16, (1, 7)),      # the UNet's level 0 at B=16
    (12, 50, 50, 64, (1, 1)),         # one key tile
])
def test_f32_attention_planner(bh, tq, tk, d, want):
    """The f32 kernel's key split: none once 64-query blocks fill the
    H100's SMs, else as many as its resident blocks allow, over equal runs
    of key tiles that cover every tile and leave no split empty."""
    from ns2vc_tpu_torch.ops.flash_attention import plan_f32tc

    splits, per = plan_f32tc(bh, tq, tk, d)
    tiles = -(-tk // (64 if d <= 64 else 32))
    assert (splits, per) == want
    assert (splits - 1) * per < tiles <= splits * per


def _unet_attention_geometries():
    """(B*H, Tq, Tk, D) of the UNet's 32 attention calls per step at the
    serving bucket (448 frames, a 320-frame prompt), level by level."""
    out = []
    for lvl, hd in enumerate((16, 32, 48, 64)):
        t = 448 >> lvl
        out += [(t, t, hd), (t, 320, hd)]
    return out


@pytest.mark.parametrize("bsz,heads", [(16, 8), (1, 8), (16, 4), (1, 4)])
def test_wgmma_attention_planner(bsz, heads):
    """The key tile of every UNet attention at B=16 and B=1, with 8 heads
    and with the 4 local heads of the 'model' axis: 128 keys only where
    the grid's 64-query blocks fit one wave of the H100's SMs, the head is
    at most 64 wide and the keys fill two 128-key tiles; 64 elsewhere."""
    from ns2vc_tpu_torch.ops._build import H100_SMS

    want = {  # (B*H, level, self / cross) -> keys per tile
        (128, 0): (64, 64), (128, 1): (64, 64), (128, 2): (64, 64),
        (128, 3): (64, 128),     # 128 blocks: self 56 keys, cross 320
        (8, 0): (128, 128), (8, 1): (128, 128), (8, 2): (64, 128),
        (8, 3): (64, 128),       # 112 and 56 keys: one 128-key tile
        (64, 0): (64, 64), (64, 1): (64, 64), (64, 2): (64, 128),
        (64, 3): (64, 128),      # 448, 256, 128 and 64 blocks
        (4, 0): (128, 128), (4, 1): (128, 128), (4, 2): (64, 128),
        (4, 3): (64, 128)}
    bh = bsz * heads
    for i, (tq, tk, d) in enumerate(_unet_attention_geometries()):
        got = plan_wgmma_attention(bh, tq, tk, d)
        assert got == want[(bh, i // 2)][i % 2], (bh, tq, tk, d)
        blocks = -(-tq // 64) * bh
        assert (got == 128) == (blocks <= H100_SMS and tk > 128 and d <= 64)
    # wider heads keep 64-key tiles (the op registry's D = 128)
    assert plan_wgmma_attention(8, 400, 400, 128) == 64


def _f32_attention_geometries():
    """(name, B*H, Tq, Tk, D) of every f32 K1 call of more than one query
    that the path makes: the UNet's at B=16 and B=1 (`chip_smoke.
    attention_cases`: serving, and the f32 CLI run's batches), ContentVec's
    at T = 50, 400, 850 and 3000, the F0 predictor's cross-attention and
    the op registry's D = 128."""
    import chip_smoke
    from ns2vc_tpu_torch.config import Config

    out = []
    for bsz in (16, 1):
        out += [(f"{name}_B{bsz}", b * h, tq, tk, d) for name, b, h, tq, tk,
                d, *_ in chip_smoke.attention_cases(Config(), bsz) if tq > 1]
    out += [(f"contentvec_T{t}", 12, t, t, 64) for t in (50, 400, 850, 3000)]
    out += [("f0_cross", 128, 448, 320, 32), ("registry_d128", 8, 400, 400,
                                              128)]
    return out


# (keys per tile, consumers, splits) where the planner's rule is worth
# reading twice: B=1's small grids keep one consumer and split over a
# cluster (a grid of 16 blocks or fewer one tile a split), the 56-row level
# keeps one consumer, two consumers take 32-key tiles at D = 48 and 64,
# ContentVec's 20 s keeps its 84 blocks, D = 128 takes 32-key tiles
F32_WGMMA_WANT = {
    "unet_self_L0_B16": (64, 2, 1), "unet_self_L2_B16": (32, 2, 1),
    "unet_cross_L3_B16": (64, 1, 1), "unet_self_L0_B1": (64, 1, 2),
    "unet_cross_L0_B1": (64, 1, 2), "unet_cross_L2_B1": (64, 1, 5),
    "unet_self_L3_B1": (64, 1, 1), "unet_cross_L3_B1": (64, 1, 5),
    "contentvec_T50": (64, 1, 1), "contentvec_T400": (64, 1, 1),
    "contentvec_T3000": (32, 2, 1), "f0_cross": (64, 2, 1),
    "registry_d128": (32, 1, 2)}


@pytest.mark.parametrize("name,bh,tq,tk,d", _f32_attention_geometries())
def test_f32_wgmma_planner(name, bh, tq, tk, d):
    """The f32 wgmma kernel's plan at every f32 geometry of the path: an
    instantiated (key tile, consumers) of its padded head dim, two
    consumers wherever the head is at most 64 wide and the queries fill
    more than one 64-row tile in 64 such blocks or more, a block's shared
    memory within the H100's 232,448 bytes, and where the blocks fall
    short of the 132 SMs the key tiles split over a cluster of at most 8
    that stays within one wave, two tiles or more a split unless the grid
    has 16 blocks or fewer, each split over the same number of tiles, none
    empty."""
    from ns2vc_tpu_torch.ops._build import H100_SMS
    from ns2vc_tpu_torch.ops.flash_attention import (
        F32_WGMMA_TILES, MAX_SMEM, f32_wgmma_dp, f32_wgmma_smem,
    )

    key_tile, consumers, splits = plan_f32_wgmma(bh, tq, tk, d)
    dp = f32_wgmma_dp(d)
    assert (key_tile, consumers) in F32_WGMMA_TILES[dp]
    assert consumers == (2 if dp <= 64 and tq > 64
                         and -(-tq // 128) * bh >= 64 else 1)
    assert f32_wgmma_smem(dp, key_tile, consumers) <= MAX_SMEM
    tiles = -(-tk // key_tile)
    blocks = -(-tq // (64 * consumers)) * bh
    per = -(-tiles // splits)
    assert 1 <= splits <= 8 and (splits - 1) * per < tiles <= splits * per
    assert blocks * splits <= max(blocks, H100_SMS)
    most = tiles if blocks <= 16 else max(1, tiles // 2)
    assert splits <= most
    if blocks < H100_SMS and splits < min(8, most):
        # one more split would leave an empty one or pass one wave
        more = -(-tiles // -(-tiles // (splits + 1)))
        assert more == splits or blocks * (splits + 1) > H100_SMS
    if name in F32_WGMMA_WANT:
        assert (key_tile, consumers, splits) == F32_WGMMA_WANT[name]


@pytest.mark.parametrize("dp,key_tile,consumers,want", [
    (16, 64, 1, 67328), (16, 64, 2, 75520), (32, 64, 1, 132864),
    (32, 64, 2, 149248), (64, 64, 1, 198144), (64, 32, 2, 181632),
    (128, 32, 1, 230656),
])
def test_f32_wgmma_shared_memory(dp, key_tile, consumers, want):
    """Each instantiation's shared memory, summed by hand from the
    kernel's layout (1024 bytes of alignment slack; per consumer Q's two
    planes of 64 x DP floats; the raw K and V slots of BN x DP; three
    stages where they fit, else two, of four BN x DP planes and BN floats
    of key bias), within a block's 232,448 bytes; every instantiation is
    listed."""
    from ns2vc_tpu_torch.ops.flash_attention import (
        F32_WGMMA_TILES, MAX_SMEM, f32_wgmma_smem,
    )

    assert (key_tile, consumers) in F32_WGMMA_TILES[dp]
    assert sum(map(len, F32_WGMMA_TILES.values())) == 7
    tile, stage = 4 * key_tile * dp, 4 * (4 * key_tile * dp + key_tile)
    fixed = 1024 + consumers * 2 * 4 * 64 * dp + 2 * tile
    stages = (want - fixed) // stage
    assert want == fixed + stages * stage and stages in (2, 3)
    assert f32_wgmma_smem(dp, key_tile, consumers) == want <= MAX_SMEM
    assert stages == 3 or want + stage > MAX_SMEM


@pytest.mark.parametrize("bsz", [16, 1])
def test_f32_attention_wrapper_follows_the_planner(card_routes, bsz):
    """The UNet's attentions in f32 (Svc's default dtype), laid out as the
    model lays them out, reach the f32 wgmma kernel's entry with the
    planner's key tile, consumers and splits and count as "f32tc"; the two
    pools (one query) reach the single-query kernel ("f32tc_q1"); the
    same head views one float longer per row (strides of no whole 16-byte
    chunks) reach the mma.sync kernel ("f32tc_narrow")."""
    from ns2vc_tpu_torch.ops.attention import split_heads

    heads = 8
    geos = _unet_attention_geometries()
    r0 = dict(flash_attention.route_launches)
    for pad in (0, 1):
        for i, (tq, tk, d) in enumerate(geos):
            c = heads * d
            if i % 2 == 0:
                qkv = torch.zeros(bsz, tq, 3 * c + pad)
                q, k, v = qkv[..., :3 * c].split(c, dim=-1)
                bias = None
            else:
                q = torch.zeros(bsz, tq, c + pad)[..., :c]
                k, v = (torch.zeros(bsz, tk, c + pad)[..., :c]
                        for _ in range(2))
                bias = torch.zeros(bsz, tk)
            flash_attention(*(split_heads(x, heads) for x in (q, k, v)),
                            bias)
    for d, h in ((100, 1), (4, 64)):     # the pools
        q = split_heads(torch.zeros(bsz, 1, h * d), h)
        kv = split_heads(torch.zeros(bsz, 321, h * d), h)
        flash_attention(q, kv, kv)
    n = len(geos)
    assert {key: flash_attention.route_launches[key] - r0[key]
            for key in r0} == {"f32tc": n, "f32tc_q1": 2, "f32tc_narrow": n,
                               "tc": 0, "tc_q1": 0, "tc_narrow": 0,
                               "plain": 0}
    names = [name for name, _ in card_routes.calls]
    assert names == (["ns2vc_flash_attention_f32_wgmma_fwd"] * n
                     + ["ns2vc_flash_attention_f32tc_fwd"] * n
                     + ["ns2vc_flash_attention_q1_fwd"] * 2)
    for (tq, tk, d), (_, args) in zip(geos, card_routes.calls):
        assert args[5:10] == (bsz, heads, tq, tk, d)
        assert args[23:] == (*plan_f32_wgmma(bsz * heads, tq, tk, d), 0)
    for (_, args) in card_routes.calls[n:2 * n]:
        assert args[23] == 0      # element loads


def test_f32_narrow_launches_count_and_replay():
    """The new counter key, "f32tc_narrow", resets with the others and
    travels through `launch_counts` / `add_launch_counts` (a replayed
    CUDA graph adds what its capture counted) and `backward_calls`."""
    from ns2vc_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    counts = fa.launch_counts()
    assert counts["route.f32tc_narrow"] == 0
    assert "f32tc_narrow" in fa.flash_attention.backward_calls
    delta = {k: 0 for k in counts}
    delta.update({"launches": 3, "route.f32tc_narrow": 1, "route.f32tc": 2})
    fa.add_launch_counts(delta, 2)
    assert fa.flash_attention.route_launches["f32tc_narrow"] == 2
    assert fa.flash_attention.route_launches["f32tc"] == 4
    assert fa.flash_attention.launches == 6
    fa.reset_launches()
    assert set(fa.launch_counts().values()) == {0}


@pytest.mark.parametrize("bsz,heads", [(16, 8), (1, 8), (2, 4)])
def test_attention_wrapper_follows_the_planner(card_routes, bsz, heads):
    """Every UNet attention of a step, laid out as the model lays it out
    (self: head views of one packed (B, T, 3C) projection; cross: of
    (B, T, C) projections, with the prompt's key padding), reaches the
    wgmma kernel's entry with the planner's key tile and counts as "tc";
    the two pooling attentions (one query, D = 100 and 4) reach the
    single-query kernel with `plan_q1`'s heads per block and key tile and
    the widest loads their rows allow, counted as "tc_q1"."""
    from ns2vc_tpu_torch.ops.flash_attention import plan_q1
    from ns2vc_tpu_torch.ops.attention import split_heads

    r0 = dict(flash_attention.route_launches)
    geos = _unet_attention_geometries()
    for i, (tq, tk, d) in enumerate(geos):
        c = heads * d
        if i % 2 == 0:
            q, k, v = torch.zeros(bsz, tq, 3 * c,
                                  dtype=torch.bfloat16).split(c, dim=-1)
            bias = None
        else:
            q = torch.zeros(bsz, tq, c, dtype=torch.bfloat16)
            k, v = (torch.zeros(bsz, tk, c, dtype=torch.bfloat16)
                    for _ in range(2))
            bias = torch.zeros(bsz, tk)
            bias[:, 272:] = -1e4
        flash_attention(*(split_heads(x, heads) for x in (q, k, v)), bias)
    pools = ((100, 1), (4, 64))          # ref_enc and add_embedding pools
    for d, h in pools:                   # head views of (B, T, C) projections
        q = split_heads(torch.zeros(bsz, 1, h * d, dtype=torch.bfloat16), h)
        kv = split_heads(torch.zeros(bsz, 321, h * d, dtype=torch.bfloat16),
                         h)
        flash_attention(q, kv, kv)
    assert {key: flash_attention.route_launches[key] - r0[key]
            for key in r0} == {"f32tc": 0, "f32tc_q1": 0, "f32tc_narrow": 0,
                               "tc": len(geos), "tc_q1": 2, "tc_narrow": 0,
                               "plain": 0}
    names = [name for name, _ in card_routes.calls]
    assert names == (["ns2vc_flash_attention_wgmma_fwd"] * len(geos)
                     + ["ns2vc_flash_attention_q1_fwd"] * 2)
    for (tq, tk, d), (_, args) in zip(geos, card_routes.calls):
        assert args[5:10] == (bsz, heads, tq, tk, d)
        assert args[23] == plan_wgmma_attention(bsz * heads, tq, tk, d)
    # the pools' rows: 200 bytes (8-byte loads), and 64 heads side by side
    # (a block's heads' 8-byte values in 16-byte loads where they pair up)
    for (d, h), (_, args) in zip(pools, card_routes.calls[len(geos):]):
        hg, tile, splits = plan_q1(bsz, h, 321, d, 2)
        vb = 16 if hg * d * 2 % 16 == 0 else 8
        assert args[5:10] == (bsz, h, 1, 321, d)
        assert args[23:28] == (hg, tile, splits, vb, 1)


def test_route_tables():
    from ns2vc_tpu_torch.ops.flash_attention import attention_route
    from ns2vc_tpu_torch.ops.fused_resnet import resnet_route

    # the route follows the dtype alone: bf16 -> the bf16 tensor-core
    # kernels, f32 (and any dtype the launch then refuses) -> 3xTF32
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for route in (attention_route, resnet_route):
            assert route("cpu", dtype) == "plain"
            assert route(torch.device("cuda", 0), dtype) == (
                "tc" if dtype == torch.bfloat16 else "f32tc")
    for route in (attention_route, resnet_route):
        with pytest.raises(ValueError, match="unsupported device"):
            route("meta", torch.bfloat16)


class _FakeLib:
    """Stands in for the kernel library: records each entry point's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def card_routes(monkeypatch):
    """The wrappers as they run for a CUDA tensor, on CPU tensors: the
    route tables answer as for 'cuda', the library is a recorder, and the
    plain versions raise if reached."""
    import ns2vc_tpu_torch.ops.flash_attention as fa
    import ns2vc_tpu_torch.ops.fused_resnet as fr

    lib = _FakeLib()
    a_route, r_route = fa.attention_route, fr.resnet_route
    monkeypatch.setattr(fa, "attention_route",
                        lambda dev, dt: a_route("cuda", dt))
    monkeypatch.setattr(fr, "resnet_route", lambda dev, dt: r_route("cuda", dt))
    monkeypatch.setattr(fr, "gn_route", lambda dev: "cuda")

    def reached(*a, **k):
        raise AssertionError("a card-routed call reached the plain version")
    monkeypatch.setattr(fa, "flash_attention_plain", reached)
    monkeypatch.setattr(fr, "affine_silu_conv1d_plain", reached)
    monkeypatch.setattr(fr, "group_norm_affine_plain", reached)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "require_current_device", lambda *t: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    return lib


@pytest.mark.parametrize("dtype,d,layout,route", [
    (torch.bfloat16, 32, "packed", "tc"),
    (torch.bfloat16, 48, "separate", "tc"),
    (torch.bfloat16, 100, "packed", "tc_narrow"),   # rows of 200 bytes
    (torch.bfloat16, 4, "separate", "tc_narrow"),
    (torch.bfloat16, 128, "separate", "tc"),        # the widest head
    (torch.float32, 64, "packed", "f32tc"),
    (torch.float32, 48, "separate", "f32tc"),       # a box wider than D
    (torch.float32, 100, "packed", "f32tc"),        # rows of 400 bytes
    (torch.float32, 6, "packed", "f32tc_narrow"),   # D % 4 != 0
    (torch.float32, 7, "separate", "f32tc_narrow"),
])
def test_attention_wrapper_routes_card_calls(card_routes, dtype, d, layout,
                                             route):
    from ns2vc_tpu_torch.ops.attention import split_heads

    b, h, t = 2, 2, 9
    c = h * d
    if layout == "packed":
        q, k, v = torch.zeros(b, t, 3 * c, dtype=dtype).split(c, dim=-1)
    else:
        q, k, v = (torch.zeros(b, t, c, dtype=dtype) for _ in range(3))
    q, k, v = (split_heads(x, h) for x in (q, k, v))
    n0, r0 = flash_attention.launches, dict(flash_attention.route_launches)
    out = flash_attention(q, k, v, torch.zeros(b, t))
    assert out.shape == (b, h, t, d) and out.dtype == dtype
    assert flash_attention.launches == n0 + 1
    assert {key: flash_attention.route_launches[key] - r0[key]
            for key in r0} == {key: int(key == route) for key in r0}
    (name, args), = card_routes.calls
    assert name == {"f32tc": "ns2vc_flash_attention_f32_wgmma_fwd",
                    "f32tc_narrow": "ns2vc_flash_attention_f32tc_fwd",
                    "tc": "ns2vc_flash_attention_wgmma_fwd",
                    "tc_narrow": "ns2vc_flash_attention_tc_fwd"}[route]
    assert args[5:10] == (b, h, t, t, d)
    if route == "tc":      # TMA tiles of the planner's key tile
        assert args[23:] == (plan_wgmma_attention(b * h, t, t, d), 0)
    elif route == "f32tc":  # TMA tiles: the planner's tile, consumers, splits
        assert args[23:] == (*plan_f32_wgmma(b * h, t, t, d), 0)
    else:                  # element loads
        assert args[23] == 0
    if route == "f32tc_narrow":   # one split of its one key tile
        assert args[24:28] == (1, 1, None, None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,d,layout", [
    (16, 1, 100, "pool"),      # ref_enc: rows of 100 values
    (16, 64, 4, "pool"),       # add_embedding: 64 heads side by side
    (2, 4, 64, "packed"),      # head views of one packed projection
    (3, 2, 4, "separate"),     # (B, H, T, D) tensors of their own
])
def test_single_query_calls_reach_the_q1_kernel(card_routes, dtype, b, h,
                                                d, layout):
    """A call of one query (Tq == 1) in either dtype reaches the
    single-query kernel's entry with `plan_q1`'s heads per block, key tile
    and key splits, the widest load the rows allow and the dtype flag, and
    counts as "tc_q1" (bf16) or "f32tc_q1" (f32)."""
    from ns2vc_tpu_torch.ops.attention import split_heads
    from ns2vc_tpu_torch.ops.flash_attention import plan_q1, q1_vec_bytes

    tk, c = 321, h * d
    if layout == "pool":
        q, k, v = (split_heads(torch.zeros(b, n, c, dtype=dtype), h)
                   for n in (1, tk, tk))
    elif layout == "packed":
        q = split_heads(torch.zeros(b, 1, c, dtype=dtype), h)
        k, v = (split_heads(x, h) for x in torch.zeros(
            b, tk, 3 * c, dtype=dtype).split(c, dim=-1)[1:])
    else:
        q, k, v = (torch.zeros(b, h, n, d, dtype=dtype) for n in (1, tk, tk))
    r0 = dict(flash_attention.route_launches)
    out = flash_attention(q, k, v, torch.zeros(b, tk))
    assert out.shape == (b, h, 1, d) and out.dtype == dtype
    route = "tc_q1" if dtype == torch.bfloat16 else "f32tc_q1"
    assert {key: flash_attention.route_launches[key] - r0[key]
            for key in r0} == {key: int(key == route) for key in r0}
    (name, args), = card_routes.calls
    assert name == "ns2vc_flash_attention_q1_fwd"
    assert args[5:10] == (b, h, 1, tk, d) and args[3] is not None
    hg, tile, splits = plan_q1(b, h, tk, d, q.element_size())
    assert args[23:28] == (hg, tile, splits, q1_vec_bytes(k, v, hg),
                           int(dtype == torch.bfloat16))
    # a head's row of 8 or 200 bytes alone: 8-byte loads; of 16, 128, 256
    # or 400 bytes, or 8 heads of 4 side by side (the pool at B=16): 16
    es = q.element_size()
    want_vb = 16 if d * es % 16 == 0 or (layout == "pool" and d == 4) else 8
    assert args[26] == want_vb


@pytest.mark.parametrize("b", [1, 2, 16])
@pytest.mark.parametrize("h,tk,d,es", [
    (1, 321, 100, 2), (64, 321, 4, 2), (1, 321, 100, 4), (64, 321, 4, 4),
    (8, 16384, 128, 4), (12, 33, 64, 2), (3, 9, 1, 2),
])
def test_single_query_planner(b, h, tk, d, es):
    """`plan_q1`: every key dealt to one of at most 8 non-empty splits of
    32 keys or more (fewer keys: one split), a block's row segment at most
    512 bytes, B x groups x splits within one wave of the H100 unless the
    keys or heads fill it alone, and the shared memory within a block's
    227 KB."""
    from ns2vc_tpu_torch.ops._build import H100_SMS
    from ns2vc_tpu_torch.ops.flash_attention import (
        MAX_SMEM, Q1_SEGMENT_BYTES, plan_q1, q1_smem,
    )

    hg, tile, splits = plan_q1(b, h, tk, d, es)
    kpb = -(-tk // splits)
    assert 1 <= splits <= 8 and (splits - 1) * kpb < tk <= splits * kpb
    assert splits == 1 or kpb >= 32
    assert 1 <= tile <= kpb and 1 <= hg <= h
    assert hg == 1 or hg * d * es <= Q1_SEGMENT_BYTES
    blocks = b * -(-h // hg)
    assert splits == 1 or blocks < H100_SMS
    assert blocks * splits < 2 * H100_SMS or splits == 1
    assert q1_smem(hg, d, kpb, tile, es) <= MAX_SMEM


@pytest.mark.parametrize("dtype,bsz,t,c,co", [
    (torch.bfloat16, 16, 448, 256, 128),   # enough tiles: no split
    (torch.bfloat16, 1, 56, 1024, 512),    # a cluster of 8 splits
    (torch.bfloat16, 2, 37, 20, 100),      # C % 8 != 0: element loads
    (torch.float32, 1, 56, 512, 512),      # a cluster of 8 splits
    (torch.float32, 16, 448, 128, 128),    # 224 tiles: no split
    (torch.float32, 2, 37, 22, 100),       # C % 4 != 0: element loads
])
def test_resnet_wrapper_routes_card_calls(card_routes, dtype, bsz, t, c, co):
    """The arguments each K2 entry point gets. bf16: the weights' TMA map
    is encoded once per packing (wgmma tiles: Co padded to 128, C to 64)
    and its address handed to every launch with `plan_wgmma`'s split; x,
    a, b 16-byte aligned take TMA ("tc"), else element loads ("tc_elem").
    f32 likewise: the planes' map (Co padded to 128, C to 16, both
    planes' three taps as rows) and `plan_tc`'s split; x, a, b 16-byte
    aligned take TMA ("f32tc"), else element loads ("f32tc_elem")."""
    from ns2vc_tpu_torch.ops.fused_resnet import (
        F32_BN, TC_BN, chunk_width, pack_conv_weight, plan_tc, plan_wgmma,
    )

    x = torch.zeros(bsz, t, c, dtype=dtype)
    a = torch.ones(bsz, c)
    w, bias = torch.randn(co, c, 3).to(dtype), torch.zeros(co, dtype=dtype)
    r0 = dict(affine_silu_conv1d.route_launches)
    y = affine_silu_conv1d(x, a, a, w, bias)
    assert y.shape == (bsz, t, co) and y.dtype == dtype
    aligned = c % (16 // x.element_size()) == 0   # 16-byte rows of x
    bk = chunk_width(dtype)
    cp = -(-c // bk) * bk
    if dtype == torch.bfloat16:
        sub = "tc" if aligned else "tc_elem"
        assert {k: affine_silu_conv1d.route_launches[k] - r0[k]
                for k in r0} == {k: int(k == sub) for k in r0}
        (enc, enc_args), (name, args) = card_routes.calls
        cop = -(-co // TC_BN) * TC_BN
        splits, cps = plan_wgmma(bsz, t, c, co)
        assert enc == "ns2vc_encode_weight_map"
        assert enc_args[1:3] == (3 * cop, cp) and enc_args[3] == args[3]
        assert name == "ns2vc_affine_silu_conv1d_tc"
        assert args[6:] == (bsz, t, c, co, cop, cps, splits, int(aligned), 0)
        # the packed weights and their map are made once per weight tensor
        affine_silu_conv1d(x, a, a, w, bias)
        assert len(card_routes.calls) == 3
        assert card_routes.calls[2][1][3] == args[3]
    else:
        sub = "f32tc" if aligned else "f32tc_elem"
        assert {k: affine_silu_conv1d.route_launches[k] - r0[k]
                for k in r0} == {k: int(k == sub) for k in r0}
        (enc, enc_args), (name, args) = card_routes.calls
        splits, cps = plan_tc(bsz, t, c, co)
        cop = -(-co // F32_BN) * F32_BN
        assert enc == "ns2vc_encode_weight_map_f32"
        assert enc_args[1:3] == (2 * 3 * cop, cp) and enc_args[3] == args[3]
        assert name == "ns2vc_affine_silu_conv1d_f32tc"
        assert args[6:] == (bsz, t, c, co, cop, cps, splits, int(aligned), 0)
        # the packed weights and their map are made once per weight tensor
        affine_silu_conv1d(x, a, a, w, bias)
        assert len(card_routes.calls) == 3
        assert card_routes.calls[2][1][3] == args[3]
    assert pack_conv_weight(w).shape[-2:] == (cop, cp)


@pytest.mark.parametrize("xdt,pdt,bsz,t,c,film,vec", [
    (torch.bfloat16, torch.bfloat16, 16, 448, 128, "chunk", 1),  # serving
    (torch.float32, torch.float32, 1, 56, 1024, None, 1),        # f32 Svc
    (torch.bfloat16, torch.float32, 2, 37, 16, "whole", 0),      # C / G = 2
    (torch.float32, "mixed", 3, 5, 64, "chunk", 1),               # cast to f32
])
def test_group_norm_affine_routes_card_calls(card_routes, xdt, pdt, bsz, t,
                                             c, film, vec):
    """The statistics kernel's arguments: x's and the parameters' dtypes,
    FiLM rows (a chunk of one projection keeps its row stride), the
    16-byte loads when a group's channels come in whole vectors, and
    `gn_splits`'s blocks per slab; gamma, beta and FiLM of mixed dtypes
    go as f32."""
    from ns2vc_tpu_torch.ops.fused_resnet import gn_splits, group_norm_affine

    x = torch.zeros(bsz, t, c, dtype=xdt)
    gamma, beta = (torch.ones(c, dtype=torch.float32 if pdt == "mixed"
                              else pdt) for _ in range(2))
    s = sh = None
    if film is not None:
        fdt = torch.bfloat16 if pdt == "mixed" else pdt
        proj = torch.zeros(bsz, 2 * c, dtype=fdt)
        s, sh = (proj.chunk(2, dim=-1) if film == "chunk"
                 else (proj[:, :c].contiguous(), proj[:, c:].contiguous()))
    n0 = group_norm_affine.launches
    a, b = group_norm_affine(x, gamma, beta, 8, 1e-5, s, sh)
    assert group_norm_affine.launches == n0 + 1
    assert a.shape == b.shape == (bsz, c) and a.dtype == b.dtype == \
        torch.float32
    (name, args), = card_routes.calls
    assert name == "ns2vc_group_norm_affine"
    assert (args[3] is None) == (film is None) == (args[4] is None)
    stride = {None: 0, "chunk": 2 * c, "whole": c}[film]
    if pdt == "mixed":
        stride = c      # the f32 copies are contiguous
    p_bf16 = int(pdt == torch.bfloat16)
    assert args[5] == stride and args[6:8] == (a.data_ptr(), b.data_ptr())
    assert args[8:12] == (bsz, t, c, 8) and args[12] == pytest.approx(1e-5)
    width = 16 // x.element_size() if vec else 1
    assert args[13:] == (gn_splits(t, c, 8, width),
                         int(xdt == torch.bfloat16), p_bf16, vec, 0)


def test_statistics_count_while_their_name_is_wrapped(card_routes,
                                                      monkeypatch):
    """A wrapper around the module's `group_norm_affine` (as a profiler's
    range puts one there) leaves the launch counted on the function."""
    import ns2vc_tpu_torch.ops.fused_resnet as fr

    counted = fr.group_norm_affine
    monkeypatch.setattr(fr, "group_norm_affine",
                        lambda *a, **k: counted(*a, **k))
    n0 = counted.launches
    x = torch.zeros(2, 9, 64, dtype=torch.bfloat16)
    w, bias = torch.randn(64, 64, 3).bfloat16(), torch.zeros(64).bfloat16()
    gn_silu_conv1d(x, torch.ones(64), torch.zeros(64), w, bias)
    assert counted.launches == n0 + 1
    assert [name for name, _ in card_routes.calls][0] == \
        "ns2vc_group_norm_affine"


def test_gn_silu_conv1d_feeds_the_statistics_to_the_conv(card_routes):
    """gn_silu_conv1d on a card: one statistics launch, then the bf16 conv
    on the a, b it wrote."""
    bsz, t, c, co = 16, 56, 512, 512
    x = torch.zeros(bsz, t, c, dtype=torch.bfloat16)
    gamma, beta = torch.ones(c), torch.zeros(c)
    w, bias = torch.randn(co, c, 3).bfloat16(), torch.zeros(co).bfloat16()
    s, sh = torch.zeros(bsz, 2 * c).bfloat16().chunk(2, dim=-1)
    gn_silu_conv1d(x, gamma, beta, w, bias, 8, 1e-5, s, sh)
    names = [name for name, _ in card_routes.calls]
    assert names == ["ns2vc_group_norm_affine", "ns2vc_encode_weight_map",
                     "ns2vc_affine_silu_conv1d_tc"]
    stats, conv = card_routes.calls[0][1], card_routes.calls[2][1]
    assert conv[1:3] == stats[6:8]     # a, b
    assert conv[11:13] == (4, 2)       # plan_wgmma: 64 tiles, 2 splits


# -- K1 and K2 under autograd -------------------------------------------------
#
# The backward of each kernel is written out in torch ops
# (`flash_attention_backward`; for K2 `affine_silu_conv1d_backward`, the
# plain version of its backward kernels) and reached through an autograd
# Function whose forward is the kernel's launch. Here each launch, the
# backward kernels' too, is replaced by its plain version on the CPU
# (`kernels_on_cpu`), so the Functions, their saved tensors and their
# backward run as on a card.
# Tolerances: 1e-5 in f32, 1e-6 in f64, against torch.autograd through the
# plain versions; gradcheck in f64.

GRAD_ATOL = {torch.float32: 1e-5, torch.float64: 1e-6}


@contextlib.contextmanager
def kernels_on_cpu():
    """The wrappers as they run for CUDA tensors, with each kernel's launch
    replaced by its plain version (counted as a 'tc' launch)."""
    import ns2vc_tpu_torch.ops.flash_attention as fa
    import ns2vc_tpu_torch.ops.fused_resnet as fr

    def a_launch(q, k, v, bias, scale):
        fa.flash_attention.launches += 1
        fa.flash_attention.route_launches["tc"] += 1
        return fa.flash_attention_plain(q, k, v, bias, scale), "tc"

    def r_launch(x, a, b, w, bias):
        fr.affine_silu_conv1d.launches += 1
        fr.affine_silu_conv1d.route_launches["tc"] += 1
        return fr.affine_silu_conv1d_plain(x, a, b, w, bias), "tc"

    def g_launch(x, a, b, w, bias, dy, keep_f32=False):
        fr.affine_silu_conv1d_grad.launches += 1
        fr.affine_silu_conv1d_grad.route_launches["bf16"] += 1
        return fr.affine_silu_conv1d_backward(x, a, b, w, bias, dy)
    with mock.patch.object(fa, "attention_route", lambda *a: "tc"), \
            mock.patch.object(fa, "_launch", a_launch), \
            mock.patch.object(fr, "resnet_route", lambda *a: "tc"), \
            mock.patch.object(fr, "_launch", r_launch), \
            mock.patch.object(fr, "_grad_launch", g_launch):
        yield


def _grads(fn, inputs, dout):
    inputs = [x.detach().requires_grad_() for x in inputs]
    out = fn(*inputs)
    out.backward(dout)
    return out.detach(), [x.grad for x in inputs]


def _heads(r, b, h, tq, tk, d, dtype):
    """q, k, v as split_heads views: q/k/v of one packed (B, T, 3C)
    projection for self-attention, separate projections otherwise."""
    from ns2vc_tpu_torch.ops.attention import split_heads

    c = h * d
    if tq == tk:
        qkv = torch.from_numpy(r.standard_normal((b, tq, 3 * c))).to(dtype)
        return [split_heads(x, h) for x in qkv.split(c, dim=-1)]
    return [split_heads(torch.from_numpy(r.standard_normal((b, t, c)))
                        .to(dtype), h) for t in (tq, tk, tk)]


ATTN_GRAD_CASES = [
    (2, 4, 37, 37, 16, [37, 0]),     # self; batch row 1 fully masked
    (2, 2, 9, 13, 8, [13, 5]),       # cross with key padding
    (2, 1, 1, 17, 100, None),        # pooling: Tq = 1, D = 100
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,h,tq,tk,d,lengths", ATTN_GRAD_CASES)
def test_flash_attention_backward_matches_autograd(dtype, b, h, tq, tk, d,
                                                   lengths):
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention_backward

    r = np.random.default_rng(11)
    q, k, v = _heads(r, b, h, tq, tk, d, dtype)
    bias = None
    if lengths is not None:
        keep = torch.arange(tk)[None, :] < torch.tensor(lengths)[:, None]
        bias = (1.0 - keep.float()) * -1e4
    scale = d ** -0.5
    # dO laid out (B, Tq, H, D): a non-contiguous (B, H, Tq, D) view
    do = torch.from_numpy(r.standard_normal((b, tq, h, d))).to(dtype) \
        .transpose(1, 2)
    o, want = _grads(lambda q_, k_, v_: flash_attention_plain(
        q_, k_, v_, bias, scale), (q, k, v), do)
    got = flash_attention_backward(q, k, v, bias, scale, do)
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=GRAD_ATOL[dtype], err_msg=f"d{name}")
    # through the autograd Function, from (B, T, C) projections and back
    with kernels_on_cpu():
        calls = dict(flash_attention.backward_calls)
        _, fn = _grads(lambda q_, k_, v_: flash_attention(q_, k_, v_, bias,
                                                          scale), (q, k, v),
                       do)
        assert flash_attention.backward_calls["tc"] == calls["tc"] + 1
    for name, g, w in zip("qkv", fn, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=GRAD_ATOL[dtype], err_msg=f"d{name}")


def test_flash_attention_backward_keeps_dq_with_a_shared_key_component():
    """bf16 keys and values that share a component (as projections of
    normalised features do): dq stays within bf16 rounding of the f64
    gradient. A dS whose rows are corrected by rowsum(dO * O) with O
    rounded to bf16 loses dq here (cosine 0.62)."""
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention_backward

    r = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(0.3 * r.standard_normal((2, 4, 64, 16))
                                + off).bfloat16()
               for off in (0.0, 3.0, 3.0))
    do = torch.from_numpy(r.standard_normal((2, 4, 64, 16))).bfloat16()
    want = _grads(lambda q_, k_, v_: flash_attention_plain(q_, k_, v_),
                  [x.double() for x in (q, k, v)], do.double())[1][0]
    dq = flash_attention_backward(q, k, v, None, 0.25, do)[0].double()
    cos = (dq.flatten() @ want.flatten()) / (dq.norm() * want.norm())
    assert cos.item() > 0.9999


def test_flash_attention_function_gradcheck():
    r = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(r.standard_normal((2, 2, t, 4)))
               .requires_grad_() for t in (5, 7, 7))
    bias = torch.zeros(2, 7, dtype=torch.float64)
    bias[0, 4:] = -1e4
    bias[1] = -1e4                 # a fully masked row
    with kernels_on_cpu():
        assert torch.autograd.gradcheck(
            lambda q_, k_, v_: flash_attention(q_, k_, v_, bias),
            (q, k, v), eps=1e-6, atol=1e-6)


def test_serving_calls_launch_directly():
    """Without grad, or with no input requiring it, the wrapper launches
    directly: no graph, no backward."""
    r = np.random.default_rng(13)
    q, k, v = _heads(r, 1, 2, 6, 6, 4, torch.float32)
    with kernels_on_cpu():
        assert flash_attention(q, k, v).grad_fn is None
        q.requires_grad_()
        with torch.no_grad():
            assert flash_attention(q, k, v).grad_fn is None
        assert flash_attention(q, k, v).grad_fn is not None


def _k2_inputs(r, dtype, b=2, t=11, c=16, co=5):
    x = torch.from_numpy(r.standard_normal((b, t, c))).to(dtype)
    a = torch.from_numpy(1 + 0.3 * r.standard_normal((b, c))).to(dtype)
    b_ = torch.from_numpy(0.3 * r.standard_normal((b, c))).to(dtype)
    w = torch.from_numpy(r.standard_normal((co, c, 3)) / 7).to(dtype)
    bias = torch.from_numpy(0.1 * r.standard_normal(co)).to(dtype)
    return x, a, b_, w, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_affine_silu_conv1d_backward_matches_autograd(dtype):
    from ns2vc_tpu_torch.ops.fused_resnet import affine_silu_conv1d_backward

    r = np.random.default_rng(14)
    inputs = _k2_inputs(r, dtype)
    # dy laid out (Co, B, T): non-contiguous as (B, T, Co)
    dy = torch.from_numpy(r.standard_normal((5, 2, 11))).to(dtype) \
        .permute(1, 2, 0)
    _, want = _grads(affine_silu_conv1d_plain, inputs, dy)
    got = affine_silu_conv1d_backward(*inputs, dy)
    for name, g, w in zip(("x", "a", "b", "w", "bias"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=GRAD_ATOL[dtype], err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gn_silu_conv1d_with_film_grads_through_the_function(dtype):
    """GroupNorm + FiLM (torch ops) -> K2's Function: every input's
    gradient equals autograd through the plain version."""
    r = np.random.default_rng(15)
    b, t, c, co = 2, 9, 16, 8
    x = torch.from_numpy(r.standard_normal((b, t, c))).to(dtype)
    gamma = torch.from_numpy(1 + 0.1 * r.standard_normal(c)).to(dtype)
    beta = torch.from_numpy(0.1 * r.standard_normal(c)).to(dtype)
    w = torch.from_numpy(r.standard_normal((co, c, 3)) / 7).to(dtype)
    bias = torch.from_numpy(0.1 * r.standard_normal(co)).to(dtype)
    scale = torch.from_numpy(0.2 * r.standard_normal((b, c))).to(dtype)
    shift = torch.from_numpy(0.2 * r.standard_normal((b, c))).to(dtype)
    dy = torch.from_numpy(r.standard_normal((b, t, co))).to(dtype)

    def fn(x_, g_, be_, w_, bi_, s_, sh_):
        return gn_silu_conv1d(x_, g_, be_, w_, bi_, 8, 1e-5, film_scale=s_,
                              film_shift=sh_)
    args = (x, gamma, beta, w, bias, scale, shift)
    _, want = _grads(fn, args, dy)
    with kernels_on_cpu():
        calls = dict(affine_silu_conv1d.backward_calls)
        _, got = _grads(fn, args, dy)
        assert affine_silu_conv1d.backward_calls["tc"] == calls["tc"] + 1
    # f32: GroupNorm's statistics are taken in f32 on both sides
    for name, g, w_ in zip(("x", "gamma", "beta", "w", "bias", "scale",
                            "shift"), got, want):
        np.testing.assert_allclose(g.numpy(), w_.numpy(),
                                   atol=GRAD_ATOL[dtype], err_msg=f"d{name}")


def test_affine_silu_conv1d_function_gradcheck():
    r = np.random.default_rng(16)
    inputs = [t.requires_grad_() for t in _k2_inputs(r, torch.float64, b=2,
                                                     t=5, c=6, co=3)]
    with kernels_on_cpu():
        assert torch.autograd.gradcheck(affine_silu_conv1d, inputs, eps=1e-6,
                                        atol=1e-6)
