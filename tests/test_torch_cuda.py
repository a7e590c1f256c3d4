"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: without a CUDA device every test here skips (the kernels
have no CPU mode). This file imports no JAX, so it also runs where JAX is
not installed; the repository's conftest imports JAX, hence on such a
machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

f32 runs with TF32 off. Tolerances: K1 2e-5 in f32 (the JAX suite's bound
for the Pallas kernel); K2 3e-5 in f32 (the JAX suite's bound; sums of up
to 3*1024 O(1) products in another order, each product within ~2^-21 of
f32's through 3xTF32); in bf16, 3e-2 for K1 (the plain version rounds
the probabilities to bf16 before the PV product, the kernel keeps f32) and
1e-2 of the output's scale for K2 (one bf16 rounding of f32 sums taken in
another order); UNet card vs CPU 5e-4 (the JAX suite's UNet bound).
K1 also runs at ContentVec's shapes, (1, 12, T, 64) in f32 with T up to
3000 keys (one unbroken 60 s segment), at the F0 predictor's cross-attention
(B=16, 8 heads of 32, 448 queries over a 320-key prompt), at the op
registry's D = 128, and with q in f32 and k, v in bf16 (the F0 predictor
under a bf16 model). K2 also runs at the local output widths of a conv
split over the 'model' axis (Co = C_out / mp: 128, 192, 256 at mp=2, 64 and
96 at mp=4) on a block of the whole conv's weight. `multihead_attention` sends key-padding calls at
D <= 128 to the kernel and full-bias or D > 128 calls to the plain route,
counted as such. bf16 goes to the bf16 tensor-core kernels (K1 "tc", the
wgmma kernel, at every head width up to 128 and both key tiles, and
"tc_narrow"; K2 "tc"), f32 to the 3xTF32 ones (K1 "f32tc", the wgmma
kernel, at every head width and instantiated key tile and consumer count,
whole and split over a cluster, bitwise repeatable, and "f32tc_narrow",
the mma.sync kernel, for rows TMA cannot take; K2 "f32tc"); K1 calls of one
query, in either dtype, to the single-query kernel ("tc_q1", "f32tc_q1":
the pools, odd key counts, fully masked rows, D of 1 to 128); each test
checks the route its call took. K2's backward kernels
(`affine_silu_conv1d_grad`) are held against the plain backward in both
dtypes (3e-5 of max|plain| per gradient, the bf16 kernels' f32 sums before
their rounding, and the rounded outputs within half a bf16 ulp of them),
odd T, C not a multiple of 16 and Co of the output tail included, two
launches bitwise equal; under autograd K2's backward takes them and never
cuDNN. K2's f32 kernel is also held to give
bitwise-equal outputs on two launches, split over a cluster at B = 1 and
2, and with element loads at C % 4 != 0. The Svc
readback test checks that
batch N's `finish()` waits on its own CUDA event only: it returns while
batch N+1, whose device work ends in a spin kernel, is still running.
The serving programs: a replay (and a key's first call) against the eager
body at the same seed, bit for bit, with the launches a replay counts;
two dispatches of one key in flight; a capture while another thread
waits on events; a capture that fails raises and caches nothing. The
Trainer's step and eval programs, under the process's default flags:
replays against the eager step and eval, bit for bit (with and without
the F0 predictor, two geometries in
turns on one pool), a failed capture, the capturable AdamW against the
eager one (1e-6), checkpoints between the card and the CPU. In a process
group of one process over NCCL the step program (its all-reduce inside
the graph) replays the eager group step bit for bit and counts an eager
step's collectives, and the eval program replays the eager eval; over
gloo the step stays eager and the eval is a program.
"""

import os

import pytest
import torch

from ns2vc_tpu_torch.ops.attention import split_heads
from ns2vc_tpu_torch.ops import _build
from ns2vc_tpu_torch.ops.flash_attention import (
    attention_route, flash_attention, flash_attention_plain,
)
from ns2vc_tpu_torch.ops.fused_resnet import (
    affine_silu_conv1d, affine_silu_conv1d_grad, affine_silu_conv1d_plain,
    chunk_width, gn_silu_conv1d, group_norm_affine, group_norm_affine_plain,
    plan_tc, plan_wgmma, tile_width,
)

pytestmark = pytest.mark.cuda

MASKED_F32_ATOL = 2e-3   # of max|v|: f32 logits near -1e4 carry steps of 2^-10


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _k1_route(q, k, v):
    """The route counter a K1 call on these inputs moves, as the wrapper
    picks it: one query takes the single-query kernel ("tc_q1", f32
    "f32tc_q1"); rows of aligned 16-byte chunks take the wgmma kernel of
    their dtype ("tc", "f32tc"), other rows the mma.sync kernel of their
    dtype with element loads ("tc_narrow", "f32tc_narrow")."""
    route = attention_route(q.device, q.dtype)
    if q.shape[2] == 1:
        return route + "_q1"
    if not all(_build.aligned16(t) for t in (q, k, v)):
        return route + "_narrow"
    return route


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,tq,tk,d,valid", [
    (2, 8, 200, 200, 16, None),    # UNet self-attention, level 0 width
    (2, 8, 56, 160, 48, 100),      # cross-attention with key padding
    (3, 1, 1, 161, 100, None),     # ref_enc pooling
    (2, 64, 1, 161, 4, None),      # add_embedding pooling
    (1, 2, 130, 65, 128, 64),      # widest head dim, ragged tiles
    (16, 8, 448, 320, 32, 272),    # F0 predictor cross-attention, B=16
    (4, 2, 400, 400, 128, 300),    # op registry ids 14/15 at C = 256
])
def test_flash_attention_matches_plain(dev, dtype, atol, b, h, tq, tk, d,
                                       valid):
    g = _gen(dev)
    c = h * d
    # q/k/v as strided head views of one packed projection, as on the path
    qkv = torch.randn(b, max(tq, tk), 3 * c, generator=g, device=dev)
    q, k, v = qkv.to(dtype).split(c, dim=-1)
    q, k, v = (split_heads(x[:, :n], h) for x, n in ((q, tq), (k, tk),
                                                     (v, tk)))
    bias = None
    if valid is not None:
        bias = torch.zeros(b, tk, device=dev)
        bias[-1, valid:] = -1e4
    n0 = flash_attention.launches
    routes0 = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, bias)
    assert flash_attention.launches == n0 + 1
    route = _k1_route(q, k, v)
    assert flash_attention.route_launches[route] == routes0[route] + 1
    want = flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.parametrize("t", [50, 400, 850, 3000])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_at_contentvec_shapes(dev, t, masked):
    """ContentVec's self-attention: 12 heads of width 64, f32, q/k/v as
    head views of three (1, T, 768) projections (at T = 400 the kernel
    splits its key tiles over three blocks per query tile)."""
    g = _gen(dev, 3)
    q, k, v = (split_heads(torch.randn(1, t, 768, generator=g, device=dev),
                           12) for _ in range(3))
    bias = None
    if masked:
        bias = torch.zeros(1, t, device=dev)
        bias[:, t - t // 5:] = -1e4
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, bias)
    assert flash_attention.launches == n0 + 1
    want = flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fully_masked_row_is_finite(dev, dtype):
    g = _gen(dev, 1)
    q = torch.randn(2, 2, 40, 32, generator=g, device=dev).to(dtype)
    bias = torch.zeros(2, 70, device=dev)
    bias[1] = -1e30
    out = flash_attention(q, q[:, :, :1].expand(2, 2, 70, 32).contiguous(),
                          q[:, :, :1].expand(2, 2, 70, 32).contiguous(), bias)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4, 7, 16, 32, 48, 64, 100, 128])
@pytest.mark.parametrize("b,h,tq,tk,valid", [
    (2, 8, 1, 1, None),        # T = 1
    (2, 4, 77, 130, 101),      # ragged tiles on both axes, key padding
    (1, 2, 64, 64, 0),         # every key of the last row masked (-1e4)
])
def test_flash_attention_tc_head_widths(dev, dtype, d, b, h, tq, tk, valid):
    """Both kernels at every head width the path gives them and at an odd
    one (bf16 D = 4, 7 and 100 and f32 D = 7 take element loads) on
    strided views of one packed (B, T, 3C) projection, against the plain
    version. A batch item whose keys are all masked is ill-conditioned in
    f32 itself: its logits sit near -1e4, where f32's step is 2^-10, so
    the kernel's and the plain version's roundings of them differ by that
    much and its probabilities are known to ~1e-3: its rows are held to
    MASKED_F32_ATOL of max|v| in f32."""
    g = _gen(dev, 4)
    c = h * d
    qkv = torch.randn(b, max(tq, tk), 3 * c, generator=g,
                      device=dev).to(dtype)
    q, k, v = qkv.split(c, dim=-1)
    q, k, v = (split_heads(x[:, :n], h) for x, n in ((q, tq), (k, tk),
                                                     (v, tk)))
    bias = None
    if valid is not None:
        bias = torch.zeros(b, tk, device=dev)
        bias[-1, valid:] = -1e4
    route = _k1_route(q, k, v)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    n0 = flash_attention.route_launches[route]
    got = flash_attention(q, k, v, bias)
    assert flash_attention.route_launches[route] == n0 + 1
    want = flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    if valid == 0 and dtype == torch.float32:   # the last item: all masked
        assert err[-1].max().item() <= MASKED_F32_ATOL * v.abs().max().item()
        err = err[:-1]
    assert err.numel() == 0 or err.max().item() <= tol


def test_flash_attention_mixed_dtypes(dev):
    """q in f32 with k and v in bf16: the f32 kernel on the exactly upcast
    k, v, the output in bf16, against the plain version (which rounds the
    probabilities to bf16: 3e-2 as the bf16 bound); under autograd, k and
    v get bf16 gradients."""
    g = _gen(dev, 6)
    q = split_heads(torch.randn(4, 96, 256, generator=g, device=dev), 8)
    k, v = (split_heads(torch.randn(4, 80, 256, generator=g,
                                    device=dev).bfloat16(), 8)
            for _ in range(2))
    bias = torch.zeros(4, 80, device=dev)
    bias[1:, 60:] = -1e4
    n0 = flash_attention.route_launches["f32tc"]
    got = flash_attention(q, k, v, bias)
    assert flash_attention.route_launches["f32tc"] == n0 + 1
    want = flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 3e-2
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    flash_attention(qg, kg, vg, bias).float().sum().backward()
    assert (qg.grad.dtype, kg.grad.dtype, vg.grad.dtype) == (
        torch.float32, torch.bfloat16, torch.bfloat16)


def test_flash_attention_refuses_what_it_cannot_take(dev):
    x = torch.zeros(1, 1, 4, 129, device=dev)
    with pytest.raises(ValueError, match="unsupported shape"):
        flash_attention(x, x, x)
    h = torch.zeros(1, 1, 4, 8, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(h, h, h)
    y = torch.zeros(1, 1, 8, 4, device=dev).transpose(-1, -2)
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention(y, y, y)


@pytest.mark.parametrize("d,key_tile", [
    (d, kt) for d in (8, 16, 24, 32, 48, 64, 112, 128)
    for kt in ((64, 128) if d <= 64 else (64,))])
@pytest.mark.parametrize("layout,b,h,tq,tk,valid", [
    ("self", 2, 8, 57, 57, None),       # one partial key tile, no bias
    ("self", 2, 4, 272, 272, None),     # H = 4 (the 'model' axis)
    ("cross", 2, 8, 112, 321, 272),     # the prompt bucket, masked tail
    ("cross", 1, 4, 448, 448, 300),
    ("self", 3, 4, 130, 130, 100),      # ragged q tiles, key padding
])
def test_wgmma_attention_matches_plain(dev, monkeypatch, key_tile, d,
                                       layout, b, h, tq, tk, valid):
    """The wgmma kernel at every head width it takes (D = 48 and the
    others between 16, 32, 64 and 128 through a box wider than the head),
    each key tile it has there (128 up to D = 64), on strided views of one
    packed (B, T, 3C) projection (self) or of (B, T, C) projections
    (cross), against the plain version; two launches are bitwise equal."""
    import ns2vc_tpu_torch.ops.flash_attention as fa

    monkeypatch.setattr(fa, "plan_wgmma_attention", lambda *a: key_tile)
    g = _gen(dev, 10)
    c = h * d
    if layout == "self":
        q, k, v = torch.randn(b, tq, 3 * c, generator=g,
                              device=dev).bfloat16().split(c, dim=-1)
    else:
        q = torch.randn(b, tq, c, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(b, tk, c, generator=g, device=dev).bfloat16()
                for _ in range(2))
    q, k, v = (split_heads(x, h) for x in (q, k, v))
    bias = None
    if valid is not None:
        bias = torch.zeros(b, tk, device=dev)
        bias[-1, valid:] = -1e4
    n0 = flash_attention.route_launches["tc"]
    got = flash_attention(q, k, v, bias)
    again = flash_attention(q, k, v, bias)
    assert flash_attention.route_launches["tc"] == n0 + 2
    want = flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got.float() - want.float()).abs().max().item() <= 3e-2


@pytest.mark.parametrize("fill", [-1e4, -1e30])
@pytest.mark.parametrize("d", [16, 48, 64])
def test_wgmma_attention_fully_masked_rows(dev, fill, d):
    """A batch row whose keys are all masked stays finite on the wgmma
    kernel and, as the plain version, averages v uniformly."""
    g = _gen(dev, 11)
    q, k, v = (torch.randn(2, 4, t, d, generator=g, device=dev).bfloat16()
               for t in (37, 150, 150))
    bias = torch.zeros(2, 150, device=dev)
    bias[1] = fill
    n0 = flash_attention.route_launches["tc"]
    got = flash_attention(q, k, v, bias)
    assert flash_attention.route_launches["tc"] == n0 + 1
    want = flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 3e-2


def _f32_wgmma_plans():
    """(D, keys per tile, consumers) of every instantiation of the f32
    wgmma kernel, at each padded head dim and at D = 48 and 100 (a box
    wider than the head)."""
    from ns2vc_tpu_torch.ops.flash_attention import (
        F32_WGMMA_TILES, f32_wgmma_dp,
    )

    return [(d, kt, nc) for d in (16, 32, 48, 64, 100, 128)
            for kt, nc in F32_WGMMA_TILES[f32_wgmma_dp(d)]]


@pytest.mark.parametrize("d,key_tile,consumers", _f32_wgmma_plans())
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("layout,valid", [("self", None), ("cross", 200)])
def test_f32_wgmma_attention_matches_plain(dev, monkeypatch, d, key_tile,
                                           consumers, splits, layout,
                                           valid):
    """The f32 wgmma kernel with each key tile and consumer count it has,
    whole or with its key tiles split over a cluster of 3, on strided
    views of one packed (B, T, 3C) projection (self, no bias) or of
    (B, T, C) projections with a key padding (cross), ragged on both axes,
    against the plain version at 2e-5; two launches are bitwise equal."""
    import ns2vc_tpu_torch.ops.flash_attention as fa

    monkeypatch.setattr(fa, "plan_f32_wgmma",
                        lambda *a: (key_tile, consumers, splits))
    g = _gen(dev, 12)
    b, h, tq, tk = 2, 3, 150, 333
    c = h * d
    if layout == "self":
        qkv = torch.randn(b, tk, 3 * c, generator=g, device=dev)
        q, k, v = qkv.split(c, dim=-1)
        q = q[:, :tq]
    else:
        q = torch.randn(b, tq, c, generator=g, device=dev)
        k, v = (torch.randn(b, tk, c, generator=g, device=dev)
                for _ in range(2))
    q, k, v = (split_heads(x, h) for x in (q, k, v))
    bias = None
    if valid is not None:
        bias = torch.zeros(b, tk, device=dev)
        bias[-1, valid:] = -1e4
    n0 = flash_attention.route_launches["f32tc"]
    got = flash_attention(q, k, v, bias)
    again = flash_attention(q, k, v, bias)
    assert flash_attention.route_launches["f32tc"] == n0 + 2
    want = flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.parametrize("fill", [-1e4, -1e30])
@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_f32_wgmma_fully_masked_rows(dev, monkeypatch, fill, splits, d):
    """A batch row whose keys are all masked stays finite on the f32 wgmma
    kernel, whole or split, and (at -1e30, exact in f32 as the plain
    version's) averages v uniformly."""
    import ns2vc_tpu_torch.ops.flash_attention as fa

    plan = fa.plan_f32_wgmma(8, 37, 150, d)
    monkeypatch.setattr(fa, "plan_f32_wgmma",
                        lambda *a: (plan[0], plan[1], splits))
    g = _gen(dev, 13)
    q, k, v = (torch.randn(2, 4, t, d, generator=g, device=dev)
               for t in (37, 150, 150))
    bias = torch.zeros(2, 150, device=dev)
    bias[1] = fill
    n0 = flash_attention.route_launches["f32tc"]
    got = flash_attention(q, k, v, bias)
    assert flash_attention.route_launches["f32tc"] == n0 + 1
    want = flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    tol = 2e-5 if fill == -1e30 else MASKED_F32_ATOL * v.abs().max().item()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("d,pad", [(6, 0), (7, 0), (32, 1), (64, 2)])
def test_f32_narrow_rows_take_the_mma_sync_kernel(dev, d, pad):
    """f32 rows TMA cannot take (D % 4 != 0, or head views of a projection
    whose rows are `pad` floats longer, so their strides are no whole
    16-byte chunks) go to the mma.sync 3xTF32 kernel with element loads
    ("f32tc_narrow"), its keys split over blocks and merged at this small
    grid, against the plain version at 2e-5."""
    import ns2vc_tpu_torch.ops.flash_attention as fa

    g = _gen(dev, 14)
    b, h, tq, tk = 1, 2, 150, 333
    c = h * d
    qkv = torch.randn(b, tk, 3 * c + pad, generator=g, device=dev)
    q, k, v = qkv[..., :3 * c].split(c, dim=-1)
    q, k, v = (split_heads(x, h) for x in (q[:, :tq], k, v))
    bias = torch.zeros(b, tk, device=dev)
    bias[:, 300:] = -1e4
    assert fa.plan_f32tc(b * h, tq, tk, d)[0] > 1
    n0 = flash_attention.route_launches["f32tc_narrow"]
    got = flash_attention(q, k, v, bias)
    assert flash_attention.route_launches["f32tc_narrow"] == n0 + 1
    want = flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,co,film", [
    (2, 448, 128, 128, True),
    (2, 56, 1024, 512, False),    # widest up-path skip concat
    (3, 37, 384, 256, True),      # ragged T, no pad-to-8
    (2, 448, 128, 100, False),    # the UNet output tail
    (1, 5, 24, 40, True),         # widths that are no multiple of 32
])
def test_gn_silu_conv1d_matches_plain(dev, dtype, b, t, c, co, film):
    g = _gen(dev, 2)
    x = torch.randn(b, t, c, generator=g, device=dev).to(dtype)
    w = (torch.randn(co, c, 3, generator=g, device=dev) / (3 * c) ** 0.5)
    w, bias = w.to(dtype), (0.1 * torch.randn(co, generator=g,
                                              device=dev)).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    s = sh = None
    if film:
        s = 0.2 * torch.randn(b, c, generator=g, device=dev)
        sh = 0.2 * torch.randn(b, c, generator=g, device=dev)
    n0 = affine_silu_conv1d.launches
    route = "f32tc" if dtype == torch.float32 else "tc"
    r0 = affine_silu_conv1d.route_launches[route]
    got = gn_silu_conv1d(x, gamma, beta, w, bias, 8, 1e-5, s, sh)
    assert affine_silu_conv1d.launches == n0 + 1
    assert affine_silu_conv1d.route_launches[route] == r0 + 1
    want = gn_silu_conv1d(x.cpu(), gamma.cpu(), beta.cpu(), w.cpu(),
                          bias.cpu(), 8, 1e-5,
                          None if s is None else s.cpu(),
                          None if sh is None else sh.cpu())
    torch.cuda.synchronize()
    err = (got.float().cpu() - want.float()).abs().max().item()
    tol = 3e-5 if dtype == torch.float32 else \
        1e-2 * max(1.0, want.float().abs().max().item())
    assert got.dtype == dtype and err <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,co", [
    (1, 1, 128, 128),     # T = 1
    (2, 100, 200, 136),   # T, C and Co not multiples of the tile
    (1, 56, 1024, 512),   # split over every channel chunk
    (16, 56, 1024, 512),  # split in two (bf16) or more
    (16, 448, 128, 100),  # the output tail, no split
    (3, 37, 20, 40),      # bf16 C % 8 != 0: element loads
    (2, 37, 21, 40),      # odd C: element loads in f32 too
])
def test_affine_silu_conv1d_tc(dev, dtype, b, t, c, co):
    """Both tensor-core kernels, with and without their channel split,
    against the plain version on the same inputs."""
    g = _gen(dev, 5)
    x = torch.randn(b, t, c, generator=g, device=dev).to(dtype)
    a = 1 + 0.2 * torch.randn(b, c, generator=g, device=dev)
    off = 0.2 * torch.randn(b, c, generator=g, device=dev)
    w = (torch.randn(co, c, 3, generator=g, device=dev)
         / (3 * c) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(co, generator=g, device=dev)).to(dtype)
    route = ("tc" if dtype == torch.bfloat16 else "f32tc") + (
        "" if c % (16 // x.element_size()) == 0 else "_elem")
    n0 = affine_silu_conv1d.route_launches[route]
    got = affine_silu_conv1d(x, a, off, w, bias)
    assert affine_silu_conv1d.route_launches[route] == n0 + 1
    want = affine_silu_conv1d_plain(x, a, off, w, bias)
    torch.cuda.synchronize()
    assert (plan_wgmma if dtype == torch.bfloat16 else plan_tc)(
        b, t, c, co)[0] >= 1
    tol = 3e-5 if dtype == torch.float32 else \
        1e-2 * max(1.0, want.float().abs().max().item())
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= tol
    w.mul_(0.5)    # an in-place update repacks the weights
    want = affine_silu_conv1d_plain(x, a, off, w, bias)
    got = affine_silu_conv1d(x, a, off, w, bias)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co", [
    (256, 128), (384, 192), (512, 256),    # mp=2 at Config()'s levels
    (1024, 256), (768, 192),               # the up path's skip concats
    (256, 64), (384, 96),                  # mp=4
])
def test_gn_silu_conv1d_at_the_model_axis_widths(dev, dtype, c, co):
    """K2 on one model rank's block of a split resnet conv: Co = C_out /
    mp with x, a and b whole, the weight a contiguous block of rows of the
    whole conv's (packed at its own width, Co padded to the tile), and
    plan_tc dealing every channel chunk to a split at the training
    geometry and at one B=16 serving step."""
    from ns2vc_tpu_torch.ops.fused_resnet import packed_weight
    from ns2vc_tpu_torch.parallel.mesh import Placement, shard_tensor

    g = _gen(dev, 7)
    whole = torch.randn(2 * co, c, 3, generator=g, device=dev) / (3 * c) ** 0.5
    w = shard_tensor(whole.to(dtype), Placement("model"), 1, 2)
    bias = (0.1 * torch.randn(co, generator=g, device=dev)).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    for b, t in ((2, 272), (16, 448)):
        x = torch.randn(b, t, c, generator=g, device=dev).to(dtype)
        s = 0.2 * torch.randn(b, c, generator=g, device=dev)
        sh = 0.2 * torch.randn(b, c, generator=g, device=dev)
        bk = chunk_width(dtype)
        splits, cps = (plan_wgmma if dtype == torch.bfloat16 else plan_tc)(
            b, t, c, co)
        n_chunks = -(-c // bk)
        assert splits * cps >= n_chunks > (splits - 1) * cps
        route = "f32tc" if dtype == torch.float32 else "tc"
        r0 = affine_silu_conv1d.route_launches[route]
        got = gn_silu_conv1d(x, gamma, beta, w, bias, 8, 1e-5, s, sh)
        assert affine_silu_conv1d.route_launches[route] == r0 + 1
        want = gn_silu_conv1d(x.cpu(), gamma.cpu(), beta.cpu(), w.cpu(),
                              bias.cpu(), 8, 1e-5, s.cpu(), sh.cpu())
        torch.cuda.synchronize()
        tol = 3e-5 if dtype == torch.float32 else \
            1e-2 * max(1.0, want.float().abs().max().item())
        assert got.dtype == dtype and got.shape == (b, t, co)
        assert (got.float().cpu() - want.float()).abs().max().item() <= tol
    bn = tile_width(dtype)
    assert packed_weight(w).shape[-2] == -(-co // bn) * bn


def _unet_resnet_cases():
    """(name, T, C, Co, film) of one UNet step's 45 resnet epilogues at the
    448-frame serving bucket (`chip_smoke.resnet_cases`)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2

    with torch.device("meta"):
        unet = NaturalSpeech2(Config()).diff_model.unet
    return chip_smoke.resnet_cases(unet)


@pytest.mark.parametrize("bsz", [16, 1])
def test_wgmma_conv_at_the_serving_geometries(dev, bsz):
    """The bf16 wgmma kernel at every epilogue of one UNet step (T 448 to
    56, C 128 to 1024, Co 100 to 512), at B=16 (split in two at the
    deepest level) and B=1 (clusters of up to 8 splits), with the affine
    from the statistics kernel, against the plain version."""
    g = _gen(dev, 11)
    for name, t, c, co, film in _unet_resnet_cases():
        x = torch.randn(bsz, t, c, generator=g, device=dev).bfloat16()
        w = (torch.randn(co, c, 3, generator=g, device=dev)
             / (3 * c) ** 0.5).bfloat16()
        bias = (0.1 * torch.randn(co, generator=g, device=dev)).bfloat16()
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        beta = 0.1 * torch.randn(c, generator=g, device=dev)
        s = sh = None
        if film:
            s, sh = (0.2 * torch.randn(bsz, 2 * c, generator=g, device=dev)
                     ).bfloat16().chunk(2, dim=-1)
        n0 = affine_silu_conv1d.route_launches["tc"]
        got = gn_silu_conv1d(x, gamma, beta, w, bias, 8, 1e-5, s, sh)
        assert affine_silu_conv1d.route_launches["tc"] == n0 + 1
        a, b = group_norm_affine_plain(x, gamma, beta, 8, 1e-5, s, sh)
        want = affine_silu_conv1d_plain(x, a, b, w, bias)
        torch.cuda.synchronize()
        tol = 1e-2 * max(1.0, want.float().abs().max().item())
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (name, plan_wgmma(bsz, t, c, co), err, tol)


@pytest.mark.parametrize("bsz", [16, 2, 1])
def test_f32_conv_at_the_serving_geometries(dev, bsz):
    """The f32 wgmma kernel (3xTF32) at every epilogue of one UNet step, at
    B=16 (no split), B=2 and B=1 (clusters of up to 8 splits), with the
    affine from the statistics kernel, against the plain version within
    the JAX suite's 3e-5; two launches give bitwise-equal outputs."""
    g = _gen(dev, 12)
    for name, t, c, co, film in _unet_resnet_cases():
        x = torch.randn(bsz, t, c, generator=g, device=dev)
        w = torch.randn(co, c, 3, generator=g, device=dev) / (3 * c) ** 0.5
        bias = 0.1 * torch.randn(co, generator=g, device=dev)
        gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        beta = 0.1 * torch.randn(c, generator=g, device=dev)
        s = sh = None
        if film:
            s, sh = (0.2 * torch.randn(bsz, 2 * c, generator=g, device=dev)
                     ).chunk(2, dim=-1)
        a, b = group_norm_affine(x, gamma, beta, 8, 1e-5, s, sh)
        n0 = affine_silu_conv1d.route_launches["f32tc"]
        got = affine_silu_conv1d(x, a, b, w, bias)
        again = affine_silu_conv1d(x, a, b, w, bias)
        assert affine_silu_conv1d.route_launches["f32tc"] == n0 + 2
        want = affine_silu_conv1d_plain(x, a, b, w, bias)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= 3e-5, (name, plan_tc(bsz, t, c, co), err)
        assert torch.equal(got, again), (name, plan_tc(bsz, t, c, co))


@pytest.mark.parametrize("b,t,c,co", [
    (1, 56, 1022, 512),   # C % 4 != 0 over a cluster of 8 splits
    (2, 448, 126, 100),   # C % 4 != 0, the output tail's Co
    (2, 37, 3, 8),        # fewer channels than a vector
])
def test_f32_conv_element_loads(dev, b, t, c, co):
    """x that TMA cannot describe (C % 4 != 0): the f32 kernel loads it by
    elements ("f32tc_elem"), against the plain version; bitwise repeatable."""
    g = _gen(dev, 13)
    x = torch.randn(b, t, c, generator=g, device=dev)
    a = 1 + 0.2 * torch.randn(b, c, generator=g, device=dev)
    off = 0.2 * torch.randn(b, c, generator=g, device=dev)
    w = torch.randn(co, c, 3, generator=g, device=dev) / (3 * c) ** 0.5
    bias = 0.1 * torch.randn(co, generator=g, device=dev)
    n0 = affine_silu_conv1d.route_launches["f32tc_elem"]
    got = affine_silu_conv1d(x, a, off, w, bias)
    again = affine_silu_conv1d(x, a, off, w, bias)
    assert affine_silu_conv1d.route_launches["f32tc_elem"] == n0 + 2
    want = affine_silu_conv1d_plain(x, a, off, w, bias)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 3e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,tk,d,layout", [
    (16, 1, 321, 100, "pool"),    # ref_enc at B=16
    (16, 64, 321, 4, "pool"),     # add_embedding at B=16
    (1, 64, 321, 4, "pool"),      # add_embedding at B=1: keys split
    (3, 5, 77, 1, "heads"),       # odd Tk, D = 1
    (3, 5, 77, 4, "heads"),
    (3, 5, 77, 100, "heads"),
    (2, 2, 1000, 128, "heads"),   # the widest head, several key tiles
])
def test_single_query_kernel(dev, dtype, atol, b, h, tk, d, layout):
    """The single-query kernel (Tq == 1) against the plain version: the
    pools as head views of (B, T, C) projections, and separate
    (B, H, T, D) tensors with key padding, one batch row fully masked
    (finite) and one at -1e30; two launches give bitwise-equal outputs."""
    g = _gen(dev, 14)
    if layout == "pool":
        q, k, v = (split_heads(torch.randn(b, n, h * d, generator=g,
                                           device=dev).to(dtype), h)
                   for n in (1, tk, tk))
        bias = None
    else:
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=dev).to(dtype)
                   for n in (1, tk, tk))
        bias = torch.zeros(b, tk, device=dev)
        bias[0, tk // 3:] = -1e4
        bias[1] = -1e4
        bias[-1, :tk // 2] = -1e30
    route = "tc_q1" if dtype == torch.bfloat16 else "f32tc_q1"
    n0 = flash_attention.route_launches[route]
    got = flash_attention(q, k, v, bias)
    again = flash_attention(q, k, v, bias)
    assert flash_attention.route_launches[route] == n0 + 2
    want = flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, 1, d)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    if bias is not None:
        # the fully masked row: f32 logits near -1e4 carry steps of 2^-10
        masked = MASKED_F32_ATOL * v.float().abs().max().item() \
            if dtype == torch.float32 else atol
        assert err[1].max().item() <= masked
        err[1] = 0
    assert err.max().item() <= atol
    assert torch.equal(got, again)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,film", [
    (16, 448, 128, True),     # serving, level 0
    (16, 56, 1024, False),    # serving, the deepest skip concat
    (1, 832, 384, True),      # the CLI's longest B=1 bucket
    (32, 272, 256, True),     # training
    (2, 37, 16, True),        # two channels a group: element loads
    (3, 5, 64, False),        # fewer frames than a cluster's blocks
])
def test_group_norm_affine_matches_plain(dev, xdtype, pdtype, b, t, c, film):
    """The statistics kernel against its plain version: 2e-5 of max(1,
    |a|, |b|) (f32 sums in other orders), and two launches bitwise equal."""
    g = _gen(dev, 12)
    x = (0.3 + 2 * torch.randn(b, t, c, generator=g, device=dev)).to(xdtype)
    gamma = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).to(pdtype)
    beta = (0.1 * torch.randn(c, generator=g, device=dev)).to(pdtype)
    s = sh = None
    if film:    # FiLM rows as a chunk of one projection, as on the path
        s, sh = (0.2 * torch.randn(b, 2 * c, generator=g, device=dev)
                 ).to(pdtype).chunk(2, dim=-1)
    n0 = group_norm_affine.launches
    a, off = group_norm_affine(x, gamma, beta, 8, 1e-5, s, sh)
    a2, off2 = group_norm_affine(x, gamma, beta, 8, 1e-5, s, sh)
    assert group_norm_affine.launches == n0 + 2
    pa, pb = group_norm_affine_plain(x, gamma, beta, 8, 1e-5, s, sh)
    torch.cuda.synchronize()
    assert torch.equal(a, a2) and torch.equal(off, off2)
    tol = 2e-5 * max(1.0, pa.abs().max().item(), pb.abs().max().item())
    assert a.dtype == off.dtype == torch.float32
    assert (a - pa).abs().max().item() <= tol
    assert (off - pb).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_affine_function_on_the_card(dev, dtype):
    """Under autograd the statistics kernel runs forward and its backward
    is the plain version's, recomputed: gradients of x, gamma, beta and
    FiLM are autograd's through the plain version (to the rounding of the
    same ops in another launch)."""
    g = _gen(dev, 13)
    b, t, c = 4, 136, 128
    x = torch.randn(b, t, c, generator=g, device=dev).to(dtype)
    gamma = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
    beta = (0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
    proj = (0.2 * torch.randn(b, 2 * c, generator=g, device=dev)).to(dtype)
    da, db = (torch.randn(b, c, generator=g, device=dev) for _ in range(2))

    def grads(fn):
        leaves = [v.detach().requires_grad_() for v in (x, gamma, beta, proj)]
        out = fn(*leaves[:3], 8, 1e-5, *leaves[3].chunk(2, dim=-1))
        torch.autograd.backward(out, (da, db))
        return [v.grad for v in leaves]
    n0, b0 = group_norm_affine.launches, group_norm_affine.backward_calls
    got = grads(group_norm_affine)
    assert group_norm_affine.launches == n0 + 1
    assert group_norm_affine.backward_calls == b0 + 1
    want = grads(group_norm_affine_plain)
    torch.cuda.synchronize()
    rtol = 1e-5 if dtype == torch.float32 else 1e-2   # the grads' dtype
    for name, gv, wv in zip(("x", "gamma", "beta", "film"), got, want):
        assert gv.dtype == wv.dtype, name
        assert (gv.float() - wv.float()).abs().max().item() <= \
            rtol * max(1.0, wv.float().abs().max().item()), name


def test_affine_silu_conv1d_refuses_what_it_cannot_take(dev):
    x = torch.zeros(1, 8, 16, device=dev)
    a = torch.zeros(1, 16, device=dev)
    w, bias = torch.zeros(4, 16, 3, device=dev), torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        affine_silu_conv1d(x.transpose(1, 2).contiguous().transpose(1, 2),
                           a, a, w, bias)
    with pytest.raises(ValueError, match="f32"):
        affine_silu_conv1d(x, a.bfloat16(), a, w, bias)
    with pytest.raises(ValueError, match="shapes"):
        affine_silu_conv1d(x, a, a, torch.zeros(4, 16, 5, device=dev), bias)
    # the plain version agrees on zeros, and is what a CPU tensor gets
    assert torch.equal(affine_silu_conv1d_plain(x, a, a, w, bias).cpu(),
                       affine_silu_conv1d(x.cpu(), a.cpu(), a.cpu(), w.cpu(),
                                          bias.cpu()))


def test_unet_on_card_matches_cpu(dev):
    from ns2vc_tpu_torch.convert import init_module_
    from ns2vc_tpu_torch.models.unet import UNet1DConditionModel

    kw = dict(in_channels=40, out_channels=20, block_out_channels=(32, 64),
              cross_attention_dim=48, addition_embed_heads=8)
    unet = init_module_(UNet1DConditionModel(**kw),
                        torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    x, ctx = torch.randn(2, 24, 40, generator=g), torch.randn(2, 10, 48,
                                                              generator=g)
    mask = torch.arange(10)[None] < torch.tensor([10, 6])[:, None]
    ts = torch.tensor([10.0, 900.0])
    with torch.no_grad():
        want = unet(x, ts, ctx, mask)
        unet.to(dev)
        got = unet(*(a.to(dev) for a in (x, ts, ctx, mask)))
    assert (got.cpu() - want).abs().max().item() <= 5e-4


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_nsf_hifigan_on_card_matches_cpu(dev, resblock):
    """The small NSF-HiFiGAN generator of tests/test_torch_nsf_hifigan.py,
    card vs CPU in f32 without TF32, the same initial phases (a CPU draw):
    2e-5, the conv-stack bound of that file."""
    from ns2vc_tpu_torch.convert import init_nsf_hifigan_params
    from ns2vc_tpu_torch.models.nsf_hifigan import (
        NSFHiFiGANGenerator, initial_phase,
    )

    kw = dict(num_mels=8, upsample_initial_channel=16, upsample_rates=(2, 2),
              upsample_kernel_sizes=(4, 4), resblock=resblock,
              resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
              sampling_rate=8000)
    gen = NSFHiFiGANGenerator(**kw)
    gen.load_state_dict(init_nsf_hifigan_params(
        torch.Generator().manual_seed(0), **kw))
    g = torch.Generator().manual_seed(1)
    mel = torch.randn(2, 12, 8, generator=g)
    f0 = 80.0 + 500.0 * torch.rand(2, 12, generator=g)
    f0[:, 4:6] = 0.0
    rand_ini = initial_phase(2, 9, torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = gen.eval()(mel, f0, rand_ini=rand_ini)
        got = gen.to(dev)(mel.to(dev), f0.to(dev), rand_ini=rand_ini)
    assert got.shape == want.shape == (2, 48) and got.device == dev
    assert (got.cpu() - want).abs().max().item() <= 2e-5


def _small_svc(device):
    """A Svc of a narrow configuration with seeded weights."""
    from ns2vc_tpu_torch.config import (
        Config, DiffusionEncoderConfig, EncoderConfig,
    )
    from ns2vc_tpu_torch.convert import init_params, init_vocos_params
    from ns2vc_tpu_torch.infer.svc import Svc

    cfg = Config(phoneme_encoder=EncoderConfig(n_layers=1),
                 prompt_encoder=EncoderConfig(in_channels=100, n_layers=1),
                 diffusion_encoder=DiffusionEncoderConfig(
                     block_out_channels=(16, 24, 32, 40)))
    g = torch.Generator().manual_seed(0)
    return Svc(config=cfg, params=init_params(cfg, g),
               vocos_params=init_vocos_params(g), device=device)


def test_svc_finish_waits_only_on_its_own_batch(dev, monkeypatch):
    """Batch 2's dispatch ends in ~0.5 s of spin on the stream, enqueued
    before its readback: batch 1's finish() must return while batch 2's
    end event still reports not done. A readback that synchronised the
    stream (a blocking `.cpu()` in finish) would wait for the spin."""
    import numpy as np

    svc = _small_svc(dev)
    r = np.random.default_rng(0)
    clips = [r.standard_normal((n, 256)).astype(np.float32) for n in (40, 70)]
    refer = r.standard_normal((30, 100)).astype(np.float32)
    svc.infer_batch(clips, refer, sampling_timesteps=3)       # warm-up
    f1 = svc.infer_batch_async(clips, refer, sampling_timesteps=3)
    run = svc._run

    def run_then_spin(*args, **kwargs):
        wav = run(*args, **kwargs)
        torch.cuda._sleep(int(1e9))
        return wav
    monkeypatch.setattr(svc, "_run", run_then_spin)
    f2 = svc.infer_batch_async(clips, refer, sampling_timesteps=3,
                               output="pcm16")
    outs = f1()
    assert not f2.done.query(), "batch 1's readback waited for batch 2"
    assert f1.done.query()
    assert [o.shape for o in outs] == [(40 * 256,), (70 * 256,)]
    pcm = f2()
    assert f2.done.query() and pcm[1].dtype == np.int16


def test_svc_dispatch_from_another_thread(dev):
    """The MicroBatcher dispatches from its worker thread, whose current
    device is cuda:0. A Svc made with device 'cuda' while the last card is
    current keeps that card, and a dispatch and readback from a fresh
    thread give the main thread's result (with two or more cards, on a
    card that is not the thread's current one)."""
    import threading

    import numpy as np

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    with torch.cuda.device(last):
        svc = _small_svc("cuda")
    assert svc.device == last
    r = np.random.default_rng(1)
    clips = [r.standard_normal((n, 256)).astype(np.float32) for n in (40, 70)]
    refer = r.standard_normal((30, 100)).astype(np.float32)
    want = svc.infer_batch(clips, refer, sampling_timesteps=3)
    got = []
    t = threading.Thread(target=lambda: got.append(svc.infer_batch_async(
        clips, refer, sampling_timesteps=3, refer_cache_key="k")()))
    t.start()
    t.join(timeout=300)
    assert len(got) == 1 and svc._refer_cache
    assert next(iter(svc._refer_cache.values())).device == last
    for a, b in zip(got[0], want):
        np.testing.assert_allclose(a, b, atol=1e-5)


# -- serving programs: CUDA graphs of the serving call ------------------------

def _counts():
    from ns2vc_tpu_torch.ops import flash_attention, fused_resnet

    return (flash_attention.launch_counts(), fused_resnet.launch_counts())


def _reset_counts():
    from ns2vc_tpu_torch.ops import flash_attention, fused_resnet

    flash_attention.reset_launches()
    fused_resnet.reset_launches()


def _request(seed, lens=(40, 70)):
    import numpy as np

    r = np.random.default_rng(seed)
    return ([r.standard_normal((n, 256)).astype(np.float32) for n in lens],
            r.standard_normal((30, 100)).astype(np.float32))


@pytest.mark.parametrize("method,eta", [("unipc", 0.0), ("dpmsolver", 0.0),
                                        ("ddim", 0.5)])
def test_svc_program_replay_equals_the_eager_body(dev, monkeypatch, method,
                                                  eta):
    """A key's first call (warm-up, capture, replay) and a replay give the
    eager body's waveforms at the same seed bit for bit (DDIM's eta > 0
    noise drawn before the replay); a replay counts the eager body's
    launches, and the first call twice those (warm-up and replay)."""
    import numpy as np

    svc = _small_svc(dev)
    clips, refer = _request(2)
    kw = dict(sample_method=method, sampling_timesteps=4, eta=eta, seed=3)
    _reset_counts()
    first = svc.infer_batch(clips, refer, **kw)
    first_counts = _counts()
    _reset_counts()
    replay = svc.infer_batch(clips, refer, **kw)
    replay_counts = _counts()
    (prog,) = svc._programs.values()
    assert prog.graph is not None and prog.replays == 2 and prog.nodes > 0
    monkeypatch.setattr(svc, "_run", svc._run_eager)
    _reset_counts()
    eager = svc.infer_batch(clips, refer, **kw)
    assert _counts() == replay_counts
    k1, k2 = replay_counts
    assert k1["launches"] > 0 and k2["launches"] > 0 and k2["gn"] > 0
    for part, c in zip(first_counts, replay_counts):
        assert part == {k: 2 * n for k, n in c.items()}
    for a, b, c in zip(first, replay, eager):
        assert np.array_equal(a, c) and np.array_equal(b, c)


def test_svc_programs_in_flight_keep_each_batchs_audio(dev):
    """Two dispatches of one key before either is read back: the second
    replay overwrites the program's static output only after the first
    batch's copy out, in stream order."""
    import numpy as np

    svc = _small_svc(dev)
    (a, refer), (b, _) = _request(4), _request(5)
    kw = dict(sampling_timesteps=4, output="pcm16")
    want_a = svc.infer_batch(a, refer, seed=1, **kw)
    want_b = svc.infer_batch(b, refer, seed=2, **kw)
    fa = svc.infer_batch_async(a, refer, seed=1, **kw)
    fb = svc.infer_batch_async(b, refer, seed=2, **kw)
    got_a, got_b = fa(), fb()
    assert len(svc._programs) == 1
    for x, y in zip(got_a + got_b, want_a + want_b):
        assert np.array_equal(x, y)
    assert not np.array_equal(got_a[0], got_b[0])


def test_svc_capture_while_another_thread_synchronises(dev, monkeypatch):
    """A completer thread waits on a batch's event and records and waits on
    its own events while the dispatching thread captures a new key: the
    capture is thread-local, so the waits do not break it."""
    import threading

    import numpy as np

    svc = _small_svc(dev)
    clips, refer = _request(6)
    svc.infer_batch(clips, refer, sampling_timesteps=4)       # key A
    done, waits, got = threading.Event(), [], []
    pending = svc.infer_batch_async(clips, refer, sampling_timesteps=4)

    def completer():
        got.append(pending())
        while not done.is_set():
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
            waits.append(1)
    t = threading.Thread(target=completer)
    t.start()
    try:
        new = svc.infer_batch(clips, refer, sampling_timesteps=5)  # key B
    finally:
        done.set()
        t.join(timeout=120)
    assert not t.is_alive() and len(got) == 1 and waits
    assert len(svc._programs) == 2
    assert all(p.graph is not None for p in svc._programs.values())
    monkeypatch.setattr(svc, "_run", svc._run_eager)
    want = svc.infer_batch(clips, refer, sampling_timesteps=5)
    for x, y in zip(new, want):
        assert np.array_equal(x, y)


def test_svc_failed_capture_raises(dev, monkeypatch):
    """A body that synchronises the device cannot be captured: the call
    raises, caches no program and falls back to nothing; the capture's
    launches come off the counters. The same key captures once the body
    is capturable again."""
    svc = _small_svc(dev)
    clips, refer = _request(7)
    vocos = type(svc.vocos).forward

    def synchronising(self, mel):
        torch.cuda.synchronize()
        return vocos(self, mel)
    monkeypatch.setattr(type(svc.vocos), "forward", synchronising)
    _reset_counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        svc.infer_batch(clips, refer, sampling_timesteps=4)
    warm_only = _counts()
    assert svc._programs == {}
    monkeypatch.undo()
    _reset_counts()
    svc.infer_batch(clips, refer, sampling_timesteps=4)
    assert _counts() == tuple({k: 2 * n for k, n in c.items()}
                              for c in warm_only)
    assert len(svc._programs) == 1


# -- training: K1 and K2 under autograd ---------------------------------------
#
# With grad on, each wrapper goes through its autograd Function: the forward
# launches the kernel (counted in `launches`), the backward is written out
# in torch ops (counted in `backward_calls[route]`). Gradients against
# autograd through the plain versions: 1e-4 in f32; in bf16, 3e-2 of
# max(1, max|grad|) (the kernels' bf16 outputs enter the backward).

def _grad_tol(dtype, want):
    if dtype == torch.float32:
        return 1e-4
    return 3e-2 * max(1.0, want.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_launches_the_kernel(dev, dtype):
    from ns2vc_tpu_torch.ops.attention import merge_heads

    g = _gen(dev, 7)
    b, h, t, d = 4, 8, 136, 32
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device=dev).to(dtype)
    bias = torch.zeros(b, t, device=dev)
    bias[-1, 100:] = -1e4
    dout = torch.randn(b, t, h * d, generator=g, device=dev).to(dtype)

    def run(fn):
        x = qkv.detach().requires_grad_()
        q, k, v = (split_heads(y, h) for y in x.split(h * d, dim=-1))
        out = merge_heads(fn(q, k, v, bias))
        out.backward(dout)
        return out, x.grad
    q, k, v = (split_heads(y, h) for y in qkv.split(h * d, dim=-1))
    route = _k1_route(q, k, v)
    n0, b0 = flash_attention.launches, dict(flash_attention.backward_calls)
    out, got = run(flash_attention)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1 and out.grad_fn is not None
    assert flash_attention.backward_calls[route] == b0[route] + 1
    _, want = run(flash_attention_plain)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= \
        _grad_tol(dtype, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet_function_launches_the_kernel(dev, dtype, monkeypatch):
    import ns2vc_tpu_torch.ops.fused_resnet as fr

    g = _gen(dev, 8)
    b, t, c, co = 4, 136, 128, 256
    x = torch.randn(b, t, c, generator=g, device=dev).to(dtype)
    gamma = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
    beta = (0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
    w = (torch.randn(co, c, 3, generator=g, device=dev) / 20).to(dtype)
    bias = (0.1 * torch.randn(co, generator=g, device=dev)).to(dtype)
    film = [(0.2 * torch.randn(b, c, generator=g, device=dev)).to(dtype)
            for _ in range(2)]
    dy = torch.randn(b, t, co, generator=g, device=dev).to(dtype)

    def run():
        args = [a.detach().requires_grad_()
                for a in (x, gamma, beta, w, bias, *film)]
        y = gn_silu_conv1d(*args[:5], 8, 1e-5, film_scale=args[5],
                           film_shift=args[6])
        y.backward(dy)
        return y, [a.grad for a in args]
    route = "tc" if dtype == torch.bfloat16 else "f32tc"
    n0, b0 = affine_silu_conv1d.launches, dict(
        affine_silu_conv1d.backward_calls)
    k0 = dict(affine_silu_conv1d_grad.route_launches)
    y, got = run()
    torch.cuda.synchronize()
    assert affine_silu_conv1d.launches == n0 + 1 and y.grad_fn is not None
    assert affine_silu_conv1d.backward_calls[route] == b0[route] + 1
    # the backward runs on the backward kernels, never on cuDNN
    grad_route = "bf16" if dtype == torch.bfloat16 else "f32"
    assert affine_silu_conv1d_grad.route_launches[grad_route] == \
        k0[grad_route] + 1
    monkeypatch.setattr(fr, "affine_silu_conv1d", affine_silu_conv1d_plain)
    _, want = run()
    for name, a, e in zip(("x", "gamma", "beta", "w", "bias", "scale",
                           "shift"), got, want):
        assert a.dtype == e.dtype and torch.isfinite(a.float()).all(), name
        assert (a.float() - e.float()).abs().max().item() <= \
            _grad_tol(dtype, e), name


# K2's backward kernels (`affine_silu_conv1d_grad`) against the plain
# backward (`affine_silu_conv1d_backward`, cuDNN with TF32 off) on the same
# inputs, f32 sums either way in other orders: dx, dw, dbias, da, db each
# within 3e-5 of max|plain| (K2's f32 bound), the bf16 kernels' sums taken
# before their rounding (`keep_f32`), and their bf16 outputs within one
# rounding of those sums. Two launches agree bit for bit.
K2_BWD_RTOL = 3e-5
K2_BWD_GEOMETRIES = [
    (2, 136, 256, 128),    # a UNet level of the training step
    (4, 34, 1024, 512),    # the deepest level: T < one frame tile
    (3, 37, 40, 100),      # odd T, C not a multiple of 16, conv_out's Co
    (1, 5, 7, 3),          # smaller than every tile
    (32, 272, 128, 100),   # conv_out at the training batch: 64 splits
]


def _k2_backward_inputs(g, dev, bsz, t, c, co, dtype):
    x = torch.randn(bsz, t, c, generator=g, device=dev).to(dtype)
    a = 1 + 0.3 * torch.randn(bsz, c, generator=g, device=dev)
    b = 0.3 * torch.randn(bsz, c, generator=g, device=dev)
    w = (torch.randn(co, c, 3, generator=g, device=dev)
         / (3 * c) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(co, generator=g, device=dev)).to(dtype)
    dy = torch.randn(bsz, t, co, generator=g, device=dev).to(dtype)
    return x, a, b, w, bias, dy


@pytest.mark.parametrize("geometry", K2_BWD_GEOMETRIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_backward_kernels_match_the_plain_backward(dev, dtype, geometry):
    from ns2vc_tpu_torch.ops.fused_resnet import (
        affine_silu_conv1d_backward, plan_backward,
    )

    args = _k2_backward_inputs(_gen(dev, 21), dev, *geometry, dtype)
    route = "bf16" if dtype == torch.bfloat16 else "f32"
    n0 = affine_silu_conv1d_grad.route_launches[route]
    got = affine_silu_conv1d_grad(*args, keep_f32=True)
    again = affine_silu_conv1d_grad(*args, keep_f32=True)
    out = affine_silu_conv1d_grad(*args)
    assert affine_silu_conv1d_grad.route_launches[route] == n0 + 3
    x, a, b, w, bias, dy = args
    want = affine_silu_conv1d_backward(x.float(), a, b, w.float(),
                                       bias.float(), dy.float())
    torch.cuda.synchronize()
    names = ("dx", "da", "db", "dw", "dbias")
    for name, gv, rv, wv, ov, inp in zip(names, got, again, want, out,
                                         (x, a, b, w, bias)):
        assert gv.shape == wv.shape and gv.dtype == torch.float32, name
        assert torch.equal(gv, rv), name
        scale = max(wv.abs().max().item(), 1e-30)
        err = (gv - wv).abs().max().item() / scale
        assert err <= K2_BWD_RTOL, (name, err, plan_backward(*geometry))
        assert ov.dtype == inp.dtype, name
        # one rounding of the kept sums (bf16: half an ulp, 2^-8 relative)
        assert ((ov.float() - gv).abs()
                <= gv.abs() * (2.0 ** -8 if dtype == torch.bfloat16
                               else 0.0)).all(), name


def test_k2_backward_refuses_what_it_cannot_take(dev):
    x, a, b, w, bias, dy = _k2_backward_inputs(_gen(dev, 22), dev, 2, 8, 16,
                                               8, torch.float32)
    with pytest.raises(ValueError, match="dy"):
        affine_silu_conv1d_grad(x, a, b, w, bias, dy[:, :4])
    with pytest.raises(ValueError, match="dy"):
        affine_silu_conv1d_grad(x, a, b, w, bias, dy.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        affine_silu_conv1d_grad(x.transpose(0, 1).contiguous().transpose(
            0, 1), a, b, w, bias, dy)
    with pytest.raises(ValueError, match="a and b"):
        affine_silu_conv1d_grad(x, a.double(), b, w, bias, dy)


@pytest.mark.parametrize("remat_policy", [None, "dots"])
def test_train_step_on_the_card_runs_the_kernels(dev, remat_policy):
    """One bf16 train step of a small model: every K1 / K2 call of the
    forward launches its tensor-core kernel (again in the backward pass
    under remat), each has one backward, and the f32 masters get finite
    gradients."""
    from ns2vc_tpu_torch.config import (
        Config, DiffusionEncoderConfig, EncoderConfig,
    )
    from ns2vc_tpu_torch.convert import init_module_
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
    from ns2vc_tpu_torch.ops import flash_attention as fa, fused_resnet
    from ns2vc_tpu_torch.train.trainer import (
        TrainState, make_optimizer, make_train_step,
    )

    cfg = Config(phoneme_encoder=EncoderConfig(n_layers=1),
                 prompt_encoder=EncoderConfig(in_channels=100, n_layers=1),
                 diffusion_encoder=DiffusionEncoderConfig(
                     block_out_channels=(64, 128)))
    model = NaturalSpeech2(cfg, remat=remat_policy is not None,
                           remat_policy=remat_policy or "all")
    init_module_(model, torch.Generator().manual_seed(0))
    model.to(dev)
    state = TrainState(model, make_optimizer(cfg, model.parameters()))
    step = make_train_step(compute_dtype=torch.bfloat16)
    g = _gen(dev, 9)
    batch = {"c": torch.randn(4, 64, 256, generator=g, device=dev),
             "refer": torch.randn(4, 48, 100, generator=g, device=dev),
             "spec": torch.randn(4, 64, 100, generator=g, device=dev),
             "lengths": torch.tensor([64, 50, 33, 64], device=dev),
             "refer_lengths": torch.tensor([48, 20, 48, 31], device=dev)}
    fa.reset_launches()
    fused_resnet.reset_launches()
    m = step(state, batch, g)
    torch.cuda.synchronize()
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    k1, k2 = fa.flash_attention, fused_resnet.affine_silu_conv1d
    # two levels: 12 UNet attentions, 2 encoder layers and 2 pooling calls
    # (one query, D = 100 and 4: the single-query kernel); 24 resnet
    # epilogues and the tail
    again = (12, 24) if remat_policy else (0, 0)
    assert k1.route_launches == {"f32tc": 0, "f32tc_q1": 0,
                                 "f32tc_narrow": 0, "tc": 14 + again[0],
                                 "tc_q1": 2, "tc_narrow": 0, "plain": 0}
    assert k1.backward_calls == {"f32tc": 0, "f32tc_q1": 0,
                                 "f32tc_narrow": 0, "tc": 14, "tc_q1": 2,
                                 "tc_narrow": 0}
    assert k2.route_launches == {"f32tc": 0, "f32tc_elem": 0,
                                 "tc": 25 + again[1], "tc_elem": 0}
    assert k2.backward_calls == {"f32tc": 0, "tc": 25}
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and torch.isfinite(p.grad).all(), \
            name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multihead_attention_routes_on_the_card(dev, dtype):
    """Key padding at D <= 128: one kernel launch; a bias along the
    queries, or D = 256: the plain route, no launch."""
    from ns2vc_tpu_torch.ops.attention import multihead_attention

    g = _gen(dev, 9)
    cases = [(8, 256, "padding"), (2, 256, "padding"), (1, 256, "padding"),
             (8, 256, "full")]
    for heads, c, kind in cases:
        q, k, v = (torch.randn(2, 40, c, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        if kind == "padding":
            bias = torch.zeros(2, 1, 1, 40, device=dev)
            bias[1, ..., 30:] = -1e4
        else:
            bias = torch.randn(1, 1, 40, 40, generator=g, device=dev)
        n0, p0 = flash_attention.launches, flash_attention.route_launches[
            "plain"]
        got = multihead_attention(q, k, v, heads, bias=bias)
        kernel = kind == "padding" and c // heads <= 128
        assert flash_attention.launches - n0 == int(kernel)
        assert flash_attention.route_launches["plain"] - p0 == int(not kernel)
        want = multihead_attention(q.cpu().float(), k.cpu().float(),
                                   v.cpu().float(), heads, bias=bias.cpu())
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 3e-2
        assert (got.float().cpu() - want).abs().max().item() <= tol


# -- the Trainer's step and eval programs ---------------------------------------
#
# On a card in one process `Trainer.train_step` replays one CUDA graph per
# step key and `sample_eval` one per eval bucket. Held bit for bit against
# the eager step (`Trainer._train_step_eager`) and the eager eval from the
# same state and seeds, with dropout 0.2 (masks and the F0 scale drawn inside
# the graph from the registered step generator), under the process's
# default cuDNN flags, with and without the F0 predictor: the step is
# deterministic by itself (K2's backward kernels, the F0 embedding's
# one-hot backward, cuDNN's deterministic algorithms inside the step).


def _small_trainer(dev, root, f0=False, vocos=False):
    """A Trainer of a narrow bf16 configuration (no data files: batches come
    from `_train_batch`), EMA every 2 steps, and one eval item."""
    import numpy as np

    from ns2vc_tpu_torch.config import (
        Config, DataConfig, DiffusionEncoderConfig, EncoderConfig,
        F0PredictorConfig, TrainConfig,
    )
    from ns2vc_tpu_torch.convert import init_vocos_params
    from ns2vc_tpu_torch.train.trainer import Trainer

    os.makedirs(os.path.join(root, "empty"), exist_ok=True)
    empty = os.path.join(root, "empty")
    cfg = Config(
        train=TrainConfig(compute_dtype="bfloat16", use_ema=True,
                          ema_update_every=2, num_workers=0,
                          logs_folder=os.path.join(root, "logs")),
        data=DataConfig(training_files=empty, val_files=empty),
        phoneme_encoder=EncoderConfig(n_layers=1),
        prompt_encoder=EncoderConfig(in_channels=100, n_layers=1),
        diffusion_encoder=DiffusionEncoderConfig(
            block_out_channels=(64, 128)),
        f0_predictor=F0PredictorConfig(enabled=f0, attention_layers=1))
    vsd = init_vocos_params(torch.Generator().manual_seed(3)) if vocos \
        else None
    tr = Trainer(cfg, logs_folder=os.path.join(root, "run"),
                 vocos_params=vsd, device=dev)
    r = np.random.default_rng(4)
    item = (r.standard_normal((90, 256)).astype(np.float32),      # c
            (150 + 50 * r.random(90)).astype(np.float32),          # f0
            r.standard_normal((90, 100)).astype(np.float32),       # spec
            np.zeros(8, np.float32),                               # audio
            np.ones(90, np.float32),                               # uv
            None, None,
            r.standard_normal((70, 100)).astype(np.float32),       # refer
            np.zeros(8, np.float32), None)
    tr.eval_ds = [item]
    return tr


def _train_batch(tr, seed, b=4, t=64, tp=48):
    import numpy as np

    r = np.random.default_rng(seed)
    batch = {"c": r.standard_normal((b, t, 256)).astype(np.float32),
             "refer": r.standard_normal((b, tp, 100)).astype(np.float32),
             "spec": r.standard_normal((b, t, 100)).astype(np.float32),
             "f0": (120 + 200 * r.random((b, t))).astype(np.float32),
             "uv": (r.random((b, t)) > 0.2).astype(np.float32),
             "lengths": np.array([t, t - 14, t - 31, t][:b], np.int32),
             "refer_lengths": np.array([tp, 20, tp, 31][:b], np.int32)}
    return tr.device_batch(batch)


def _trainer_state(tr) -> dict:
    opt = tr.state.optimizer.state_dict()["state"]
    return {"params": {k: v.detach().clone()
                       for k, v in tr.model.state_dict().items()},
            "moments": {(i, k): v.clone() for i, st in opt.items()
                        for k, v in st.items()},
            "ema": {k: v.clone() for k, v in tr.state.ema_params.items()}}


def _differing(a: dict, b: dict) -> list:
    return [(part, k) for part in a for k in a[part]
            if not torch.equal(a[part][k], b[part][k])]


@pytest.mark.parametrize("f0", [False, True])
def test_train_step_program_replays_the_eager_step(dev, tmp_path, f0):
    """Three steps (the first a warm-up and capture, then two replays)
    against three eager steps of a second Trainer from the same seed:
    metrics and state bit for bit; a replay counts the eager step's
    launches and backward calls."""
    comp = _small_trainer(dev, str(tmp_path / "c"), f0=f0)
    eager = _small_trainer(dev, str(tmp_path / "e"), f0=f0)
    eager.compiled = False
    batches = [_train_batch(comp, s) for s in range(3)]
    for i, b in enumerate(batches):
        _reset_counts()
        mc = comp.train_step(b)
        counted = _counts()
        _reset_counts()
        me = eager.train_step(b)
        assert _counts() == counted, i
        for k in me:
            assert torch.equal(mc[k], me[k]), (i, k)
        assert not _differing(_trainer_state(comp), _trainer_state(eager))
    (prog,) = comp._step_programs.values()
    assert prog.replays == 2 and prog.nodes > 0 and prog.capture_ms > 0
    assert counted[0]["backward.tc"] > 0 and counted[1]["gn_backward"] > 0
    if f0:
        assert me["loss_f0"] > 0


def test_train_step_programs_of_two_geometries_in_turns(dev, tmp_path):
    """Two batch geometries, their programs sharing one memory pool,
    replayed in alternating order: each step is the eager step's."""
    comp = _small_trainer(dev, str(tmp_path / "c"))
    eager = _small_trainer(dev, str(tmp_path / "e"))
    eager.compiled = False
    for i, (t, tp) in enumerate([(64, 48), (128, 64)] * 3):
        b = _train_batch(comp, i, t=t, tp=tp)
        mc, me = comp.train_step(b), eager.train_step(b)
        assert torch.equal(mc["loss"], me["loss"]), i
        assert torch.equal(mc["grad_norm"], me["grad_norm"]), i
    assert not _differing(_trainer_state(comp), _trainer_state(eager))
    assert sorted(p.replays for p in comp._step_programs.values()) == [2, 2]
    pools = {tuple(p.graph.pool()) for p in comp._step_programs.values()}
    assert len(pools) == 1


def test_train_step_failed_capture_raises(dev, tmp_path, monkeypatch):
    """A step body that synchronises cannot be captured: the call raises
    after its warm-up step and caches no program; the key captures once
    the body is capturable again."""
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2

    tr = _small_trainer(dev, str(tmp_path))
    b = _train_batch(tr, 0)
    forward = NaturalSpeech2.forward

    def synchronising(self, *a, **kw):
        torch.cuda.synchronize()
        return forward(self, *a, **kw)
    monkeypatch.setattr(NaturalSpeech2, "forward", synchronising)
    with pytest.raises(RuntimeError, match="capture failed"):
        tr.train_step(b)
    assert tr._step_programs == {}
    monkeypatch.undo()
    tr.train_step(b)
    tr.train_step(b)
    (prog,) = tr._step_programs.values()
    assert prog.replays == 1


def test_eval_program_replays_the_eager_eval(dev, tmp_path):
    """The eval sample's first call (warm-up and capture) and a replay give
    the eager eval's mel and waveform bit for bit, from the EMA copied into
    the eval model inside the graph: a step between two evals moves both
    alike."""
    import numpy as np

    comp = _small_trainer(dev, str(tmp_path / "c"), f0=True, vocos=True)
    eager = _small_trainer(dev, str(tmp_path / "e"), f0=True, vocos=True)
    eager.compiled = eager.eval_compiled = False
    got = []
    for i in range(2):
        for tr in (comp, eager):
            tr.train_step(_train_batch(tr, i))
            tr.train_step(_train_batch(tr, i + 10))
        got.append([tr.sample_eval(_gen(dev, 7)) for tr in (comp, eager)])
    for c, e in got:
        assert np.array_equal(c[0], e[0]) and np.array_equal(c[1], e[1])
    assert not np.array_equal(got[0][0][0], got[1][0][0])
    (prog,) = comp._eval_programs.values()
    assert prog.replays == 1 and not eager._eval_programs


def test_capturable_adamw_matches_the_eager_one(dev):
    """The step programs' AdamW (capturable: step counts and bias
    corrections on the card) against the eager one over three clipped
    steps: 1e-6 relative, the CPU test's optax bound."""
    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.train.trainer import (
        clip_by_global_norm, make_optimizer,
    )

    cfg = Config()
    g = _gen(dev, 5)
    shapes = [(256, 256, 3), (256,), (64, 100)]
    a = [torch.nn.Parameter(torch.randn(s, generator=g, device=dev))
         for s in shapes]
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    oa = make_optimizer(cfg, a)
    ob = make_optimizer(cfg, b, capturable=True)
    for i in range(3):
        for p, q in zip(a, b):
            p.grad = (30.0 if i == 1 else 0.01) * torch.randn(
                p.shape, generator=g, device=dev)
            q.grad = p.grad.clone()
        clip_by_global_norm([p.grad for p in a], 1.0)
        clip_by_global_norm([q.grad for q in b], 1.0)
        oa.step()
        ob.step()
        for p, q in zip(a, b):
            assert torch.allclose(q, p, rtol=1e-6, atol=1e-7)
    assert ob.state[b[0]]["step"].device == dev


def test_checkpoints_cross_between_the_card_and_the_cpu(dev, tmp_path):
    """A compiled Trainer's checkpoint resumes in a CPU Trainer (eager
    AdamW), and the CPU's in a card Trainer, which captures anew: step,
    both moments and the EMA equal; the resumed card Trainer's next step
    is the eager step's."""
    comp = _small_trainer(dev, str(tmp_path / "c"))
    for s in range(3):
        comp.train_step(_train_batch(comp, s))
    path = comp.save()
    cpu = _small_trainer(torch.device("cpu"), str(tmp_path / "cpu"))
    cpu.load(path=path)
    assert cpu.step == comp.step == 3
    assert not any(g["capturable"] for g in cpu.state.optimizer.param_groups)
    want = {part: {k: v.cpu() for k, v in d.items()}
            for part, d in _trainer_state(comp).items()}
    assert not _differing(_trainer_state(cpu), want)
    back = cpu.save(milestone=30)
    again = _small_trainer(dev, str(tmp_path / "again"))
    again.train_step(_train_batch(again, 9))     # a program to drop
    again.load(path=back)
    assert again._step_programs == {} and again.step == 3
    assert all(g["capturable"] for g in again.state.optimizer.param_groups)
    b = _train_batch(comp, 3)
    eager = _small_trainer(dev, str(tmp_path / "eager"))
    eager.compiled = False
    eager.load(path=back)
    m, e = again.train_step(b), eager.train_step(b)
    assert torch.equal(m["loss"], e["loss"])
    assert not _differing(_trainer_state(again), _trainer_state(eager))


@pytest.fixture
def process_group(dev):
    """A process group of this one process over the backend the test
    names (`tcp://localhost`, a free port), destroyed after it."""
    import socket

    import torch.distributed as dist

    def start(backend):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def test_group_step_program_replays_the_eager_group_step(
        dev, tmp_path, process_group):
    """NCCL, one process: three steps through the step program (the first
    a warm-up and capture, then two replays, the all-reduce in the graph)
    against three eager group steps of a second Trainer from the same
    seed: metrics and state bit for bit, each call counting one
    all-reduce of the flat gradient buffer as the eager step does; the
    eval's first call and a replay give the eager eval bit for bit."""
    import numpy as np

    from ns2vc_tpu_torch.parallel import mesh

    process_group("nccl")
    comp = _small_trainer(dev, str(tmp_path / "c"), vocos=True)
    eager = _small_trainer(dev, str(tmp_path / "e"), vocos=True)
    assert comp.distributed and comp.compiled and comp.eval_compiled
    eager.compiled = eager.eval_compiled = False
    n = sum(p.numel() for p in comp.model.parameters()) + 3
    for i in range(3):
        b = _train_batch(comp, i)
        got = []
        for tr in (comp, eager):
            mesh.reset_counters()
            m = tr.train_step(b)
            got.append((m, mesh.counters()))
        (mc, cc), (me, ce) = got
        assert cc == ce and ce["all_reduce_mean"] == {"calls": 1,
                                                      "bytes": 4 * n}, i
        for k in me:
            assert torch.equal(mc[k], me[k]), (i, k)
        assert not _differing(_trainer_state(comp), _trainer_state(eager))
    (prog,) = comp._step_programs.values()
    assert prog.replays == 2 and prog.nodes > 0
    evals = [[tr.sample_eval(_gen(dev, 7)) for tr in (comp, eager)]
             for _ in range(2)]
    for c, e in evals:
        assert np.array_equal(c[0], e[0]) and np.array_equal(c[1], e[1])
    (prog,) = comp._eval_programs.values()
    assert prog.replays == 1 and not eager._eval_programs
    comp.drop_programs()     # the graphs before the group's communicator


def test_gloo_group_step_stays_eager(dev, tmp_path, process_group):
    """gloo on a card reduces through host copies, which no graph holds:
    the step runs eagerly (an eager AdamW) and caches no program; the
    eval, which holds no collective at a model axis of one, is a
    program."""
    process_group("gloo")
    tr = _small_trainer(dev, str(tmp_path))
    assert tr.distributed and not tr.compiled and tr.eval_compiled
    assert not any(g["capturable"] for g in tr.state.optimizer.param_groups)
    m = tr.train_step(_train_batch(tr, 0))
    assert torch.isfinite(m["loss"]) and tr._step_programs == {}
