"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: without a CUDA device every test here skips (the kernels
have no CPU mode). This file imports no JAX, so it also runs where JAX is
not installed; the repository's conftest imports JAX, hence on such a
machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

f32 runs with TF32 off. Tolerances: K1 2e-5 in f32 (the JAX suite's bound
for the Pallas kernel); K2 1e-4 in f32 (sums of up to 3*1024 O(1)
products in another order); in bf16, 3e-2 for K1 (the plain version rounds
the probabilities to bf16 before the PV product, the kernel keeps f32) and
1e-2 of the output's scale for K2 (one bf16 rounding of f32 sums taken in
another order); UNet card vs CPU 5e-4 (the JAX suite's UNet bound).
"""

import pytest
import torch

from ns2vc_tpu_torch.ops.attention import split_heads
from ns2vc_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain,
)
from ns2vc_tpu_torch.ops.fused_resnet import (
    affine_silu_conv1d, affine_silu_conv1d_plain, gn_silu_conv1d,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,tq,tk,d,valid", [
    (2, 8, 200, 200, 16, None),    # UNet self-attention, level 0 width
    (2, 8, 56, 160, 48, 100),      # cross-attention with key padding
    (3, 1, 1, 161, 100, None),     # ref_enc pooling
    (2, 64, 1, 161, 4, None),      # add_embedding pooling
    (1, 2, 130, 65, 128, 64),      # widest head dim, ragged tiles
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
    got = flash_attention(q, k, v, bias)
    assert flash_attention.launches == n0 + 1
    want = flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= atol


def test_flash_attention_fully_masked_row_is_finite(dev):
    g = _gen(dev, 1)
    q = torch.randn(2, 2, 40, 32, generator=g, device=dev)
    bias = torch.zeros(2, 70, device=dev)
    bias[1] = -1e30
    out = flash_attention(q, q[:, :, :1].expand(2, 2, 70, 32).contiguous(),
                          q[:, :, :1].expand(2, 2, 70, 32).contiguous(), bias)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


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
    got = gn_silu_conv1d(x, gamma, beta, w, bias, 8, 1e-5, s, sh)
    assert affine_silu_conv1d.launches == n0 + 1
    want = gn_silu_conv1d(x.cpu(), gamma.cpu(), beta.cpu(), w.cpu(),
                          bias.cpu(), 8, 1e-5,
                          None if s is None else s.cpu(),
                          None if sh is None else sh.cpu())
    torch.cuda.synchronize()
    err = (got.float().cpu() - want.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else \
        1e-2 * max(1.0, want.float().abs().max().item())
    assert got.dtype == dtype and err <= tol


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
