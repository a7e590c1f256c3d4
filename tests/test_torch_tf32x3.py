"""The 3xTF32 arithmetic of the port's f32 kernels, emulated on the CPU.

`csrc/flash_attention.cu` (K1) and `csrc/gn_silu_conv1d.cu` (K2) take f32
inputs to the TF32 tensor cores in three passes: each operand x is split
into big = x rounded to TF32 (`cvt.rna.tf32.f32`: 10 stored mantissa bits,
to nearest, ties away from zero) and small = (x - big) rounded again, and
each product is big.big + big.small + small.big, exact in f32 and summed
in f32. Here that arithmetic runs in torch on the CPU (the rounding by bit
masking, each pass an f32 matmul of TF32 values) at K2's widest geometry
(C = Co = 1024, T = 64) and at K1's ContentVec geometry (1, 12, 400, 64),
and is held against the JAX package's Pallas kernels, run as its own tests
run them (interpret mode, f32 at `highest` precision): 3e-5 for K2 and
2e-5 for K1, the JAX suite's bounds for those kernels. One TF32 pass
misses both bounds. The package has no emulation path: this pins down the
kernels' design where no card is.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from ns2vc_tpu.ops.pallas_attention import flash_attention as jax_flash
from ns2vc_tpu.ops.pallas_resnet import affine_silu_conv1d as jax_resnet
from ns2vc_tpu_torch.ops.fused_resnet import tf32_round

K1_ATOL, K2_ATOL = 2e-5, 3e-5


def rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as cvt.rna.tf32.f32 rounds: add half of the 13 dropped
    bits' range to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: three TF32 products, f32 sums."""
    ab, bb = rna(a), rna(b)
    as_, bs = rna(a - ab), rna(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def matmul_1x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return rna(a) @ rna(b)


def test_rounding_is_cvt_rna():
    """Ties go away from zero, the halves are TF32 and sum to x within
    2^-22 of |x|, and the packed weights' rounding is the same."""
    ulp = 2.0 ** -10   # TF32's step in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 0.0, -0.0])
    assert rna(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 0.0, -0.0]
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32)) * 10.0 ** torch.randint(
        -8, 8, (100_000,), generator=torch.Generator().manual_seed(0))
    big = rna(r)
    small = rna(r - big)
    for h in (big, small):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    assert ((big + small - r).abs() <= 2.0 ** -22 * r.abs()).all()
    assert torch.equal(tf32_round(r), big)


def _k2_case():
    r = np.random.default_rng(1)
    b, t, c, co = 2, 64, 1024, 1024
    x = r.standard_normal((b, t, c)).astype(np.float32)
    a = (1 + 0.1 * r.standard_normal((b, c))).astype(np.float32)
    off = (0.1 * r.standard_normal((b, c))).astype(np.float32)
    w = (r.standard_normal((3, c, co)) / np.sqrt(3 * c)).astype(np.float32)
    bias = (0.1 * r.standard_normal(co)).astype(np.float32)
    want = np.asarray(jax_resnet(*map(jnp.asarray, (x, a, off, w, bias)),
                                 interpret=True))
    return (x, a, off, w, bias), want


def _k2_emulated(x, a, off, w, bias, matmul):
    """The kernel's implicit GEMM: the activation in f32, the three taps
    as row offsets 0, 1, 2 of the zero-padded activated frames."""
    xt, at, bt = map(torch.from_numpy, (x, a, off))
    v = xt * at[:, None, :] + bt[:, None, :]
    h = F.pad(v / (1.0 + torch.exp(-v)), (0, 0, 1, 1))
    t = x.shape[1]
    y = sum(matmul(h[:, k:k + t], torch.from_numpy(w[k])) for k in range(3))
    return (y + torch.from_numpy(bias)).numpy()


def _k1_case():
    r = np.random.default_rng(2)
    q, k, v = (r.standard_normal((1, 12, 400, 64)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)),
                                interpret=True))
    return (q, k, v), want


def _k1_emulated(q, k, v, matmul):
    """softmax(q.k^T * scale) . v with both products taken as the kernel
    takes them (the softmax in f32; the kernel's online form only reorders
    its f32 sums)."""
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    s = matmul(qt, kt.transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (matmul(p, vt) / p.sum(dim=-1, keepdim=True)).numpy()


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_3xtf32_holds_the_f32_bounds(kernel):
    if kernel == "K2":
        args, want = _k2_case()
        emulate, tol = _k2_emulated, K2_ATOL
    else:
        args, want = _k1_case()
        emulate, tol = _k1_emulated, K1_ATOL
    err3 = np.abs(emulate(*args, matmul_3x) - want).max()
    err1 = np.abs(emulate(*args, matmul_1x) - want).max()
    assert err3 <= tol < err1, (err3, err1)
    assert err3 <= err1 / 20
