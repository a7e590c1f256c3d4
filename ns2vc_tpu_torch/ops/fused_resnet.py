"""Fused resnet epilogue: GroupNorm(+FiLM) -> SiLU -> conv k3 (kernel K2).

Replaces `ns2vc_tpu/ops/pallas_resnet.py::affine_silu_conv1d` (the Pallas
TPU kernel) and its wrapper `gn_silu_conv1d`. Once the GroupNorm statistics
are known, GroupNorm and the FiLM modulation fold into one per-(batch,
channel) affine, so the epilogue is

    y = conv1d_k3_SAME(silu(x * a + b), w) + bias,   a, b of shape (B, C).

`gn_silu_conv1d` computes the statistics and the fold as plain f32 tensor
reductions (as the JAX wrapper leaves them to XLA) and keeps a and b in f32
(the JAX wrapper rounds them to x's dtype). `affine_silu_conv1d` dispatches
on the device of x and on nothing else: a CPU tensor runs
`affine_silu_conv1d_plain`, a CUDA tensor launches `csrc/gn_silu_conv1d.cu`
or raises. The CUDA source note says what bounds the kernel on the H100 and
how its design answers that.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ns2vc_tpu_torch.ops import _build


def affine_silu_conv1d_plain(x: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, w: torch.Tensor,
                             bias: torch.Tensor) -> torch.Tensor:
    """x (B, T, C), a/b (B, C) f32, w (Co, C, 3) torch Conv1d layout,
    bias (Co,) -> (B, T, Co) in x's dtype; computed in f32."""
    h = F.silu(x.float() * a[:, None, :] + b[:, None, :])
    y = F.conv1d(h.transpose(1, 2), w.float(), bias.float(), padding=1)
    return y.transpose(1, 2).to(x.dtype)


def affine_silu_conv1d(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y = conv1d_k3_SAME(silu(x * a + b), w) + bias. On CUDA: x, w, bias
    contiguous and of one dtype (f32 or bf16); a, b contiguous f32."""
    if x.device.type == "cpu":
        return affine_silu_conv1d_plain(x, a, b, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"affine_silu_conv1d: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"affine_silu_conv1d: x must be (B, T, C), got "
                         f"{tuple(x.shape)}")
    bsz, t, c = x.shape
    co = w.shape[0]
    if w.shape != (co, c, 3) or bias.shape != (co,) \
            or a.shape != (bsz, c) or b.shape != (bsz, c):
        raise ValueError(
            f"affine_silu_conv1d: shapes x {tuple(x.shape)} a "
            f"{tuple(a.shape)} b {tuple(b.shape)} w {tuple(w.shape)} bias "
            f"{tuple(bias.shape)}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype \
            or bias.dtype != x.dtype:
        raise ValueError(f"affine_silu_conv1d: dtypes x {x.dtype} w {w.dtype}"
                         f" bias {bias.dtype}; f32 or bf16, all alike")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("affine_silu_conv1d: a and b must be f32")
    if not all(v.is_contiguous() for v in (x, a, b, w, bias)):
        raise ValueError("affine_silu_conv1d: inputs must be contiguous")
    if any(v.device != x.device for v in (a, b, w, bias)):
        raise ValueError("affine_silu_conv1d: inputs on different devices")
    if min(bsz, t, c, co) < 1 or bsz > 65535:
        raise ValueError(f"affine_silu_conv1d: unsupported shape "
                         f"{tuple(x.shape)} -> {co}")
    _build.require_current_device(x)
    lib = _build.library()
    y = torch.empty((bsz, t, co), dtype=x.dtype, device=x.device)
    affine_silu_conv1d.launches += 1
    err = lib.ns2vc_affine_silu_conv1d(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
        bias.data_ptr(), y.data_ptr(), _build.DTYPE_CODES[x.dtype],
        bsz, t, c, co, _build.stream_of(x))
    _build.check(err, "affine_silu_conv1d")
    return y


affine_silu_conv1d.launches = 0


def group_norm_affine(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, groups: int, eps: float,
                      film_scale: torch.Tensor | None = None,
                      film_shift: torch.Tensor | None = None):
    """GroupNorm(groups, eps) statistics of x (B, T, C) folded with
    gamma/beta and an optional FiLM (h*(1+scale)+shift, scale/shift (B, C))
    into the per-(batch, channel) f32 affine (a, b)."""
    bsz, t, c = x.shape
    xg = x.float().reshape(bsz, t, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0)   # (B, G)
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(c // groups, dim=1) * gamma.float()
    b = beta.float() - mean.repeat_interleave(c // groups, dim=1) * a
    if film_scale is not None:
        s = 1.0 + film_scale.float()
        a = a * s
        b = b * s + film_shift.float()
    return a.contiguous(), b.contiguous()


def gn_silu_conv1d(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   w: torch.Tensor, bias: torch.Tensor, groups: int = 8,
                   eps: float = 1e-5, film_scale: torch.Tensor | None = None,
                   film_shift: torch.Tensor | None = None) -> torch.Tensor:
    """GroupNorm(+FiLM) -> SiLU -> conv k3 SAME on (B, T, C), w in torch
    Conv1d layout (Co, C, 3)."""
    a, b = group_norm_affine(x, gamma, beta, groups, eps, film_scale,
                             film_shift)
    return affine_silu_conv1d(x, a, b, w, bias)
