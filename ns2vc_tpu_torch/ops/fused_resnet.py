"""Fused resnet epilogue: GroupNorm(+FiLM) -> SiLU -> conv k3 (kernel K2).

Replaces `ns2vc_tpu/ops/pallas_resnet.py::affine_silu_conv1d` (the Pallas
TPU kernel) and its wrapper `gn_silu_conv1d`. Once the GroupNorm statistics
are known, GroupNorm and the FiLM modulation fold into one per-(batch,
channel) affine, so the epilogue is

    y = conv1d_k3_SAME(silu(x * a + b), w) + bias,   a, b of shape (B, C).

`gn_silu_conv1d` computes the statistics and the fold as plain f32 tensor
reductions (as the JAX wrapper leaves them to XLA) and keeps a and b in f32
(the JAX wrapper rounds them to x's dtype). `affine_silu_conv1d` routes by
`resnet_route(device, dtype)` and on nothing else:

    cpu        -> `affine_silu_conv1d_plain`
    cuda, bf16 -> "tc": `csrc/gn_silu_conv1d_tc.cu`, an implicit GEMM on the
                  tensor cores (mma.sync bf16 -> f32)
    cuda, f32  -> "f32tc": `csrc/gn_silu_conv1d.cu`, the same implicit GEMM
                  on TF32 tensor cores in three passes (3xTF32: each
                  operand's TF32 big and small halves), at f32 accuracy

Both run over weights packed once per weight tensor by `pack_conv_weight`
(kept while the tensor lives, keyed by its storage and version; f32
weights packed as their big and small TF32 planes), split over the input
channels by `plan_tc` when the output tiles alone would not fill the card.
A CUDA tensor launches one of the kernels or raises. `affine_silu_conv1d.
launches` counts every launch, `affine_silu_conv1d.route_launches` each
route's. The CUDA source notes say what bounds each kernel on the H100 and
how its design answers that.

Training: when grad is enabled and an input requires it, a CUDA call goes
through an autograd Function whose forward is the same launch and whose
backward is `affine_silu_conv1d_backward`, written out in f32 torch ops
(the activation is recomputed, the conv's input and weight gradients are
one `convolution_backward`). Each backward adds one to
`affine_silu_conv1d.backward_calls[route]`. The packed weights are
made from `w.detach()`: w's gradient comes from the backward, never
through the packed copy. `group_norm_affine` is torch ops, so autograd
carries the GroupNorm and FiLM gradients through a and b.
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

from ns2vc_tpu_torch.ops import _build

# the kernels' tile: frames, output channels, input channels per chunk
# (csrc/gn_silu_conv1d_tc.cu kBM, kBN, kBK; gn_silu_conv1d.cu takes chunks
# of F32_BK)
TC_BM, TC_BN, TC_BK = 64, 64, 32
F32_BK = 16


def resnet_route(device: torch.device | str, dtype: torch.dtype) -> str:
    """'plain' (CPU), 'tc' (bf16 kernel) or 'f32tc' (the 3xTF32 kernel,
    which takes f32; the checks below refuse any other dtype); raises for a
    device that is neither CPU nor CUDA."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise ValueError(f"affine_silu_conv1d: unsupported device {device}")
    return "tc" if dtype == torch.bfloat16 else "f32tc"


def chunk_width(dtype: torch.dtype) -> int:
    """Input channels per chunk of the kernel that takes `dtype`."""
    return TC_BK if dtype == torch.bfloat16 else F32_BK


def plan_tc(bsz: int, t: int, c: int, co: int,
            bk: int = TC_BK) -> tuple[int, int]:
    """(splits, chunks per split) of a kernel's channel loop over its
    `bk`-channel chunks: the fewest splits whose (T, Co, B) output tiles
    times splits reach one block per SM of the H100 (one split when the
    tiles alone do), or one chunk per split where even that falls short.
    The chunks are dealt evenly and no split is left empty."""
    tiles = -(-t // TC_BM) * -(-co // TC_BN) * bsz
    n_chunks = -(-c // bk)
    for want in range(1, n_chunks + 1):
        cps = -(-n_chunks // want)
        splits = -(-n_chunks // cps)   # no empty split
        if tiles * splits >= _build.H100_SMS:
            return splits, cps
    return n_chunks, 1


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 stored mantissa bits), ties away
    from zero, as f32: the rounding of `cvt.rna.tf32.f32`."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """torch Conv1d weight (Co, C, 3) -> the kernels' packed layout,
    contiguous along C, zero past (Co, C), Co_pad and C_pad rounded up to
    TC_BN and the chunk width: tap k's (Co, C) matrix multiplies the frames
    shifted by k - 1. bf16: (3, Co_pad, C_pad). f32: (2, 3, Co_pad, C_pad),
    the big and small TF32 halves of 3xTF32 (big = w rounded to TF32, small
    = the exact remainder rounded again), so the kernel splits no weight."""
    co, c, _ = w.shape
    bk = chunk_width(w.dtype)
    shape = (3, -(-co // TC_BN) * TC_BN, -(-c // bk) * bk)
    taps = w.detach().permute(2, 0, 1)
    if w.dtype == torch.bfloat16:
        packed = torch.zeros(shape, dtype=torch.bfloat16, device=w.device)
        packed[:, :co, :c] = taps
        return packed
    packed = torch.zeros((2, *shape), dtype=torch.float32, device=w.device)
    big = tf32_round(taps.float().contiguous())
    packed[0, :, :co, :c] = big
    packed[1, :, :co, :c] = tf32_round(taps.float() - big)
    return packed


_PACKED: dict[int, tuple] = {}   # id(w) -> (key, packed), while w lives


def packed_weight(w: torch.Tensor) -> torch.Tensor:
    """`pack_conv_weight(w)`, computed once per weight tensor and kept while
    the tensor lives; recomputed when its storage or version (an in-place
    update) changes."""
    key = (w.data_ptr(), w._version, w.dtype, tuple(w.shape))
    hit = _PACKED.get(id(w))
    if hit is None or hit[0] != key:
        if hit is None:
            weakref.finalize(w, _PACKED.pop, id(w), None)
        hit = _PACKED[id(w)] = (key, pack_conv_weight(w))
    return hit[1]


def affine_silu_conv1d_plain(x: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, w: torch.Tensor,
                             bias: torch.Tensor) -> torch.Tensor:
    """x (B, T, C), a/b (B, C) f32, w (Co, C, 3) torch Conv1d layout,
    bias (Co,) -> (B, T, Co) in x's dtype; computed in f32 (f64 for f64
    inputs)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    h = F.silu(x.to(acc) * a.to(acc)[:, None, :] + b.to(acc)[:, None, :])
    y = F.conv1d(h.transpose(1, 2), w.to(acc), bias.to(acc), padding=1)
    return y.transpose(1, 2).to(x.dtype)


def affine_silu_conv1d_backward(x: torch.Tensor, a: torch.Tensor,
                                b: torch.Tensor, w: torch.Tensor,
                                bias: torch.Tensor, dy: torch.Tensor):
    """(dx, da, db, dw, dbias) of y = conv1d_k3_SAME(silu(x * a + b), w) +
    bias given dy (B, T, Co), in f32 (f64 for f64 inputs), each cast to its
    input's dtype:
        z = x a + b,  s = sigmoid(z),  h = z s
        dbias = sum dy;  dw, dh = the k=3 conv's weight and input gradients
        dz = dh s (1 + z (1 - s));  dx = dz a,  da = sum_T dz x,
        db = sum_T dz."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc)
    z = xf * a.to(acc)[:, None, :] + b.to(acc)[:, None, :]
    s = torch.sigmoid(z)
    h = z * s
    dh, dw, dbias = torch.ops.aten.convolution_backward(
        dy.to(acc).transpose(1, 2), h.transpose(1, 2), w.to(acc),
        [w.shape[0]], [1], [1], [1], False, [0], 1, [True, True, True])
    dz = dh.transpose(1, 2) * (s * (1.0 + z * (1.0 - s)))
    return ((dz * a.to(acc)[:, None, :]).to(x.dtype),
            (dz * xf).sum(dim=1).to(a.dtype), dz.sum(dim=1).to(b.dtype),
            dw.to(w.dtype), dbias.to(bias.dtype))


class _AffineSiluConv1dFn(torch.autograd.Function):
    """The kernel's launch under autograd; backward in f32 torch ops."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias):
        y, route = _launch(x, a, b, w, bias)
        ctx.save_for_backward(x, a, b, w, bias)
        ctx.route = route
        return y

    @staticmethod
    def backward(ctx, dy):
        affine_silu_conv1d.backward_calls[ctx.route] += 1
        return affine_silu_conv1d_backward(*ctx.saved_tensors, dy)


def affine_silu_conv1d(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y = conv1d_k3_SAME(silu(x * a + b), w) + bias. On CUDA: x, w, bias
    contiguous and of one dtype (f32 or bf16); a, b contiguous f32;
    differentiable in every input."""
    if resnet_route(x.device, x.dtype) == "plain":
        return affine_silu_conv1d_plain(x, a, b, w, bias)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, a, b, w, bias)):
        return _AffineSiluConv1dFn.apply(x, a, b, w, bias)
    return _launch(x, a, b, w, bias)[0]


def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            w: torch.Tensor, bias: torch.Tensor) -> tuple[torch.Tensor, str]:
    """Check the inputs and launch the kernel of their route: (y, route)."""
    route = resnet_route(x.device, x.dtype)
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
    if x.dtype not in _build.KERNEL_DTYPES or w.dtype != x.dtype \
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
    affine_silu_conv1d.route_launches[route] += 1
    wp = packed_weight(w)
    splits, cps = plan_tc(bsz, t, c, co, chunk_width(x.dtype))
    ws = None if splits == 1 else torch.empty(     # bsz * splits < 132 * 132
        (splits, bsz, t, co), dtype=torch.float32, device=x.device)
    vec = all(_build.aligned16(v) for v in (x, a, b))
    fn = (lib.ns2vc_affine_silu_conv1d_tc if route == "tc"
          else lib.ns2vc_affine_silu_conv1d_f32tc)
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), wp.data_ptr(),
             bias.data_ptr(), y.data_ptr(),
             None if ws is None else ws.data_ptr(), bsz, t, c, co,
             wp.shape[-1], wp.shape[-2], cps, splits, int(vec),
             _build.stream_of(x))
    _build.check(err, f"affine_silu_conv1d ({route})")
    return y, route


affine_silu_conv1d.launches = 0
affine_silu_conv1d.route_launches = {"f32tc": 0, "tc": 0}
affine_silu_conv1d.backward_calls = {"f32tc": 0, "tc": 0}


def reset_launches() -> None:
    affine_silu_conv1d.launches = 0
    for counts in (affine_silu_conv1d.route_launches,
                   affine_silu_conv1d.backward_calls):
        for key in counts:
            counts[key] = 0


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
