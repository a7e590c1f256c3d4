"""Flash attention forward with an additive key bias (kernel K1).

Replaces `ns2vc_tpu/ops/pallas_attention.py::flash_attention`, the Pallas
TPU kernel. The CUDA kernel is `csrc/flash_attention.cu`; its source note
says what bounds it on the H100 and how its design answers that.

`flash_attention` dispatches on the device of its inputs and on nothing
else: a CPU tensor runs `flash_attention_plain`, a CUDA tensor launches the
kernel or raises. The kernel reads q/k/v through their (batch, head, seq)
strides, so the (B, H, T, D) views that `ops/attention.py::split_heads`
makes of the (B, T, H*D) projections go in without a transpose copy, and
the output is written as a (B, Tq, H, D) buffer whose (B, H, Tq, D) view is
returned, so `merge_heads` is a free reshape.
"""

from __future__ import annotations

import torch

from ns2vc_tpu_torch.ops import _build

MAX_HEAD_DIM = 128


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """softmax(q.k^T * scale + bias) . v, the JAX package's XLA attention
    core (ops/attention.py::scaled_dot_product_attention): logits and
    softmax in f32, probabilities cast to v's dtype before the PV product,
    which accumulates in f32. q (B, H, Tq, D), k/v (B, H, Tk, D), bias
    (B, Tk) additive (0 keep / -1e4 drop)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, H, Tq, D), k/v (B, H, Tk, D), bias (B, Tk) -> (B, H, Tq, D)
    in q's dtype. On CUDA: f32 or bf16, D <= 128, unit stride on D."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != (b, h, tk, d):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes f32 or bf16, all alike")
    if not 1 <= d <= MAX_HEAD_DIM or tq < 1 or tk < 1 or b * h > 65535:
        raise ValueError(f"flash_attention: unsupported shape B*H={b * h} "
                         f"Tq={tq} Tk={tk} D={d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head dim must have unit stride")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if bias is not None:
        if bias.shape != (b, tk) or bias.dtype != torch.float32 \
                or not bias.is_contiguous() or bias.device != q.device:
            raise ValueError(f"flash_attention: bias must be contiguous f32 "
                             f"({b}, {tk}) on {q.device}, got "
                             f"{tuple(bias.shape)} {bias.dtype}")
    _build.require_current_device(q)
    lib = _build.library()
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    o = out.permute(0, 2, 1, 3)  # (B, H, Tq, D) view
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    flash_attention.launches += 1
    err = lib.ns2vc_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), o.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, h, tq, tk, d, *strides, float(scale),
        _build.stream_of(q))
    _build.check(err, "flash_attention")
    return o


flash_attention.launches = 0
