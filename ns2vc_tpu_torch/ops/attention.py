"""Multi-head attention core (counterpart of ns2vc_tpu/ops/attention.py).

`multihead_attention` is the projected attention of the encoder layers, the
F0 predictor, the attention pooling, the UNet attention blocks and the
encoder op registry; `streaming_attention` attends a chunk over a
fixed-capacity K/V cache. Both route each call by its bias and head dim
(`attention`):

    no bias, or a key-padding bias (B or 1, 1, 1, Tk), at D <= 128
        -> `ops/flash_attention.py::flash_attention`: kernel K1 on a CUDA
           tensor, its plain version on a CPU tensor
    a bias that varies along the queries (banded, Gaussian, causal), or
    D > 128
        -> `flash_attention_plain` with the bias broadcast, counted in
           `flash_attention.route_launches["plain"]`

as the JAX package computes the second kind in XLA and gives Pallas only the
first. The route follows from the call's shapes alone; no kernel failure is
caught. The JAX package's XLA fusion experiments and their environment knobs
are not carried over.
"""

from __future__ import annotations

import torch

from ns2vc_tpu_torch.ops.flash_attention import (
    MAX_HEAD_DIM, flash_attention, flash_attention_plain,
)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, C) -> (B, H, T, C/H), a strided view where x allows one."""
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def is_key_padding(bias: torch.Tensor | None) -> bool:
    """True for no bias or one that varies only along the keys."""
    return bias is None or (bias.dim() == 4
                            and bias.shape[1] == bias.shape[2] == 1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor | None = None,
              scale: float | None = None) -> torch.Tensor:
    """q (B, H, Tq, D), k/v (B, H, Tk, D), bias broadcasting against (B, H,
    Tq, Tk), routed as the module docstring says."""
    if is_key_padding(bias) and q.shape[-1] <= MAX_HEAD_DIM:
        if bias is not None:
            b, tk = q.shape[0], k.shape[2]
            bias = bias.reshape(bias.shape[0], tk)
            if bias.shape[0] != b or bias.dtype != torch.float32 \
                    or not bias.is_contiguous():
                bias = bias.float().expand(b, tk).contiguous()
        return flash_attention(q, k, v, bias, scale)
    flash_attention.route_launches["plain"] += 1
    if bias is not None and bias.dim() < 4:   # numpy-style broadcasting
        bias = bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape))
    return flash_attention_plain(q, k, v, bias, scale)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, bias: torch.Tensor | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Projected multi-head attention on (B, T, C) tensors. `bias` is
    additive and broadcasts against (B, H, Tq, Tk): (B, 1, 1, Tk) for key
    padding."""
    out = attention(split_heads(q, num_heads), split_heads(k, num_heads),
                    split_heads(v, num_heads), bias, scale)
    return merge_heads(out)


# -- streaming over a fixed-capacity K/V cache ------------------------------


def init_kv_cache(batch: int, num_heads: int, head_dim: int, capacity: int,
                  dtype=torch.float32, device=None) -> dict:
    """A streaming K/V cache: buffers (B, H, capacity, D) and the fill
    index `idx` (a host int)."""
    shape = (batch, num_heads, capacity, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "idx": 0}


def streaming_attention(q: torch.Tensor, k_new: torch.Tensor | None,
                        v_new: torch.Tensor | None, cache: dict,
                        num_heads: int, static_kv: bool = False,
                        bias: torch.Tensor | None = None,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, dict]:
    """One streaming step: write the projected K/V chunk (B, S, C) at the
    fill index and attend q (B, Sq, C) over every filled position; returns
    (out (B, Sq, C), the new cache). The cache given is not modified.
    static_kv=True reads K/V from the cache and ignores k_new/v_new (the
    encoder-decoder mode). The caller keeps idx + S <= capacity. The fill
    index becomes a key-padding bias; an extra `bias` adds to it, and one
    that varies along the queries sends the call to the plain route."""
    idx = cache["idx"]
    if static_kv:
        k_buf, v_buf, new_idx = cache["k"], cache["v"], idx
    else:
        s = k_new.shape[1]
        if idx + s > cache["k"].shape[2]:
            raise ValueError(f"streaming_attention: {idx} + {s} positions "
                             f"exceed the capacity {cache['k'].shape[2]}")
        pos = torch.arange(idx, idx + s, device=cache["k"].device)
        k_buf = cache["k"].index_copy(
            2, pos, split_heads(k_new, num_heads).to(cache["k"].dtype))
        v_buf = cache["v"].index_copy(
            2, pos, split_heads(v_new, num_heads).to(cache["v"].dtype))
        new_idx = idx + s
    cap = k_buf.shape[2]
    fill = torch.zeros(1, 1, 1, cap, device=k_buf.device)
    fill[..., new_idx:] = -1e4
    if bias is not None:
        fill = fill + bias
    out = attention(split_heads(q, num_heads).to(k_buf.dtype), k_buf, v_buf,
                    fill, scale)
    return merge_heads(out), {"k": k_buf, "v": v_buf, "idx": new_idx}
