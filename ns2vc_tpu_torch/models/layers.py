"""Channels-last wrappers of torch's Conv1d and GroupNorm.

The port keeps the JAX package's (B, T, C) layout at every module boundary;
these layers take and return (B, T, C) and keep torch's parameter names and
shapes (Conv1d weight (Co, C/groups, K))."""

from __future__ import annotations

import torch
from torch import nn


class Conv1d(nn.Conv1d):
    """nn.Conv1d on (B, T, C), in the common type of the input and the
    parameters (flax's promotion). `padding` defaults to SAME for odd
    kernels."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int | None = None,
                 groups: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=(kernel_size - 1) // 2 if padding is None
                         else padding, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.transpose(1, 2).to(dt),
                                  self.weight.to(dt), b).transpose(1, 2)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm on (B, T, C); torch computes bf16 statistics in f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)
