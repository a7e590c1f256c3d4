"""Tensor ops of the port: masking, attention, and the two hand-written
CUDA kernels (flash attention, fused resnet epilogue) with their plain
PyTorch versions. Importing builds nothing: nvcc runs at a kernel's first
CUDA call."""

from ns2vc_tpu_torch.ops.attention import multihead_attention
from ns2vc_tpu_torch.ops.masking import mask_to_bias, sequence_mask

__all__ = ["sequence_mask", "mask_to_bias", "multihead_attention"]
