"""Tensor ops of the port: masking, attention, and the two hand-written
CUDA kernels (flash attention, fused resnet epilogue) with their plain
PyTorch versions."""
