"""ns2vc_tpu_torch: the PyTorch/CUDA port of ns2vc_tpu for one NVIDIA H100.

`ns2vc_tpu/` (JAX) is the reference the port is held against and stays as
it is. This first slice is the voice-conversion serving path: content
features + a reference mel -> encoders -> cross-attention K/V precompute ->
UniPC over the UNet -> Vocos -> 24 kHz waveform (optionally int16 PCM).

Layer map:
    infer/      Svc: bucketed, masked batch serving
    models/     encoders, UNet1D denoiser, diffusion core, Vocos
    diffusion/  noise schedule + UniPC sampler
    ops/        masking, attention, and the two hand-written CUDA kernels
                (csrc/): flash attention (K1) and the fused
                GroupNorm -> SiLU -> conv-k3 resnet epilogue (K2)
    convert.py  JAX (flax) parameter trees -> state dicts; seeded init

Importing the package builds nothing: the kernels are compiled by nvcc at
their first CUDA call (ops/_build.py). It imports no JAX; the one module of
`ns2vc_tpu` it uses is the dataclass-only `ns2vc_tpu.config`.
"""

__version__ = "0.1.0"
