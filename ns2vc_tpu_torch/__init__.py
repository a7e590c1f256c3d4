"""ns2vc_tpu_torch: the PyTorch/CUDA port of ns2vc_tpu for one NVIDIA H100.

`ns2vc_tpu/` (JAX) is the reference the port is held against and stays as
it is. The port converts wav in to wav out: the front end (resampling,
log-mel, F0, ContentVec), then content features + a reference mel ->
encoders -> cross-attention K/V precompute -> a sampler over the UNet ->
Vocos -> 24 kHz waveform (optionally int16 PCM).

It also trains, on one card or data-parallel over torch.distributed (one
card per process): wav dir -> data/preprocess -> features -> data/dataset
loader (synced across processes) -> train/trainer (bf16 forward on f32
masters through both kernels' autograd Functions, one gradient
all-reduce per step, AdamW, EMA, spectrogram images) -> checkpoints Svc
serves. scripts/orbax_to_torch.py brings a JAX run's checkpoint over.

It also reconstructs 44.1 kHz audio from a log-mel and its F0 through the
NSF-HiFiGAN vocoder (models/nsf_hifigan.py, loaded from the reference
checkpoint; scripts/torch_reconstruct_nsf.py).

Layer map (each subpackage exports the JAX package's public names):
    infer/      Svc: bucketed, masked batch serving, RealTimeVC, the
                MicroBatcher and the CLI
    data/, train/  preprocess, the training data loader (and its schedule
                synced across processes), the trainer and its CLI
    parallel/   the process group, the ('data', 'model') mesh, the batch
                layout, the all-reduce and the parameter placements
    models/     encoders, UNet1D denoiser, diffusion core, the vocoders
                (Vocos; NSF-HiFiGAN with its discriminators and GAN
                losses), LoRA, the encoder op registry
    diffusion/  noise schedule, the samplers, the model wrapper
    ops/        masking, attention, and the two hand-written CUDA kernels
                (csrc/): flash attention (K1) and the fused
                GroupNorm -> SiLU -> conv-k3 resnet epilogue (K2), each
                with a bf16 tensor-core route and an f32 3xTF32 route
    audio/, features/  resampling, STFT / log-mel / iSTFT, host F0 and
                slicing, ContentVec, CREPE
    native/     the C++ DIO F0 tracker (ctypes)
    convert.py  JAX (flax) parameter trees -> state dicts; seeded init
    config.py, utils/  configuration, reference-checkpoint converter, wav I/O,
                checkpoint mixing, plotting

Importing the package builds nothing: the kernels are compiled by nvcc at
their first CUDA call (ops/_build.py), the host DIO library by g++ at its
first call (native/). It imports no JAX and nothing of `ns2vc_tpu`: the
numpy-only modules it shares with the JAX package (config, the reference
checkpoint converter, the F0 trackers, the Slicer, wav I/O, the DIO) are
copies of its own, each naming the file it mirrors.
"""

__version__ = "0.1.0"
