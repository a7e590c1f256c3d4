"""Models of the port: encoders, UNet denoiser, diffusion core, Vocos.

NSF-HiFiGAN (`models/nsf_hifigan.py`) is reached by its module path, as in
the JAX package, whose `models.__all__` does not name it either.
"""

from ns2vc_tpu_torch.models.diffusion import (
    DiffusionEncoder,
    NaturalSpeech2,
    PreModel,
    generate_mel,
    make_x0_fn,
)
from ns2vc_tpu_torch.models.encoders import (
    AttentionPooling,
    F0Predictor,
    PhoneEncoder,
    PromptEncoder,
    TextTimeEmbedding,
)
from ns2vc_tpu_torch.models.unet import UNet1DConditionModel

__all__ = [
    "PhoneEncoder",
    "PromptEncoder",
    "F0Predictor",
    "TextTimeEmbedding",
    "AttentionPooling",
    "UNet1DConditionModel",
    "NaturalSpeech2",
    "PreModel",
    "DiffusionEncoder",
    "generate_mel",
    "make_x0_fn",
]
