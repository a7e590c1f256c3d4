"""Noise schedule, samplers and the model wrapper of the port."""

from ns2vc_tpu_torch.diffusion.samplers import (
    add_noise,
    ddim_sample,
    ddpm_sample,
    dpm_inverse,
    dpmpp_2m_sample,
    dpmpp_adaptive_sample,
    dpmpp_singlestep_sample,
    dynamic_thresholding,
    sample,
    thresholded_x0_fn,
    unipc_sample,
)
from ns2vc_tpu_torch.diffusion.schedule import NoiseSchedule
from ns2vc_tpu_torch.diffusion.wrappers import model_wrapper

__all__ = [
    "model_wrapper",
    "NoiseSchedule",
    "add_noise",
    "ddpm_sample",
    "ddim_sample",
    "dpm_inverse",
    "dpmpp_2m_sample",
    "dpmpp_adaptive_sample",
    "dpmpp_singlestep_sample",
    "dynamic_thresholding",
    "sample",
    "thresholded_x0_fn",
    "unipc_sample",
]
