"""NaturalSpeech2-style diffusion VC core (counterpart of
ns2vc_tpu/models/diffusion.py): PreModel, DiffusionEncoder,
`NaturalSpeech2.forward` (the training objective), `.encode` / `.denoise`
/ `.precompute_conditioning`, and `generate_mel`.

Batch convention (fixed shapes, mask-disciplined):
    c      (B, T, 256)   contentvec, frame-expanded
    refer  (B, Tp, 100)  reference log-mel (the prompt)
    spec   (B, T, 100)   target log-mel (training)
    lengths, refer_lengths (B,)
The F0-predictor branch is a later slice.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ns2vc_tpu_torch.config import Config
from ns2vc_tpu_torch.diffusion.samplers import sample
from ns2vc_tpu_torch.diffusion.schedule import NoiseSchedule
from ns2vc_tpu_torch.models.encoders import (
    PhoneEncoder, PromptEncoder, TextTimeEmbedding,
)
from ns2vc_tpu_torch.models.unet import UNet1DConditionModel
from ns2vc_tpu_torch.ops.masking import sequence_mask


class PreModel(nn.Module):
    """Speaker pooling + prompt/content encoders."""

    def __init__(self, cfg: Config):
        super().__init__()
        pe, pr = cfg.phoneme_encoder, cfg.prompt_encoder
        self.ref_enc = TextTimeEmbedding(pr.in_channels, pr.in_channels, 1)
        self.prompt_encoder = PromptEncoder(
            pr.in_channels, pr.hidden_channels, pr.out_channels, pr.n_layers,
            pr.p_dropout, pr.n_heads, pr.ffn_kernel)
        self.phoneme_encoder = PhoneEncoder(
            pe.in_channels, pe.hidden_channels, pe.out_channels, pe.n_layers,
            pe.p_dropout, pe.n_heads, pe.ffn_kernel,
            g_channels=pr.in_channels)

    def forward(self, c, refer, c_mask, refer_mask, generator=None):
        # the reference pools the *padded* refer mel without a mask
        g = self.ref_enc(refer)
        prompt = self.prompt_encoder(refer, refer_mask, generator)
        content = self.phoneme_encoder(c, c_mask, g, generator)
        return content, prompt


class DiffusionEncoder(nn.Module):
    """Concat noisy mel + content -> conditional UNet."""

    def __init__(self, cfg: Config, remat: bool = False,
                 remat_policy: str = "all"):
        super().__init__()
        d = cfg.diffusion_encoder
        self.unet = UNet1DConditionModel(
            in_channels=d.in_channels + d.hidden_channels,
            out_channels=d.out_channels,
            block_out_channels=d.block_out_channels,
            layers_per_block=d.layers_per_block,
            norm_num_groups=d.norm_num_groups,
            cross_attention_dim=d.hidden_channels,
            num_attention_heads=d.n_heads,
            addition_embed_heads=d.addition_embed_heads,
            remat=remat, remat_policy=remat_policy)

    def forward(self, x, content, prompt, prompt_mask, t, cross_kv=None,
                aug_emb=None):
        h = torch.cat([x, content], dim=-1)
        return self.unet(h, t, prompt, encoder_attention_mask=prompt_mask,
                         cross_kv=cross_kv, aug_emb=aug_emb)


class NaturalSpeech2(nn.Module):
    """Diffusion core: `forward` = the training loss, `encode` =
    step-invariant conditioning, `denoise` = one x0 prediction,
    `precompute_conditioning` = the pooled-prompt embedding and every
    cross-attention K/V. `remat` / `remat_policy` apply to the UNet's
    blocks in training (see models/unet.py)."""

    def __init__(self, cfg: Config, remat: bool = False,
                 remat_policy: str = "all"):
        super().__init__()
        if cfg.f0_predictor.enabled:
            raise NotImplementedError(
                "the F0-predictor branch is not ported yet")
        self.cfg = cfg
        self.pre_model = PreModel(cfg)
        self.diff_model = DiffusionEncoder(cfg, remat, remat_policy)
        self.schedule = NoiseSchedule(cfg.train.timesteps)

    def forward(self, batch: dict, generator: torch.Generator | None = None,
                t: torch.Tensor | None = None,
                noise: torch.Tensor | None = None):
        """Training objective (JAX models/diffusion.py:180-229): SNR-
        weighted MSE on x0 over masked mels -> (loss, aux). `t` (B,) ints in
        [0, timesteps) and `noise` (B, T, 100) are drawn from `generator`
        on spec's device unless given; the generator also drives the
        encoders' dropout in training mode. The noise is masked; the
        schedule's sqrt(acp) and sqrt(1 - acp) are cast to spec's dtype;
        the MSE is f32 over every frame, padded ones included."""
        spec = batch["spec"]
        b, t_len, _ = spec.shape
        dev = spec.device
        c_mask = sequence_mask(batch["lengths"], t_len)
        refer_mask = sequence_mask(batch["refer_lengths"],
                                   batch["refer"].shape[1])
        x_mask = c_mask[..., None].to(spec.dtype)
        x_start = spec * x_mask
        if t is None:
            t = torch.randint(0, self.schedule.num_timesteps, (b,),
                              generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=dev, dtype=spec.dtype)
        t = t.to(dev, torch.long)
        noise = noise.to(dev, spec.dtype) * x_mask
        content, prompt = self.pre_model(batch["c"], batch["refer"], c_mask,
                                         refer_mask, generator)

        def coef(arr):
            return torch.as_tensor(arr, dtype=spec.dtype,
                                   device=dev)[t][:, None, None]
        x_t = (coef(self.schedule.sqrt_alphas_cumprod) * x_start
               + coef(self.schedule.sqrt_one_minus_alphas_cumprod) * noise)
        model_out = self.diff_model(x_t, content, prompt, refer_mask,
                                    t.float())
        # the loss in f32 whatever the compute dtype
        model_out, x_start = model_out.float(), x_start.float()
        loss = ((model_out - x_start) ** 2).reshape(b, -1).mean(dim=-1)
        snr = self.schedule.snr
        if self.cfg.train.min_snr_loss_weight:
            snr = np.minimum(snr, self.cfg.train.min_snr_gamma)
        weight = torch.as_tensor(snr, dtype=torch.float32, device=dev)[t]
        loss_diff = (loss * weight).mean()
        aux = {"loss_diff": loss_diff, "loss_f0": 0.0, "pred": model_out,
               "target": x_start}
        return loss_diff, aux

    def encode(self, c, refer, c_mask, refer_mask):
        return self.pre_model(c, refer, c_mask, refer_mask)

    def denoise(self, x, content, prompt, prompt_mask, t, cross_kv=None,
                aug_emb=None):
        """x0-prediction at (possibly fractional) discrete label t."""
        return self.diff_model(x, content, prompt, prompt_mask, t,
                               cross_kv=cross_kv, aug_emb=aug_emb)

    def precompute_conditioning(self, prompt):
        return self.diff_model.unet.precompute(prompt)


@torch.no_grad()
def generate_mel(model: NaturalSpeech2, c: torch.Tensor, refer: torch.Tensor,
                 lengths: torch.Tensor, refer_lengths: torch.Tensor,
                 x_T: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 method: str = "unipc", steps: int | None = None,
                 order: int = 2, noise=None) -> torch.Tensor:
    """Encode the conditioning once, run the sampler (`method` 'ddpm',
    'ddim', 'dpmsolver' or 'unipc', the JAX package's default steps when
    `steps` is None), return the (B, T, 100) log-mel in f32. The model
    runs in the dtype of its parameters; c and refer are cast to it. `x_T`
    (B, T, 100) is the initial noise; without it the noise is drawn from
    `generator` on the model's device, which also feeds DDPM's and DDIM's
    per-step draws unless `noise` gives them."""
    dtype = next(model.parameters()).dtype
    c, refer = c.to(dtype), refer.to(dtype)
    t_len = c.shape[1]
    c_mask = sequence_mask(lengths, t_len)
    refer_mask = sequence_mask(refer_lengths, refer.shape[1])
    content, prompt = model.encode(c, refer, c_mask, refer_mask)
    aug_emb, cross_kv = model.precompute_conditioning(prompt)

    def x0_fn(x, t):
        return model.denoise(x, content, prompt, refer_mask, t,
                             cross_kv=cross_kv, aug_emb=aug_emb)

    shape = (c.shape[0], t_len, model.cfg.diffusion_encoder.out_channels)
    if x_T is None:
        x_T = torch.randn(shape, generator=generator, device=c.device,
                          dtype=dtype)
    elif tuple(x_T.shape) != shape:
        raise ValueError(f"x_T shape {tuple(x_T.shape)}, expected {shape}")
    mel = sample(method, x0_fn, x_T.to(c.device, dtype), model.schedule,
                 steps, generator=generator, order=order, noise=noise)
    return mel.float()
