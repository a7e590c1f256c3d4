"""NaturalSpeech2-style diffusion VC core (counterpart of
ns2vc_tpu/models/diffusion.py): PreModel, DiffusionEncoder,
`NaturalSpeech2.forward` (the training objective), `.encode` / `.denoise`
/ `.precompute_conditioning`, and `generate_mel`.

Batch convention (fixed shapes, mask-disciplined):
    c      (B, T, 256)   contentvec, frame-expanded
    refer  (B, Tp, 100)  reference log-mel (the prompt)
    f0, uv (B, T)        F0 (Hz) and voicing, read when the F0 predictor is on
    spec   (B, T, 100)   target log-mel (training)
    lengths, refer_lengths (B,)

With `cfg.f0_predictor.enabled` the PreModel holds the F0 predictor and a
256-bin F0 embedding added to the content: the embedding takes the given
F0, or the predicted one when the model is in eval mode and
`auto_predict_f0`. The training loss adds the L1 of the predicted against
the true log-mel F0 (`loss_f0`). In eval with `auto_predict_f0` False the
paths that discard the prediction (`encode`, `generate_mel`, and so the
serving API) skip the predictor, as XLA drops that work from the JAX
program; training, and a caller of `PreModel` that takes `lf0_pred`, run
it. Under a bf16 model the predictor runs in f32, as JAX's promotion has
it (see `models/encoders.py::F0Predictor`): `lf0_pred` is f32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ns2vc_tpu_torch.config import Config
from ns2vc_tpu_torch.diffusion.samplers import sample
from ns2vc_tpu_torch.diffusion.schedule import NoiseSchedule
from ns2vc_tpu_torch.models.encoders import (
    F0Predictor, PhoneEncoder, PromptEncoder, TextTimeEmbedding,
)
from ns2vc_tpu_torch.models.unet import UNet1DConditionModel
from ns2vc_tpu_torch.ops.embedding import embedding_lookup
from ns2vc_tpu_torch.ops.masking import sequence_mask
from ns2vc_tpu_torch.ops.sequence import F0_BIN, f0_to_coarse, normalize_f0
from ns2vc_tpu_torch.parallel.mesh import (
    all_gather, batch_sharding, mesh_groups,
)


class PreModel(nn.Module):
    """Speaker pooling + prompt/content encoders, and with the F0
    predictor on, the predictor and the F0 embedding."""

    def __init__(self, cfg: Config):
        super().__init__()
        pe, pr, fp = cfg.phoneme_encoder, cfg.prompt_encoder, cfg.f0_predictor
        self.ref_enc = TextTimeEmbedding(pr.in_channels, pr.in_channels, 1)
        self.prompt_encoder = PromptEncoder(
            pr.in_channels, pr.hidden_channels, pr.out_channels, pr.n_layers,
            pr.p_dropout, pr.n_heads, pr.ffn_kernel)
        self.phoneme_encoder = PhoneEncoder(
            pe.in_channels, pe.hidden_channels, pe.out_channels, pe.n_layers,
            pe.p_dropout, pe.n_heads, pe.ffn_kernel,
            g_channels=pr.in_channels)
        self.f0_predictor = self.f0_emb = None
        if fp.enabled:
            self.f0_predictor = F0Predictor(
                fp.in_channels, fp.hidden_channels, fp.out_channels,
                fp.attention_layers, fp.n_heads, fp.p_dropout)
            self.f0_emb = nn.Embedding(F0_BIN, pe.out_channels)

    def forward(self, c, refer, c_mask, refer_mask, generator=None, f0=None,
                uv=None, f0_factor=None, auto_predict_f0=True,
                want_prediction=True):
        """(content, prompt, lf0, lf0_pred); lf0 (B, T, 1) is the log-mel
        F0 target and lf0_pred the prediction, both None unless the
        predictor is on and f0 (B, T) is given. uv defaults to f0 > 0. The
        normalised contour's scale is `f0_factor` (B,), else drawn from
        `generator` in training mode, else 1. With `want_prediction` False,
        in eval and without `auto_predict_f0`, nothing reads the prediction:
        the predictor does not run and lf0_pred is None."""
        # the reference pools the *padded* refer mel without a mask
        g = self.ref_enc(refer)
        prompt = self.prompt_encoder(refer, refer_mask, generator)
        content = self.phoneme_encoder(c, c_mask, g, generator)
        lf0 = lf0_pred = None
        if self.f0_predictor is not None and f0 is not None:
            lf0 = 2595.0 * torch.log10(1.0 + f0[..., None] / 700.0) / 500.0
            if self.training or auto_predict_f0 or want_prediction:
                norm_lf0 = normalize_f0(
                    lf0, uv if uv is not None else (f0 > 0).to(lf0.dtype),
                    f0_factor, generator if self.training else None)
                lf0_pred = self.f0_predictor(content, prompt, norm_lf0,
                                             c_mask, refer_mask, generator)
            if not self.training and auto_predict_f0:
                f0_for_emb = 700.0 * (10.0 ** (lf0_pred[..., 0]
                                               * 500.0 / 2595.0) - 1.0)
            else:
                f0_for_emb = f0
            # nn.Embedding's lookup with a backward that sums in a fixed
            # order (its own adds repeated bins' rows with atomics)
            content = content + embedding_lookup(f0_to_coarse(f0_for_emb),
                                                 self.f0_emb.weight)
        return content, prompt, lf0, lf0_pred


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
        self.cfg = cfg
        self.pre_model = PreModel(cfg)
        self.diff_model = DiffusionEncoder(cfg, remat, remat_policy)
        self.schedule = NoiseSchedule(cfg.train.timesteps)
        self._schedule_on: dict = {}   # device -> `_schedule_tensors`

    def _schedule_tensors(self, dev: torch.device) -> tuple:
        """sqrt(acp), sqrt(1 - acp) and the loss weight (the SNR, clamped
        under `min_snr_loss_weight`) as f64 tensors on `dev`, uploaded at
        the first step on that device: a step captured as a CUDA graph
        copies nothing from the host."""
        hit = self._schedule_on.get(dev)
        if hit is None:
            snr = self.schedule.snr
            if self.cfg.train.min_snr_loss_weight:
                snr = np.minimum(snr, self.cfg.train.min_snr_gamma)
            hit = self._schedule_on[dev] = tuple(
                torch.as_tensor(a, device=dev) for a in (
                    self.schedule.sqrt_alphas_cumprod,
                    self.schedule.sqrt_one_minus_alphas_cumprod, snr))
        return hit

    def forward(self, batch: dict, generator: torch.Generator | None = None,
                t: torch.Tensor | None = None,
                noise: torch.Tensor | None = None,
                f0_factor: torch.Tensor | None = None):
        """Training objective (JAX models/diffusion.py:180-229): SNR-
        weighted MSE on x0 over masked mels, plus with the F0 predictor the
        f32 L1 of its prediction against the log-mel F0 -> (loss, aux).
        `t` (B,) ints in [0, timesteps) and `noise` (B, T, 100) are drawn
        from `generator` on spec's device unless given; the generator also
        drives dropout and the F0 contour's scale (`f0_factor` (B,) when
        given) in training mode. The noise is masked; the schedule's
        sqrt(acp) and sqrt(1 - acp) are cast to spec's dtype; the MSE is f32
        over every frame, padded ones included."""
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
        content, prompt, lf0, lf0_pred = self.pre_model(
            batch["c"], batch["refer"], c_mask, refer_mask, generator,
            f0=batch.get("f0"), uv=batch.get("uv"), f0_factor=f0_factor,
            auto_predict_f0=False)

        sqrt_acp, sqrt_one_minus_acp, snr = self._schedule_tensors(dev)

        def coef(arr):
            return arr.to(spec.dtype)[t][:, None, None]
        x_t = (coef(sqrt_acp) * x_start + coef(sqrt_one_minus_acp) * noise)
        model_out = self.diff_model(x_t, content, prompt, refer_mask,
                                    t.float())
        # the loss in f32 whatever the compute dtype
        model_out, x_start = model_out.float(), x_start.float()
        loss = ((model_out - x_start) ** 2).reshape(b, -1).mean(dim=-1)
        weight = snr.to(torch.float32)[t]
        loss_diff = (loss * weight).mean()
        loss_f0 = 0.0
        if lf0_pred is not None:
            loss_f0 = (lf0_pred.float() - lf0.float()).abs().mean()
        aux = {"loss_diff": loss_diff, "loss_f0": loss_f0, "pred": model_out,
               "target": x_start}
        return loss_diff + loss_f0, aux

    def encode(self, c, refer, c_mask, refer_mask, f0=None, uv=None,
               auto_predict_f0=True):
        """The step-invariant conditioning (content, prompt); in eval
        without `auto_predict_f0` the F0 predictor does not run."""
        return self.pre_model(c, refer, c_mask, refer_mask, f0=f0, uv=uv,
                              auto_predict_f0=auto_predict_f0,
                              want_prediction=False)[:2]

    def denoise(self, x, content, prompt, prompt_mask, t, cross_kv=None,
                aug_emb=None):
        """x0-prediction at (possibly fractional) discrete label t."""
        return self.diff_model(x, content, prompt, prompt_mask, t,
                               cross_kv=cross_kv, aug_emb=aug_emb)

    def precompute_conditioning(self, prompt):
        return self.diff_model.unet.precompute(prompt)


def make_x0_fn(model: NaturalSpeech2, content: torch.Tensor,
               prompt: torch.Tensor, prompt_mask: torch.Tensor,
               cached: tuple | None = None):
    """Bind the step-invariant conditioning into a sampler's x0 function
    x0_fn(x, t) (reference model.py:632/667); `cached` = (aug_emb,
    cross_kv) from `precompute_conditioning` also hoists the prompt's
    pooled embedding and cross-attention K/V out of every step. The JAX
    signature without `params`: the module holds its weights."""
    aug_emb, cross_kv = cached if cached is not None else (None, None)

    def x0_fn(x, t):
        return model.denoise(x, content, prompt, prompt_mask, t,
                             cross_kv=cross_kv, aug_emb=aug_emb)
    return x0_fn


@torch.no_grad()
def generate_mel(model: NaturalSpeech2, c: torch.Tensor, refer: torch.Tensor,
                 lengths: torch.Tensor, refer_lengths: torch.Tensor,
                 x_T: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 method: str = "unipc", steps: int | None = None,
                 order: int = 2, noise=None, f0: torch.Tensor | None = None,
                 uv: torch.Tensor | None = None,
                 auto_predict_f0: bool = True, mesh=None,
                 gather: bool = True, eta: float = 0.0) -> torch.Tensor:
    """Encode the conditioning once, run the sampler (`method` 'ddpm',
    'ddim' with DDIM's `eta`, 'dpmsolver' or 'unipc', the JAX package's
    default steps when `steps` is None), return the (B, T, 100) log-mel in
    f32. The model runs in the dtype of its parameters; c and refer are
    cast to it, f0 and uv (B, T) stay in theirs (f32: the coarse F0 bins
    are taken there).
    `x_T` (B, T, 100) is the initial noise; without it the noise is drawn
    from `generator` on the model's device, which also feeds DDPM's and
    DDIM's per-step draws unless `noise` gives them.

    Over a `parallel.mesh.Mesh` (every rank calls it with the whole batch;
    the model split over the mesh's model axis by `shard_parameters`, or
    not), each data index samples its contiguous rows of the batch
    (`BatchSharding.rows`) on its model group, and the caller gets the
    whole batch back (`gather`, one all-gather over the data group) or its
    rows. `x_T` drawn here is drawn at the whole batch's shape and sliced,
    as one process draws it; `noise` (each step's whole batch) is sliced
    alike; without it DDPM's per-step draws are each data group's own."""
    rows = None if mesh is None else batch_sharding(mesh).rows(c.shape[0])
    dtype = next(model.parameters()).dtype
    shape = (c.shape[0], c.shape[1], model.cfg.diffusion_encoder.out_channels)
    if rows is not None:
        c, refer, lengths, refer_lengths = (
            v[rows] for v in (c, refer, lengths, refer_lengths))
        f0, uv = (None if v is None else v[rows] for v in (f0, uv))
    c, refer = c.to(dtype), refer.to(dtype)
    t_len = c.shape[1]
    c_mask = sequence_mask(lengths, t_len)
    refer_mask = sequence_mask(refer_lengths, refer.shape[1])
    content, prompt = model.encode(c, refer, c_mask, refer_mask, f0=f0,
                                   uv=uv, auto_predict_f0=auto_predict_f0)
    x0_fn = make_x0_fn(model, content, prompt, refer_mask,
                       cached=model.precompute_conditioning(prompt))

    if x_T is None:
        x_T = torch.randn(shape, generator=generator, device=c.device,
                          dtype=dtype)
    elif tuple(x_T.shape) != shape:
        raise ValueError(f"x_T shape {tuple(x_T.shape)}, expected {shape}")
    if rows is not None:
        x_T = x_T[rows]
        noise = None if noise is None else [n[rows] for n in noise]
    mel = sample(method, x0_fn, x_T.to(c.device, dtype), model.schedule,
                 steps, generator=generator, order=order, noise=noise,
                 eta=eta)
    mel = mel.float()
    if rows is not None and gather and mesh.shape["data"] > 1:
        mel = torch.cat(all_gather(mel, mesh_groups(mesh)[1]))
    return mel
