"""Parameterization and guidance wrappers for the samplers (counterpart of
ns2vc_tpu/diffusion/wrappers.py).

`model_wrapper` turns a raw diffusion model of any of four parameterizations
(`noise`, `x_start`, `v`, `score`) under one of three guidance modes
(`uncond`, `classifier`, `classifier-free`) into the samplers' contract,
`x0_fn(x, t_input)` with `t_input` the (B,) discrete-time label in [0, 1000):
the model output goes to a noise prediction, guidance combines noise
predictions, and the data-prediction step of DPM-Solver++ gives x0:

    x0 = (x - sigma_t * eps) / alpha_t

- `uncond`: `model(x, t_input, **model_kwargs)`.
- `classifier`: eps - s * sigma_t * grad_x sum(log p(cond | x_t)), the
  gradient by `torch.autograd.grad` through `classifier_fn` (JAX: jax.grad).
- `classifier-free`: one model call on the doubled batch [uncond; cond],
  eps = eps_uncond + s * (eps_cond - eps_uncond).

alpha_t and sigma_t interpolate log alpha piecewise-linearly over the
schedule's (t_i, log alpha_i) grid on the device, as the JAX wrapper's
`jnp.interp` does, so a wrapped model adds no host synchronisation.
"""

from __future__ import annotations

from typing import Callable

import torch

from ns2vc_tpu_torch.diffusion.schedule import NoiseSchedule

MODEL_TYPES = ("noise", "x_start", "v", "score")
GUIDANCE_TYPES = ("uncond", "classifier", "classifier-free")


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp: piecewise-linear through (xp, fp), xp increasing, held
    at the end values outside [xp[0], xp[-1]]."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    x0, x1, y0, y1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    y = y0 + (x - x0) * (y1 - y0) / (x1 - x0)
    return torch.where(x <= xp[0], fp[0], torch.where(x >= xp[-1], fp[-1], y))


def _marginal_coeffs(schedule: NoiseSchedule, t_input: torch.Tensor,
                     ndim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha_t, sigma_t) at the labels t_input, shaped to broadcast over
    an ndim-d x: log alpha interpolated at t = (t_input + 1) / N."""
    dev = t_input.device
    t_grid = torch.as_tensor(schedule.t_array, dtype=torch.float32,
                             device=dev)
    la_grid = torch.as_tensor(schedule.log_alpha_array, dtype=torch.float32,
                              device=dev)
    t_cont = (t_input.float() + 1.0) / schedule.num_timesteps
    log_alpha = _interp(t_cont, t_grid, la_grid)
    alpha = torch.exp(log_alpha)
    sigma = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_alpha),
                                   min=1e-20))
    shape = (-1,) + (1,) * (ndim - 1)
    return alpha.reshape(shape), sigma.reshape(shape)


def model_wrapper(model: Callable, schedule: NoiseSchedule,
                  model_type: str = "noise",
                  model_kwargs: dict | None = None,
                  guidance_type: str = "uncond",
                  condition: torch.Tensor | None = None,
                  unconditional_condition: torch.Tensor | None = None,
                  guidance_scale: float = 1.0,
                  classifier_fn: Callable | None = None,
                  classifier_kwargs: dict | None = None
                  ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Wrap a raw diffusion model into `x0_fn(x, t_input)`.

    `model(x, t_input, **model_kwargs)` (uncond, classifier) or
    `model(x, t_input, cond, **model_kwargs)` (classifier-free);
    `classifier_fn(x, t_input, condition, **classifier_kwargs)` returns
    per-example log-probabilities."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"model_type must be one of {MODEL_TYPES}")
    if guidance_type not in GUIDANCE_TYPES:
        raise ValueError(f"guidance_type must be one of {GUIDANCE_TYPES}")
    if guidance_type == "classifier" and classifier_fn is None:
        raise ValueError("classifier guidance needs classifier_fn")
    mkw = dict(model_kwargs or {})
    ckw = dict(classifier_kwargs or {})

    def to_noise(output, x, t_input):
        if model_type == "noise":
            return output
        alpha, sigma = _marginal_coeffs(schedule, t_input, x.dim())
        alpha, sigma = alpha.to(x.dtype), sigma.to(x.dtype)
        if model_type == "x_start":
            return (x - alpha * output) / sigma
        if model_type == "v":
            return alpha * output + sigma * x
        return -sigma * output   # score

    def noise_pred(x, t_input, cond=None):
        output = (model(x, t_input, **mkw) if cond is None
                  else model(x, t_input, cond, **mkw))
        return to_noise(output, x, t_input)

    def to_x0(eps, x, t_input):
        alpha, sigma = _marginal_coeffs(schedule, t_input, x.dim())
        return (x - sigma.to(x.dtype) * eps) / alpha.to(x.dtype)

    def x0_fn(x, t_input):
        if guidance_type == "uncond":
            if model_type == "x_start":
                return model(x, t_input, **mkw)
            return to_x0(noise_pred(x, t_input), x, t_input)
        if guidance_type == "classifier":
            with torch.enable_grad():
                xx = x.detach().requires_grad_(True)
                log_prob = classifier_fn(xx, t_input, condition, **ckw).sum()
                cond_grad, = torch.autograd.grad(log_prob, xx)
            _, sigma = _marginal_coeffs(schedule, t_input, x.dim())
            eps = noise_pred(x, t_input)
            eps = eps - guidance_scale * sigma.to(x.dtype) * cond_grad
            return to_x0(eps, x, t_input)
        if guidance_scale == 1.0 or unconditional_condition is None:
            return to_x0(noise_pred(x, t_input, cond=condition), x, t_input)
        x_in = torch.cat([x, x], dim=0)
        t_in = torch.cat([t_input, t_input], dim=0)
        c_in = torch.cat([unconditional_condition, condition], dim=0)
        eps_uncond, eps_cond = noise_pred(x_in, t_in, cond=c_in).chunk(2)
        eps = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
        return to_x0(eps, x, t_input)

    return x0_fn
