"""Discrete linear-beta noise schedule + continuous-time (VP) views.

A copy of ns2vc_tpu/diffusion/schedule.py (numpy only): importing that
module would run `ns2vc_tpu/diffusion/__init__.py`, which imports the JAX
samplers. tests/test_torch_slice.py pins every array of this copy to the
JAX package's class.

All schedule scalars are precomputed on the host in float64; the sampler
folds them to Python floats.
"""

from __future__ import annotations

import numpy as np


class NoiseSchedule:
    def __init__(self, timesteps: int = 1000, beta_start: float = 1e-4,
                 beta_end: float = 0.02):
        scale = 1000.0 / timesteps
        self.num_timesteps = timesteps
        self.betas = np.linspace(scale * beta_start, scale * beta_end,
                                 timesteps, dtype=np.float64)
        alphas = 1.0 - self.betas
        acp = np.cumprod(alphas)
        acp_prev = np.concatenate([[1.0], acp[:-1]])
        self.alphas_cumprod = acp
        self.alphas_cumprod_prev = acp_prev

        # DDPM buffers (reference model.py:473-498), kept in f64 here;
        # cast at use sites (the reference stores f32 copies)
        self.sqrt_alphas_cumprod = np.sqrt(acp)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - acp)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / acp)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / acp - 1.0)
        posterior_variance = self.betas * (1.0 - acp_prev) / (1.0 - acp)
        self.posterior_variance = posterior_variance
        self.posterior_log_variance_clipped = np.log(
            np.maximum(posterior_variance, 1e-20))
        self.posterior_mean_coef1 = (
            self.betas * np.sqrt(acp_prev) / (1.0 - acp))
        self.posterior_mean_coef2 = (
            (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp))
        self.snr = acp / (1.0 - acp)  # loss weight (model.py:492-498)

        # continuous-time view (sampler/dpm_solver.py:100-108)
        self.T = 1.0
        self.t_array = np.linspace(0.0, 1.0, timesteps + 1)[1:]
        self.log_alpha_array = 0.5 * np.log(acp)

    # -- NoiseScheduleVP equivalents (host-side, float64) ------------------

    def marginal_log_alpha(self, t: np.ndarray) -> np.ndarray:
        """log alpha_t via piecewise-linear interpolation
        (sampler/dpm_solver.py:127-133; edges are exact since
        t in [1/N, 1] lies inside the grid)."""
        return np.interp(np.asarray(t, np.float64), self.t_array,
                         self.log_alpha_array)

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_alpha(t))

    def marginal_std(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.marginal_log_alpha(t)))

    def marginal_lambda(self, t):
        log_alpha = self.marginal_log_alpha(t)
        log_sigma = 0.5 * np.log(1.0 - np.exp(2.0 * log_alpha))
        return log_alpha - log_sigma

    def inverse_lambda(self, lamb):
        """t such that marginal_lambda(t) = lamb
        (sampler/dpm_solver.py:156-167, discrete branch): alpha^2 =
        sigmoid(2 lambda), then interpolate t over the log-alpha grid."""
        lamb = np.asarray(lamb, np.float64)
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lamb)
        # log_alpha_array decreases with t; np.interp wants increasing x
        return np.interp(log_alpha, self.log_alpha_array[::-1],
                         self.t_array[::-1])

    def model_input_time(self, t_continuous):
        """continuous t in [1/N, 1] -> model label in [0, 1000*(N-1)/N]
        (sampler/dpm_solver.py:272-280)."""
        n = self.num_timesteps
        return (np.asarray(t_continuous, np.float64) - 1.0 / n) * n

    def time_uniform_steps(self, steps: int, t_start: float | None = None,
                           t_end: float | None = None) -> np.ndarray:
        """skip_type='time_uniform' grid from T to t_0
        (sampler/dpm_solver.py get_time_steps)."""
        t_0 = 1.0 / self.num_timesteps if t_end is None else t_end
        t_T = self.T if t_start is None else t_start
        return np.linspace(t_T, t_0, steps + 1)
