"""Diffusion samplers (counterpart of ns2vc_tpu/diffusion/samplers.py):
DDPM, DDIM, DPM-Solver++ (multistep, singlestep, adaptive, inverse), UniPC
and the `sample` dispatcher with the JAX package's default step counts.

Every sampler consumes an x0-prediction function `x0_fn(x, t_input)` where
`t_input` is the (possibly fractional) discrete-time label in [0, 1000).
Every schedule constant is host float64 math folded to Python floats; the
loop over steps is a Python loop that makes exactly one model call per
NFE. The JAX package runs the homogeneous middle of each loop as one
`lax.scan`; here every update goes through the same update function, which
is the same arithmetic.

DDPM and DDIM draw their per-step noise from an explicit `torch.Generator`
on x's device, or take it in as a sequence (`noise`), so a test can feed
the draws `jax.random` makes.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ns2vc_tpu_torch.diffusion.schedule import NoiseSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _check_order(order: int, allowed: tuple) -> None:
    if order not in allowed:
        raise ValueError(f"order must be one of {allowed}, got {order}")


def _labels(x: torch.Tensor, t: float) -> torch.Tensor:
    """The (B,) f32 time-label vector of one model call."""
    return torch.full((x.shape[0],), float(np.float32(t)),
                      dtype=torch.float32, device=x.device)


def _noise(x: torch.Tensor, i: int, noise: Sequence | None,
           generator: torch.Generator | None) -> torch.Tensor:
    if noise is not None:
        return noise[i].to(x.device, x.dtype)
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def ddpm_sample(x0_fn: DenoiseFn, x_T: torch.Tensor, schedule: NoiseSchedule,
                generator: torch.Generator | None = None,
                noise: Sequence | None = None) -> torch.Tensor:
    """Ancestral sampling over all T steps (posterior mean of the x0
    prediction plus exp(0.5 logvar) noise, none at t = 0). `noise[j]` is
    the draw of the j-th call (t = T-1-j)."""
    n = schedule.num_timesteps
    c1 = schedule.posterior_mean_coef1.astype(np.float32)
    c2 = schedule.posterior_mean_coef2.astype(np.float32)
    logvar = schedule.posterior_log_variance_clipped.astype(np.float32)
    x = x_T
    for j, t in enumerate(range(n - 1, -1, -1)):
        x0 = x0_fn(x, _labels(x, t))
        eps = _noise(x, j, noise, generator)   # drawn at t = 0 too, as JAX
        x = float(c1[t]) * x0 + float(c2[t]) * x
        if t > 0:
            x = x + float(np.exp(0.5 * logvar[t])) * eps
    return x


def ddim_sample(x0_fn: DenoiseFn, x_T: torch.Tensor, schedule: NoiseSchedule,
                steps: int, generator: torch.Generator | None = None,
                eta: float = 0.0, noise: Sequence | None = None
                ) -> torch.Tensor:
    """DDIM over `steps` calls (default eta 0: deterministic; the final
    step returns the x0 prediction). `noise[j]` is the j-th call's draw."""
    acp = schedule.alphas_cumprod
    x = x_T
    for j, (t, tn) in enumerate(_ddim_pairs(schedule, steps)):
        x0 = x0_fn(x, _labels(x, t))
        if tn < 0:
            x = x0
            continue
        alpha_next = acp[tn]
        sigma = _ddim_sigma(schedule, t, tn, eta)
        c = np.float32(np.sqrt(1 - alpha_next - sigma ** 2))
        srt = np.float32(schedule.sqrt_recip_alphas_cumprod[t])
        srm1 = np.float32(schedule.sqrt_recipm1_alphas_cumprod[t])
        pred_noise = (float(srt) * x - x0) / max(float(srm1), 1e-20)
        x = float(np.float32(np.sqrt(alpha_next))) * x0 + float(c) * pred_noise
        if sigma != 0.0:
            x = x + float(np.float32(sigma)) * _noise(x, j, noise, generator)
    return x


def _ddim_pairs(schedule: NoiseSchedule, steps: int) -> list:
    """DDIM's (t, t_next) per call; t_next < 0 on the last."""
    n = schedule.num_timesteps
    times = np.trunc(np.linspace(-1.0, n - 1, steps + 1)).astype(np.int64)
    return list(zip(times[::-1][:-1], times[::-1][1:]))


def _ddim_sigma(schedule: NoiseSchedule, t, tn, eta: float) -> float:
    alpha, alpha_next = schedule.alphas_cumprod[t], schedule.alphas_cumprod[tn]
    return eta * np.sqrt((1 - alpha / alpha_next) * (1 - alpha_next)
                         / (1 - alpha))


def noise_calls(method: str, schedule: NoiseSchedule,
                steps: int | None = None, eta: float = 0.0) -> list[int]:
    """The model calls (0-based) after which `sample(method, ...)` draws
    noise, in draw order: every DDPM call (t = 0 too), each DDIM call but
    the last when eta > 0, none for the ODE samplers. x_T and then one
    draw of x_T's shape and dtype per listed call, from one generator,
    are the draws `generate_mel` makes itself from that generator."""
    if method == "ddpm":
        return list(range(schedule.num_timesteps))
    if method == "ddim":
        return [j for j, (t, tn) in enumerate(_ddim_pairs(schedule,
                                                          steps or 100))
                if tn >= 0 and _ddim_sigma(schedule, t, tn, eta) != 0.0]
    return []


def _fast_sampler_consts(schedule: NoiseSchedule, steps: int,
                         t_start: float | None = None,
                         t_end: float | None = None):
    """Marginals on the time-uniform grid, (steps+1,) each, host float64;
    an ascending range (t_start < t_end) runs the ODE forward."""
    ts = schedule.time_uniform_steps(steps, t_start, t_end)
    lam = schedule.marginal_lambda(ts)
    alpha = np.exp(schedule.marginal_log_alpha(ts))
    sigma = schedule.marginal_std(ts)
    return lam, alpha, sigma, schedule.model_input_time(ts)


def dynamic_thresholding(x0: torch.Tensor, ratio: float = 0.995,
                         max_val: float = 1.0) -> torch.Tensor:
    """Imagen-style dynamic thresholding of an x0 prediction: clamp each
    sample to its |x0| `ratio`-quantile (floored at max_val) and rescale
    into [-1, 1]."""
    s = torch.quantile(x0.abs().reshape(x0.shape[0], -1).float(), ratio,
                       dim=1)
    s = torch.clamp(s, min=max_val).reshape((-1,) + (1,) * (x0.ndim - 1))
    s = s.to(x0.dtype)
    return torch.maximum(torch.minimum(x0, s), -s) / s


def thresholded_x0_fn(x0_fn: DenoiseFn, ratio: float = 0.995,
                      max_val: float = 1.0) -> DenoiseFn:
    """x0_fn -> x0_fn with dynamic thresholding on every prediction."""
    def fn(x, t):
        return dynamic_thresholding(x0_fn(x, t), ratio, max_val)
    return fn


def add_noise(schedule: NoiseSchedule, x: torch.Tensor, t: float,
              noise: torch.Tensor) -> torch.Tensor:
    """x_t = alpha_t x + sigma_t noise at continuous time t."""
    a = float(schedule.marginal_alpha(t))
    s = float(schedule.marginal_std(t))
    return a * x + s * noise


def dpmpp_2m_sample(x0_fn: DenoiseFn, x_T: torch.Tensor,
                    schedule: NoiseSchedule, steps: int = 40,
                    order: int = 2, t_start: float | None = None,
                    t_end: float | None = None) -> torch.Tensor:
    """DPM-Solver++ multistep (orders 1-3), time-uniform, 'dpmsolver'
    variant, `steps` NFE. Below 10 steps the final updates lower their
    order (lower_order_final); from 10 steps on the order rises 1, 2, ...
    to `order` and stays there. An ascending t range integrates the ODE
    forward (see `dpm_inverse`)."""
    _check_order(order, (1, 2, 3))
    if steps < order:
        raise ValueError(f"steps={steps} must be at least order={order}")
    lam, alpha, sigma, t_in = _fast_sampler_consts(schedule, steps,
                                                   t_start, t_end)
    h = lam[1:] - lam[:-1]                              # h_i for update i+1
    sig_ratio = sigma[1:] / sigma[:-1]
    phi_1 = np.expm1(-h)
    aphi1 = alpha[1:] * phi_1
    aphi2 = alpha[1:] * (phi_1 / h + 1.0)
    aphi3 = alpha[1:] * ((phi_1 / h + 1.0) / h - 0.5)

    def update(x, k, i, m0, m1, m2):
        x_ = float(sig_ratio[i]) * x - float(aphi1[i]) * m0
        if k == 1:
            return x_
        r0 = float(h[i - 1] / h[i])
        d1_0 = (m0 - m1) / r0
        if k == 2:
            return x_ - float(aphi1[i]) * 0.5 * d1_0
        r1 = float(h[i - 2] / h[i])
        d1_1 = (m1 - m2) / r1
        d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (d1_0 - d1_1) / (r0 + r1)
        return x_ + float(aphi2[i]) * d1 - float(aphi3[i]) * d2

    x = x_T
    m0 = x0_fn(x, _labels(x, t_in[0]))
    m1 = m2 = m0
    for step in range(1, steps + 1):
        if steps < 10:
            k = step if step < order else min(order, steps + 1 - step)
        else:
            k = min(order, step)
        x = update(x, k, step - 1, m0, m1, m2)
        if step < steps:
            m2, m1, m0 = m1, m0, x0_fn(x, _labels(x, t_in[step]))
    return x


def unipc_sample(x0_fn: DenoiseFn, x_T: torch.Tensor,
                 schedule: NoiseSchedule, steps: int = 30, order: int = 2,
                 variant: str = "bh2") -> torch.Tensor:
    """UniPC multistep predictor-corrector, orders 1-3, predict_x0, variants
    'bh2' (B_h = expm1(hh)), 'bh1' (B_h = hh) and 'vary_coeff'. Low-order
    warm-up, order-k body with corrector, and the lower_order_final tail
    (the last k-1 updates drop to orders k-1..1; the final update runs
    without corrector). `steps` model calls in total."""
    _check_order(order, (1, 2, 3))
    if variant not in ("bh2", "bh1", "vary_coeff"):
        raise ValueError(f"unknown UniPC variant {variant!r}")
    if steps < order + 1:
        raise ValueError(f"steps={steps} must be at least order+1")
    lam, alpha, sigma, t_in = _fast_sampler_consts(schedule, steps)
    h = lam[1:] - lam[:-1]
    hh = -h                                        # predict_x0
    sig_ratio = sigma[1:] / sigma[:-1]
    aphi = alpha[1:] * np.expm1(hh)

    def rks(i, k):
        """[r_1, ..., r_{k-1}]: r_j = (lambda_{i-j} - lambda_i) / h_i."""
        return [float((lam[i - j] - lam[i]) / h[i]) for j in range(1, k)]

    def step_weights(i, k):
        """(wp, wc, wt, scale) of the order-k update with h-index i:
            x_  = sig_ratio*x - aphi*m0
            x_p = x_ - scale * sum_j wp[j] * D1s[j]          (predictor)
            x   = x_ - scale * (sum_j wc[j] * D1s[j]
                                + wt * (m(x_p) - m0))        (corrector)
        with D1s[j] = (m_j - m0) / r_j."""
        hh_i = float(hh[i])
        if variant in ("bh1", "bh2"):
            B = hh_i if variant == "bh1" else float(np.expm1(hh_i))
            b = []
            h_phi_k = np.expm1(hh_i) / hh_i - 1.0
            fact = 1
            for m in range(1, k + 1):
                b.append(h_phi_k * fact / B)
                fact *= m + 1
                h_phi_k = h_phi_k / hh_i - 1.0 / fact
            b = np.asarray(b)
            r = np.asarray(rks(i, k) + [1.0])
            R = np.stack([r ** p for p in range(k)])
            rho_c = np.array([0.5]) if k == 1 else np.linalg.solve(R, b)
            if k <= 1:
                wp = np.zeros(0)
            elif k == 2:   # simplified order-2 predictor
                wp = np.array([0.5])
            else:
                wp = np.linalg.solve(R[:-1, :-1], b[:-1])
            return wp, rho_c[:-1], float(rho_c[-1]), float(alpha[i + 1] * B)
        # vary_coeff: C[a, j] = r_a^j / (j+1)!, A_p = C[:-1,:-1]^-1,
        # A_c = C^-1, combined over the h_phi_k series
        K = k
        r = np.asarray(rks(i, K) + [1.0])
        fact = np.cumprod(np.arange(2, K + 2))            # (j+1)! for j>=1
        C = np.stack([r ** j / (fact[j - 1] if j else 1.0)
                      for j in range(K)], axis=1)
        hps = []                                          # h_phi_ks[0..K]
        h_phi_k = np.expm1(hh_i)
        f = 1
        for m in range(1, K + 2):
            hps.append(h_phi_k)
            h_phi_k = h_phi_k / hh_i - 1.0 / f
            f *= m + 1
        A_c = np.linalg.inv(C)
        if K >= 2:
            A_p = np.linalg.inv(C[:-1, :-1])
            wp = sum(hps[kk + 1] * A_p[kk] for kk in range(K - 1))
            wc = sum(hps[kk + 1] * A_c[kk][:-1] for kk in range(K - 1))
        else:
            wp = wc = np.zeros(0)
        k_last = K - 2 if K >= 2 else 0   # the reference's loop-variable quirk
        wt = float(hps[K] * A_c[k_last][-1])
        return wp, wc, wt, float(alpha[i + 1])

    def eval_m(x, i):
        return x0_fn(x, _labels(x, t_in[i]))

    def update(x, i, k, ms, use_corrector):
        """One multistep update with h-index i at order k; ms = (m0, m1, m2)."""
        wp, wc, wt, scale = step_weights(i, k)
        m0 = ms[0]
        x_ = float(sig_ratio[i]) * x - float(aphi[i]) * m0
        ds = [(ms[j + 1] - m0) / r for j, r in enumerate(rks(i, k))]
        x_t = x_
        for j, d in enumerate(ds):
            x_t = x_t - scale * float(wp[j]) * d
        if not use_corrector:
            return x_t, None
        m_t = eval_m(x_t, i + 1)
        corr = wt * (m_t - m0)
        for j, d in enumerate(ds):
            corr = corr + float(wc[j]) * d
        return x_ - scale * corr, m_t

    x = x_T
    m0 = eval_m(x, 0)
    ms = (m0, m0, m0)
    for i in range(steps):
        # warm-up updates run at orders 1..order-1, the tail lowers the order
        # again (lower_order_final); the final update skips the corrector
        k = min(order, i + 1, steps - i)
        x, m_t = update(x, i, k, ms, use_corrector=i < steps - 1)
        if m_t is not None:
            ms = (m_t, ms[0], ms[1])
    return x


def _eval_at(x0_fn: DenoiseFn, schedule: NoiseSchedule, x, t_cont: float):
    """Model call at a continuous time (host float) -> discrete label."""
    return x0_fn(x, _labels(x, schedule.model_input_time(t_cont)))


def _singlestep_update(x0_fn: DenoiseFn, schedule: NoiseSchedule, x,
                       s: float, t: float, order: int,
                       r1: float | None, r2: float | None,
                       solver_type: str = "dpmsolver",
                       model_s=None, model_s1=None,
                       return_intermediate: bool = False):
    """One DPM-Solver++ singlestep block from time s to t at order 1-3
    ('dpmsolver' or 'taylor' solver type); schedule scalars fold to host
    floats."""
    lam_s, lam_t = (float(schedule.marginal_lambda(u)) for u in (s, t))
    h = lam_t - lam_s
    sig_s, sig_t = (float(schedule.marginal_std(u)) for u in (s, t))
    alpha_t = float(schedule.marginal_alpha(t))
    phi_1 = float(np.expm1(-h))
    if model_s is None:
        model_s = _eval_at(x0_fn, schedule, x, s)
    if order == 1:
        x_t = (sig_t / sig_s) * x - (alpha_t * phi_1) * model_s
        return (x_t, {"model_s": model_s}) if return_intermediate else x_t

    r1 = (0.5 if order == 2 else 1.0 / 3.0) if r1 is None else float(r1)
    s1 = float(schedule.inverse_lambda(lam_s + r1 * h))
    sig_s1 = float(schedule.marginal_std(s1))
    alpha_s1 = float(schedule.marginal_alpha(s1))
    phi_11 = float(np.expm1(-r1 * h))
    if model_s1 is None:
        x_s1 = (sig_s1 / sig_s) * x - (alpha_s1 * phi_11) * model_s
        model_s1 = _eval_at(x0_fn, schedule, x_s1, s1)
    inter = {"model_s": model_s, "model_s1": model_s1}
    base = (sig_t / sig_s) * x - (alpha_t * phi_1) * model_s
    if order == 2:
        if solver_type == "dpmsolver":
            x_t = base - (0.5 / r1) * (alpha_t * phi_1) * (model_s1 - model_s)
        else:  # taylor
            x_t = base + (1.0 / r1) * (alpha_t * (phi_1 / h + 1.0)) \
                * (model_s1 - model_s)
        return (x_t, inter) if return_intermediate else x_t

    _check_order(order, (1, 2, 3))
    r2 = 2.0 / 3.0 if r2 is None else float(r2)
    s2 = float(schedule.inverse_lambda(lam_s + r2 * h))
    sig_s2 = float(schedule.marginal_std(s2))
    alpha_s2 = float(schedule.marginal_alpha(s2))
    phi_12 = float(np.expm1(-r2 * h))
    phi_22 = float(np.expm1(-r2 * h) / (r2 * h) + 1.0)
    phi_2 = phi_1 / h + 1.0
    phi_3 = phi_2 / h - 0.5
    x_s2 = ((sig_s2 / sig_s) * x - (alpha_s2 * phi_12) * model_s
            + (r2 / r1) * (alpha_s2 * phi_22) * (model_s1 - model_s))
    model_s2 = _eval_at(x0_fn, schedule, x_s2, s2)
    if solver_type == "dpmsolver":
        x_t = base + (1.0 / r2) * (alpha_t * phi_2) * (model_s2 - model_s)
    else:  # taylor
        d1_0 = (1.0 / r1) * (model_s1 - model_s)
        d1_1 = (1.0 / r2) * (model_s2 - model_s)
        d1 = (r2 * d1_0 - r1 * d1_1) / (r2 - r1)
        d2 = 2.0 * (d1_1 - d1_0) / (r2 - r1)
        x_t = base + (alpha_t * phi_2) * d1 - (alpha_t * phi_3) * d2
    return (x_t, inter) if return_intermediate else x_t


def dpmpp_singlestep_sample(x0_fn: DenoiseFn, x_T: torch.Tensor,
                            schedule: NoiseSchedule, steps: int = 20,
                            order: int = 2, solver_type: str = "dpmsolver",
                            fixed: bool = False,
                            t_start: float | None = None,
                            t_end: float | None = None) -> torch.Tensor:
    """Singlestep DPM-Solver++: `steps` NFE split into order-k blocks, each
    one singlestep update whose intra-block r1/r2 come from the
    time-uniform inner grid. `fixed`: steps//order equal blocks."""
    _check_order(order, (1, 2, 3))
    if fixed:
        k_blocks = steps // order
        orders = [order] * k_blocks
        outer = schedule.time_uniform_steps(k_blocks, t_start, t_end)
    else:
        if order == 3:
            k_blocks = steps // 3 + 1
            orders = ([3] * (k_blocks - 2) + [2, 1] if steps % 3 == 0 else
                      [3] * (k_blocks - 1) + [1] if steps % 3 == 1 else
                      [3] * (k_blocks - 1) + [2])
        elif order == 2:
            orders = [2] * (steps // 2) + ([1] if steps % 2 else [])
        else:
            orders = [1] * steps
        ts = schedule.time_uniform_steps(steps, t_start, t_end)
        outer = ts[np.cumsum([0] + orders)]
    x = x_T
    for i, k in enumerate(orders):
        s, t = float(outer[i]), float(outer[i + 1])
        lam_in = schedule.marginal_lambda(np.linspace(s, t, k + 1))
        hh = lam_in[-1] - lam_in[0]
        r1 = float((lam_in[1] - lam_in[0]) / hh) if k >= 2 else None
        r2 = float((lam_in[2] - lam_in[0]) / hh) if k >= 3 else None
        x = _singlestep_update(x0_fn, schedule, x, s, t, k, r1, r2,
                               solver_type)
    return x


def dpmpp_adaptive_sample(x0_fn: DenoiseFn, x_T: torch.Tensor,
                          schedule: NoiseSchedule, order: int = 2,
                          h_init: float = 0.05, atol: float = 0.0078,
                          rtol: float = 0.05, theta: float = 0.9,
                          t_err: float = 1e-5, solver_type: str = "dpmsolver",
                          t_start: float | None = None,
                          t_end: float | None = None) -> torch.Tensor:
    """Adaptive-step singlestep DPM-Solver++: an embedded lower/higher
    order pair; a step is accepted when the scaled error E <= 1, and the
    logSNR step h adapts by theta * E^(-1/order). The error test is a host
    decision, so every step reads one scalar back."""
    _check_order(order, (2, 3))
    t_0 = 1.0 / schedule.num_timesteps if t_end is None else t_end
    s = schedule.T if t_start is None else t_start
    lam_s = float(schedule.marginal_lambda(s))
    lam_0 = float(schedule.marginal_lambda(t_0))
    h = h_init
    x = x_prev = x_T
    r1, r2 = (0.5, None) if order == 2 else (1.0 / 3.0, 2.0 / 3.0)
    while abs(s - t_0) > t_err:
        t = float(schedule.inverse_lambda(lam_s + h))
        x_lower, inter = _singlestep_update(
            x0_fn, schedule, x, s, t, order - 1, r1 if order == 3 else None,
            None, solver_type, return_intermediate=True)
        x_higher = _singlestep_update(
            x0_fn, schedule, x, s, t, order, r1, r2, solver_type,
            model_s=inter["model_s"], model_s1=inter.get("model_s1"))
        delta = torch.clamp(rtol * torch.maximum(x_lower.abs(),
                                                 x_prev.abs()), min=atol)
        err = ((x_higher - x_lower) / delta).reshape(x_T.shape[0], -1)
        e = float(torch.sqrt(torch.mean(err.float() ** 2, dim=-1)).max())
        if e <= 1.0:
            x, x_prev, s = x_higher, x_lower, t
            lam_s = float(schedule.marginal_lambda(s))
        h = min(theta * h * e ** (-1.0 / order), lam_0 - lam_s)
    return x


def dpm_inverse(x0_fn: DenoiseFn, x0: torch.Tensor, schedule: NoiseSchedule,
                steps: int = 20, order: int = 2) -> torch.Tensor:
    """Encode a sample x_{1/N} -> x_T: the multistep solver over the
    ascending time grid [1/N, T]."""
    return dpmpp_2m_sample(x0_fn, x0, schedule, steps=steps, order=order,
                           t_start=1.0 / schedule.num_timesteps,
                           t_end=schedule.T)


def sample(method: str, x0_fn: DenoiseFn, x_T: torch.Tensor,
           schedule: NoiseSchedule, steps: int | None = None,
           generator: torch.Generator | None = None, order: int = 2,
           variant: str = "bh2", noise: Sequence | None = None,
           eta: float = 0.0) -> torch.Tensor:
    """Dispatch by method name: 'ddpm', 'ddim' (100 steps, `eta` 0: the
    JAX dispatcher's), 'dpmsolver' (DPM-Solver++ multistep, 40 steps) or
    'unipc' (30 steps, `variant` bh2/bh1/vary_coeff). `generator` /
    `noise` feed DDPM's and DDIM's draws."""
    if method == "ddpm":
        return ddpm_sample(x0_fn, x_T, schedule, generator, noise)
    if method == "ddim":
        return ddim_sample(x0_fn, x_T, schedule, steps or 100, generator,
                           eta=eta, noise=noise)
    if method == "dpmsolver":
        return dpmpp_2m_sample(x0_fn, x_T, schedule, steps or 40, order=order)
    if method == "unipc":
        return unipc_sample(x0_fn, x_T, schedule, steps or 30, order=order,
                            variant=variant)
    raise ValueError(f"unknown sample method {method!r}")
