"""UniPC sampler (counterpart of ns2vc_tpu/diffusion/samplers.py::
unipc_sample and `_fast_sampler_consts`).

The sampler consumes an x0-prediction function `x0_fn(x, t_input)` where
`t_input` is the (possibly fractional) discrete-time label in [0, 1000).
Every schedule constant is host float64 math folded to Python floats; the
loop over steps is a Python loop that makes exactly `steps` model calls.
The JAX package runs the homogeneous middle of the loop as one `lax.scan`;
here every update goes through the same `update` step, which is the same
arithmetic. DDPM, DDIM and DPM-Solver++ are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ns2vc_tpu_torch.diffusion.schedule import NoiseSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _fast_sampler_consts(schedule: NoiseSchedule, steps: int):
    """Marginals on the time-uniform grid, (steps+1,) each, host float64."""
    ts = schedule.time_uniform_steps(steps)
    lam = schedule.marginal_lambda(ts)
    alpha = np.exp(schedule.marginal_log_alpha(ts))
    sigma = schedule.marginal_std(ts)
    return lam, alpha, sigma, schedule.model_input_time(ts)


def unipc_sample(x0_fn: DenoiseFn, x_T: torch.Tensor,
                 schedule: NoiseSchedule, steps: int = 30, order: int = 2,
                 variant: str = "bh2") -> torch.Tensor:
    """UniPC multistep predictor-corrector, orders 1-3, predict_x0, variants
    'bh2' (B_h = expm1(hh)), 'bh1' (B_h = hh) and 'vary_coeff'. Low-order
    warm-up, order-k body with corrector, and the lower_order_final tail
    (the last k-1 updates drop to orders k-1..1; the final update runs
    without corrector). `steps` model calls in total."""
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, got {order}")
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
        t = torch.full((x.shape[0],), float(np.float32(t_in[i])),
                       dtype=torch.float32, device=x.device)
        return x0_fn(x, t)

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
