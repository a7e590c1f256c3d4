"""The port's `diffusion/wrappers.py::model_wrapper` against the JAX
package's, on the CPU: every parameterization (noise, x_start, v, score)
under every guidance mode (uncond, classifier, classifier-free), on the
same toy model, classifier and inputs, at 1e-4 (the JAX suite's sampler
bound) of max(1, max|x0|): near t = 999 the x0 prediction divides by
alpha ~ 6e-3 and reaches 2e3, where f32 resolves 1e-4; the device-side
marginal coefficients against the schedule's host float64 ones; the
doubled-batch call of classifier-free guidance; and a UniPC sample through
the wrapper.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ns2vc_tpu.diffusion import model_wrapper as j_model_wrapper
from ns2vc_tpu.diffusion.schedule import NoiseSchedule as JSchedule
from ns2vc_tpu.diffusion.samplers import unipc_sample as j_unipc
from ns2vc_tpu_torch.diffusion.samplers import unipc_sample
from ns2vc_tpu_torch.diffusion.schedule import NoiseSchedule
from ns2vc_tpu_torch.diffusion.wrappers import (
    GUIDANCE_TYPES, MODEL_TYPES, _marginal_coeffs, model_wrapper,
)

ATOL = 1e-4


def _inputs():
    r = np.random.default_rng(0)
    x = r.standard_normal((3, 6, 5)).astype(np.float32)
    t = np.array([999.0, 431.5, 3.0], np.float32)
    cond = r.standard_normal((3, 6, 5)).astype(np.float32)
    uncond = np.zeros_like(cond)
    return x, t, cond, uncond


def _models(np_mod):
    """The same raw model and classifier over numpy-like `np_mod` (jnp or
    torch)."""
    tanh = np_mod.tanh

    def model(x, t, cond=None):
        out = tanh(0.7 * x) * (1.0 + t[:, None, None] / 2000.0)
        return out if cond is None else out + 0.3 * cond

    def classifier(x, t, cond):
        return -(((x - cond) ** 2).sum(axis=(1, 2)) if np_mod is jnp else
                 ((x - cond) ** 2).sum(dim=(1, 2))) * (t / 1000.0 + 0.5)
    return model, classifier


def _wrappers(model_type, guidance):
    x, t, cond, uncond = _inputs()
    jm, jc = _models(jnp)
    tm, tcls = _models(torch)
    kw = dict(model_type=model_type, guidance_type=guidance,
              guidance_scale=2.5)
    jkw, tkw = dict(kw), dict(kw)
    if guidance == "classifier":
        jkw.update(classifier_fn=jc, condition=jnp.asarray(cond))
        tkw.update(classifier_fn=tcls, condition=torch.from_numpy(cond))
    elif guidance == "classifier-free":
        jkw.update(condition=jnp.asarray(cond),
                   unconditional_condition=jnp.asarray(uncond))
        tkw.update(condition=torch.from_numpy(cond),
                   unconditional_condition=torch.from_numpy(uncond))
    return (j_model_wrapper(jm, JSchedule(1000), **jkw),
            model_wrapper(tm, NoiseSchedule(1000), **tkw), x, t)


@pytest.mark.parametrize("guidance", GUIDANCE_TYPES)
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_model_wrapper_matches_jax(model_type, guidance):
    j_fn, t_fn, x, t = _wrappers(model_type, guidance)
    want = np.asarray(j_fn(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():   # as the samplers call it
        got = t_fn(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def test_marginal_coefficients_match_the_schedule():
    s = NoiseSchedule(1000)
    t = np.array([0.0, 0.37, 17.0, 500.5, 998.2, 999.0], np.float32)
    alpha, sigma = _marginal_coeffs(s, torch.from_numpy(t), 3)
    assert alpha.shape == (6, 1, 1)
    t_cont = (t.astype(np.float64) + 1.0) / 1000
    want = np.exp(s.marginal_log_alpha(t_cont))
    np.testing.assert_allclose(alpha[:, 0, 0].numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(sigma[:, 0, 0].numpy(),
                               np.sqrt(1 - want ** 2), rtol=1e-4)


def test_classifier_free_guidance_calls_once_on_the_doubled_batch():
    x, t, cond, uncond = _inputs()
    calls = []

    def model(xx, tt, cc):
        calls.append((xx.shape[0], tt.shape[0], cc.shape[0]))
        return torch.tanh(xx) + cc
    fn = model_wrapper(model, NoiseSchedule(1000), model_type="x_start",
                       guidance_type="classifier-free",
                       condition=torch.from_numpy(cond),
                       unconditional_condition=torch.from_numpy(uncond),
                       guidance_scale=3.0)
    fn(torch.from_numpy(x), torch.from_numpy(t))
    assert calls == [(6, 6, 6)]
    calls.clear()
    model_wrapper(model, NoiseSchedule(1000), model_type="x_start",
                  guidance_type="classifier-free",
                  condition=torch.from_numpy(cond),
                  unconditional_condition=torch.from_numpy(uncond),
                  guidance_scale=1.0)(torch.from_numpy(x),
                                      torch.from_numpy(t))
    assert calls == [(3, 3, 3)]


def test_wrapped_unipc_sample_matches_jax():
    """A classifier-free x_start model through UniPC, both packages."""
    _, t_fn, x, _ = _wrappers("x_start", "classifier-free")
    j_fn, *_ = _wrappers("x_start", "classifier-free")
    want = j_unipc(j_fn, jnp.asarray(x), JSchedule(1000), 10)
    with torch.no_grad():
        got = unipc_sample(t_fn, torch.from_numpy(x), NoiseSchedule(1000), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bad_arguments_raise():
    s = NoiseSchedule(1000)
    with pytest.raises(ValueError, match="model_type"):
        model_wrapper(lambda x, t: x, s, model_type="epsilon")
    with pytest.raises(ValueError, match="guidance_type"):
        model_wrapper(lambda x, t: x, s, guidance_type="cfg")
    with pytest.raises(ValueError, match="classifier_fn"):
        model_wrapper(lambda x, t: x, s, guidance_type="classifier")
