"""The port's samplers against the JAX package's, on a toy x0 function.

Every sampler of `ns2vc_tpu_torch.diffusion.samplers` runs beside its JAX
counterpart from the same x_T; DDPM and DDIM take the per-step draws that
`jax.random` makes (the `split(key)` -> `normal(sub)` sequence of the JAX
loop), passed in explicitly. Tolerance 1e-4 (f32 throughout). The
dispatcher's default step counts are checked by counting model calls, and
`generate_mel` runs every method on the tiny configuration.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu.diffusion import samplers as js
from ns2vc_tpu.diffusion.schedule import NoiseSchedule as JSchedule
from ns2vc_tpu_torch.convert import init_params
from ns2vc_tpu_torch.diffusion import samplers as ts
from ns2vc_tpu_torch.diffusion.schedule import NoiseSchedule
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2, generate_mel
from test_torch_slice import tiny_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tests: their models are small,
    and the suite's test workers share the host's cores, where several
    OpenMP teams per core stall at their barriers (on an 8-core CPU host,
    alone, 1 thread runs `test_torch_f0.py::test_trainer_serves_a_
    predictor_checkpoint` in 14.7 s against 45.3 with 8)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


ATOL = 1e-4
SHAPE = (2, 8, 5)


def _fns(calls=None):
    def t_fn(x, t):
        if calls is not None:
            calls.append(float(t[0]))
        return torch.tanh(0.8 * x) * (1.0 + t[:, None, None] / 2000.0)

    def j_fn(x, t):
        return jnp.tanh(0.8 * x) * (1.0 + t[:, None, None] / 2000.0)
    return t_fn, j_fn


def _x_T(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)


def _jax_draws(key, n):
    """The per-step normals the JAX DDPM/DDIM loops draw from `key`."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(sub, SHAPE, jnp.float32))))
    return out


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_ddpm_matches_jax_with_its_draws():
    t_fn, j_fn = _fns()
    key = jax.random.PRNGKey(5)
    x_T = _x_T()
    sched = NoiseSchedule(1000)
    got = ts.ddpm_sample(t_fn, torch.from_numpy(x_T), sched,
                         noise=_jax_draws(key, sched.num_timesteps))
    want = js.ddpm_sample(j_fn, jnp.asarray(x_T), JSchedule(1000), key)
    _close(got, want)


@pytest.mark.parametrize("steps,eta", [(20, 0.0), (50, 0.0), (20, 0.7)])
def test_ddim_matches_jax(steps, eta):
    t_fn, j_fn = _fns()
    key = jax.random.PRNGKey(6)
    x_T = _x_T(1)
    got = ts.ddim_sample(t_fn, torch.from_numpy(x_T), NoiseSchedule(1000),
                         steps, eta=eta, noise=_jax_draws(key, steps))
    want = js.ddim_sample(j_fn, jnp.asarray(x_T), JSchedule(1000), steps,
                          key, eta=eta)
    _close(got, want)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("steps", [5, 20])
def test_dpmpp_2m_matches_jax(order, steps):
    calls = []
    t_fn, j_fn = _fns(calls)
    x_T = _x_T(2)
    got = ts.dpmpp_2m_sample(t_fn, torch.from_numpy(x_T), NoiseSchedule(1000),
                             steps, order=order)
    want = js.dpmpp_2m_sample(j_fn, jnp.asarray(x_T), JSchedule(1000), steps,
                              order=order)
    assert len(calls) == steps
    _close(got, want)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("solver_type", ["dpmsolver", "taylor"])
def test_dpmpp_singlestep_matches_jax(order, fixed, solver_type):
    t_fn, j_fn = _fns()
    x_T = _x_T(3)
    got = ts.dpmpp_singlestep_sample(t_fn, torch.from_numpy(x_T),
                                     NoiseSchedule(1000), 12, order=order,
                                     solver_type=solver_type, fixed=fixed)
    want = js.dpmpp_singlestep_sample(j_fn, jnp.asarray(x_T), JSchedule(1000),
                                      12, order=order,
                                      solver_type=solver_type, fixed=fixed)
    _close(got, want)


@pytest.mark.parametrize("order", [2, 3])
def test_dpmpp_adaptive_matches_jax(order):
    calls = []
    t_fn, j_fn = _fns(calls)
    x_T = _x_T(4)
    got = ts.dpmpp_adaptive_sample(t_fn, torch.from_numpy(x_T),
                                   NoiseSchedule(1000), order=order)
    want = js.dpmpp_adaptive_sample(j_fn, jnp.asarray(x_T), JSchedule(1000),
                                    order=order)
    assert len(calls) > 10
    _close(got, want)


def test_dpm_inverse_matches_jax():
    t_fn, j_fn = _fns()
    x0 = _x_T(5)
    got = ts.dpm_inverse(t_fn, torch.from_numpy(x0), NoiseSchedule(1000), 15)
    want = js.dpm_inverse(j_fn, jnp.asarray(x0), JSchedule(1000), 15)
    _close(got, want)


def test_thresholding_and_add_noise_match_jax():
    x = 3.0 * _x_T(6)
    got = ts.dynamic_thresholding(torch.from_numpy(x), ratio=0.9)
    _close(got, js.dynamic_thresholding(jnp.asarray(x), ratio=0.9))
    t_fn, j_fn = _fns()
    t = np.array([300.0, 700.0], np.float32)
    got = ts.thresholded_x0_fn(t_fn, 0.95)(torch.from_numpy(x),
                                           torch.from_numpy(t))
    _close(got, js.thresholded_x0_fn(j_fn, 0.95)(jnp.asarray(x),
                                                 jnp.asarray(t)))
    noise = _x_T(7)
    got = ts.add_noise(NoiseSchedule(1000), torch.from_numpy(x), 0.4,
                       torch.from_numpy(noise))
    _close(got, js.add_noise(JSchedule(1000), jnp.asarray(x), 0.4,
                             jnp.asarray(noise)))


@pytest.mark.parametrize("method,calls", [("ddpm", 1000), ("ddim", 100),
                                          ("dpmsolver", 40), ("unipc", 30)])
def test_sample_dispatch_uses_the_jax_default_steps(method, calls):
    seen = []
    t_fn, j_fn = _fns(seen)
    x_T = _x_T(8)
    g = torch.Generator().manual_seed(0)
    got = ts.sample(method, t_fn, torch.from_numpy(x_T), NoiseSchedule(1000),
                    generator=g)
    assert len(seen) == calls and torch.isfinite(got).all()
    if method in ("dpmsolver", "unipc"):   # deterministic: equal to JAX's
        _close(got, js.sample(method, j_fn, jnp.asarray(x_T),
                              JSchedule(1000)))
    with pytest.raises(ValueError, match="unknown sample method"):
        ts.sample("euler", t_fn, torch.from_numpy(x_T), NoiseSchedule(1000))


@pytest.mark.parametrize("method", ["ddpm", "ddim", "dpmsolver", "unipc"])
def test_generate_mel_runs_every_method(method):
    cfg = tiny_config()
    model = NaturalSpeech2(cfg)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    g = torch.Generator().manual_seed(1)
    c, refer = torch.randn(1, 16, 256, generator=g), torch.randn(1, 8, 100,
                                                                  generator=g)
    steps = None if method == "ddpm" else 3
    if method == "ddpm":   # all T steps: a 20-step schedule keeps it short
        model.schedule = NoiseSchedule(20)
    mels = [generate_mel(model.eval(), c, refer, torch.tensor([16]),
                         torch.tensor([8]),
                         generator=torch.Generator().manual_seed(7),
                         method=method, steps=steps) for _ in range(2)]
    assert mels[0].shape == (1, 16, 100) and torch.isfinite(mels[0]).all()
    assert torch.equal(mels[0], mels[1])   # seeded: reproducible
