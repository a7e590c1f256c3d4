"""The port's serving slice as a whole, its sampler and schedule, and the
package's import hygiene.

The slice test runs the JAX package's `generate_mel` and Vocos, and the
port's, on the tiny configuration of the JAX tests, the same weights
(through `convert.from_flax`) and the same initial noise x_T, in f32.
Tolerances: NoiseSchedule arrays exact, UniPC on a toy x0 function 1e-4,
mel and waveform of the slice 1e-3.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu.config import (
    Config, DataConfig, DiffusionEncoderConfig, EncoderConfig,
)
from ns2vc_tpu.diffusion import samplers as jsamplers
from ns2vc_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from ns2vc_tpu.models import diffusion as jdiff
from ns2vc_tpu.models.vocos import Vocos as JaxVocos
from ns2vc_tpu_torch.convert import from_flax, vocos_from_flax
from ns2vc_tpu_torch.diffusion.samplers import unipc_sample
from ns2vc_tpu_torch.diffusion.schedule import NoiseSchedule
from ns2vc_tpu_torch.infer.svc import Svc, to_pcm16
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2, generate_mel
from ns2vc_tpu_torch.models.vocos import Vocos


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


SAMPLER_ATOL, SLICE_ATOL = 1e-4, 1e-3
VOCOS_KW = dict(dim=32, intermediate_dim=48, num_layers=2, n_fft=64,
                hop_length=16)


def tiny_config(hop_length=256):
    return Config(
        data=DataConfig(hop_length=hop_length),
        phoneme_encoder=EncoderConfig(n_layers=1),
        prompt_encoder=EncoderConfig(in_channels=100, n_layers=1),
        diffusion_encoder=DiffusionEncoderConfig(
            block_out_channels=(16, 24, 32, 40)))


def _filled_tree(init_fn, r, *args):
    """The parameter tree a flax init makes, with numpy values (no zero
    biases or unit norms, so every parameter matters)."""
    def fill(path, a):
        n = r.standard_normal(a.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return n / np.sqrt(np.prod(a.shape[:-1]))
        return (1.0 if name == "scale" else 0.0) + 0.05 * n
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_noise_schedule_copy_is_exact():
    mine, ref = NoiseSchedule(1000), JaxSchedule(1000)
    for name, val in vars(ref).items():
        np.testing.assert_array_equal(getattr(mine, name), val, err_msg=name)
    t = np.linspace(1e-3, 1.0, 37)
    for fn in ("marginal_log_alpha", "marginal_std", "marginal_lambda",
               "model_input_time"):
        np.testing.assert_array_equal(getattr(mine, fn)(t),
                                      getattr(ref, fn)(t), err_msg=fn)
    np.testing.assert_array_equal(mine.inverse_lambda(np.linspace(-5, 5, 9)),
                                  ref.inverse_lambda(np.linspace(-5, 5, 9)))
    np.testing.assert_array_equal(mine.time_uniform_steps(50),
                                  ref.time_uniform_steps(50))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("variant", ["bh2", "bh1", "vary_coeff"])
def test_unipc_matches_jax_and_counts_calls(order, variant):
    steps = 50
    x_T = np.random.default_rng(order).standard_normal((2, 8, 5)).astype(
        np.float32)
    calls = []

    def t_fn(x, t):
        calls.append(float(t[0]))
        return torch.tanh(0.8 * x) * (1.0 + t[:, None, None] / 2000.0)

    def j_fn(x, t):
        return jnp.tanh(0.8 * x) * (1.0 + t[:, None, None] / 2000.0)

    got = unipc_sample(t_fn, torch.from_numpy(x_T), NoiseSchedule(1000),
                       steps, order=order, variant=variant)
    want = jsamplers.unipc_sample(j_fn, jnp.asarray(x_T), JaxSchedule(1000),
                                  steps, order=order, variant=variant)
    assert len(calls) == steps
    assert calls[0] == pytest.approx(999.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLER_ATOL)


def test_slice_matches_jax_generate_mel_and_vocos():
    cfg = tiny_config()
    r = np.random.default_rng(0)
    b, t, tp, steps = 2, 16, 12, 4
    c = r.standard_normal((b, t, 256)).astype(np.float32)
    refer = r.standard_normal((b, tp, 100)).astype(np.float32)
    lengths, refer_lengths = np.array([16, 11]), np.array([12, 7])

    jmodel = jdiff.NaturalSpeech2(cfg)
    batch = {"c": c, "refer": refer, "spec": np.zeros((b, t, 100), np.float32),
             "lengths": lengths, "refer_lengths": refer_lengths}
    params = _filled_tree(lambda k: jmodel.init(k, batch, k), r)
    jvocos = JaxVocos(**VOCOS_KW)
    vparams = _filled_tree(jvocos.init, r, np.zeros((1, t, 100), np.float32))

    rng = jax.random.PRNGKey(7)

    @jax.jit
    def jax_slice(params, vparams, c, refer, lengths, refer_lengths):
        mel = jdiff.generate_mel(jmodel, params, c, refer, lengths,
                                 refer_lengths, rng, method="unipc",
                                 steps=steps)
        return mel, jvocos.apply(vparams, mel)

    want_mel, want_wav = jax_slice(params, vparams, c, refer, lengths,
                                   refer_lengths)
    # generate_mel draws x_T from the first half of its key split
    noise_rng, _ = jax.random.split(rng)
    x_T = np.array(jax.random.normal(noise_rng, (b, t, 100), jnp.float32))

    model = NaturalSpeech2(cfg)
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, params), cfg))
    vocos = Vocos(**VOCOS_KW)
    vocos.load_state_dict(vocos_from_flax(jax.tree.map(np.asarray, vparams),
                                          **VOCOS_KW))
    mel = generate_mel(model.eval(), torch.from_numpy(c),
                       torch.from_numpy(refer), torch.from_numpy(lengths),
                       torch.from_numpy(refer_lengths),
                       x_T=torch.from_numpy(x_T), steps=steps)
    with torch.no_grad():
        wav = vocos.eval()(mel)
    np.testing.assert_allclose(mel.numpy(), np.asarray(want_mel),
                               atol=SLICE_ATOL)
    np.testing.assert_allclose(wav.numpy(), np.asarray(want_wav),
                               atol=SLICE_ATOL)


def test_svc_batches_buckets_and_trims():
    from ns2vc_tpu_torch.convert import init_params, init_vocos_params

    cfg = tiny_config(hop_length=VOCOS_KW["hop_length"])
    g = torch.Generator().manual_seed(0)
    svc = Svc(config=cfg, params=init_params(cfg, g),
              vocos_params=init_vocos_params(g, **VOCOS_KW), device="cpu")
    hop = VOCOS_KW["hop_length"]
    r = np.random.default_rng(1)
    clips = [r.standard_normal((n, 256)).astype(np.float32) for n in (40, 70)]
    refer = r.standard_normal((30, 100)).astype(np.float32)
    wav = svc.infer_batch(clips, refer, sampling_timesteps=3, seed=5)
    pcm = svc.infer_batch(clips, refer, sampling_timesteps=3, seed=5,
                          output="pcm16")
    assert [w.shape for w in wav] == [(40 * hop,), (70 * hop,)]
    for w, p in zip(wav, pcm):
        assert w.dtype == np.float32 and np.isfinite(w).all()
        assert p.dtype == np.int16
        np.testing.assert_array_equal(p, to_pcm16(torch.from_numpy(w)))
    single = svc.infer_from_features(clips[0], refer, sampling_timesteps=3)
    assert single.shape == (40 * hop,) and np.isfinite(single).all()


def test_import_pulls_in_no_jax():
    """Importing the port (its CLIs, feature models, serving, training, the
    data pipeline, the host DSP and the native DIO) and `chip_smoke` adds
    no jax/flax module and no
    module of `ns2vc_tpu`, and builds no kernel; a host F0 call after that
    still leaves JAX and `ns2vc_tpu` out of sys.modules."""
    code = """
import sys
import numpy as np
before = set(sys.modules)
import ns2vc_tpu_torch
import ns2vc_tpu_torch.convert, ns2vc_tpu_torch.infer.svc
import ns2vc_tpu_torch.infer.cli, ns2vc_tpu_torch.infer.serve
import ns2vc_tpu_torch.features.contentvec, ns2vc_tpu_torch.features.crepe
import ns2vc_tpu_torch.ops.flash_attention, ns2vc_tpu_torch.ops.fused_resnet
import ns2vc_tpu_torch.native, ns2vc_tpu_torch.utils.convert_reference
import ns2vc_tpu_torch.data.dataset, ns2vc_tpu_torch.data.preprocess
import ns2vc_tpu_torch.train.trainer, ns2vc_tpu_torch.train.cli
import ns2vc_tpu_torch.ops.sequence, ns2vc_tpu_torch.diffusion.wrappers
import ns2vc_tpu_torch.models.lora, ns2vc_tpu_torch.models.op_registry
import chip_smoke
from ns2vc_tpu_torch.audio import host
from ns2vc_tpu_torch.ops import _build

def bad():
    return sorted(m for m in set(sys.modules) - before
                  if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ns2vc_tpu'))
assert not bad(), bad()
assert _build._lib is None
t = np.arange(24000) / 24000
f0 = host.compute_f0_ac(np.sin(2 * np.pi * 200 * t), 24000, 256)
assert abs(np.median(f0[f0 > 0]) - 200) < 5
host.compute_f0_dio(np.sin(2 * np.pi * 200 * t), sampling_rate=24000,
                    hop_length=256)
assert not bad(), bad()
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
