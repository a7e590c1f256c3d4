"""Svc's serving programs on the CPU: the staged body, its key and cache.

On the CPU a program runs its body eagerly over its static buffers and the
noise drawn before it, as a card replays the graph captured over them.
Held bit for bit (same ops on the same inputs in the same order) against
`generate_mel` + Vocos + `to_pcm16` called directly with the same seed's
x_T and per-step noise, and against the eager body (`Svc._run_eager`, the
samplers drawing their own noise from the seeded generator), for every
sampler, with and without the F0 predictor and `auto_predict_f0`. Tiny
configurations: one encoder layer, UNet (16, 24), 25 diffusion timesteps
(DDPM runs all of them), B <= 2, T <= 128 frames, 3 sampler steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ns2vc_tpu_torch.config import (
    Config, DataConfig, DiffusionEncoderConfig, EncoderConfig,
    F0PredictorConfig,
)
from ns2vc_tpu_torch.convert import init_params, init_vocos_params
from ns2vc_tpu_torch.infer.svc import Svc, _bucket, to_pcm16
from ns2vc_tpu_torch.models.diffusion import generate_mel

VOCOS_KW = dict(dim=32, intermediate_dim=48, num_layers=2, n_fft=64,
                hop_length=16)
TIMESTEPS = 25          # linear betas stay below 1 above 20 steps
STEPS = 3


def _config(f0: bool) -> Config:
    cfg = Config(
        data=DataConfig(hop_length=VOCOS_KW["hop_length"]),
        phoneme_encoder=EncoderConfig(n_layers=1),
        prompt_encoder=EncoderConfig(in_channels=100, n_layers=1),
        diffusion_encoder=DiffusionEncoderConfig(block_out_channels=(16, 24)),
        f0_predictor=F0PredictorConfig(enabled=f0, attention_layers=1))
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, timesteps=TIMESTEPS))


def _svc(f0: bool = False, dtype: str = "float32") -> Svc:
    cfg = _config(f0)
    g = torch.Generator().manual_seed(0)
    return Svc(config=cfg, params=init_params(cfg, g),
               vocos_params=init_vocos_params(g, **VOCOS_KW),
               compute_dtype=dtype, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These models are tiny: one intra-op thread runs them fastest, and
    several test workers share the host."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def svcs():
    return {"off": _svc(), "f0": _svc(f0=True),
            "bf16": _svc(dtype="bfloat16")}


def _request(lens=(40, 60), tp=30, f0=False, seed=0):
    r = np.random.default_rng(seed)
    clips = [(0.1 * r.standard_normal((n, 256))).astype(np.float32)
             for n in lens]
    refer = r.standard_normal((tp, 100)).astype(np.float32)
    f0s = uvs = None
    if f0:
        f0s = [(120.0 + 150.0 * r.random(n)).astype(np.float32)
               for n in lens]
        for a in f0s:
            a[3:6] = 0.0
        uvs = [(a > 0).astype(np.float32) for a in f0s]
    return clips, refer, f0s, uvs


def _run_args(svc, clips, refer, f0s, uvs):
    """`_run`'s padded inputs, as `infer_batch_async` makes them."""
    t_lens = [c.shape[0] for c in clips]
    n, t_pad = len(clips), _bucket(max(t_lens))
    c_in = np.zeros((n, t_pad, 256), np.float32)
    for i, c in enumerate(clips):
        c_in[i, : t_lens[i]] = c
    f0_in = uv_in = None
    if f0s is not None:
        f0_in = np.zeros((n, t_pad), np.float32)
        uv_in = np.zeros((n, t_pad), np.float32)
        for i in range(n):
            f0_in[i, : t_lens[i]] = f0s[i]
            uv_in[i, : t_lens[i]] = uvs[i]
    r_dev = svc._device_refer(refer, n, _bucket(refer.shape[0]))
    return c_in, r_dev, t_lens, refer.shape[0], f0_in, uv_in


def _direct(svc, c_in, r_dev, t_lens, tp_len, f0_in, uv_in, seed, method,
            output, auto, eta):
    """generate_mel + Vocos (+ pcm16) with x_T and each draw taken from the
    seed's generator here: x_T, then DDPM's draw after each of its calls,
    DDIM's after each call but the last when eta > 0."""
    g = torch.Generator().manual_seed(seed)
    shape = (*c_in.shape[:2], svc.cfg.diffusion_encoder.out_channels)
    x_T = torch.randn(shape, generator=g, dtype=svc.compute_dtype)
    n_draws = {"ddpm": TIMESTEPS,
               "ddim": STEPS - 1 if eta else 0}.get(method, 0)
    noise = [torch.randn(shape, generator=g, dtype=svc.compute_dtype)
             for _ in range(n_draws)] or None
    t = torch.from_numpy
    with torch.no_grad():
        mel = generate_mel(
            svc.model, t(c_in), r_dev, t(np.asarray(t_lens, np.int64)),
            t(np.full((len(t_lens),), tp_len, np.int64)), x_T=x_T,
            method=method, steps=STEPS, order=2, noise=noise,
            f0=None if f0_in is None else t(f0_in),
            uv=None if uv_in is None else t(uv_in), auto_predict_f0=auto,
            eta=eta)
        wav = svc.vocos(mel)
    return to_pcm16(wav) if output == "pcm16" else wav


SAMPLERS = [("ddpm", 0.0), ("ddim", 0.0), ("ddim", 0.5), ("dpmsolver", 0.0),
            ("unipc", 0.0)]


@pytest.mark.parametrize("method,eta", SAMPLERS)
@pytest.mark.parametrize("which,auto", [("off", False), ("f0", False),
                                        ("f0", True)])
def test_program_equals_the_direct_call_and_the_eager_body(
        svcs, method, eta, which, auto):
    svc = svcs[which]
    clips, refer, f0s, uvs = _request(f0=which == "f0")
    c_in, r_dev, t_lens, tp_len, f0_in, uv_in = _run_args(
        svc, clips, refer, f0s, uvs)
    output = "pcm16" if method == "unipc" else "float32"
    args = (c_in, r_dev, t_lens, tp_len, method, STEPS, 2, 7, output, f0_in,
            uv_in, auto, eta)
    got = svc._run(*args)
    want = _direct(svc, c_in, r_dev, t_lens, tp_len, f0_in, uv_in, 7,
                   method, output, auto, eta)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(svc._run_eager(*args), got)
    # the program's static output is not what a later call returns
    prog = next(p for k, p in svc._programs.items()
                if k.method == method and k.eta == eta
                and k.auto_predict_f0 == auto)
    assert prog.graph is None and prog.out is None
    assert len(prog.static["draws"]) == {"ddpm": TIMESTEPS, "ddim": (
        STEPS - 1 if eta else 0)}.get(method, 0)


@pytest.mark.parametrize("method,eta", [("ddpm", 0.0), ("ddim", 0.5)])
def test_program_draws_the_noise_in_the_compute_dtype(svcs, method, eta):
    """bf16: x_T and each step's noise in bf16, as the samplers draw them
    from a bf16 x."""
    svc = svcs["bf16"]
    clips, refer, _, _ = _request(lens=(50,), seed=1)
    c_in, r_dev, t_lens, tp_len, _, _ = _run_args(svc, clips, refer, None,
                                                  None)
    args = (c_in, r_dev, t_lens, tp_len, method, STEPS, 2, 3, "float32",
            None, None, False, eta)
    got = svc._run(*args)
    assert torch.equal(got, _direct(svc, c_in, r_dev, t_lens, tp_len, None,
                                    None, 3, method, "float32", False, eta))
    assert torch.equal(got, svc._run_eager(*args))


def test_infer_batch_serves_through_the_program_and_keeps_the_seed(svcs):
    """The public entry points reach the program: the trimmed waveforms
    are the eager body's, a second seed gives other audio, and the first
    seed again gives the first call's audio bit for bit."""
    svc = _svc()
    clips, refer, _, _ = _request()
    kw = dict(sample_method="ddim", sampling_timesteps=STEPS, eta=0.5)
    first = svc.infer_batch(clips, refer, seed=4, **kw)
    other = svc.infer_batch(clips, refer, seed=5, **kw)
    again = svc.infer_batch(clips, refer, seed=4, **kw)
    eager = svc._run_eager
    svc._run = eager
    try:
        want = svc.infer_batch(clips, refer, seed=4, **kw)
    finally:
        del svc._run
    assert len(svc._programs) == 1
    for a, b, c, d in zip(first, other, again, want):
        assert a.shape == d.shape and np.array_equal(a, c)
        assert np.array_equal(a, d) and not np.array_equal(a, b)


def _key_of(svc, clips, refer, **kw):
    before = set(svc._programs)
    svc.infer_batch(clips, refer, **kw)
    new = set(svc._programs) - before
    return next(iter(new)) if new else None


def test_program_key_reuses_a_bucket_and_splits_on_every_field():
    svc = _svc()
    clips, refer, _, _ = _request(lens=(40, 70))
    kw = dict(sampling_timesteps=STEPS, order=2)
    base = _key_of(svc, clips, refer, **kw)
    assert base is not None and (base.batch, base.t_pad, base.tp_pad) == (
        2, 128, 64)
    # other lengths, another seed, the same buckets: the same program
    assert _key_of(svc, [c[:66] for c in clips], refer[:20], seed=9,
                   **kw) is None
    new = {
        "batch": _key_of(svc, clips[1:], refer, **kw),
        "t_pad": _key_of(svc, [c[:60] for c in clips], refer, **kw),
        "tp_pad": _key_of(svc, clips, np.concatenate([refer] * 3), **kw),
        "steps": _key_of(svc, clips, refer, sampling_timesteps=STEPS + 1,
                         order=2),
        "order": _key_of(svc, clips, refer, sampling_timesteps=STEPS,
                         order=1),
        "output": _key_of(svc, clips, refer, output="pcm16", **kw),
        "method": _key_of(svc, clips, refer, sample_method="dpmsolver",
                          **kw),
    }
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for field, (mm, dnn) in (("tf32_matmul", (not saved[0], saved[1])),
                                 ("tf32_cudnn", (saved[0], not saved[1]))):
            torch.backends.cuda.matmul.allow_tf32 = mm
            torch.backends.cudnn.allow_tf32 = dnn
            new[field] = _key_of(svc, clips, refer, **kw)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    for field, key in new.items():
        assert key is not None, f"{field}: no new program"
        assert [f for f in key._fields if getattr(key, f) != getattr(
            base, f)] == [field], (field, key, base)
    assert len(svc._programs) == 1 + len(new)
    bf16 = _svc(dtype="bfloat16")
    key16 = _key_of(bf16, clips, refer, **kw)
    assert key16 == base._replace(dtype=torch.bfloat16)


def test_unload_model_empties_the_program_cache():
    svc = _svc()
    clips, refer, _, _ = _request()
    svc.infer_batch(clips, refer, sampling_timesteps=STEPS)
    mem = svc._program_memory()
    assert mem["programs"] == 1 and mem["static_bytes"] > 0
    assert mem["pool_bytes"] == 0
    svc.unload_model()
    assert svc._programs == {} and svc._program_memory()["static_bytes"] == 0


def test_replay_accounting_adds_and_takes_back_launch_counts(monkeypatch):
    """A replay adds the counts its capture took, a capture takes its own
    off; both read the counters' owners, also while the public names are
    replaced by the plain versions (as a plain-version run does)."""
    from ns2vc_tpu_torch.ops import flash_attention as k1, fused_resnet as k2

    monkeypatch.setattr(k2, "affine_silu_conv1d",
                        k2.affine_silu_conv1d_plain)
    monkeypatch.setattr(k1, "flash_attention", k1.flash_attention_plain)
    for ops in (k1, k2):
        ops.reset_launches()
        before = ops.launch_counts()
        assert set(before.values()) == {0}
        delta = {k: i + 1 for i, k in enumerate(before)}
        ops.add_launch_counts(delta)
        ops.add_launch_counts(delta)
        assert ops.launch_counts() == {k: 2 * n for k, n in delta.items()}
        ops.add_launch_counts(delta, -2)
        assert ops.launch_counts() == before
    assert k2._gn_counts.launches == 0 and k2._conv_counts.launches == 0


def test_a_replay_adds_back_the_collectives_calls_and_bytes():
    """A GraphProgram's replay adds its capture's all-reduce and
    all-gather calls and bytes to the mesh's counters, as it adds the
    kernels' launches; a capture's own are taken off the same way."""
    from ns2vc_tpu_torch.parallel import mesh
    from ns2vc_tpu_torch.utils import graphs

    class Graph:
        def replay(self):
            pass
    mesh.reset_counters()
    try:
        before = graphs.launch_counts()
        assert before[-1] == mesh.launch_counts()
        assert set(before[-1]) == {f"{c}.{k}" for c in mesh.counters()
                                   for k in ("calls", "bytes")}
        prog = graphs.GraphProgram("step", {})
        prog.graph = Graph()
        prog.counts = [{k: 0 for k in c} for c in before]
        prog.counts[-1].update({"all_reduce_mean.calls": 1,
                                "all_reduce_mean.bytes": 4 * 1003,
                                "all_reduce_sum.calls": 3,
                                "all_reduce_sum.bytes": 4 * 96,
                                "all_gather.calls": 2,
                                "all_gather.bytes": 2 * 4 * 512})
        prog.replay()
        prog.replay()
        assert mesh.counters() == {
            "all_reduce_mean": {"calls": 2, "bytes": 8 * 1003},
            "all_reduce_sum": {"calls": 6, "bytes": 8 * 96},
            "all_gather": {"calls": 4, "bytes": 16 * 512}}
        assert prog.replays == 2
        graphs.add_launch_counts(prog.counts, -2)
        assert graphs.launch_counts() == before
    finally:
        mesh.reset_counters()
