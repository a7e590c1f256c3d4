"""The port's training slice against the JAX package's, on the CPU.

- The loss of `NaturalSpeech2.forward` and every parameter's gradient match
  JAX `NaturalSpeech2.__call__` (deterministic) and `jax.grad` on the same
  weights (through `convert.from_flax`), with t and noise drawn by the JAX
  calls and injected into the port. Tolerances: loss 1e-5 relative; each
  gradient within 1e-4 * max(1e-3, max|g_jax|).
- Remat off / "all" / "dots" give the same gradients, also with K1's and
  K2's autograd Functions in the path (their launches replaced by the
  plain versions, `test_torch_kernels.kernels_on_cpu`), within 1e-5 of
  each gradient's scale.
- AdamW + global-norm clipping match `make_optimizer` (optax) over three
  steps, one over the clip threshold: 1e-6 relative.
- One train step with accumulation 2 and p_dropout 0 (JAX's loss always
  runs with dropout on), three times over, matches `make_train_step`:
  loss 1e-5 and grad norm 1e-4 relative, parameters and EMA within 1e-3 of
  lr per step. Adam's eps is 1e-3 there: at the config's 1e-9 Adam turns a
  gradient that is zero in exact arithmetic (the pooled attentions' key
  bias, which shifts every key's logit alike) into a +-lr update of either
  framework's rounding noise.
- Dropout keeps 1 - p of the values, scaled by 1/(1 - p).
- The Trainer runs on `device="cpu"`: steps, eval sample, checkpoints,
  resume to the same state and the same next loss, the CLI, `Svc` serving
  from its checkpoint (EMA preferred), the warm start; without a card the
  default device refuses.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu import config as jconfig
from ns2vc_tpu.models import diffusion as jdiff
from ns2vc_tpu.train import trainer as jtrainer
from ns2vc_tpu_torch import config as tconfig
from ns2vc_tpu_torch.convert import from_flax
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
from ns2vc_tpu_torch.ops.flash_attention import flash_attention
from ns2vc_tpu_torch.ops.fused_resnet import affine_silu_conv1d
from ns2vc_tpu_torch.train import trainer as ttrainer
from test_torch_data import write_features
from test_torch_kernels import kernels_on_cpu
from test_torch_slice import _filled_tree


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


LOSS_RTOL, GRAD_RTOL, OPT_RTOL = 1e-5, 1e-4, 1e-6
LEVELS = (16, 24)   # two UNet levels keep the JAX compile short


def configs(levels=LEVELS, p_dropout=0.2, data=None, **train):
    """The same configuration in the JAX package's classes and the port's."""
    def make(m):
        return m.Config(
            train=m.TrainConfig(**train),
            data=m.DataConfig(**(data or {})),
            phoneme_encoder=m.EncoderConfig(n_layers=1, p_dropout=p_dropout),
            prompt_encoder=m.EncoderConfig(in_channels=100, n_layers=1,
                                           p_dropout=p_dropout),
            diffusion_encoder=m.DiffusionEncoderConfig(
                block_out_channels=levels))
    return make(jconfig), make(tconfig)


def _batch(r, b=2, t=16, tp=12, lengths=(16, 11), refer_lengths=(12, 7)):
    return {"c": r.standard_normal((b, t, 256)).astype(np.float32),
            "refer": r.standard_normal((b, tp, 100)).astype(np.float32),
            "spec": r.standard_normal((b, t, 100)).astype(np.float32),
            "lengths": np.array(lengths, np.int32),
            "refer_lengths": np.array(refer_lengths, np.int32)}


def _draws(rng, b, t):
    """t and noise as JAX NaturalSpeech2.__call__ draws them from `rng`."""
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    return (np.asarray(jax.random.randint(t_rng, (b,), 0, 1000)),
            np.asarray(jax.random.normal(n_rng, (b, t, 100), jnp.float32)))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_model(params, cfg, **kw):
    m = NaturalSpeech2(cfg, **kw)
    m.load_state_dict(from_flax(jax.tree.map(np.asarray, params), cfg))
    return m


@pytest.fixture(scope="module")
def grad_pair():
    """JAX loss and gradients (jit once) and the port model on the same
    weights, with the clamped SNR weight on."""
    jcfg, cfg = configs(min_snr_loss_weight=True)
    r = np.random.default_rng(0)
    batch = _batch(r)
    jm = jdiff.NaturalSpeech2(jcfg)
    params = _filled_tree(lambda k: jm.init(k, batch, k), r)
    rng = jax.random.PRNGKey(3)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, batch, rng, deterministic=True)[0]))(params)
    t, noise = _draws(rng, 2, 16)
    return {"cfg": cfg, "params": params, "batch": batch, "t": t,
            "noise": noise, "loss": float(loss),
            "grads": from_flax(jax.tree.map(np.asarray, grads), cfg)}


def _port_grads(model, pair):
    model.zero_grad(set_to_none=True)
    loss, aux = model(_torch(pair["batch"]), t=torch.from_numpy(pair["t"]),
                      noise=torch.from_numpy(pair["noise"]))
    loss.backward()
    return loss.item(), aux, {n: p.grad for n, p in model.named_parameters()}


def test_loss_matches_jax(grad_pair):
    model = _port_model(grad_pair["params"], grad_pair["cfg"]).eval()
    loss, aux, _ = _port_grads(model, grad_pair)
    assert abs(loss - grad_pair["loss"]) <= LOSS_RTOL * abs(grad_pair["loss"])
    assert aux["pred"].dtype == torch.float32
    assert aux["pred"].shape == aux["target"].shape == (2, 16, 100)
    # padded frames of the target are zero
    assert (aux["target"][1, 11:] == 0).all()


def test_every_gradient_matches_jax(grad_pair):
    model = _port_model(grad_pair["params"], grad_pair["cfg"]).eval()
    _, _, grads = _port_grads(model, grad_pair)
    want = grad_pair["grads"]
    assert set(grads) == set(want)
    worst = {}
    for name, g in grads.items():
        assert g is not None, name
        scale = max(1e-3, want[name].abs().max().item())
        worst[name] = (g - want[name]).abs().max().item() / scale
    bad = {k: v for k, v in worst.items() if not v <= GRAD_RTOL}
    assert not bad, bad


@pytest.mark.parametrize("policy", ["off", "all", "dots"])
def test_remat_gives_the_same_grads_through_the_kernels(grad_pair, policy):
    """With K1's and K2's Functions in the path, every remat mode gives the
    gradients of the plain path without remat; under remat the kernels
    launch again in the backward pass (their outputs are recomputed)."""
    model = _port_model(grad_pair["params"], grad_pair["cfg"]).eval()
    _, _, want = _port_grads(model, grad_pair)
    unet = model.diff_model.unet
    unet.remat, unet.remat_policy = policy != "off", \
        "all" if policy == "off" else policy
    with kernels_on_cpu():
        k1, k2 = flash_attention.launches, affine_silu_conv1d.launches
        b1 = dict(flash_attention.backward_calls)
        _, _, got = _port_grads(model, grad_pair)
        launches = (flash_attention.launches - k1,
                    affine_silu_conv1d.launches - k2)
        backward = flash_attention.backward_calls["tc"] - b1["tc"]
    for name, g in got.items():
        scale = max(1e-3, want[name].abs().max().item())
        assert (g - want[name]).abs().max().item() <= 1e-5 * scale, name
    # two levels: 6 transformers (12 attentions), 2 encoder layers and 2
    # pooling calls; 12 resnet blocks (24 epilogues) and the output tail
    fwd = (16, 25)
    if policy == "off":
        assert launches == fwd
    else:   # each checkpointed block's kernels run again
        assert launches == (fwd[0] + 12, fwd[1] + 24)
    assert backward == 16


def test_optimizer_matches_optax():
    jcfg, cfg = configs(train_lr=1e-2)
    r = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: r.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (0.1 * r.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    grads[1] = {k: 30 * v for k, v in grads[1].items()}   # over the clip
    jopt = jtrainer.make_optimizer(jcfg)
    jstate, jparams = jopt.init(params), dict(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    topt = ttrainer.make_optimizer(cfg, list(tparams.values()))
    norms = []
    for g in grads:
        updates, jstate = jopt.update(g, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: np.asarray(p + u), jparams,
                               updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = ttrainer.clip_by_global_norm(
            [p.grad for p in tparams.values()], cfg.train.grad_clip_norm)
        norms.append((norm.item(), float(jtrainer.optax.global_norm(g))))
        topt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), jparams[k],
                                       rtol=OPT_RTOL, atol=1e-7, err_msg=k)
    assert norms[1][1] > 1.0 > norms[0][1]
    for got, want in norms:
        assert got == pytest.approx(want, rel=OPT_RTOL)


@pytest.fixture(scope="module")
def step_pair():
    """Three JAX train steps (accum 2, EMA every 2 steps, p_dropout 0, jit
    once) and the same three through the port, with JAX's draws."""
    jcfg, cfg = configs(p_dropout=0.0, train_lr=1e-3, eps=1e-3,
                        gradient_accumulate_every=2, use_ema=True,
                        ema_decay=0.9, ema_update_every=2)
    r = np.random.default_rng(2)
    batch = _batch(r, b=4, lengths=(16, 11, 9, 16),
                   refer_lengths=(12, 7, 12, 5))
    jm = jdiff.NaturalSpeech2(jcfg)
    params = _filled_tree(lambda k: jm.init(k, batch, k), r)
    jopt = jtrainer.make_optimizer(jcfg)
    jstep = jax.jit(jtrainer.make_train_step(jm, jopt, accum=2,
                                             ema_decay=0.9, ema_every=2))
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=params, opt_state=jopt.init(params),
                                 ema_params=params)
    model = _port_model(params, cfg)
    state = ttrainer.TrainState(
        model=model, optimizer=ttrainer.make_optimizer(cfg,
                                                       model.parameters()),
        ema_params=ttrainer.init_ema(model))
    tstep = ttrainer.make_train_step(accum=2, ema_decay=0.9, ema_every=2,
                                     max_norm=cfg.train.grad_clip_norm)
    rng = jax.random.PRNGKey(5)
    steps = []
    for s in range(3):
        jstate, jm_ = jstep(jstate, batch, rng)
        draws = [_draws(jax.random.fold_in(jax.random.fold_in(rng, s), i),
                        2, 16) for i in range(2)]
        tm = tstep(state, _torch(batch),
                   t=torch.from_numpy(np.concatenate([d[0] for d in draws])),
                   noise=torch.from_numpy(np.concatenate([d[1]
                                                          for d in draws])))
        steps.append({
            "jax": (float(jm_["loss"]), float(jm_["grad_norm"]),
                    from_flax(jax.tree.map(np.asarray, jstate.params), cfg),
                    from_flax(jax.tree.map(np.asarray, jstate.ema_params),
                              cfg)),
            "port": (tm["loss"].item(), tm["grad_norm"].item(),
                     {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
                     {k: v.clone() for k, v in state.ema_params.items()})})
    return cfg, state, steps


def _close(got: dict, want: dict, atol: float):
    bad = {k: (got[k] - want[k]).abs().max().item() for k in want
           if not (got[k] - want[k]).abs().max().item() <= atol}
    assert not bad, bad


def test_train_step_matches_jax(step_pair):
    cfg, state, steps = step_pair
    assert state.step == 3
    lr = cfg.train.train_lr
    for i, s in enumerate(steps):
        (jl, jn, jp, _), (tl, tn, tp, _) = s["jax"], s["port"]
        assert tl == pytest.approx(jl, rel=LOSS_RTOL)
        assert tn == pytest.approx(jn, rel=GRAD_RTOL)
        _close(tp, jp, 1e-3 * lr * (i + 1))
    assert steps[0]["jax"][1] > cfg.train.grad_clip_norm   # clipped


def test_ema_matches_jax(step_pair):
    cfg, _, steps = step_pair
    lr = cfg.train.train_lr
    for i, s in enumerate(steps):
        _close(s["port"][3], s["jax"][3], 1e-3 * lr * (i + 1))
    # no update after step 1 ((0 + 1) % 2 != 0), one after step 2
    first, second = steps[0]["port"][3], steps[1]["port"][3]
    name = "diff_model.unet.conv_in.weight"
    assert not torch.equal(first[name], second[name])


def test_checkpoint_utilities_match_jax(tmp_path):
    from ns2vc_tpu.utils import checkpoints as jck
    from ns2vc_tpu_torch.utils import checkpoints as tck

    r = np.random.default_rng(8)
    trees = [{"a": r.standard_normal((3, 4)).astype(np.float32),
              "b": r.standard_normal(5).astype(np.float32)}
             for _ in range(3)]
    ratios = [0.5, 0.3, 0.2]
    want = jck.mix_models(trees, ratios)
    got = tck.mix_models([_torch(t) for t in trees], ratios)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    target = {"a": trees[0]["a"], "b": trees[0]["b"]}
    restored = {"a": trees[1]["a"], "b": np.zeros(6, np.float32)}
    want = jck.partial_restore(target, restored, verbose=False)
    got = tck.partial_restore(_torch(target), _torch(restored),
                              verbose=False)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    del restored["a"]
    assert torch.equal(tck.partial_restore(_torch(target), _torch(restored),
                                           verbose=False)["a"],
                       torch.from_numpy(target["a"]))
    for name in ("model-3.pt", "model-12.pt", "7", "notes.txt"):
        (tmp_path / name).touch()
    assert tck.latest_checkpoint_path(str(tmp_path)) == \
        jck.latest_checkpoint_path(str(tmp_path)) == \
        str(tmp_path / "model-12.pt")
    assert tck.latest_checkpoint_path(str(tmp_path / "none")) is None


def test_dummy_batch_and_host_transform_match_jax():
    """The same batch layout as the JAX trainer's; host_transform drops
    the same fields and leaves floats f32 (the device casts them)."""
    jcfg, cfg = configs(train_batch_size=3, max_content_frames=48,
                        max_refer_frames=40)
    for geometry in (None, (32, 24)):
        want = jtrainer.dummy_batch(jcfg, geometry)
        got = ttrainer.dummy_batch(cfg, geometry)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
    batch = ttrainer.dummy_batch(cfg)
    jbatch = jtrainer.host_transform(batch, jcfg)    # f32 compute dtype
    assert sorted(ttrainer.host_transform(batch, cfg)) == sorted(jbatch)
    dev = ttrainer.put_local_batch(ttrainer.host_transform(batch, cfg),
                                   torch.device("cpu"), torch.bfloat16)
    assert dev["c"].dtype == torch.bfloat16
    assert dev["lengths"].dtype == torch.int32


def test_dropout_rate_and_scaling():
    from ns2vc_tpu_torch.models.encoders import Dropout

    d = Dropout(0.2).train()
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = d(x, g)
    kept = y != 0
    assert abs(1.0 - kept.float().mean().item() - 0.2) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1.0 / 0.8))
    assert torch.equal(d(x, torch.Generator().manual_seed(0)), y)
    with pytest.raises(ValueError, match="generator"):
        d(x)
    assert d.eval()(x) is x


def test_encoder_dropout_only_in_train_mode():
    _, cfg = configs(p_dropout=0.5)
    enc = NaturalSpeech2(cfg).pre_model.phoneme_encoder
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.standard_normal((1, 10, 256)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((1, 100)).astype(np.float32))
    mask = torch.ones(1, 10, dtype=torch.bool)
    enc.eval()
    a, b = enc(x, mask, g), enc(x, mask, g)
    assert torch.equal(a, b)
    enc.train()
    c = enc(x, mask, g, torch.Generator().manual_seed(1))
    d = enc(x, mask, g, torch.Generator().manual_seed(1))
    assert torch.equal(c, d) and not torch.allclose(c, a)


# -- the Trainer ---------------------------------------------------------------

def _trainer_config(root, **train):
    feats = write_features(os.path.join(root, "feats"),
                           [40, 56, 64, 48, 36, 60, 44, 52], hop=256,
                           audio_rates=(24000,))
    kw = dict(train_batch_size=2, train_num_steps=3, log_every=1,
              save_and_sample_every=2, keep_ckpts=2, max_content_frames=40,
              max_refer_frames=32, num_workers=0, remat=True,
              remat_policy="dots", use_ema=True, ema_update_every=1,
              ema_decay=0.9, compute_dtype="float32", train_lr=1e-3,
              logs_folder=os.path.join(root, "logs"))
    kw.update(train)
    _, cfg = configs(levels=(16, 24), data={"training_files": feats,
                                            "val_files": feats}, **kw)
    return cfg


def test_trainer_trains_saves_resumes_and_serves(tmp_path, capsys):
    from ns2vc_tpu_torch.convert import init_vocos_params, load_checkpoint
    from ns2vc_tpu_torch.infer.svc import Svc

    cfg = _trainer_config(str(tmp_path))
    vkw = dict(dim=32, intermediate_dim=48, num_layers=1, hop_length=256)
    vsd = init_vocos_params(torch.Generator().manual_seed(3), **vkw)
    logs = str(tmp_path / "run")
    tr = ttrainer.Trainer(cfg, logs_folder=logs, vocos_params=vsd,
                          device="cpu")
    tr.train()
    out = capsys.readouterr().out
    assert tr.step == 3 and "training complete" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["1", "2", "3"]
    assert all(" loss " in ln and " grad_norm " in ln and " steps/s " in ln
               for ln in lines)
    with open(os.path.join(logs, "scalars.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    losses = [r["loss/diff"] for r in records if "loss/diff" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()
    evals = [r for r in records if "gen_mel" in r]
    assert len(evals) == 1 and os.path.exists(evals[0]["gen_audio"])
    mel = np.load(evals[0]["gen_mel"])
    assert mel.shape[1] == 100 and np.isfinite(mel).all()
    assert os.path.exists(os.path.join(logs, "sample-1.wav"))
    assert os.path.exists(os.path.join(logs, "config.json"))
    # checkpoints at steps 2 and 3 (keep_ckpts 2)
    assert sorted(os.listdir(tr.ckpt_dir)) == ["model-2.pt", "model-3.pt"]

    tr2 = ttrainer.Trainer(cfg, logs_folder=logs, device="cpu")
    tr2.load()
    assert tr2.step == 3
    for (k, a), b in zip(tr.model.state_dict().items(),
                         tr2.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k, v in tr.state.ema_params.items():
        assert torch.equal(v, tr2.state.ema_params[k]), k
    s1, s2 = tr.state.optimizer.state_dict(), tr2.state.optimizer.state_dict()
    for i, st in s1["state"].items():
        for key, v in st.items():
            assert torch.equal(v, s2["state"][i][key]), (i, key)
    ema = {k: v.clone() for k, v in tr2.state.ema_params.items()}
    batch = tr.device_batch(next(tr.loader()))
    l1, l2 = tr.train_step(batch)["loss"], tr2.train_step(batch)["loss"]
    assert l1.item() == l2.item() and tr.step == tr2.step == 4
    tr.close()

    # Svc deploys the EMA parameters unless told otherwise
    ckpt = os.path.join(tr2.ckpt_dir, "model-3.pt")
    raw = load_checkpoint(ckpt, cfg, use_ema=False)
    for use_ema, want in ((True, ema), (False, raw)):
        svc = Svc(ckpt, config=cfg, vocos_params=vsd, contentvec_ckpt="",
                  device="cpu", use_ema_params=use_ema)
        got = svc.model.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v.cpu()), k
    assert not torch.equal(raw["diff_model.unet.conv_in.weight"],
                           ema["diff_model.unet.conv_in.weight"])
    r = np.random.default_rng(6)
    wav = svc.infer_from_features(
        r.standard_normal((30, 256)).astype(np.float32),
        r.standard_normal((20, 100)).astype(np.float32),
        sampling_timesteps=3)
    assert wav.shape == (30 * 256,) and np.isfinite(wav).all()


def test_bf16_step_on_the_cpu(tmp_path):
    """The bf16 forward on bf16 copies of the f32 masters: the gradients
    reach the masters, which stay f32."""
    cfg = _trainer_config(str(tmp_path), compute_dtype="bfloat16",
                          use_ema=False)
    tr = ttrainer.Trainer(cfg, logs_folder=str(tmp_path / "run"),
                          device="cpu")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    batch = tr.device_batch(next(tr.loader()))
    assert batch["c"].dtype == torch.bfloat16
    assert batch["lengths"].dtype == torch.int32 and "wav" not in batch
    m = tr.train_step(batch)
    assert torch.isfinite(m["loss"]) and m["pred"].dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in tr.model.parameters())
    moved = [k for k, v in tr.model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert len(moved) == len(before)


def test_train_cli_and_resume(tmp_path):
    from ns2vc_tpu_torch.config import save_config
    from ns2vc_tpu_torch.train import cli

    cfg = _trainer_config(str(tmp_path), train_num_steps=2,
                          save_and_sample_every=100)
    path = str(tmp_path / "config.json")
    save_config(cfg, path)
    logs = str(tmp_path / "cli_run")
    cli.main(["-c", path, "--logs_folder", logs, "-d", "cpu"])
    assert os.listdir(os.path.join(logs, "ckpt")) == ["model-2.pt"]
    save_config(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, train_num_steps=3)), path)
    cli.main(["-c", path, "--logs_folder", logs, "--resume", "-d", "cpu"])
    assert sorted(os.listdir(os.path.join(logs, "ckpt"))) == [
        "model-2.pt", "model-3.pt"]


def test_warm_start_from_a_reference_checkpoint(tmp_path, monkeypatch):
    from ns2vc_tpu_torch.utils import convert_reference

    jcfg, _ = configs(levels=(16, 24))
    cfg = _trainer_config(str(tmp_path))
    r = np.random.default_rng(7)
    jm = jdiff.NaturalSpeech2(jcfg)
    params = _filled_tree(lambda k: jm.init(k, _batch(r), k), r)
    monkeypatch.setattr(convert_reference, "natural_speech2",
                        lambda sd: jax.tree.map(np.asarray, params)["params"])
    torch.save({"step": 17, "model": {"x": torch.zeros(1)}},
               tmp_path / "model-17.pt")
    tr = ttrainer.Trainer(cfg, logs_folder=str(tmp_path / "run"),
                          device="cpu")
    tr.load_torch(str(tmp_path / "model-17.pt"))
    want = from_flax(jax.tree.map(np.asarray, params), cfg)
    assert tr.step == 17
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, want[k]), k
        assert torch.equal(tr.state.ema_params[k], want[k]), k


def test_the_default_device_refuses_without_a_card(tmp_path, monkeypatch):
    from ns2vc_tpu_torch.train import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _trainer_config(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(cfg, logs_folder=str(tmp_path / "run"))
    with pytest.raises(SystemExit) as e:
        cli.main(["--logs_folder", str(tmp_path / "cli")])
    assert e.value.code not in (0, None) and "-d cpu" in str(e.value.code)
    assert not (tmp_path / "cli").exists()


def test_f0_predictor_config_raises(tmp_path):
    """A Trainer with the F0 predictor keeps f0/uv in its batches; a
    checkpoint trained without the predictor does not load into it (the
    port's loading is strict)."""
    cfg = _trainer_config(str(tmp_path))
    plain = ttrainer.Trainer(cfg, logs_folder=str(tmp_path / "plain"),
                             device="cpu")
    path = plain.save()
    cfg = dataclasses.replace(cfg, f0_predictor=dataclasses.replace(
        cfg.f0_predictor, enabled=True, attention_layers=1))
    tr = ttrainer.Trainer(cfg, logs_folder=str(tmp_path / "run"),
                          device="cpu")
    assert {"f0", "uv"} <= set(tr.device_batch(next(tr.loader())))
    tr.close()
    with pytest.raises(RuntimeError, match="f0_predictor"):
        tr.load(path=path)
