"""The Trainer's step and eval programs on the CPU.

On a card a step program is a CUDA graph captured over static buffers; on
the CPU `Trainer._train_step_program` runs the same body eagerly over the
same buffers (the batch's fields, t and noise when given, the step count),
with the step's generator seeded at `step_seed` before it, and so does
`_eval_program` for `sample_eval` (the EMA copied into the eval model,
x_T drawn before the body). `Trainer.compiled` and `.eval_compiled`
pick the paths (`compiled_paths`: on a card, the step without a group or
under NCCL, the eval at a model axis of one); set here on the CPU.

- Against JAX: the setup of test_torch_train's `step_pair` (accumulation
  2, EMA every 2 steps, p_dropout 0, three steps with JAX's draws given as
  t and noise) through the program body, at that file's tolerances: loss
  1e-5 and grad norm 1e-4 relative, parameters and EMA within 1e-3 of lr
  per step.
- Against the eager step (`_train_step_eager`), with and without the F0
  predictor, dropout 0.2 (masks and the F0 scale drawn from the step's
  generator inside the body): metrics, parameters, both AdamW moments, the
  step counts and the EMA, bit for bit, over three steps; the eval sample's
  mel and waveform too.
- The EMA's decay on the device: on a step without an update no bit of
  the EMA moves.
- The key: one program per geometry, reused on repeats; it splits on every
  field. An optimizer's state loaded, or new EMA tensors, drop the
  programs.
- A checkpoint of a capturable AdamW resumes in an eager Trainer and the
  other way round: the live optimizer keeps its kind; step, moments and
  EMA come back equal.

Tiny widths (one encoder layer, UNet (16, 24), B = 2-4, T <= 40).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu.models import diffusion as jdiff
from ns2vc_tpu.train import trainer as jtrainer
from ns2vc_tpu_torch.convert import from_flax, init_vocos_params
from ns2vc_tpu_torch.train import trainer as ttrainer
from test_torch_data import write_features
from test_torch_slice import _filled_tree
from test_torch_train import (
    GRAD_RTOL, LEVELS, LOSS_RTOL, _batch, _close, _draws, _torch, configs,
)

VOCOS_KW = dict(dim=32, intermediate_dim=48, num_layers=1, hop_length=256)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models: one intra-op thread runs them fastest, and several
    test workers share the host."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _config(root, f0=False, p_dropout=0.2, **train):
    feats = os.path.join(root, "feats")
    if not os.path.exists(feats):
        write_features(feats, [40, 56, 64, 48, 36, 60, 44, 52], hop=256,
                       audio_rates=(24000,))
    kw = dict(train_batch_size=2, max_content_frames=40,
              max_refer_frames=32, num_workers=0, remat=True,
              remat_policy="dots", use_ema=True, ema_update_every=2,
              ema_decay=0.9, compute_dtype="float32", train_lr=1e-3,
              logs_folder=os.path.join(root, "logs"))
    kw.update(train)
    _, cfg = configs(levels=LEVELS, p_dropout=p_dropout,
                     data={"training_files": feats, "val_files": feats},
                     **kw)
    if f0:
        cfg = dataclasses.replace(cfg, f0_predictor=dataclasses.replace(
            cfg.f0_predictor, enabled=True, attention_layers=1))
    return cfg


def _trainer(cfg, root, name, compiled, vocos=None):
    tr = ttrainer.Trainer(cfg, logs_folder=os.path.join(root, name),
                          vocos_params=vocos, device="cpu")
    tr.compiled = tr.eval_compiled = compiled
    return tr


def _state(tr) -> dict:
    """What a step changes, as copies."""
    opt = tr.state.optimizer.state_dict()["state"]
    return {"params": {k: v.clone() for k, v in
                       tr.model.state_dict().items()},
            "moments": {(i, k): v.clone() for i, st in opt.items()
                        for k, v in st.items()},
            "ema": {k: v.clone() for k, v in tr.state.ema_params.items()},
            "step": tr.step}


def _assert_same(a: dict, b: dict):
    assert a["step"] == b["step"]
    for part in ("params", "moments", "ema"):
        assert a[part].keys() == b[part].keys(), part
        bad = [k for k in a[part] if not torch.equal(a[part][k],
                                                     b[part][k])]
        assert not bad, (part, bad[:5])


# -- against JAX ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """test_torch_train's `step_pair` (jit once) against the same three
    steps through the step program's body."""
    root = str(tmp_path_factory.mktemp("jax"))
    jcfg, _ = configs(p_dropout=0.0, train_lr=1e-3, eps=1e-3,
                      gradient_accumulate_every=2, use_ema=True,
                      ema_decay=0.9, ema_update_every=2)
    cfg = _config(root, p_dropout=0.0, eps=1e-3, gradient_accumulate_every=2,
                  train_batch_size=4)
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
    tr = _trainer(cfg, root, "run", compiled=True)
    tr.model.load_state_dict(from_flax(jax.tree.map(np.asarray, params),
                                       cfg))
    for k, v in tr.model.state_dict().items():
        tr.state.ema_params[k].copy_(v)
    rng = jax.random.PRNGKey(5)
    steps = []
    for s in range(3):
        jstate, jm_ = jstep(jstate, batch, rng)
        draws = [_draws(jax.random.fold_in(jax.random.fold_in(rng, s), i),
                        2, 16) for i in range(2)]
        tm = tr.train_step(
            _torch(batch),
            t=torch.from_numpy(np.concatenate([d[0] for d in draws])),
            noise=torch.from_numpy(np.concatenate([d[1] for d in draws])))
        steps.append({
            "jax": (float(jm_["loss"]), float(jm_["grad_norm"]),
                    from_flax(jax.tree.map(np.asarray, jstate.params), cfg),
                    from_flax(jax.tree.map(np.asarray, jstate.ema_params),
                              cfg)),
            "port": (tm["loss"].item(), tm["grad_norm"].item(),
                     {k: v.detach().clone()
                      for k, v in tr.model.state_dict().items()},
                     {k: v.clone() for k, v in tr.state.ema_params.items()})})
    return cfg, tr, steps


def test_step_program_matches_jax(jax_steps):
    cfg, tr, steps = jax_steps
    assert tr.step == 3 and len(tr._step_programs) == 1
    (key,) = tr._step_programs
    assert (key.batch, key.accum, key.given_t, key.given_noise) == (
        4, 2, True, True)
    lr = cfg.train.train_lr
    for i, s in enumerate(steps):
        (jl, jn, jp, je), (tl, tn, tp, te) = s["jax"], s["port"]
        assert tl == pytest.approx(jl, rel=LOSS_RTOL)
        assert tn == pytest.approx(jn, rel=GRAD_RTOL)
        _close(tp, jp, 1e-3 * lr * (i + 1))
        _close(te, je, 1e-3 * lr * (i + 1))
    assert steps[0]["jax"][1] > cfg.train.grad_clip_norm   # clipped


# -- against the eager step --------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["f0_off", "f0_on"])
def pair(request, tmp_path_factory):
    """An eager and a program Trainer from the same seed, three steps each
    on the same loader batches, their metrics and states after each step,
    and one eval sample each."""
    root = str(tmp_path_factory.mktemp("pair"))
    cfg = _config(root, f0=request.param)
    vsd = init_vocos_params(torch.Generator().manual_seed(3), **VOCOS_KW)
    eager = _trainer(cfg, root, "eager", compiled=False, vocos=vsd)
    prog = _trainer(cfg, root, "prog", compiled=True, vocos=vsd)
    loader = eager.loader()
    batches = [eager.device_batch(next(loader)) for _ in range(3)]
    eager.close()
    out = {"eager": [], "prog": [], "ema0": _state(prog)["ema"]}
    for name, tr in (("eager", eager), ("prog", prog)):
        for b in batches:
            m = tr.train_step(b)
            out[name].append((m, _state(tr)))
    samples = {name: tr.sample_eval(torch.Generator().manual_seed(11))
               for name, tr in (("eager", eager), ("prog", prog))}
    return cfg, eager, prog, batches, out, samples


def test_step_program_equals_the_eager_step(pair):
    cfg, eager, prog, _, out, _ = pair
    assert len(prog._step_programs) == 1 and not eager._step_programs
    for (me, se), (mp, sp) in zip(out["eager"], out["prog"]):
        assert me.keys() == mp.keys() and {"pred", "target"} <= set(me)
        for k in me:
            assert torch.equal(me[k], mp[k]), k
        _assert_same(se, sp)
    assert out["prog"][-1][1]["step"] == 3
    if cfg.f0_predictor.enabled:
        assert out["prog"][0][0]["loss_f0"] > 0


def test_eval_program_equals_the_eager_eval(pair):
    _, eager, prog, _, _, samples = pair
    a, b = samples["eager"], samples["prog"]
    assert np.array_equal(a[0], b[0]) and np.isfinite(a[0]).all()
    assert a[1] is not None and np.array_equal(a[1], b[1])
    assert len(prog._eval_programs) == 1 and not eager._eval_programs
    (key,) = prog._eval_programs
    assert key.t_pad % 64 == 0 and key.tr_pad % 64 == 0
    assert key.f0 == prog.cfg.f0_predictor.enabled


def test_ema_bits_stay_on_a_step_without_an_update(pair):
    """EMA every 2 steps: none after the first step ((0 + 1) % 2 != 0) and
    the third, one after the second."""
    out = pair[4]
    ema = [out["ema0"]] + [st["ema"] for _, st in out["prog"]]
    name = "diff_model.unet.conv_in.weight"
    bits = [e[name].view(torch.int32) for e in ema]
    assert torch.equal(bits[0], bits[1]) and not torch.equal(bits[1],
                                                            bits[2])
    assert torch.equal(bits[2], bits[3])
    for k in ema[0]:
        assert torch.equal(ema[0][k].view(torch.int32),
                           ema[1][k].view(torch.int32)), k
        assert torch.equal(ema[2][k].view(torch.int32),
                           ema[3][k].view(torch.int32)), k


# -- the key ---------------------------------------------------------------------------

def _cut(batch, t=None, tp=None, b=None):
    out = {}
    for k, v in batch.items():
        if b is not None:
            v = v[:b]
        if k in ("c", "spec", "f0", "uv") and t is not None:
            v = v[:, :t]
        if k == "refer" and tp is not None:
            v = v[:, :tp]
        out[k] = v.clone()
    return out


def test_step_key_reuses_a_geometry_and_splits_on_every_field(tmp_path):
    cfg = _config(str(tmp_path), train_batch_size=2)
    tr = _trainer(cfg, str(tmp_path), "run", compiled=True)
    batch = tr.device_batch(next(tr.loader()))
    tr.close()
    other = _cut(batch, t=24)
    for b in (batch, other, batch, other):   # two geometries, in turns
        tr.train_step(b)
    assert len(tr._step_programs) == 2
    base = tr._step_key(batch, None, None)
    unet = tr.model.diff_model.unet
    t, noise = torch.zeros(2, dtype=torch.long), batch["spec"].clone()
    new = {"batch": tr._step_key(_cut(batch, b=1), None, None),
           "t": tr._step_key(other, None, None),
           "tp": tr._step_key(_cut(batch, tp=16), None, None),
           "given_t": tr._step_key(batch, t, None),
           "given_noise": tr._step_key(batch, None, noise)}
    for field, attr, value in (("accum", "accum", 2),
                               ("dtype", "compute_dtype", torch.bfloat16)):
        saved = getattr(tr, attr)
        setattr(tr, attr, value)
        new[field] = tr._step_key(batch, None, None)
        setattr(tr, attr, saved)
    for field, attr, value in (("remat", "remat", False),
                               ("remat_policy", "remat_policy", "all")):
        saved = getattr(unet, attr)
        setattr(unet, attr, value)
        new[field] = tr._step_key(batch, None, None)
        setattr(unet, attr, saved)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for field, (mm, dnn) in (("tf32_matmul", (not saved[0], saved[1])),
                                 ("tf32_cudnn", (saved[0], not saved[1]))):
            torch.backends.cuda.matmul.allow_tf32 = mm
            torch.backends.cudnn.allow_tf32 = dnn
            new[field] = tr._step_key(batch, None, None)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    f0_cfg = _config(str(tmp_path), f0=True, train_batch_size=2)
    f0_tr = _trainer(f0_cfg, str(tmp_path), "f0", compiled=True)
    new["f0"] = f0_tr._step_key(batch, None, None)
    for field, key in new.items():
        assert [f for f in key._fields if getattr(key, f) != getattr(
            base, f)] == [field], (field, key, base)
    assert set(new) == set(base._fields)


def test_a_new_optimizer_state_or_ema_drops_the_programs(tmp_path):
    cfg = _config(str(tmp_path))
    tr = _trainer(cfg, str(tmp_path), "run", compiled=True)
    batch = tr.device_batch(next(tr.loader()))
    tr.close()
    tr.train_step(batch)
    tr.sample_eval(torch.Generator().manual_seed(0))
    assert tr._step_programs and tr._eval_programs
    tr.state.optimizer.load_state_dict(tr.state.optimizer.state_dict())
    assert not tr._step_programs and not tr._eval_programs
    tr.train_step(batch)
    assert len(tr._step_programs) == 1
    path = tr.save()
    tr.load(path=path)
    assert not tr._step_programs
    tr.train_step(batch)
    tr.state.ema_params = ttrainer.init_ema(tr.model)
    tr.train_step(batch)
    assert len(tr._step_programs) == 1
    (prog,) = tr._step_programs.values()
    assert prog.static["step"].item() == tr.step - 1


# -- which path runs ---------------------------------------------------------------

@pytest.mark.parametrize("device,backends,model_size,step,eval_", [
    ("cuda", set(), 1, True, True),              # one process
    ("cuda", {"nccl"}, 1, True, True),
    ("cuda", {"nccl"}, 2, True, False),          # the split eval: eager
    ("cuda", {"gloo"}, 1, False, True),          # gloo: host copies
    ("cuda", {"gloo"}, 2, False, False),
    ("cuda", {"nccl", "gloo"}, 1, False, True),  # a gloo group among them
    ("cpu", set(), 1, False, False),
    ("cpu", {"gloo"}, 1, False, False),
    ("cpu", {"gloo"}, 2, False, False),
])
def test_compile_rule(device, backends, model_size, step, eval_):
    """The step is a program on a card without a group or where every
    group is NCCL; the eval on a card at a model axis of one under any
    backend; nothing on the CPU."""
    assert ttrainer.compiled_paths(device, backends, model_size) == (
        step, eval_)


def test_a_cpu_trainer_compiles_nothing(tmp_path):
    tr = ttrainer.Trainer(_config(str(tmp_path)),
                          logs_folder=str(tmp_path / "run"), device="cpu")
    assert (tr.compiled, tr.eval_compiled) == (False, False)
    assert not any(g["capturable"] for g in tr.state.optimizer.param_groups)


# -- checkpoints between the two optimizers -----------------------------------------

def test_checkpoints_cross_between_capturable_and_eager_adamw(tmp_path):
    """A capturable AdamW's checkpoint (its groups say capturable, its step
    counts are f32 tensors, on the CPU once read) resumes in an eager
    Trainer, which stays eager and steps on; an eager one's loads into a
    capturable AdamW, which stays capturable and takes the step counts to
    its parameters' device."""
    cfg = _config(str(tmp_path))
    tr = _trainer(cfg, str(tmp_path), "run", compiled=False)
    batch = tr.device_batch(next(tr.loader()))
    tr.close()
    for _ in range(2):
        tr.train_step(batch)
    path = tr.save()
    data = torch.load(path, map_location="cpu")
    for g in data["opt_state"]["param_groups"]:
        g["capturable"] = True
    as_capturable = str(tmp_path / "capturable.pt")
    torch.save(data, as_capturable)

    want = _state(tr)
    eager = _trainer(cfg, str(tmp_path), "eager", compiled=False)
    eager.load(path=as_capturable)
    assert not any(g["capturable"]
                   for g in eager.state.optimizer.param_groups)
    _assert_same(_state(eager), want)
    a, b = tr.train_step(batch), eager.train_step(batch)
    assert torch.equal(a["loss"], b["loss"])
    _assert_same(_state(eager), _state(tr))

    cap = _trainer(cfg, str(tmp_path), "cap", compiled=False)
    cap.state.optimizer = ttrainer.make_optimizer(
        cfg, cap.model.parameters(), capturable=True)
    cap.load(path=path)
    assert all(g["capturable"] for g in cap.state.optimizer.param_groups)
    got = _state(cap)
    _assert_same(got, want)
    steps = [st["step"] for st in
             cap.state.optimizer.state_dict()["state"].values()]
    assert all(s.dtype == torch.float32 and s.item() == 2 for s in steps)
