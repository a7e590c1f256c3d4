"""The port's 'model' mesh axis (`parallel/mesh.py` groups and placements,
`parallel/tensor.py` column-parallel layers, the Trainer at
model_parallel_size 2, the split `generate_mel`) against the JAX package's
single-device programs and the port's one-process step, on the CPU.

One module fixture runs 4 gloo processes laid out (data 2 x model 2) on a
narrow configuration that still splits: encoders of 1 layer at hidden 256,
UNet levels (32, 256) with 1 resnet per block (the mid transformer, the
256-wide resnets and the prompt pool are split), T = 16, global batch 4.
Tolerances are JAX's own for a mesh against one device
(tests/test_parallel.py): loss rtol 2e-5, grad norm rtol 2e-4, every
gradient rtol 1e-3 / atol 1e-7, `generate_mel` atol 2e-5 / rtol 1e-5.

- (a) the split step (dropout 0) against JAX's one-device step on the same
  weights (built per rank with `convert.from_flax_sharded`) and the same
  draws of t and noise, and against the port's one-process step;
- (b) the gathered parameters and EMA after one AdamW step (Adam eps 1e-3,
  as tests/test_torch_train.py) within 1e-3 of lr of one process's, and
  the replicas' bits equal;
- (c) with dropout 0.2 and the F0 predictor on, the members of a model
  group read the same rows and draw the same masks; the data groups read
  different rows and draw different masks; with dropout 0 the F0 step
  matches one process;
- (d) the grad norm counts each split block once: the norm of the ranks'
  local gradients alone misses the one-process norm by far more than the
  tolerance, the step's norm matches it;
- (e) `generate_mel` (DDIM, 3 steps) split over data and model against
  JAX's one-device `generate_mel`, whole batch and per-data-group rows;
- (f) a checkpoint of a one-process run resumes at mp=2 (each rank's
  gathered state bitwise the file's), and the mp=2 run's checkpoint
  resumes in one process: the next step of each agrees; the eval sample
  (UniPC, 30 steps) of the ranks of data index 0 against one process's
  within the samplers' 1e-4;
- (g) `gather_parameters` after `shard_parameters` is the identity, and
  the blocks each rank keeps are the values JAX's `param_shardings` gives
  each device of a (1, 2) mesh (fused to_qkv and the GEGLU proj among
  them);
- (h) the split step through the group's step program (`compiled` set by
  hand: on the CPU its body runs eagerly over the static buffers, the
  work a card captures under NCCL) is the eager split step bit for bit
  (metrics, parameters, gradients, AdamW moments, EMA) with the same
  collectives' calls and bytes; a CPU Trainer in the gloo group compiles
  neither path.

Single-process cases: the f/g Functions' backward over two simulated ranks
(threads exchanging tensors in place of the collectives) against the
whole layer, and the reordering of a fused (blocks = 3) output.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from ns2vc_tpu import config as jconfig
from ns2vc_tpu.models import diffusion as jdiff
from ns2vc_tpu.parallel import mesh as jmesh
from ns2vc_tpu.train import trainer as jtrainer
from ns2vc_tpu_torch import config as tconfig
from ns2vc_tpu_torch.convert import from_flax, init_module_
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
from ns2vc_tpu_torch.parallel import mesh as tmesh
from ns2vc_tpu_torch.parallel import tensor as ttensor
from ns2vc_tpu_torch.train import trainer as ttrainer
from test_torch_data import write_features
from test_torch_slice import _filled_tree
from test_torch_train import _draws


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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, NORM_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 2e-4, 1e-3, 1e-7
MEL_ATOL, MEL_RTOL = 2e-5, 1e-5
B, T, TP = 4, 16, 12           # the global batch
LR = 1e-3
LENGTHS = [40, 56, 64, 48, 36, 60, 44, 52, 40, 64, 56, 34]
WORKER_TIMEOUT = 240


def configs(p_dropout=0.0, f0=False, mp=1, data=None, **train):
    """The narrow configuration in the JAX package's classes and the
    port's: everything 256 wide splits at mp=2."""
    train = {"train_batch_size": B // 2, "train_lr": LR,
             "compute_dtype": "float32", "num_workers": 0,
             "remat": True, "remat_policy": "dots", **train}

    def make(m):
        return m.Config(
            train=m.TrainConfig(**train),
            data=m.DataConfig(**(data or {})),
            parallel=m.ParallelConfig(model_parallel_size=mp),
            phoneme_encoder=m.EncoderConfig(n_layers=1, p_dropout=p_dropout),
            prompt_encoder=m.EncoderConfig(in_channels=100, n_layers=1,
                                           p_dropout=p_dropout),
            diffusion_encoder=m.DiffusionEncoderConfig(
                block_out_channels=(32, 256), layers_per_block=1),
            f0_predictor=m.F0PredictorConfig(enabled=f0, attention_layers=1,
                                             p_dropout=p_dropout))
    return make(jconfig), make(tconfig)


def _batch(r, f0=False):
    batch = {"c": r.standard_normal((B, T, 256)),
             "refer": r.standard_normal((B, TP, 100)),
             "spec": r.standard_normal((B, T, 100))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    batch["lengths"] = np.array([16, 11, 9, 16], np.int32)
    batch["refer_lengths"] = np.array([12, 7, 12, 5], np.int32)
    if f0:
        f = (120.0 + 150.0 * r.random((B, T))).astype(np.float32)
        f[:, 3:6] = 0.0
        batch.update(f0=f, uv=(f > 0).astype(np.float32))
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# -- the 4-process cluster ------------------------------------------------------

_WORKER = textwrap.dedent('''
    import hashlib, json, os
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from ns2vc_tpu_torch.config import load_config
    from ns2vc_tpu_torch.convert import from_flax_sharded, init_module_
    from ns2vc_tpu_torch.models import encoders
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2, generate_mel
    from ns2vc_tpu_torch.parallel import mesh
    from ns2vc_tpu_torch.train import trainer as ttrainer
    from ns2vc_tpu_torch.train.trainer import Trainer

    assert mesh.maybe_initialize_distributed("cpu")
    rank, n = mesh.world()
    out = os.environ["T_OUT"]
    res = {"rank": rank}

    def save(name, obj):
        torch.save(obj, os.path.join(out, f"{name}_rank{rank}.pt"))

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().numpy().tobytes())
        return h.hexdigest()

    def trainer(name):
        cfg = load_config(os.path.join(out, f"{name}_config.json"))
        return Trainer(cfg, logs_folder=os.path.join(out, f"{name}_run"),
                       device="cpu")

    def gathered(tr, tensors):
        return mesh.gather_state(tensors, tr.placements, tr.mesh)

    # (g) shard then gather is the identity, with the 2 x 2 groups
    case = torch.load(os.path.join(out, "step_case.pt"), weights_only=False)
    tr = trainer("step")
    assert tr.mesh.shape == {"data": 2, "model": 2}
    res["index"] = [tr.data_index, tr.mesh.index("model")]
    full = NaturalSpeech2(tr.cfg)
    init_module_(full, torch.Generator().manual_seed(5))
    want = {k: v.clone() for k, v in full.state_dict().items()}
    mesh.shard_parameters(full, tr.placements, tr.mesh)
    back = mesh.gather_parameters(full, tr.placements, tr.mesh)
    res["identity"] = all(torch.equal(back[k], v) for k, v in want.items())
    res["split_shapes"] = {k: list(p.shape) for k, p in
                           full.named_parameters()}

    # (a), (b), (d): one step of JAX's weights on this rank's rows
    tr.model.load_state_dict(from_flax_sharded(case["tree"], tr.cfg,
                                               tr.mesh))
    tr.state.ema_params = ttrainer.init_ema(tr.model)
    mesh.reset_counters()
    local = mesh.shard_batch(case["batch"], tr.mesh)
    m = tr.train_step(tr.device_batch(local), t=case["t"],
                      noise=case["noise"])
    res["counters"] = mesh.counters()
    names = [k for k, _ in tr.model.named_parameters()]
    grads = {k: p.grad for k, p in tr.model.named_parameters()}
    res["local_only_norm"] = ttrainer.global_norm(list(grads.values())).item()
    split = [g for k, g in grads.items() if tr.placements[k].axis]
    repl = [g for k, g in grads.items() if not tr.placements[k].axis]
    res["norm_clipped"] = ttrainer.global_norm(repl, split,
                                               tr.model_group).item()
    res["loss"], res["grad_norm"] = m["loss"].item(), m["grad_norm"].item()
    full_grads = gathered(tr, grads)
    params = gathered(tr, {k: p.detach() for k, p in
                           tr.model.named_parameters()})
    ema = gathered(tr, tr.state.ema_params)
    res["replicated_digest"] = digest(p for k, p in tr.model.named_parameters()
                                      if not tr.placements[k].axis)
    res["local_digest"] = digest(tr.model.parameters())
    res["split_numel"] = sum(p.numel() for k, p in
                             tr.model.named_parameters()
                             if tr.placements[k].axis)
    res["numel"] = sum(p.numel() for p in tr.model.parameters())
    if rank == 0:
        save("step", {"grads": full_grads, "params": params, "ema": ema})
    res["compiled"] = [tr.compiled, tr.eval_compiled]

    # (h) the same split step through the step program's body (compiled
    # set by hand: on the CPU it runs eagerly over the static buffers)
    prog = Trainer(tr.cfg, logs_folder=os.path.join(out, "prog_run"),
                   device="cpu")
    prog.compiled = True
    prog.model.load_state_dict(from_flax_sharded(case["tree"], prog.cfg,
                                                 prog.mesh))
    prog.state.ema_params = ttrainer.init_ema(prog.model)
    mesh.reset_counters()
    mp_ = prog.train_step(prog.device_batch(local), t=case["t"],
                          noise=case["noise"])
    res["program_counters"] = mesh.counters()
    res["programs"] = len(prog._step_programs)
    def moments(t):
        return [v for st in t.state.optimizer.state_dict()["state"].values()
                for v in st.values()]
    res["program_differs"] = [k for k in m if not torch.equal(m[k], mp_[k])]
    for part, a, b in (
            ("param", dict(tr.model.named_parameters()),
             dict(prog.model.named_parameters())),
            ("grad", grads, {k: p.grad for k, p in
                             prog.model.named_parameters()}),
            ("ema", tr.state.ema_params, prog.state.ema_params),
            ("moment", dict(enumerate(moments(tr))),
             dict(enumerate(moments(prog))))):
        res["program_differs"] += [f"{part} {k}" for k in a
                                   if not torch.equal(a[k], b[k])]
    prog.close()
    tr.close()

    # (c) F0 predictor on, dropout 0: t, noise and the F0 scale drawn by the
    # ranks, against one process
    f0 = torch.load(os.path.join(out, "f0_case.pt"), weights_only=False)
    tr = trainer("f0")
    tr.model.load_state_dict(mesh.shard_state(f0["params"], tr.placements,
                                              tr.mesh))
    m = tr.train_step(tr.device_batch(mesh.shard_batch(f0["batch"],
                                                       tr.mesh)))
    res["f0"] = {"loss": m["loss"].item(), "loss_f0": m["loss_f0"].item(),
                 "grad_norm": m["grad_norm"].item()}
    g = gathered(tr, {k: p.grad for k, p in tr.model.named_parameters()})
    if rank == 0:
        save("f0", g)
    tr.close()

    # (c) dropout 0.2: the rows read and the masks drawn
    masks = []
    forward = encoders.Dropout.forward
    def recorded(self, x, generator=None):
        y = forward(self, x, generator)
        if self.training and self.p > 0:
            masks.append(digest([(y == 0) & (x != 0)]))
        return y
    encoders.Dropout.forward = recorded
    tr = trainer("masks")
    batch = tr.device_batch(next(tr.loader()))
    res["rows_digest"] = digest([batch["c"], batch["spec"]])
    m = tr.train_step(batch)
    encoders.Dropout.forward = forward
    res["masks"] = masks
    res["masks_loss"] = m["loss"].item()
    res["masks_replicated_digest"] = digest(
        p for k, p in tr.model.named_parameters()
        if not tr.placements[k].axis)
    # the trainer's own loop: logs, an eval sample and checkpoints
    tr.train(num_steps=3)
    res["loop_step"] = tr.step
    tr.close()

    # (e) generate_mel over the 2 x 2 mesh
    gen = torch.load(os.path.join(out, "gen_case.pt"), weights_only=False)
    cfg = load_config(os.path.join(out, "step_config.json"))
    model = NaturalSpeech2(cfg).eval()
    placements = mesh.param_shardings(model, tr.mesh)
    mesh.shard_parameters(model, placements, tr.mesh)
    model.load_state_dict(from_flax_sharded(case["tree"], cfg, tr.mesh))
    args = [gen[k] for k in ("c", "refer", "lengths", "refer_lengths")]
    mel = generate_mel(model, *args, x_T=gen["x_T"], method="ddim", steps=3,
                       mesh=tr.mesh)
    rows = generate_mel(model, *args, x_T=gen["x_T"], method="ddim", steps=3,
                        mesh=tr.mesh, gather=False)
    save("gen", {"mel": mel, "rows": rows})

    # (f) a one-process checkpoint resumed at mp=2, a step, a save
    ck = torch.load(os.path.join(out, "ckpt_case.pt"), weights_only=False)
    tr = trainer("ckpt")
    tr.load(path=ck["path"])
    file = torch.load(ck["path"], weights_only=False)
    params, opt, ema = tr._full_state()
    same = all(torch.equal(params[k], v) for k, v in file["params"].items())
    same &= all(torch.equal(ema[k], v) for k, v in
                file["ema_params"].items())
    same &= all(torch.equal(opt["state"][i][k], v)
                for i, st in file["opt_state"]["state"].items()
                for k, v in st.items())
    res["resumed_equal"] = same
    res["resumed_step"] = tr.step
    # eval sampling: the ranks of data index 0 sample, rank 0 returns it
    sample = tr.sample_eval(torch.Generator().manual_seed(3))
    res["eval_returned"] = sample is not None
    if rank == 0:
        save("eval", sample[0])
    local = tr.device_batch(mesh.shard_batch(ck["batch"], tr.mesh))
    tr.train_step(local, t=ck["t"], noise=ck["noise"])
    res["saved"] = tr.save()
    tr.train_step(local, t=ck["t"], noise=ck["noise"])
    params = gathered(tr, {k: p.detach() for k, p in
                           tr.model.named_parameters()})
    if rank == 0:
        save("ckpt", params)
    tr.close()

    with open(os.path.join(out, f"result_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    print("WORKER-OK", flush=True)
''')


def _step_case(out, feature_dir):
    """JAX's one-device step (loss, grad norm, gradients) on the global
    batch, the draws of t and noise it made, and its weights."""
    jcfg, cfg = configs(mp=2, eps=1e-3, use_ema=True, ema_decay=0.5,
                        ema_update_every=1,
                        data={"training_files": feature_dir})
    r = np.random.default_rng(21)
    batch = _batch(r)
    jm = jdiff.NaturalSpeech2(jcfg)
    params = _filled_tree(lambda k: jm.init(k, batch, k), r)
    jopt = jtrainer.make_optimizer(jcfg)
    jstep = jtrainer.make_train_step(jm, jopt)
    rng = jax.random.PRNGKey(5)

    def step_and_grads(state, b, rng):
        new, metrics = jstep(state, b, rng)
        key = jax.random.fold_in(rng, state.step)
        grads = jax.grad(lambda p: jm.apply(
            p, b, key, deterministic=False,
            rngs={"dropout": jax.random.fold_in(key, 1)})[0])(state.params)
        return new, metrics, grads

    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=jopt.init(params))
    _, metrics, grads = jax.jit(step_and_grads)(state, batch, rng)
    gn = float(metrics["grad_norm"])
    scale = min(1.0, cfg.train.grad_clip_norm / gn)
    t, noise = _draws(jax.random.fold_in(rng, 0), B, T)
    tree = jax.tree.map(np.asarray, params)
    case = {"tree": tree, "batch": _torch(batch),
            "t": torch.from_numpy(np.array(t)),
            "noise": torch.from_numpy(np.array(noise))}
    torch.save(case, os.path.join(out, "step_case.pt"))
    tconfig.save_config(cfg, os.path.join(out, "step_config.json"))
    want = {"loss": float(metrics["loss"]), "grad_norm": gn,
            "grads": {k: v * scale for k, v in from_flax(
                jax.tree.map(np.asarray, grads), cfg).items()}}

    # JAX's generate_mel on one device, and its initial noise
    gen_rng = jax.random.PRNGKey(7)
    mel = jax.jit(lambda p, c, rf, n, rn, k: jdiff.generate_mel(
        jm, p, c, rf, n, rn, k, method="ddim", steps=3))(
        params, batch["c"], batch["refer"], batch["lengths"],
        batch["refer_lengths"], gen_rng)
    x_T = np.array(jax.random.normal(jax.random.split(gen_rng)[0],
                                     (B, T, 100), jnp.float32))
    torch.save({**{k: case["batch"][k] for k in
                   ("c", "refer", "lengths", "refer_lengths")},
                "x_T": torch.from_numpy(x_T)},
               os.path.join(out, "gen_case.pt"))
    return cfg, case, want, np.asarray(mel)


def _f0_cases(out, feature_dir, eval_dir):
    """The F0-predictor step case (dropout 0) and the masks case (dropout
    0.2, the loader over the features, then the trainer's loop: a log line
    per step, an eval sample and a checkpoint every 2 steps)."""
    _, cfg = configs(f0=True, mp=2, use_ema=False)
    r = np.random.default_rng(22)
    model = NaturalSpeech2(cfg)
    init_module_(model, torch.Generator().manual_seed(3))
    case = {"params": model.state_dict(), "batch": _torch(_batch(r, True))}
    torch.save(case, os.path.join(out, "f0_case.pt"))
    tconfig.save_config(cfg, os.path.join(out, "f0_config.json"))
    _, masks = configs(p_dropout=0.2, f0=True, mp=2, use_ema=False,
                       max_content_frames=64, max_refer_frames=48,
                       log_every=1, save_and_sample_every=2, keep_ckpts=5,
                       data={"training_files": feature_dir,
                             "val_files": eval_dir})
    tconfig.save_config(masks, os.path.join(out, "masks_config.json"))
    return cfg, case


def _ckpt_case(out, feature_dir, evals):
    """A one-process Trainer's checkpoint after one step (moments and EMA
    not trivial), and the batch and draws the resumed runs step on."""
    _, cfg1 = configs(use_ema=True, ema_decay=0.5, ema_update_every=1,
                      eps=1e-3, seed=4,
                      data={"training_files": feature_dir,
                            "val_files": evals})
    r = np.random.default_rng(23)
    batch = _torch(_batch(r))
    t = torch.from_numpy(r.integers(0, 1000, B))
    noise = torch.from_numpy(r.standard_normal((B, T, 100)).astype(
        np.float32))
    tr = ttrainer.Trainer(cfg1, logs_folder=os.path.join(out, "one_run"),
                          device="cpu")
    tr.train_step(tr.device_batch(batch), t=t, noise=noise)
    path = tr.save()
    tr.close()
    tconfig.save_config(dataclasses.replace(
        cfg1, parallel=tconfig.ParallelConfig(model_parallel_size=2)),
        os.path.join(out, "ckpt_config.json"))
    case = {"path": path, "batch": batch, "t": t, "noise": noise}
    torch.save(case, os.path.join(out, "ckpt_case.pt"))
    return cfg1, case


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    feature_dir = write_features(str(out / "feats"), LENGTHS)
    cfg, case, want, jmel = _step_case(str(out), feature_dir)
    eval_dir = write_features(str(out / "eval"), [40, 56],
                              audio_rates=(24000,))
    f0_cfg, f0_case = _f0_cases(str(out), feature_dir, eval_dir)
    ck_cfg, ck_case = _ckpt_case(str(out), feature_dir, eval_dir)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "NS2VC_COORDINATOR": f"localhost:{port}",
           "NS2VC_NUM_PROCESSES": "4", "T_OUT": str(out),
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("NS2VC_DISTRIBUTED", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER],
        env={**env, "NS2VC_PROCESS_ID": str(i)}, cwd=str(out),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(4)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-4000:]
        assert "WORKER-OK" in text, text[-4000:]
    res = []
    for i in range(4):
        with open(out / f"result_rank{i}.json") as f:
            res.append(json.load(f))
    load = lambda name, r=0: torch.load(out / f"{name}_rank{r}.pt",  # noqa
                                        weights_only=False)
    return {"res": res, "cfg": cfg, "case": case, "want": want,
            "jmel": jmel, "f0_cfg": f0_cfg, "f0_case": f0_case,
            "ck_cfg": ck_cfg, "ck_case": ck_case, "step": load("step"),
            "eval": load("eval"),
            "f0": load("f0"), "ckpt": load("ckpt"),
            "gen": [load("gen", r) for r in range(4)], "dir": out}


def _one_process(cfg, params, batch, t=None, noise=None, tmp=None):
    """The port's one-process step (mp=1) on the whole batch."""
    cfg = dataclasses.replace(cfg, parallel=tconfig.ParallelConfig())
    tr = ttrainer.Trainer(cfg, logs_folder=str(tmp), device="cpu")
    tr.model.load_state_dict(params)
    if tr.state.ema_params is not None:
        tr.state.ema_params = ttrainer.init_ema(tr.model)
    m = tr.train_step(tr.device_batch(batch), t=t, noise=noise)
    return tr, m


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(g),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_mesh_groups_and_indices(cluster):
    res = cluster["res"]
    assert [r["index"] for r in res] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    # each rank holds only its blocks: a quarter of the model is split
    for r in res:
        assert 0.25 * r["numel"] < r["split_numel"] < r["numel"]


def test_split_step_matches_jax_and_one_process(cluster, tmp_path):
    """(a) loss, grad norm and every gathered gradient against JAX's
    one-device step and the port's one-process step."""
    res, want = cluster["res"], cluster["want"]
    for r in res:
        assert r["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)
        assert r["grad_norm"] == pytest.approx(want["grad_norm"],
                                               rel=NORM_RTOL)
    got = {k: v.numpy() for k, v in cluster["step"]["grads"].items()}
    _assert_grads(got, want["grads"])
    case = cluster["case"]
    tr, m = _one_process(cluster["cfg"], from_flax(case["tree"],
                                                   cluster["cfg"]),
                         case["batch"], case["t"], case["noise"], tmp_path)
    assert res[0]["loss"] == pytest.approx(m["loss"].item(), rel=LOSS_RTOL)
    assert res[0]["grad_norm"] == pytest.approx(m["grad_norm"].item(),
                                                rel=NORM_RTOL)
    _assert_grads(got, {k: p.grad for k, p in tr.model.named_parameters()})
    # the step's collectives: a gather per split layer call, the input
    # gradients' and the norm's all-reduces, a mean over each axis
    counters = res[0]["counters"]
    assert counters["all_gather"]["calls"] > 20
    assert counters["all_reduce_sum"]["calls"] > 20
    assert counters["all_reduce_mean"]["calls"] == 2
    assert all(r["counters"] == counters for r in res)
    tr.close()


def test_split_step_program_equals_the_eager_split_step(cluster):
    """(h) the program body's split step is the eager one's on every
    rank, its collectives counted alike."""
    for r in cluster["res"]:
        assert r["compiled"] == [False, False]
        assert r["programs"] == 1 and r["program_differs"] == [], r["rank"]
        assert r["program_counters"] == r["counters"]


def test_split_adamw_step_matches_one_process(cluster, tmp_path):
    """(b) gathered parameters and EMA after the step within 1e-3 of lr;
    the replicas' bits equal (replicated parameters over all ranks, each
    rank's blocks with the other data group's)."""
    res, case = cluster["res"], cluster["case"]
    tr, _ = _one_process(cluster["cfg"], from_flax(case["tree"],
                                                   cluster["cfg"]),
                         case["batch"], case["t"], case["noise"], tmp_path)
    for k, p in tr.model.named_parameters():
        np.testing.assert_allclose(cluster["step"]["params"][k].numpy(),
                                   p.detach().numpy(), atol=1e-3 * LR,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(cluster["step"]["ema"][k].numpy(),
                                   tr.state.ema_params[k].numpy(),
                                   atol=1e-3 * LR, rtol=0, err_msg=k)
    assert len({r["replicated_digest"] for r in res}) == 1
    assert res[0]["local_digest"] == res[2]["local_digest"]
    assert res[1]["local_digest"] == res[3]["local_digest"]
    assert res[0]["local_digest"] != res[1]["local_digest"]
    tr.close()


def test_grad_norm_counts_each_block_once(cluster):
    """(d) the norm of the local gradients alone (split blocks summed on
    one rank) is far off the one-device norm; the model group's sum of
    the blocks' squares is it."""
    res, want = cluster["res"], cluster["want"]
    clipped = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                                for g in want["grads"].values())))
    for r in res:
        assert r["norm_clipped"] == pytest.approx(clipped, rel=NORM_RTOL)
        assert abs(r["local_only_norm"] - clipped) > 100 * NORM_RTOL * clipped


def test_f0_split_step_matches_one_process(cluster, tmp_path):
    """(c) the F0 predictor split (dropout 0): the ranks' draws of t, noise
    and the F0 scale at the global batch's shape are one process's."""
    res, case = cluster["res"], cluster["f0_case"]
    tr, m = _one_process(cluster["f0_cfg"], case["params"], case["batch"],
                         tmp=tmp_path)
    assert res[0]["f0"]["loss_f0"] > 0.0
    for r in res:
        assert r["f0"] == res[0]["f0"]
    assert res[0]["f0"]["loss_f0"] == pytest.approx(m["loss_f0"].item(),
                                                    rel=LOSS_RTOL)
    assert res[0]["f0"]["loss"] == pytest.approx(m["loss"].item(),
                                                 rel=LOSS_RTOL)
    assert res[0]["f0"]["grad_norm"] == pytest.approx(
        m["grad_norm"].item(), rel=NORM_RTOL)
    _assert_grads({k: v.numpy() for k, v in cluster["f0"].items()},
                  {k: p.grad for k, p in tr.model.named_parameters()})
    tr.close()


def test_model_group_reads_one_set_of_rows_and_draws_one_mask(cluster):
    """(c) dropout 0.2: rows and masks by data index, not by rank."""
    res = cluster["res"]
    assert res[0]["masks"] and len(res[0]["masks"]) == len(res[2]["masks"])
    for a, b in ((0, 1), (2, 3)):      # the two model groups
        for key in ("rows_digest", "masks", "masks_loss",
                    "masks_replicated_digest"):
            assert res[a][key] == res[b][key], (a, b, key)
    assert res[0]["rows_digest"] != res[2]["rows_digest"]
    assert not set(res[0]["masks"]) & set(res[2]["masks"])
    assert len({r["masks_replicated_digest"] for r in res}) == 1


def test_split_generate_mel_matches_jax(cluster):
    """(e) data 2 x model 2 against JAX's one-device generate_mel."""
    jmel = cluster["jmel"]
    for r, got in enumerate(cluster["gen"]):
        np.testing.assert_allclose(got["mel"].numpy(), jmel, atol=MEL_ATOL,
                                   rtol=MEL_RTOL, err_msg=f"rank {r}")
        rows = slice(0, 2) if r < 2 else slice(2, 4)
        np.testing.assert_allclose(got["rows"].numpy(), jmel[rows],
                                   atol=MEL_ATOL, rtol=MEL_RTOL)


def test_checkpoints_move_between_mp1_and_mp2(cluster, tmp_path):
    """(f) mp=1 -> mp=2: every rank's gathered state is the file's; mp=2
    -> mp=1: one process resumes the split run's checkpoint and its next
    step agrees with the split run's."""
    res, case = cluster["res"], cluster["ck_case"]
    assert all(r["resumed_equal"] and r["resumed_step"] == 1 for r in res)
    path = res[0]["saved"]
    assert all(r["saved"] == path for r in res)
    tr = ttrainer.Trainer(cluster["ck_cfg"], logs_folder=str(tmp_path),
                          device="cpu")
    tr.load(path=path)
    assert tr.step == 2
    tr.train_step(tr.device_batch(case["batch"]), t=case["t"],
                  noise=case["noise"])
    for k, p in tr.model.named_parameters():
        np.testing.assert_allclose(cluster["ckpt"][k].numpy(),
                                   p.detach().numpy(), atol=1e-3 * LR,
                                   rtol=0, err_msg=k)
    tr.close()


def test_split_trainer_loop_logs_samples_and_saves(cluster):
    """Trainer.train at mp=2 (dropout on, F0 predictor on): rank 0 alone
    writes the log lines, the eval sample and the checkpoints."""
    assert all(r["loop_step"] == 3 for r in cluster["res"])
    run = cluster["dir"] / "masks_run"
    assert sorted(os.listdir(run / "ckpt")) == ["model-2.pt", "model-3.pt"]
    with open(run / "scalars.jsonl") as f:
        records = [json.loads(ln) for ln in f]
    assert [r["step"] for r in records if "loss/all" in r] == [2, 3]
    evals = [r for r in records if "gen_mel" in r]
    assert len(evals) == 1 and evals[0]["step"] == 2
    mel = np.load(evals[0]["gen_mel"])
    assert mel.shape[1] == 100 and np.isfinite(mel).all()


def test_eval_sample_from_the_first_data_group(cluster, tmp_path):
    """At mp=2 the ranks of data index 0 sample the eval item together
    (rank 0 returns it, the others None) and agree with one process on the
    same checkpoint within the samplers' bound."""
    res = cluster["res"]
    assert [r["eval_returned"] for r in res] == [True, False, False, False]
    tr = ttrainer.Trainer(cluster["ck_cfg"], logs_folder=str(tmp_path),
                          device="cpu")
    tr.load(path=cluster["ck_case"]["path"])
    want = tr.sample_eval(torch.Generator().manual_seed(3))[0]
    np.testing.assert_allclose(cluster["eval"], want, atol=1e-4, rtol=0)
    tr.close()


def test_shard_then_gather_is_the_identity(cluster):
    """(g) in the cluster: gather_parameters(shard_parameters(model))."""
    res = cluster["res"]
    assert all(r["identity"] for r in res)
    model = NaturalSpeech2(cfg := cluster["cfg"])
    placements = tmesh.param_shardings(model, tmesh.make_mesh(2,
                                                              world_size=4))
    for k, shape in res[0]["split_shapes"].items():
        full = list(model.get_parameter(k).shape)
        if placements[k].axis is not None:
            full[placements[k].dim] //= 2
        assert shape == full, (k, cfg.parallel)


# -- single process ---------------------------------------------------------------

def test_rank_blocks_are_jax_param_shardings_device_shards():
    """(g) each rank's block of every port parameter holds exactly the
    values JAX's param_shardings puts on that device of a (1, 2) mesh:
    every flax leaf numbered uniquely, converted, and split both ways."""
    jcfg, cfg = configs()
    batch = {k: jnp.asarray(v) for k, v in _batch(np.random.default_rng(0),
                                                  True).items()}
    jcfg = dataclasses.replace(jcfg, f0_predictor=jconfig.F0PredictorConfig(
        enabled=True, attention_layers=1))
    cfg = dataclasses.replace(cfg, f0_predictor=tconfig.F0PredictorConfig(
        enabled=True, attention_layers=1))
    jm = jdiff.NaturalSpeech2(jcfg)
    abstract = jax.eval_shape(lambda k: jm.init(k, batch, k),
                              jax.random.PRNGKey(0))
    jax_mesh = jmesh.make_mesh(2, devices=jax.devices()[:2])
    specs = jmesh.param_shardings(abstract, jax_mesh)
    leaves = jax.tree.leaves(abstract)
    offsets = np.cumsum([0] + [int(np.prod(a.shape)) for a in leaves])
    assert offsets[-1] < 2 ** 24      # exact in f32
    ids = jax.tree.unflatten(jax.tree.structure(abstract), [
        (offsets[i] + np.arange(offsets[i + 1] - offsets[i])).reshape(
            a.shape).astype(np.float32) for i, a in enumerate(leaves)])
    on_device = [np.zeros(offsets[-1], bool) for _ in range(2)]
    for leaf, spec in zip(jax.tree.leaves(ids), jax.tree.leaves(specs)):
        index = spec.devices_indices_map(leaf.shape)
        for d, dev in enumerate(jax_mesh.devices.reshape(-1)):
            on_device[d][leaf[index[dev]].reshape(-1).astype(np.int64)] = True
    full = from_flax(ids, cfg)
    model = NaturalSpeech2(cfg)
    placements = tmesh.param_shardings(model, tmesh.make_mesh(2,
                                                              world_size=2))
    split = {k for k, pl in placements.items() if pl.axis is not None}
    assert {"diff_model.unet.mid_attn_0.blocks_0.attn1.to_qkv.weight",
            "diff_model.unet.mid_attn_0.blocks_0.ff.proj.weight",
            "pre_model.phoneme_encoder.stack.layers_0.self_attn.in_proj.weight",
            "diff_model.unet.mid_resnet_0.conv1.weight",
            "pre_model.f0_predictor.attn_0.q_proj.weight"} <= split
    # flax's `conv_v` of the weight-normed convs is no 'kernel': JAX
    # replicates it, and so does the port
    assert placements["pre_model.f0_predictor.conv_0_0.conv_v"] == \
        tmesh.REPLICATED
    for r in range(2):
        for k, v in full.items():
            # the block's ids (unique over the model) are those of the
            # whole tensor that JAX puts on device r
            block = tmesh.shard_tensor(v, placements[k], r, 2)
            mine = block.reshape(-1).numpy().astype(np.int64)
            whole = v.reshape(-1).numpy().astype(np.int64)
            assert on_device[r][mine].all(), (r, k)
            assert on_device[r][whole].sum() == len(mine), (r, k)
            if k in split:
                assert block.numel() * 2 == v.numel(), k
        back = {k: tmesh.unshard_tensor(
            [tmesh.shard_tensor(v, placements[k], i, 2) for i in range(2)],
            placements[k]) for k, v in full.items()}
        assert all(torch.equal(back[k], v) for k, v in full.items())


class _Ranks:
    """Two ranks simulated by threads: each collective call of the port's
    f/g exchanges tensors in place of torch.distributed."""

    def __init__(self, n=2):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def exchange(self, rank, t):
        self.slots[rank] = t.detach().clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


@pytest.fixture
def simulated(monkeypatch):
    def gather(x, group):
        ranks, rank = group
        return ranks.exchange(rank, x)

    def reduce(x, group):
        ranks, rank = group
        x.copy_(sum(ranks.exchange(rank, x)))
    monkeypatch.setattr(ttensor, "all_gather", gather)
    monkeypatch.setattr(ttensor, "all_reduce_sum", reduce)
    return _Ranks()


def _run_ranks(ranks, fn):
    out, errors = [None] * ranks.n, []

    def run(r):
        try:
            out[r] = fn(r)
        except Exception as e:     # re-raised in the test's thread
            errors.append(e)
            ranks.barrier.abort()
    threads = [threading.Thread(target=run, args=(r,))
               for r in range(ranks.n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("kind,blocks", [("linear", 1), ("linear", 3),
                                         ("conv", 1)])
def test_column_parallel_layer_forward_and_backward(simulated, kind, blocks):
    """f/g around a split Linear (plain and fused q/k/v) or Conv1d on two
    simulated ranks: the whole layer's output, its input gradient, each
    rank's block of its weight gradient and the whole bias gradient."""
    from ns2vc_tpu_torch.models.layers import Conv1d

    torch.manual_seed(0)
    if kind == "linear":
        layer = nn.Linear(6, 8 * blocks, bias=blocks == 1)
        x = torch.randn(3, 5, 6)
    else:
        layer = Conv1d(6, 8, 3)
        x = torch.randn(3, 5, 6)
    holder = nn.Module()
    holder.layer = layer
    y = layer(x.requires_grad_())
    dy = torch.randn_like(y)
    y.backward(dy)
    pl = tmesh.Placement("model", 0, blocks)

    def rank(r):
        import copy

        mine = copy.deepcopy(holder)
        ttensor.split_layer(mine, "layer", "weight", pl, (simulated, r), r, 2)
        xr = x.detach().clone().requires_grad_()
        yr = mine.layer(xr)
        yr.backward(dy)
        return yr.detach(), xr.grad, mine.layer
    for r, (yr, dx, split) in enumerate(_run_ranks(simulated, rank)):
        assert isinstance(split, ttensor.ColumnParallelLinear
                          if kind == "linear" else
                          ttensor.ColumnParallelConv1d)
        torch.testing.assert_close(yr, y.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(dx, x.grad, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(
            split.weight.grad, tmesh.shard_tensor(layer.weight.grad, pl, r,
                                                  2), rtol=1e-6, atol=1e-6)
        if layer.bias is not None:
            torch.testing.assert_close(split.bias.grad, layer.bias.grad,
                                       rtol=1e-6, atol=1e-6)


def test_gather_reorders_fused_blocks(simulated):
    """blocks = 3: rank r's local [q_r | k_r | v_r] gather to
    [q_0 q_1 | k_0 k_1 | v_0 v_1]; the backward keeps rank r's pieces."""
    def rank(r):
        split = ttensor.ColumnSplit((simulated, r), r, 2, 3)
        local = (torch.arange(6.0) + 10 * r).reshape(1, 6).requires_grad_()
        y = ttensor._GatherFeatures.apply(split, local)
        y.backward(torch.arange(12.0).reshape(1, 12))
        return y.detach(), local.grad
    (y0, g0), (y1, g1) = _run_ranks(simulated, rank)
    want = torch.tensor([[0., 1, 10, 11, 2, 3, 12, 13, 4, 5, 14, 15]])
    assert torch.equal(y0, want) and torch.equal(y1, want)
    assert torch.equal(g0, torch.tensor([[0., 1, 4, 5, 8, 9]]))
    assert torch.equal(g1, torch.tensor([[2., 3, 6, 7, 10, 11]]))


def test_model_axis_without_a_group_raises():
    """No fallback: mp=2 in one process does not divide the world."""
    _, cfg = configs(mp=2)
    with pytest.raises(ValueError):
        ttrainer.Trainer(cfg, logs_folder="unused", device="cpu")
