"""The port's data parallelism (`ns2vc_tpu_torch/parallel/`, the synced
loader, the multi-process Trainer) against the JAX package's, on the CPU.

- `param_shardings` places every parameter of a small `Config` (F0
  predictor on, one UNet level 256 wide) as JAX's rule does at a 2-device
  model axis: each flax leaf is filled with a marker that counts along its
  sharded axis (zero where JAX replicates), converted through `from_flax`,
  and each port tensor must be zero where the port replicates it and count
  along the dim (per fused block) where the port splits it; at mp=1
  everything is replicated.
- `synced_schedule` equals JAX's item for item (first 20 global batches,
  fixed-shape and bucketed), and `synced_data_loader`'s two shards,
  concatenated, equal JAX's global batch bit for bit (workers 0 and 2).
- A 2-process gloo cluster through NS2VC_COORDINATOR (JAX's own 2-process
  test): all-reduce of 1+2+3+4 gives 10; broadcast, the mesh, the barrier.
- The port's 2-rank Trainer step (f32, dropout 0 in both packages, so no
  random mask enters) against JAX's step on a 2-device 'data' mesh on the
  same global batch and the same draws of t and noise, and against the
  port's 1-process step on the concatenated batch: loss rtol 2e-5, grad
  norm rtol 2e-4, every parameter's gradient rtol 1e-3 / atol 1e-7 (JAX's
  own tolerances, tests/test_parallel.py); the two ranks' parameters and
  gradients bitwise equal.
- With the F0 predictor on (dropout 0), the 2-rank step, drawing t, noise
  and the F0 scale itself, against one process on the concatenated batch
  at the same tolerances.
- The 2-process bucketed journey (JAX's TestMultiHostTrainer): train 4
  steps, save, resume on both ranks, train 2 more; the ranks agree on the
  geometry sequence, which is JAX's schedule's, and on the parameters
  after training, after the resume and after training on.
- The group's step program (`Trainer._train_step_program`, `compiled` set
  by hand: on the CPU its body runs eagerly over the static buffers, the
  work a card captures under NCCL; gloo itself is never captured): the
  JAX step case, the F0 case (the body draws the F0 scale) and a case with
  dropout 0.2 and EMA every 2 steps over two steps (data index 1 draws its
  masks from the dropout generator the program seeds per step), each bit
  for bit the eager group step's (loss terms, grad norm, gradients,
  parameters, AdamW moments, EMA), and the JAX case at JAX's tolerances.

The cluster cases share one run of two worker processes.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu import config as jconfig
from ns2vc_tpu.data import dataset as jds
from ns2vc_tpu.models import diffusion as jdiff
from ns2vc_tpu.parallel import mesh as jmesh
from ns2vc_tpu.train import trainer as jtrainer
from ns2vc_tpu_torch import config as tconfig
from ns2vc_tpu_torch.convert import from_flax, init_module_
from ns2vc_tpu_torch.data import dataset as tds
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
from ns2vc_tpu_torch.parallel import mesh as tmesh
from ns2vc_tpu_torch.train import trainer as ttrainer
from test_torch_data import write_features
from test_torch_slice import _filled_tree
from test_torch_train import _draws, configs


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
# the JAX multi-host journey's utterance lengths: both content buckets
LENGTHS = [40, 56, 64, 48, 36, 60, 44, 52, 40, 64,
           56, 34, 45, 38, 62, 50, 20, 90]
STEP_B, STEP_T, STEP_TP = 4, 16, 12      # the global batch of the step case


# -- the mesh and the sharding rule ------------------------------------------

def _sharding_configs():
    def make(m):
        return m.Config(
            phoneme_encoder=m.EncoderConfig(n_layers=1),
            prompt_encoder=m.EncoderConfig(in_channels=100, n_layers=1),
            diffusion_encoder=m.DiffusionEncoderConfig(
                block_out_channels=(16, 256)),
            f0_predictor=m.F0PredictorConfig(enabled=True,
                                             attention_layers=1))
    return make(jconfig), make(tconfig)


def test_param_shardings_match_jax_at_a_model_axis_of_two():
    jcfg, cfg = _sharding_configs()
    b, t = 2, 16
    batch = {"c": jnp.zeros((b, t, 256)), "refer": jnp.zeros((b, t, 100)),
             "spec": jnp.zeros((b, t, 100)), "f0": jnp.ones((b, t)),
             "uv": jnp.ones((b, t)), "lengths": jnp.full((b,), t),
             "refer_lengths": jnp.full((b,), t)}
    jm = jdiff.NaturalSpeech2(jcfg)
    abstract = jax.eval_shape(lambda k: jm.init(k, batch, k),
                              jax.random.PRNGKey(0))
    specs = jmesh.param_shardings(abstract, jmesh.make_mesh(2))

    def marker(a, s):
        if all(p is None for p in s.spec):
            return np.zeros(a.shape, np.float32)
        assert tuple(s.spec) == (None,) * (len(a.shape) - 1) + ("model",)
        return np.broadcast_to(1.0 + np.arange(a.shape[-1], dtype=np.float32),
                               a.shape).copy()

    marked = from_flax(jax.tree.map(marker, abstract, specs), cfg)
    model = NaturalSpeech2(cfg)
    got = tmesh.param_shardings(model, tmesh.make_mesh(2, world_size=2))
    assert set(got) == {n for n, _ in model.named_parameters()}
    split = 0
    for name, pl in got.items():
        v = marked[name]
        if pl.axis is None:
            assert (v == 0).all(), name
            continue
        assert pl.axis == "model", name
        split += 1
        w = v.movedim(pl.dim, 0)
        w = w.reshape(pl.blocks, w.shape[0] // pl.blocks, -1)
        want = 1.0 + torch.arange(w.shape[1], dtype=torch.float32)
        assert torch.equal(w, want[None, :, None].expand_as(w)), name
    assert split >= 10 and len(got) - split >= 100, (split, len(got))
    # the weight-normed convs: flax names their kernel `conv_v`, which the
    # JAX rule (`kernel` / `weight_v` leaves) does not split, and the
    # marker above holds the port to replicating it too
    for i in range(3):
        name = f"pre_model.f0_predictor.conv_0_{i}.conv_v"
        assert got[name] == tmesh.REPLICATED and (marked[name] == 0).all()


def test_param_shardings_replicate_everything_at_mp1():
    _, cfg = _sharding_configs()
    got = tmesh.param_shardings(NaturalSpeech2(cfg), tmesh.make_mesh(1))
    assert set(got.values()) == {tmesh.REPLICATED}


def test_mesh_and_batch_layout_without_a_group():
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.axis_names == ("data", "model")
    assert tmesh.world() == (0, 1)
    m = tmesh.make_mesh(2, world_size=8)
    assert m.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        tmesh.make_mesh(3, world_size=8)
    sharding = tmesh.BatchSharding(1, 4)
    assert sharding.rows(8) == slice(2, 4)
    with pytest.raises(ValueError):
        sharding.rows(6)
    x = np.arange(10)
    assert (tmesh.shard_batch({"x": x}, mesh)["x"] == x).all()
    tmesh.host_barrier("alone")     # a no-op in one process
    dev = tmesh.put_local_batch({"a": x.astype(np.float32)[::2],
                                 "n": x.astype(np.int32)},
                                torch.device("cpu"), torch.bfloat16)
    assert dev["a"].dtype == torch.bfloat16 and dev["n"].dtype == torch.int32
    assert dev["a"].tolist() == [0, 2, 4, 6, 8]


# -- the synced loader --------------------------------------------------------

@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    return write_features(str(tmp_path_factory.mktemp("feats")), LENGTHS)


def _datasets(feature_dir, bucketed, **train):
    kw = dict(max_content_frames=64, max_refer_frames=48, **train)
    if bucketed:
        kw["length_buckets"] = (32, 64)
    jcfg = jconfig.Config(train=jconfig.TrainConfig(**kw))
    cfg = tconfig.Config(train=tconfig.TrainConfig(**kw))
    jd = jds.VCDataset(feature_dir, jcfg, seed=0, load_audio=False)
    td = tds.VCDataset(feature_dir, cfg, seed=0, load_audio=False)
    if bucketed:
        return (jd, jds.BucketedCollator(jcfg, (32, 64), include_wav=False),
                td, tds.BucketedCollator(cfg, (32, 64), include_wav=False))
    return (jd, jds.FixedShapeCollator(jcfg, include_wav=False),
            td, tds.FixedShapeCollator(cfg, include_wav=False))


@pytest.mark.parametrize("bucketed", [False, True])
def test_synced_schedule_matches_jax(feature_dir, bucketed):
    jd, jcol, td, tcol = _datasets(feature_dir, bucketed)
    assert td.audiopaths == jd.audiopaths
    want = jds.synced_schedule(jd, jcol, 8, seed=3)
    got = tds.synced_schedule(td, tcol, 8, seed=3)
    geoms = set()
    for _ in range(20):
        g, w = next(got), next(want)
        assert g == w
        geoms.add(g[0])
    assert len(geoms) == (2 if bucketed else 1), geoms
    # the lengths come from the headers alone, as the loads realise them
    for i in range(len(td)):
        assert td.item_frames(i) == td.get_audio(td.audiopaths[i])[2].shape[0]


@pytest.mark.parametrize("workers", [0, 2])
def test_synced_loader_shards_are_the_jax_global_batch(feature_dir, workers):
    jd, jcol, td, tcol = _datasets(feature_dir, True)
    want = jds.synced_data_loader(jd, jcol, 4, seed=1, shard_index=0,
                                  shard_count=1)
    shards = [tds.synced_data_loader(td, tcol, 2, seed=1, num_workers=workers,
                                     shard_index=r, shard_count=2)
              for r in range(2)]
    try:
        for _ in range(4):
            w = next(want)
            parts = [next(s) for s in shards]
            assert list(parts[0]) == list(w)
            for k in w:
                got = np.concatenate([p[k] for p in parts])
                np.testing.assert_array_equal(got, w[k], err_msg=k)
                assert got.dtype == w[k].dtype, k
    finally:
        for s in shards:
            s.close()


# -- a 2-process gloo cluster -------------------------------------------------

_WORKER = textwrap.dedent('''
    import os, sys, dataclasses, json
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import torch.distributed as dist
    from ns2vc_tpu_torch.parallel import mesh
    from ns2vc_tpu_torch.config import load_config
    from ns2vc_tpu_torch.train.trainer import Trainer

    assert mesh.maybe_initialize_distributed("cpu")
    rank, n = mesh.world()
    out = os.environ["T_OUT"]
    assert n == 2 and dist.get_backend() == "gloo"
    assert mesh.make_mesh().shape == {"data": 2, "model": 1}

    # 1 + 2 + 3 + 4 across both processes
    local = torch.arange(4.0)[2 * rank:2 * rank + 2] + 1
    total = local.sum()
    dist.all_reduce(total)
    x = torch.full((3,), float(rank + 1))
    mesh.all_reduce_mean(x)
    y = torch.full((2,), float(rank))
    mesh.broadcast_([y])
    mesh.host_barrier("cluster")
    print("TOTAL", float(total), x.tolist(), y.tolist(), flush=True)

    def stepped(tr, ms):
        """What a step leaves: metrics, gradients, parameters, moments."""
        opt = tr.state.optimizer.state_dict()["state"]
        return {"metrics": [{k: m[k] for k in ("loss", "loss_diff",
                                                "loss_f0", "grad_norm")}
                            for m in ms],
                "grads": {k: p.grad.clone() for k, p in
                          tr.model.named_parameters()},
                "params": tr.model.state_dict(),
                "moments": {(i, k): v for i, st in opt.items()
                            for k, v in st.items()},
                "ema": tr.state.ema_params, "programs": len(tr._step_programs)}

    def program_trainer(cfg, name):
        tr = Trainer(cfg, logs_folder=os.path.join(out, name), device="cpu")
        tr.compiled = True    # the program body, eagerly over its buffers
        return tr

    # one step on this rank's rows of the global batch, JAX's draws
    case = torch.load(os.path.join(out, "step_case.pt"))
    cfg = load_config(os.path.join(out, "step_config.json"))
    tr = Trainer(cfg, logs_folder=os.path.join(out, "step_run"),
                 device="cpu")
    tr.model.load_state_dict(case["params"])
    local = mesh.shard_batch(case["batch"], tr.mesh)
    m = tr.train_step(tr.device_batch(local), t=case["t"],
                      noise=case["noise"])
    torch.save({"loss": m["loss"], "grad_norm": m["grad_norm"],
                "grads": {k: p.grad for k, p in
                          tr.model.named_parameters()},
                "params": tr.model.state_dict(),
                "state": stepped(tr, [m])},
               os.path.join(out, f"step_rank{rank}.pt"))
    assert not (tr.compiled or tr.eval_compiled)
    tr.close()

    # the same step through the group's step program
    tr = program_trainer(cfg, "prog_run")
    tr.model.load_state_dict(case["params"])
    m = tr.train_step(tr.device_batch(local), t=case["t"],
                      noise=case["noise"])
    torch.save(stepped(tr, [m]), os.path.join(out, f"prog_rank{rank}.pt"))
    tr.close()

    # the F0 predictor on: t, noise and the F0 scale from the step's
    # generator at the global batch's shape
    case = torch.load(os.path.join(out, "f0_case.pt"))
    cfg = load_config(os.path.join(out, "f0_config.json"))
    tr = Trainer(cfg, logs_folder=os.path.join(out, "f0_run"), device="cpu")
    tr.model.load_state_dict(case["params"])
    m = tr.train_step(tr.device_batch(mesh.shard_batch(case["batch"],
                                                       tr.mesh)))
    torch.save({"loss": m["loss"], "loss_f0": m["loss_f0"],
                "grad_norm": m["grad_norm"],
                "grads": {k: p.grad for k, p in
                          tr.model.named_parameters()},
                "state": stepped(tr, [m])},
               os.path.join(out, f"f0_rank{rank}.pt"))
    tr.close()
    tr = program_trainer(cfg, "f0_prog_run")
    tr.model.load_state_dict(case["params"])
    m = tr.train_step(tr.device_batch(mesh.shard_batch(case["batch"],
                                                       tr.mesh)))
    torch.save(stepped(tr, [m]), os.path.join(out, f"f0prog_rank{rank}.pt"))
    tr.close()

    # dropout 0.2, EMA every 2 steps: two eager steps, two program steps
    cfg = load_config(os.path.join(out, "drop_config.json"))
    drop = {}
    for name in ("eager", "prog"):
        tr = Trainer(cfg, logs_folder=os.path.join(out, f"drop_{name}"),
                     device="cpu") if name == "eager" else \
            program_trainer(cfg, "drop_prog")
        b = tr.device_batch(mesh.shard_batch(case["batch"], tr.mesh))
        drop[name] = stepped(tr, [tr.train_step(b) for _ in range(2)])
        tr.close()
    torch.save(drop, os.path.join(out, f"drop_rank{rank}.pt"))

    # the bucketed journey: train, save, resume on both ranks, train on
    cfg = load_config(os.path.join(out, "journey_config.json"))
    def phash(model):
        return float(sum(p.detach().abs().double().sum()
                         for p in model.parameters()))
    def recording(tr):
        geoms, step = [], tr.train_step
        def recorded(batch, *args, **kw):
            geoms.append([batch["c"].shape[1], batch["refer"].shape[1]])
            return step(batch, *args, **kw)
        tr.train_step = recorded
        return geoms
    tr = Trainer(cfg, device="cpu")
    assert tr.logs_folder.endswith("run-s0"), tr.logs_folder
    geoms = recording(tr)
    tr.train(num_steps=4)
    assert tr.step == 4
    print("GEOMS", json.dumps(geoms), flush=True)
    tr.save()
    print("PARAMS %.10e" % phash(tr.model), flush=True)
    tr.close()
    tr2 = Trainer(cfg, device="cpu")
    tr2.load()
    print("RESUMED", tr2.step, flush=True)
    assert phash(tr2.model) == phash(tr.model)
    geoms = recording(tr2)
    tr2.train(num_steps=6)
    assert tr2.step == 6
    print("GEOMS2", json.dumps(geoms), flush=True)
    print("PARAMS2 %.10e" % phash(tr2.model), flush=True)
    tr2.close()
    dist.destroy_process_group()
    print("WORKER-OK", flush=True)
''')


def _step_case(out_dir, feature_dir):
    """The global batch, JAX's loss / grad norm / gradients on a 2-device
    data mesh, and the draws of t and noise its step made; the initial
    parameters and the config written for the workers."""
    jcfg, cfg = configs(levels=(16, 24), p_dropout=0.0,
                        data={"training_files": feature_dir},
                        train_batch_size=STEP_B // 2, train_lr=1e-3,
                        num_workers=0, use_ema=False,
                        compute_dtype="float32")
    r = np.random.default_rng(11)
    batch = {"c": r.standard_normal((STEP_B, STEP_T, 256)),
             "refer": r.standard_normal((STEP_B, STEP_TP, 100)),
             "spec": r.standard_normal((STEP_B, STEP_T, 100))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    batch["lengths"] = np.array([16, 11, 9, 16], np.int32)
    batch["refer_lengths"] = np.array([12, 7, 12, 5], np.int32)
    jm = jdiff.NaturalSpeech2(jcfg)
    params = _filled_tree(lambda k: jm.init(k, batch, k), r)
    jopt = jtrainer.make_optimizer(jcfg)
    jstep = jtrainer.make_train_step(jm, jopt)

    def step_and_grads(state, b, rng):
        new, metrics = jstep(state, b, rng)
        key = jax.random.fold_in(rng, state.step)
        grads = jax.grad(lambda p: jm.apply(
            p, b, key, deterministic=False,
            rngs={"dropout": jax.random.fold_in(key, 1)})[0])(state.params)
        return new, metrics, grads

    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=jopt.init(params))
    mesh = jmesh.make_mesh(1, devices=jax.devices()[:2])
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    rng = jax.random.PRNGKey(5)
    with mesh:
        _, metrics, grads = jax.jit(
            step_and_grads, in_shardings=(repl, jmesh.batch_sharding(mesh),
                                          None))(state, batch, rng)
    gn = float(metrics["grad_norm"])
    scale = min(1.0, cfg.train.grad_clip_norm / gn)    # the step clips
    t, noise = _draws(jax.random.fold_in(rng, 0), STEP_B, STEP_T)
    case = {"params": from_flax(jax.tree.map(np.asarray, params), cfg),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "t": torch.from_numpy(np.array(t)),
            "noise": torch.from_numpy(np.array(noise))}
    torch.save(case, os.path.join(out_dir, "step_case.pt"))
    tconfig.save_config(cfg, os.path.join(out_dir, "step_config.json"))
    want = {"loss": float(metrics["loss"]), "grad_norm": gn,
            "grads": {k: v * scale for k, v in from_flax(
                jax.tree.map(np.asarray, grads), cfg).items()}}
    return cfg, case, want


def _f0_case(out_dir, feature_dir):
    """A global batch with F0 for the F0-predictor case, the port's
    initial parameters and its config (dropout 0 everywhere)."""
    _, cfg = configs(levels=(16, 24), p_dropout=0.0,
                     data={"training_files": feature_dir},
                     train_batch_size=STEP_B // 2, num_workers=0,
                     use_ema=False, compute_dtype="float32")
    cfg = dataclasses.replace(cfg, f0_predictor=tconfig.F0PredictorConfig(
        enabled=True, attention_layers=1, p_dropout=0.0))
    r = np.random.default_rng(12)
    f0 = (120.0 + 150.0 * r.random((STEP_B, STEP_T))).astype(np.float32)
    f0[:, 3:6] = 0.0
    batch = {"c": r.standard_normal((STEP_B, STEP_T, 256)),
             "refer": r.standard_normal((STEP_B, STEP_TP, 100)),
             "spec": r.standard_normal((STEP_B, STEP_T, 100))}
    batch = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in batch.items()}
    batch.update(f0=torch.from_numpy(f0),
                 uv=torch.from_numpy((f0 > 0).astype(np.float32)),
                 lengths=torch.tensor([16, 11, 9, 16], dtype=torch.int32),
                 refer_lengths=torch.tensor([12, 7, 12, 5],
                                            dtype=torch.int32))
    model = NaturalSpeech2(cfg)
    init_module_(model, torch.Generator().manual_seed(3))
    case = {"params": model.state_dict(), "batch": batch}
    torch.save(case, os.path.join(out_dir, "f0_case.pt"))
    tconfig.save_config(cfg, os.path.join(out_dir, "f0_config.json"))
    # the dropout case: masks in the encoders and the F0 predictor, the EMA
    # updated at the second step
    tconfig.save_config(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, use_ema=True,
                                       ema_update_every=2, ema_decay=0.9),
        phoneme_encoder=dataclasses.replace(cfg.phoneme_encoder,
                                            p_dropout=0.2),
        prompt_encoder=dataclasses.replace(cfg.prompt_encoder,
                                           p_dropout=0.2),
        f0_predictor=dataclasses.replace(cfg.f0_predictor, p_dropout=0.2)),
        os.path.join(out_dir, "drop_config.json"))
    return cfg, case


def _journey(out_dir, feature_dir):
    """The JAX multi-host journey's configuration (content buckets 32 and
    64; per-process batch 2), its run dir under out_dir/logs; and the
    geometries JAX's schedule gives for it."""
    jcfg, cfg = configs(levels=(16, 24), p_dropout=0.0,
                        data={"training_files": feature_dir,
                              "val_files": os.path.join(out_dir, "none")},
                        train_batch_size=2, train_lr=1e-4,
                        save_and_sample_every=10_000, keep_ckpts=2,
                        max_content_frames=64, max_refer_frames=48,
                        length_buckets=(32, 64), num_workers=0, log_every=2,
                        remat=False, seed=0, compute_dtype="float32",
                        logs_folder=os.path.join(out_dir, "logs"))
    tconfig.save_config(cfg, os.path.join(out_dir, "journey_config.json"))
    jd = jds.VCDataset(feature_dir, jcfg, seed=0, load_audio=False)
    sched = jds.synced_schedule(
        jd, jds.BucketedCollator(jcfg, (32, 64), include_wav=False), 4)
    return [list(next(sched)[0]) for _ in range(6)]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory, feature_dir):
    out = tmp_path_factory.mktemp("cluster")
    cfg, case, want = _step_case(str(out), feature_dir)
    f0_cfg, f0_case = _f0_case(str(out), feature_dir)
    geoms = _journey(str(out), feature_dir)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "NS2VC_COORDINATOR": f"localhost:{port}",
           "NS2VC_NUM_PROCESSES": "2", "T_OUT": str(out),
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("NS2VC_DISTRIBUTED", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER],
        env={**env, "NS2VC_PROCESS_ID": str(i)}, cwd=str(out),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-4000:]
        assert "WORKER-OK" in text, text[-4000:]
    def ranks(name):
        return [torch.load(out / f"{name}_rank{i}.pt") for i in range(2)]
    return {"outs": outs, "cfg": cfg, "case": case, "want": want,
            "ranks": ranks("step"), "geoms": geoms, "dir": out,
            "f0_cfg": f0_cfg, "f0_case": f0_case, "f0_ranks": ranks("f0"),
            "prog_ranks": ranks("prog"), "f0prog_ranks": ranks("f0prog"),
            "drop_ranks": ranks("drop")}


def _lines(text, tag):
    return [ln for ln in text.splitlines() if ln.startswith(tag + " ")]


def test_two_process_gloo_cluster(cluster):
    for rank, text in enumerate(cluster["outs"]):
        # 1+2+3+4 across both processes; the mean of 1 and 2; rank 0's
        assert _lines(text, "TOTAL") == ["TOTAL 10.0 [1.5, 1.5, 1.5] "
                                         "[0.0, 0.0]"], rank


def _assert_step(got, want):
    assert got["loss"].item() == pytest.approx(want["loss"], rel=LOSS_RTOL)
    assert got["grad_norm"].item() == pytest.approx(want["grad_norm"],
                                                    rel=NORM_RTOL)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), np.asarray(g),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


def test_two_rank_step_matches_jax_data_mesh_and_one_process(cluster,
                                                             tmp_path):
    r0, r1 = cluster["ranks"]
    for key in ("params", "grads"):
        for k, v in r0[key].items():
            assert torch.equal(v, r1[key][k]), (key, k)
    assert r0["loss"].item() == r1["loss"].item()
    _assert_step(r0, cluster["want"])
    # the port's step in one process on the concatenated batch
    case = cluster["case"]
    tr = ttrainer.Trainer(cluster["cfg"], logs_folder=str(tmp_path / "one"),
                          device="cpu")
    tr.model.load_state_dict(case["params"])
    m = tr.train_step(tr.device_batch(case["batch"]), t=case["t"],
                      noise=case["noise"])
    one = {"loss": m["loss"], "grad_norm": m["grad_norm"],
           "grads": {k: p.grad for k, p in tr.model.named_parameters()}}
    _assert_step(r0, {"loss": one["loss"].item(),
                      "grad_norm": one["grad_norm"].item(),
                      "grads": one["grads"]})


def test_two_rank_step_with_the_f0_predictor_matches_one_process(
        cluster, tmp_path):
    """t, noise and the F0 contour's scale drawn by the ranks at the
    global batch's shape are the draws of one process on the whole batch
    (dropout 0: no mask is drawn between them)."""
    r0, r1 = cluster["f0_ranks"]
    for k, v in r0["grads"].items():
        assert torch.equal(v, r1["grads"][k]), k
    assert r0["loss_f0"].item() > 0.0
    tr = ttrainer.Trainer(cluster["f0_cfg"], logs_folder=str(tmp_path),
                          device="cpu")
    tr.model.load_state_dict(cluster["f0_case"]["params"])
    m = tr.train_step(tr.device_batch(cluster["f0_case"]["batch"]))
    assert r0["loss_f0"].item() == pytest.approx(m["loss_f0"].item(),
                                                 rel=LOSS_RTOL)
    _assert_step(r0, {"loss": m["loss"].item(),
                      "grad_norm": m["grad_norm"].item(),
                      "grads": {k: p.grad for k, p in
                                tr.model.named_parameters()}})


def test_two_process_bucketed_train_save_resume(cluster):
    outs = cluster["outs"]
    for tag in ("GEOMS", "GEOMS2", "PARAMS", "RESUMED", "PARAMS2"):
        assert _lines(outs[0], tag) == _lines(outs[1], tag) != [], tag
    geoms = json.loads(_lines(outs[0], "GEOMS")[0].split(" ", 1)[1])
    again = json.loads(_lines(outs[0], "GEOMS2")[0].split(" ", 1)[1])
    # JAX's schedule's geometries, both content buckets among them; the
    # resumed run reads the schedule from its start again, as JAX's does
    assert geoms == cluster["geoms"][:4] and again == cluster["geoms"][:2]
    assert {g[0] for g in geoms} == {32, 64}
    assert _lines(outs[0], "RESUMED") == ["RESUMED 4"]
    run = cluster["dir"] / "logs" / "run-s0"
    assert sorted(os.listdir(run / "ckpt")) == ["model-4.pt", "model-6.pt"]
    with open(run / "scalars.jsonl") as f:     # rank 0 writes alone
        steps = [json.loads(ln)["step"] for ln in f]
    assert steps == [2, 4, 6]


def _differing(a: dict, b: dict) -> list:
    """What two `stepped` records of the worker hold differently."""
    out = [f"step {i} {k}" for i, (x, y) in enumerate(zip(a["metrics"],
                                                         b["metrics"]))
           for k in x if not torch.equal(x[k], y[k])]
    for part in ("grads", "params", "moments", "ema"):
        x, y = a[part] or {}, b[part] or {}
        assert x.keys() == y.keys(), part
        out += [f"{part} {k}" for k in x if not torch.equal(x[k], y[k])]
    return out


@pytest.mark.parametrize("case", ["jax_step", "f0", "dropout"])
def test_two_rank_step_program_equals_the_eager_group_step(cluster, case):
    """The group's step program (its body run eagerly over the static
    buffers, as compiled on the CPU) is the eager group step bit for bit
    on each rank; the JAX case also matches JAX's 2-device data mesh at
    JAX's tolerances."""
    for rank in range(2):
        if case == "dropout":
            got = cluster["drop_ranks"][rank]
            prog, eager = got["prog"], got["eager"]
            assert len(prog["metrics"]) == 2 and prog["ema"]
        elif case == "f0":
            prog = cluster["f0prog_ranks"][rank]
            eager = cluster["f0_ranks"][rank]["state"]
            assert prog["metrics"][0]["loss_f0"] > 0
        else:
            prog = cluster["prog_ranks"][rank]
            eager = cluster["ranks"][rank]["state"]
            m = prog["metrics"][0]
            _assert_step({"loss": m["loss"], "grad_norm": m["grad_norm"],
                          "grads": prog["grads"]}, cluster["want"])
        assert prog["programs"] == 1 and eager["programs"] == 0, rank
        assert not _differing(prog, eager), (rank, _differing(prog,
                                                              eager)[:5])
    if case == "dropout":   # the replicas agree after the masked steps
        a, b = (cluster["drop_ranks"][r]["prog"] for r in range(2))
        assert all(torch.equal(v, b["params"][k])
                   for k, v in a["params"].items())
