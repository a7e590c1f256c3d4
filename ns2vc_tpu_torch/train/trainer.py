"""Training on one card, or on several with data parallelism
(counterpart of ns2vc_tpu/train/trainer.py).

The train step keeps f32 master parameters and runs the forward on bf16
copies of them when `compute_dtype` is bfloat16 (`utils/precision.py`), so
K1 and K2 take their tensor-core kernels; autograd carries the gradients
through the casts, through K1's and K2's autograd Functions and, with
`remat`, through the checkpointed UNet blocks. Per step:

- gradient accumulation: the batch is split into `accum` micro-batches,
  each with its own draws of t, noise and dropout masks from the step's
  generator; loss and gradients are averaged over them;
- in a process group, one all-reduce averages the gradients (and the loss
  terms) over the ranks: they live in one flat buffer
  (`parallel.mesh.flat_gradients`, `all_reduce_mean`);
- the global gradient norm is taken before clipping and logged;
- clipping by global norm with optax's rule (g * max_norm / |g| only when
  |g| >= max_norm, no epsilon);
- AdamW with the config's lr, betas and eps and optax's default weight
  decay 1e-4 (the JAX package's `optax.adamw` gets none and uses its
  default; torch's default would be 1e-2);
- EMA of the updated parameters at (step + 1) % ema_update_every == 0.

The step's generator is seeded from (seed, step), as the JAX step folds the
step into its key, so a resumed run draws what the uninterrupted run would
have drawn.

Data parallelism (a process group is up: `parallel.mesh.
maybe_initialize_distributed`, which `train/cli.py` calls) follows the JAX
package's 'data' mesh axis. `train_batch_size` is per process, so the
global batch is that times the world size; every rank reads its rows of
the same global batches through `synced_data_loader`; rank 0's parameters
are broadcast at init; t, noise (and the F0 contour's scale) are drawn
from the step's generator at the global batch's shape and each rank takes
its rows, as JAX draws from one key over the global batch, so a step of n
ranks on n slices is the step of one process on their concatenation;
dropout masks are per data index, from (step seed, data index) (with
dropout > 0 the masks, and the F0 scale one process draws after them, are
not that process's: `_global_draws`). Clipping, AdamW and the EMA then run
alike on every rank. Rank 0 writes the checkpoints and every rank meets it
after each; every rank reads one on resume. `train.log`, `scalars.jsonl`
and images come from rank 0 only. A group of one process takes this path
too (the synced loader, the all-reduce).

Tensor parallelism (`parallel.model_parallel_size` = mp > 1) follows the
JAX package's 'model' axis: the ranks sit on a (world / mp) x mp mesh
(`parallel.mesh.make_mesh`, which raises when mp does not divide the
world), and each rank holds its block of every parameter
`param_shardings` splits, and so its blocks of the AdamW moments and the
EMA (`shard_parameters`; the layers gather their output features,
`parallel/tensor.py`). The ranks of one model group read the same rows
(the loader shards by data index, `train_batch_size` per data index) and
draw the same dropout masks (by data index), so their activations agree.
The split blocks' gradients are averaged over the data group; the
replicated gradients and the loss terms over every rank (alike on the
ranks of a model group, so this is the data group's mean, and it keeps
the replicas' bits equal whatever order a kernel sums in). The global norm
sums each split block's squares once, over the model group. Checkpoints
hold full tensors (parameters, moments, EMA), gathered before rank 0
writes and split again by every rank that reads, so a run resumes at any
mp. Eval samples come from the ranks of data index 0, through the split
`generate_mel`, and rank 0 writes them.

On a card the step and the milestone eval run as CUDA graphs, the
counterparts of the JAX Trainer's step jitted over its mesh
(`_get_step_fn`) and its jitted `_get_eval_fn` (`utils/graphs.py`).
`compiled_paths` decides which: the step in one process or in a process
group whose groups are all NCCL (its all-reduces, and at mp > 1 the
tensor-parallel gathers and reductions, inside the graph; gloo reduces
through host copies, which no graph holds, so its step is eager); the
eval at a model axis of one under any backend, where its body holds no
collective (at mp > 1 it stays eager, as the JAX multi-host eval is
skipped there). A step program per `_StepKey` (the batch's geometry,
accumulation, dtype, remat and its policy, the F0 predictor, whether t
and noise are given, the TF32 settings): static buffers for the batch's
fields, t and noise (the global batch's, in a group), and the step count,
which each call fills; the step's generator (and, at data index > 0, the
dropout generator) is registered with the graph and seeded before each
call, so a replay draws t, noise, the dropout masks and the F0 scale as
the eager step does (in a group at the global batch's shape, inside the
graph). A key's first call is an eager step on the side stream (the
warm-up: it makes the gradients, the optimizer's state, the NCCL
communicators and everything else lazy outside the capture), then the
capture; every later call replays. AdamW is capturable where the step is
(`make_optimizer`). An eval program per (64-frame content and refer
buckets, F0 predictor, TF32 settings): its body copies the EMA (or the
parameters) into the eval model, then encoders, 30 UniPC steps and Vocos,
with x_T drawn before the call from the eval generator. The metrics are
copied out of the graph after each replay. Loading an optimizer state
(`load`, `Optimizer.load_state_dict`) or new EMA tensors (`load_torch`)
drops the programs: their graphs hold the old tensors' addresses. A
capture that fails raises; no path falls back to the eager step. On the
CPU the step and the eval run eagerly.

`Trainer` drives it: the data loader, the step, the stdout line
`step N loss ... grad_norm ... steps/s ...`, scalars as JSON lines in the
run dir's `scalars.jsonl` (and `train.log`), spectrogram images as PNGs
under `images/` (the JAX trainer's TensorBoard images `all/spec` and
`all/spec_pred` at log steps with accumulation 1, `gen/mel` and `gt/mel`
at eval; none, said once, without matplotlib), a UniPC eval sample from
the EMA parameters when present (mel as .npy, waveform as .wav), and
checkpoints `ckpt/model-N.pt` (step, parameters, optimizer state, EMA, the
config; the newest `keep_ckpts` kept) that `convert.load_checkpoint`, and
so `Svc`, reads. It runs on `cuda` unless given `device="cpu"`, and raises
without a card.

Not ported, because they answer the TPU's runtime: the AOT step cache, the
packed one-buffer host-to-device transfer (`pack_h2d`), the persistent
compile cache, the compile barrier of the multi-host step and the xplane
profile window.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import time
from collections import deque
from datetime import datetime
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ns2vc_tpu_torch.config import Config, load_config, save_config
from ns2vc_tpu_torch.convert import (
    TRAINER_FORMAT, init_module_, save_trainer_checkpoint,
)
from ns2vc_tpu_torch.data.dataset import (
    BucketedCollator, EvalDataset, FixedShapeCollator, VCDataset, data_loader,
)
from ns2vc_tpu_torch.data.dataset import synced_data_loader
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2, generate_mel
from ns2vc_tpu_torch.parallel.mesh import (
    all_reduce_mean, all_reduce_sum, batch_sharding, broadcast_,
    flat_gradients, gather_state, host_barrier, make_mesh, mesh_groups,
    param_shardings, put_local_batch, shard_parameters, shard_state, world,
)
from ns2vc_tpu_torch.utils.graphs import GraphCapturer, GraphProgram
from ns2vc_tpu_torch.utils.precision import (
    cast_floating, parameters_as, resolve_dtype,
)

# optax.adamw's default weight decay, which the JAX trainer uses
ADAMW_WEIGHT_DECAY = 1e-4


def make_optimizer(cfg: Config, params,
                   capturable: bool = False) -> torch.optim.AdamW:
    """AdamW as the JAX package's `optax.adamw(lr, b1, b2, eps)`: the
    config's lr, betas and eps, weight decay 1e-4. Clipping is the train
    step's (`clip_by_global_norm`). `capturable` (parameters on a card
    only) keeps the step count on the device and takes the bias
    corrections there, so a CUDA graph can capture `step()`."""
    t = cfg.train
    return torch.optim.AdamW(params, lr=t.train_lr,
                             betas=tuple(t.adam_betas), eps=t.eps,
                             weight_decay=ADAMW_WEIGHT_DECAY,
                             capturable=capturable)


def global_norm(tensors: list, split: list = (),
                group=None) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor, in f32 (optax.global_norm).
    `split` holds this rank's blocks of tensors split over the model
    `group`: their squares are summed over the group (one all-reduce), so
    each block counts once, as the norm of the global arrays does."""
    norm = torch.linalg.vector_norm(torch.stack(
        [n.float() for n in torch._foreach_norm(tensors)]))
    if not split:
        return norm
    sq = torch.stack([n.float() for n in torch._foreach_norm(split)]
                     ).square().sum().reshape(1)
    all_reduce_sum(sq, group)
    return torch.sqrt(norm.square() + sq[0])


def clip_by_global_norm(grads: list, max_norm: float, split: list = (),
                        group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place over `grads` and `split` (see
    `global_norm`): unchanged while their global norm is below `max_norm`,
    else scaled by max_norm / norm. No host synchronisation. Returns the
    norm before clipping."""
    norm = global_norm(grads, split, group)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(list(grads) + list(split), scale)
    return norm


@dataclasses.dataclass
class TrainState:
    """What a train step changes: the model's (master) parameters, the
    optimizer's state, the step count and the EMA parameters (a {name:
    tensor} dict, or None without EMA)."""
    model: NaturalSpeech2
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema_params: Optional[dict] = None


def init_ema(model: NaturalSpeech2) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _split(x: torch.Tensor | None, accum: int) -> list:
    return [None] * accum if x is None else list(x.chunk(accum))


def make_train_step(accum: int = 1, compute_dtype: torch.dtype =
                    torch.float32, ema_decay: float = 0.0,
                    ema_every: int = 1, max_norm: float = 1.0,
                    data_parallel: bool = False,
                    split_names: frozenset = frozenset(), model_group=None,
                    data_group=None):
    """train_step(state, batch, generator=None, t=None, noise=None,
    f0_factor=None) -> metrics, updating `state` in place. `batch` holds
    tensors with leading dim B = accum * micro-batch on the model's device
    (floats in f32 or the compute dtype); `t` (B,), `noise` (B, T, 100) and
    `f0_factor` (B,), when given, replace the draws from `generator`.
    With `data_parallel`, the gradients live in one flat f32 buffer
    (`parallel.mesh.flat_gradients`, with three slots for the loss terms)
    that one all-reduce averages over the process group after
    accumulation and before clipping, so every rank clips, steps and logs
    the global batch's. Under tensor parallelism `split_names` names the
    parameters split over `model_group`: their gradients sit first in the
    buffer and are averaged over `data_group` (when it has more than one
    rank), the rest over every rank, and the norm counts each block once.
    metrics: loss, its terms loss_diff and loss_f0 (0 without the F0
    predictor) and grad_norm (0-d tensors, no host synchronisation) and,
    with accum 1, pred and target (this rank's rows).

    `train_step.body(state, batch, generator, t, noise, f0_factor, step)`
    is the step's device work alone, what a CUDA graph captures: it reads
    the step count from `step` (a 0-d int64 tensor on the model's device,
    filled before each call), which decides the EMA's update on the device
    (decay d at (step + 1) % ema_every == 0, else 1: e * d + p * (1 - d),
    as the JAX step has it), and leaves `state.step` to its caller. The
    gradients, once allocated, are zeroed in place."""
    flat = None
    counters: dict = {}   # device -> the step count `train_step` fills

    def body(state: TrainState, batch: dict,
             generator: torch.Generator | None, t: torch.Tensor | None,
             noise: torch.Tensor | None, f0_factor: torch.Tensor | None,
             step: torch.Tensor) -> dict:
        nonlocal flat
        model = state.model
        model.train()
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        split = [p for n, p in named if n in split_names]
        params = split + [p for n, p in named if n not in split_names]
        if data_parallel:
            flat = flat_gradients(params, flat, extra=3)
            flat.zero_()
        else:
            state.optimizer.zero_grad(set_to_none=False)
        micro = [dict(zip(batch, vals)) for vals in zip(
            *(v.chunk(accum) for v in batch.values()))]
        loss_sum, aux = 0.0, {}
        terms = {"loss_diff": 0.0, "loss_f0": 0.0}
        for mb, mt, mn, mf in zip(micro, _split(t, accum),
                                  _split(noise, accum),
                                  _split(f0_factor, accum)):
            if compute_dtype != torch.float32:
                cast = cast_floating(dict(model.named_parameters()),
                                     compute_dtype)
                mb = cast_floating(mb, compute_dtype)
            else:
                cast = {}
            # the backward stays inside: remat recomputes with the casts
            with parameters_as(model, cast):
                loss, aux = model(mb, generator, t=mt, noise=mn,
                                  f0_factor=mf)
                loss.backward()
            loss_sum = loss_sum + loss.detach()
            for key in terms:
                terms[key] = terms[key] + torch.as_tensor(aux[key]).detach()
        grads = [p.grad for p in params]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        if data_parallel:
            # in place: a term on the host (the F0 loss's 0.0 without the
            # predictor) is a fill, which a CUDA graph can hold, not a copy
            for slot, x in zip(flat[-3:], (loss_sum, terms["loss_diff"],
                                           terms["loss_f0"])):
                slot.fill_(x)
            n_split = sum(p.numel() for p in split)
            if n_split and dist.get_world_size(data_group) > 1:
                all_reduce_mean(flat[:n_split], data_group)
            all_reduce_mean(flat[n_split:])
            loss_sum, loss_diff, loss_f0 = flat[-3:].clone()
            terms = {"loss_diff": loss_diff, "loss_f0": loss_f0}
        grad_norm = clip_by_global_norm(grads[len(split):], max_norm,
                                        grads[:len(split)], model_group)
        state.optimizer.step()
        if ema_decay > 0.0 and state.ema_params is not None:
            d = torch.where((step + 1) % ema_every == 0, ema_decay, 1.0)
            ema = [state.ema_params[n] for n, _ in named]
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, torch._foreach_mul(
                [p.detach() for _, p in named], 1.0 - d))
        metrics = {"loss": loss_sum / accum, "grad_norm": grad_norm,
                   **{k: v / accum for k, v in terms.items()}}
        if accum == 1:   # outside autograd: the step's graph is freed
            metrics["pred"] = aux["pred"].detach()
            metrics["target"] = aux["target"].detach()
        return metrics

    def train_step(state: TrainState, batch: dict,
                   generator: torch.Generator | None = None,
                   t: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None,
                   f0_factor: torch.Tensor | None = None) -> dict:
        dev = next(state.model.parameters()).device
        if dev not in counters:
            counters[dev] = torch.zeros((), dtype=torch.int64, device=dev)
        metrics = body(state, batch, generator, t, noise, f0_factor,
                       counters[dev].fill_(state.step))
        state.step += 1
        return metrics

    train_step.body = body
    return train_step


def host_transform(batch: dict, cfg: Config) -> dict:
    """Drop the fields the step never reads: the waveform always, f0 and uv
    while the F0 predictor is off. Floats stay f32 (the compute-dtype cast
    happens on the device, in `put_local_batch`)."""
    drop = {"wav"}
    if not cfg.f0_predictor.enabled:
        drop |= {"f0", "uv"}
    return {k: v for k, v in batch.items() if k not in drop}


def dummy_batch(cfg: Config,
                geometry: tuple[int, int] | None = None) -> dict:
    """Zero batch (numpy) at the default or a given (t_c, t_r) geometry."""
    t = cfg.train
    b = max(t.train_batch_size, 1)
    tc, tr = geometry or (t.max_content_frames, t.max_refer_frames)
    return {
        "c": np.zeros((b, tc, cfg.phoneme_encoder.in_channels), np.float32),
        "refer": np.zeros((b, tr, cfg.prompt_encoder.in_channels),
                          np.float32),
        "spec": np.zeros((b, tc, cfg.diffusion_encoder.in_channels),
                         np.float32),
        "f0": np.zeros((b, tc), np.float32),
        "uv": np.zeros((b, tc), np.float32),
        "wav": np.zeros((b, 8), np.float32),
        "lengths": np.full((b,), tc, np.int32),
        "refer_lengths": np.full((b,), tr, np.int32),
    }


def step_seed(seed: int, step: int) -> int:
    """The step generator's seed: a function of the run seed and the step
    only, so a resumed run draws what the uninterrupted one would have."""
    return (seed * 0x9E3779B1 + step * 0x85EBCA77 + 1) & 0x7FFFFFFFFFFF


def rank_seed(step_seed_: int, index: int) -> int:
    """The dropout generator's seed of data index `index` > 0 in a step
    (data index 0 draws its masks from the step's generator itself)."""
    return (step_seed_ * 0xC2B2AE35 + index) & 0x7FFFFFFFFFFF


class _StepKey(NamedTuple):
    """What one step program is for: the batch's geometry, what the step's
    ops depend on, and what a capture bakes in."""
    batch: int
    t: int
    tp: int
    accum: int
    dtype: torch.dtype
    remat: bool
    remat_policy: str
    f0: bool
    given_t: bool
    given_noise: bool
    tf32_matmul: bool
    tf32_cudnn: bool


class _EvalKey(NamedTuple):
    """What one eval program is for: the 64-frame content and refer
    buckets, the F0 predictor, and what a capture bakes in."""
    t_pad: int
    tr_pad: int
    f0: bool
    tf32_matmul: bool
    tf32_cudnn: bool


def _tf32() -> tuple[bool, bool]:
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def compiled_paths(device_type: str, backends=frozenset(),
                   model_size: int = 1) -> tuple[bool, bool]:
    """(step, eval): whether the Trainer's step and its milestone eval run
    as CUDA graphs on a device of `device_type`, with `backends` the
    backends of the process group and of the mesh's model and data groups
    (empty without a group) and `model_size` the model axis. The step is
    captured on a card without a group or where every group is NCCL; the
    eval on a card at a model axis of one, whatever the backend (its body
    holds no collective there)."""
    card = device_type == "cuda"
    return card and set(backends) <= {"nccl"}, card and model_size == 1


class Trainer:
    """End-to-end training driver (reference Trainer, model.py:748-946) on
    one card, or one card per rank of a process group: `train()` steps,
    logs, samples and checkpoints."""

    def __init__(self, cfg: Config | str | None = None,
                 logs_folder: Optional[str] = None,
                 vocos_params: Optional[dict] = None,
                 device: str | torch.device = "cuda"):
        from ns2vc_tpu_torch.infer.svc import resolve_device

        if isinstance(cfg, str):
            cfg = load_config(cfg)
        self.cfg = cfg or Config()
        t = self.cfg.train
        self.device = resolve_device(device)
        self.compute_dtype = resolve_dtype(t.compute_dtype)
        self.rank, self.n_proc = world()
        self.distributed = dist.is_available() and dist.is_initialized()
        self.is_main = self.rank == 0
        self.mesh = make_mesh(self.cfg.parallel.model_parallel_size)
        self.data_index = self.mesh.index("data")
        self.data_size = self.mesh.shape["data"]
        self.model_group, self.data_group = mesh_groups(self.mesh)

        if self.n_proc > 1:
            # every rank derives the same run dir without talking
            default_name = os.path.join(t.logs_folder, f"run-s{t.seed}")
        else:
            default_name = os.path.join(
                t.logs_folder, datetime.now().strftime("%Y-%m-%d-%H-%M-%S"))
        self.logs_folder = logs_folder or default_name
        os.makedirs(self.logs_folder, exist_ok=True)
        if self.is_main:
            self._stamp_git_hash()
            save_config(self.cfg,
                        os.path.join(self.logs_folder, "config.json"))

        model = NaturalSpeech2(self.cfg, remat=t.remat,
                               remat_policy=t.remat_policy)
        init_module_(model, torch.Generator().manual_seed(t.seed))
        model.to(self.device)
        if self.distributed:
            broadcast_(list(model.parameters()))
        self.placements = param_shardings(model, self.mesh)
        shard_parameters(model, self.placements, self.mesh)
        backends = {dist.get_backend(g) for g in (
            None, self.model_group, self.data_group)} \
            if self.distributed else set()
        self.compiled, self.eval_compiled = compiled_paths(
            self.device.type, backends, self.mesh.shape["model"])
        self.state = TrainState(
            model=model, optimizer=make_optimizer(
                self.cfg, model.parameters(), capturable=self.compiled),
            ema_params=init_ema(model) if t.use_ema else None)
        self._graphs = GraphCapturer(self.device)
        self._step_programs: dict[_StepKey, GraphProgram] = {}
        self._eval_programs: dict[_EvalKey, GraphProgram] = {}
        self._programs_of = None   # (optimizer, EMA) the programs captured
        self.accum = t.gradient_accumulate_every
        self._step_fn = make_train_step(
            self.accum, self.compute_dtype,
            ema_decay=t.ema_decay if t.use_ema else 0.0,
            ema_every=t.ema_update_every, max_norm=t.grad_clip_norm,
            data_parallel=self.distributed,
            split_names=frozenset(k for k, pl in self.placements.items()
                                  if pl.axis is not None),
            model_group=self.model_group, data_group=self.data_group)
        self.generator = torch.Generator(self.device)
        self._rank_generator = torch.Generator(self.device)

        if t.length_buckets:
            self._collator = BucketedCollator(
                self.cfg, t.length_buckets,
                refer_buckets=t.refer_length_buckets, include_wav=False)
        elif t.refer_length_buckets:
            raise ValueError(
                "refer_length_buckets is set but length_buckets is empty: "
                "refer-axis buckets only apply on top of content bucketing; "
                "set train.length_buckets too.")
        else:
            self._collator = FixedShapeCollator(self.cfg, include_wav=False)
        self.ds = VCDataset(self.cfg.data.training_files, self.cfg,
                            all_in_mem=t.all_in_mem, seed=t.seed,
                            load_audio=False)
        if t.num_workers < 0:   # auto: serial on a host of <= 2 CPUs
            n_workers = 0 if (os.cpu_count() or 1) <= 2 else 8
        else:
            n_workers = t.num_workers
        self.num_workers = n_workers
        self.dl = None   # made at the first step
        try:
            # seeded: the ranks that sample together take one item
            self.eval_ds = EvalDataset(self.cfg.data.val_files, self.cfg,
                                       seed=t.seed)
            if len(self.eval_ds) == 0:
                self.eval_ds = None
        except Exception:
            self.eval_ds = None
        self.vocos = None
        if vocos_params is not None:
            from ns2vc_tpu_torch.models.vocos import vocos_from_state_dict

            self.vocos = vocos_from_state_dict(vocos_params,
                                               self.cfg.data.hop_length)
            self.vocos.load_state_dict(vocos_params)
            self.vocos.to(self.device).eval()
        self._eval_model = None
        self._plots = None   # whether matplotlib is here, at the first image

    # ------------------------------------------------------------------

    def _stamp_git_hash(self):
        """Record the source revision in the run dir."""
        try:
            h = subprocess.run(["git", "rev-parse", "HEAD"],
                               capture_output=True, text=True,
                               cwd=os.path.dirname(os.path.abspath(__file__)),
                               timeout=5).stdout.strip()
        except Exception:
            h = ""
        if h:
            path = os.path.join(self.logs_folder, "githash")
            if os.path.exists(path):
                with open(path) as f:
                    old = f.read().strip()
                if old and old != h:
                    print(f"warning: git hash changed ({old[:8]} -> {h[:8]})")
            with open(path, "w") as f:
                f.write(h)

    @property
    def model(self) -> NaturalSpeech2:
        return self.state.model

    @property
    def step(self) -> int:
        return self.state.step

    def loader(self):
        """The training batch iterator (made once, at first use)."""
        if self.dl is None:
            t = self.cfg.train
            if self.distributed:   # the model group reads one set of rows
                self.dl = synced_data_loader(
                    self.ds, self._collator, t.train_batch_size, seed=t.seed,
                    num_workers=self.num_workers,
                    shard_index=self.data_index, shard_count=self.data_size)
            else:
                self.dl = data_loader(self.ds, self._collator,
                                      t.train_batch_size, seed=t.seed,
                                      num_workers=self.num_workers)
        return self.dl

    def close(self) -> None:
        """Stop the loader's worker processes."""
        if self.dl is not None:
            self.dl.close()
            self.dl = None

    def device_batch(self, batch: dict) -> dict:
        return put_local_batch(host_transform(batch, self.cfg), self.device,
                               self.compute_dtype)

    def train_step(self, batch: dict, t: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None) -> dict:
        """One optimizer step on a device batch (as `device_batch` makes
        it), with the step's generator (or the given t and noise): through
        the step program of its key where `compiled` (`compiled_paths`),
        else eagerly. In a process group, `batch` is this rank's rows (its
        data index's) and t and noise, when given, are the global
        batch's."""
        if self.compiled:
            return self._train_step_program(batch, t, noise)
        return self._train_step_eager(batch, t, noise)

    def _train_step_eager(self, batch: dict, t: torch.Tensor | None = None,
                          noise: torch.Tensor | None = None) -> dict:
        """The step with every op dispatched from Python: what a step
        program's replay from the same state must equal."""
        drop = self._seed_generators()
        f0_factor = None
        if self.distributed:
            t, noise, f0_factor = self._global_draws(batch, t, noise)
        return self._step_fn(self.state, batch, drop, t, noise, f0_factor)

    def _seed_generators(self) -> torch.Generator:
        """Seed the step's generator at `step_seed` and, in a group at data
        index > 0, the dropout generator at `rank_seed`; the generator the
        dropout masks are drawn from."""
        seed = step_seed(self.cfg.train.seed, self.step)
        self.generator.manual_seed(seed)
        if not self.distributed or self.data_index == 0:
            return self.generator
        return self._rank_generator.manual_seed(
            rank_seed(seed, self.data_index))

    # -- the step and eval programs -----------------------------------------

    def drop_programs(self) -> None:
        """Drop the step and eval programs, their graphs and memory pool:
        the next call at each key captures anew."""
        self._step_programs.clear()
        self._eval_programs.clear()
        self._graphs.reset()

    def _check_programs(self) -> None:
        """Keep the programs only while the optimizer and the EMA tensors
        they captured are this state's (an optimizer's `load_state_dict`
        drops them through its hook)."""
        opt, ema = self.state.optimizer, self.state.ema_params
        held = self._programs_of
        if held is not None and held[0] is opt and held[1] is ema:
            return
        self.drop_programs()
        if held is None or held[0] is not opt:
            opt.register_load_state_dict_post_hook(
                lambda o: self.drop_programs()
                if o is self.state.optimizer else None)
        self._programs_of = (opt, ema)

    def _step_key(self, batch: dict, t, noise) -> _StepKey:
        unet = self.model.diff_model.unet
        return _StepKey(
            batch["spec"].shape[0], batch["spec"].shape[1],
            batch["refer"].shape[1], self.accum, self.compute_dtype,
            unet.remat, unet.remat_policy, self.cfg.f0_predictor.enabled,
            t is not None, noise is not None, *_tf32())

    def _train_step_program(self, batch: dict,
                            t: torch.Tensor | None = None,
                            noise: torch.Tensor | None = None) -> dict:
        """The step through the program of its key: the batch, t and noise
        (when given) and the step count staged into its static buffers,
        the generators seeded, then a replay; a key's first call is the
        warm-up (an eager step), then the capture. In a process group the
        body draws t, noise and the F0 scale at the global batch's shape
        (`_global_draws`) and reduces over the group, inside the graph.
        The metrics are copies. On the CPU the body runs eagerly over the
        static buffers, the work a card captures."""
        self._check_programs()
        key = self._step_key(batch, t, noise)
        prog = self._step_programs.get(key)
        if prog is None:   # static buffers, allocated outside any capture
            prog = GraphProgram(key, {
                "batch": {k: torch.empty_like(v) for k, v in batch.items()},
                "t": None if t is None else torch.empty_like(
                    t, device=self.device),
                "noise": None if noise is None else torch.empty_like(
                    noise, device=self.device),
                "step": torch.zeros((), dtype=torch.int64,
                                    device=self.device)})
        s = prog.static
        for k, v in batch.items():
            s["batch"][k].copy_(v)
        for name, v in (("t", t), ("noise", noise)):
            if v is not None:
                s[name].copy_(v)
        s["step"].fill_(self.step)
        drop = self._seed_generators()

        def body():
            t, noise, f0_factor = s["t"], s["noise"], None
            if self.distributed:
                t, noise, f0_factor = self._global_draws(s["batch"], t, noise)
            return self._step_fn.body(self.state, s["batch"], drop, t, noise,
                                      f0_factor, s["step"])
        if self.device.type != "cuda":
            out = body()
            self._step_programs[key] = prog
        elif prog.graph is None:
            try:
                out = self._graphs.capture(
                    prog, body, "step program",
                    (self.generator,) + ((drop,) if drop is not
                                         self.generator else ()))
            except RuntimeError:
                # a failed capture leaves the generators it registered in
                # capture mode: draw from new ones
                self.generator = torch.Generator(self.device)
                self._rank_generator = torch.Generator(self.device)
                raise
            # held: a graph writes these whatever .grad holds later
            prog.grads = [(p, p.grad) for p in self.model.parameters()]
            self._step_programs[key] = prog
        else:
            for p, g in prog.grads:
                if p.grad is not g:
                    p.grad = g
            out = prog.replay()
        self.state.step += 1
        return {k: v.clone() for k, v in out.items()}

    def _global_draws(self, batch: dict, t, noise):
        """This rank's rows of t, noise and (with the F0 predictor) the
        contour's scale, drawn from the step's generator at the global
        batch's shape. One process draws t and noise first too, but the
        scale after the encoders' dropout masks: with dropout 0 (no mask
        drawn) the draws are the single-process step's on the whole batch;
        with dropout > 0 the masks (per data index) and the scales differ
        from it, each still drawn from its distribution."""
        spec = batch["spec"]
        n = spec.shape[0] * self.data_size
        gen, dev = self.generator, spec.device
        if t is None:
            t = torch.randint(0, self.model.schedule.num_timesteps, (n,),
                              generator=gen, device=dev)
        if noise is None:
            noise = torch.randn((n, *spec.shape[1:]), generator=gen,
                                device=dev, dtype=spec.dtype)
        f0_factor = None
        if self.cfg.f0_predictor.enabled:
            f0_factor = 0.8 + 0.4 * torch.rand((n,), generator=gen,
                                               device=dev)
        rows = batch_sharding(self.mesh).rows(n)
        return (t[rows], noise[rows],
                None if f0_factor is None else f0_factor[rows])

    # -- checkpointing ---------------------------------------------------

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.logs_folder, "ckpt")

    def save(self, milestone: Optional[int] = None) -> str:
        """ckpt/model-N.pt: step, parameters, optimizer state, EMA and the
        config, on the CPU, as full tensors at any model axis; then only the
        newest `keep_ckpts` are kept. In a process group every rank gathers
        its model group's blocks, rank 0 writes, and every rank meets it
        here afterwards."""
        n = milestone if milestone is not None else self.step
        path = os.path.join(self.ckpt_dir, f"model-{n}.pt")
        params, opt_state, ema = self._full_state()
        if self.is_main:
            os.makedirs(self.ckpt_dir, exist_ok=True)

            def cpu(sd):
                return None if sd is None else {
                    k: v.detach().cpu() for k, v in sd.items()}
            save_trainer_checkpoint(path, self.cfg, cpu(params), self.step,
                                    opt_state, cpu(ema))
            self._collect_garbage()
        host_barrier(f"ns2vc-saved-{n}")
        return path

    def _optimizer_state(self, opt_state: dict, convert) -> dict:
        """The optimizer state dict with its AdamW moments passed through
        convert({key: tensor}, {key: Placement}), each split as its
        parameter (a copy: the live state stays as it is). The optimizer
        holds model.parameters() in order."""
        names = [n for n, _ in self.model.named_parameters()]
        pl = {(i, k): self.placements[names[i]]
              for i, st in opt_state["state"].items()
              for k, v in st.items() if v.dim()}
        out = convert({k: opt_state["state"][k[0]][k[1]] for k in pl}, pl)
        state = {i: {k: out.get((i, k), v) for k, v in st.items()}
                 for i, st in opt_state["state"].items()}
        return {**opt_state, "state": state}

    def _full_state(self):
        """(parameters, optimizer state, EMA) as full tensors: at a model
        axis over one, gathered over the model group (every rank calls
        this)."""
        params = self.model.state_dict()
        opt = self.state.optimizer.state_dict()
        ema = self.state.ema_params
        if self.mesh.shape["model"] == 1:
            return params, opt, ema

        def gather(sd, pl):
            return gather_state(sd, pl, self.mesh)
        return (gather(params, self.placements),
                self._optimizer_state(opt, gather),
                None if ema is None else gather(ema, self.placements))

    def _collect_garbage(self) -> None:
        keep = self.cfg.train.keep_ckpts
        if keep <= 0:
            return
        found = []
        for name in os.listdir(self.ckpt_dir):
            if name.startswith("model-") and name.endswith(".pt"):
                try:
                    found.append((int(name[6:-3]), name))
                except ValueError:
                    continue
        for _, name in sorted(found)[:-keep]:
            os.remove(os.path.join(self.ckpt_dir, name))

    def load(self, step: Optional[int] = None, path: Optional[str] = None):
        """Resume from a checkpoint of this trainer: `path`, else
        ckpt/model-`step`.pt, else the newest in ckpt/. Restores the
        parameters, optimizer state (a fresh AdamW where the file holds
        none; a capturable AdamW's file loads into an eager one and back),
        EMA (when this run keeps one) and step; the step and eval programs
        are captured anew. Every rank of a
        process group reads it, keeps its blocks of the full tensors, and
        none goes on (to a save whose garbage collection could remove it)
        until all have."""
        from ns2vc_tpu_torch.utils.checkpoints import latest_checkpoint_path

        if path is None:
            path = (os.path.join(self.ckpt_dir, f"model-{step}.pt")
                    if step is not None
                    else latest_checkpoint_path(self.ckpt_dir))
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint to resume from in "
                                    f"{self.ckpt_dir}")
        data = torch.load(path, map_location="cpu")
        if data.get("format") != TRAINER_FORMAT:
            raise ValueError(f"{path} is not a checkpoint of this trainer; "
                             f"use load_torch for a reference model-N.pt")
        self.model.load_state_dict(self._local(data["params"]))
        if data["opt_state"] is not None:
            opt = self._optimizer_state(
                data["opt_state"],
                lambda sd, pl: shard_state(sd, pl, self.mesh))
            # the file's AdamW may have been capturable or not: this one
            # stays as it is (and its step count where that puts it)
            opt["param_groups"] = [
                {**g, "capturable": live["capturable"]} for g, live in zip(
                    opt["param_groups"], self.state.optimizer.param_groups)]
            self.state.optimizer.load_state_dict(opt)
        if self.state.ema_params is not None:
            src = self._local(data["ema_params"] or data["params"])
            for k, v in self.state.ema_params.items():
                v.copy_(src[k])
        self.state.step = int(data["step"])
        host_barrier(f"ns2vc-loaded-{self.state.step}")
        return path

    def load_torch(self, model_path: str):
        """Warm start from a reference `model-N.pt` (through the port's
        reference converter): parameters and step; the optimizer starts
        fresh and the EMA, when kept, from the loaded parameters."""
        from ns2vc_tpu_torch.convert import load_checkpoint

        data = torch.load(model_path, map_location="cpu")
        if "model" not in data:
            raise ValueError(f"{model_path} is not a reference model-N.pt")
        self.model.load_state_dict(self._local(load_checkpoint(model_path,
                                                               self.cfg)))
        if self.state.ema_params is not None:
            self.state.ema_params = init_ema(self.model)
        self.state.step = int(data.get("step", 0))

    def _local(self, full: dict) -> dict:
        """This rank's blocks of a full state dict."""
        return shard_state(full, self.placements, self.mesh)

    # -- eval sampling -----------------------------------------------------

    def sample_eval(self, generator: torch.Generator | None = None):
        """Sample one eval item (reference model.py:905-938) with UniPC, 30
        steps, from the EMA parameters when kept: (mel (T, 100), waveform or
        None, gt spec, refer spec, gt audio, refer audio), numpy; None
        without an eval set, and on every rank but 0. Through the eval
        program of the item's buckets where `eval_compiled`
        (`compiled_paths`: on a card at a model axis of one), else eagerly.
        The ranks of data index 0 sample together (the model split over
        their model group, `generator` seeded alike on each; rank 0 alone
        at mp = 1, with no collective); the others go on to the next
        step's all-reduce and wait there."""
        if self.eval_ds is None or self.data_index != 0:
            return None
        c, f0, spec, audio, uv, c_r, f0_r, spec_r, audio_r, uv_r = \
            self.eval_ds[self.step % len(self.eval_ds)]
        t_len, tr_len = c.shape[0], spec_r.shape[0]
        t_pad = max(64, -(-t_len // 64) * 64)
        tr_pad = max(64, -(-tr_len // 64) * 64)
        c_in = np.zeros((1, t_pad, c.shape[1]), np.float32)
        c_in[0, :t_len] = c
        refer_in = np.zeros((1, tr_pad, spec_r.shape[1]), np.float32)
        refer_in[0, :tr_len] = spec_r
        f0_in = uv_in = None
        if self.cfg.f0_predictor.enabled:
            f0_in = np.zeros((1, t_pad), np.float32)
            uv_in = np.zeros((1, t_pad), np.float32)
            m = min(t_len, np.size(f0))
            f0_in[0, :m] = np.reshape(f0, (-1,))[:m]
            uv_in[0, :m] = np.reshape(uv, (-1,))[:m]
        if self._eval_model is None:
            self._eval_model = shard_parameters(
                NaturalSpeech2(self.cfg), self.placements, self.mesh).to(
                self.device, self.compute_dtype).eval()
        run = self._eval_program if self.eval_compiled else self._eval_eager
        mel, wav = run(c_in, refer_in, t_len, tr_len, f0_in, uv_in, generator)
        if not self.is_main:
            return None
        if wav is not None:
            wav = wav[0, : t_len * self.cfg.data.hop_length].float().cpu(
                ).numpy()
        return (mel[0, :t_len].cpu().numpy(), wav, spec, spec_r, audio,
                audio_r)

    def _eval_eager(self, c_in, refer_in, t_len, tr_len, f0_in, uv_in,
                    generator):
        """sample_eval's device work dispatched from Python: the EMA (or the
        parameters) loaded into the eval model, generate_mel (x_T drawn
        from `generator`), and Vocos on rank 0 -> (mel, waveform or
        None), padded."""
        dev = self.device
        self._eval_model.load_state_dict(
            self.state.ema_params if self.state.ema_params is not None
            else self.model.state_dict())

        def up(a):
            return None if a is None else torch.from_numpy(a).to(dev)
        mel = generate_mel(
            self._eval_model, up(c_in), up(refer_in),
            torch.tensor([t_len], device=dev),
            torch.tensor([tr_len], device=dev),
            generator=generator, method="unipc", steps=30, f0=up(f0_in),
            uv=up(uv_in))
        wav = None
        if self.vocos is not None and self.is_main:
            with torch.no_grad():
                wav = self.vocos(mel)
        return mel, wav

    def _eval_program(self, c_in, refer_in, t_len, tr_len, f0_in, uv_in,
                      generator):
        """sample_eval's device work through the eval program of its key:
        the inputs staged into its static buffers, x_T drawn from
        `generator` as generate_mel draws it, then a replay (a key's first
        call: the warm-up, then the capture). On the CPU the body runs
        eagerly over the static buffers."""
        self._check_programs()
        key = _EvalKey(c_in.shape[1], refer_in.shape[1], f0_in is not None,
                       *_tf32())
        prog = self._eval_programs.get(key)
        if prog is None:   # static buffers, allocated outside any capture

            def empty(*shape, dtype=torch.float32):
                return torch.empty(shape, dtype=dtype, device=self.device)
            f0 = None if f0_in is None else empty(1, key.t_pad)
            prog = GraphProgram(key, {
                "c": empty(*c_in.shape), "refer": empty(*refer_in.shape),
                "lengths": empty(1, dtype=torch.int64),
                "refer_lengths": empty(1, dtype=torch.int64),
                "f0": f0, "uv": None if f0 is None else empty(1, key.t_pad),
                "x_T": empty(1, key.t_pad,
                             self.cfg.diffusion_encoder.out_channels,
                             dtype=self.compute_dtype)})
        s = prog.static
        for name, arr in (("c", c_in), ("refer", refer_in),
                          ("lengths", np.array([t_len], np.int64)),
                          ("refer_lengths", np.array([tr_len], np.int64)),
                          ("f0", f0_in), ("uv", uv_in)):
            if arr is not None:
                s[name].copy_(torch.from_numpy(arr))
        s["x_T"].normal_(generator=generator)

        @torch.no_grad()
        def body():
            src = self.state.ema_params
            if src is None:
                src = dict(self.model.named_parameters())
            for name, p in self._eval_model.named_parameters():
                p.copy_(src[name])
            mel = generate_mel(
                self._eval_model, s["c"], s["refer"], s["lengths"],
                s["refer_lengths"], x_T=s["x_T"], method="unipc", steps=30,
                f0=s["f0"], uv=s["uv"])
            return mel, None if self.vocos is None else self.vocos(mel)
        if self.device.type != "cuda":
            self._eval_programs[key] = prog
            return body()
        if prog.graph is None:
            out = self._graphs.capture(prog, body, "eval program")
            self._eval_programs[key] = prog
            return out
        return prog.replay()

    def _write_eval(self, result, step: int) -> dict:
        from ns2vc_tpu_torch.utils.wavio import write_wav

        mel, wav, gt_spec, refer_spec, gt_audio, refer_audio = result
        out_dir = os.path.join(self.logs_folder, "eval")
        os.makedirs(out_dir, exist_ok=True)
        files = {}
        for name, arr in (("gen_mel", mel), ("gt_mel", gt_spec)):
            files[name] = os.path.join(out_dir, f"{name}-{step}.npy")
            np.save(files[name], np.asarray(arr))
        sr = self.cfg.data.sampling_rate
        for name, arr in (("gt_audio", gt_audio),
                          ("refer_audio", refer_audio), ("gen_audio", wav)):
            if arr is not None and np.size(arr):
                files[name] = os.path.join(out_dir, f"{name}-{step}.wav")
                write_wav(files[name], np.reshape(arr, (-1,)), sr)
        if wav is not None:
            milestone = step // self.cfg.train.save_and_sample_every
            write_wav(os.path.join(self.logs_folder,
                                   f"sample-{milestone}.wav"), wav, sr)
        files.update(self._images(step, {"gen/mel": mel, "gt/mel": gt_spec}))
        return files

    def _images(self, step: int, specs: dict) -> dict:
        """images/<tag>-<step>.png of each (T, C) spectrogram in `specs`
        ({tag: array}), as the JAX trainer's TensorBoard images; {} without
        matplotlib."""
        if not self._can_plot():
            return {}
        from ns2vc_tpu_torch.utils.plotting import (
            plot_spectrogram_to_numpy, write_png,
        )

        out_dir = os.path.join(self.logs_folder, "images")
        os.makedirs(out_dir, exist_ok=True)
        return {tag: write_png(
            os.path.join(out_dir, f"{tag.replace('/', '_')}-{step}.png"),
            plot_spectrogram_to_numpy(np.asarray(spec, np.float32).T))
            for tag, spec in specs.items()}

    def _can_plot(self) -> bool:
        """Whether matplotlib is here; without it, said once on stdout
        and in train.log."""
        if self._plots is None:
            self._plots = importlib.util.find_spec("matplotlib") is not None
            if not self._plots:
                from ns2vc_tpu_torch.utils.logger import get_logger

                msg = ("matplotlib is not installed: the trainer writes no "
                       "spectrogram images")
                print(msg, flush=True)
                get_logger(self.logs_folder).info(msg)
        return self._plots

    # -- main loop ---------------------------------------------------------

    def _log(self, record: dict) -> None:
        with open(os.path.join(self.logs_folder, "scalars.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def train(self, num_steps: Optional[int] = None):
        from ns2vc_tpu_torch.utils.logger import get_logger

        t = self.cfg.train
        total = num_steps if num_steps is not None else t.train_num_steps
        logger = get_logger(self.logs_folder) if self.is_main else None
        eval_gen = torch.Generator(self.device)
        loader = self.loader()
        batches = deque(self.device_batch(next(loader))
                        for _ in range(max(1, t.prefetch_depth)))
        t0 = time.time()
        while self.step < total:
            batches.append(self.device_batch(next(loader)))
            batch = batches.popleft()
            metrics = self.train_step(batch)
            step = self.step
            if step % t.log_every == 0 and self.is_main:
                loss = float(metrics["loss"])
                diff, lf0 = (float(metrics[k]) for k in ("loss_diff",
                                                         "loss_f0"))
                gn = float(metrics["grad_norm"])
                sps = t.log_every / max(time.time() - t0, 1e-9)
                t0 = time.time()
                print(f"step {step} loss {loss:.4f} grad_norm {gn:.3f} "
                      f"steps/s {sps:.2f}"
                      + (f" loss_f0 {lf0:.4f}"
                         if self.cfg.f0_predictor.enabled else ""),
                      flush=True)
                logger.info(f"Losses: [{diff}, {lf0}], step: {step}")
                self._log({"step": step, "loss/diff": diff, "loss/f0": lf0,
                           "loss/all": loss,
                           "loss/grad": gn, "perf/steps_per_sec": sps,
                           "perf/content_frames": int(batch["c"].shape[1]),
                           "perf/refer_frames": int(batch["refer"].shape[1])})
                if "pred" in metrics:   # this rank's first example
                    self._images(step, {
                        "all/spec": metrics["target"][0].detach().cpu(),
                        "all/spec_pred": metrics["pred"][0].detach().cpu()})
            if step != 0 and step % t.save_and_sample_every == 0:
                eval_gen.manual_seed(step_seed(t.seed + 1, step))
                result = self.sample_eval(eval_gen)
                if result is not None:
                    self._log({"step": step,
                               **self._write_eval(result, step)})
                self.save()
        # a final checkpoint, so a short or interrupted run is never lost
        self.save()
        print("training complete", flush=True)
