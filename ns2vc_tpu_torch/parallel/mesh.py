"""Process group, mesh and sharding rules over torch.distributed
(counterpart of ns2vc_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'model') mesh over its devices, annotates
the batch and the parameters, and lets GSPMD place the collectives. The
port runs one process per card: the 'data' axis is the process group, rank
r holds rows [r * B, (r + 1) * B) of the global batch (the layout of
`jax.make_array_from_process_local_data`), and the trainer averages the
gradients with one all-reduce per step (`all_reduce_mean`), which is the
collective GSPMD inserts for the JAX step.

The 'model' axis splits parameters column-parallel, where the JAX
package's rule (`param_shardings`) says: rank r sits at data index
r // mp and model index r % mp; the ranks of one data index form its model
group, the ranks of one model index its data group (`mesh_groups`).
`shard_parameters` leaves each rank its block of every split parameter and
puts the column-parallel layers of `parallel/tensor.py` in their modules'
places; `gather_parameters` / `gather_state` give the full tensors back
(one all-gather over the model group), `shard_state` takes a rank's blocks
of a full state dict. Where GSPMD places the collectives for the JAX
program, the port gathers each split layer's output features.

The cluster is set up from the environment, with the JAX package's names:
- NS2VC_COORDINATOR=host:port with NS2VC_NUM_PROCESSES and
  NS2VC_PROCESS_ID: an explicit cluster (`tcp://host:port`);
- NS2VC_DISTRIBUTED=1: the launcher's environment (`env://`: torchrun's
  MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK).
The backend is NCCL for a card and gloo for the CPU, unless the caller
names one (gloo on a card reduces through host copies).

The collectives count their calls and bytes (`counters()`). Under NCCL
the Trainer captures its step, collectives included, as a CUDA graph
(`train/trainer.py`), and a replay runs no Python: `launch_counts` and
`add_launch_counts` let the graph's owner take a capture's counts off and
add them back per replay, as it does with the kernels' launches
(`utils/graphs.py`).

Not ported: the packed host-to-device batch (`make_batch_packer`,
`unpack_batch`, the JAX trainer's `pack_h2d`), and the barrier the JAX
trainer holds around a freshly compiled step (its gloo transport gives a
communicator ~30 s to come up while another host still compiles). A step
key's first call here is an eager step, whose collectives bring up every
communicator the capture uses and meet every rank, then a capture, which
communicates nothing and takes seconds against NCCL's timeout of minutes;
every rank captures the same keys in the same order (the synced loader
gives them one geometry per step).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def maybe_initialize_distributed(device: str | torch.device | None = None,
                                 backend: str | None = None) -> bool:
    """Join the process group the environment describes (module
    docstring); True when a group is up (also when it was already), False
    without one. `device` defaults to "cuda", which raises without a card
    (pass "cpu" for a gloo group on the CPU). On a card, each process takes
    `cuda:{LOCAL_RANK}`, else `cuda:{process id mod device count}`, as its
    current device."""
    if dist.is_initialized():
        return True
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is "
                           f"available; pass device='cpu' for a gloo group "
                           f"on the CPU")
    coord = os.environ.get("NS2VC_COORDINATOR")
    if coord:
        init = f"tcp://{coord}"
        rank = int(os.environ["NS2VC_PROCESS_ID"])
        size = int(os.environ["NS2VC_NUM_PROCESSES"])
    elif os.environ.get("NS2VC_DISTRIBUTED") == "1":
        init = "env://"
        rank = int(os.environ["RANK"])
        size = int(os.environ["WORLD_SIZE"])
    else:
        return False
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
        torch.cuda.set_device(index)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=size)
    return True


def world() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ('data', 'model') layout of the processes: `shape` maps each
    axis to its size, as `jax.sharding.Mesh.shape` does; rank r sits at
    data index r // model size, model index r % model size."""
    shape: dict
    axis_names: tuple
    rank: int = 0

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        inner = math.prod(self.shape[a] for a in
                          self.axis_names[self.axis_names.index(axis) + 1:])
        return self.rank // inner % self.shape[axis]


def make_mesh(model_parallel_size: int = 1, world_size: int | None = None,
              data_axis: str = "data", model_axis: str = "model") -> Mesh:
    """The mesh over the process group (one process of one card without a
    group); `world_size` lays it over that many processes instead."""
    rank, n = world()
    n = world_size if world_size is not None else n
    if n % model_parallel_size:
        raise ValueError(f"{n} processes do not split into a model axis of "
                         f"{model_parallel_size}")
    return Mesh({data_axis: n // model_parallel_size,
                 model_axis: model_parallel_size},
                (data_axis, model_axis), rank)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The data axis's layout of a global batch: data index i of n holds
    its contiguous rows [i * B / n, (i + 1) * B / n)."""
    index: int
    count: int

    def rows(self, global_batch: int) -> slice:
        if global_batch % self.count:
            raise ValueError(f"a global batch of {global_batch} does not "
                             f"split over {self.count} data ranks")
        b = global_batch // self.count
        return slice(self.index * b, (self.index + 1) * b)


def batch_sharding(mesh: Mesh, data_axis: str = "data") -> BatchSharding:
    """Shard the leading batch axis over the data axis, replicate the
    rest."""
    return BatchSharding(mesh.index(data_axis), mesh.shape[data_axis])


def shard_batch(batch, mesh: Mesh, data_axis: str = "data"):
    """This rank's rows of a global batch: a dict of arrays or tensors
    (each leading axis the global batch), or one of them."""
    sharding = batch_sharding(mesh, data_axis)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, data_axis) for k, v in batch.items()}
    return batch[sharding.rows(len(batch))]


def put_local_batch(local: dict, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> dict:
    """This rank's batch (numpy) onto its device: pinned, non-blocking
    copies from the host on a card, floats cast to `dtype` there. Each
    rank's loader yields its own rows of the global batch, so no rank
    holds another's."""
    out = {}
    for k, v in local.items():
        x = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        if x.is_floating_point():
            x = x.to(dtype)
        out[k] = x
    return out


def host_barrier(name: str, timeout_ms: int = 3_600_000) -> None:
    """Every rank waits here for the others (gloo: a monitored barrier,
    which names a rank that does not arrive within `timeout_ms`). A no-op
    in one process."""
    rank, n = world()
    if n == 1:
        return
    if dist.get_backend() == "gloo":
        try:
            dist.monitored_barrier(
                timeout=datetime.timedelta(milliseconds=timeout_ms))
        except RuntimeError as e:
            raise RuntimeError(f"host_barrier {name!r}: {e}") from e
    else:
        dist.barrier(device_ids=[torch.cuda.current_device()])


def _collective(flat: torch.Tensor, op, group=None) -> None:
    """Run `op` on `flat` in place; under gloo a card's buffer goes
    through a host copy (gloo reduces host memory)."""
    if flat.is_cuda and dist.get_backend(group) == "gloo":
        host = flat.cpu()
        op(host)
        flat.copy_(host)
    else:
        op(flat)


def flat_gradients(params: list, flat: torch.Tensor | None = None,
                   extra: int = 0) -> torch.Tensor:
    """One f32 buffer behind the gradients of `params`: each `p.grad` a
    view of it, in order, then `extra` slots of its own. `flat` is reused
    when given and of the right size, and a parameter whose gradient is
    not its view (set to None by another step) is bound again. Backward
    accumulates into existing gradients in place, so the step zeroes the
    buffer, runs backward and reduces the buffer with one call, with no
    gathering or copying back."""
    n = sum(p.numel() for p in params) + extra
    if flat is None or flat.numel() != n:
        flat = torch.zeros(n, dtype=torch.float32, device=params[0].device)
    offset = 0
    for p in params:
        view = flat[offset:offset + p.numel()].view_as(p)
        if p.grad is None or p.grad.data_ptr() != view.data_ptr():
            p.grad = view
        offset += p.numel()
    return flat


def all_reduce_mean(flat: torch.Tensor, group=None) -> None:
    """Average a flat f32 buffer over `group` (the whole process group by
    default) in place: one all-reduce (sum), divided by the group's size;
    every rank ends with the same bits. Adds one to `all_reduce_mean.calls`
    and the buffer's bytes to `all_reduce_mean.bytes` per call."""
    n = dist.get_world_size(group)
    _collective(flat, lambda buf: dist.all_reduce(
        buf, op=dist.ReduceOp.SUM, group=group), group)
    flat.div_(n)
    all_reduce_mean.calls += 1
    all_reduce_mean.bytes += flat.numel() * flat.element_size()


all_reduce_mean.calls = 0
all_reduce_mean.bytes = 0


def all_reduce_sum(x: torch.Tensor, group) -> None:
    """Sum a contiguous tensor over `group` in place (`all_reduce_sum.calls`
    and `.bytes` count each call and its buffer)."""
    _collective(x, lambda buf: dist.all_reduce(
        buf, op=dist.ReduceOp.SUM, group=group), group)
    all_reduce_sum.calls += 1
    all_reduce_sum.bytes += x.numel() * x.element_size()


all_reduce_sum.calls = 0
all_reduce_sum.bytes = 0


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's `x` (one shape on all), in the group's rank order, on
    x's device (`all_gather.calls` and `.bytes`, the gathered bytes, count
    each call). Under gloo a card's tensor goes through a host copy."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = x.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        parts = [p.to(x.device) for p in parts]
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
    all_gather.calls += 1
    all_gather.bytes += n * x.numel() * x.element_size()
    return parts


all_gather.calls = 0
all_gather.bytes = 0


_COUNTED = (all_reduce_mean, all_reduce_sum, all_gather)


def reset_counters() -> None:
    """Zero the collectives' counters."""
    for fn in _COUNTED:
        fn.calls = fn.bytes = 0


def counters() -> dict:
    """{collective: {"calls": n, "bytes": n}} so far."""
    return {fn.__name__: {"calls": fn.calls, "bytes": fn.bytes}
            for fn in _COUNTED}


def launch_counts() -> dict[str, int]:
    """The collectives' counters, flat (a CUDA graph's owner takes them
    before and after its capture, as it takes the kernels' launch
    counts)."""
    return {f"{fn.__name__}.{k}": getattr(fn, k) for fn in _COUNTED
            for k in ("calls", "bytes")}


def add_launch_counts(delta: dict[str, int], times: int = 1) -> None:
    """Add `times` x `delta` (a difference of two `launch_counts()`): a
    replay runs its capture's collectives."""
    for fn in _COUNTED:
        for k in ("calls", "bytes"):
            setattr(fn, k, getattr(fn, k)
                    + times * delta[f"{fn.__name__}.{k}"])


def broadcast_(tensors: list, src: int = 0) -> None:
    """Overwrite `tensors` with rank `src`'s, in one broadcast."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _collective(flat, lambda buf: dist.broadcast(buf, src))
    with torch.no_grad():
        torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(
            flat.split([t.numel() for t in tensors]), tensors)])


# the JAX package's tensor-sharding rule: column-parallel on any kernel
# whose output-features axis is wide and divides by the model axis
_MIN_SHARD_FEATURES = 256


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a parameter lives on the mesh: replicated (`axis` None), or
    split over `axis` along `dim`, where `dim` stacks `blocks` equal blocks
    (a fused q/k/v projection) and each block is split alike."""
    axis: str | None = None
    dim: int = 0
    blocks: int = 1


REPLICATED = Placement()


def _output_features(name: str, module: nn.Module, pname: str):
    """(dim, blocks) of a parameter that holds a flax kernel, the torch
    axis of the kernel's output features (flax's last axis), else None.
    NaturalSpeech2's kernels are Linear and Conv1d weights; its fused q/k/v
    projections stack three kernels."""
    if isinstance(module, (nn.Linear, nn.Conv1d)) and pname == "weight":
        fused = name.endswith("to_qkv") or name.endswith("in_proj")
        return 0, 3 if fused else 1
    return None


def _placement(out, shape, model_size: int, model_axis: str) -> Placement:
    if model_size <= 1 or out is None:
        return REPLICATED
    dim, blocks = out
    features = shape[dim] // blocks
    if features % model_size == 0 and features >= _MIN_SHARD_FEATURES:
        return Placement(model_axis, dim, blocks)
    return REPLICATED


def param_shardings(model: nn.Module, mesh: Mesh,
                    model_axis: str = "model") -> dict:
    """{parameter name: Placement}: replicated by default; wide kernels
    split column-parallel over the model axis when it has more than one
    rank (the JAX package's `_spec_for`)."""
    model_size = mesh.shape.get(model_axis, 1)
    out = {}
    for name, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            key = f"{name}.{pname}" if name else pname
            out[key] = _placement(_output_features(name, module, pname),
                                  tuple(p.shape), model_size, model_axis)
    return out


# -- the model axis -------------------------------------------------------------

_GROUPS: dict = {}   # (data size, model size) -> every rank's groups


def mesh_groups(mesh: Mesh) -> tuple:
    """(model group, data group) of this rank: the torch.distributed
    groups of the ranks that share its data index and of those that share
    its model index. Every rank of the process group makes every group, in
    one order, the first time any of them asks for a mesh of this shape
    (torch makes a group collectively). (None, None) without a process
    group, and at a model axis of one, where no model group is needed and
    the data group is the whole process group (torch's default, None)."""
    dp, mp = (mesh.shape[a] for a in mesh.axis_names)
    if mp == 1 or not (dist.is_available() and dist.is_initialized()):
        return None, None
    if dp * mp != dist.get_world_size():
        raise ValueError(f"a {dp} x {mp} mesh over "
                         f"{dist.get_world_size()} processes")
    if (dp, mp) not in _GROUPS:
        model = [dist.new_group([d * mp + m for m in range(mp)])
                 for d in range(dp)]
        data = [dist.new_group([d * mp + m for d in range(dp)])
                for m in range(mp)]
        _GROUPS[dp, mp] = (model, data)
    model, data = _GROUPS[dp, mp]
    return (model[mesh.index(mesh.axis_names[0])],
            data[mesh.index(mesh.axis_names[1])])


def _blocks(t: torch.Tensor, placement: Placement) -> torch.Tensor:
    """t with the placement's dim moved first and split into its blocks:
    (blocks, features per block, ...)."""
    x = t.movedim(placement.dim, 0)
    return x.reshape(placement.blocks, x.shape[0] // placement.blocks,
                     *x.shape[1:])


def shard_tensor(full: torch.Tensor, placement: Placement, index: int,
                 size: int) -> torch.Tensor:
    """Model rank `index`'s block (of `size`) of a full tensor: itself
    when replicated, else its slice of each block along the dim."""
    if placement.axis is None:
        return full
    x = _blocks(full, placement)
    per = x.shape[1] // size
    x = x[:, index * per:(index + 1) * per]
    return x.reshape(-1, *x.shape[2:]).movedim(0, placement.dim).contiguous()


def unshard_tensor(parts: list, placement: Placement) -> torch.Tensor:
    """The full tensor from every model rank's block, in rank order (the
    inverse of `shard_tensor`)."""
    if placement.axis is None:
        return parts[0]
    x = torch.stack([_blocks(p, placement) for p in parts], dim=1)
    return x.reshape(-1, *x.shape[3:]).movedim(0, placement.dim).contiguous()


def shard_state(state: dict, placements: dict, mesh: Mesh,
                model_axis: str = "model") -> dict:
    """This rank's blocks of a full {name: tensor} dict (names that
    `placements` does not hold stay as they are)."""
    index, size = mesh.index(model_axis), mesh.shape[model_axis]
    return {k: shard_tensor(v, placements.get(k, REPLICATED), index, size)
            for k, v in state.items()}


def gather_state(state: dict, placements: dict, mesh: Mesh,
                 model_axis: str = "model") -> dict:
    """The full tensors of this rank's {name: block} dict: the split ones
    in one all-gather of their concatenation over the model group, which
    every rank of the group calls alike; the replicated ones as they
    are."""
    split = [k for k in state
             if placements.get(k, REPLICATED).axis is not None]
    out = dict(state)
    if not split or mesh.shape[model_axis] == 1:
        return out
    group, _ = mesh_groups(mesh)
    flat = torch.cat([state[k].detach().reshape(-1) for k in split])
    parts = all_gather(flat, group)
    sizes = [state[k].numel() for k in split]
    for i, k in enumerate(split):
        blocks = [p.split(sizes)[i].view_as(state[k]) for p in parts]
        out[k] = unshard_tensor(blocks, placements[k])
    return out


def shard_parameters(model: nn.Module, placements: dict, mesh: Mesh,
                     model_axis: str = "model") -> nn.Module:
    """Split `model` over the mesh's model axis, in place: every parameter
    whose placement is on `model_axis` becomes this rank's block of it
    (each block of a fused parameter split alike), and its layer computes
    this rank's output features and gathers them over the model group
    (`parallel/tensor.py`). Every rank of the group holds the same full
    parameters before the call. A no-op at a model axis of one."""
    from ns2vc_tpu_torch.parallel.tensor import split_layer

    size = mesh.shape[model_axis]
    if size == 1:
        return model
    group, _ = mesh_groups(mesh)
    for name, pl in placements.items():
        if pl.axis == model_axis:
            owner, _, attr = name.rpartition(".")
            split_layer(model, owner, attr, pl, group, mesh.index(model_axis),
                        size)
    return model


def gather_parameters(model: nn.Module, placements: dict, mesh: Mesh,
                      model_axis: str = "model") -> dict:
    """{name: full tensor} of a model split by `shard_parameters` (every
    rank of the model group calls it)."""
    return gather_state({k: p.detach() for k, p in model.named_parameters()},
                        placements, mesh, model_axis)
