"""Process group, mesh and sharding rules over torch.distributed
(counterpart of ns2vc_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'model') mesh over its devices, annotates
the batch and the parameters, and lets GSPMD place the collectives. The
port runs one process per card: the 'data' axis is the process group, rank
r holds rows [r * B, (r + 1) * B) of the global batch (the layout of
`jax.make_array_from_process_local_data`), and the trainer averages the
gradients with one all-reduce per step (`all_reduce_mean`), which is the
collective GSPMD inserts for the JAX step.

The 'model' axis is described (`make_mesh`, `param_shardings`, with the
JAX package's rule) but not applied: placing parameters over it waits for
a later slice (ROADMAP Queue 1), and the trainer refuses
`model_parallel_size > 1`.

The cluster is set up from the environment, with the JAX package's names:
- NS2VC_COORDINATOR=host:port with NS2VC_NUM_PROCESSES and
  NS2VC_PROCESS_ID: an explicit cluster (`tcp://host:port`);
- NS2VC_DISTRIBUTED=1: the launcher's environment (`env://`: torchrun's
  MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK).
The backend is NCCL for a card and gloo for the CPU, unless the caller
names one (gloo on a card reduces through host copies).

Not ported: the packed host-to-device batch (`make_batch_packer`,
`unpack_batch`, the JAX trainer's `pack_h2d`), and the barrier the JAX
trainer holds around a freshly compiled step (its gloo transport gives a
communicator ~30 s to come up while another host still compiles): an
eager torch step compiles nothing, so no rank waits on another's compile.
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
    without one. On a card, each process takes `cuda:{LOCAL_RANK}`, else
    `cuda:{process id mod device count}`, as its current device."""
    if dist.is_initialized():
        return True
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
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
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


def _collective(flat: torch.Tensor, op) -> None:
    """Run `op` on `flat` in place; under gloo a card's buffer goes
    through a host copy (gloo reduces host memory)."""
    if flat.is_cuda and dist.get_backend() == "gloo":
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


def all_reduce_mean(flat: torch.Tensor) -> None:
    """Average a flat f32 buffer over the process group in place: one
    all-reduce (sum), divided by the world size; every rank ends with the
    same bits. Adds one to `all_reduce_mean.calls` and the buffer's bytes
    to `all_reduce_mean.bytes` per call."""
    n = dist.get_world_size()
    _collective(flat, lambda buf: dist.all_reduce(buf, op=dist.ReduceOp.SUM))
    flat.div_(n)
    all_reduce_mean.calls += 1
    all_reduce_mean.bytes += flat.numel() * flat.element_size()


all_reduce_mean.calls = 0
all_reduce_mean.bytes = 0


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
