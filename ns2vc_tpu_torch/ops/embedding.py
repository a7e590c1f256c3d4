"""An embedding lookup whose backward sums in a fixed order.

`nn.Embedding`'s backward on a card (`embedding_dense_backward`) adds the
rows of repeated indices with atomics, in an order that changes from run
to run, so two training steps from one state give two gradients of the F0
embedding. `embedding_lookup(idx, weight)` gathers the same rows (the
forward is `F.embedding`'s), and its backward is one one-hot product:

    dweight = onehot(idx)^T @ dy,    onehot (N, num_embeddings) f32

a cuBLAS GEMM in f32 with TF32 off (on the card; the CPU's on the CPU),
which sums each bin's rows in an order fixed by the shapes alone, whatever
the data. The one-hot matrix's 0s and 1s make every product exact, so each
bin's gradient is the f32 sum of its rows. The parameter stays the
`nn.Embedding`'s weight: state dicts and checkpoints do not change.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _full_f32_matmul():
    """cuBLAS's f32 GEMMs in f32 (TF32 off) inside, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def embedding_backward(idx: torch.Tensor, dy: torch.Tensor,
                       num_embeddings: int) -> torch.Tensor:
    """(num_embeddings, D) f32: the sum of dy's rows (..., D) per index of
    idx (...,), as one one-hot GEMM."""
    onehot = (idx.reshape(-1, 1) == torch.arange(
        num_embeddings, device=idx.device)).to(torch.float32)
    with _full_f32_matmul():
        return onehot.t() @ dy.reshape(-1, dy.shape[-1]).to(torch.float32)


class _EmbeddingFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, idx, weight):
        ctx.save_for_backward(idx)
        ctx.num, ctx.dtype = weight.shape[0], weight.dtype
        return F.embedding(idx, weight)

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        return None, embedding_backward(idx, dy, ctx.num).to(ctx.dtype)


def embedding_lookup(idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """weight[idx] (idx integer (...,), weight (num, D)) -> (..., D), with
    a backward that is the same on every run (`embedding_backward`)."""
    return _EmbeddingFn.apply(idx, weight)
