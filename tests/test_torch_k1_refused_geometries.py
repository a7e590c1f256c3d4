"""K1's backward at every geometry its forward takes, and the plans of the
redesigned single-query backward and GroupNorm statistics kernels, on the
CPU.

The kernels run only on a card (tests/test_torch_cuda.py holds them there
against their plain versions). Here:
  - `grad_plan`, the backward's pure route decision: rows that are not
    whole aligned 16-byte chunks (bf16 D = 100, a packed head view one
    element longer per row) take the tile kernels on zero-padded
    contiguous copies ("tc_pad" / "f32tc_pad"), f32 heads wider than 64
    the f32 kernels' 128-wide instantiation ("f32tc_d128"), none raises;
    the wrapper launches those entries at the padded head dim and returns
    the gradients sliced back, counted per sub-route;
  - the zero-pad identity: the plain backward on padded copies, sliced
    back, is the backward: it equals JAX's gradient (`jax.vjp`) of
    ns2vc_tpu/ops/attention.py::scaled_dot_product_attention, the XLA
    attention the Pallas kernel ns2vc_tpu/ops/pallas_attention.py::
    flash_attention is held to by its own suite (the Pallas kernel is
    forward-only: JAX differentiates the XLA attention), at those
    geometries, within the f32 kernel tolerance (2e-5 of max |reference|
    per gradient), and the padded columns' gradients are exactly zero;
  - `plan_q1_backward` at the pools of a training step and of the f32
    gradient checks: at most 8 splits, no empty share, shared memory within
    a block's, and at B = 32 a grid that fills the H100's SMs in one wave;
  - `gn_threads` (the statistics block) at every serving, B = 1 and
    training geometry: whole warps, at most 512 threads, one round of
    loads, two vectors a thread where 512 threads hold the slab so;
  - a numpy f32 emulation of the statistics kernel's merge order (each
    thread's values about their own mean, Chan's merges in fixed xor trees
    over lanes, warps and the cluster's blocks) against f64, within 2e-5,
    on slabs with a large common offset, where the uncentred E[x^2] -
    E[x]^2 in f32 misses by far.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ns2vc_tpu_torch.ops.flash_attention as fa
from ns2vc_tpu.ops.attention import scaled_dot_product_attention
from ns2vc_tpu_torch.ops import _build
from ns2vc_tpu_torch.ops.flash_attention import (
    MAX_SMEM, Q1_MAX_SPLITS, flash_attention_backward, grad_plan, grad_route,
    plan_q1_backward, q1_backward_smem, q1_vec_bytes,
)
from ns2vc_tpu_torch.ops.fused_resnet import (
    GN_LOADS, GN_THREADS, gn_splits, gn_threads,
)

from test_torch_kernels import card_routes  # noqa: F401 (a fixture)

RTOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread runs them fastest, and several
    test workers share the host."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _heads(b, t, h, d, dtype, extra=0):
    """(B, H, T, D) head views of a (B, T, H * (D + extra)) projection:
    extra = 1 is a packed head view one element longer per row."""
    buf = torch.zeros(b, t, h * (d + extra), dtype=dtype)
    return buf.view(b, t, h, d + extra)[..., :d].permute(0, 2, 1, 3)


@pytest.mark.parametrize("dtype,d,extra,tq,route,dp", [
    (torch.bfloat16, 100, 0, 9, "tc_pad", 104),     # D % 8 != 0
    (torch.bfloat16, 16, 1, 40, "tc_pad", 16),      # rows one longer
    (torch.bfloat16, 64, 0, 40, "tc", 64),
    (torch.float32, 16, 1, 40, "f32tc_pad", 16),
    (torch.float32, 6, 0, 40, "f32tc_pad", 8),      # D % 4 != 0
    (torch.float32, 128, 0, 40, "f32tc_d128", 128),  # ids 14/15's heads
    (torch.float32, 100, 0, 40, "f32tc_d128", 100),
    (torch.float32, 126, 0, 40, "f32tc_pad", 128),
    (torch.float32, 32, 0, 272, "f32tc", 32),
    (torch.bfloat16, 100, 0, 1, "tc_q1", 100),       # a pool: any rows
    (torch.float32, 4, 1, 1, "f32tc_q1", 4),
])
def test_grad_plan_picks_a_kernel_route(dtype, d, extra, tq, route, dp):
    q = _heads(2, tq, 2, d, dtype, extra)
    k, v = (_heads(2, 30, 2, d, dtype, extra) for _ in range(2))
    plan = grad_plan(tuple(q.shape), 30, dtype,
                     tuple(t.stride() for t in (q, k, v)),
                     tuple(t.data_ptr() for t in (q, k, v)))
    assert plan == (route, dp)
    assert grad_route(q, k, v) == plan


def test_grad_plan_reads_the_addresses():
    """A base off a 16-byte boundary takes the padded copies."""
    shape, strides = (2, 2, 40, 64), ((5120, 64, 128, 1),) * 3
    assert grad_plan(shape, 40, torch.bfloat16, strides, (0, 0, 0)) == \
        ("tc", 64)
    assert grad_plan(shape, 40, torch.bfloat16, strides, (0, 8, 0)) == \
        ("tc_pad", 64)


@pytest.mark.parametrize("dtype,d,extra,route,entry,dp", [
    (torch.bfloat16, 100, 0, "tc_pad", "ns2vc_flash_attention_bwd_wgmma",
     104),
    (torch.bfloat16, 16, 1, "tc_pad", "ns2vc_flash_attention_bwd_wgmma", 16),
    (torch.float32, 6, 0, "f32tc_pad",
     "ns2vc_flash_attention_f32_bwd_wgmma", 6),
    (torch.float32, 128, 0, "f32tc_d128",
     "ns2vc_flash_attention_f32_bwd_wgmma", 128),
])
def test_refused_geometries_launch_the_tile_kernels(card_routes, dtype, d,
                                                    extra, route, entry, dp):
    """As for a CUDA tensor (the library a recorder): no error, the tile
    kernels' entry (bf16: at the padded head dim on contiguous copies; f32:
    at the head dim on the inputs' own strides, which the converting pass
    reads and pads), gradients of the inputs' shape, the sub-route
    counted."""
    q, k, v, do = (_heads(2, t, 2, d, dtype, extra) for t in (9, 30, 30, 9))
    n0 = dict(fa.flash_attention_grad.route_launches)
    grads = fa.flash_attention_grad(q, k, v, None, d ** -0.5, do)
    assert fa.flash_attention_grad.route_launches == {**n0,
                                                      route: n0[route] + 1}
    (name, args), = card_routes.calls
    assert name == entry
    assert args[9:14] == (2, 2, 9, 30, dp)
    if route == "tc_pad":   # q's copy: contiguous (B, H, T, dp)
        assert args[14:17] == (2 * 9 * dp, 9 * dp, dp)
    elif route == "f32tc_pad":   # q itself
        assert args[14:17] == q.stride()[:3]
    for g, t in zip(grads, (9, 30, 30)):
        assert g.shape == (2, 2, t, d) and g.dtype == dtype


def _jax_grads(q, k, v, bias, scale, do):
    """jax.vjp of the JAX package's attention at the highest precision."""
    def grads(q_, k_, v_, b_, do_):
        jb = None if b_ is None else b_[:, None, None]
        _, vjp = jax.vjp(lambda a, b2, c: scaled_dot_product_attention(
            a, b2, c, jb, scale), q_, k_, v_)
        return vjp(do_)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(grads)(*(None if t is None
                               else jnp.asarray(t.contiguous().numpy())
                               for t in (q, k, v, bias, do)))
    return [torch.tensor(np.asarray(g)) for g in out]


@pytest.mark.parametrize("h,tq,tk,d,extra,per,lengths", [
    (2, 40, 50, 100, 0, 8, [50, 21]),   # bf16's D = 100 -> 104, in f32
    (2, 33, 33, 16, 1, 4, None),        # a packed head view one longer
    (1, 24, 40, 6, 0, 4, [40, 7]),      # D % 4 != 0
    (2, 20, 36, 126, 0, 4, None),       # pads to 128
])
def test_padded_backward_is_the_backward(h, tq, tk, d, extra, per, lengths):
    """`per`: the elements of a 16-byte chunk of the route's dtype."""
    rng = np.random.default_rng(tq * tk + d)
    q, k, v, do = (_heads(2, t, h, d, torch.float32, extra)
                   for t in (tq, tk, tk, tq))
    for t in (q, k, v, do):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape)))
    bias = None
    if lengths is not None:
        keep = torch.arange(tk)[None] < torch.tensor(lengths)[:, None]
        bias = (1.0 - keep.float()) * -1e4
    scale = d ** -0.5
    dp = -(-d // per) * per
    padded = flash_attention_backward(*(fa._padded(t, dp) for t in (q, k, v)),
                                      bias, scale, fa._padded(do, dp))
    for g in padded:
        assert g.is_contiguous() and torch.all(g[..., d:] == 0)
    got = [g[..., :d] for g in padded]
    want = _jax_grads(q, k, v, bias, scale, do)
    errs = [((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]
    assert max(errs) <= RTOL, errs


def _pool_views(b, h, tk, d, dtype):
    """q, k, v as the pools make them (head views of one projection) and
    dk, dv as the backward allocates them ((B, T, H, D) buffers)."""
    k, v = (torch.zeros(b, tk, h * d, dtype=dtype).view(b, tk, h, d)
            .permute(0, 2, 1, 3) for _ in range(2))
    dk, dv = (torch.empty(b, tk, h, d, dtype=dtype).permute(0, 2, 1, 3)
              for _ in range(2))
    return k, v, dk, dv


@pytest.mark.parametrize("b,h,tk,d,dtype,vec", [
    (32, 1, 273, 100, torch.bfloat16, 8),   # ref_enc, a training step
    (32, 64, 273, 4, torch.bfloat16, 16),   # add_embedding: 16 heads
    (2, 1, 273, 100, torch.float32, 16),    # the f32 gradient checks
    (2, 64, 273, 4, torch.float32, 16),
])
def test_single_query_backward_plan(b, h, tk, d, dtype, vec):
    es = torch.tensor([], dtype=dtype).element_size()
    hg, tile, splits = plan_q1_backward(b, h, tk, d, es)
    kpb = -(-tk // splits)
    assert 1 <= splits <= Q1_MAX_SPLITS and (splits - 1) * kpb < tk
    assert hg * d * es <= fa.Q1_SEGMENT_BYTES and hg * d <= fa.Q1_THREADS
    assert q1_backward_smem(hg, d, kpb, tile, es) <= MAX_SMEM
    grid = b * -(-h // hg) * splits
    assert grid <= _build.H100_SMS
    if b == 32:   # the training pools: one wave over the SMs
        assert grid >= 0.9 * _build.H100_SMS
        assert kpb <= tile   # k read once for both passes
    k, v, dk, dv = _pool_views(b, h, tk, d, dtype)
    assert q1_vec_bytes(k, v, hg, dk, dv) == vec


# (T, C) of one UNet step's statistics calls: serving B = 16 and B = 1 at
# 448 frames, and the training step's 272 frames
GN_GEOMETRIES = [(448 >> lvl, c) for lvl, c in enumerate((128, 256, 384, 512))
                 ] + [(272 >> lvl, c)
                      for lvl, c in enumerate((128, 256, 384, 512))]


@pytest.mark.parametrize("t,c", GN_GEOMETRIES)
@pytest.mark.parametrize("width", [8, 4])   # bf16 / f32 16-byte vectors
def test_statistics_block_plan(t, c, width):
    splits = gn_splits(t, c, 8, width)
    threads = gn_threads(t, c, 8, width, splits)
    items = -(-t // splits) * (c // 8 // width)
    assert threads % 32 == 0 and 32 <= threads <= GN_THREADS
    assert splits == 1 and threads * GN_LOADS >= items   # one round
    if items <= 2 * GN_THREADS:   # two vectors a thread at most
        assert 2 * threads >= items and threads - 32 < -(-items // 2)


def test_statistics_block_at_the_serving_widths():
    assert [gn_threads(t, c, 8, 8, 1) for t, c in GN_GEOMETRIES[:4]] == \
        [448, 448, 352, 224]


def _merge(a, b):
    """Chan's merge in f32 of (n, mean, m2) arrays, as the kernel's."""
    n = (a[0] + b[0]).astype(np.float32)
    delta = (b[1] - a[1]).astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        wb = np.where(a[0] == b[0], np.float32(0.5),
                      (b[0] / n).astype(np.float32)).astype(np.float32)
    mean = (a[1] + delta * wb).astype(np.float32)
    m2 = (a[2] + b[2] + delta * delta * a[0] * wb).astype(np.float32)
    out = [np.where(b[0] == 0, a[i], np.where(a[0] == 0, b[i], v))
           for i, v in enumerate((n, mean, m2))]
    return [o.astype(np.float32) for o in out]


def _xor_tree(parts):
    """The kernel's warp_merge over 32 lanes of each row: lane 0's total."""
    for off in (16, 8, 4, 2, 1):
        idx = np.arange(parts[0].shape[-1]) ^ off
        parts = _merge(parts, [p[..., idx] for p in parts])
    return [p[..., 0] for p in parts]


def emulate_statistics(slab: np.ndarray, splits: int, width: int):
    """(mean, var) of a (T, C / G) f32 slab as the kernel merges it."""
    t, cg = slab.shape
    threads = gn_threads(t, 8 * cg, 8, width, splits)
    blocks = []
    for s in range(splits):
        vecs = slab[s * t // splits:(s + 1) * t // splits].reshape(-1, width)
        items = len(vecs)
        tid = np.arange(threads)
        m = [np.zeros(threads, np.float32) for _ in range(3)]
        for base0 in range(0, items, threads * 8):
            base = base0 + tid
            live = base < items
            cnt = np.clip(-(-(items - base) // threads), 0, 8)
            vals = [vecs[np.minimum(base + u * threads, items - 1)]
                    for u in range(8)]
            acc = np.zeros(threads, np.float32)
            for u in range(8):
                for i in range(width):
                    acc = np.where(u < cnt, acc + vals[u][:, i], acc) \
                        .astype(np.float32)
            n = (cnt * width).astype(np.float32)
            with np.errstate(invalid="ignore", divide="ignore"):
                mean = (acc / n).astype(np.float32)
            m2 = np.zeros(threads, np.float32)
            for u in range(8):
                for i in range(width):
                    dev = (vals[u][:, i] - mean).astype(np.float32)
                    fma = (dev.astype(np.float64) ** 2 + m2).astype(np.float32)
                    m2 = np.where(u < cnt, fma, m2).astype(np.float32)
            rnd = [np.where(live, x, 0).astype(np.float32)
                   for x in (n, mean, m2)]
            m = _merge(m, rnd)
        warps = _xor_tree([x.reshape(-1, 32) for x in m])
        lanes = [np.zeros(32, np.float32) for _ in range(3)]
        for i in range(3):
            lanes[i][:len(warps[i])] = warps[i]
        blocks.append([x[()] for x in _xor_tree(lanes)])
    lanes = [np.zeros(32, np.float32) for _ in range(3)]
    for r, blk in enumerate(blocks):
        for i in range(3):
            lanes[i][r] = blk[i]
    n, mean, m2 = (x[()] for x in _xor_tree(lanes))
    return mean, np.float32(m2 / n)


@pytest.mark.parametrize("t,cg,width,splits", [
    (448, 16, 8, 1),     # B=16 serving, C = 128, bf16 vectors
    (448, 16, 4, 1),     # the same in f32
    (56, 64, 8, 1),      # C = 512 at level 3
    (832, 48, 8, 2),     # the CLI's longest B=1 bucket: a cluster of 2
])
def test_statistics_merge_order_keeps_the_digits(t, cg, width, splits):
    rng = np.random.default_rng(t + cg)
    slab = (1000.0 + rng.standard_normal((t, cg))).astype(np.float32)
    mean, var = emulate_statistics(slab, splits, width)
    x64 = slab.astype(np.float64)
    assert abs(mean - x64.mean()) <= RTOL * abs(x64.mean())
    assert abs(var - x64.var()) <= RTOL * x64.var()
    rstd = 1.0 / np.sqrt(np.float64(var) + 1e-5)
    assert abs(rstd - 1.0 / np.sqrt(x64.var() + 1e-5)) <= RTOL * rstd
    # the uncentred form in f32 loses the variance to the offset
    f = slab.reshape(-1)
    naive = np.float32(np.mean(f * f, dtype=np.float32)
                       - np.float32(np.mean(f, dtype=np.float32)) ** 2)
    assert abs(naive - x64.var()) > 100 * RTOL * x64.var()
