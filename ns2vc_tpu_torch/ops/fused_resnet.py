"""Fused resnet epilogue: GroupNorm(+FiLM) -> SiLU -> conv k3 (kernel K2).

Replaces `ns2vc_tpu/ops/pallas_resnet.py::affine_silu_conv1d` (the Pallas
TPU kernel) and its wrapper `gn_silu_conv1d`. Once the GroupNorm statistics
are known, GroupNorm and the FiLM modulation fold into one per-(batch,
channel) affine, so the epilogue is

    y = conv1d_k3_SAME(silu(x * a + b), w) + bias,   a, b of shape (B, C).

`group_norm_affine` computes the statistics and the fold in one kernel on a
card (`csrc/group_norm_affine.cu`, for x in bf16 and in f32; the JAX wrapper
leaves them to XLA) and keeps a and b in f32 (the JAX wrapper rounds them
to x's dtype); a CPU tensor takes `group_norm_affine_plain`, the same
arithmetic in torch ops. `affine_silu_conv1d` routes by
`resnet_route(device, dtype)` and on nothing else:

    cpu        -> `affine_silu_conv1d_plain`
    cuda, bf16 -> "tc": `csrc/gn_silu_conv1d_tc.cu`, an implicit GEMM on
                  wgmma (bf16 -> f32) over TMA-fed weights in 64 x 128
                  output tiles, split over the input channels by
                  `plan_wgmma` into a cluster when the tiles alone would
                  not fill the card; x through a TMA map, or ("tc_elem")
                  by element loads when C % 8 != 0 or x, a, b are not
                  16-byte aligned
    cuda, f32  -> "f32tc": `csrc/gn_silu_conv1d.cu`, the same design on
                  wgmma in TF32 with three passes per product (3xTF32:
                  each operand's TF32 big and small halves), at f32
                  accuracy, in 64 x 128 output tiles over 16-channel
                  chunks, split by `plan_tc` into a cluster likewise; x by
                  element loads ("f32tc_elem") when C % 4 != 0 or x, a, b
                  are not 16-byte aligned

Both run over weights packed once per weight tensor by `pack_conv_weight`
(kept while the tensor lives, keyed by its storage and version, with the
kernel's TMA map of them; f32 weights packed as their big and small TF32
planes). A CUDA tensor launches one of the kernels or raises.
`affine_silu_conv1d.launches` counts every launch,
`affine_silu_conv1d.route_launches` each route's ("tc_elem" apart from
"tc", "f32tc_elem" from "f32tc"), `group_norm_affine.launches` the
statistics kernel's. A replayed
CUDA graph launches kernels, and runs their backwards, without calling the
wrappers or the Functions: its owner adds the launch and backward counts
its capture took (`launch_counts`, `add_launch_counts`). The
CUDA source notes say what bounds each kernel on the H100 and how its
design answers that.

Training: when grad is enabled and an input requires it, a CUDA call goes
through an autograd Function whose forward is the same launch and whose
backward is `affine_silu_conv1d_grad`: three kernels per dtype that
recompute the activation and sum every gradient in an order fixed by the
shapes, with no atomics, so a training step is bit-reproducible on the
card. bf16 (every training step's route): `csrc/affine_silu_conv1d_bwd_
wgmma.cu`, dgrad and wgrad on wgmma over TMA-fed tiles of the flattened
B * T frames, h in BWD_H_PLANES bf16 planes (written by dgrad, read by
wgrad), splits of the weight gradient's frame sum from `plan_wgrad`; f32:
`csrc/affine_silu_conv1d_f32_bwd_wgmma.cu`, the same structure on tf32
wgmma in three passes per product (3xTF32), w packed once per call as
TF32 planes with its output channels contiguous, h's TF32 planes written
transposed by dgrad for wgrad, splits from `plan_wgrad_f32`.
`affine_silu_conv1d_backward`, the same arithmetic in f32 torch ops (the
conv's input and weight gradients one `convolution_backward`), is their
plain version, which a CPU tensor takes. Each backward adds one to
`affine_silu_conv1d.backward_calls[route]`, each launch of the backward
kernels one to `affine_silu_conv1d_grad.launches` and to its
`route_launches["bf16"]` or `["f32"]`. The packed weights are
made from `w.detach()`: w's gradient comes from the backward, never
through the packed copy. `group_norm_affine` goes through its own Function
whose forward is the statistics kernel, which then also writes each
(batch, group)'s f32 mean and rstd for the backward, and whose backward is
`group_norm_affine_grad`: on a card `csrc/group_norm_affine_bwd.cu`, one
launch of one kernel over all SMs (parameter blocks: every parameter
gradient in a fixed order; dx blocks: each derives its batch row's
per-group coefficients, then writes its share of dx in one streaming pass
over x), on the CPU `group_norm_affine_backward`, the same closed form in
torch ops. Each
backward adds one to `group_norm_affine.backward_calls`, each launch of
the backward kernels one to `group_norm_affine.backward_launches`.
"""

from __future__ import annotations

import ctypes
import weakref

import torch
import torch.nn.functional as F

from ns2vc_tpu_torch.ops import _build

# the kernels' tiles: frames, output channels, input channels per chunk
# (csrc/gn_silu_conv1d_tc.cu kBM, kBN, kBK; csrc/gn_silu_conv1d.cu's: a
# chunk is one 64-byte row of f32)
TC_BM, TC_BN, TC_BK = 64, 128, 64
F32_BM, F32_BN, F32_BK = 64, 128, 16
TC_MAX_SPLITS = 8         # either conv kernel's splits form one portable
                          # cluster
GN_MAX_SPLITS = 8         # the statistics kernel's blocks per slab, likewise
# the f32 backward kernels' tiles (csrc/affine_silu_conv1d_f32_bwd_
# wgmma.cu kDgFrames, kWgFrames, kOChunk): a dgrad block's frames, the
# weight gradient's frames per chunk, the packed weights' output channels
# per row (input channels per tile and output channels per weight-gradient
# tile: WG_COLS, WG_ROWS)
F32_DG_FRAMES, F32_WG_FRAMES, F32_CO_CHUNK = 128, 32, 32
# the bf16 backward kernels' tiles (csrc/affine_silu_conv1d_bwd_wgmma.cu
# kFrames, kCols, kWgRows): frames of the flattened B * T per dgrad tile and
# per weight-gradient chunk, input channels per tile, output channels per
# weight-gradient tile; the bf16 planes of h
WG_FRAMES, WG_COLS, WG_ROWS = 64, 64, 64
WG_MAX_SPLITS = 64
BWD_H_PLANES = 2


def resnet_route(device: torch.device | str, dtype: torch.dtype) -> str:
    """'plain' (CPU), 'tc' (bf16 kernel) or 'f32tc' (the 3xTF32 kernel,
    which takes f32; the checks below refuse any other dtype); raises for a
    device that is neither CPU nor CUDA."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise ValueError(f"affine_silu_conv1d: unsupported device {device}")
    return "tc" if dtype == torch.bfloat16 else "f32tc"


def chunk_width(dtype: torch.dtype) -> int:
    """Input channels per chunk of the kernel that takes `dtype`."""
    return TC_BK if dtype == torch.bfloat16 else F32_BK


def tile_width(dtype: torch.dtype) -> int:
    """Output channels per tile of the kernel that takes `dtype`."""
    return TC_BN if dtype == torch.bfloat16 else F32_BN


def _plan_cluster(tiles: int, n_chunks: int) -> tuple[int, int]:
    """(splits, chunks per split) of a warp-specialised conv kernel's
    channel loop. It holds one block per SM, so the splits of a tile stay
    within one wave; a split gets two chunks or more (the bf16 kernel's two
    consumer warpgroups take alternate chunks): the most splits, at most
    TC_MAX_SPLITS (one cluster) and at most half the chunks, whose output
    tiles times splits fit on the H100's SMs; one split when the tiles
    alone fill them. The chunks are dealt evenly and no split is left
    empty."""
    want = max(1, min(TC_MAX_SPLITS, n_chunks // 2,
                      _build.H100_SMS // tiles))
    cps = -(-n_chunks // want)
    return -(-n_chunks // cps), cps


def plan_tc(bsz: int, t: int, c: int, co: int) -> tuple[int, int]:
    """(splits, chunks per split) of the f32 kernel over its 64 x 128
    (T, Co) output tiles per batch row and 16-channel chunks
    (`_plan_cluster`)."""
    return _plan_cluster(-(-t // F32_BM) * -(-co // F32_BN) * bsz,
                         -(-c // F32_BK))


def plan_wgmma(bsz: int, t: int, c: int, co: int) -> tuple[int, int]:
    """(splits, chunks per split) of the bf16 kernel over its 64 x 128
    (T, Co) output tiles per batch row and 64-channel chunks
    (`_plan_cluster`)."""
    return _plan_cluster(-(-t // TC_BM) * -(-co // TC_BN) * bsz,
                         -(-c // TC_BK))


GN_THREADS, GN_LOADS = 512, 8   # the statistics kernel's largest block,
                                # loads in flight per thread at most


def gn_splits(t: int, c: int, groups: int, vec_width: int) -> int:
    """Blocks per (batch, group) slab of the statistics kernel, one
    cluster over equal runs of frames: as many as the slab's T * C / groups
    values need for each block to read its share in one round of loads
    (GN_LOADS vectors of `vec_width` values per thread of GN_THREADS), at
    most GN_MAX_SPLITS and at most T. The kernel's time is the latency of
    its rounds of loads and of the steps after them, not the card's
    bandwidth."""
    per_round = GN_THREADS * GN_LOADS * vec_width
    want = -(-t * (c // groups) // per_round)
    return max(1, min(GN_MAX_SPLITS, t, want))


def gn_threads(t: int, c: int, groups: int, vec_width: int,
               splits: int) -> int:
    """Threads of one statistics block, which the kernel is launched with:
    two vectors of `vec_width` values of its share of the slab per thread,
    in whole warps, at most GN_THREADS."""
    items = -(-t // splits) * (c // groups // vec_width)
    return min(GN_THREADS, max(32, -(-(-(-items // 2)) // 32) * 32))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 stored mantissa bits), ties away
    from zero, as f32: the rounding of `cvt.rna.tf32.f32`."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """torch Conv1d weight (Co, C, 3) -> the kernels' packed layout,
    contiguous along C, zero past (Co, C), Co_pad and C_pad rounded up to
    the tile and chunk widths of the kernel of w's dtype: tap k's (Co, C)
    matrix multiplies the frames shifted by k - 1. bf16: (3, Co_pad,
    C_pad), Co_pad a multiple of 128 and C_pad of 64 (rows of 128 bytes for
    TMA). f32: (2, 3, Co_pad, C_pad) in 128 x 16 (rows of 64 bytes), the
    big and small TF32 halves of 3xTF32 (big = w rounded to TF32, small =
    the exact remainder rounded again), so the kernel splits no weight."""
    co, c, _ = w.shape
    bk, bn = chunk_width(w.dtype), tile_width(w.dtype)
    shape = (3, -(-co // bn) * bn, -(-c // bk) * bk)
    taps = w.detach().permute(2, 0, 1)
    if w.dtype == torch.bfloat16:
        packed = torch.zeros(shape, dtype=torch.bfloat16, device=w.device)
        packed[:, :co, :c] = taps
        return packed
    packed = torch.zeros((2, *shape), dtype=torch.float32, device=w.device)
    big = tf32_round(taps.float().contiguous())
    packed[0, :, :co, :c] = big
    packed[1, :, :co, :c] = tf32_round(taps.float() - big)
    return packed


class _Packed:
    """One weight tensor's packing: its key, the packed tensor, and the
    kernel's TMA map of it (128 bytes, encoded at first launch)."""

    __slots__ = ("key", "tensor", "tmap")

    def __init__(self, key, tensor):
        self.key, self.tensor, self.tmap = key, tensor, None


_PACKED: dict[int, _Packed] = {}   # id(w) -> its packing, while w lives
_BY_KEY: dict[tuple, _Packed] = {}  # the same packings by their keys


def _key(w: torch.Tensor) -> tuple:
    return (w.data_ptr(), w._version, w.dtype, tuple(w.shape), w.stride())


def _current_packing(w: torch.Tensor) -> _Packed | None:
    """w's packing where one is current, else None (nothing is packed)."""
    key = _key(w)
    hit = _PACKED.get(id(w))
    if hit is not None and hit.key == key:
        return hit
    return _BY_KEY.get(key)


def _packing(w: torch.Tensor) -> _Packed:
    """w's packing; another tensor object over the same memory, stride and
    version as a live packed tensor (the alias autograd saves for a
    backward, as under remat) shares that tensor's packing."""
    current = _current_packing(w)
    if current is not None:
        return current
    key = _key(w)
    hit = _PACKED.get(id(w))
    if hit is None:
        weakref.finalize(w, _forget, id(w))
    else:
        _BY_KEY.pop(hit.key, None)
    hit = _PACKED[id(w)] = _BY_KEY[key] = _Packed(key, pack_conv_weight(w))
    return hit


def _forget(ident: int) -> None:
    hit = _PACKED.pop(ident, None)
    if hit is not None and _BY_KEY.get(hit.key) is hit:
        del _BY_KEY[hit.key]


def packed_weight(w: torch.Tensor) -> torch.Tensor:
    """`pack_conv_weight(w)`, computed once per weight tensor and kept while
    the tensor lives; recomputed when its storage or version (an in-place
    update) changes."""
    return _packing(w).tensor


def weight_map(w: torch.Tensor, lib) -> ctypes.Array:
    """The TMA map of `packed_weight(w)` for the kernel of w's dtype,
    encoded once per packing (it holds the packed tensor's address): rows
    of the packed tensor's leading axes, columns its C_pad."""
    hit = _packing(w)
    if hit.tmap is None:
        p = hit.tensor
        encode = (lib.ns2vc_encode_weight_map if p.dtype == torch.bfloat16
                  else lib.ns2vc_encode_weight_map_f32)
        tmap = ctypes.create_string_buffer(128)
        _build.check(encode(p.data_ptr(), p.numel() // p.shape[-1],
                            p.shape[-1], ctypes.addressof(tmap)),
                     "affine_silu_conv1d weight map")
        hit.tmap = tmap
    return hit.tmap


def affine_silu_conv1d_plain(x: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, w: torch.Tensor,
                             bias: torch.Tensor) -> torch.Tensor:
    """x (B, T, C), a/b (B, C) f32, w (Co, C, 3) torch Conv1d layout,
    bias (Co,) -> (B, T, Co) in x's dtype; computed in f32 (f64 for f64
    inputs)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    h = F.silu(x.to(acc) * a.to(acc)[:, None, :] + b.to(acc)[:, None, :])
    y = F.conv1d(h.transpose(1, 2), w.to(acc), bias.to(acc), padding=1)
    return y.transpose(1, 2).to(x.dtype)


def affine_silu_conv1d_backward(x: torch.Tensor, a: torch.Tensor,
                                b: torch.Tensor, w: torch.Tensor,
                                bias: torch.Tensor, dy: torch.Tensor):
    """(dx, da, db, dw, dbias) of y = conv1d_k3_SAME(silu(x * a + b), w) +
    bias given dy (B, T, Co), in f32 (f64 for f64 inputs), each cast to its
    input's dtype:
        z = x a + b,  s = sigmoid(z),  h = z s
        dbias = sum dy;  dw, dh = the k=3 conv's weight and input gradients
        dz = dh s (1 + z (1 - s));  dx = dz a,  da = sum_T dz x,
        db = sum_T dz."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc)
    z = xf * a.to(acc)[:, None, :] + b.to(acc)[:, None, :]
    s = torch.sigmoid(z)
    h = z * s
    dh, dw, dbias = torch.ops.aten.convolution_backward(
        dy.to(acc).transpose(1, 2), h.transpose(1, 2), w.to(acc),
        [w.shape[0]], [1], [1], [1], False, [0], 1, [True, True, True])
    dz = dh.transpose(1, 2) * (s * (1.0 + z * (1.0 - s)))
    return ((dz * a.to(acc)[:, None, :]).to(x.dtype),
            (dz * xf).sum(dim=1).to(a.dtype), dz.sum(dim=1).to(b.dtype),
            dw.to(w.dtype), dbias.to(bias.dtype))


class _AffineSiluConv1dFn(torch.autograd.Function):
    """The kernel's launch under autograd; backward through the backward
    kernels (`affine_silu_conv1d_grad`)."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias):
        y, route = _launch(x, a, b, w, bias)
        ctx.save_for_backward(x, a, b, w, bias)
        ctx.route = route
        return y

    @staticmethod
    def backward(ctx, dy):
        _conv_counts.backward_calls[ctx.route] += 1
        return affine_silu_conv1d_grad(*ctx.saved_tensors, dy.contiguous())


def plan_wgrad_f32(bsz: int, t: int, c: int, co: int) -> int:
    """Splits of the f32 backward's weight-gradient sum over the
    ceil(B * T / 32) chunks of the flattened frames: (64 x 64 x 3 taps) dw
    tiles times splits up to the H100's SMs (one block each), at most
    WG_MAX_SPLITS and at most the chunks; split z takes chunks [z n / S,
    (z + 1) n / S), as `plan_wgrad`'s."""
    tiles = -(-c // WG_COLS) * -(-co // WG_ROWS)
    chunks = -(-bsz * t // F32_WG_FRAMES)
    return max(1, min(chunks, WG_MAX_SPLITS, _build.H100_SMS // tiles))


def f32_backward_workspace(bsz: int, t: int, c: int, co: int,
                           splits: int) -> int:
    """f32 values of the f32 backward kernels' workspace (`Workspace` in
    their source), each part rounded up to 32 values: each split's dw and
    dbias partials, each batch row's frame-tile partials of da and db, w's
    TF32 planes (2, 3, C_pad, Co_pad), C rounded up to 64 and Co to 32, and
    h's (2, C_pad, B * T rounded up to 4), frames contiguous."""
    cp = -(-c // WG_COLS) * WG_COLS
    cop = -(-co // F32_CO_CHUNK) * F32_CO_CHUNK
    parts = (splits * 3 * co * c, splits * co, bsz * frame_slots(t) * c,
             bsz * frame_slots(t) * c, 2 * 3 * cp * cop,
             2 * cp * -(-bsz * t // 4) * 4)
    return sum(-(-n // 32) * 32 for n in parts)


def plan_wgrad(bsz: int, t: int, c: int, co: int) -> int:
    """Splits of the bf16 backward's weight-gradient sum over the
    ceil(B * T / 64) chunks of the flattened frames: (64 x 64 x 3 taps) dw
    tiles times splits up to the H100's SMs (one block each), at most
    WG_MAX_SPLITS and at most the chunks. Split z takes chunks [z n / S,
    (z + 1) n / S): contiguous, none empty."""
    tiles = -(-c // WG_COLS) * -(-co // WG_ROWS)
    chunks = -(-bsz * t // WG_FRAMES)
    return max(1, min(chunks, WG_MAX_SPLITS, _build.H100_SMS // tiles))


def frame_slots(t: int) -> int:
    """The most 64-frame tiles of the flattened B * T frames that one batch
    row of T frames touches: da's and db's partials per batch row."""
    return (t + WG_FRAMES - 2) // WG_FRAMES + 1


def wgmma_backward_workspace(bsz: int, t: int, c: int, co: int,
                             splits: int) -> int:
    """f32 values of the bf16 backward kernels' workspace: each split's dw
    and dbias partials, each batch row's frame-tile partials of da and db,
    then, at a multiple of 64 values, h's two bf16 planes over the B * T
    frames, rows of C rounded up to 64 (dgrad writes them, wgrad reads
    them by TMA)."""
    partials = splits * (3 * co * c + co) + 2 * bsz * frame_slots(t) * c
    return -(-partials // 64) * 64 + bsz * t * -(-c // WG_COLS) * WG_COLS


def affine_silu_conv1d_grad(x: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, w: torch.Tensor,
                            bias: torch.Tensor, dy: torch.Tensor,
                            keep_f32: bool = False):
    """(dx, da, db, dw, dbias) of `affine_silu_conv1d` given dy (B, T, Co),
    each in its input's dtype, or with `keep_f32` dx, dw, dbias in f32
    (the sums before their rounding to bf16). A CPU tensor takes
    `affine_silu_conv1d_backward`; a CUDA tensor the backward kernels of
    its dtype (bf16: `csrc/affine_silu_conv1d_bwd_wgmma.cu`, wgmma; f32:
    `csrc/affine_silu_conv1d_f32_bwd_wgmma.cu`, 3xTF32 on tf32 wgmma; no
    atomics, so two calls on one input agree bit for bit) or raises. On CUDA: x, w, bias, dy
    contiguous and of one dtype (f32 or bf16); a, b contiguous f32."""
    if resnet_route(x.device, x.dtype) == "plain":
        if keep_f32:
            x, w, bias, dy = (v.float() for v in (x, w, bias, dy))
        return affine_silu_conv1d_backward(x, a, b, w, bias, dy)
    return _grad_launch(x, a, b, w, bias, dy, keep_f32)


def _grad_launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 w: torch.Tensor, bias: torch.Tensor, dy: torch.Tensor,
                 keep_f32: bool = False):
    """Check the inputs and launch the backward kernels: (dx, da, db, dw,
    dbias)."""
    _check_inputs(x, a, b, w, bias, "affine_silu_conv1d_grad")
    bsz, t, c = x.shape
    co = w.shape[0]
    if dy.shape != (bsz, t, co) or dy.dtype != x.dtype \
            or not dy.is_contiguous() or dy.device != x.device:
        raise ValueError(f"affine_silu_conv1d_grad: dy {tuple(dy.shape)} "
                         f"{dy.dtype} must be contiguous ({bsz}, {t}, {co}) "
                         f"{x.dtype} on {x.device}")
    bf16 = x.dtype == torch.bfloat16
    if -(-bsz * t // (WG_FRAMES if bf16 else F32_DG_FRAMES)) > 65535:
        raise ValueError(f"affine_silu_conv1d_grad: unsupported shape "
                         f"{tuple(x.shape)}")
    _build.require_current_device(x)
    lib = _build.library()
    if bf16:
        splits = plan_wgrad(bsz, t, c, co)
        size = wgmma_backward_workspace(bsz, t, c, co, splits)
    else:
        splits = plan_wgrad_f32(bsz, t, c, co)
        size = f32_backward_workspace(bsz, t, c, co, splits)
    ws = torch.empty(size, dtype=torch.float32, device=x.device)
    out = torch.float32 if keep_f32 else x.dtype
    dx = torch.empty((bsz, t, c), dtype=out, device=x.device)
    dw = torch.empty((co, c, 3), dtype=out, device=x.device)
    dbias = torch.empty((co,), dtype=out, device=x.device)
    da = torch.empty((bsz, c), dtype=torch.float32, device=x.device)
    db = torch.empty_like(da)
    route = "bf16" if bf16 else "f32"
    _grad_counts.launches += 1
    _grad_counts.route_launches[route] += 1
    ptrs = (x.data_ptr(), a.data_ptr(), b.data_ptr())
    outs = (dx.data_ptr(), da.data_ptr(), db.data_ptr(), dw.data_ptr(),
            dbias.data_ptr(), ws.data_ptr())
    if bf16:
        vec = all(_build.aligned16(v) for v in (x, a, b, dy))
        err = lib.ns2vc_affine_silu_conv1d_bwd_wgmma(
            *ptrs, ctypes.addressof(weight_map(w, lib)), dy.data_ptr(),
            *outs, bsz, t, c, co, packed_weight(w).shape[-2], splits,
            int(vec), int(keep_f32), _build.stream_of(x))
    else:
        err = lib.ns2vc_affine_silu_conv1d_f32_bwd_wgmma(
            *ptrs, w.data_ptr(), dy.data_ptr(), *outs, bsz, t, c, co, splits,
            int(_build.aligned16(dy)), _build.stream_of(x))
    _build.check(err, f"affine_silu_conv1d_grad ({route})")
    return dx, da, db, dw, dbias


affine_silu_conv1d_grad.launches = 0
affine_silu_conv1d_grad.route_launches = {"bf16": 0, "f32": 0}
_grad_counts = affine_silu_conv1d_grad


def affine_silu_conv1d(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y = conv1d_k3_SAME(silu(x * a + b), w) + bias. On CUDA: x, w, bias
    contiguous and of one dtype (f32 or bf16); a, b contiguous f32;
    differentiable in every input."""
    if resnet_route(x.device, x.dtype) == "plain":
        return affine_silu_conv1d_plain(x, a, b, w, bias)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, a, b, w, bias)):
        return _AffineSiluConv1dFn.apply(x, a, b, w, bias)
    return _launch(x, a, b, w, bias)[0]


def _check_inputs(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  w: torch.Tensor, bias: torch.Tensor, what: str) -> None:
    """Raise unless the inputs are what the forward and backward kernels
    take: x (B, T, C), a, b (B, C) f32, w (Co, C, 3), bias (Co,), x, w,
    bias of one kernel dtype, all contiguous and on one device."""
    if x.dim() != 3:
        raise ValueError(f"{what}: x must be (B, T, C), got "
                         f"{tuple(x.shape)}")
    bsz, t, c = x.shape
    co = w.shape[0]
    if w.shape != (co, c, 3) or bias.shape != (co,) \
            or a.shape != (bsz, c) or b.shape != (bsz, c):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)} a "
            f"{tuple(a.shape)} b {tuple(b.shape)} w {tuple(w.shape)} bias "
            f"{tuple(bias.shape)}")
    if x.dtype not in _build.KERNEL_DTYPES or w.dtype != x.dtype \
            or bias.dtype != x.dtype:
        raise ValueError(f"{what}: dtypes x {x.dtype} w {w.dtype}"
                         f" bias {bias.dtype}; f32 or bf16, all alike")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"{what}: a and b must be f32")
    if not all(v.is_contiguous() for v in (x, a, b, w, bias)):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(v.device != x.device for v in (a, b, w, bias)):
        raise ValueError(f"{what}: inputs on different devices")
    if min(bsz, t, c, co) < 1:
        raise ValueError(f"{what}: unsupported shape {tuple(x.shape)} -> "
                         f"{co}")


def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            w: torch.Tensor, bias: torch.Tensor) -> tuple[torch.Tensor, str]:
    """Check the inputs and launch the kernel of their route: (y, route)."""
    route = resnet_route(x.device, x.dtype)
    _check_inputs(x, a, b, w, bias, "affine_silu_conv1d")
    bsz, t, c = x.shape
    co = w.shape[0]
    splits, cps = (plan_wgmma if route == "tc" else plan_tc)(bsz, t, c, co)
    if bsz * splits > 65535:
        raise ValueError(f"affine_silu_conv1d: unsupported shape "
                         f"{tuple(x.shape)} -> {co}")
    _build.require_current_device(x)
    lib = _build.library()
    y = torch.empty((bsz, t, co), dtype=x.dtype, device=x.device)
    # the kernel copies its first packed weights before its grid dependency
    # wait: it may start before the kernel ahead of it ends (programmatic
    # dependent launch) only where that kernel is not the packing's
    pdl = _current_packing(w) is not None
    wp = packed_weight(w)
    tmap = weight_map(w, lib)
    vec = all(_build.aligned16(v) for v in (x, a, b))
    sub = route if vec else f"{route}_elem"
    entry = (lib.ns2vc_affine_silu_conv1d_tc if route == "tc"
             else lib.ns2vc_affine_silu_conv1d_f32tc)
    affine_silu_conv1d.launches += 1
    affine_silu_conv1d.route_launches[sub] += 1
    err = entry(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                ctypes.addressof(tmap), bias.data_ptr(), y.data_ptr(), bsz, t,
                c, co, wp.shape[-2], cps, splits, int(vec), int(pdl),
                _build.stream_of(x))
    _build.check(err, f"affine_silu_conv1d ({sub})")
    return y, route


affine_silu_conv1d.launches = 0
affine_silu_conv1d.route_launches = {"f32tc": 0, "f32tc_elem": 0, "tc": 0,
                                     "tc_elem": 0}
affine_silu_conv1d.backward_calls = {"f32tc": 0, "tc": 0}
# the counters' owner, also while a caller replaces the module's public
# name (the plain version in its place)
_conv_counts = affine_silu_conv1d


def reset_launches() -> None:
    _conv_counts.launches = _grad_counts.launches = 0
    _gn_counts.launches = _gn_counts.backward_calls = 0
    _gn_counts.backward_launches = 0
    for counts in (_conv_counts.route_launches, _conv_counts.backward_calls,
                   _grad_counts.route_launches):
        for key in counts:
            counts[key] = 0


def launch_counts() -> dict[str, int]:
    """The launch and backward counters, flat (a CUDA graph's owner takes
    them before and after its capture)."""
    return {"launches": _conv_counts.launches, "gn": _gn_counts.launches,
            "gn_backward": _gn_counts.backward_calls,
            "gn_backward_launches": _gn_counts.backward_launches,
            **{f"route.{k}": n
               for k, n in _conv_counts.route_launches.items()},
            **{f"backward.{k}": n
               for k, n in _conv_counts.backward_calls.items()},
            "grad": _grad_counts.launches,
            **{f"grad.{k}": n
               for k, n in _grad_counts.route_launches.items()}}


def add_launch_counts(delta: dict[str, int], times: int = 1) -> None:
    """Add `times` x `delta` (a difference of two `launch_counts()`): a
    replay launches, and runs the backwards, its capture counted."""
    _conv_counts.launches += times * delta["launches"]
    _gn_counts.launches += times * delta["gn"]
    _gn_counts.backward_calls += times * delta["gn_backward"]
    _gn_counts.backward_launches += times * delta["gn_backward_launches"]
    for k in _conv_counts.route_launches:
        _conv_counts.route_launches[k] += times * delta[f"route.{k}"]
    for k in _conv_counts.backward_calls:
        _conv_counts.backward_calls[k] += times * delta[f"backward.{k}"]
    _grad_counts.launches += times * delta["grad"]
    for k in _grad_counts.route_launches:
        _grad_counts.route_launches[k] += times * delta[f"grad.{k}"]


def gn_route(device: torch.device | str) -> str:
    """'plain' (CPU) or 'cuda' (the statistics kernel, bf16 or f32 x);
    raises for a device that is neither."""
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"group_norm_affine: unsupported device {device}")
    return "plain" if kind == "cpu" else "cuda"


def group_norm_affine(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, groups: int, eps: float,
                      film_scale: torch.Tensor | None = None,
                      film_shift: torch.Tensor | None = None):
    """GroupNorm(groups, eps) statistics of x (B, T, C) folded with
    gamma/beta and an optional FiLM (h*(1+scale)+shift, scale/shift (B, C))
    into the per-(batch, channel) f32 affine (a, b). On CUDA: x contiguous
    f32 or bf16; differentiable in every input."""
    if gn_route(x.device) == "plain":
        return group_norm_affine_plain(x, gamma, beta, groups, eps,
                                       film_scale, film_shift)
    film = (film_scale, film_shift)
    if torch.is_grad_enabled() and any(
            v is not None and v.requires_grad for v in (x, gamma, beta, *film)):
        return _GroupNormAffineFn.apply(x, gamma, beta, *film, groups, eps)
    return _gn_launch(x, gamma, beta, groups, eps, *film)


class _GroupNormAffineFn(torch.autograd.Function):
    """The statistics kernel under autograd, keeping each slab's mean and
    rstd; backward through `group_norm_affine_grad`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, film_scale, film_shift, groups, eps):
        a, b, mean, rstd = _gn_launch(x, gamma, beta, groups, eps,
                                      film_scale, film_shift, stats=True)
        ctx.save_for_backward(x, gamma, beta, film_scale, film_shift, mean,
                              rstd)
        ctx.groups = groups
        return a, b

    @staticmethod
    def backward(ctx, da, db):
        _gn_counts.backward_calls += 1
        x, gamma, beta, film_scale, film_shift, mean, rstd = \
            ctx.saved_tensors
        grads = group_norm_affine_grad(x, gamma, beta, ctx.groups,
                                       film_scale, film_shift, mean, rstd,
                                       da, db, need_x=ctx.needs_input_grad[0])
        return (*(g if n else None
                  for g, n in zip(grads, ctx.needs_input_grad[:5])),
                None, None)


def _gn_params(x, gamma, beta, film_scale, film_shift, what):
    """Check the statistics kernels' inputs; gamma, beta and FiLM in one
    dtype the kernels read (f32 where they differ), gamma and beta
    contiguous, FiLM rows of unit stride one common stride apart (a chunk
    of one projection) or made so: (params, FiLM row stride)."""
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous (B, T, C), got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    bsz, t, c = x.shape
    if x.dtype not in _build.KERNEL_DTYPES:
        raise ValueError(f"{what}: x dtype {x.dtype}; f32 or bf16")
    if (film_scale is None) != (film_shift is None):
        raise ValueError(f"{what}: FiLM needs scale and shift")
    params = [gamma, beta]
    if film_scale is not None:
        params += [film_scale, film_shift]
    if gamma.shape != (c,) or beta.shape != (c,) \
            or any(f.shape != (bsz, c) for f in params[2:]):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)} gamma "
            f"{tuple(gamma.shape)} beta {tuple(beta.shape)} film "
            f"{[tuple(f.shape) for f in params[2:]]}")
    if any(v.device != x.device for v in params):
        raise ValueError(f"{what}: inputs on different devices")
    if len({v.dtype for v in params}) > 1 \
            or params[0].dtype not in _build.KERNEL_DTYPES:
        params = [v.float() for v in params]
    params[:2] = [v.contiguous() for v in params[:2]]
    if len(params) == 4 and (params[2].stride(1) != 1
                             or params[3].stride() != params[2].stride()):
        params[2:] = [v.contiguous() for v in params[2:]]
    return params, (params[2].stride(0) if len(params) == 4 else 0)


def _gn_launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int, eps: float, film_scale: torch.Tensor | None,
               film_shift: torch.Tensor | None, stats: bool = False):
    """Check the inputs and launch the statistics kernel: (a, b), with
    `stats` also each (batch, group)'s f32 mean and rstd, (B, G) each."""
    params, film_stride = _gn_params(x, gamma, beta, film_scale, film_shift,
                                     "group_norm_affine")
    bsz, t, c = x.shape
    if groups < 1 or c % groups or min(bsz, t) < 1 or bsz > 65535 \
            or groups > 65535:
        raise ValueError(f"group_norm_affine: shapes x {tuple(x.shape)} "
                         f"groups {groups}")
    _build.require_current_device(x)
    lib = _build.library()
    a = torch.empty((bsz, c), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty((2, bsz, groups), dtype=torch.float32,
                                 device=x.device)
    per = 16 // x.element_size()
    vec = (c // groups) % per == 0 and x.data_ptr() % 16 == 0
    splits = gn_splits(t, c, groups, per if vec else 1)
    threads = gn_threads(t, c, groups, per if vec else 1, splits)
    _gn_counts.launches += 1
    err = lib.ns2vc_group_norm_affine(
        x.data_ptr(), params[0].data_ptr(), params[1].data_ptr(),
        *((params[2].data_ptr(), params[3].data_ptr()) if len(params) == 4
          else (None, None)),
        film_stride, a.data_ptr(), b.data_ptr(),
        *((mean.data_ptr(), rstd.data_ptr()) if stats else (None, None)),
        bsz, t, c, groups, float(eps), splits, threads,
        int(x.dtype == torch.bfloat16),
        int(params[0].dtype == torch.bfloat16), int(vec),
        _build.stream_of(x))
    _build.check(err, "group_norm_affine")
    return (a, b, mean, rstd) if stats else (a, b)


def group_norm_affine_grad(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, groups: int,
                           film_scale: torch.Tensor | None,
                           film_shift: torch.Tensor | None,
                           mean: torch.Tensor, rstd: torch.Tensor,
                           da: torch.Tensor, db: torch.Tensor,
                           need_x: bool = True):
    """(dx, dgamma, dbeta, dscale, dshift) of `group_norm_affine` given a's
    and b's gradients da, db (B, C) and the forward's mean and rstd (B, G)
    f32, each in its input's dtype and shape (dscale, dshift None without
    FiLM; dx None unless `need_x`). A CPU tensor takes
    `group_norm_affine_backward`; a CUDA tensor the backward kernels
    (`csrc/group_norm_affine_bwd.cu`; fixed summation orders, no atomics,
    so two calls on one input agree bit for bit) or raises."""
    if gn_route(x.device) == "plain":
        out = group_norm_affine_backward(x, gamma, beta, groups, 0.0,
                                         film_scale, film_shift, da, db,
                                         mean, rstd)
        return (out[0] if need_x else None, *out[1:])
    return _gn_grad_launch(x, gamma, beta, groups, film_scale, film_shift,
                           mean, rstd, da, db, need_x)


GN_BWD_THREADS, GN_BWD_VECS = 256, 4   # the kernel's block, vectors in
                                       # flight per thread
GN_BWD_MAX_GROUPS = 3072   # the coefficients' shared memory (48 KB)
GN_BWD_WAVE = 8 * _build.H100_SMS   # blocks of 256 threads the card holds


def gn_backward_blocks(bsz: int, t: int, c: int, vec_width: int) -> int:
    """dx blocks per batch row of the statistics backward kernel. A row's
    T*C values go in rounds of GN_BWD_VECS vectors of `vec_width` values
    per thread of GN_BWD_THREADS; each block takes an even share of the
    rounds (and derives the row's coefficients once): one round each
    while the B rows' blocks fit one wave of the H100 (GN_BWD_WAVE), else
    the fewest blocks whose shares keep the most rounds a block takes."""
    rounds = -(-t * c // (vec_width * GN_BWD_THREADS * GN_BWD_VECS))
    per = -(-rounds // max(1, GN_BWD_WAVE // bsz))
    return -(-rounds // per)


def _gn_grad_launch(x, gamma, beta, groups, film_scale, film_shift, mean,
                    rstd, da, db, need_x):
    """Check the inputs and launch the statistics' backward kernels."""
    params, film_stride = _gn_params(x, gamma, beta, film_scale, film_shift,
                                     "group_norm_affine_grad")
    bsz, t, c = x.shape
    if groups < 1 or c % groups or groups > GN_BWD_MAX_GROUPS:
        raise ValueError(f"group_norm_affine_grad: shapes x "
                         f"{tuple(x.shape)} groups {groups}")
    for name, v, shape in (("mean", mean, (bsz, groups)),
                           ("rstd", rstd, (bsz, groups)),
                           ("da", da, (bsz, c)), ("db", db, (bsz, c))):
        if v.shape != shape or v.dtype != torch.float32 \
                or v.device != x.device:
            raise ValueError(f"group_norm_affine_grad: {name} must be f32 "
                             f"{shape} on {x.device}, got "
                             f"{tuple(v.shape)} {v.dtype}")
    mean, rstd, da, db = (v.contiguous() for v in (mean, rstd, da, db))
    _build.require_current_device(x)
    lib = _build.library()
    film = len(params) == 4
    pdt = params[0].dtype
    dx = torch.empty_like(x) if need_x else None
    dgamma, dbeta = torch.empty((2, c), dtype=pdt, device=x.device)
    dscale = dshift = None
    if film:
        dscale, dshift = torch.empty((2, bsz, c), dtype=pdt,
                                     device=x.device)
    per = 16 // x.element_size()
    vec = (c // groups) % per == 0 and x.data_ptr() % 16 == 0
    _gn_counts.backward_launches += 1
    err = lib.ns2vc_group_norm_affine_bwd(
        x.data_ptr(), params[0].data_ptr(), params[1].data_ptr(),
        *((params[2].data_ptr(), params[3].data_ptr()) if film
          else (None, None)),
        film_stride, mean.data_ptr(), rstd.data_ptr(), da.data_ptr(),
        db.data_ptr(), None if dx is None else dx.data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(),
        *((dscale.data_ptr(), dshift.data_ptr()) if film else (None, None)),
        bsz, t, c, groups, gn_backward_blocks(bsz, t, c, per if vec else 1),
        int(x.dtype == torch.bfloat16), int(pdt == torch.bfloat16),
        int(vec), _build.stream_of(x))
    _build.check(err, "group_norm_affine_grad")
    # each gradient in its input's dtype (the kernels write the one dtype
    # the parameters were read in)
    out = [dgamma.to(gamma.dtype), dbeta.to(beta.dtype)]
    if film:
        out += [dscale.to(film_scale.dtype), dshift.to(film_shift.dtype)]
    else:
        out += [None, None]
    return (dx, *out)


group_norm_affine.launches = 0
group_norm_affine.backward_calls = 0
group_norm_affine.backward_launches = 0
# the counters' owner, also while a caller wraps the module's public name
# (a profiler's range, a test's recorder)
_gn_counts = group_norm_affine


def group_norm_affine_plain(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, groups: int, eps: float,
                            film_scale: torch.Tensor | None = None,
                            film_shift: torch.Tensor | None = None):
    """The statistics kernel's plain version (torch ops, any device): the
    JAX wrapper's fold of GroupNorm(groups, eps)'s f32 mean and centred
    variance of x (B, T, C) with gamma/beta and an optional FiLM into the
    f32 affine (a, b), both (B, C)."""
    bsz, t, c = x.shape
    xg = x.float().reshape(bsz, t, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0)   # (B, G)
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(c // groups, dim=1) * gamma.float()
    b = beta.float() - mean.repeat_interleave(c // groups, dim=1) * a
    if film_scale is not None:
        s = 1.0 + film_scale.float()
        a = a * s
        b = b * s + film_shift.float()
    return a.contiguous(), b.contiguous()


def group_norm_stats_plain(x: torch.Tensor, groups: int, eps: float):
    """Each (batch, group)'s f32 mean and rstd = 1 / sqrt(var + eps), (B, G)
    each: what the statistics kernel keeps for the backward."""
    bsz, t, c = x.shape
    xg = x.float().reshape(bsz, t, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0)
    return mean, torch.rsqrt(var + eps)


def group_norm_affine_backward(x: torch.Tensor, gamma: torch.Tensor,
                               beta: torch.Tensor, groups: int, eps: float,
                               film_scale: torch.Tensor | None,
                               film_shift: torch.Tensor | None,
                               da: torch.Tensor, db: torch.Tensor,
                               mean: torch.Tensor | None = None,
                               rstd: torch.Tensor | None = None):
    """The statistics' backward kernels' plain version (torch ops, any
    device): (dx, dgamma, dbeta, dscale, dshift) of `group_norm_affine`
    given da, db (B, C), in closed form, in f32 (f64 for f64 inputs), each
    cast to its input's dtype (dscale, dshift None without FiLM). With s =
    1 + scale (or 1), g = gamma, and r, m the rstd and mean of channel c's
    group (from x, or as given by the forward):
        dshift = db,  dscale = da r g + db (beta - m r g)
        dbeta = sum_B db s,  dgamma = sum_B r s (da - m db)
        dr = sum_{c in G} g s (da - m db),  dm = -sum_{c in G} r g s db
        dvar = -r^3 dr / 2,  dx = dm / N + 2 dvar (x - m) / N,
    N = T C / G (dx from x - m, as the kernel takes it: exact where the
    mean is large beside the spread)."""
    bsz, t, c = x.shape
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    if mean is None:
        mean, rstd = group_norm_stats_plain(x.to(acc), groups, eps)
    cg = c // groups
    m = mean.to(acc).repeat_interleave(cg, dim=1)
    r = rstd.to(acc).repeat_interleave(cg, dim=1)
    g, be = gamma.to(acc), beta.to(acc)
    da, db = da.to(acc), db.to(acc)
    s = 1.0 if film_scale is None else 1.0 + film_scale.to(acc)
    t_ = da - m * db
    dgamma = (r * s * t_).sum(dim=0)
    dbeta = (db * s).sum(dim=0)
    dr = (g * s * t_).reshape(bsz, groups, cg).sum(dim=2)
    dm = -(r * g * s * db).reshape(bsz, groups, cg).sum(dim=2)
    rs = rstd.to(acc)
    dvar = -0.5 * rs * rs * rs * dr
    n = float(t * cg)
    slope = 2.0 * dvar / n
    xg = x.to(acc).reshape(bsz, t, groups, cg)
    dx = ((dm / n)[:, None, :, None] + slope[:, None, :, None]
          * (xg - mean.to(acc)[:, None, :, None])).reshape(bsz, t, c) \
        .to(x.dtype)
    dscale = dshift = None
    if film_scale is not None:
        dscale = (da * r * g + db * (be - m * r * g)).to(film_scale.dtype)
        dshift = db.to(film_shift.dtype)
    return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), dscale, dshift


def gn_silu_conv1d(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   w: torch.Tensor, bias: torch.Tensor, groups: int = 8,
                   eps: float = 1e-5, film_scale: torch.Tensor | None = None,
                   film_shift: torch.Tensor | None = None) -> torch.Tensor:
    """GroupNorm(+FiLM) -> SiLU -> conv k3 SAME on (B, T, C), w in torch
    Conv1d layout (Co, C, 3). On CUDA w is packed ahead of the statistics
    kernel (an in-place update repacks it), so the conv, which starts while
    the statistics finish, has the statistics kernel just before it."""
    if gn_route(x.device) == "cuda":
        packed_weight(w)
    a, b = group_norm_affine(x, gamma, beta, groups, eps, film_scale,
                             film_shift)
    return affine_silu_conv1d(x, a, b, w, bias)
