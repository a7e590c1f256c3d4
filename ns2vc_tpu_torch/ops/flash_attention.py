"""Flash attention forward with an additive key bias (kernel K1).

Replaces `ns2vc_tpu/ops/pallas_attention.py::flash_attention`, the Pallas
TPU kernel, with hand-written CUDA kernels; their source notes say what
bounds each on the H100 and how its design answers that.

`flash_attention` routes by `attention_route(device, dtype)`, and a bf16
call by its rows and `plan_wgmma_attention`:

    cpu        -> `flash_attention_plain`
    cuda, bf16 -> "tc": `csrc/flash_attention_wgmma.cu`, TMA-fed K/V tiles,
                  wgmma for Q.K^T and P.V, the softmax overlapped with them,
                  D <= 128 in whole 16-byte chunks (D % 8 == 0, aligned
                  strides), with the keys per tile `plan_wgmma_attention`
                  gives; a single query (Tq == 1, at most Q1_MAX_KEYS keys:
                  the attention pools) takes `csrc/flash_attention_q1.cu`,
                  dot products and softmax on the CUDA cores over key rows
                  read in the widest aligned vectors, the keys split over a
                  cluster where the grid is small (`plan_q1`), counted
                  apart as "tc_q1"; other rows that are not whole aligned
                  16-byte chunks (D = 4, 100 or odd, odd strides) take the
                  mma.sync kernel (`csrc/flash_attention_tc.cu`) with
                  element loads, counted apart as "tc_narrow"
    cuda, f32  -> "f32tc": `csrc/flash_attention_f32_wgmma.cu`, TF32 tensor
                  cores in three passes (3xTF32: each operand's TF32 big
                  and small halves) on wgmma over TMA-fed K/V tiles, at f32
                  accuracy, D <= 128 in 16-byte chunks (D % 4 == 0, aligned
                  strides), with the key tile, consumer warpgroups per block
                  and key splits over a cluster that `plan_f32_wgmma`
                  gives; a single query takes the single-query kernel in
                  f32 (exact f32 on the CUDA cores; faster than the 3xTF32
                  kernels at both pools on an H100, PERF.md), counted as
                  "f32tc_q1"; other rows that TMA cannot take take the
                  mma.sync 3xTF32 kernel (`csrc/flash_attention.cu`) with
                  element loads, its keys split over blocks and merged by a
                  second kernel where `plan_f32tc` says, counted apart as
                  "f32tc_narrow"

q in f32 with k and v in bf16 (the F0 predictor's cross-attention under a
bf16 model: its trunk is f32, its prompt bf16, as flax promotes them) is
the JAX package's mixed attention: f32 logits and softmax, the
probabilities rounded to v's dtype, the output in v's dtype. The plain
version computes exactly that; on a card k and v are cast to f32 (exact)
and the call takes the f32 route, its output cast to bf16, so the card
skips the one rounding of the probabilities to bf16 before the PV product.

A CUDA tensor launches one of the kernels or raises. `flash_attention.
launches` counts every launch, `flash_attention.route_launches` each route's
and sub-route's ("tc", "tc_q1", "tc_narrow", "f32tc", "f32tc_q1",
"f32tc_narrow"); its "plain" entry
counts the calls `ops/attention.py` sends to the plain version by their
bias or head dim (no kernel launches for those). A replayed CUDA graph
launches kernels, and runs their backwards, without calling the wrapper
or the Function: its owner adds the launch and backward counts its
capture took (`launch_counts`, `add_launch_counts`).
The kernels read q/k/v through their (batch, head, seq) strides, so the
(B, H, T, D) views that `ops/attention.py::split_heads` makes of the
(B, T, H*D) projections go in without a transpose copy, and the output is
written as a (B, Tq, H, D) buffer whose (B, H, Tq, D) view is returned, so
`merge_heads` is a free reshape.

Training: when grad is enabled and q, k or v requires it, a CUDA call goes
through an autograd Function whose forward is the same launch and whose
backward is `flash_attention_grad` (the JAX package differentiates XLA's
attention; its Pallas kernel is forward-only), routed by dtype:

    cpu        -> `flash_attention_backward`, the plain version in torch ops
    cuda, bf16 -> "tc": `csrc/flash_attention_bwd_wgmma.cu`, two kernels on
                  wgmma over TMA-fed tiles (dq with each row's lse and
                  Delta, then dk and dv), no atomics, D % 8 == 0 with
                  aligned rows (as the forward's "tc" takes them); other
                  rows of more than one query take the same kernels on
                  zero-padded contiguous copies, counted apart as
                  "tc_pad"; a single query (the pools) takes
                  `csrc/flash_attention_q1_bwd.cu` (keys split over a
                  cluster, `plan_q1_backward`), counted apart as "tc_q1"
    cuda, f32  -> "f32tc": `csrc/flash_attention_f32_bwd_wgmma.cu`, a
                  converting pass that writes q's, k's, v's and dO's TF32
                  planes (rows and transposes) once per call, then the same
                  two kernels on tf32 wgmma in three passes per product
                  (3xTF32, f32 accuracy) over those planes as TMA brings
                  them, small grids split over a cluster
                  (`plan_f32_backward`; the F0 predictor's f32
                  cross-attentions and the f32 gradient checks), D % 4 ==
                  0 with aligned rows; heads of 65-128 take their 128-wide
                  instantiation (16-row streamed tiles), counted apart as
                  "f32tc_d128"; other rows (the converting pass reads any
                  rows, zeros past D) "f32tc_pad"; a single query takes
                  the single-query backward in f32, "f32tc_q1"

`grad_plan` is the route decision, a pure function of the shapes, dtype,
strides and addresses; no geometry the forward takes is refused.

`flash_attention_grad.launches` counts the backward kernels' launches,
`.route_launches` each sub-route's. No gradient flows to the key bias (a
mask) or to the scale. Each backward adds one to
`flash_attention.backward_calls[route]`, the route its forward took.
Serving, the samplers and CUDA graph capture, which run without grad,
launch directly.
"""

from __future__ import annotations

import torch

from ns2vc_tpu_torch.ops import _build

MAX_HEAD_DIM = 128      # the kernels' widest padded head
# the single-query kernel (csrc/flash_attention_q1.cu): its block, its ring
# of key tiles, a block's row segment and a stage at most, and the keys
# whose logits one head's block keeps in shared memory
Q1_THREADS, Q1_STAGES = 256, 3
Q1_SEGMENT_BYTES, Q1_STAGE_BYTES = 512, 32768
Q1_MAX_KEYS = 16384
Q1_MAX_SPLITS = 8       # a portable cluster
# the single-query backward (csrc/flash_attention_q1_bwd.cu): its ring of
# stages, each a tile of k and one of v, at most this many bytes together
Q1_BWD_STAGES, Q1_BWD_STAGE_BYTES = 2, 98304
Q1_WARPS = Q1_THREADS // 32
MAX_SMEM = 232448       # an H100 block's shared memory
# the dtypes whose Tq == 1 calls take it: both (at the pools it beat the
# f32 3xTF32 kernel on an H100, PERF.md)
Q1_DTYPES = (torch.bfloat16, torch.float32)
BWD_ROWS = 64           # the backward tile kernels' rows: queries or keys
# the bf16 backward tile kernels' runs an H100 SM works at once (its
# consumer warpgroups), per padded head dim: blocks by their launch bounds
# times producer / consumer pairs a block (`Cfg::Blocks`, `Cfg::Pairs` in
# csrc/flash_attention_bwd_wgmma.cu)
BWD_RUNS_PER_SM = {16: 3, 32: 3, 64: 2, 128: 1}
# the f32 backward tile kernels per padded head dim (`Shape` in
# csrc/flash_attention_f32_bwd_wgmma.cu): dq's key tile, dkdv's query tile
# and the blocks an H100 SM holds
F32_BWD_SHAPES = {16: (64, 32, 2), 32: (64, 32, 2), 64: (64, 32, 1),
                  128: (64, 32, 1)}
F32_BWD_MAX_SPLITS = 8   # a portable cluster


def plan_f32tc(bh: int, tq: int, tk: int, d: int) -> tuple[int, int]:
    """(splits, key tiles per split) of the mma.sync f32 kernel
    ("f32tc_narrow") for B*H = bh: one split when its 64-query blocks give
    every SM of the H100 one, else as many as the SMs hold resident blocks
    (two at D <= 64, one above: their shared memory), each over the same
    number of key tiles (64 keys, 32 at D > 64), none empty."""
    tiles = -(-tk // (64 if d <= 64 else 32))
    blocks = -(-tq // 64) * bh
    if blocks >= _build.H100_SMS:
        return 1, tiles
    want = max(1, (2 if d <= 64 else 1) * _build.H100_SMS // blocks)
    per = -(-tiles // min(want, tiles))
    return -(-tiles // per), per


def f32_wgmma_dp(d: int) -> int:
    """The f32 wgmma kernel's padded head dim: 16, 32, 64 or 128."""
    return next(dp for dp in (16, 32, 64, 128) if d <= dp)


def f32_wgmma_smem(dp: int, key_tile: int, consumers: int) -> int:
    """Shared memory of one block of the f32 wgmma kernel (`Cfg::
    SmemBytes`): alignment slack, each consumer's two Q planes, the raw K
    and V slots, then three stages where they fit MAX_SMEM, else two, each
    K's and V^T's two planes and the key bias."""
    tile = 4 * key_tile * dp
    fixed = 1024 + 2 * consumers * 4 * 64 * dp + 2 * tile
    stage = 4 * tile + 4 * key_tile
    return fixed + (3 if fixed + 3 * stage <= MAX_SMEM else 2) * stage


# the f32 wgmma kernel's instantiated (key tile, consumers) per padded head
# dim (`launch_dp` in its source)
F32_WGMMA_TILES = {16: ((64, 1), (64, 2)), 32: ((64, 1), (64, 2)),
                   64: ((64, 1), (32, 2)), 128: ((32, 1),)}


def plan_f32_wgmma(bh: int, tq: int, tk: int, d: int
                   ) -> tuple[int, int, int]:
    """(keys per tile, consumer warpgroups per block, key splits) of the
    f32 wgmma kernel for B*H = bh, as measured on an H100 (PERF.md). Two
    consumers (128 query rows sharing each converted K/V tile) where the
    head is at most 64 wide, the queries fill more than one 64-row tile
    and such blocks number 64 or more; else one, so that a small grid
    keeps its blocks. 64-key tiles, 32 with two consumers at D > 32 and at
    D > 64 (what fits a consumer's registers). Where the blocks fall short
    of the H100's SMs, the key tiles are split over a cluster of up to 8
    blocks, as many as keep the grid within one wave, and, unless the
    grid has 16 blocks or fewer, two key tiles or more each; every split
    over the same number of tiles, none empty."""
    dp = f32_wgmma_dp(d)
    two = dp <= 64 and tq > 64 and -(-tq // 128) * bh >= 64
    consumers = 2 if two else 1
    key_tile = 32 if dp == 128 or (dp == 64 and two) else 64
    tiles = -(-tk // key_tile)
    blocks = -(-tq // (64 * consumers)) * bh
    most = tiles if blocks <= 16 else max(1, tiles // 2)
    splits = max(1, min(8, most, _build.H100_SMS // blocks))
    splits = -(-tiles // -(-tiles // splits))
    return key_tile, consumers, splits


def plan_wgmma_attention(bh: int, tq: int, tk: int, d: int) -> int:
    """Keys per tile (64 or 128) of the wgmma kernel for B*H = bh: 128
    where its 64-query blocks are no more than the H100's SMs, the head is
    at most 64 wide and the keys fill two tiles or more (a long key loop on
    a grid with no second wave to hide each tile's fixed cost), else 64
    (more blocks resident per SM: fewer registers, smaller stages). Chosen
    on an H100 (PERF.md): the mma.sync kernel was slower at every geometry
    timed, B=1's 8-56 blocks included, so no grid goes to it."""
    blocks = -(-tq // 64) * bh
    wide = d <= 64 and blocks <= _build.H100_SMS and tk > 128
    return 128 if wide else 64


def q1_smem(hg: int, d: int, kpb: int, tile: int, es: int) -> int:
    """Shared memory of a single-query block of `hg` heads of D over its
    `kpb` keys in tiles of `tile`, elements of `es` bytes: q, the logits,
    the PV shares, the cluster's max and sum per head and the block's PV
    partial in f32 (16-byte aligned), then the stages."""
    floats = (2 * hg * d + hg * kpb + Q1_THREADS + 2 * hg + 3) & ~3
    return 4 * floats + es * Q1_STAGES * tile * hg * d


def plan_q1(b: int, h: int, tk: int, d: int,
            es: int) -> tuple[int, int, int]:
    """(heads per block, keys per tile, key splits) of the single-query
    kernel. Heads are grouped so that B x groups reaches the H100's SMs
    where the heads allow it, a group's row segment at most
    Q1_SEGMENT_BYTES; where B x groups still falls short, the keys are
    split over a cluster of up to Q1_MAX_SPLITS blocks of 32 keys or more
    each, dealt evenly with none empty. The key tile is the power of two
    in [32, 512] that fills a Q1_STAGE_BYTES stage, at most a split's keys;
    fewer heads per block until the shared memory fits (one head of up to
    Q1_MAX_KEYS keys always does)."""
    groups = min(h, max(1, -(-_build.H100_SMS // b)))
    hg = min(-(-h // groups), max(1, Q1_SEGMENT_BYTES // (d * es)))
    while True:
        blocks = b * -(-h // hg)
        splits = max(1, min(Q1_MAX_SPLITS, -(-_build.H100_SMS // blocks),
                            tk // 32))
        kpb = -(-tk // splits)
        splits = -(-tk // kpb)
        seg = Q1_STAGE_BYTES // (hg * d * es)
        tile = min(kpb, max(32, min(512, 1 << (seg.bit_length() - 1))))
        if hg == 1 or q1_smem(hg, d, kpb, tile, es) <= MAX_SMEM:
            return hg, tile, splits
        hg = -(-hg // 2)


def q1_vec_bytes(k: torch.Tensor, v: torch.Tensor, hg: int,
                 *more: torch.Tensor) -> int:
    """The widest load (16, 8 or 4 bytes, else one element) that divides
    every base, stride and row segment the single-query kernels read of k
    and v (and write of `more`: the backward's dk and dv) in blocks of `hg`
    heads. Where the heads of a key lie side by side in every one of them
    (head stride D, or one head) a block's segment is its heads' H_g x D
    values, else one head's D."""
    b, h, tk, d = k.shape
    es = k.element_size()
    merged = h == 1 or all(t.stride(1) == d for t in (k, v, *more))
    last = h - (-(-h // hg) - 1) * hg
    segs = {hg * d, last * d} if merged else {d}

    def fits(t, vb):
        return (t.data_ptr() % vb == 0
                and (b == 1 or t.stride(0) * es % vb == 0)
                and (tk == 1 or t.stride(2) * es % vb == 0)
                and all(n * es % vb == 0 for n in segs)
                and (merged or h == 1 or t.stride(1) * es % vb == 0))
    return next((vb for vb in (16, 8, 4)
                 if all(fits(t, vb) for t in (k, v, *more))), es)


def q1_backward_smem(hg: int, d: int, kpb: int, tile: int, es: int) -> int:
    """Shared memory of a block of the single-query backward
    (csrc/flash_attention_q1_bwd.cu, `q1b_floats`): q, dO and the block's
    dq partial, each head's logits and dP over its keys, the dq shares,
    five values per head in f32 (16-byte aligned), then its stages of a k
    and a v tile each: one where the share is one tile, else
    Q1_BWD_STAGES."""
    floats = (3 * hg * d + 2 * hg * kpb + Q1_THREADS + 5 * hg + 3) & ~3
    stages = 1 if kpb <= tile else Q1_BWD_STAGES
    return 4 * floats + es * stages * 2 * tile * hg * d


def plan_q1_backward(b: int, h: int, tk: int, d: int,
                     es: int) -> tuple[int, int, int]:
    """(heads per block, keys per tile, key splits) of the single-query
    backward. Heads are grouped so that B x groups stays within one block
    per H100 SM where the heads allow it (the floor of SMs / B groups), a
    group at least Q1_WARPS heads where there are as many (the softmax
    takes a warp per head) and its row segment at most Q1_SEGMENT_BYTES;
    where B x groups falls short, the keys are split over a cluster of up
    to Q1_MAX_SPLITS blocks, as many as keep the grid within the SMs, of
    32 keys or more each, dealt evenly with none empty. A stage holds a
    tile of k and one of v, together at most Q1_BWD_STAGE_BYTES: a share
    that fits is one tile (k then read once for both passes), else tiles
    of that size; fewer heads per block until the shared memory fits."""
    sms = _build.H100_SMS
    groups = max(1, min(h, sms // b))
    hg = min(max(-(-h // groups), min(h, Q1_WARPS)),
             max(1, Q1_SEGMENT_BYTES // (d * es)))
    while True:
        blocks = b * -(-h // hg)
        splits = max(1, min(Q1_MAX_SPLITS, sms // blocks, tk // 32))
        kpb = -(-tk // splits)
        splits = -(-tk // kpb)
        seg = Q1_BWD_STAGE_BYTES // (2 * hg * d * es)
        tile = min(kpb, max(32, min(Q1_MAX_KEYS, seg)))
        if hg == 1 or q1_backward_smem(hg, d, kpb, tile, es) <= MAX_SMEM:
            return hg, tile, splits
        hg = -(-hg // 2)


def attention_route(device: torch.device | str, dtype: torch.dtype) -> str:
    """'plain' (CPU), 'tc' (the bf16 kernels) or 'f32tc' (the 3xTF32
    kernels, which take f32; `_launch` refuses any other dtype); raises for
    a device that is neither."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise ValueError(f"flash_attention: unsupported device {device}")
    return "tc" if dtype == torch.bfloat16 else "f32tc"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """softmax(q.k^T * scale + bias) . v, the JAX package's XLA attention
    core (ops/attention.py::scaled_dot_product_attention): logits and
    softmax in f32, probabilities cast to v's dtype before the PV product,
    which accumulates in f32. q (B, H, Tq, D), k/v (B, H, Tk, D), bias
    additive (0 keep / -1e4 drop): the kernel's (B, Tk) key bias, or any
    bias that broadcasts against (B, H, Tq, Tk) (the plain route of
    `ops/attention.py`). q may be f32 with k and v bf16: the output is in
    v's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    acc = _acc_dtype(q)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + (bias.to(acc)[:, None, None, :] if bias.dim() == 2
                           else bias.to(acc))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.to(acc), v.to(acc)).to(v.dtype)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 accumulation, f64 for f64 inputs (the gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor | None,
                             scale: float, do: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of o = softmax(q.k^T * scale + bias) . v, given o's
    gradient do (any strides), in f32 (f64 for f64 inputs) and cast to each
    input's dtype. P is recomputed as the plain version makes it; dV takes
    P rounded to v's dtype, as the plain version's PV product does:
        dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(P * dP)),
        dQ = dS K scale,  dK = dS^T Q scale.
    rowsum(P * dP) equals rowsum(dO * O) in exact arithmetic; taken from
    the f32 P and dP it makes each row of dS sum to zero, whereas a bf16 O
    carries its rounding into every element of the row, which a component
    the keys share turns into dQ's largest error."""
    acc = _acc_dtype(q)
    qf, kf, vf, dof = q.to(acc), k.to(acc), v.to(acc), do.to(acc)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.to(acc)[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    dv = torch.matmul(p.to(v.dtype).to(acc).transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_workspace(b: int, h: int, tq: int) -> int:
    """f32 values of the backward tile kernels' workspace: each of the B*H
    rows of queries, padded to whole 64-row tiles, its lse and its
    Delta."""
    return 2 * b * h * -(-tq // BWD_ROWS) * BWD_ROWS


def plan_backward(bh: int, tq: int, tk: int, d: int) -> tuple[int, int]:
    """(dq's, dkdv's) runs of the bf16 backward tile kernels for B*H = bh:
    a kernel's items are its 64 fixed rows (queries for dq, keys for dkdv)
    of each batch*head, and each run an even share of them, consecutive,
    taken by one producer / consumer pair of a block (paying its set-up
    once, loading each next item while it finishes the one before): as
    many runs as the H100 works at once (H100_SMS x BWD_RUNS_PER_SM at the
    padded head dim, 16, 32, 64 or 128), or one per item where there are
    fewer."""
    slots = _build.H100_SMS * BWD_RUNS_PER_SM[f32_wgmma_dp(d)]
    return tuple(min(-(-rows // BWD_ROWS) * bh, slots) for rows in (tq, tk))


def plan_f32_backward(bh: int, tq: int, tk: int, d: int
                      ) -> tuple[int, int, int, int, int]:
    """(padded head dim, dq's key tile, dkdv's query tile, dq's key splits,
    dkdv's query splits) of the f32 backward tile kernels for B*H = bh. A
    kernel whose (64-row tiles x bh) grid fills fewer than the H100's SMs
    times the blocks each holds splits its streamed tiles over a cluster of
    up to
    F32_BWD_MAX_SPLITS blocks: as many as keep the grid within one wave,
    at most half its tiles (two or more each), rank r taking tiles [r n /
    c, (r + 1) n / c)."""
    dp = f32_wgmma_dp(d)
    bn, kbn, per_sm = F32_BWD_SHAPES[dp]

    def splits(rows: int, streamed: int, tile: int) -> int:
        blocks = -(-rows // BWD_ROWS) * bh
        n = -(-streamed // tile)
        return max(1, min(F32_BWD_MAX_SPLITS, n // 2,
                          per_sm * _build.H100_SMS // blocks))
    return dp, bn, kbn, splits(tq, tk, bn), splits(tk, tq, kbn)


def f32_bwd_workspace(b: int, h: int, tq: int, tk: int, d: int) -> int:
    """f32 values of the f32 backward kernels' workspace (`Planes` in their
    source), each part rounded up to 32 values: lse and Delta of every
    query row (tiles of 64), the TF32 big and small planes of q, k, v and
    dO as rows (B*H, T, DP) and of q, k and dO transposed (B*H, DP, T
    rounded up to 8)."""
    dp = f32_wgmma_dp(d)
    bh = b * h
    tq_pad = -(-tq // BWD_ROWS) * BWD_ROWS
    parts = [bh * tq_pad] * 2 + [2 * bh * t * dp for t in (tq, tk, tk, tq)]
    parts += [2 * bh * dp * -(-t // 8) * 8 for t in (tq, tk, tq)]
    return sum(-(-n // 32) * 32 for n in parts)


def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor | None, scale: float,
                         do: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` given o's gradient do, each in its
    input's dtype and shape. A CPU tensor takes `flash_attention_backward`;
    a CUDA tensor the backward kernels of its dtype (bf16:
    `csrc/flash_attention_bwd_wgmma.cu`, f32: `csrc/flash_attention_f32_
    bwd_wgmma.cu`; calls of one query the single-query kernel of the
    first; no atomics, so two calls on one input agree bit for bit) or
    raises."""
    if attention_route(q.device, q.dtype) == "plain":
        return flash_attention_backward(q, k, v, bias, scale, do)
    return _grad_launch(q, k, v, bias, scale, do)


def grad_plan(shape: tuple[int, int, int, int], tk: int,
              dtype: torch.dtype, strides: tuple[tuple[int, ...], ...],
              addresses: tuple[int, ...]) -> tuple[str, int]:
    """The backward kernels' sub-route of a CUDA call, and the head dim
    they run it at, from q's shape (B, H, Tq, D), the keys, the dtype and
    q's, k's and v's strides and data addresses (bytes):
        one query (at most Q1_MAX_KEYS keys) -> "tc_q1" / "f32tc_q1", the
            single-query kernel, at D, any rows;
        rows of whole aligned 16-byte chunks (D % (16 / element size) == 0,
            16-byte aligned bases, strides of whole chunks) -> "tc" /
            "f32tc", the tile kernels, at D; f32 at D > 64 "f32tc_d128",
            the f32 kernels' 128-wide instantiation;
        other rows -> "tc_pad" / "f32tc_pad": the tile kernels at D rounded
            up to whole 16-byte chunks, on zero-padded contiguous copies
            (zero columns change no score; their gradients are zero and are
            dropped)."""
    b, h, tq, d = shape
    route = "tc" if dtype == torch.bfloat16 else "f32tc"
    if tq == 1 and tk <= Q1_MAX_KEYS:
        return route + "_q1", d
    per = 16 // (2 if dtype == torch.bfloat16 else 4)
    dims = ((b, h, tq), (b, h, tk), (b, h, tk))
    aligned = d % per == 0 and all(a % 16 == 0 for a in addresses) and all(
        st % per == 0 for sts, ns in zip(strides, dims)
        for st, n in zip(sts[:3], ns) if n > 1)
    if not aligned:
        return route + "_pad", -(-d // per) * per
    return (route + "_d128" if route == "f32tc" and d > 64 else route), d


def grad_route(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> tuple[str, int]:
    """`grad_plan` of q, k and v: (sub-route, head dim it runs at)."""
    return grad_plan(tuple(q.shape), k.shape[2], q.dtype,
                     tuple(t.stride() for t in (q, k, v)),
                     tuple(t.data_ptr() for t in (q, k, v)))


def _padded(t: torch.Tensor, dp: int) -> torch.Tensor:
    """A contiguous (B, H, T, dp) copy of t, zeros past its head dim."""
    out = t.new_zeros((*t.shape[:3], dp))
    out[..., :t.shape[3]] = t
    return out


def _grad_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: torch.Tensor | None, scale: float, do: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the inputs and launch the backward kernels of `grad_plan`'s
    sub-route: (dq, dk, dv) as (B, H, T, D) views of (B, T, H, D) buffers
    (of their padded copies' on the "_pad" sub-routes)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != (b, h, tk, d) \
            or do.shape != q.shape:
        raise ValueError(f"flash_attention_grad: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} do "
                         f"{tuple(do.shape)}")
    if q.dtype not in _build.KERNEL_DTYPES \
            or any(t.dtype != q.dtype for t in (k, v, do)):
        raise ValueError(f"flash_attention_grad: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}/{do.dtype}; the kernels take bf16 or "
                         f"f32, all alike")
    if not 1 <= d <= MAX_HEAD_DIM or tq < 1 or tk < 1 or b * h > 65535:
        raise ValueError(f"flash_attention_grad: unsupported shape "
                         f"B*H={b * h} Tq={tq} Tk={tk} D={d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_grad: head dim must have unit "
                         "stride")
    if any(t.device != q.device for t in (k, v, do)):
        raise ValueError("flash_attention_grad: q, k, v, do on different "
                         "devices")
    if bias is not None and (bias.shape != (b, tk)
                             or bias.dtype != torch.float32
                             or not bias.is_contiguous()
                             or bias.device != q.device):
        raise ValueError(f"flash_attention_grad: bias must be contiguous f32 "
                         f"({b}, {tk}) on {q.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    route, dp = grad_route(q, k, v)
    _build.require_current_device(q)
    lib = _build.library()
    if route.endswith("_q1"):
        if do.stride(-1) != 1:
            do = do.contiguous()
        grads = [torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
                 .permute(0, 2, 1, 3) for t in (tq, tk, tk)]
        hg, tile, splits = plan_q1_backward(b, h, tk, d, q.element_size())
        _grad_counts.launches += 1
        _grad_counts.route_launches[route] += 1
        fn = (lib.ns2vc_flash_attention_bwd_q1 if route == "tc_q1"
              else lib.ns2vc_flash_attention_bwd_q1_f32)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), do.data_ptr(),
                 *(t.data_ptr() for t in grads), None, b, h, tq, tk, d,
                 *(s for t in (q, k, v, do, *grads) for s in t.stride()[:3]),
                 float(scale), hg, tile, splits,
                 q1_vec_bytes(k, v, hg, *grads[1:]), _build.stream_of(q))
        _build.check(err, f"flash_attention_grad ({route})")
        return tuple(grads)
    if q.dtype == torch.float32:
        # the f32 kernels read q, k, v, do through their strides (a
        # converting pass writes their TF32 planes), any rows
        if do.stride(-1) != 1:
            do = do.contiguous()
        grads = [torch.empty((b, t, h, dp), dtype=q.dtype, device=q.device)
                 .permute(0, 2, 1, 3) for t in (tq, tk, tk)]
        ws = torch.empty(f32_bwd_workspace(b, h, tq, tk, d),
                         dtype=torch.float32, device=q.device)
        *_, dq_splits, kv_splits = plan_f32_backward(b * h, tq, tk, d)
        _grad_counts.launches += 1
        _grad_counts.route_launches[route] += 1
        err = lib.ns2vc_flash_attention_f32_bwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), do.data_ptr(),
            *(t.data_ptr() for t in grads), ws.data_ptr(), b, h, tq, tk, d,
            *(s for t in (q, k, v, do, *grads) for s in t.stride()[:3]),
            float(scale), dq_splits, kv_splits, _build.stream_of(q))
        _build.check(err, f"flash_attention_grad ({route})")
        return tuple(g[..., :d] for g in grads) if dp != d else tuple(grads)
    if route.endswith("_pad"):
        q, k, v, do = (_padded(t, dp) for t in (q, k, v, do))
    elif not (_build.aligned16(do) and all(
            s > 0 for s, n in zip(do.stride()[:-1], do.shape) if n > 1)):
        # do comes as autograd gives it: a layout TMA cannot read (aligned
        # rows, nonzero strides) is copied first
        do = do.contiguous()
    grads = [torch.empty((b, t, h, dp), dtype=q.dtype, device=q.device)
             .permute(0, 2, 1, 3) for t in (tq, tk, tk)]
    ws = torch.empty(bwd_workspace(b, h, tq), dtype=torch.float32,
                     device=q.device)
    _grad_counts.launches += 1
    _grad_counts.route_launches[route] += 1
    err = lib.ns2vc_flash_attention_bwd_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), do.data_ptr(),
        *(t.data_ptr() for t in grads), ws.data_ptr(), b, h, tq, tk, dp,
        *(s for t in (q, k, v, do, *grads) for s in t.stride()[:3]),
        float(scale), *plan_backward(b * h, tq, tk, dp), _build.stream_of(q))
    _build.check(err, f"flash_attention_grad ({route})")
    return tuple(g[..., :d] for g in grads) if dp != d else tuple(grads)


flash_attention_grad.launches = 0
flash_attention_grad.route_launches = {"tc": 0, "tc_q1": 0, "tc_pad": 0,
                                       "f32tc": 0, "f32tc_q1": 0,
                                       "f32tc_pad": 0, "f32tc_d128": 0}
_grad_counts = flash_attention_grad


class _FlashAttentionFn(torch.autograd.Function):
    """The kernel's launch under autograd; backward through
    `flash_attention_grad`."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        o, route = _launch(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale, ctx.route = scale, route
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        flash_attention.backward_calls[ctx.route] += 1
        dq, dk, dv = flash_attention_grad(q, k, v, bias, ctx.scale, do)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, H, Tq, D), k/v (B, H, Tk, D), bias (B, Tk) -> (B, H, Tq, D)
    in v's dtype. On CUDA: f32 or bf16, all alike or q f32 with k and v
    bf16, D <= 128, unit stride on D; differentiable in q, k and v."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if attention_route(q.device, q.dtype) == "plain":
        return flash_attention_plain(q, k, v, bias, scale)
    if q.dtype == torch.float32 and k.dtype == v.dtype == torch.bfloat16:
        # exact upcasts; autograd takes their gradients back to bf16
        return flash_attention(q, k.float(), v.float(), bias,
                               scale).to(v.dtype)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttentionFn.apply(q, k, v, bias, scale)
    return _launch(q, k, v, bias, scale)[0]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor | None, scale: float
            ) -> tuple[torch.Tensor, str]:
    """Check the inputs and launch the kernel of their route: (o, route)."""
    route = attention_route(q.device, q.dtype)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != (b, h, tk, d):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in _build.KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernels take f32 or bf16, all "
                         f"alike, or q f32 with k and v bf16")
    if not 1 <= d <= MAX_HEAD_DIM or tq < 1 or tk < 1 or b * h > 65535:
        raise ValueError(f"flash_attention: unsupported shape B*H={b * h} "
                         f"Tq={tq} Tk={tk} D={d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head dim must have unit stride")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if bias is not None:
        if bias.shape != (b, tk) or bias.dtype != torch.float32 \
                or not bias.is_contiguous() or bias.device != q.device:
            raise ValueError(f"flash_attention: bias must be contiguous f32 "
                             f"({b}, {tk}) on {q.device}, got "
                             f"{tuple(bias.shape)} {bias.dtype}")
    _build.require_current_device(q)
    lib = _build.library()
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    o = out.permute(0, 2, 1, 3)  # (B, H, Tq, D) view
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    bias_ptr = None if bias is None else bias.data_ptr()
    vec = all(_build.aligned16(t) for t in (q, k, v))
    if tq == 1 and tk <= Q1_MAX_KEYS and q.dtype in Q1_DTYPES:
        route += "_q1"
    elif route in ("tc", "f32tc") and not vec:
        route += "_narrow"
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, o.data_ptr(),
            b, h, tq, tk, d, *strides, float(scale), int(vec))
    if route.endswith("_q1"):
        hg, tile, splits = plan_q1(b, h, tk, d, q.element_size())
        err = lib.ns2vc_flash_attention_q1_fwd(
            *args[:-1], hg, tile, splits, q1_vec_bytes(k, v, hg),
            int(q.dtype == torch.bfloat16), _build.stream_of(q))
    elif route == "tc":   # the key tile in vec's place
        err = lib.ns2vc_flash_attention_wgmma_fwd(
            *args[:-1], plan_wgmma_attention(b * h, tq, tk, d),
            _build.stream_of(q))
    elif route == "f32tc":   # the key tile, consumers and splits in vec's
        err = lib.ns2vc_flash_attention_f32_wgmma_fwd(
            *args[:-1], *plan_f32_wgmma(b * h, tq, tk, d),
            _build.stream_of(q))
    elif route == "f32tc_narrow":
        splits, per = plan_f32tc(b * h, tq, tk, d)
        ws = [None, None] if splits == 1 else [
            torch.empty((splits, b * h * tq, n), dtype=torch.float32,
                        device=q.device) for n in (d, 2)]
        err = lib.ns2vc_flash_attention_f32tc_fwd(
            *args, per, splits, *(None if w is None else w.data_ptr()
                                  for w in ws), _build.stream_of(q))
    else:
        err = lib.ns2vc_flash_attention_tc_fwd(*args, _build.stream_of(q))
    _build.check(err, f"flash_attention ({route})")
    return o, route


flash_attention.launches = 0
flash_attention.route_launches = {"f32tc": 0, "f32tc_q1": 0,
                                  "f32tc_narrow": 0, "tc": 0, "tc_q1": 0,
                                  "tc_narrow": 0, "plain": 0}
flash_attention.backward_calls = {"f32tc": 0, "f32tc_q1": 0,
                                  "f32tc_narrow": 0, "tc": 0, "tc_q1": 0,
                                  "tc_narrow": 0}
# the counters' owner, also while a caller replaces the module's public
# name
_counts = flash_attention


def reset_launches() -> None:
    _counts.launches = _grad_counts.launches = 0
    for counts in (_counts.route_launches, _counts.backward_calls,
                   _grad_counts.route_launches):
        for key in counts:
            counts[key] = 0


def launch_counts() -> dict[str, int]:
    """The launch and backward counters, flat (a CUDA graph's owner takes
    them before and after its capture)."""
    return {"launches": _counts.launches,
            **{f"route.{k}": n for k, n in _counts.route_launches.items()},
            **{f"backward.{k}": n for k, n in _counts.backward_calls.items()},
            "grad": _grad_counts.launches,
            **{f"grad.{k}": n for k, n in _grad_counts.route_launches.items()}}


def add_launch_counts(delta: dict[str, int], times: int = 1) -> None:
    """Add `times` x `delta` (a difference of two `launch_counts()`): a
    replay launches, and runs the backwards, its capture counted."""
    _counts.launches += times * delta["launches"]
    for k in _counts.route_launches:
        _counts.route_launches[k] += times * delta[f"route.{k}"]
    for k in _counts.backward_calls:
        _counts.backward_calls[k] += times * delta[f"backward.{k}"]
    _grad_counts.launches += times * delta["grad"]
    for k in _grad_counts.route_launches:
        _grad_counts.route_launches[k] += times * delta[f"grad.{k}"]
